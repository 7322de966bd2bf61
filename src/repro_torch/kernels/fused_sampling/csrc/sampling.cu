// The sampler's two kernels for Hopper (sm_90a): the top-k / nucleus top-p
// logit filter and the inverse-CDF token draw.
//
// filter_logits replaces the TPU kernel
// src/repro/kernels/fused_sampling/kernel.py:73 filter_logits (pallas_call at
// :77). draw_tokens has no Pallas counterpart: the JAX engine's unfused
// sampler draws in XLA (src/repro/kernels/fused_lm_head/ref.py:90
// draw_tokens), its fused decode inside head_tokens
// (src/repro/kernels/fused_lm_head/kernel.py:64).
//
// What bounds them on this card: bytes. The filter reads the [S, V] fp32
// logits once and writes the filtered [S, V] once: at S = 8 and V = 128256
// that is 8.2 MB, 2.5 us at 3.35 TB/s. The draw reads [S, V] once and writes
// S tokens: 4.1 MB, 1.2 us.
//
// What the filter's design does about it, and what it does not yet: one CTA
// of 1024 threads per row. The Pallas kernel kept the whole row in VMEM; a
// row here is 513 KB, more than the 227 KB of shared memory a CTA can hold,
// so this first version re-reads the row from global memory (L2-resident at
// 8 rows) on every step of the two 32-step bisections (a top-k count
// bisection over monotone uint32 float keys, then a strictly-greater-mass
// bisection for top-p), and recomputes the masses on the fly instead of
// storing them. A row with top_k disabled (<= 0 or >= V) replaces the count
// bisection by its exact result, the minimum key; a row with top_p >= 1
// skips the mass bisection, whose threshold it never uses. Both shortcuts
// leave every output bit unchanged.
//
// The draw: one CTA of 1024 threads per row reads the row three times (max,
// tile masses, in-tile prefix sums). One thread folds the ~1000 tile masses
// in order in shared memory; then each thread walks one tile's prefix sums
// and the CTA takes the smallest index that crosses the target, so no
// thread waits on another tile's result.
//
// Float masses follow the port's one canonical order (sampling_device.cuh,
// shared with the fused LM head's epilogue), so both kernels are bitwise
// equal to their plain versions in repro_torch/kernels/fused_sampling/ref.py
// and repro_torch/kernels/fused_lm_head/ref.py.

#include "sampling_device.cuh"

namespace {

using sampling::kThreads;
using sampling::kTile;

__global__ void __launch_bounds__(kThreads)
filter_kernel(const float* __restrict__ logits, const int* __restrict__ top_k,
              const float* __restrict__ top_p, float* __restrict__ out,
              int vocab) {
  extern __shared__ float parts[];           // one partial per 128-lane tile
  __shared__ sampling::Scratch sc;
  const float* x = logits + static_cast<size_t>(blockIdx.x) * vocab;
  float* y = out + static_cast<size_t>(blockIdx.x) * vocab;
  sampling::BlockRow row(vocab, parts, sc);
  float kth, th;
  sampling::filter_thresholds([&](int i) { return x[i]; }, row,
                              top_k[blockIdx.x], top_p[blockIdx.x], &kth,
                              &th);
  for (int i = threadIdx.x; i < vocab; i += kThreads) {
    const float v = x[i] < kth ? -INFINITY : x[i];
    y[i] = v < th ? -INFINITY : v;
  }
}

// Inverse-CDF draw of one row: the first index whose prefix mass exceeds
// rs * Z (Z the canonical row mass of exp(x - max)); 0 when none does.
__global__ void __launch_bounds__(kThreads)
draw_kernel(const float* __restrict__ logits, const float* __restrict__ rs,
            int* __restrict__ tokens, int vocab) {
  extern __shared__ float smem[];
  const int n_tiles = (vocab + kTile - 1) / kTile;
  __shared__ sampling::Scratch sc;
  const float* x = logits + static_cast<size_t>(blockIdx.x) * vocab;
  sampling::BlockRow row(vocab, smem, sc);
  const int tok = sampling::draw_index([&](int i) { return x[i]; }, row,
                                       rs[blockIdx.x], smem + n_tiles);
  if (threadIdx.x == 0) tokens[blockIdx.x] = tok;
}

}  // namespace

extern "C" int filter_logits(const void* logits, const void* top_k,
                             const void* top_p, void* out, int rows, int vocab,
                             void* stream) {
  const size_t smem = static_cast<size_t>((vocab + kTile - 1) / kTile) *
                      sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      filter_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  filter_kernel<<<rows, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(logits), static_cast<const int*>(top_k),
      static_cast<const float*>(top_p), static_cast<float*>(out), vocab);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int draw_tokens(const void* logits, const void* rs, void* tokens,
                           int rows, int vocab, void* stream) {
  const size_t smem = 2 * static_cast<size_t>((vocab + kTile - 1) / kTile) *
                      sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      draw_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  draw_kernel<<<rows, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(logits), static_cast<const float*>(rs),
      static_cast<int*>(tokens), vocab);
  return static_cast<int>(cudaGetLastError());
}
