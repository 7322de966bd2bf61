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
// What the filter's design does about it. The Pallas kernel kept the whole
// row in VMEM; a row here is 513 KB, more than the 227 KB of shared memory
// one CTA can hold, so a row goes to a thread block cluster (its size from
// ops.cluster_plan: 16 CTAs, or 9 at 8-9 rows so that every row's cluster
// runs at once) that reads it from HBM once into its CTAs' shared memory
// (sampling_device.cuh ClusterRow) and writes the result once. Top-k is a
// radix select: four 8-bit passes over the monotone uint32 keys, 256-bin
// counts merged across the cluster through distributed shared memory,
// exact as integer counts are. The masses exp(lgk - max) are written to
// shared memory once. Top-p: an estimate of the nucleus key from four more
// 8-bit passes over fixed-point masses (integers: exact in any order, and
// integer shared-memory atomics combine where float ones serialize), then
// exact sweeps that each evaluate 16 candidate keys, each candidate with
// its own per-tile halving trees and its own left fold, the 16 folds in
// 16 lanes of rank 0 side by side: the first sweep on the estimate and
// keys 4^i from it, which ends the search when the estimate is right; a
// miss retries at the first key with mass left. The strictly-greater mass
// is monotone in the key, so the search ends on the bisection's threshold
// whatever the estimate: the output is bitwise that of
// ref.filter_logits_bisect (ref.filter_logits_search models the search
// step for step). A row with top_k disabled (<= 0 or >= V) takes the
// minimum key for the k-th; a row with top_p >= 1 skips the search, whose
// threshold it never uses. Both shortcuts leave every bit unchanged.
//
// The draw (not redesigned): one CTA of 1024 threads per row reads the row
// three times (max, tile masses, in-tile prefix sums). One thread folds the
// ~1000 tile masses in order in shared memory; then each thread walks one
// tile's prefix sums and the CTA takes the smallest index that crosses the
// target, so no thread waits on another tile's result.
//
// Float masses follow the port's one canonical order (sampling_device.cuh,
// shared with the fused LM head's epilogue), so both kernels are bitwise
// equal to their plain versions in repro_torch/kernels/fused_sampling/ref.py
// and repro_torch/kernels/fused_lm_head/ref.py.

#include "sampling_device.cuh"

namespace {

namespace cg = cooperative_groups;
using sampling::kThreads;
using sampling::kTile;

// One thread block cluster a row: load the row, the thresholds, write the
// filtered row. Dynamic shared memory: sampling::cluster_smem_words.
__global__ void __launch_bounds__(kThreads, 1)
filter_kernel(const float* __restrict__ logits, const int* __restrict__ top_k,
              const float* __restrict__ top_p, float* __restrict__ out,
              int vocab) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ sampling::Scratch sc;
  __shared__ sampling::ClusterShared sh;
  cg::cluster_group cluster = cg::this_cluster();
  const int size = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int row = blockIdx.x / size;
  const float* x = logits + static_cast<size_t>(row) * vocab;
  float* y = out + static_cast<size_t>(row) * vocab;
  sampling::ClusterRow crow(vocab, size, rank, smem_raw, sh, sc);
  crow.load([&](int i) { return x[i]; });
  float kth, th;
  sampling::cluster_thresholds(crow, top_k[row], top_p[row], &kth, &th);
  for (int it = threadIdx.x; it < crow.n_own * 32; it += kThreads) {
    const int lt = it >> 5, q = it & 31, base = (crow.t0 + lt) * kTile + q;
    const uint4 k =
        reinterpret_cast<const uint4*>(crow.keys + lt * sampling::kStride)[q];
    const unsigned kv[4] = {k.x, k.y, k.z, k.w};
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      if (base + 32 * r < vocab) {
        const float v = sampling::key_to_float(kv[r]);
        y[base + 32 * r] = v < th ? -INFINITY : v;
      }
    }
  }
  cluster.sync();            // no CTA leaves while another may read its smem
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

// The filter kernel's shared memory at (vocab, size) CTAs a row, set as its
// launch limit; 0 when the attributes are refused.
size_t filter_smem(int vocab, int size) {
  const size_t smem = sampling::cluster_smem_words(vocab, size) * 4;
  if (cudaFuncSetAttribute(filter_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem)) != cudaSuccess ||
      cudaFuncSetAttribute(filter_kernel,
                           cudaFuncAttributeNonPortableClusterSizeAllowed,
                           1) != cudaSuccess)
    return 0;
  return smem;
}

// A launch of `rows` clusters of `size` CTAs; attr is the cluster attribute.
cudaLaunchConfig_t filter_config(int rows, int size, size_t smem, void* stream,
                                 cudaLaunchAttribute* attr) {
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = size;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(rows * size, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

}  // namespace

// logits and out [rows, vocab] float32, top_k int32 and top_p float32
// [rows]; `size` CTAs a row (ops.cluster_plan), 1 to 16.
extern "C" int filter_logits(const void* logits, const void* top_k,
                             const void* top_p, void* out, int rows, int vocab,
                             int size, void* stream) {
  if (size < 1 || size > sampling::kMaxCluster)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = filter_smem(vocab, size);
  if (smem == 0) return static_cast<int>(cudaGetLastError());
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = filter_config(rows, size, smem, stream, &attr);
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, filter_kernel, static_cast<const float*>(logits),
      static_cast<const int*>(top_k), static_cast<const float*>(top_p),
      static_cast<float*>(out), vocab);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// How many clusters of `size` filter CTAs (at `vocab`'s shared memory) the
// card runs at once (cudaOccupancyMaxActiveClusters), or -1 when it cannot
// run one; a refusal's error is cleared, so no later launch reports it.
extern "C" int filter_active_clusters(int vocab, int size, void* stream) {
  const size_t smem = filter_smem(vocab, size);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = filter_config(64, size, smem, stream, &attr);
  int n = 0;
  if (smem == 0 ||
      cudaOccupancyMaxActiveClusters(&n, filter_kernel, &cfg) != cudaSuccess) {
    cudaGetLastError();
    return -1;
  }
  return n;
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
