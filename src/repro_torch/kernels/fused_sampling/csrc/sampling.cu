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
// runs at once; 16 for rows of up to 382,976 entries, as command-r-35b's
// 256,000) that reads it from HBM once into its CTAs' shared memory
// (sampling_device.cuh ClusterRow) and writes the result once. Top-k is a
// radix select: four 8-bit passes over the monotone uint32 keys, 256-bin
// counts merged across the cluster through distributed shared memory,
// exact as integer counts are. The masses exp(lgk - max) are written to
// shared memory once. Top-p: an estimate of the nucleus key from four more
// 8-bit passes over fixed-point masses (integers: exact in any order, and
// integer shared-memory atomics combine where float ones serialize), then
// exact sweeps that each evaluate 16 candidate keys, each candidate with
// its own per-tile halving trees and its own left fold, the 16 folds in
// 16 lanes of rank 0 side by side (rank 0 receives the other ranks'
// partials all at once at every served width, in rounds where its shared
// memory cannot hold them all: two at 256,000 entries): the first sweep on
// the estimate and
// keys 4^i from it, which ends the search when the estimate is right; a
// miss retries at the first key with mass left. The strictly-greater mass
// is monotone in the key, so the search ends on the bisection's threshold
// whatever the estimate: the output is bitwise that of
// ref.filter_logits_bisect (ref.filter_logits_search models the search
// step for step). A row with top_k disabled (<= 0 or >= V) takes the
// minimum key for the k-th; a row with top_p >= 1 skips the search, whose
// threshold it never uses. Both shortcuts leave every bit unchanged.
//
// What the draw's design does about it. It takes its rows' uniforms from
// the request seeds and stream positions (threefry2x32 on the card,
// sampling_device.cuh row_uniform), so a sampled step launches no eager
// threefry; a row goes to a thread block cluster of ops.cluster_plan CTAs,
// the filter's and the fused head's, which reads it from HBM once into
// shared memory (each thread's 16 loads in flight before any store); the
// row's max, tile masses, the tile fold and the search then read shared
// memory only (sampling_device.cuh draw_index, which the fused head's
// epilogue runs too). The fold of the ~1000 tile masses is a chain of adds
// in one thread; the in-tile prefix sums and the uniform run beside it, so
// the search after it is one compare an element.
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

// Inverse-CDF draw, one thread block cluster a row: the first index whose
// prefix mass exceeds r * Z (r the row's uniform from seeds[row] and
// positions[row], Z the canonical row mass of exp(x - max)); 0 when none
// does. Dynamic shared memory: sampling::cluster_smem_words.
__global__ void __launch_bounds__(kThreads, 1)
draw_kernel(const float* __restrict__ logits,
            const long long* __restrict__ seeds,
            const void* __restrict__ positions, int pos64,
            int* __restrict__ tokens, int vocab) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ sampling::Scratch sc;
  __shared__ sampling::ClusterShared sh;
  cg::cluster_group cluster = cg::this_cluster();
  const int size = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int row = blockIdx.x / size;
  sampling::ClusterRow crow(vocab, size, rank, smem_raw, sh, sc);
  const float mx = crow.load_floats(logits + static_cast<size_t>(row) * vocab);
  const int tok = sampling::draw_index(
      [&](int lt, int q) {
        return reinterpret_cast<const float4*>(crow.keys +
                                               lt * sampling::kStride)[q];
      },
      crow, mx, static_cast<unsigned>(seeds[row]),
      sampling::position_word(positions, pos64, row));
  if (rank == 0 && threadIdx.x == 0) tokens[row] = tok;
}

// The uniforms alone, one thread a row (for holding them against the plain
// version; no sampling path launches it).
__global__ void uniforms_kernel(const long long* __restrict__ seeds,
                                const void* __restrict__ positions, int pos64,
                                float* __restrict__ out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n)
    out[i] = sampling::row_uniform(
        static_cast<unsigned>(seeds[i]),
        sampling::position_word(positions, pos64, i));
}

// A cluster kernel's shared memory at (vocab, size) CTAs a row, set as its
// launch limit; 0 when the attributes are refused.
template <class Kernel>
size_t cluster_smem(Kernel kernel, int vocab, int size) {
  const size_t smem = sampling::cluster_smem_words(vocab, size) * 4;
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem)) != cudaSuccess ||
      cudaFuncSetAttribute(kernel,
                           cudaFuncAttributeNonPortableClusterSizeAllowed,
                           1) != cudaSuccess)
    return 0;
  return smem;
}

// A launch of `rows` clusters of `size` CTAs of kThreads (the filter's and
// the draw's); attr is the cluster attribute.
cudaLaunchConfig_t cluster_config(int rows, int size, size_t smem,
                                  void* stream, cudaLaunchAttribute* attr) {
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
  const size_t smem = cluster_smem(filter_kernel, vocab, size);
  if (smem == 0) return static_cast<int>(cudaGetLastError());
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      cluster_config(rows, size, smem, stream, &attr);
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
  const size_t smem = cluster_smem(filter_kernel, vocab, size);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(64, size, smem, stream, &attr);
  int n = 0;
  if (smem == 0 ||
      cudaOccupancyMaxActiveClusters(&n, filter_kernel, &cfg) != cudaSuccess) {
    cudaGetLastError();
    return -1;
  }
  return n;
}

// logits [rows, vocab] float32; seeds int64 [rows] (uint32 values);
// positions [rows] int32 (pos64 = 0) or int64 (pos64 = 1); tokens int32
// [rows]; `size` CTAs a row (ops.cluster_plan), 1 to 16.
extern "C" int draw_tokens(const void* logits, const void* seeds,
                           const void* positions, void* tokens, int rows,
                           int vocab, int pos64, int size, void* stream) {
  if (size < 1 || size > sampling::kMaxCluster)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = cluster_smem(draw_kernel, vocab, size);
  if (smem == 0) return static_cast<int>(cudaGetLastError());
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      cluster_config(rows, size, smem, stream, &attr);
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, draw_kernel, static_cast<const float*>(logits),
      static_cast<const long long*>(seeds), positions, pos64,
      static_cast<int*>(tokens), vocab);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// out float32 [n]: row_uniform(seeds[i], positions[i]), as draw_tokens and
// the fused head take them.
extern "C" int row_uniforms(const void* seeds, const void* positions,
                            void* out, int n, int pos64, void* stream) {
  const int threads = 256;
  uniforms_kernel<<<(n + threads - 1) / threads, threads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(seeds), positions, pos64,
      static_cast<float*>(out), n);
  return static_cast<int>(cudaGetLastError());
}
