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
// Float masses follow the port's one canonical order, which
// repro_torch/kernels/fused_sampling/ref.py and
// repro_torch/kernels/fused_lm_head/ref.py follow too, so both kernels are
// bitwise equal to their plain versions: inside each 128-lane tile a halving
// tree x[:w/2] + x[w/2:] for w = 128 ... 2 (one warp per tile), across
// tiles a strictly sequential left fold (((0 + p0) + p1) + ...); the draw's
// in-tile prefix sums are strictly sequential too, and a lane's prefix mass
// is (fold of the tiles before) + (its in-tile prefix sum).
// Logits are assumed free of NaN (max and compares follow IEEE for the rest,
// -inf rows included).

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 128;
constexpr int kBisectSteps = 32;
constexpr unsigned kTopKey = 0xFFFFFFFEu;
constexpr float kTFloor = 1.1754943508222875e-38f;   // smallest normal fp32

__device__ __forceinline__ unsigned float_to_key(float f) {
  const unsigned b = __float_as_uint(f);
  return (b >> 31) ? ~b : (b ^ 0x80000000u);
}

__device__ __forceinline__ float key_to_float(unsigned k) {
  const unsigned b = (k >> 31) == 0 ? ~k : (k ^ 0x80000000u);
  return __uint_as_float(b);
}

struct SumOp {
  template <class T> __device__ T operator()(T a, T b) const { return a + b; }
};
struct MinOp {
  template <class T> __device__ T operator()(T a, T b) const {
    return a < b ? a : b;
  }
};
struct MaxOp {
  __device__ float operator()(float a, float b) const { return fmaxf(a, b); }
};

// Block-wide reduction of an order-independent op (integer sums, min, max).
template <class T, class Op>
__device__ T block_reduce(T v, Op op, T* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int o = 16; o > 0; o >>= 1) v = op(v, __shfl_xor_sync(0xffffffffu, v, o));
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = red[lane];                           // kWarps == 32
    for (int o = 16; o > 0; o >>= 1)
      v = op(v, __shfl_xor_sync(0xffffffffu, v, o));
    if (lane == 0) red[0] = v;
  }
  __syncthreads();
  const T r = red[0];
  __syncthreads();
  return r;
}

// Per-tile masses parts[t] of f(i), i in [0, n_tiles * 128): one halving
// tree per tile, one warp per tile.
template <class F>
__device__ void tile_partials(F f, int n_tiles, float* parts) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int t = warp; t < n_tiles; t += kWarps) {
    const int base = t * kTile + lane;
    const float x0 = f(base), x1 = f(base + 32), x2 = f(base + 64),
                x3 = f(base + 96);
    // w = 128: lanes l and l + 32 of x[:64] + x[64:]; w = 64: their sum
    float z = __fadd_rn(__fadd_rn(x0, x2), __fadd_rn(x1, x3));
    for (int o = 16; o > 0; o >>= 1)          // w = 32 ... 2
      z = __fadd_rn(z, __shfl_down_sync(0xffffffffu, z, o));
    if (lane == 0) parts[t] = z;
  }
  __syncthreads();
}

// Canonical row sum of f(i), i in [0, V): per-tile halving trees, then a
// sequential left fold of the tile partials by one thread.
template <class F>
__device__ float tiled_sum(F f, int n_tiles, float* parts, float* bcast) {
  tile_partials(f, n_tiles, parts);
  if (threadIdx.x == 0) {
    float acc = 0.f;
    for (int t = 0; t < n_tiles; ++t) acc = __fadd_rn(acc, parts[t]);
    *bcast = acc;
  }
  __syncthreads();
  const float r = *bcast;
  __syncthreads();
  return r;
}

__global__ void __launch_bounds__(kThreads)
filter_kernel(const float* __restrict__ logits, const int* __restrict__ top_k,
              const float* __restrict__ top_p, float* __restrict__ out,
              int vocab) {
  extern __shared__ float parts[];           // one partial per 128-lane tile
  __shared__ int ired[kWarps];
  __shared__ unsigned ured[kWarps];
  __shared__ float fred[kWarps];
  __shared__ float bcast;

  const float* x = logits + static_cast<size_t>(blockIdx.x) * vocab;
  float* y = out + static_cast<size_t>(blockIdx.x) * vocab;
  const int n_tiles = (vocab + kTile - 1) / kTile;
  const int tid = threadIdx.x;

  // ---- top-k: largest key with count(keys >= key) >= k ----
  const int tk = top_k[blockIdx.x];
  const int k = tk <= 0 ? vocab : min(tk, vocab);
  unsigned lo = 0u, hi = kTopKey;
  if (k >= vocab) {
    unsigned mn = 0xFFFFFFFFu;
    for (int i = tid; i < vocab; i += kThreads) mn = min(mn, float_to_key(x[i]));
    lo = min(block_reduce(mn, MinOp(), ured), kTopKey);
  } else {
    for (int step = 0; step < kBisectSteps; ++step) {
      const unsigned mid = lo + ((hi - lo + 1u) >> 1);
      int cnt = 0;
      for (int i = tid; i < vocab; i += kThreads)
        cnt += float_to_key(x[i]) >= mid ? 1 : 0;
      const bool ok = block_reduce(cnt, SumOp(), ired) >= k;
      lo = ok ? mid : lo;
      hi = ok ? hi : mid - 1u;
    }
  }
  const float kth = key_to_float(lo);
  auto lgk = [&](int i) { const float v = x[i]; return v < kth ? -INFINITY : v; };

  // ---- top-p: smallest key whose strictly-greater mass stays under T ----
  const float tp = top_p[blockIdx.x];
  float th = -INFINITY;
  if (tp < 1.0f) {
    float mx = -INFINITY;
    for (int i = tid; i < vocab; i += kThreads) mx = fmaxf(mx, lgk(i));
    const float m = block_reduce(mx, MaxOp(), fred);
    const float safe_m = isfinite(m) ? m : 0.f;
    auto mass = [&](int i) {
      return i < vocab ? expf(__fsub_rn(lgk(i), safe_m)) : 0.f;
    };
    const float z = tiled_sum(mass, n_tiles, parts, &bcast);
    const float t = fmaxf(__fmul_rn(tp, z), kTFloor);
    unsigned plo = 0u, phi = kTopKey;
    for (int step = 0; step < kBisectSteps; ++step) {
      const unsigned mid = plo + ((phi - plo) >> 1);
      auto above = [&](int i) {
        return (i < vocab && float_to_key(lgk(i)) > mid) ? mass(i) : 0.f;
      };
      const bool ok = tiled_sum(above, n_tiles, parts, &bcast) < t;
      plo = ok ? plo : mid + 1u;
      phi = ok ? mid : phi;
    }
    th = key_to_float(phi);
  }

  for (int i = tid; i < vocab; i += kThreads) {
    const float v = lgk(i);
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
  float* parts = smem;                       // tile masses
  float* before = smem + n_tiles;            // fold of the tiles before t
  __shared__ int ired[kWarps];
  __shared__ float fred[kWarps];
  __shared__ float bcast;

  const float* x = logits + static_cast<size_t>(blockIdx.x) * vocab;
  const int tid = threadIdx.x;
  float mx = -INFINITY;
  for (int i = tid; i < vocab; i += kThreads) mx = fmaxf(mx, x[i]);
  const float m = block_reduce(mx, MaxOp(), fred);
  const float safe_m = isfinite(m) ? m : 0.f;
  auto mass = [&](int i) {
    return i < vocab ? expf(__fsub_rn(x[i], safe_m)) : 0.f;
  };
  tile_partials(mass, n_tiles, parts);
  if (tid == 0) {
    float acc = 0.f;
    for (int t = 0; t < n_tiles; ++t) {
      before[t] = acc;
      acc = __fadd_rn(acc, parts[t]);
    }
    bcast = acc;
  }
  __syncthreads();
  const float target = __fmul_rn(rs[blockIdx.x], bcast);

  // each thread's tiles in increasing order: its first hit is its smallest
  int first = INT_MAX;
  for (int t = tid; t < n_tiles && first == INT_MAX; t += kThreads) {
    const float acc = before[t];
    float c = 0.f;
    for (int j = 0; j < kTile; ++j) {
      c = __fadd_rn(c, mass(t * kTile + j));
      if (__fadd_rn(acc, c) > target) {
        first = t * kTile + j;
        break;
      }
    }
  }
  first = block_reduce(first, MinOp(), ired);
  if (tid == 0) tokens[blockIdx.x] = first == INT_MAX ? 0 : first;
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
