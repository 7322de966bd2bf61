// Fused scale + causal mask + softmax over score rows for Hopper (sm_90a):
// s [N, Sq, Sk] -> y = softmax(scale * s + causal mask) over the last axis,
// fp32 statistics, y in s's dtype (fp32 or bf16).
//
// Replaces the TPU kernel src/repro/kernels/fused_softmax/kernel.py:33
// scale_mask_softmax (pallas_call at :40). The plain version is
// repro_torch/kernels/fused_softmax/ref.py scale_mask_softmax, the JAX
// reference's operations in their order.
//
// What bounds it on this card: bytes. It reads s once and writes y once and
// does about six operations an element (scale, max, subtract, exp, add,
// divide): at bert-large's Phase 2 scores [64, 512, 512] fp32 that is
// 134 MB, 40 us at 3.35 TB/s, against 0.1 GFLOP, 1.5 us at 67 TFLOP/s fp32.
//
// What its design does about it. The TPU kernel keeps a 128-row tile in
// VMEM. Here a row stays in registers from its load to its store, so s is
// read once and y written once, the paper's separate scale, mask and
// softmax kernels (Fig. 8) in one pass, with 16-byte loads and stores where
// Sk allows (8-byte, or one element, where it does not) and every load of a
// thread issued before any use. The plan (ops.softmax_plan, from rows, Sk
// and the dtype) picks one of two variants:
//   - a warp a row while a lane holds at most 16 elements (Sk <= 512): 4
//     rows a CTA, reductions by shuffles only, no shared memory and no
//     barrier;
//   - a CTA a row above that (Sk <= 32768): 16 elements a thread (32 past
//     16384 columns), one barrier a reduction (each warp's result in
//     shared memory, every thread then combines them in warp order). A
//     warp holding a longer row loses to it: more registers a thread,
//     fewer rows in flight (at Sk 1500 bf16, 64 elements a lane took 1.7x
//     the time of a CTA of 96 threads, softmax_ablations.py).
// A causal row loads only its valid columns (whole vectors: a vector that
// straddles the edge is loaded and masked) and writes its masked columns as
// zeros with vector stores; a row with no valid column comes out 1 / Sk.
// Unlike the TPU kernel, which asserts whole 128-row tiles, it takes any Sq.
//
// Numerics follow the plain version operation by operation: x = s * scale
// with __fmul_rn, masked entries the finite -1e30, p = expf(x - m) with
// __fsub_rn and expf (not __expf: PyTorch's CUDA exp is expf), y = p / sum
// with IEEE division, rounded once to bf16 where s is bf16. Only the order
// of the sum differs from PyTorch's: each thread adds its own columns in
// order, a butterfly in each warp, then (a CTA a row) the warp sums in warp
// order. Where masked entries exist the row max includes -1e30, as the
// plain version's does; when that is the max (a row with no valid column,
// or valid scores at or below -1e30), every masked entry weighs exp(0) = 1
// and the sum, a count of ones, is exact in any order.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxSk = 32768;        // ops.MAX_SK: 32 elements a thread at
                                     // 1024 threads
constexpr int kMaxThreads = 1024;
constexpr float kNegInf = -1e30f;

using bf16 = __nv_bfloat16;

// L consecutive elements at p (p aligned to L elements) as floats.
template <int L>
__device__ __forceinline__ void load_vec(const float* p, float* x) {
  if constexpr (L == 4) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p));
    x[0] = v.x;
    x[1] = v.y;
    x[2] = v.z;
    x[3] = v.w;
  } else {
    static_assert(L == 1, "fp32 loads of 4 or 1 elements");
    x[0] = __ldg(p);
  }
}

__device__ __forceinline__ void unpack2(unsigned w, float* x) {
  x[0] = __uint_as_float(w << 16);             // element 0: the low half
  x[1] = __uint_as_float(w & 0xFFFF0000u);
}

template <int L>
__device__ __forceinline__ void load_vec(const bf16* p, float* x) {
  if constexpr (L == 8) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
    unpack2(v.x, x);
    unpack2(v.y, x + 2);
    unpack2(v.z, x + 4);
    unpack2(v.w, x + 6);
  } else if constexpr (L == 4) {
    const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
    unpack2(v.x, x);
    unpack2(v.y, x + 2);
  } else {
    static_assert(L == 1, "bf16 loads of 8, 4 or 1 elements");
    x[0] = __uint_as_float(static_cast<unsigned>(
        __ldg(reinterpret_cast<const unsigned short*>(p))) << 16);
  }
}

// L floats to L consecutive elements at p, rounded once where p is bf16.
template <int L>
__device__ __forceinline__ void store_vec(float* p, const float* y) {
  if constexpr (L == 4)
    *reinterpret_cast<float4*>(p) = make_float4(y[0], y[1], y[2], y[3]);
  else
    p[0] = y[0];
}

__device__ __forceinline__ unsigned pack2(const float* y) {
  return static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16_rn(y[0])))
         | (static_cast<unsigned>(
                __bfloat16_as_ushort(__float2bfloat16_rn(y[1]))) << 16);
}

template <int L>
__device__ __forceinline__ void store_vec(bf16* p, const float* y) {
  if constexpr (L == 8)
    *reinterpret_cast<uint4*>(p) =
        make_uint4(pack2(y), pack2(y + 2), pack2(y + 4), pack2(y + 6));
  else if constexpr (L == 4)
    *reinterpret_cast<uint2*>(p) = make_uint2(pack2(y), pack2(y + 2));
  else
    p[0] = __float2bfloat16_rn(y[0]);
}

// Columns 0 .. n - 1 of `row` are valid: all of them, or where causal those
// up to the row's position (row % sq) + q_offset. Rows < 2^31 (the
// wrapper's bound), so the index stays 32-bit: a 64-bit remainder costs
// each thread some hundred instructions.
__device__ __forceinline__ int valid_columns(int row, int sq, int sk,
                                             int q_offset, int causal) {
  if (!causal) return sk;
  const long long last = static_cast<long long>(row % sq) + q_offset;
  return static_cast<int>(
      max(0LL, min(static_cast<long long>(sk), last + 1)));
}

// A row of which this thread holds the vectors at columns col(k) = (k *
// stride + first) * L, k < E / L, in x[]: load and scale the valid entries;
// their local max. Every load is issued unconditionally, before any use: a
// vector with no valid column reads column 0 again (an L1 hit), so device
// memory serves the valid columns only; under a branch a CTA's loads cost
// some 10 registers a thread more and 10-20% of the time (the variant in
// softmax_ablations.py). nvalid >= 1.
template <typename T, int L, int E>
__device__ __forceinline__ float load_row(const T* src, int first, int stride,
                                          int nvalid, float scale, float* x) {
  constexpr int N = E / L;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const int c0 = (k * stride + first) * L;
    load_vec<L>(src + (c0 < nvalid ? c0 : 0), x + k * L);
  }
  float m = -INFINITY;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const int c0 = (k * stride + first) * L;
#pragma unroll
    for (int j = 0; j < L; ++j) {
      if (c0 + j < nvalid) {        // masked entries are never read
        x[k * L + j] = __fmul_rn(x[k * L + j], scale);
        m = fmaxf(m, x[k * L + j]);
      }
    }
  }
  return m;
}

// p = expf(x - m) of the valid entries, in place; their sum in column order.
template <int L, int E>
__device__ __forceinline__ float exp_row(int first, int stride, int nvalid,
                                         float m, float* x) {
  constexpr int N = E / L;
  float acc = 0.f;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const int c0 = (k * stride + first) * L;
#pragma unroll
    for (int j = 0; j < L; ++j) {
      if (c0 + j < nvalid) {
        x[k * L + j] = expf(__fsub_rn(x[k * L + j], m));
        acc = __fadd_rn(acc, x[k * L + j]);
      }
    }
  }
  return acc;
}

// A row with no valid column: 1 / Sk everywhere, whatever s holds (every
// entry is the mask's -1e30, so every p is exp(0) = 1), with nothing read;
// the thread's vectors among the n columns at dst.
template <typename T, int L, int E>
__device__ __forceinline__ void store_uniform(T* dst, int first, int stride,
                                              int n, int sk) {
  constexpr int N = E / L;
  float v[L];
#pragma unroll
  for (int j = 0; j < L; ++j) v[j] = __fdiv_rn(1.f, static_cast<float>(sk));
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const int c0 = (k * stride + first) * L;
    if (c0 < n) store_vec<L>(dst + c0, v);
  }
}

// y = p / total for the thread's vectors among the n columns at dst;
// masked entries 0, or 1 / total when the max is the mask's -1e30 (every
// masked entry then weighs exp(0) = 1).
template <typename T, int L, int E>
__device__ __forceinline__ void store_row(T* dst, int first, int stride,
                                          int nvalid, int n, float m,
                                          float total, float* x) {
  constexpr int N = E / L;
  const float masked = m == kNegInf ? __fdiv_rn(1.f, total) : 0.f;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const int c0 = (k * stride + first) * L;
    if (c0 < n) {
#pragma unroll
      for (int j = 0; j < L; ++j)
        x[k * L + j] = c0 + j < nvalid ? __fdiv_rn(x[k * L + j], total)
                                       : masked;
      store_vec<L>(dst + c0, x + k * L);
    }
  }
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// A butterfly: every lane ends with the same bits.
__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// A warp a row, blockDim.x / 32 rows a CTA; lane l holds the vectors at
// columns (32 k + l) L. Sk <= 32 E.
template <typename T, int L, int E>
__global__ void __launch_bounds__(256)
softmax_warp_kernel(const T* __restrict__ s, T* __restrict__ y, int rows,
                    int sq, int sk, int q_offset, int causal, float scale) {
  const int lane = threadIdx.x & 31;
  const long long wrow =
      static_cast<long long>(blockIdx.x) * (blockDim.x >> 5) +
      (threadIdx.x >> 5);
  if (wrow >= rows) return;
  const int row = static_cast<int>(wrow);
  const size_t off = static_cast<size_t>(row) * sk;
  const int nvalid = valid_columns(row, sq, sk, q_offset, causal);
  if (nvalid == 0) {
    store_uniform<T, L, E>(y + off, lane, 32, sk, sk);
    return;
  }
  float x[E];
  float m = warp_max(load_row<T, L, E>(s + off, lane, 32, nvalid, scale, x));
  if (nvalid < sk) m = fmaxf(m, kNegInf);
  float total = warp_sum(exp_row<L, E>(lane, 32, nvalid, m, x));
  if (m == kNegInf) total = __fadd_rn(total, static_cast<float>(sk - nvalid));
  store_row<T, L, E>(y + off, lane, 32, nvalid, sk, m, total, x);
}

// A CTA a row; thread t holds the vectors at columns (blockDim.x k + t) L.
// Sk <= blockDim.x E.
template <typename T, int L, int E>
__global__ void __launch_bounds__(kMaxThreads)
softmax_cta_kernel(const T* __restrict__ s, T* __restrict__ y, int rows,
                   int sq, int sk, int q_offset, int causal, float scale) {
  __shared__ float red[2][kMaxThreads / 32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int warps = blockDim.x >> 5;
  const int row = blockIdx.x;
  const size_t off = static_cast<size_t>(row) * sk;
  const int nvalid = valid_columns(row, sq, sk, q_offset, causal);
  if (nvalid == 0) {                   // the same for the whole CTA
    store_uniform<T, L, E>(y + off, tid, blockDim.x, sk, sk);
    return;
  }
  float x[E];
  float m = warp_max(
      load_row<T, L, E>(s + off, tid, blockDim.x, nvalid, scale, x));
  if (lane == 0) red[0][warp] = m;
  __syncthreads();
  for (int w = 0; w < warps; ++w) m = fmaxf(m, red[0][w]);
  if (nvalid < sk) m = fmaxf(m, kNegInf);
  const float p = warp_sum(exp_row<L, E>(tid, blockDim.x, nvalid, m, x));
  if (lane == 0) red[1][warp] = p;
  __syncthreads();
  float total = 0.f;
  for (int w = 0; w < warps; ++w) total = __fadd_rn(total, red[1][w]);
  if (m == kNegInf) total = __fadd_rn(total, static_cast<float>(sk - nvalid));
  store_row<T, L, E>(y + off, tid, blockDim.x, nvalid, sk, m, total, x);
}

template <typename T, int L, int E>
int launch_warp(const void* s, void* y, int rows, int sq, int sk,
                int q_offset, int causal, float scale, int threads,
                cudaStream_t st) {
  if (threads < 32 || threads > 256 || threads % 32 || sk > 32 * E)
    return static_cast<int>(cudaErrorInvalidValue);
  const int per_cta = threads / 32;
  softmax_warp_kernel<T, L, E><<<(rows + per_cta - 1) / per_cta, threads, 0,
                                 st>>>(
      static_cast<const T*>(s), static_cast<T*>(y), rows, sq, sk, q_offset,
      causal, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int L, int E>
int launch_cta(const void* s, void* y, int rows, int sq, int sk, int q_offset,
               int causal, float scale, int threads, cudaStream_t st) {
  if (threads < 32 || threads > kMaxThreads || threads % 32 ||
      sk > threads * E)
    return static_cast<int>(cudaErrorInvalidValue);
  softmax_cta_kernel<T, L, E><<<rows, threads, 0, st>>>(
      static_cast<const T*>(s), static_cast<T*>(y), rows, sq, sk, q_offset,
      causal, scale);
  return static_cast<int>(cudaGetLastError());
}

using Launch = int (*)(const void*, void*, int, int, int, int, int, float, int,
                       cudaStream_t);

// The instantiated variants: (bf16, cta, vec, per) -> launcher; nullptr for
// a combination the plan never picks.
template <typename T, bool kCta, int L>
Launch pick_per(int per) {
  if constexpr (kCta) {
    switch (per) {
      case 16: return launch_cta<T, L, 16>;
      case 32: return launch_cta<T, L, 32>;
    }
  } else {
    switch (per) {
      case 4:
        if constexpr (L <= 4) return launch_warp<T, L, 4>;
        break;
      case 8: return launch_warp<T, L, 8>;
      case 16: return launch_warp<T, L, 16>;
    }
  }
  return nullptr;
}

template <typename T, bool kCta>
Launch pick_vec(int vec, int per) {
  switch (vec) {
    case 1: return pick_per<T, kCta, 1>(per);
    case 4: return pick_per<T, kCta, 4>(per);
    case 8:
      if constexpr (sizeof(T) == 2) return pick_per<T, kCta, 8>(per);
      break;
  }
  return nullptr;
}

}  // namespace

// s, y contiguous [rows = N * Sq, sk], fp32 (is_bf16 = 0) or bf16, both
// aligned to `vec` elements; row r is query row r % sq, at position
// (r % sq) + q_offset; 1 <= sk <= kMaxSk. The plan (ops.softmax_plan):
// cta = 0, a warp a row, threads / 32 rows a CTA, `per` elements a lane
// (4, 8, 16; at least vec); cta = 1, a CTA of `threads` a row, `per`
// elements a thread (16, 32); `vec` elements a load (fp32 4 or 1, bf16 8, 4
// or 1), dividing sk.
extern "C" int scale_mask_softmax(const void* s, void* y, int rows, int sq,
                                  int sk, int q_offset, int causal,
                                  int is_bf16, int cta, int vec, int per,
                                  int threads, float scale, void* stream) {
  if (sk < 1 || sk > kMaxSk || sq < 1 || rows < 1 || vec < 1 || sk % vec)
    return static_cast<int>(cudaErrorInvalidValue);
  const Launch fn =
      is_bf16 ? (cta ? pick_vec<bf16, true>(vec, per)
                     : pick_vec<bf16, false>(vec, per))
              : (cta ? pick_vec<float, true>(vec, per)
                     : pick_vec<float, false>(vec, per));
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return fn(s, y, rows, sq, sk, q_offset, causal, scale, threads,
            static_cast<cudaStream_t>(stream));
}
