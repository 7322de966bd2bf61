// Device code of the port's sampler, shared by the filter and draw kernels
// (sampling.cu) and the fused LM head's epilogue
// (../../fused_lm_head/csrc/head_tokens.cu): monotone float keys, block
// reductions, the canonical tiled mass sum, the top-k / top-p threshold
// bisections and the inverse-CDF draw. Each takes the row as a functor
// x(i) -> float, so a caller can feed stored fp32 logits, or bf16 logits
// scaled on the fly, through the same arithmetic, and a row policy that
// says which part of the row the calling CTA owns and how it reduces across
// the row (BlockRow here: one CTA owns it all; the fused LM head spreads a
// row over a thread block cluster).
//
// Float masses follow the port's one canonical order, which
// repro_torch/kernels/fused_sampling/ref.py and
// repro_torch/kernels/fused_lm_head/ref.py follow too, so every kernel built
// on this header is bitwise equal to its plain version: inside each 128-lane
// tile a halving tree x[:w/2] + x[w/2:] for w = 128 ... 2 (one warp per
// tile), across tiles a strictly sequential left fold (((0 + p0) + p1) +
// ...); the draw's in-tile prefix sums are strictly sequential too, and a
// lane's prefix mass is (fold of the tiles before) + (its in-tile prefix
// sum). Logits are assumed free of NaN (max and compares follow IEEE for
// the rest, -inf rows included). Every function here expects a CTA of
// kThreads threads, and every CTA of a row to make the same calls.
#pragma once

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace sampling {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 128;
constexpr int kBisectSteps = 32;
constexpr unsigned kTopKey = 0xFFFFFFFEu;
constexpr float kTFloor = 1.1754943508222875e-38f;   // smallest normal fp32

// Shared scratch of the block reductions.
struct Scratch {
  int ired[kWarps];
  unsigned ured[kWarps];
  float fred[kWarps];
  float bcast;
};

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

__device__ __forceinline__ int* red_of(Scratch& s, int) { return s.ired; }
__device__ __forceinline__ unsigned* red_of(Scratch& s, unsigned) {
  return s.ured;
}
__device__ __forceinline__ float* red_of(Scratch& s, float) { return s.fred; }

// A row owned by one CTA: elements [0, vocab), every 128-lane tile. The
// functions below take a row policy: the element range [lo, hi) and the
// tile range [t0, t1) the CTA owns, reduce(v, op) over the whole row (op
// order-independent), parts() where the CTA writes its tiles' partials,
// and fold(before), the canonical left fold of all partials (before[t], if
// given, gets the fold of the tiles before t).
struct BlockRow {
  int vocab, n_tiles, lo, hi, t0, t1;
  float* parts_;
  Scratch& sc;

  __device__ BlockRow(int v, float* parts, Scratch& s)
      : vocab(v), n_tiles((v + kTile - 1) / kTile), lo(0), hi(v), t0(0),
        t1((v + kTile - 1) / kTile), parts_(parts), sc(s) {}
  __device__ float* parts() { return parts_; }
  template <class T, class Op> __device__ T reduce(T v, Op op) {
    return block_reduce(v, op, red_of(sc, v));
  }
  __device__ float fold(float* before) {
    if (threadIdx.x == 0) {
      float acc = 0.f;
      for (int t = 0; t < n_tiles; ++t) {
        if (before != nullptr) before[t] = acc;
        acc = __fadd_rn(acc, parts_[t]);
      }
      sc.bcast = acc;
    }
    __syncthreads();
    const float r = sc.bcast;
    __syncthreads();
    return r;
  }
};

// Per-tile masses parts[t] of f(i) for the row's own tiles: one halving
// tree per tile, one warp per tile.
template <class Row, class F>
__device__ void tile_partials(F f, Row& row) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* parts = row.parts();
  for (int t = row.t0 + warp; t < row.t1; t += kWarps) {
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
// sequential left fold of the tile partials.
template <class Row, class F>
__device__ float tiled_sum(F f, Row& row) {
  tile_partials(f, row);
  return row.fold(nullptr);
}

// The top-k / nucleus top-p thresholds of one row x(i), i in [0, vocab):
// entries below *kth are dropped by top-k, then entries below *th by top-p
// (-inf when top_p >= 1). top_k <= 0 or >= vocab disables top-k; its count
// bisection is then replaced by its exact result, the minimum key, and a
// row with top_p >= 1 skips the mass bisection. Neither shortcut changes a
// bit of the result. x is read only on the row's own range.
template <class Row, class X>
__device__ void filter_thresholds(X x, Row& row, int top_k, float top_p,
                                  float* kth_out, float* th_out) {
  const int vocab = row.vocab;
  const int tid = threadIdx.x;

  // ---- top-k: largest key with count(keys >= key) >= k ----
  const int k = top_k <= 0 ? vocab : min(top_k, vocab);
  unsigned lo = 0u, hi = kTopKey;
  if (k >= vocab) {
    unsigned mn = 0xFFFFFFFFu;
    for (int i = row.lo + tid; i < row.hi; i += kThreads)
      mn = min(mn, float_to_key(x(i)));
    lo = min(row.reduce(mn, MinOp()), kTopKey);
  } else {
    for (int step = 0; step < kBisectSteps; ++step) {
      const unsigned mid = lo + ((hi - lo + 1u) >> 1);
      int cnt = 0;
      for (int i = row.lo + tid; i < row.hi; i += kThreads)
        cnt += float_to_key(x(i)) >= mid ? 1 : 0;
      const bool ok = row.reduce(cnt, SumOp()) >= k;
      lo = ok ? mid : lo;
      hi = ok ? hi : mid - 1u;
    }
  }
  const float kth = key_to_float(lo);
  auto lgk = [&](int i) { const float v = x(i); return v < kth ? -INFINITY : v; };

  // ---- top-p: smallest key whose strictly-greater mass stays under T ----
  float th = -INFINITY;
  if (top_p < 1.0f) {
    float mx = -INFINITY;
    for (int i = row.lo + tid; i < row.hi; i += kThreads) mx = fmaxf(mx, lgk(i));
    const float m = row.reduce(mx, MaxOp());
    const float safe_m = isfinite(m) ? m : 0.f;
    auto mass = [&](int i) {
      return i < vocab ? expf(__fsub_rn(lgk(i), safe_m)) : 0.f;
    };
    const float z = tiled_sum(mass, row);
    const float t = fmaxf(__fmul_rn(top_p, z), kTFloor);
    unsigned plo = 0u, phi = kTopKey;
    for (int step = 0; step < kBisectSteps; ++step) {
      const unsigned mid = plo + ((phi - plo) >> 1);
      auto above = [&](int i) {
        return (i < vocab && float_to_key(lgk(i)) > mid) ? mass(i) : 0.f;
      };
      const bool ok = tiled_sum(above, row) < t;
      plo = ok ? plo : mid + 1u;
      phi = ok ? mid : phi;
    }
    th = key_to_float(phi);
  }
  *kth_out = kth;
  *th_out = th;
}

// Inverse-CDF draw of one row x(i), i in [0, vocab): the first index whose
// prefix mass exceeds r * Z (Z the canonical row mass of exp(x - max)); 0
// when none does. before holds one float per 128-lane tile.
template <class Row, class X>
__device__ int draw_index(X x, Row& row, float r, float* before) {
  const int vocab = row.vocab;
  const int tid = threadIdx.x;
  float mx = -INFINITY;
  for (int i = row.lo + tid; i < row.hi; i += kThreads) mx = fmaxf(mx, x(i));
  const float m = row.reduce(mx, MaxOp());
  const float safe_m = isfinite(m) ? m : 0.f;
  auto mass = [&](int i) {
    return i < vocab ? expf(__fsub_rn(x(i), safe_m)) : 0.f;
  };
  tile_partials(mass, row);
  const float target = __fmul_rn(r, row.fold(before));

  // each thread's tiles in increasing order: its first hit is its smallest
  int first = INT_MAX;
  for (int t = row.t0 + tid; t < row.t1 && first == INT_MAX; t += kThreads) {
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
  first = row.reduce(first, MinOp());
  return first == INT_MAX ? 0 : first;
}

}  // namespace sampling
