// Device code of the port's sampler, shared by the filter and draw kernels
// (sampling.cu) and the fused LM head's epilogue
// (../../fused_lm_head/csrc/head_tokens.cu): monotone float keys, block
// reductions, the canonical tiled mass sum, the row of a thread block
// cluster with its top-k radix select and its multi-candidate nucleus
// search, the draw uniform (threefry2x32, bit for bit jax.random's) and the
// inverse-CDF draw on a cluster row. The draw takes the row as a functor
// x(i) -> float.
//
// Float masses follow the port's one canonical order, which
// repro_torch/kernels/fused_sampling/ref.py and
// repro_torch/kernels/fused_lm_head/ref.py follow too, so every kernel built
// on this header is bitwise equal to its plain version: inside each 128-lane
// tile a halving tree x[:w/2] + x[w/2:] for w = 128 ... 2, across tiles a
// strictly sequential left fold (((0 + p0) + p1) + ...); the draw's in-tile
// prefix sums are strictly sequential too, and a lane's prefix mass is (fold
// of the tiles before) + (its in-tile prefix sum). Logits are assumed free of
// NaN (max and compares follow IEEE for the rest, -inf rows included). Every
// function here expects a CTA of kThreads threads, and every CTA of a row to
// make the same calls.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace sampling {

namespace cg = cooperative_groups;

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 128;
constexpr unsigned kTopKey = 0xFFFFFFFEu;
constexpr float kTFloor = 1.1754943508222875e-38f;   // smallest normal fp32
constexpr int kCand = 16;            // nucleus candidates a sweep (ref.CANDIDATES)
constexpr int kTilesAWarp = 32 / kCand;   // tiles a warp's lanes take at once
constexpr int kMaxCluster = 16;      // CTAs a row, at most
constexpr int kBins = 256;           // radix digits of 8 bits
constexpr int kStride = kTile + 4;   // words a tile takes in a CTA's copy
constexpr int kMaxSweeps = 64;       // a search that has not ended by then traps
constexpr int kFoldAhead = 8;        // terms a fold loads ahead
constexpr int kPrefixAhead = 4;      // float4s the draw's fold loads ahead
constexpr int kLoadAhead = 4;        // (tile, q) items a thread loads at once
constexpr int kScanAhead = 16;       // words the in-tile prefix sums load
                                     // ahead
constexpr int kSearchAhead = 4;      // tiles a warp's search reads at once
constexpr int kSmemBytes = 232448 - 10240;   // dynamic shared memory a CTA
                                             // may take (ops.SMEM_BYTES)
constexpr float kFixedOne = 4294967296.f;   // 2^32: estimate masses' fixed
                                            // point (ref.FIXED_ONE)

// Shared scratch of the block reductions.
struct Scratch {
  int ired[kWarps];
  unsigned ured[kWarps];
  float fred[kWarps];
};

__device__ __forceinline__ unsigned float_to_key(float f) {
  const unsigned b = __float_as_uint(f);
  return (b >> 31) ? ~b : (b ^ 0x80000000u);
}

__device__ __forceinline__ float key_to_float(unsigned k) {
  const unsigned b = (k >> 31) == 0 ? ~k : (k ^ 0x80000000u);
  return __uint_as_float(b);
}

struct MinOp {
  template <class T> __device__ T operator()(T a, T b) const {
    return a < b ? a : b;
  }
};
struct MaxOp {
  __device__ float operator()(float a, float b) const { return fmaxf(a, b); }
};

// Block-wide reduction of an order-independent op (min, max).
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
  return row.fold();
}

// ---------------------------------------------------------------------------
// A row spread over a thread block cluster.
//
// CTA `rank` of `size` owns tiles [t0, t1), `per` = ceil(n_tiles / size) a
// rank, and keeps them in shared memory: keys[] (the monotone keys of its
// logits, after top-k those of the top-k-masked logits) and u[] (the masses
// exp(lgk - max), written once), kStride words a tile. Element j of a tile
// sits at word tile_pos(j): float4 q holds elements q, q + 32, q + 64 and
// q + 96, the four leaves the halving tree joins first ((x_q + x_{q+64}) +
// (x_{q+32} + x_{q+96})), so a tree reads whole float4s; the 4 spare words
// a tile shift the next tile by 16 bytes, so the lane groups of a warp
// reading neighbouring tiles hit different banks.
//
// A row's single tile masses (tiled_sum, the draw) go into rank 0's stage
// (distributed shared memory), one word a tile; after a cluster barrier
// rank 0 folds them in tile order, the canonical order, and writes the
// result to every rank; a second barrier publishes it. A nucleus sweep's
// kCand partials a tile, kCand words side by side, go the same way into
// rank 0's stage and the recv[] after it (under the draw's before[]), tile
// t at word t kCand: as many ranks' tiles at once as rank 0's
// shared memory holds beside the rest (nseg other ranks,
// cluster_recv_segments). At every served width that is every rank, so
// each writes its partials straight into rank 0 and one cluster barrier
// comes before rank 0's fold over the row. A wider row goes in `rounds`:
// the ranks past the first round write their own stage, and each round's
// ranks copy it into recv[] once rank 0 has folded the round before
// (sweep_fold). Either way rank 0 folds in tile order, the canonical
// order. Buffers reused across exchanges follow a parity: one is written
// again only after every rank has passed the barrier that follows its last
// read.
__device__ __forceinline__ int tile_pos(int j) {
  return (j & 31) * 4 + (j >> 5);
}

// The left fold acc = ((acc0 + p[0]) + p[s]) + ... of n terms, before[i]
// (if given) the fold of the terms before i. The next kFoldAhead terms are
// loaded while the current ones are added, so no add waits on a load.
__device__ __forceinline__ float fold_run(const float* p, int n, int s,
                                          float* before, float acc0 = 0.f) {
  float acc = acc0, cur[kFoldAhead], nxt[kFoldAhead];
  const int full = n - n % kFoldAhead;
  if (full > 0) {
#pragma unroll
    for (int j = 0; j < kFoldAhead; ++j) nxt[j] = p[j * s];
  }
  for (int i = 0; i < full; i += kFoldAhead) {
#pragma unroll
    for (int j = 0; j < kFoldAhead; ++j) cur[j] = nxt[j];
    if (i + kFoldAhead < full) {
#pragma unroll
      for (int j = 0; j < kFoldAhead; ++j)
        nxt[j] = p[(i + kFoldAhead + j) * s];
    }
#pragma unroll
    for (int j = 0; j < kFoldAhead; ++j) {
      if (before != nullptr) before[i + j] = acc;
      acc = __fadd_rn(acc, cur[j]);
    }
  }
  for (int i = full; i < n; ++i) {
    if (before != nullptr) before[i] = acc;
    acc = __fadd_rn(acc, p[i * s]);
  }
  return acc;
}

struct ClusterShared {
  unsigned hist[2][kBins];     // radix counts, by pass parity
  unsigned tot[kBins];         // the cluster's counts of one pass
  unsigned cand[kCand];        // the sweep's candidate keys
  unsigned slot[2];            // reduce() words, by parity
  unsigned red;                // reduce()'s result
  unsigned radix[2];           // the digits found so far, the rank still wanted
  unsigned dec[2];             // rank 0's decision: plo, phi
  float zres;                  // rank 0's fold
  float uni;                   // the draw's uniform
  float dmax;                  // the draw's CTA max
  unsigned dlocal, dmin;       // the draw's least hit: the CTA's, rank 0's
  unsigned mhist[2][2 * kBins];         // estimate_key's masses, by pass
  unsigned long long mtot[kBins];       // the cluster's masses of one pass
  unsigned long long above;             // the mass above the prefix found
};

__device__ __forceinline__ unsigned to_word(int v) {
  return static_cast<unsigned>(v);
}
__device__ __forceinline__ unsigned to_word(unsigned v) { return v; }
__device__ __forceinline__ unsigned to_word(float v) {
  return __float_as_uint(v);
}
template <class T> __device__ T from_word(unsigned w);
template <> __device__ __forceinline__ int from_word<int>(unsigned w) {
  return static_cast<int>(w);
}
template <> __device__ __forceinline__ unsigned from_word<unsigned>(unsigned w) {
  return w;
}
template <> __device__ __forceinline__ float from_word<float>(unsigned w) {
  return __uint_as_float(w);
}

// Dynamic shared memory of a cluster row, in 4-byte words: keys and u of
// `per` tiles; the stage, kCand partials for each of them; recv[], the
// partials of nseg ranks' tiles. In rank 0 the stage also holds one mass a
// tile of the row (running on into recv[] where per kCand < n_tiles, which
// only kCand < size makes), and before[] (a prefix a tile) starts past
// both, over recv[] (whose sweeps never meet a draw).
__host__ __device__ inline int cluster_tiles_per_rank(int vocab, int size) {
  const int n_tiles = (vocab + kTile - 1) / kTile;
  return (n_tiles + size - 1) / size;
}
// The other ranks whose sweep partials rank 0 receives at once: as many as
// its shared memory holds beside the rest, at least one, at most size - 1.
__host__ __device__ inline int cluster_recv_segments(int vocab, int size) {
  if (size <= 1) return 0;
  const int per = cluster_tiles_per_rank(vocab, size);
  const int base = per * (2 * kStride + kCand);
  const int fit = (kSmemBytes / 4 - base) / (per * kCand);
  return fit < 1 ? 1 : fit < size - 1 ? fit : size - 1;
}
__host__ __device__ inline int cluster_before_offset(int vocab, int size) {
  const int parts = ((vocab + kTile - 1) / kTile + 3) / 4 * 4;
  const int own = cluster_tiles_per_rank(vocab, size) * kCand;
  return own > parts ? own : parts;
}
__host__ __device__ inline size_t cluster_smem_words(int vocab, int size) {
  const int n_tiles = (vocab + kTile - 1) / kTile;
  const int per = cluster_tiles_per_rank(vocab, size);
  const int sweep = (1 + cluster_recv_segments(vocab, size)) * per * kCand;
  const int draw = cluster_before_offset(vocab, size) + n_tiles;
  return static_cast<size_t>(per) * 2 * kStride +
         (sweep > draw ? sweep : draw);
}

// One tile's mass strictly above candidate c: the halving tree of
// u[j] * (key[j] > c). Subtree (a, s) joins float4s a, a + s, a + 2 s, ...
// as the tree does (T(a, s) = T(a, 2 s) + T(a + s, 2 s)); a float4 is the
// tree's first two levels over its four leaves.
template <int A, int S>
__device__ __forceinline__ float cand_tree(const uint4* k4, const float4* u4,
                                           unsigned c) {
  if constexpr (S == 32) {
    const uint4 k = k4[A];
    const float4 w = u4[A];
    const float x0 = k.x > c ? w.x : 0.f, x1 = k.y > c ? w.y : 0.f;
    const float x2 = k.z > c ? w.z : 0.f, x3 = k.w > c ? w.w : 0.f;
    return __fadd_rn(__fadd_rn(x0, x2), __fadd_rn(x1, x3));
  } else {
    return __fadd_rn(cand_tree<A, 2 * S>(k4, u4, c),
                     cand_tree<A + S, 2 * S>(k4, u4, c));
  }
}

__device__ __forceinline__ float cand_tile_sum(const unsigned* kt,
                                               const float* ut, unsigned c) {
  return cand_tree<0, 1>(reinterpret_cast<const uint4*>(kt),
                         reinterpret_cast<const float4*>(ut), c);
}

struct ClusterRow {
  int vocab, n_tiles, per, size, rank, t0, t1, lo, hi, n_own;
  int nseg, rounds;  // other ranks rank 0 receives at once; rounds a sweep
  unsigned* keys;
  float* u;
  float* stage;      // this CTA's: its tiles' sweep partials (rank 0's
                     // run on into its recv[], per kCand words on)
  float* stage0;     // rank 0's, through distributed shared memory: a
                     // mass a tile of the row
  float* recv;       // after the stage: other ranks' sweep partials
  float* recv0;      // rank 0's, through distributed shared memory
  float* before;     // the draw's prefix a tile (over recv[])
  ClusterShared& sh;
  Scratch& sc;
  int phase;

  __device__ ClusterRow(int v, int sz, int rk, unsigned char* smem,
                        ClusterShared& s, Scratch& scr)
      : vocab(v), n_tiles((v + kTile - 1) / kTile),
        per(cluster_tiles_per_rank(v, sz)), size(sz), rank(rk),
        nseg(cluster_recv_segments(v, sz)), sh(s), sc(scr), phase(0) {
    rounds = nseg > 0 ? (sz - 1 + nseg - 1) / nseg : 1;
    t0 = min(rank * per, n_tiles);
    t1 = min(t0 + per, n_tiles);
    lo = min(t0 * kTile, vocab);
    hi = min(t1 * kTile, vocab);
    n_own = t1 - t0;
    keys = reinterpret_cast<unsigned*>(smem);
    u = reinterpret_cast<float*>(keys + per * kStride);
    stage = u + per * kStride;
    recv = stage + per * kCand;
    before = stage + cluster_before_offset(v, sz);
    stage0 = cg::this_cluster().map_shared_rank(stage, 0);
    recv0 = cg::this_cluster().map_shared_rank(recv, 0);
  }

  // word of element i (i in [lo, hi) plus the last tile's padding)
  __device__ int pos(int i) const {
    return (i / kTile - t0) * kStride + tile_pos(i % kTile);
  }
  __device__ float* parts() { return stage0; }

  // Fill keys[] with float_to_key(x(i)) and u[] with 0; padding past vocab
  // holds key 0 and mass 0. Thread (tile, q) reads x(i) for i = tile + q +
  // 32 r, r = 0..3, and stores one float4 of each.
  template <class X> __device__ void load(X x) {
    for (int it = threadIdx.x; it < n_own * 32; it += kThreads) {
      const int lt = it >> 5, q = it & 31, base = (t0 + lt) * kTile + q;
      uint4 k;
      k.x = base < vocab ? float_to_key(x(base)) : 0u;
      k.y = base + 32 < vocab ? float_to_key(x(base + 32)) : 0u;
      k.z = base + 64 < vocab ? float_to_key(x(base + 64)) : 0u;
      k.w = base + 96 < vocab ? float_to_key(x(base + 96)) : 0u;
      reinterpret_cast<uint4*>(keys + lt * kStride)[q] = k;
      reinterpret_cast<float4*>(u + lt * kStride)[q] =
          make_float4(0.f, 0.f, 0.f, 0.f);
    }
    __syncthreads();
  }

  // Fill keys[] with the bits of the float x[i] itself (the draw reads
  // floats, not keys); padding past vocab holds 0. As load(), with every
  // thread's loads of up to kLoadAhead (tile, q) items issued before any
  // store, so a thread keeps 16 loads in flight. Returns the max of the
  // thread's own loads (draw_index's local max).
  __device__ float load_floats(const float* __restrict__ x) {
    const int n = n_own * 32;
    float mx = -INFINITY;
    for (int it0 = threadIdx.x; it0 < n; it0 += kLoadAhead * kThreads) {
      float v[kLoadAhead][4];
#pragma unroll
      for (int a = 0; a < kLoadAhead; ++a) {
        const int it = it0 + a * kThreads;
        const int base = (t0 + (it >> 5)) * kTile + (it & 31);
#pragma unroll
        for (int r = 0; r < 4; ++r)
          v[a][r] = it < n && base + 32 * r < vocab ? __ldg(x + base + 32 * r)
                                                    : -INFINITY;
      }
#pragma unroll
      for (int a = 0; a < kLoadAhead; ++a) {
        const int it = it0 + a * kThreads;
        if (it < n)
          reinterpret_cast<float4*>(keys + (it >> 5) * kStride)[it & 31] =
              make_float4(v[a][0], v[a][1], v[a][2], v[a][3]);
#pragma unroll
        for (int r = 0; r < 4; ++r) mx = fmaxf(mx, v[a][r]);
      }
    }
    __syncthreads();
    return mx;
  }

  // Calls f(i, word) for every own element i < vocab.
  template <class F> __device__ void for_each(F f) const {
    for (int it = threadIdx.x; it < n_own * kTile; it += kThreads) {
      const int lt = it >> 7, j = it & (kTile - 1);
      const int i = (t0 + lt) * kTile + j;
      if (i < vocab) f(i, lt * kStride + tile_pos(j));
    }
  }

  // Reduction over the row by an idempotent op (min, max): the CTA's result
  // into slot[parity], a cluster barrier, then warp 0 combines every rank's
  // (lanes past the cluster's size read rank 0's again).
  template <class T, class Op> __device__ T reduce(T v, Op op) {
    cg::cluster_group cluster = cg::this_cluster();
    const T local = block_reduce(v, op, red_of(sc, v));
    unsigned* s = sh.slot + (phase & 1);
    if (threadIdx.x == 0) *s = to_word(local);
    cluster.sync();
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      T r = from_word<T>(*cluster.map_shared_rank(s, lane < size ? lane : 0));
      for (int o = 16; o > 0; o >>= 1) r = op(r, __shfl_xor_sync(0xffffffffu, r, o));
      if (lane == 0) sh.red = to_word(r);
    }
    __syncthreads();
    const T r = from_word<T>(sh.red);
    __syncthreads();
    ++phase;
    return r;
  }

  // The canonical left fold of parts() (one float a tile, in rank 0's
  // stage): rank 0 folds and writes the sum to every rank.
  __device__ float fold() {
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();
    if (rank == 0 && threadIdx.x == 0) {
      const float acc = fold_run(stage, n_tiles, 1, nullptr);
      for (int k = 0; k < size; ++k) *cluster.map_shared_rank(&sh.zres, k) = acc;
    }
    cluster.sync();
    return sh.zres;
  }

  // Where this rank's sweep partials go: rank 0's stage (its own tiles and,
  // through distributed shared memory, those of the first round's ranks,
  // each tile at its place in the row), else the rank's own stage.
  __device__ float* sweep_target() const {
    return rank <= nseg ? stage0 + static_cast<size_t>(t0) * kCand : stage;
  }

  // The sweep's canonical left folds, after every rank has written its
  // partials (sweep_target) and before any rank reads the result: `rounds`
  // rounds, each a cluster barrier after which rank 0 (lane c < kCand of
  // warp 0, candidate c) folds the round's tiles in order: the first round
  // its own and the first nseg ranks' (every rank's at a served width), a
  // later round the next nseg ranks' (cluster_recv_segments), which copy
  // their stage into recv[] (float4s through distributed shared memory)
  // once rank 0 has folded the round before (another cluster barrier).
  // Returns candidate c's strictly-greater mass in lane c of rank 0's warp
  // 0, else 0. Every thread of every rank calls it.
  __device__ float sweep_fold() {
    cg::cluster_group cluster = cg::this_cluster();
    const int tid = threadIdx.x, seg = per * kCand;
    float acc = 0.f;
    for (int j = 0; j < rounds; ++j) {
      const int first = j == 0 ? 0 : (1 + j * nseg) * per;
      if (j > 0) {
        cluster.sync();                // rank 0 has folded round j - 1
        const int slot = rank - 1 - j * nseg;
        if (slot >= 0 && slot < nseg && n_own > 0) {
          float4* dst = reinterpret_cast<float4*>(
              recv0 + static_cast<size_t>(slot) * seg);
          const float4* src = reinterpret_cast<const float4*>(stage);
          for (int i = tid; i < n_own * kCand / 4; i += kThreads)
            dst[i] = src[i];
        }
      }
      cluster.sync();                  // round j's partials in rank 0
      if (rank == 0 && tid < kCand)
        acc = fold_run((j == 0 ? stage : recv) + tid,
                       max(0, min(n_tiles, (1 + (j + 1) * nseg) * per) - first),
                       kCand, nullptr, acc);
    }
    return acc;
  }

  // The k-th largest key of the row, 1 <= k <= vocab: four passes of 8-bit
  // digits from the top, each a 256-bin count of the keys that match the
  // digits found so far, summed over the cluster. Exact (integer counts).
  __device__ unsigned radix_kth(unsigned k) {
    cg::cluster_group cluster = cg::this_cluster();
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    unsigned prefix = 0u, want = k;
    for (int pass = 0; pass < 4; ++pass) {
      const int shift = 24 - 8 * pass;
      unsigned* h = sh.hist[pass & 1];
      for (int b = tid; b < kBins; b += kThreads) h[b] = 0u;
      __syncthreads();
      for (int it = tid; it < n_own * 32; it += kThreads) {
        const int lt = it >> 5, q = it & 31, base = (t0 + lt) * kTile + q;
        const uint4 kk = reinterpret_cast<const uint4*>(keys + lt * kStride)[q];
        const unsigned kv[4] = {kk.x, kk.y, kk.z, kk.w};
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          if (base + 32 * r < vocab && (((kv[r] ^ prefix) >> shift) >> 8) == 0u)
            atomicAdd(&h[(kv[r] >> shift) & (kBins - 1)], 1u);
        }
      }
      cluster.sync();
      for (int b = tid; b < kBins; b += kThreads) {
        unsigned s[kMaxCluster];
#pragma unroll
        for (int r = 0; r < kMaxCluster; ++r)
          s[r] = r < size ? *cluster.map_shared_rank(h + b, r) : 0u;
        unsigned tot = 0u;
#pragma unroll
        for (int r = 0; r < kMaxCluster; ++r) tot += s[r];
        sh.tot[b] = tot;
      }
      __syncthreads();
      if (warp == 0) {
        // lane l holds digits 8 l .. 8 l + 7; S = keys at digit >= 8 l
        unsigned c8[8], own = 0u;
#pragma unroll
        for (int b = 0; b < 8; ++b) {
          c8[b] = sh.tot[8 * lane + b];
          own += c8[b];
        }
        unsigned s_ge = own;
        for (int o = 1; o < 32; o <<= 1) {
          const unsigned up = __shfl_down_sync(0xffffffffu, s_ge, o);
          if (lane + o < 32) s_ge += up;
        }
        const unsigned hit = __ballot_sync(0xffffffffu, s_ge >= want);
        if (lane == 31 - __clz(hit)) {
          unsigned acc = s_ge - own;         // keys at digits above the lane's
          int d = 8 * lane;
          for (int b = 7; b >= 0; --b) {
            if (acc + c8[b] >= want) {
              d = 8 * lane + b;
              break;
            }
            acc += c8[b];
          }
          sh.radix[0] = prefix | (static_cast<unsigned>(d) << shift);
          sh.radix[1] = want - acc;
        }
      }
      __syncthreads();
      prefix = sh.radix[0];
      want = sh.radix[1];
      __syncthreads();
    }
    return prefix < kTopKey ? prefix : kTopKey;
  }

  // An estimate of the nucleus key (ref.estimate_key, bit for bit): the
  // smallest key whose strictly-greater mass stays under t, masses in fixed
  // point (u 2^32 rounded) summed as integers, exact in any order. Four
  // 8-bit passes from the top as in radix_kth: a 256-bin histogram
  // (shared-memory integer atomics) of the masses of the keys that match the
  // digits found so far, summed over the cluster, then the smallest digit
  // whose mass above is at most t 2^32 rounded.
  __device__ unsigned estimate_key(float t) {
    cg::cluster_group cluster = cg::this_cluster();
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const unsigned long long tt = __float2ull_rn(t * kFixedOne);
    unsigned prefix = 0u;
    unsigned long long above = 0ull;
    for (int pass = 0; pass < 4; ++pass) {
      const int shift = 24 - 8 * pass;
      unsigned* h = sh.mhist[pass & 1];        // hi halves, then lo halves
      for (int b = tid; b < 2 * kBins; b += kThreads) h[b] = 0u;
      __syncthreads();
      for (int it = tid; it < n_own * 32; it += kThreads) {
        const int lt = it >> 5, q = it & 31;
        const uint4 kk = reinterpret_cast<const uint4*>(keys + lt * kStride)[q];
        const float4 ww = reinterpret_cast<const float4*>(u + lt * kStride)[q];
        const unsigned kv[4] = {kk.x, kk.y, kk.z, kk.w};
        const float wv[4] = {ww.x, ww.y, ww.z, ww.w};
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          // floor(u 2^32) as two 16-bit halves, each summed in its own
          // 32-bit counter (no sum of a CTA's masses can carry out of it):
          // integer atomics on one address combine, float ones serialize
          const unsigned long long m = __float2ull_rn(wv[r] * kFixedOne);
          if (m != 0ull && (((kv[r] ^ prefix) >> shift) >> 8) == 0u) {
            const unsigned d = (kv[r] >> shift) & (kBins - 1);
            const unsigned hi = static_cast<unsigned>(m >> 16);
            const unsigned lo = static_cast<unsigned>(m & 0xFFFFull);
            if (hi != 0u) atomicAdd(&h[d], hi);
            if (lo != 0u) atomicAdd(&h[kBins + d], lo);
          }
        }
      }
      cluster.sync();
      for (int b = tid; b < kBins; b += kThreads) {
        unsigned hi[kMaxCluster], lo[kMaxCluster];
#pragma unroll
        for (int r = 0; r < kMaxCluster; ++r) {
          hi[r] = r < size ? *cluster.map_shared_rank(h + b, r) : 0u;
          lo[r] = r < size ? *cluster.map_shared_rank(h + kBins + b, r) : 0u;
        }
        unsigned long long sum = 0ull;
#pragma unroll
        for (int r = 0; r < kMaxCluster; ++r)
          sum += (static_cast<unsigned long long>(hi[r]) << 16) + lo[r];
        sh.mtot[b] = sum;
      }
      __syncthreads();
      if (warp == 0) {
        // lane l holds digits 8 l .. 8 l + 7; sg(d) = above + the mass of
        // the digits over d, decreasing in d; sg(255) = above <= tt
        unsigned long long m8[8], own = 0ull;
#pragma unroll
        for (int b = 0; b < 8; ++b) {
          m8[b] = sh.mtot[8 * lane + b];
          own += m8[b];
        }
        unsigned long long incl = own;         // mass of lanes >= this one
        for (int o = 1; o < 32; o <<= 1) {
          const unsigned long long x = __shfl_down_sync(0xffffffffu, incl, o);
          if (lane + o < 32) incl += x;
        }
        const unsigned long long next = __shfl_down_sync(0xffffffffu, incl, 1);
        unsigned long long sg = above + (lane == 31 ? 0ull : next);
        const unsigned hit = __ballot_sync(0xffffffffu, sg <= tt);
        if (lane == __ffs(hit) - 1) {          // the digit: 8 lane + b
          int b = 7;
          while (b > 0 && sg + m8[b] <= tt) sg += m8[b--];
          sh.radix[0] = prefix | (static_cast<unsigned>(8 * lane + b) << shift);
          sh.above = sg;
        }
      }
      __syncthreads();
      prefix = sh.radix[0];
      above = sh.above;
      __syncthreads();
    }
    return prefix < kTopKey ? prefix : kTopKey;
  }

  // A search step from the candidates sh.cand (ascending) and ok (bit c:
  // SG at candidate c is under the target), on [lo, hi]: the smallest ok
  // candidate, one past the largest that is not.
  __device__ void step(unsigned ok, unsigned& lo, unsigned& hi) const {
    if (ok != 0u) {                          // ok lanes: a suffix
      const int f = __ffs(ok) - 1;
      hi = min(hi, sh.cand[f]);
      if (f > 0) lo = max(lo, sh.cand[f - 1] + 1u);
    } else {
      lo = max(lo, sh.cand[kCand - 1] + 1u);
    }
  }

  // The smallest key K in [0, kTopKey] whose strictly-greater mass SG(K)
  // (canonical order over u, keys) stays under t (ref.nucleus_key_search,
  // step for step): estimate_key, then exact sweeps, each candidate's SG by
  // its own halving trees (lane c of each kCand lanes of a warp takes
  // candidate c, the warp kTilesAWarp tiles; sweep_target) and its own left
  // fold (lane c of rank 0's first warp, sweep_fold). The first sweep takes the estimate's key and
  // keys at 4^i from it (ref.first_candidates), each later one the first
  // key with mass left and keys spread over the rest (ref.retry_candidates).
  // A wrong estimate only costs sweeps: SG is monotone in K, so the search
  // ends on the mass bisection's result.
  __device__ unsigned nucleus(float t) {
    cg::cluster_group cluster = cg::this_cluster();
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const unsigned ke = estimate_key(t);
    if (tid < kCand) {
      const int i = tid < kCand / 2 ? kCand / 2 - 1 - tid : tid - kCand / 2;
      const unsigned off = 1u << (2 * i);
      sh.cand[tid] = tid < kCand / 2 ? (ke > off ? ke - off : 0u)
                     : (ke < kTopKey - (off - 1u) ? ke + (off - 1u) : kTopKey);
    }
    unsigned lo = 0u, hi = kTopKey;
    for (int sweep = 1;; ++sweep) {
      if (sweep == kMaxSweeps) __trap();
      __syncthreads();
      const int c = lane % kCand;
      const unsigned cv = sh.cand[c];
      float* part = sweep_target() + c;
      for (int pr = warp; kTilesAWarp * pr < n_own; pr += kWarps) {
        const int lt = kTilesAWarp * pr + lane / kCand;
        if (lt < n_own)
          part[lt * kCand] =
              cand_tile_sum(keys + lt * kStride, u + lt * kStride, cv);
      }
      const float sg = sweep_fold();
      if (rank == 0 && warp == 0) {
        const unsigned ok = __ballot_sync(0xffffffffu, lane < kCand && sg < t);
        unsigned nlo = lo, nhi = hi;
        step(ok, nlo, nhi);
        if (lane < size) {
          unsigned* d = cluster.map_shared_rank(sh.dec, lane);
          d[0] = nlo;
          d[1] = nhi;
        }
      }
      cluster.sync();
      lo = sh.dec[0];
      hi = sh.dec[1];
      if (lo >= hi) break;
      // the estimate missed: the threshold is a key with mass in [lo, hi],
      // most often the first, kappa (ref.retry_candidates)
      unsigned mn = 0xFFFFFFFFu;
      for_each([&](int, int p) {
        const unsigned k = keys[p];
        if (u[p] > 0.f && k >= lo && k <= hi) mn = min(mn, k);
      });
      const unsigned kappa = min(reduce(mn, MinOp()), hi);
      const unsigned lo2 = min(kappa + 1u, hi);
      if (tid < kCand)
        sh.cand[tid] =
            tid == 0 ? (kappa > 0u ? kappa - 1u : 0u)
            : tid == 1 ? kappa
            : lo2 + static_cast<unsigned>(
                  static_cast<unsigned long long>(hi - lo2) * (tid - 1) /
                  (kCand - 1));
    }
    return hi;
  }
};

// The top-k / nucleus top-p thresholds of a cluster row whose keys[] hold
// the row (ClusterRow::load): entries below *kth are dropped by top-k, then
// entries below *th by top-p (-inf when top_p >= 1). top_k <= 0 or >= vocab
// disables top-k: its k-th key is then the minimum key. Leaves keys[] as
// the keys of the top-k-masked row and, when top_p < 1, u[] as its masses.
__device__ void cluster_thresholds(ClusterRow& row, int top_k, float top_p,
                                   float* kth_out, float* th_out) {
  const int vocab = row.vocab;
  const int k = top_k <= 0 ? vocab : min(top_k, vocab);
  unsigned kkey;
  if (k >= vocab) {
    unsigned mn = 0xFFFFFFFFu;
    row.for_each([&](int, int p) { mn = min(mn, row.keys[p]); });
    kkey = min(row.reduce(mn, MinOp()), kTopKey);
  } else {
    kkey = row.radix_kth(static_cast<unsigned>(k));
  }
  const float kth = key_to_float(kkey);
  float mx = -INFINITY;
  row.for_each([&](int, int p) {
    const float v = key_to_float(row.keys[p]);
    const float lgk = v < kth ? -INFINITY : v;
    row.keys[p] = float_to_key(lgk);
    mx = fmaxf(mx, lgk);
  });
  float th = -INFINITY;
  if (top_p < 1.0f) {
    const float m = row.reduce(mx, MaxOp());   // syncs: keys[] are written
    const float safe_m = isfinite(m) ? m : 0.f;
    row.for_each([&](int, int p) {
      row.u[p] = expf(__fsub_rn(key_to_float(row.keys[p]), safe_m));
    });
    __syncthreads();
    const float z = tiled_sum(
        [&](int i) { return i < vocab ? row.u[row.pos(i)] : 0.f; }, row);
    const float t = fmaxf(__fmul_rn(top_p, z), kTFloor);
    th = key_to_float(row.nucleus(t));
  }
  __syncthreads();
  *kth_out = kth;
  *th_out = th;
}

// ---------------------------------------------------------------------------
// The draw.
//
// The uniform of stream position p of a request with seed s
// (ref.row_uniforms, bit for bit jax.random.uniform(fold_in(key(s), p))):
// threefry2x32 with 20 rounds, key (0, s) and counter (0, p) give the folded
// key; the folded key and counter (0, 0) give two words whose xor's top 23
// bits are the mantissa of a float in [1, 2); minus 1, clamped at 0.
__device__ __forceinline__ void threefry2x32(unsigned k0, unsigned k1,
                                             unsigned& x0, unsigned& x1) {
  const unsigned ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  constexpr int kRot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x0 += x1;
      x1 = __funnelshift_l(x1, x1, kRot[i % 2][j]) ^ x0;
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + static_cast<unsigned>(i + 1);
  }
}

__device__ __forceinline__ float row_uniform(unsigned seed,
                                             unsigned position) {
  unsigned k0 = 0u, k1 = position;
  threefry2x32(0u, seed, k0, k1);
  unsigned b0 = 0u, b1 = 0u;
  threefry2x32(k0, k1, b0, b1);
  const unsigned bits = ((b0 ^ b1) >> 9) | 0x3F800000u;
  return fmaxf(__fsub_rn(__uint_as_float(bits), 1.f), 0.f);
}

// The low 32 bits of positions[row]: int32 or int64 (pos64) values, as
// ref.row_uniforms masks them.
__device__ __forceinline__ unsigned position_word(const void* positions,
                                                  int pos64, int row) {
  if (pos64) {
    const long long* p = static_cast<const long long*>(positions);
    return static_cast<unsigned>(p[row]);
  }
  return static_cast<unsigned>(static_cast<const int*>(positions)[row]);
}

// The left fold ((0 + p[0]) + p[1]) + ... of n terms, before[i] the fold of
// the terms before i: fold_run's order and bits, with p and before 16-byte
// aligned, read and written a float4 at a time and kPrefixAhead float4s
// loaded ahead, so the chain of adds (the fold's only cost) never waits on a
// load.
__device__ __forceinline__ float fold_prefix(const float* p, int n,
                                             float* before) {
  const float4* p4 = reinterpret_cast<const float4*>(p);
  float4* b4 = reinterpret_cast<float4*>(before);
  const int nq = n / 4, full = nq - nq % kPrefixAhead;
  float acc = 0.f;
  float4 cur[kPrefixAhead], nxt[kPrefixAhead];
  if (full > 0) {
#pragma unroll
    for (int j = 0; j < kPrefixAhead; ++j) nxt[j] = p4[j];
  }
  for (int q = 0; q < full; q += kPrefixAhead) {
#pragma unroll
    for (int j = 0; j < kPrefixAhead; ++j) cur[j] = nxt[j];
    if (q + kPrefixAhead < full) {
#pragma unroll
      for (int j = 0; j < kPrefixAhead; ++j) nxt[j] = p4[q + kPrefixAhead + j];
    }
#pragma unroll
    for (int j = 0; j < kPrefixAhead; ++j) {
      float4 b;
      b.x = acc;
      acc = __fadd_rn(acc, cur[j].x);
      b.y = acc;
      acc = __fadd_rn(acc, cur[j].y);
      b.z = acc;
      acc = __fadd_rn(acc, cur[j].z);
      b.w = acc;
      acc = __fadd_rn(acc, cur[j].w);
      b4[q + j] = b;
    }
  }
  for (int i = 4 * full; i < n; ++i) {
    before[i] = acc;
    acc = __fadd_rn(acc, p[i]);
  }
  return acc;
}

// The draw reads a cluster row's own elements four at a time: x4(lt, q)
// -> float4 holds the row at elements (t0 + lt) kTile + q + 32 r, r = 0..3,
// word q of own tile lt's float4s (any value past vocab). A lane's float4
// read is one 16-byte word, so a warp reading a tile meets no bank
// conflict.

// The max of the calling thread's share of the row's own elements (the
// draw's local_max where no load has taken it).
template <class X4>
__device__ float own_max(X4 x4, const ClusterRow& row) {
  float mx = -INFINITY;
  for (int it = threadIdx.x; it < row.n_own * 32; it += kThreads) {
    const int lt = it >> 5, q = it & 31;
    const int base = (row.t0 + lt) * kTile + q;
    const float4 v = x4(lt, q);
    const float vv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int r = 0; r < 4; ++r)
      if (base + 32 * r < row.vocab) mx = fmaxf(mx, vv[r]);
  }
  return mx;
}

// Inverse-CDF draw of a cluster row (ref.draw_tokens, bit for bit): the
// first index whose prefix mass exceeds r Z, r = row_uniform(seed,
// position) and Z the canonical row mass of exp(x - max); 0 when none does.
// local_max: the max of the calling thread's share of the CTA's own
// elements (together the CTA's threads cover them all). The result is rank
// 0's; overwrites u[]. Every remote access of shared memory precedes the
// last cluster barrier, so a CTA may leave once it returns.
//
// 1. The row max: a barrier in the CTA, each CTA's max in its dmax, a
//    cluster barrier (which also makes sure that every CTA of the cluster
//    has started before any remote access), and every warp reads the
//    ranks' words.
// 2. Warp a tile: the tile's masses into u[] and its halving tree into rank
//    0's stage.
// 3. After a cluster barrier, three things at once: thread 0 of rank 0
//    folds the partials in tile order (fold_prefix: before[t] and Z, which
//    it writes to every rank); warps 1-30 of every rank turn u[] into the
//    in-tile prefix sums c_j = ((u_0 + u_1) + ...) + u_j of its tiles, a
//    thread a tile, kScanAhead words loaded before their adds; warp 31
//    computes r. Only the fold is a long chain.
// 4. After a second barrier, warp a tile again: lane l tests elements l +
//    32 k (one float4 of c), before[t] + c_j > r Z, before[t] read from rank
//    0 for kSearchAhead tiles at once; a warp's tiles in increasing order,
//    so its first hit is its least.
// 5. The least hit: into the CTA's dlocal (shared atomics), a barrier, then
//    into rank 0's dmin (one atomic through distributed shared memory), a
//    cluster barrier.
template <class X4>
__device__ int draw_index(X4 x4, ClusterRow& row, float local_max,
                          unsigned seed, unsigned position) {
  cg::cluster_group cluster = cg::this_cluster();
  const int vocab = row.vocab, tid = threadIdx.x, lane = tid & 31;
  const int warp = tid >> 5;
  ClusterShared& sh = row.sh;
  float v = local_max;
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  if (lane == 0) row.sc.fred[warp] = v;
  if (tid == 0) sh.dmin = 0xFFFFFFFFu;
  if (tid == 32) sh.dlocal = 0xFFFFFFFFu;
  __syncthreads();
  if (warp == 0) {
    v = row.sc.fred[lane];                   // kWarps == 32
    for (int o = 16; o > 0; o >>= 1)
      v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
    if (lane == 0) sh.dmax = v;
  }
  cluster.sync();
  v = *cluster.map_shared_rank(&sh.dmax, lane < row.size ? lane : 0);
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  const float safe_m = isfinite(v) ? v : 0.f;

  for (int lt = warp; lt < row.n_own; lt += kWarps) {
    const int base = (row.t0 + lt) * kTile + lane;
    const float4 xv = x4(lt, lane);
    const float xs[4] = {xv.x, xv.y, xv.z, xv.w};
    float w[4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
      w[r] = base + 32 * r < vocab ? expf(__fsub_rn(xs[r], safe_m)) : 0.f;
    reinterpret_cast<float4*>(row.u + lt * kStride)[lane] =
        make_float4(w[0], w[1], w[2], w[3]);
    // w = 128: lanes l and l + 32 of x[:64] + x[64:]; w = 64: their sum
    float z = __fadd_rn(__fadd_rn(w[0], w[2]), __fadd_rn(w[1], w[3]));
    for (int o = 16; o > 0; o >>= 1)          // w = 32 ... 2
      z = __fadd_rn(z, __shfl_down_sync(0xffffffffu, z, o));
    if (lane == 0) row.stage0[row.t0 + lt] = z;
  }
  cluster.sync();

  if (row.rank == 0 && tid == 0) {
    const float z = fold_prefix(row.stage, row.n_tiles, row.before);
    for (int k = 0; k < row.size; ++k)
      *cluster.map_shared_rank(&sh.zres, k) = z;
  } else if (tid == kThreads - 32) {
    sh.uni = row_uniform(seed, position);
  } else if (tid >= 32 && tid < kThreads - 32) {
    for (int lt = tid - 32; lt < row.n_own; lt += kThreads - 64) {
      float* ut = row.u + lt * kStride;
      float c = 0.f;
      // element j = 32 r + q sits at word 4 q + r (tile_pos)
      for (int r = 0; r < 4; ++r) {
#pragma unroll
        for (int h = 0; h < 32; h += kScanAhead) {
          float a[kScanAhead];
#pragma unroll
          for (int q = 0; q < kScanAhead; ++q) a[q] = ut[4 * (h + q) + r];
#pragma unroll
          for (int q = 0; q < kScanAhead; ++q) {
            c = __fadd_rn(c, a[q]);
            ut[4 * (h + q) + r] = c;
          }
        }
      }
    }
  }
  cluster.sync();

  const float target = __fmul_rn(sh.uni, sh.zres);
  const float* before0 = cluster.map_shared_rank(row.before, 0);
  for (int lt0 = warp; lt0 < row.n_own; lt0 += kSearchAhead * kWarps) {
    float bt[kSearchAhead];
    float4 cv[kSearchAhead];
#pragma unroll
    for (int k = 0; k < kSearchAhead; ++k) {
      const int lt = lt0 + k * kWarps;
      if (lt < row.n_own) {
        bt[k] = before0[row.t0 + lt];
        cv[k] = reinterpret_cast<const float4*>(row.u + lt * kStride)[lane];
      }
    }
    unsigned hit = 0xFFFFFFFFu;
#pragma unroll
    for (int k = kSearchAhead - 1; k >= 0; --k) {
      const int t = row.t0 + lt0 + k * kWarps;
      const float cs[4] = {cv[k].x, cv[k].y, cv[k].z, cv[k].w};
#pragma unroll
      for (int r = 3; r >= 0; --r) {
        const int i = t * kTile + lane + 32 * r;
        if (lt0 + k * kWarps < row.n_own && i < vocab &&
            __fadd_rn(bt[k], cs[r]) > target)
          hit = i;
      }
    }
    hit = __reduce_min_sync(0xffffffffu, hit);
    if (hit != 0xFFFFFFFFu) {
      if (lane == 0) atomicMin(&sh.dlocal, hit);
      break;
    }
  }
  __syncthreads();
  if (tid == 0 && sh.dlocal != 0xFFFFFFFFu)
    atomicMin(cluster.map_shared_rank(&sh.dmin, 0), sh.dlocal);
  cluster.sync();
  return sh.dmin == 0xFFFFFFFFu ? 0 : static_cast<int>(sh.dmin);
}

}  // namespace sampling
