// Paged GQA attention for Hopper (sm_90a): single-query decode and one
// chunk of chunked prefill, both reading K/V through a page table.
//
// Replaces the TPU kernels of src/repro/kernels/decode_attention/kernel.py:
//   paged_decode_attention_fwd  (kernel.py:164, pallas_call at :181)
//   paged_prefill_attention_fwd (kernel.py:113, pallas_call at :138)
// The plain versions are repro_torch/kernels/decode_attention/ref.py.
//
// What bounds it on this card: bytes. Each (sequence, KV head) reads its K
// and V rows once and does 4 G flop per element read (G = Hq / Hkv query
// heads, 3 for llama3.2-3b), far below the ~295 flop/byte at which an H100
// stops being memory-bound. Decode at 8 slots x 128-576 tokens moves 7.9
// MB per layer: 2.4 us at 3.35 TB/s. The previous kernel (one CTA of 8
// warps per (row, KV head), fp32 dot products reduced by shuffles) ran it
// as a chain of blocking loads: 64 CTAs on 132 SMs, the longest row's CTA
// nine round trips to memory in series, and the prefill re-read its chunk's
// K/V once per query row.
//
// Design. One launch a call; the CTAs of one (slot, KV head) in decode, or
// of one (KV head, tile of 64 query rows) in prefill, form a thread block
// cluster of S CTAs (S <= 8, chosen on the host from shapes and host
// integers only: ops.decode_plan / ops.prefill_plan; the lengths stay on the
// card). Keys are cut into tiles of 16; tile t goes to rank t mod S, so
// every rank gets the same share whatever the length.
// - Rows. Prefill flattens the chunk's (token, query head) pairs of a KV
//   head into rows, 64 a CTA, so one K/V tile serves every query head and
//   every token of the tile (the Pallas kernel's [C*G, D] accumulator):
//   each K/V tile is read once per row tile, not once per query row. Decode
//   pads the G query heads of a KV head to 16 rows (G <= 16).
// - Loads. A producer warp (one thread issues; its 32 lanes first fetch
//   the page ids of 32 tiles at once) puts each tile's K and V into a
//   shared-memory ring by TMA: the pool viewed as [P * page, Hkv, D] is a
//   3-D tensor map, a box 64 columns x 16 key rows of one KV head in the
//   128-byte swizzle (8 rows where a page holds 8k keys, 8 | page), two
//   boxes a tile for K and two for V, at row page_id * page + offset. Full
//   barriers count the bytes, empty barriers the readers. Decode rings 8
//   stages (64 KB in flight a CTA), prefill 4.
// - Products. Four consumer warps: in decode each takes every fourth tile
//   of its rank with its own online-softmax state, in prefill each owns 16
//   of the 64 rows and walks every tile of its rank. S = Q K^T and o += p V
//   are mma.sync m16n8k16 (bf16 in, fp32 accumulate), K by ldmatrix and V
//   by ldmatrix.trans from the swizzled tile, Q's fragments in registers
//   for the whole call. p is split into bf16 hi + lo (p - hi rounded
//   again), two products into the same fp32 accumulator, as in the flash
//   kernel: p keeps 16 significant bits, and the kernel holds its fp32
//   plain version within a fraction of a bf16 ulp. The softmax runs in base
//   2 (scale and log2(e) in one multiply, ex2.approx); masked scores are
//   -1e30, as in the Pallas kernel.
// - Merge. Decode folds its four warps' (m, l, o), staged in the ring, into
//   one state a CTA; prefill's warps write theirs. After a cluster barrier
//   every rank reads the S ranks' states through distributed shared memory
//   (map_shared_rank, all S loads issued together), each rank finishing a
//   slice of the output rows' columns: o / max(l, 1e-30), rounded to bf16
//   once. A second cluster barrier keeps every CTA alive until the others
//   have read it. No workspace, no atomics, no second kernel. A state with
//   no valid key (m = -1e30) drops out with weight 0 wherever the row has
//   one; a decode row with seq_len 0 has no tile on any rank and returns
//   exact zeros. Barrier waits trap after 2^28 polls, so a phase error
//   fails the launch instead of hanging the card.
// Two choices against Hopper's usual parts, and why: mma.sync, not wgmma
// (the prefill's 16-key x 64-row tiles take under a microsecond of tensor
// work a call; wgmma's warpgroup tiles would add synchronisation without
// moving the kernel); TMA boxes of 16 or 8 rows (the 128-byte swizzle
// needs a 1024-byte aligned destination, so a box is 8 rows at least; the
// wrapper refuses a page size that is not a multiple of 8, as the Pallas
// kernel's (page, D) block needs the TPU's 8-row tiling).
//
// Measured by paged_ablations.py (device time from torch.profiler) on an
// NVIDIA H100 80GB HBM3 at 700.00 W, llama3.2-3b heads, page 16. ptxas:
// 166 registers (decode) and 165 (prefill), no spills; dynamic shared
// memory 75,520 bytes (decode) and 67,648 (prefill).
// - Decode over 8 slots of 128-576 tokens, 0.01040 ms at the plan's S 3
//   (S 1 0.02020, 2 0.01259, 4 0.01149, 8 0.01710: past 3, the CTAs of
//   short rows cost more than they share); ring 4 0.01033, 16 0.01409 (one
//   CTA an SM); 8 warps 0.01545; boxes of 8 rows 0.01251. Loads alone
//   0.00886, products alone 0.00743; 8 slots of 16 tokens (one tile a row)
//   0.0059: most of a call is fixed cost.
// - Decode over [4096, 1500], 0.01909 ms at S 8 (S 6 0.02359, 7 0.02147):
//   the 4096-token row's 64 CTAs set the time (loads alone 0.01574).
// - Prefill of 64 rows at 448 of 498, S 8 0.01120 and S 4 0.01133 against
//   S 5 0.01297 and S 6 0.01238 (clusters of 5 or 6 pack the GPCs
//   unevenly); 8 warps, two a row group, 0.02088 (one CTA an SM at 288
//   threads). Products alone 0.01261, loads alone 0.00965: it is bound by
//   its products.
// - p V without the lo product saves 1-5% at 0.70-0.89 row ulps (against
//   0.50): not taken (a precision change).

#include <cooperative_groups.h>
#include <cuda.h>              // CUtensorMap and its enums (no -lcuda)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

using bf16 = __nv_bfloat16;

constexpr int D = 128;                 // head dim, the only one built
constexpr int kAtom = 64;              // bf16 columns of a 128-byte swizzle row
constexpr int KT = 16;                 // keys a tile (ops.KEY_TILE)
constexpr int kMinBox = 8;             // key rows a TMA box, at least
constexpr int kMaxG = 16;              // query heads a KV head, at most
constexpr int kMaxSplit = 8;           // CTAs a cluster (ops.MAX_SPLIT)
constexpr int kHalfBytes = KT * kAtom * 2;     // 16 keys x 64 columns
constexpr int kTileBytes = KT * D * 2;         // one K or V tile
constexpr int kStageBytes = 2 * kTileBytes;    // K then V
constexpr float kNegInf = -1e30f;      // masked score, as the Pallas kernel
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kMaxDevices = 16;

// The CTA: kWarps consumer warps in kGroups groups of 16 rows (decode: the
// G query heads, one group; prefill: 64 (token, query head) rows, four),
// the kSplitK warps of a group taking alternate tiles of the rank, and one
// producer warp. Shared memory, from a 1024-byte aligned base (the
// swizzle's period): the ring of kStages stages (K tile, V tile: [2
// halves][16 keys][128 bytes]), the rank's state (o [kRows][D], m [kRows],
// l [kRows] fp32), the warps' m and l, then the full and empty barriers.
// Where a group has more than one warp, the warps' o are staged in the
// ring once every tile is consumed and folded into the rank's state.
template <bool kDecode>
struct Layout {
  static constexpr int kWarps = 4;
  static constexpr int kGroups = kDecode ? 1 : 4;
  static constexpr int kSplitK = kWarps / kGroups;
  static constexpr int kThreads = 32 * (kWarps + 1);
  static constexpr int kStages = kDecode ? 8 : 4;
  static constexpr int kRows = 16 * kGroups;
  static constexpr int kO = kStages * kStageBytes;
  static constexpr int kM = kO + kRows * D * 4;
  static constexpr int kL = kM + kRows * 4;
  static constexpr int kWm = kL + kRows * 4;
  static constexpr int kWl = kWm + kWarps * 16 * 4;
  static constexpr int kBar = kWl + kWarps * 16 * 4;
  static constexpr int kBytes = kBar + 16 * kStages + 1024;  // + alignment
  static_assert(kSplitK == 1 || kWarps * 16 * D * 4 <= kO,
                "the warps' o are staged in the ring");
};

struct Params {
  const bf16* q;
  bf16* out;
  const int* table;        // decode: page_table [B, max_pages]; prefill:
                           // page_row [max_pages]
  const int* seq_lens;     // decode: [B]
  int hq, hkv, g, page, max_pages, chunk, start, total;
  int box;                 // key rows a TMA box: 16, or 8 for pages of 8k
  float scale_log2;        // D^-0.5 * log2(e)
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar), "r"(bytes) : "memory");
}
// until the phase of parity ``parity`` has completed; a wait that outlasts
// 2^28 polls (seconds) traps, so a phase error fails the launch instead of
// hanging the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done = 0;
  for (uint32_t polls = 0;; ++polls) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if (polls == (1u << 28)) __trap();
  }
}

// one box of a 3-D tensor map into shared memory, completing on ``bar``
__device__ __forceinline__ void tma_load_3d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2) : "memory");
}

// four 8x8 bf16 matrices; lane l gives the address of row l % 8 of matrix
// l / 8 and receives, of each, row l / 4, columns 2 (l % 4) and + 1
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}
// the same, transposed: rows 2 (l % 4) and + 1, column l / 4
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

// d += a (16 x 16, row-major) * b (16 x 8, column-major): bf16 in, fp32 d
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x on the special-function unit, subnormal results flushed to 0
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// the bf16 hi part of (x, y) and the bf16 rounding of what it leaves
__device__ __forceinline__ void split_bf16(float x, float y, uint32_t& hi,
                                           uint32_t& lo) {
  __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<uint32_t*>(&h);
  lo = pack_bf16(x - hf.x, y - hf.y);
}

// byte offset of (key, column d) in a K or V tile as TMA's 128-byte swizzle
// lays it out (d a multiple of 8): 16-byte chunk c of row r sits at chunk
// c ^ (r % 8)
__device__ __forceinline__ uint32_t swz(int key, int d) {
  return (d / kAtom) * kHalfBytes + key * 128 +
         ((((d % kAtom) >> 3) ^ (key & 7)) << 4);
}

__device__ __forceinline__ uint32_t load_pair(const bf16* row, int col) {
  return row == nullptr ? 0u
                        : *reinterpret_cast<const uint32_t*>(row + col);
}

template <bool kDecode>
__device__ __forceinline__ void paged_body(const CUtensorMap& tk,
                                           const CUtensorMap& tv,
                                           const Params& p) {
  using L = Layout<kDecode>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* gbase = smem_raw + (base - raw);
  float* so = reinterpret_cast<float*>(gbase + L::kO);
  float* sm = reinterpret_cast<float*>(gbase + L::kM);
  float* sl = reinterpret_cast<float*>(gbase + L::kL);
  const uint32_t full = base + L::kBar, empty = full + 8 * L::kStages;
  cg::cluster_group cluster = cg::this_cluster();
  // the grid's x is one cluster: x = the rank, gridDim.x = the split
  const int rank = blockIdx.x, split = gridDim.x;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = p.g, cap = p.max_pages * p.page;

  // the rows of this CTA, their KV head, and the keys its last row sees
  int h, bq = 0, row0 = 0, n_rows, n_max;
  const int* table;
  if constexpr (kDecode) {
    bq = blockIdx.z;
    h = blockIdx.y;
    table = p.table + static_cast<size_t>(bq) * p.max_pages;
    n_rows = g;
    n_max = min(max(p.seq_lens[bq], 0), cap);
  } else {
    h = blockIdx.z;
    row0 = blockIdx.y * L::kRows;
    table = p.table;
    n_rows = min(L::kRows, p.chunk * g - row0);
    const int last = (row0 + n_rows - 1) / g;     // its token
    n_max = min(min(p.start + last + 1, p.total), cap);
  }
  const int n_tiles = (n_max + KT - 1) / KT;
  // this rank's tiles t = rank + i * split, i < n_local
  const int n_local = rank < n_tiles ? (n_tiles - 1 - rank) / split + 1 : 0;

  if (tid == 0) {
    for (int s = 0; s < L::kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, L::kGroups);       // a tile's readers
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int gq = lane >> 2, t4 = lane & 3;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f}, o[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
    o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;

  if (warp == L::kWarps) {
    // ---- producer: the lanes fetch 32 tiles' page ids, lane 0 loads ----
    // The first 32 are fetched up to the page capacity, before the length
    // is known, so that no load waits on another; ids past the length are
    // never used (a box past it reads the null page 0).
    const int cap_tiles = (cap + KT - 1) / KT;
    const int fetch = rank < cap_tiles ? (cap_tiles - 1 - rank) / split + 1
                                       : 0;
    const int boxes = KT / p.box;
    int pid[KT / kMinBox];
    auto fetch_ids = [&](int i0) {
      const int i = i0 + lane;
#pragma unroll
      for (int j = 0; j < KT / kMinBox; ++j) {
        const int c = (rank + i * split) * KT + j * p.box;
        pid[j] = i < fetch && j < boxes && c < cap ? table[c / p.page] : 0;
      }
    };
    fetch_ids(0);
    if (lane == 0) {                   // the tensor maps, ahead of the loads
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(
          reinterpret_cast<uint64_t>(&tk)) : "memory");
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(
          reinterpret_cast<uint64_t>(&tv)) : "memory");
    }
    for (int i0 = 0; i0 < n_local; i0 += 32) {
      if (i0 > 0) fetch_ids(i0);
      const int cnt = min(32, n_local - i0);
      for (int k = 0; k < cnt; ++k) {
        int id[KT / kMinBox];
#pragma unroll
        for (int j = 0; j < KT / kMinBox; ++j)
          id[j] = __shfl_sync(0xffffffffu, pid[j], k);
        if (lane == 0) {
          const int ii = i0 + k, s = ii % L::kStages;
          const int c0 = (rank + ii * split) * KT;
          const uint32_t kd = base + s * kStageBytes, vd = kd + kTileBytes;
          mbar_wait(empty + 8 * s, ((ii / L::kStages) & 1) ^ 1);
          mbar_expect_tx(full + 8 * s, kStageBytes);
#pragma unroll
          for (int j = 0; j < KT / kMinBox; ++j) {
            if (j >= boxes) break;
            const int c = c0 + j * p.box;
            const int row = (c < n_max ? id[j] : 0) * p.page + c % p.page;
            const uint32_t off = j * p.box * 128;
#pragma unroll
            for (int hf = 0; hf < 2; ++hf) {
              tma_load_3d(kd + off + hf * kHalfBytes, &tk, full + 8 * s,
                          hf * kAtom, h, row);
              tma_load_3d(vd + off + hf * kHalfBytes, &tv, full + 8 * s,
                          hf * kAtom, h, row);
            }
          }
        }
        __syncwarp();
      }
    }
  } else {
    // ---- consumers: rows gq and gq + 8 of the warp's group of 16 ----
    const int grp = warp % L::kGroups, first = warp / L::kGroups;
    const bf16* qrow[2];
    int ntok[2];
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      if constexpr (kDecode) {
        const int r = gq + 8 * hr;
        qrow[hr] = r < g ? p.q + (static_cast<size_t>(bq) * p.hq + h * g + r) *
                                     D
                         : nullptr;
        ntok[hr] = n_max;
      } else {
        const int r = row0 + 16 * grp + gq + 8 * hr, tok = r / g;
        qrow[hr] = tok < p.chunk ? p.q + (static_cast<size_t>(tok) * p.hq +
                                          h * g + r % g) * D
                                 : nullptr;
        // causal from the row's position, clipped at the valid length
        ntok[hr] = min(min(p.start + tok + 1, p.total), cap);
      }
    }
    uint32_t qa[D / 16][4];
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      qa[kk][0] = load_pair(qrow[0], kk * 16 + 2 * t4);
      qa[kk][1] = load_pair(qrow[1], kk * 16 + 2 * t4);
      qa[kk][2] = load_pair(qrow[0], kk * 16 + 8 + 2 * t4);
      qa[kk][3] = load_pair(qrow[1], kk * 16 + 8 + 2 * t4);
    }
    const int mat = lane >> 3;
    // ldmatrix rows: K as (key block, column half), V as (key half, block)
    const int k_key = (mat >> 1) * 8 + (lane & 7), k_col = (mat & 1) * 8;
    const int v_key = (mat & 1) * 8 + (lane & 7), v_col = (mat >> 1) * 8;
    const float sl2 = p.scale_log2;
    for (int i = first; i < n_local; i += L::kSplitK) {
      const int s = i % L::kStages;
      const int c0 = (rank + i * split) * KT;
      const uint32_t kt = base + s * kStageBytes, vt = kt + kTileBytes;
      mbar_wait(full + 8 * s, (i / L::kStages) & 1);

      float sc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t kb[4];
        ldsm_x4(kb, kt + swz(k_key, kk * 16 + k_col));
        mma(sc[0], qa[kk], kb[0], kb[1]);
        mma(sc[1], qa[kk], kb[2], kb[3]);
      }
      // mask, then the online softmax in base 2; a row's 16 columns live
      // in the 4 lanes of one quad
      float alpha[2];
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        float mx = kNegInf;
#pragma unroll
        for (int nb = 0; nb < 2; ++nb)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            float& x = sc[nb][2 * hr + j];
            x = c0 + nb * 8 + 2 * t4 + j < ntok[hr] ? __fmul_rn(x, sl2)
                                                    : kNegInf;
            mx = fmaxf(mx, x);
          }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[hr], mx);
        alpha[hr] = exp2_ftz(m[hr] - m_new);
        float sum = 0.f;
#pragma unroll
        for (int nb = 0; nb < 2; ++nb)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            float& x = sc[nb][2 * hr + j];
            x = exp2_ftz(__fsub_rn(x, m_new));
            sum += x;
          }
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        l[hr] = l[hr] * alpha[hr] + sum;
        m[hr] = m_new;
      }
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        o[n][0] *= alpha[0];
        o[n][1] *= alpha[0];
        o[n][2] *= alpha[1];
        o[n][3] *= alpha[1];
      }
      // p's A fragment (16 rows x the tile's 16 keys) as bf16 hi and lo
      uint32_t ph[4], pl[4];
      split_bf16(sc[0][0], sc[0][1], ph[0], pl[0]);
      split_bf16(sc[0][2], sc[0][3], ph[1], pl[1]);
      split_bf16(sc[1][0], sc[1][1], ph[2], pl[2]);
      split_bf16(sc[1][2], sc[1][3], ph[3], pl[3]);
#pragma unroll
      for (int n2 = 0; n2 < D / 16; ++n2) {
        uint32_t vb[4];
        ldsm_x4_t(vb, vt + swz(v_key, n2 * 16 + v_col));
        mma(o[2 * n2], ph, vb[0], vb[1]);
        mma(o[2 * n2], pl, vb[0], vb[1]);
        mma(o[2 * n2 + 1], ph, vb[2], vb[3]);
        mma(o[2 * n2 + 1], pl, vb[2], vb[3]);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * s);
    }
  }

  // ---- the rank's state: each group's warps folded ----
  __syncthreads();                      // every tile consumed: the ring is free
  constexpr bool kFold = L::kSplitK > 1;
  // a warp's own state: staged (kFold) or straight into the rank's
  float* wo = kFold ? reinterpret_cast<float*>(gbase) : so;  // [kWarps][16][D]
  float* wm = kFold ? reinterpret_cast<float*>(gbase + L::kWm) : sm;
  float* wl = kFold ? reinterpret_cast<float*>(gbase + L::kWl) : sl;
  if (warp < L::kWarps) {
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int r = warp * 16 + gq + 8 * hr;
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
        *reinterpret_cast<float2*>(wo + r * D + n * 8 + 2 * t4) =
            make_float2(o[n][2 * hr], o[n][2 * hr + 1]);
      if (t4 == 0) {
        wm[r] = m[hr];
        wl[r] = l[hr];
      }
    }
  }
  if constexpr (kFold) {
    __syncthreads();
    for (int e = tid; e < n_rows * (D / 4); e += L::kThreads) {
      const int r = e / (D / 4), c = e % (D / 4) * 4;
      // row r of the group r / 16 sits at staged row r + 16 kGroups k in
      // its warps r / 16 + kGroups k
      float mm = kNegInf;
#pragma unroll
      for (int k = 0; k < L::kSplitK; ++k)
        mm = fmaxf(mm, wm[r + k * L::kGroups * 16]);
      float ll = 0.f;
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int k = 0; k < L::kSplitK; ++k) {
        const int wr = r + k * L::kGroups * 16;
        const float wt = exp2_ftz(wm[wr] - mm);
        const float4 v = *reinterpret_cast<const float4*>(wo + wr * D + c);
        ll += wl[wr] * wt;
        acc.x += v.x * wt;
        acc.y += v.y * wt;
        acc.z += v.z * wt;
        acc.w += v.w * wt;
      }
      *reinterpret_cast<float4*>(so + r * D + c) = acc;
      if (c == 0) {
        sm[r] = mm;
        sl[r] = ll;
      }
    }
  }

  // ---- the cluster's merge through distributed shared memory ----
  cluster.sync();
  for (int e = rank * L::kThreads + tid; e < n_rows * (D / 4);
       e += split * L::kThreads) {
    const int r = e / (D / 4), c = e % (D / 4) * 4;
    // every rank's state at once (the loads are issued together)
    float mk[kMaxSplit], lk[kMaxSplit];
    float4 ok[kMaxSplit];
#pragma unroll
    for (int k = 0; k < kMaxSplit; ++k) {
      if (k < split) {
        mk[k] = *cluster.map_shared_rank(sm + r, k);
        lk[k] = *cluster.map_shared_rank(sl + r, k);
        ok[k] = *cluster.map_shared_rank(
            reinterpret_cast<float4*>(so + r * D + c), k);
      } else {
        mk[k] = kNegInf;
        lk[k] = 0.f;
        ok[k] = make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
    float mm = kNegInf;
#pragma unroll
    for (int k = 0; k < kMaxSplit; ++k) mm = fmaxf(mm, mk[k]);
    float ll = 0.f;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int k = 0; k < kMaxSplit; ++k) {
      const float wt = exp2_ftz(mk[k] - mm);
      ll += lk[k] * wt;
      acc.x += ok[k].x * wt;
      acc.y += ok[k].y * wt;
      acc.z += ok[k].z * wt;
      acc.w += ok[k].w * wt;
    }
    const float inv = 1.f / fmaxf(ll, 1e-30f);
    size_t orow;
    if constexpr (kDecode) {
      orow = static_cast<size_t>(bq) * p.hq + h * g + r;
    } else {
      const int rr = row0 + r;
      orow = static_cast<size_t>(rr / g) * p.hq + h * g + rr % g;
    }
    uint2 packed;
    packed.x = pack_bf16(acc.x * inv, acc.y * inv);
    packed.y = pack_bf16(acc.z * inv, acc.w * inv);
    *reinterpret_cast<uint2*>(p.out + orow * D + c) = packed;
  }
  cluster.sync();           // no CTA leaves while another may read its state
}

__global__ void __launch_bounds__(Layout<true>::kThreads)
decode_kernel(const __grid_constant__ CUtensorMap tk,
              const __grid_constant__ CUtensorMap tv, const Params p) {
  paged_body<true>(tk, tv, p);
}

__global__ void __launch_bounds__(Layout<false>::kThreads)
prefill_kernel(const __grid_constant__ CUtensorMap tk,
               const __grid_constant__ CUtensorMap tv, const Params p) {
  paged_body<false>(tk, tv, p);
}

// cuTensorMapEncodeTiled from the driver through the runtime, so that
// nothing links libcuda
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr,
                                cudaEnableDefault, &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// a pool [P, page, Hkv, D] bf16 seen as [P * page, Hkv, D], read in boxes of
// 64 columns x ``box`` key rows of one KV head, 128-byte swizzled
int encode(CUtensorMap* map, const void* pool, int hkv, long long rows,
           int box) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(hkv),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(D) * 2,
                                 static_cast<cuuint64_t>(hkv) * D * 2};
  const cuuint32_t dims_box[3] = {kAtom, 1, static_cast<cuuint32_t>(box)};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                        const_cast<void*>(pool), dims, strides, dims_box,
                        unit,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : 10000 + static_cast<int>(r);
}

template <bool kDecode>
int launch(const void* kp, const void* vp, int num_pages, const Params& p,
           dim3 grid, int split, void* stream) {
  using L = Layout<kDecode>;
  static bool ready[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  auto* kernel = kDecode ? decode_kernel : prefill_kernel;
  if (!ready[dev]) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               L::kBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    ready[dev] = true;
  }
  CUtensorMap tk, tv;
  const long long rows = static_cast<long long>(num_pages) * p.page;
  int e = encode(&tk, kp, p.hkv, rows, p.box);
  if (e == 0) e = encode(&tv, vp, p.hkv, rows, p.box);
  if (e != 0) return e;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(L::kThreads, 1, 1);
  cfg.dynamicSmemBytes = L::kBytes;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, tk, tv, p);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

bool valid(int hq, int hkv, int d, int page_size, int max_pages, int split) {
  return d == D && hkv > 0 && hq % hkv == 0 && hq / hkv <= kMaxG &&
         page_size > 0 && page_size % kMinBox == 0 && max_pages >= 0 &&
         split >= 1 && split <= kMaxSplit;
}

float scale_log2() {
  return static_cast<float>(1.0 / sqrt(static_cast<double>(D)) * kLog2e);
}

// a tile in one box where pages hold whole tiles, else two boxes of 8
int box_rows(int page_size) { return page_size % KT == 0 ? KT : kMinBox; }

}  // namespace

// q [B, Hq, D] bf16, pools [num_pages, page, Hkv, D] bf16, page_table [B,
// max_pages] int32, seq_lens [B] int32, out [B, Hq, D] bf16, all contiguous
// and 16-byte aligned; D 128, Hq / Hkv <= 16, page a multiple of 8; split
// CTAs a (slot, KV head) cluster (ops.decode_plan).
extern "C" int paged_decode_attention(const void* q, const void* k_pages,
                                      const void* v_pages,
                                      const void* page_table,
                                      const void* seq_lens, void* out, int b,
                                      int hq, int hkv, int d, int page_size,
                                      int max_pages, int num_pages, int split,
                                      void* stream) {
  if (b <= 0 || num_pages <= 0 ||
      !valid(hq, hkv, d, page_size, max_pages, split))
    return static_cast<int>(cudaErrorInvalidValue);
  const Params p{static_cast<const bf16*>(q), static_cast<bf16*>(out),
                 static_cast<const int*>(page_table),
                 static_cast<const int*>(seq_lens), hq, hkv, hq / hkv,
                 page_size, max_pages, 0, 0, 0, box_rows(page_size),
                 scale_log2()};
  return launch<true>(k_pages, v_pages, num_pages, p, dim3(split, hkv, b),
                      split, stream);
}

// one chunk q [C, Hq, D] of one sequence at positions start.., page_row
// [max_pages]; total = start + the chunk's valid rows; split CTAs a (KV head,
// 64-row tile) cluster (ops.prefill_plan).
extern "C" int paged_prefill_attention(const void* q, const void* k_pages,
                                       const void* v_pages,
                                       const void* page_row, void* out, int c,
                                       int hq, int hkv, int d, int page_size,
                                       int max_pages, int num_pages, int start,
                                       int total, int split, void* stream) {
  if (c <= 0 || num_pages <= 0 || start < 0 || total < start ||
      !valid(hq, hkv, d, page_size, max_pages, split))
    return static_cast<int>(cudaErrorInvalidValue);
  const int g = hq / hkv;
  const int row_tiles = (c * g + Layout<false>::kRows - 1) /
                        Layout<false>::kRows;
  const Params p{static_cast<const bf16*>(q), static_cast<bf16*>(out),
                 static_cast<const int*>(page_row), nullptr, hq, hkv, g,
                 page_size, max_pages, c, start, total, box_rows(page_size),
                 scale_log2()};
  return launch<false>(k_pages, v_pages, num_pages, p,
                       dim3(split, row_tiles, hkv), split, stream);
}
