// Flash-attention forward for Hopper (sm_90a): online-softmax GQA attention
// with causal, sliding-window and per-batch valid-length masks, any query
// and key length.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py:64
// flash_attention_fwd (pallas_call at :87). The plain version is
// repro_torch/kernels/flash_attention/ref.py flash_attention_fwd.
//
// What bounds it on this card: operations. The static prefill's shape
// (q [4, 4096, 24, 128], k/v [4, 4096, 8, 128] bf16, causal) moves 268 MB
// (0.080 ms at 3.35 TB/s) but does 4 * B * Hq * D * S(S+1)/2 = 4.1e11
// flop: 0.42 ms on the bf16 tensor cores. Scores never touch device
// memory: HBM traffic is O(S * D) per head instead of the O(S^2) of a
// materialized softmax. The previous kernel (warp-level m16n8k16
// products, 64 x 64 tiles, a two-stage cp.async ring filled by the
// computing threads, one CTA per tile) took 2.4991 ms at that shape.
//
// Design. A persistent grid, one CTA per SM, walks a list of work items
// (128-query tile, batch, query head) that the wrapper builds heaviest
// first (ops.work_order), the query heads of one KV head next to each
// other so that its K/V tiles are read from L2 by all of them. A CTA is
// three warpgroups:
// - a producer (setmaxnreg.dec to 24 registers; one thread issues every
//   load) puts the item's Q tile, then its K and V tiles of 128 keys, into
//   shared memory by TMA (cp.async.bulk.tensor over 4-D tensor maps of the
//   model layout [B, S, H, D] with the tensors' own strides, built on the
//   host for each call, so v may be a column view of the fused QKV
//   projection; rows past Sq or Sk arrive as zeros). K and V go through a
//   ring of kStages stages with a full barrier (transaction bytes) and an
//   empty barrier (the consumers' eight warps) each, so K of the next tile
//   loads as soon as the current S is done;
// - two consumers (setmaxnreg.inc to 240) own 64 query rows each. S = Q K^T
//   is wgmma m64n128k16 with Q and K read from shared memory in the
//   128-byte swizzle TMA writes (K-major; D 128 is two 64-column swizzle
//   atoms). The online softmax runs on the fp32 accumulator in registers:
//   scale and log2(e) folded into one multiply, ex2, two-way trees for the
//   row max and sum, o rescaled only when a row's max moved. p V is wgmma
//   m64nDk16 with p from registers (the accumulator's layout is the A
//   fragment's, no shuffles) and V through the transpose bit (MN-major).
//   p is split into bf16 hi + lo (p - hi rounded again), two products into
//   the same fp32 accumulator, so p carries 16 significant bits instead of
//   bf16's 8: the kernel holds an fp32 plain version within a fraction of
//   a bf16 ulp, at 1.5x the tensor work of one bf16 p V. Tile t's S is
//   issued beside tile t - 1's p V. At D 64 the softmax of t runs while
//   that p V finishes; at D 128 it waits for it (kPvInFlight), since p's
//   fragments of t - 1 would stay live beside S and o. Either way one
//   warpgroup's softmax overlaps the other warpgroup's products.
// Masks are evaluated only on tiles that cross a warp's causal, window,
// kv_len or Sk edge; interior tiles skip the compares. Masked scores are
// -1e30 (finite, as in the Pallas kernel), keys past Sk -inf, so a row
// with no valid key returns the mean of V over all keys, as the plain
// version does. Key tiles wholly outside every row's causal / window band
// or past kv_len are skipped (they add exactly 0 once a row has a valid
// key); an item holding a row with no valid key visits every tile, to keep
// that row's mean. The output is written once, in bf16.
//
// Registers (ptxas -v): a consumer's S (64 fp32), p hi + lo (64) and o (D /
// 2) fit its 240 at D 64; at D 128 they spilled 352 bytes and ran 6% slower
// than the softmax waiting for p V, which spills none (flash_ablations.py).
// Shared memory: Q 32 KB +
// 2 stages x (K 32 KB + V 32 KB) = 160 KB at D 128 (a third stage measured
// slower), half at D 64.

#include <cuda.h>              // CUtensorMap and its enums (no -lcuda)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int BQ = 128;             // query rows an item (64 a consumer)
constexpr int BK = 128;             // keys per tile
constexpr int kStages = 2;          // K/V ring depth
constexpr int kThreads = 384;       // producer + two consumer warpgroups
constexpr int kAtom = 64;           // bf16 in one 128-byte swizzle row
constexpr int kRowBytes = 128;
constexpr float kNegInf = -1e30f;   // masked score, as the Pallas kernel
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr int kMaxDevices = 16;
// p V products left in flight while the softmax runs: 1 at D 64; 0 at D
// 128, where p's fragments and o beside S spill (see Registers above)
template <int D>
constexpr int kPvInFlight = D == 64 ? 1 : 0;

struct Params {
  const int* kv_len;
  const int* order;                 // items: qtile * (B * Hq) + b * Hq + h
  bf16* out;
  float* lse;                       // [B, Hq, Sq] or null: not written
  int n_items, b, hq, hkv, sq, sk, q_offset, window, causal;
  float scale_log2;                 // D^-0.5 * log2(e)
};

// Shared memory, every tile 1024-byte aligned (the swizzle's period): Q
// [D / 64 halves][BQ rows][64], then kStages K tiles and kStages V tiles
// [D / 64][BK][64], then the barriers.
template <int D>
struct Layout {
  static constexpr int kHalves = D / kAtom;
  static constexpr int kHalfQ = BQ * kRowBytes;
  static constexpr int kHalfKV = BK * kRowBytes;
  static constexpr int kQBytes = kHalves * kHalfQ;
  static constexpr int kTileBytes = kHalves * kHalfKV;
  static constexpr int kK = kQBytes;
  static constexpr int kV = kK + kStages * kTileBytes;
  static constexpr int kBar = kV + kStages * kTileBytes;
  static constexpr int kBars = 2 + 4 * kStages;
  static constexpr int kBytes = kBar + 8 * kBars + 1024;  // + alignment
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
// until the phase of parity ``parity`` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

// one box of a 4-D tensor map into shared memory, completing on ``bar``
__device__ __forceinline__ void tma_load_4d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3) : "memory");
}

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// until at most N committed groups of this warpgroup are in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving accesses of a wgmma accumulator across
// the asynchronous product
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets (16-byte units)
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) |
         (1ull << 62);
}
// K-major operand (Q, K): rows of 128 bytes, 8-row groups 1024 bytes apart
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t addr) {
  return smem_desc(addr, 16, 8 * kRowBytes);
}
// MN-major operand (V: keys x D, D contiguous): 64-column atoms ``atom``
// bytes apart along D, 8-key groups 1024 bytes apart
__device__ __forceinline__ uint64_t mnmajor_desc(uint32_t addr, uint32_t atom) {
  return smem_desc(addr, atom, 8 * kRowBytes);
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

// d (+)= A (smem, K-major) * B (smem, K-major): m64n128k16, bf16 in, fp32 d
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                                uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d += A (registers) * B (smem, MN-major): m64n128k16, bf16 in, fp32 d
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                                const uint32_t (&a)[4],
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d += A (registers) * B (smem, MN-major): m64n64k16, bf16 in, fp32 d
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                                const uint32_t (&a)[4],
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int D>
__device__ __forceinline__ void wgmma_rs(float (&d)[D / 2],
                                         const uint32_t (&a)[4], uint64_t db) {
  if constexpr (D == 128)
    wgmma_rs_n128(d, a, db);
  else
    wgmma_rs_n64(d, a, db);
}

// The key tiles [begin, end) an item visits: the union of its rows' bands
// [lo, hi) (hi: kv_len, causal pos + 1; lo: pos - window + 1), or every
// tile when a row has an empty band. lo and hi grow with the row and a
// row's band width rises then falls, so rows with an empty band can only
// sit at either end of the item: the first and last rows decide.
// ops.key_tiles is the same rule in Python (the host's work order).
__device__ __forceinline__ void key_tiles(const Params& p, int q0, int kvl,
                                          int& begin, int& end) {
  const int p0 = q0 + p.q_offset;
  const int p1 = min(q0 + BQ, p.sq) - 1 + p.q_offset;
  const int hi0 = p.causal ? min(kvl, p0 + 1) : kvl;
  const int hi1 = p.causal ? min(kvl, p1 + 1) : kvl;
  const int lo0 = p.window > 0 ? max(0, p0 - p.window + 1) : 0;
  const int lo1 = p.window > 0 ? max(0, p1 - p.window + 1) : 0;
  if (lo0 >= hi0 || lo1 >= hi1) {
    begin = 0;
    end = (p.sk + BK - 1) / BK;
  } else {
    begin = lo0 / BK;
    end = (hi1 + BK - 1) / BK;
  }
}

struct Item {
  int q0, b, h, hk, kvl, begin, end;
};

__device__ __forceinline__ Item decode(const Params& p, int i) {
  const int nbh = p.b * p.hq;
  const int code = p.order[i];
  Item it;
  it.q0 = code / nbh * BQ;
  it.b = code % nbh / p.hq;
  it.h = code % p.hq;
  it.hk = it.h / (p.hq / p.hkv);
  it.kvl = min(max(p.kv_len[it.b], 0), p.sk);
  key_tiles(p, it.q0, it.kvl, it.begin, it.end);
  return it;
}

// S = Q K^T for one warpgroup: its 64 Q rows at ``q_rows`` against the
// 128-key K tile at ``kt``, D / 16 k-steps, one committed group
template <int D>
__device__ __forceinline__ void issue_s(float (&s)[BK / 2], uint32_t q_rows,
                                        uint32_t kt) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t hoff = kk / 4, koff = kk % 4 * 32;
    wgmma_ss_n128(s, kmajor_desc(q_rows + hoff * Layout<D>::kHalfQ + koff),
                  kmajor_desc(kt + hoff * Layout<D>::kHalfKV + koff), kk > 0);
  }
  wgmma_commit();
}

// o += p V against the V tile at ``vt``: BK / 16 k-steps of 16 keys, V
// MN-major, p as hi and lo; one committed group
template <int D>
__device__ __forceinline__ void issue_pv(float (&o)[D / 2],
                                         const uint32_t (&ph)[BK / 16][4],
                                         const uint32_t (&pl)[BK / 16][4],
                                         uint32_t vt) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    const uint64_t dv = mnmajor_desc(vt + kk * 16 * kRowBytes,
                                     Layout<D>::kHalfKV);
    wgmma_rs<D>(o, ph[kk], dv);
    wgmma_rs<D>(o, pl[kk], dv);
  }
  wgmma_commit();
}

// Masks (on a tile that crosses an edge of the warp's 16 rows only), then
// the online softmax in base 2 of one tile of key columns c0..c0+127; a
// row's keys live in the 4 lanes of one quad. s becomes p; m, l and the
// rescale alpha of o are per row (g and g + 8 of the warp). Maxima and
// sums run as two-way trees (short dependency chains). An interior tile
// takes p = exp2(s * scale_log2 - m) as one fma; an edge tile scales
// first (never fused) so that a masked -1e30 minus a max of -1e30 is
// exactly 0 and a row with no valid key stays uniform.
__device__ __forceinline__ void softmax_tile(const Params& p,
                                             float (&s)[BK / 2], float (&m)[2],
                                             float (&l)[2], float (&alpha)[2],
                                             int c0, int kvl, int pos_w,
                                             int g, int t4) {
  const bool edge = c0 + BK > kvl || (p.causal && c0 + BK - 1 > pos_w) ||
                    (p.window > 0 && c0 <= pos_w + 15 - p.window);
  const float sl2 = p.scale_log2;
  if (edge) {
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int pos = pos_w + g + 8 * hr;
#pragma unroll
      for (int n = 0; n < BK / 8; ++n)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int col = c0 + n * 8 + 2 * t4 + j;
          bool ok = col < kvl;
          if (p.causal) ok = ok && col <= pos;
          if (p.window > 0) ok = ok && col > pos - p.window;
          float& x = s[4 * n + 2 * hr + j];
          x = col >= p.sk ? -INFINITY : (ok ? __fmul_rn(x, sl2) : kNegInf);
        }
    }
  }
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    float mx2[2] = {kNegInf, kNegInf}, sum2[2] = {0.f, 0.f};
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        mx2[j] = fmaxf(mx2[j], s[4 * n + 2 * hr + j]);
    float mx = fmaxf(mx2[0], mx2[1]);
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    if (!edge) mx *= sl2;         // scale > 0: the max of the scaled row
    const float m_new = fmaxf(m[hr], mx);
    alpha[hr] = exp2_ftz(m[hr] - m_new);
    if (edge) {
#pragma unroll
      for (int n = 0; n < BK / 8; ++n)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          float& x = s[4 * n + 2 * hr + j];
          x = exp2_ftz(__fsub_rn(x, m_new));
          sum2[j] += x;
        }
    } else {
#pragma unroll
      for (int n = 0; n < BK / 8; ++n)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          float& x = s[4 * n + 2 * hr + j];
          x = exp2_ftz(fmaf(x, sl2, -m_new));
          sum2[j] += x;
        }
    }
    float sum = sum2[0] + sum2[1];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    l[hr] = l[hr] * alpha[hr] + sum;
    m[hr] = m_new;
  }
}

// p's A fragments: for k-step kk the accumulators of key columns
// 16kk..16kk+15 (n8 blocks 2kk and 2kk + 1), split into bf16 hi and lo
__device__ __forceinline__ void split_p(const float (&s)[BK / 2],
                                        uint32_t (&ph)[BK / 16][4],
                                        uint32_t (&pl)[BK / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    split_bf16(s[8 * kk], s[8 * kk + 1], ph[kk][0], pl[kk][0]);
    split_bf16(s[8 * kk + 2], s[8 * kk + 3], ph[kk][1], pl[kk][1]);
    split_bf16(s[8 * kk + 4], s[8 * kk + 5], ph[kk][2], pl[kk][2]);
    split_bf16(s[8 * kk + 6], s[8 * kk + 7], ph[kk][3], pl[kk][3]);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap tq,
                 const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv, const Params p) {
  using L = Layout<D>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t q_smem = base, k_smem = base + L::kK, v_smem = base + L::kV;
  const uint32_t q_full = base + L::kBar, q_empty = q_full + 8;
  const uint32_t k_full = q_full + 16;                 // + 8 * stage
  const uint32_t v_full = k_full + 8 * kStages;
  const uint32_t k_empty = v_full + 8 * kStages;
  const uint32_t v_empty = k_empty + 8 * kStages;
  const int tid = threadIdx.x;

  if (tid == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_empty, 8);                            // the consumers' warps
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(v_full + 8 * s, 1);
      mbar_init(k_empty + 8 * s, 8);
      mbar_init(v_empty + 8 * s, 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid < 128) {
    // ---- producer: one thread issues every TMA load ----
    setmaxnreg_dec<24>();
    if (tid == 0) {
      int stage = 0, phase = 0, q_phase = 0;
      for (int i = blockIdx.x; i < p.n_items; i += gridDim.x) {
        const Item it = decode(p, i);
        mbar_wait(q_empty, q_phase ^ 1);              // Q of the last item read
        q_phase ^= 1;
        mbar_expect_tx(q_full, L::kQBytes);
#pragma unroll
        for (int hf = 0; hf < L::kHalves; ++hf)
          tma_load_4d(q_smem + hf * L::kHalfQ, &tq, q_full, hf * kAtom, it.h,
                      it.q0, it.b);
        for (int t = it.begin; t < it.end; ++t) {
          const uint32_t off = stage * L::kTileBytes;
          mbar_wait(k_empty + 8 * stage, phase ^ 1);
          mbar_expect_tx(k_full + 8 * stage, L::kTileBytes);
#pragma unroll
          for (int hf = 0; hf < L::kHalves; ++hf)
            tma_load_4d(k_smem + off + hf * L::kHalfKV, &tk, k_full + 8 * stage,
                        hf * kAtom, it.hk, t * BK, it.b);
          mbar_wait(v_empty + 8 * stage, phase ^ 1);
          mbar_expect_tx(v_full + 8 * stage, L::kTileBytes);
#pragma unroll
          for (int hf = 0; hf < L::kHalves; ++hf)
            tma_load_4d(v_smem + off + hf * L::kHalfKV, &tv, v_full + 8 * stage,
                        hf * kAtom, it.hk, t * BK, it.b);
          if (++stage == kStages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    // ---- consumers: 64 query rows a warpgroup ----
    setmaxnreg_inc<240>();
    const int c = tid / 128 - 1;
    const int warp = tid / 32 % 4, lane = tid % 32;
    const int g = lane >> 2, t4 = lane & 3;
    // this warpgroup's 64 rows of the Q tile (8 swizzle periods of 1024 B)
    const uint32_t q_rows = q_smem + c * 64 * kRowBytes;
    int stage = 0, phase = 0, q_phase = 0;
    for (int i = blockIdx.x; i < p.n_items; i += gridDim.x) {
      const Item it = decode(p, i);
      const int row_w = it.q0 + 64 * c + 16 * warp;   // the warp's first row
      const int pos_w = row_w + p.q_offset;
      float o[D / 2], s[BK / 2], m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
      uint32_t ph[BK / 16][4], pl[BK / 16][4];
#pragma unroll
      for (int j = 0; j < D / 2; ++j) o[j] = 0.f;
      mbar_wait(q_full, q_phase);
      q_phase ^= 1;

      // Every item has at least one key tile. The first tile's S runs
      // alone; then tile t's S is issued beside tile t - 1's p V, and at
      // D 64 the softmax of t runs while the tensor cores finish p V; the
      // last tile's p V runs alone. No product sits under a branch (ptxas
      // serializes wgmma on divergent paths).
      float alpha[2];
      mbar_wait(k_full + 8 * stage, phase);
      pin(s);
      wgmma_fence();
      issue_s<D>(s, q_rows, k_smem + stage * L::kTileBytes);
      wgmma_wait<0>();
      pin(s);
      if (lane == 0) {
        mbar_arrive(k_empty + 8 * stage);
        if (it.end - it.begin == 1) mbar_arrive(q_empty);
      }
      softmax_tile(p, s, m, l, alpha, it.begin * BK, it.kvl, pos_w, g, t4);
      split_p(s, ph, pl);
      int v_stage = stage, v_phase = phase;
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1;
      }
      for (int t = it.begin + 1; t < it.end; ++t) {
        mbar_wait(k_full + 8 * stage, phase);
        mbar_wait(v_full + 8 * v_stage, v_phase);
        pin(s);
        pin(o);
        wgmma_fence();
        issue_s<D>(s, q_rows, k_smem + stage * L::kTileBytes);
        issue_pv<D>(o, ph, pl, v_smem + v_stage * L::kTileBytes);
        wgmma_wait<kPvInFlight<D>>();        // S of t (and at D 128 p V) landed
        pin(s);
        if (lane == 0) {
          mbar_arrive(k_empty + 8 * stage);
          if (t == it.end - 1) mbar_arrive(q_empty);
        }
        softmax_tile(p, s, m, l, alpha, t * BK, it.kvl, pos_w, g, t4);
        wgmma_wait<0>();                              // p V of t - 1 done
        pin(o);
        if (lane == 0) mbar_arrive(v_empty + 8 * v_stage);
        // o *= alpha, skipped when no row of the warp moved its max
        if (!__all_sync(0xffffffffu, alpha[0] == 1.f && alpha[1] == 1.f))
#pragma unroll
        for (int n = 0; n < D / 8; ++n) {
          o[4 * n] *= alpha[0];
          o[4 * n + 1] *= alpha[0];
          o[4 * n + 2] *= alpha[1];
          o[4 * n + 3] *= alpha[1];
        }
        split_p(s, ph, pl);
        v_stage = stage;
        v_phase = phase;
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
      mbar_wait(v_full + 8 * v_stage, v_phase);
      pin(o);
      wgmma_fence();
      issue_pv<D>(o, ph, pl, v_smem + v_stage * L::kTileBytes);
      wgmma_wait<0>();
      pin(o);
      if (lane == 0) mbar_arrive(v_empty + 8 * v_stage);

      // o / l, rounded to bf16 once; out is contiguous [B, Sq, Hq, D].
      // With lse, one lane of the row's quad writes its natural log-sum-
      // exp m ln 2 + ln l (m is in log2 units); a row with no valid key
      // keeps m at the masked score, whose lse is the masked score itself
      // (-1e30 + ln l rounds to it in fp32), as the plain version's
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int r = row_w + g + 8 * hr;
        if (r >= p.sq) continue;
        const float inv = 1.f / fmaxf(l[hr], 1e-30f);
        if (p.lse != nullptr && t4 == 0)
          p.lse[(static_cast<long long>(it.b) * p.hq + it.h) * p.sq + r] =
              m[hr] == kNegInf
                  ? kNegInf
                  : fmaf(m[hr], kLn2, logf(fmaxf(l[hr], 1e-30f)));
        bf16* dst = p.out +
                    ((static_cast<long long>(it.b) * p.sq + r) * p.hq + it.h) *
                        D + 2 * t4;
#pragma unroll
        for (int n = 0; n < D / 8; ++n)
          *reinterpret_cast<uint32_t*>(dst + n * 8) =
              pack_bf16(o[4 * n + 2 * hr] * inv, o[4 * n + 2 * hr + 1] * inv);
      }
    }
  }
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

// a [B, S, H, D] bf16 tensor with element strides (sb, ss, sh, 1), read in
// boxes of 64 columns x ``rows`` rows of one head, 128-byte swizzled, zeros
// past the edges
int encode(CUtensorMap* map, const void* ptr, int d, int h, int s, int b,
           long long sb, long long ss, long long sh, int rows) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(d),
                              static_cast<cuuint64_t>(h),
                              static_cast<cuuint64_t>(s),
                              static_cast<cuuint64_t>(b)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(sh) * 2,
                                 static_cast<cuuint64_t>(ss) * 2,
                                 static_cast<cuuint64_t>(sb) * 2};
  const cuuint32_t box[4] = {kAtom, 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                        const_cast<void*>(ptr), dims, strides, box, unit,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : 10000 + static_cast<int>(r);
}

template <int D>
int launch(const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv,
           const Params& p, void* stream) {
  static bool ready[kMaxDevices];
  static int sms[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (!ready[dev]) {
    err = cudaFuncSetAttribute(flash_fwd_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               Layout<D>::kBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount,
                                 dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    ready[dev] = true;
  }
  const int grid = p.n_items < sms[dev] ? p.n_items : sms[dev];
  flash_fwd_kernel<D><<<grid, kThreads, Layout<D>::kBytes,
                        static_cast<cudaStream_t>(stream)>>>(tq, tk, tv, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q [B, Sq, Hq, D], k / v [B, Sk, Hkv, D] bf16 with element strides (batch,
// sequence, head; D contiguous, strides multiples of 8, 16-byte aligned
// bases), kv_len [B] int32, order [n_items] int32 (every (query tile of 128,
// batch, head) once, as ops.work_order builds it), out contiguous [B, Sq,
// Hq, D] bf16, lse null or contiguous [B, Hq, Sq] fp32 (each row's natural
// log-sum-exp of its scaled scores). D is 64 or 128; Hq a multiple of Hkv;
// Sk > 0.
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, const void* kv_len,
    const void* order, void* out, void* lse, int b, int hq, int hkv, int sq, int sk,
    int d, int q_offset, int window, int causal, int n_items, int q_sb,
    int q_ss, int q_sh, int k_sb, int k_ss, int k_sh, int v_sb, int v_ss,
    int v_sh, float scale, void* stream) {
  if (hkv <= 0 || hq % hkv || b <= 0 || sq <= 0 || sk <= 0 || n_items <= 0 ||
      (d != 64 && d != 128))
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tq, tk, tv;
  int err = encode(&tq, q, d, hq, sq, b, q_sb, q_ss, q_sh, BQ);
  if (err == 0) err = encode(&tk, k, d, hkv, sk, b, k_sb, k_ss, k_sh, BK);
  if (err == 0) err = encode(&tv, v, d, hkv, sk, b, v_sb, v_ss, v_sh, BK);
  if (err != 0) return err;
  const Params p{static_cast<const int*>(kv_len),
                 static_cast<const int*>(order), static_cast<bf16*>(out),
                 static_cast<float*>(lse), n_items, b, hq, hkv, sq, sk,
                 q_offset, window, causal, scale * kLog2e};
  return d == 128 ? launch<128>(tq, tk, tv, p, stream)
                  : launch<64>(tq, tk, tv, p, stream);
}
