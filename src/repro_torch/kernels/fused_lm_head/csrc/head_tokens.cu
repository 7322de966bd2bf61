// The fused LM head for Hopper (sm_90a): final hidden x [S, D] and the tied
// embedding W [V, D] (head_tokens) or an untied head W [D, V]
// (head_tokens_untied), read in place -> (tokens int32 [S], ok bool [S]):
// the unembed GEMM,
// the greedy argmax, the all-finite probe, temperature scaling, the top-k /
// top-p filter and the inverse-CDF draw, with no fp32 [S, V] logits tensor.
//
// Replaces the TPU kernel src/repro/kernels/fused_lm_head/kernel.py:64
// head_tokens (pallas_call at :73). The plain version is
// repro_torch/kernels/fused_lm_head/ref.py head_tokens: unembed, then
// head_epilogue (argmax, probe, temperature, filter_logits_bisect,
// draw_tokens), the same ops as the unfused sampler.
//
// What bounds it on this card: bytes. The weight is read once: 128256 x
// 3072 bf16 = 788 MB, 0.235 ms at 3.35 TB/s; the 2 x S x V x D operations
// take 0.006 ms at the bf16 tensor-core peak.
//
// What its design does about it. The TPU kernel keeps the [S, V] logits in
// VMEM scratch across its sequential grid and runs the epilogue on them.
// A Hopper CTA cannot hold a row (128256 entries), and recomputing the
// logits for each of the sampler's sweeps over a row would read the weight
// once a sweep. The logits are bf16 values by contract (the
// product is rounded to the model dtype before the upcast, as unembed does),
// so a bf16 [S, V] workspace holds them losslessly: 2 MB at S = 8, which
// stays in the 50 MB L2. The op takes two launches:
//   1. head_gemv_kernel streams W. Each CTA takes 128 vocab rows and one
//      group of up to 8 hidden rows (the mma's N); each warp computes the
//      logits of 16 vocab rows for the group's hidden rows with mma.sync
//      m16n8k16 (bf16 in, fp32 accumulate), W fragments loaded straight
//      from global memory (each thread 2 x 32 contiguous bytes per 64-wide
//      K chunk, four chunks in flight), x from shared memory. The K order
//      inside a chunk is permuted identically for W and x, so each thread's
//      loads are contiguous. The group is the grid's fastest index, so the
//      CTAs of every group of one vocab tile are dispatched together and W
//      comes from HBM once for any S, the other groups' reads hitting L2.
//      The fp32 sum is rounded once to bf16 and written to the workspace;
//      each CTA also writes per-row partials (max, first argmax, all
//      finite) of its 128 vocab rows.
//      An untied head [D, V] has the vocab contiguous, so its pass 1 is
//      head_gemv_wgmma_kernel, which reads W in place (a transposed copy
//      would be a second 0.42 GB at deepseek-moe-16b's 2048 x 102400). It
//      too is bound by bytes: those 0.42 GB take 0.125 ms at 3.35 TB/s,
//      the 2 S D V operations (3.4 GFLOP at S = 8) 0.003 ms on the tensor
//      cores. Four parts of its design keep the memory system busy:
//      (a) bytes in flight do not depend on registers: one producer thread
//          streams W by TMA (cp.async.bulk.tensor.2d; the tensor map is
//          built on the host each call) into a ring of 4-10 stages with
//          full and empty mbarriers, 128-160 KB a CTA in flight at the
//          served shapes (ops.untied_plan);
//      (b) the products run on the tensor cores: wgmma m64nNk16 with a W
//          tile as A (64 vocab columns, vocab-contiguous, through the
//          transpose bit) and x as B (N = 8 or 16 hidden rows, K-major,
//          loaded whole into shared memory once a row group), fp32
//          accumulation, K ascending;
//      (c) a balanced persistent grid with no wave tail: one CTA an SM,
//          each walking a contiguous range of 64-column tiles (T tiles over
//          G CTAs, CTA c from c T / G), at most 1.08x the mean at the
//          served shapes. A ring stage holds the same 16 K rows of a panel
//          of 4, 8 or 16 tiles, the whole range at the served shapes, so
//          the CTAs together read whole K rows of W at a time and DRAM
//          pages are used while open (a stage of one tile reads 128
//          scattered bytes a K row, which streams W more slowly);
//      (d) W is read from HBM once for any S <= 16 (N = 16 holds rows
//          9-16); more rows loop over groups of 16 inside the CTA.
//      Each column's sum is one CTA's, in a fixed order, with no atomics,
//      so the bits are the same every call. It writes the same workspace
//      and partials as the tied pass, a partial block a 64-column tile.
//   2. head_epilogue_kernel, one thread block cluster a row (size from
//      fused_sampling/ops.cluster_plan, 1 for a step with no sampled row):
//      the greedy token and the probe from the partials;
//      for a sampled row each CTA scales its share of the workspace row
//      once (x / t, fp32) into shared memory as monotone keys, and the
//      sampler's cluster code (sampling_device.cuh, the same code as the
//      unfused filter kernel: a radix select for top-k, the masses written
//      once, a fixed-point estimate of the nucleus key and exact sweeps of
//      16 candidates whose folds run in 16 lanes of rank 0) and the draw
//      read shared memory only; counts and maxima combine across the
//      cluster through distributed shared memory, and tile masses are
//      folded in tile order by rank 0. Each sampled row's draw uniform is
//      computed in the kernel from its request seed and stream position
//      (threefry2x32, sampling_device.cuh row_uniform), beside the fold.
//      Tokens are bitwise those of the plain epilogue fed the same logits
//      and ref.row_uniforms of the same seeds and positions.
// Argmax ties go to the smallest index, NaN counts as the largest value (as
// torch.argmax). The GEMM's summation order is the tensor core's: on inputs
// whose every partial sum is exact in fp32 the logits, and so the tokens,
// are bitwise those of any other GEMM.

#include <cooperative_groups.h>
#include <cuda.h>              // CUtensorMap and its enums (no -lcuda)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "../../fused_sampling/csrc/sampling_device.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kGemvThreads = 256;
constexpr int kGemvWarps = kGemvThreads / 32;
constexpr int kRowsPerWarp = 16;                     // mma M: vocab rows
constexpr int kRowsPerCta = kGemvWarps * kRowsPerWarp;
constexpr int kGroupRows = 8;                        // mma N: hidden rows
constexpr int kChunk = 64;                           // K per chunk: 4 mma
constexpr int kUnroll = 4;                           // chunks in flight
constexpr int kXPad = 8;                             // bf16 pad per smem row

// Whether candidate (bv, bi) beats (av, ai) for the first argmax: NaN is
// the largest value, ties go to the smaller index, bi == INT_MAX is empty.
__device__ __forceinline__ bool beats(float av, int ai, float bv, int bi) {
  if (bi == INT_MAX) return false;
  if (ai == INT_MAX) return true;
  const bool an = isnan(av), bn = isnan(bv);
  if (an != bn) return bn;
  if (an || av == bv) return bi < ai;
  return bv > av;
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], unsigned a0,
                                         unsigned a1, unsigned a2, unsigned a3,
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void words(const uint4& lo, const uint4& hi,
                                      unsigned (&w)[8]) {
  w[0] = lo.x; w[1] = lo.y; w[2] = lo.z; w[3] = lo.w;
  w[4] = hi.x; w[5] = hi.y; w[6] = hi.z; w[7] = hi.w;
}

// Pass 1. Grid: (hidden row group of kGroupRows, 128 vocab rows). Dynamic
// shared memory: the group's rows of x as kGroupRows rows of (d + kXPad)
// bf16, rows past s_rows zero.
//
// mma fragments (PTX ISA, m16n8k16 .bf16): lane = 4 g + t. A (16 x 16,
// row-major) holds rows g and g + 8 at K = 2t, 2t + 1 (regs a0, a1) and
// 2t + 8, 2t + 9 (a2, a3); B (16 x 8) holds K = 2t, 2t + 1 and 2t + 8,
// 2t + 9 of column g; C holds rows g, g + 8 at columns 2t, 2t + 1. Logical
// K of mma step j (0..3) inside a 64-wide chunk maps to the chunk element
// 16 t + 4 j + (K >= 8 ? 2 : 0) + (K & 1), the same map for W and x, so
// lane (g, t) reads elements [16 t, 16 t + 16) of its rows: 32-bit word
// 2 j is the fragment pair for K < 8 and word 2 j + 1 the pair for K >= 8.
__global__ void __launch_bounds__(kGemvThreads, 2)
head_gemv_kernel(const __nv_bfloat16* __restrict__ x,
                 const __nv_bfloat16* __restrict__ w, int s_rows, int d,
                 int vocab, int n_blk, __nv_bfloat16* __restrict__ ws,
                 float* __restrict__ pmax, int* __restrict__ pidx,
                 int* __restrict__ pok) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ float best_v[kGemvWarps][kGroupRows];
  __shared__ int best_i[kGemvWarps][kGroupRows];
  __shared__ int best_f[kGemvWarps][kGroupRows];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  const int s0 = blockIdx.x * kGroupRows, blk = blockIdx.y;
  const int s_here = min(kGroupRows, s_rows - s0);
  const int xstride = d + kXPad;
  const int vec_per_row = d / 8;
  for (int i = threadIdx.x; i < kGroupRows * vec_per_row; i += kGemvThreads) {
    const int r = i / vec_per_row, c = (i % vec_per_row) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r < s_here)
      v = *reinterpret_cast<const uint4*>(
          x + static_cast<size_t>(s0 + r) * d + c);
    *reinterpret_cast<uint4*>(xs + r * xstride + c) = v;
  }
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int v0 = blk * kRowsPerCta + warp * kRowsPerWarp;
  const bool active = v0 < vocab;            // vocab % 16 == 0
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  if (active) {
    const __nv_bfloat16* wa = w + static_cast<size_t>(v0 + g) * d + t * 16;
    const __nv_bfloat16* wb = wa + static_cast<size_t>(8) * d;
    const __nv_bfloat16* xr = xs + g * xstride + t * 16;
    const int n_chunk = d / kChunk;
    for (int c0 = 0; c0 < n_chunk; c0 += kUnroll) {
      uint4 ra[kUnroll][2], rb[kUnroll][2];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (c0 + u < n_chunk) {
          const int off = (c0 + u) * kChunk;
          ra[u][0] = __ldg(reinterpret_cast<const uint4*>(wa + off));
          ra[u][1] = __ldg(reinterpret_cast<const uint4*>(wa + off + 8));
          rb[u][0] = __ldg(reinterpret_cast<const uint4*>(wb + off));
          rb[u][1] = __ldg(reinterpret_cast<const uint4*>(wb + off + 8));
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (c0 + u < n_chunk) {
          const int off = (c0 + u) * kChunk;
          unsigned aw[8], bw[8], xw[8];
          words(ra[u][0], ra[u][1], aw);
          words(rb[u][0], rb[u][1], bw);
          words(*reinterpret_cast<const uint4*>(xr + off),
                *reinterpret_cast<const uint4*>(xr + off + 8), xw);
#pragma unroll
          for (int j = 0; j < 4; ++j)
            mma_bf16(acc, aw[2 * j], bw[2 * j], aw[2 * j + 1], bw[2 * j + 1],
                     xw[2 * j], xw[2 * j + 1]);
        }
      }
    }
  }

  // acc[q]: vocab row v0 + g + 8 (q >> 1), hidden row s0 + 2 t + (q & 1)
  float bv[2] = {0.f, 0.f};
  int bi[2] = {INT_MAX, INT_MAX};
  int fin[2] = {1, 1};
  if (active) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const __nv_bfloat16 b = __float2bfloat16_rn(acc[q]);
      const float v = __bfloat162float(b);
      const int vr = v0 + g + 8 * (q >> 1), s = 2 * t + (q & 1);
      if (s < s_here) ws[static_cast<size_t>(s0 + s) * vocab + vr] = b;
      if (beats(bv[q & 1], bi[q & 1], v, vr)) {
        bv[q & 1] = v;
        bi[q & 1] = vr;
      }
      fin[q & 1] &= isfinite(v) ? 1 : 0;
    }
  }
  for (int o = 4; o < 32; o <<= 1) {          // across g (lane bits 2..4)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float ov = __shfl_xor_sync(0xffffffffu, bv[h], o);
      const int oi = __shfl_xor_sync(0xffffffffu, bi[h], o);
      fin[h] &= __shfl_xor_sync(0xffffffffu, fin[h], o);
      if (beats(bv[h], bi[h], ov, oi)) {
        bv[h] = ov;
        bi[h] = oi;
      }
    }
  }
  if (g == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      best_v[warp][2 * t + h] = bv[h];
      best_i[warp][2 * t + h] = bi[h];
      best_f[warp][2 * t + h] = fin[h];
    }
  }
  __syncthreads();
  if (threadIdx.x < s_here) {
    const int s = threadIdx.x;
    float v = 0.f;
    int i = INT_MAX, f = 1;
    for (int k = 0; k < kGemvWarps; ++k) {
      if (beats(v, i, best_v[k][s], best_i[k][s])) {
        v = best_v[k][s];
        i = best_i[k][s];
      }
      f &= best_f[k][s];
    }
    const size_t o = static_cast<size_t>(s0 + s) * n_blk + blk;
    pmax[o] = v;
    pidx[o] = i;
    pok[o] = f;
  }
}

// ---- pass 1 of an untied head W [d, vocab]: a TMA ring into wgmma ----

constexpr int kTile = 64;             // vocab columns a tile: the wgmma's M
constexpr int kBK = 16;               // K rows of a tile a stage: its K
constexpr int kTRowBytes = 128;       // one K row of a tile (64 bf16)
constexpr int kBox = kBK * kTRowBytes;  // one tile's TMA box
constexpr int kTThreads = 160;        // a consumer warpgroup, a producer warp
constexpr int kMaxStages = 64;
constexpr int kSmemLimit = 232448;    // dynamic shared memory a block

// a ring stage: the same kBK K rows of `panel` tiles (4, 8 or 16)
__host__ __device__ constexpr int stage_bytes(int panel) {
  return panel * kBox;
}

// Dynamic shared memory of the untied GEMV, as ops.untied_plan counts it:
// 1024 bytes of alignment slack, x [d / 64 chunks][rows][128 bytes], the
// ring, a full and an empty barrier a stage and two for x, and the four
// warps' partial keys (4 bytes) and finite flags (1 byte) of each (tile,
// row) of a panel.
inline size_t untied_smem(int d, int rows, int panel, int stages) {
  return 1024 + static_cast<size_t>(d) * rows * 2 +
         static_cast<size_t>(stages) * stage_bytes(panel) +
         8 * (2 * stages + 2) + static_cast<size_t>(panel) * rows * 4 * 5;
}

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
// one box of a 2-D tensor map into shared memory, completing on ``bar``
__device__ __forceinline__ void tma_load_2d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}
// the consumer warpgroup's own barrier (the producer warp has left)
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, 128;\n" ::: "memory");
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

// d += A (smem, MN-major: W's 64 vocab columns contiguous, read through the
// transpose bit) * B (smem, K-major: x's rows): m64nNk16, bf16 in, fp32 d
__device__ __forceinline__ void wgmma_t(float (&d)[4], uint64_t da,
                                        uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, %4, %5, p, 1, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(da), "l"(db), "r"(1));
}
__device__ __forceinline__ void wgmma_t(float (&d)[8], uint64_t da,
                                        uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(1));
}

struct UntiedArgs {
  __nv_bfloat16* ws;
  float* pmax;
  int* pidx;
  int* pok;
  int s_rows, d, vocab, n_tiles, stages;
};

// Pass 1 of an untied head W [d, vocab]. A persistent grid of at most one
// CTA an SM; CTA c takes the contiguous vocab tiles [c T / G, (c + 1) T /
// G) of the T tiles of 64 columns (G CTAs; ops.untied_plan's ranges), in
// panels of P neighbouring tiles. N hidden rows a group (8 or 16); groups
// run one after another. Warps 0-3 consume, warp 4's first thread produces:
// - x's group [N, d] is loaded whole by TMA (64-column boxes, 128-byte
//   swizzle, rows past s_rows zero) into K-major wgmma layout;
// - a panel's W streams through a ring of `stages` stages, each the same
//   kBK = 16 K rows of the P tiles (one TMA box a tile, 128-byte
//   swizzle, columns past vocab zero), with a full barrier (transaction
//   bytes) and an empty barrier (the 4 consumer warps) a stage. All G CTAs
//   walk K together, so at a served shape (a range of at most P tiles)
//   they read whole K rows of W at a time;
// - a tile's K rows of a stage are one wgmma m64nNk16 (A: the tile,
//   vocab-contiguous, through the transpose bit; B: x's 16 K columns), K
//   ascending into one fp32 accumulator a tile; a stage's products are
//   waited for before it is released (the ring, not the products, keeps
//   the loads ahead);
// - the panel's epilogue writes each sum, rounded once to bf16, to the
//   workspace and reduces every (tile, row)'s partial (max, first argmax,
//   all finite) at once, as unsigned maxima of packed keys: in registers,
//   across lanes by shuffles, across the warps through shared memory, one
//   barrier a panel (the last panel of every CTA ends the kernel, so its
//   epilogue is paid in full; a tile at a time it was the kernel's tail).
// A panel that runs past the CTA's range computes its missing tiles on
// stale shared memory and stores nothing of them, so no product sits under
// a branch. Each column's sum is one CTA's in a fixed order: no atomics.
template <int N, int P>
__global__ void __launch_bounds__(kTThreads, 1)
head_gemv_wgmma_kernel(const __grid_constant__ CUtensorMap tw,
                       const __grid_constant__ CUtensorMap tx,
                       const UntiedArgs a) {
  constexpr int kStageBytes = stage_bytes(P);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t x_smem = base;
  const uint32_t ring = base + static_cast<uint32_t>(a.d) * N * 2;
  const uint32_t full = ring + a.stages * kStageBytes;   // + 8 * stage
  const uint32_t empty = full + 8 * a.stages;
  const uint32_t x_full = empty + 8 * a.stages, x_empty = x_full + 8;
  // the warps' partial keys and finite flags, [P][N][4 warps] each
  unsigned* red_best =
      reinterpret_cast<unsigned*>(smem_raw + (x_empty + 8 - raw));
  unsigned char* red_fin =
      reinterpret_cast<unsigned char*>(red_best + P * N * 4);
  const int tid = threadIdx.x;
  const int t0 = static_cast<int>(static_cast<long long>(blockIdx.x) *
                                  a.n_tiles / gridDim.x);
  const int t1 = static_cast<int>(static_cast<long long>(blockIdx.x + 1) *
                                  a.n_tiles / gridDim.x);
  const int n_grp = (a.s_rows + N - 1) / N, n_kb = a.d / kBK;

  if (tid == 0) {
    for (int s = 0; s < a.stages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 4);             // the consumer warps
    }
    mbar_init(x_full, 1);
    mbar_init(x_empty, 4);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= 128) {
    // ---- producer: one thread issues every TMA load ----
    if (tid == 128) {
      int stage = 0, phase = 0;
      for (int grp = 0; grp < n_grp; ++grp) {
        mbar_wait(x_empty, (grp & 1) ^ 1);     // the last group's x read
        mbar_expect_tx(x_full, a.d * N * 2);
        for (int ch = 0; ch < a.d / 64; ++ch)
          tma_load_2d(x_smem + ch * N * kTRowBytes, &tx, x_full, ch * 64,
                      grp * N);
        for (int pt = t0; pt < t1; pt += P) {
          const int np = min(P, t1 - pt);
          for (int kb = 0; kb < n_kb; ++kb) {
            mbar_wait(empty + 8 * stage, phase ^ 1);
            mbar_expect_tx(full + 8 * stage, np * kBox);
            for (int p = 0; p < np; ++p)
              tma_load_2d(ring + stage * kStageBytes + p * kBox, &tw,
                          full + 8 * stage, (pt + p) * kTile, kb * kBK);
            if (++stage == a.stages) {
              stage = 0;
              phase ^= 1;
            }
          }
        }
      }
    }
    return;
  }

  // ---- consumer warpgroup ----
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, q = lane & 3;
  int stage = 0, phase = 0;
  for (int grp = 0; grp < n_grp; ++grp) {
    const int row0 = grp * N, s_here = min(N, a.s_rows - row0);
    mbar_wait(x_full, grp & 1);
    for (int pt = t0; pt < t1; pt += P) {
      const int np = min(P, t1 - pt);
      float acc[P][N / 2];
#pragma unroll
      for (int p = 0; p < P; ++p)
#pragma unroll
        for (int i = 0; i < N / 2; ++i) acc[p][i] = 0.f;
      for (int kb = 0; kb < n_kb; ++kb) {
        mbar_wait(full + 8 * stage, phase);
#pragma unroll
        for (int p = 0; p < P; ++p) pin(acc[p]);
        wgmma_fence();
        const int k = kb * kBK;
        const uint64_t db = smem_desc(
            x_smem + (k >> 6) * N * kTRowBytes + (k & 63) * 2, 16,
            8 * kTRowBytes);
#pragma unroll
        for (int p = 0; p < P; ++p)
          wgmma_t(acc[p],
                  smem_desc(ring + stage * kStageBytes + p * kBox, kBox,
                            8 * kTRowBytes),
                  db);
        wgmma_commit();
        // the stage's products done before the stage is released and
        // before anything reads the accumulators (with a group left in
        // flight across stages, ptxas moved the epilogue's reads of the
        // last group's accumulators above its wait)
        wgmma_wait<0>();
#pragma unroll
        for (int p = 0; p < P; ++p) pin(acc[p]);
        if (lane == 0) mbar_arrive(empty + 8 * stage);
        if (++stage == a.stages) {
          stage = 0;
          phase ^= 1;
        }
      }

      // The panel's sums, each rounded once to bf16 into the workspace.
      // acc[p][4 j + 2 h + e] is vocab column 16 warp + g + 8 h of tile
      // pt + p, hidden row row0 + 8 j + 2 q + e. Each (tile, row)'s partial
      // (max, first argmax with NaN largest, all finite) is reduced without
      // branches: a value becomes its monotone key (-0 as +0, every NaN
      // above +inf) beside its column inverted, so one unsigned max keeps
      // the largest value and, among equal ones, the first column (what
      // beats() keeps); a thread's two columns, then the 8 lanes of a
      // quad's column by shuffles, then the 4 warps through shared memory,
      // every tile and row at once.
      unsigned best[P][N / 4];
      unsigned finite[(P * N / 4 + 31) / 32];
#pragma unroll
      for (int f = 0; f < (P * N / 4 + 31) / 32; ++f) finite[f] = ~0u;
#pragma unroll
      for (int p = 0; p < P; ++p)
#pragma unroll
        for (int r = 0; r < N / 4; ++r) {
          const int n = 8 * (r >> 1) + 2 * q + (r & 1), idx = p * (N / 4) + r;
          best[p][r] = 0u;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int m = 16 * warp + g + 8 * h, v = (pt + p) * kTile + m;
            const __nv_bfloat16 bf =
                __float2bfloat16_rn(acc[p][4 * (r >> 1) + 2 * h + (r & 1)]);
            unsigned b = __bfloat16_as_ushort(bf);
            if (p < np && v < a.vocab) {
              if (n < s_here)
                a.ws[static_cast<size_t>(row0 + n) * a.vocab + v] = bf;
              if ((b & 0x7f80u) == 0x7f80u)
                finite[idx >> 5] &= ~(1u << (idx & 31));
              b = b == 0x8000u ? 0u : b;
              unsigned key = (b & 0x8000u) ? (~b & 0xffffu) : (b | 0x8000u);
              key = (b & 0x7fffu) > 0x7f80u ? 0xffffu : key;
              best[p][r] = max(best[p][r], (key << 16) | (63u - m));
            }
          }
        }
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) {       // across g (lane bits 2..4)
#pragma unroll
        for (int p = 0; p < P; ++p)
#pragma unroll
          for (int r = 0; r < N / 4; ++r)
            best[p][r] = max(best[p][r],
                             __shfl_xor_sync(0xffffffffu, best[p][r], o));
#pragma unroll
        for (int f = 0; f < (P * N / 4 + 31) / 32; ++f)
          finite[f] &= __shfl_xor_sync(0xffffffffu, finite[f], o);
      }
      if (g == 0) {
#pragma unroll
        for (int p = 0; p < P; ++p)
#pragma unroll
          for (int r = 0; r < N / 4; ++r) {
            const int n = 8 * (r >> 1) + 2 * q + (r & 1), idx = p * (N / 4) + r;
            red_best[(p * N + n) * 4 + warp] = best[p][r];
            red_fin[(p * N + n) * 4 + warp] = (finite[idx >> 5] >> (idx & 31)) & 1u;
          }
      }
      consumer_sync();
      for (int k = tid; k < np * s_here; k += 128) {   // the warps
        const int p = k / s_here, n = k % s_here;
        unsigned bk = 0u, fk = 1u;
#pragma unroll
        for (int w = 0; w < 4; ++w) {
          bk = max(bk, red_best[(p * N + n) * 4 + w]);
          fk &= red_fin[(p * N + n) * 4 + w];
        }
        const unsigned key = bk >> 16;
        const unsigned bits = key == 0xffffu ? 0x7fc0u
                              : (key & 0x8000u) ? (key & 0x7fffu)
                                                : (~key & 0xffffu);
        const size_t o =
            static_cast<size_t>(row0 + n) * a.n_tiles + pt + p;
        a.pmax[o] = __uint_as_float(bits << 16);
        a.pidx[o] = (pt + p) * kTile + 63 - static_cast<int>(bk & 0xffffu);
        a.pok[o] = static_cast<int>(fk);
      }
      consumer_sync();                         // the partials are free
    }
    if (lane == 0) mbar_arrive(x_empty);       // every product of x issued
  }                                            // and waited for
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

// a row-major [rows, cols] bf16 matrix read in boxes of 64 columns x
// ``box_rows`` rows, 128-byte swizzled, zeros past the edges
int encode_2d(CUtensorMap* map, const void* ptr, int cols, int rows,
              int box_rows) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * 2};
  const cuuint32_t box[2] = {64, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                        const_cast<void*>(ptr), dims, strides, box, unit,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : 10000 + static_cast<int>(r);
}

template <int N, int P>
cudaError_t run_untied(const CUtensorMap& tw, const CUtensorMap& tx,
                       const UntiedArgs& a, int ctas, size_t smem,
                       cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(
      head_gemv_wgmma_kernel<N, P>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  head_gemv_wgmma_kernel<N, P><<<ctas, kTThreads, smem, st>>>(tw, tx, a);
  return cudaGetLastError();
}

template <int N>
cudaError_t run_panel(const CUtensorMap& tw, const CUtensorMap& tx,
                      const UntiedArgs& a, int panel, int ctas, size_t smem,
                      cudaStream_t st) {
  switch (panel) {
    case 4: return run_untied<N, 4>(tw, tx, a, ctas, smem, st);
    case 8: return run_untied<N, 8>(tw, tx, a, ctas, smem, st);
    case 16: return run_untied<N, 16>(tw, tx, a, ctas, smem, st);
    default: return cudaErrorInvalidValue;
  }
}

// The untied GEMV at ops.untied_plan's (rows, panel, ctas, a.stages).
int launch_untied(const void* x, const void* w, const UntiedArgs& a,
                  int rows, int panel, int ctas, cudaStream_t st) {
  if ((rows != 8 && rows != 16) || (panel != 4 && panel != 8 &&
      panel != 16) || ctas < 1 || ctas > a.n_tiles ||
      a.stages < 1 || a.stages > kMaxStages || a.d % 64 || a.s_rows < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = untied_smem(a.d, rows, panel, a.stages);
  if (smem > static_cast<size_t>(kSmemLimit))
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tw, tx;
  int err = encode_2d(&tw, w, a.vocab, a.d, kBK);
  if (err == 0) err = encode_2d(&tx, x, a.d, a.s_rows, rows);
  if (err != 0) return err;
  return static_cast<int>(rows == 8 ? run_panel<8>(tw, tx, a, panel, ctas,
                                                    smem, st)
                                     : run_panel<16>(tw, tx, a, panel, ctas,
                                                     smem, st));
}

// The greedy token (first argmax, NaN largest) and the all-finite probe of
// one row, from pass 1's per-CTA partials. Called by one whole CTA.
__device__ void greedy_and_probe(const float* pmax, const int* pidx,
                                 const int* pok, int n_blk, int row,
                                 sampling::Scratch& sc, float* wv, int* wi,
                                 int* greedy, int* finite) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float bv = 0.f;
  int bi = INT_MAX, fin = 1;
  for (int j = tid; j < n_blk; j += sampling::kThreads) {
    const size_t o = static_cast<size_t>(row) * n_blk + j;
    if (beats(bv, bi, pmax[o], pidx[o])) {
      bv = pmax[o];
      bi = pidx[o];
    }
    fin &= pok[o];
  }
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, bv, o);
    const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
    if (beats(bv, bi, ov, oi)) {
      bv = ov;
      bi = oi;
    }
  }
  if (lane == 0) {
    wv[warp] = bv;
    wi[warp] = bi;
  }
  fin = sampling::block_reduce(fin, sampling::MinOp(), sc.ired);
  if (tid == 0) {
    for (int k = 1; k < sampling::kWarps; ++k)
      if (beats(wv[0], wi[0], wv[k], wi[k])) {
        wv[0] = wv[k];
        wi[0] = wi[k];
      }
    *greedy = wi[0] == INT_MAX ? 0 : wi[0];
    *finite = fin;
  }
}

// Pass 2. Grid: one cluster of `size` CTAs of sampling::kThreads per hidden
// row. Rank 0 takes the greedy token and the probe from the partials; a
// sampled row (temperature > 0) is then split over the cluster: each CTA
// scales its tiles of the bf16 workspace row once into shared memory (x / t,
// as the plain version divides, held as monotone keys), and the filter's
// thresholds and the draw read them from there. Dynamic shared memory:
// sampling::cluster_smem_words.
__global__ void __launch_bounds__(sampling::kThreads, 1)
head_epilogue_kernel(const __nv_bfloat16* __restrict__ ws,
                     const float* __restrict__ pmax,
                     const int* __restrict__ pidx, const int* __restrict__ pok,
                     int n_blk, int vocab,
                     const long long* __restrict__ seeds,
                     const void* __restrict__ positions, int pos64,
                     const float* __restrict__ temps,
                     const int* __restrict__ top_k,
                     const float* __restrict__ top_p, int sampled,
                     int filtered, int* __restrict__ tokens,
                     bool* __restrict__ ok) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ sampling::Scratch sc;
  __shared__ sampling::ClusterShared sh;
  __shared__ float wv[sampling::kWarps];
  __shared__ int wi[sampling::kWarps];
  __shared__ int head[2];                    // greedy token, probe
  cg::cluster_group cluster = cg::this_cluster();
  const int size = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int row = blockIdx.x / size, tid = threadIdx.x;
  const float temp = temps[row];
  const bool draw = sampled && temp > 0.f;
  if (rank == 0) {
    greedy_and_probe(pmax, pidx, pok, n_blk, row, sc, wv, wi, &head[0],
                     &head[1]);
    if (tid == 0) {
      ok[row] = head[1] != 0;
      if (!draw) tokens[row] = head[0];
    }
  }
  if (!draw) return;                         // the same for the whole cluster

  sampling::ClusterRow crow(vocab, size, rank, smem, sh, sc);
  const __nv_bfloat16* lw = ws + static_cast<size_t>(row) * vocab;
  crow.load([&](int i) { return __fdiv_rn(__bfloat162float(lw[i]), temp); });
  float kth = -INFINITY, th = -INFINITY;
  if (filtered)
    sampling::cluster_thresholds(crow, top_k[row], top_p[row], &kth, &th);
  // keys[] hold the (top-k-masked) scaled logits; top-p masks on the fly
  auto final_logits = [&](int lt, int q) {
    const uint4 k =
        reinterpret_cast<const uint4*>(crow.keys + lt * sampling::kStride)[q];
    const float v[4] = {sampling::key_to_float(k.x),
                        sampling::key_to_float(k.y),
                        sampling::key_to_float(k.z),
                        sampling::key_to_float(k.w)};
    return make_float4(v[0] < th ? -INFINITY : v[0],
                       v[1] < th ? -INFINITY : v[1],
                       v[2] < th ? -INFINITY : v[2],
                       v[3] < th ? -INFINITY : v[3]);
  };
  const int tok = sampling::draw_index(
      final_logits, crow, sampling::own_max(final_logits, crow),
      static_cast<unsigned>(seeds[row]),
      sampling::position_word(positions, pos64, row));
  if (rank == 0 && tid == 0) tokens[row] = tok;
}

}  // namespace

static int launch_head(bool untied, const void* x, const void* w,
                       const void* seeds, const void* positions,
                       const void* temps, const void* top_k,
                       const void* top_p, void* ws, void* scratch,
                       void* tokens, void* ok, int s_rows, int d, int vocab,
                       int pos64, int sampled, int filtered, int size,
                       const int* plan, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (size < 1 || size > sampling::kMaxCluster)
    return static_cast<int>(cudaErrorInvalidValue);
  // partials: one block a CTA's 128 vocab rows (tied), a 64-column tile
  // (untied)
  const int blk = untied ? kTile : kRowsPerCta;
  const int n_blk = (vocab + blk - 1) / blk;
  float* pmax = static_cast<float*>(scratch);
  int* pidx = static_cast<int*>(scratch) + static_cast<size_t>(s_rows) * n_blk;
  int* pok = pidx + static_cast<size_t>(s_rows) * n_blk;

  cudaError_t err;
  if (untied) {
    const UntiedArgs a{static_cast<__nv_bfloat16*>(ws), pmax, pidx, pok,
                       s_rows, d, vocab, n_blk, plan[3]};
    const int e = launch_untied(x, w, a, plan[0], plan[1], plan[2], st);
    if (e != 0) return e;
  } else {
    const int n_grp = (s_rows + kGroupRows - 1) / kGroupRows;
    if (n_blk > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
    const size_t smem1 = static_cast<size_t>(kGroupRows) * (d + kXPad) *
                         sizeof(__nv_bfloat16);
    err = cudaFuncSetAttribute(head_gemv_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem1));
    if (err != cudaSuccess) return static_cast<int>(err);
    head_gemv_kernel<<<dim3(n_grp, n_blk), kGemvThreads, smem1, st>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(w), s_rows, d, vocab, n_blk,
        static_cast<__nv_bfloat16*>(ws), pmax, pidx, pok);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }

  const size_t smem2 =
      sampled ? sampling::cluster_smem_words(vocab, size) * 4 : 0;
  err = cudaFuncSetAttribute(head_epilogue_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem2));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(head_epilogue_kernel,
                             cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = size;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(s_rows * size, 1, 1);
  cfg.blockDim = dim3(sampling::kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem2;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(
      &cfg, head_epilogue_kernel, static_cast<const __nv_bfloat16*>(ws),
      static_cast<const float*>(pmax), static_cast<const int*>(pidx),
      static_cast<const int*>(pok), n_blk, vocab,
      static_cast<const long long*>(seeds), positions, pos64,
      static_cast<const float*>(temps),
      static_cast<const int*>(top_k), static_cast<const float*>(top_p),
      sampled, filtered, static_cast<int*>(tokens), static_cast<bool*>(ok));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// x [s_rows, d] bf16; w bf16, [vocab, d] (head_tokens: the tied embedding)
// or [d, vocab] (head_tokens_untied: an untied head); seeds int64 [s_rows]
// (uint32 values), positions [s_rows] int32 (pos64 = 0) or int64 (pos64 =
// 1); temps, top_p float32 [s_rows]; top_k int32 [s_rows]; ws bf16
// [s_rows, vocab] and scratch int32 [3, s_rows, n_blk] are the wrapper's
// workspace (n_blk = ceil(vocab / 128) tied, ceil(vocab / 64) untied);
// tokens int32 and ok bool [s_rows]; pass 2 runs `size` CTAs a row
// (ops.cluster_plan, 1 to 16; 1 for a step with no sampled row, which
// needs no row in shared memory). Needs s_rows >= 1, d % 64 == 0, vocab %
// 16 == 0, 16-byte aligned x and w, and (tied) ceil(vocab / 128) <= 65535
// (the grid's y extent).
extern "C" int head_tokens(const void* x, const void* w, const void* seeds,
                           const void* positions, const void* temps,
                           const void* top_k, const void* top_p, void* ws,
                           void* scratch, void* tokens, void* ok, int s_rows,
                           int d, int vocab, int pos64, int sampled,
                           int filtered, int size, void* stream) {
  return launch_head(false, x, w, seeds, positions, temps, top_k, top_p, ws,
                     scratch, tokens, ok, s_rows, d, vocab, pos64, sampled,
                     filtered, size, nullptr, stream);
}

// The same for an untied head, its GEMV at ops.untied_plan's hidden rows a
// group (8 or 16), tiles a panel (4, 8 or 16), CTAs and ring stages. x's
// group is held whole in shared memory beside at least 4 stages, so d is
// at most 12352 (untied_plan raises above it).
extern "C" int head_tokens_untied(const void* x, const void* w,
                                  const void* seeds, const void* positions,
                                  const void* temps, const void* top_k,
                                  const void* top_p, void* ws, void* scratch,
                                  void* tokens, void* ok, int s_rows, int d,
                                  int vocab, int pos64, int sampled,
                                  int filtered, int size, int rows, int panel,
                                  int ctas, int stages, void* stream) {
  const int plan[4] = {rows, panel, ctas, stages};
  return launch_head(true, x, w, seeds, positions, temps, top_k, top_p, ws,
                     scratch, tokens, ok, s_rows, d, vocab, pos64, sampled,
                     filtered, size, plan, stream);
}
