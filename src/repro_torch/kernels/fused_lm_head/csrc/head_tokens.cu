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
//      head_gemv_t_kernel, a CUDA-core GEMV that reads W in place (a
//      transposed copy would be a second 0.42 GB at deepseek-moe-16b's
//      2048 x 102400): each CTA takes 128 vocab columns and one group of up
//      to 8 hidden rows; a thread owns 8 contiguous columns (one 16-byte
//      load a K row) of one of 16 interleaved K slices, and keeps 8 x 8
//      fp32 sums (FMA, K ascending); the slices are summed in a fixed order
//      (the two halves of a warp by one shuffle, then the 8 warps through
//      shared memory in warp order), so the bits are the same every call.
//      Its 2 S D V operations (3.4 GFLOP at S = 8 and that shape) take
//      0.05 ms at the CUDA cores' fp32 peak, under the 0.125 ms the bytes
//      take. It writes the same workspace and partials as the tied pass.
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
#include <cuda_bf16.h>
#include <cuda_runtime.h>

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

constexpr int kTCols = 8;                            // vocab columns a thread
constexpr int kTLanes = kRowsPerCta / kTCols;        // 16 threads a K row
constexpr int kTSlices = kGemvThreads / kTLanes;     // 16 K slices
constexpr int kTUnroll = 4;                          // K rows in flight

__device__ __forceinline__ void bf16x8(const uint4& v, float (&f)[8]) {
  const unsigned u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(u[i] << 16);
    f[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
  }
}

// Pass 1 of an untied head W [d, vocab]. Grid: (hidden row group of
// kGroupRows, 128 vocab columns). Dynamic shared memory: x transposed as d
// rows of kGroupRows bf16 (rows past s_rows zero), reused after the K loop
// for the 8 warps' sums, [warp][hidden row][128 columns] fp32.
__global__ void __launch_bounds__(kGemvThreads, 2)
head_gemv_t_kernel(const __nv_bfloat16* __restrict__ x,
                   const __nv_bfloat16* __restrict__ w, int s_rows, int d,
                   int vocab, int n_blk, __nv_bfloat16* __restrict__ ws,
                   float* __restrict__ pmax, int* __restrict__ pidx,
                   int* __restrict__ pok) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  float* red = reinterpret_cast<float*>(smem_raw);
  const int s0 = blockIdx.x * kGroupRows, blk = blockIdx.y;
  const int s_here = min(kGroupRows, s_rows - s0);
  const int tid = threadIdx.x, vec_per_row = d / 8;
  for (int i = tid; i < kGroupRows * vec_per_row; i += kGemvThreads) {
    const int r = i / vec_per_row, c = (i % vec_per_row) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r < s_here)
      v = *reinterpret_cast<const uint4*>(
          x + static_cast<size_t>(s0 + r) * d + c);
    const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&v);
#pragma unroll
    for (int j = 0; j < 8; ++j) xs[(c + j) * kGroupRows + r] = e[j];
  }
  __syncthreads();

  const int lane = tid % kTLanes, slice = tid / kTLanes;
  const int col = blk * kRowsPerCta + lane * kTCols;
  const bool active = col < vocab;           // vocab % 8 == 0
  float acc[kGroupRows][kTCols];
#pragma unroll
  for (int r = 0; r < kGroupRows; ++r)
#pragma unroll
    for (int c = 0; c < kTCols; ++c) acc[r][c] = 0.f;
  if (active) {
    const __nv_bfloat16* wp = w + static_cast<size_t>(slice) * vocab + col;
    const size_t step = static_cast<size_t>(kTSlices) * vocab;
    const uint4* x4 = reinterpret_cast<const uint4*>(xs);
    for (int k0 = slice; k0 < d; k0 += kTSlices * kTUnroll) {
      uint4 wv[kTUnroll];
#pragma unroll
      for (int u = 0; u < kTUnroll; ++u)
        wv[u] = __ldg(reinterpret_cast<const uint4*>(wp + u * step));
      wp += kTUnroll * step;
#pragma unroll
      for (int u = 0; u < kTUnroll; ++u) {
        float wf[8], xf[8];
        bf16x8(wv[u], wf);
        bf16x8(x4[k0 + u * kTSlices], xf);
#pragma unroll
        for (int r = 0; r < kGroupRows; ++r)
#pragma unroll
          for (int c = 0; c < kTCols; ++c)
            acc[r][c] = fmaf(xf[r], wf[c], acc[r][c]);
      }
    }
  }
  // the two K slices of a warp, then the warps in order
#pragma unroll
  for (int r = 0; r < kGroupRows; ++r)
#pragma unroll
    for (int c = 0; c < kTCols; ++c)
      acc[r][c] += __shfl_xor_sync(0xffffffffu, acc[r][c], 16);
  __syncthreads();                           // xs is dead: reuse as red
  const int warp = tid >> 5;
  if ((tid & 31) < kTLanes) {
#pragma unroll
    for (int r = 0; r < kGroupRows; ++r) {
      float4* dst = reinterpret_cast<float4*>(
          red + (warp * kGroupRows + r) * kRowsPerCta + lane * kTCols);
      dst[0] = make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
      dst[1] = make_float4(acc[r][4], acc[r][5], acc[r][6], acc[r][7]);
    }
  }
  __syncthreads();
  // warp r finishes hidden row r: 4 columns a lane
  const int r = warp, q = (tid & 31) * 4, v = blk * kRowsPerCta + q;
  float4 sum = reinterpret_cast<const float4*>(red + r * kRowsPerCta + q)[0];
  for (int k = 1; k < kGemvWarps; ++k) {
    const float4 o = reinterpret_cast<const float4*>(
        red + (k * kGroupRows + r) * kRowsPerCta + q)[0];
    sum.x += o.x;
    sum.y += o.y;
    sum.z += o.z;
    sum.w += o.w;
  }
  const float sums[4] = {sum.x, sum.y, sum.z, sum.w};
  float bv = 0.f;
  int bi = INT_MAX, fin = 1;
  if (v < vocab) {
    __nv_bfloat16 b[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      b[j] = __float2bfloat16_rn(sums[j]);
      const float f = __bfloat162float(b[j]);
      if (beats(bv, bi, f, v + j)) {
        bv = f;
        bi = v + j;
      }
      fin &= isfinite(f) ? 1 : 0;
    }
    if (r < s_here) {
      __nv_bfloat162* dst = reinterpret_cast<__nv_bfloat162*>(
          ws + static_cast<size_t>(s0 + r) * vocab + v);
      dst[0] = __halves2bfloat162(b[0], b[1]);
      dst[1] = __halves2bfloat162(b[2], b[3]);
    }
  }
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, bv, o);
    const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
    fin &= __shfl_xor_sync(0xffffffffu, fin, o);
    if (beats(bv, bi, ov, oi)) {
      bv = ov;
      bi = oi;
    }
  }
  if ((tid & 31) == 0 && r < s_here) {
    const size_t o = static_cast<size_t>(s0 + r) * n_blk + blk;
    pmax[o] = bv;
    pidx[o] = bi;
    pok[o] = fin;
  }
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
                       void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (size < 1 || size > sampling::kMaxCluster)
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_blk = (vocab + kRowsPerCta - 1) / kRowsPerCta;
  float* pmax = static_cast<float*>(scratch);
  int* pidx = static_cast<int*>(scratch) + static_cast<size_t>(s_rows) * n_blk;
  int* pok = pidx + static_cast<size_t>(s_rows) * n_blk;

  const int n_grp = (s_rows + kGroupRows - 1) / kGroupRows;
  if (n_blk > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
  const size_t x_t = static_cast<size_t>(d) * kGroupRows *
                     sizeof(__nv_bfloat16);
  const size_t sums = static_cast<size_t>(kGemvWarps) * kGroupRows *
                      kRowsPerCta * sizeof(float);
  const size_t smem1 =
      untied ? (x_t > sums ? x_t : sums)
             : static_cast<size_t>(kGroupRows) * (d + kXPad) *
                   sizeof(__nv_bfloat16);
  const auto gemv = untied ? head_gemv_t_kernel : head_gemv_kernel;
  cudaError_t err = cudaFuncSetAttribute(
      gemv, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem1));
  if (err != cudaSuccess) return static_cast<int>(err);
  gemv<<<dim3(n_grp, n_blk), kGemvThreads, smem1, st>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(w), s_rows, d, vocab, n_blk,
      static_cast<__nv_bfloat16*>(ws), pmax, pidx, pok);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

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
// [s_rows, vocab] and scratch int32 [3, s_rows, ceil(vocab / 128)] are the
// wrapper's workspace; tokens int32 and ok bool [s_rows]; pass 2 runs
// `size` CTAs a row (ops.cluster_plan, 1 to 16; 1 for a step with no
// sampled row, which needs no row in shared memory). Needs s_rows >= 1,
// d % 64 == 0, vocab % 16 == 0 and ceil(vocab / 128) <= 65535 (the grid's
// y extent).
extern "C" int head_tokens(const void* x, const void* w, const void* seeds,
                           const void* positions, const void* temps,
                           const void* top_k, const void* top_p, void* ws,
                           void* scratch, void* tokens, void* ok, int s_rows,
                           int d, int vocab, int pos64, int sampled,
                           int filtered, int size, void* stream) {
  return launch_head(false, x, w, seeds, positions, temps, top_k, top_p, ws,
                     scratch, tokens, ok, s_rows, d, vocab, pos64, sampled,
                     filtered, size, stream);
}

extern "C" int head_tokens_untied(const void* x, const void* w,
                                  const void* seeds, const void* positions,
                                  const void* temps, const void* top_k,
                                  const void* top_p, void* ws, void* scratch,
                                  void* tokens, void* ok, int s_rows, int d,
                                  int vocab, int pos64, int sampled,
                                  int filtered, int size, void* stream) {
  return launch_head(true, x, w, seeds, positions, temps, top_k, top_p, ws,
                     scratch, tokens, ok, s_rows, d, vocab, pos64, sampled,
                     filtered, size, stream);
}
