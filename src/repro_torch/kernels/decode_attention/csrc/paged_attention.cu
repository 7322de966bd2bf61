// Paged GQA attention for Hopper (sm_90a): single-query decode and one
// chunk of chunked prefill, both reading K/V through a page table.
//
// Replaces the TPU kernels of src/repro/kernels/decode_attention/kernel.py:
//   paged_decode_attention_fwd  (kernel.py:164, pallas_call at :181)
//   paged_prefill_attention_fwd (kernel.py:113, pallas_call at :138)
//
// What bounds it on this card: bytes. Each (sequence, KV head) has to read
// its K and V rows once, and does G = Hq/Hkv (3 for llama3.2-3b) dot products
// and axpys per element read, far below the ~295 flop/byte at which an H100
// stops being memory-bound. Decode at 8 slots x 576 tokens must move
// 8 * 576 * 8 heads * 128 * 2 (K and V) * 2 B = 18.9 MB per layer: 5.6 us at
// 3.35 TB/s.
//
// What the design does about it: one CTA of kWarps warps per (query row,
// KV head): per (slot, KV head) for decode, per (chunk row, KV head) for
// prefill. The CTA's G query heads of the row share every K/V row it loads.
// The visible columns of the row (col <= its position, col < total) are cut
// into groups of kGroup tokens dealt round-robin to the warps; a warp looks
// up each token's page id in the page table itself (this replaces the Pallas
// kernel's scalar-prefetched page grid axis) and issues the group's K and V
// loads together, each lane reading D/32 contiguous elements of a row, so
// 2 * kGroup row loads are in flight per warp. Scores are reduced across the
// warp with shuffles and folded into per-warp fp32 online-softmax state
// (m, l, acc in registers); the warps' states are merged once through shared
// memory at the end (the flash-decoding combine, inside one CTA). Columns
// past the visible length are never loaded, so work tracks the real length.
// Known limits, left for later work: 8 slots x 8 KV heads make only 64
// decode CTAs on 132 SMs (no split of one row across CTAs), the prefill
// re-reads a chunk's K/V once per row (from L2), and no tensor cores
// (wgmma) or TMA are used.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// One instantiation: the head dim and GQA group of the configs the port
// serves (llama3.2-3b: D = 128, G = 3). The wrapper rejects the rest.
constexpr int D = 128;
constexpr int DPL = D / 32;         // elements of a row per lane
constexpr int MAXQ = 4;             // query heads per KV head, at most
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kGroup = 8;           // tokens per warp step
constexpr float kNegInf = -1e30f;

// DPL contiguous bf16 of one row for this lane, widened to fp32.
struct Chunk {
  __nv_bfloat162 h[DPL / 2];
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    *reinterpret_cast<uint2*>(h) = *reinterpret_cast<const uint2*>(p);
  }
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < DPL / 2; ++i) h[i] = __float2bfloat162_rn(0.f);
  }
  __device__ __forceinline__ float at(int i) const {
    const float2 f = __bfloat1622float2(h[i / 2]);
    return (i & 1) ? f.y : f.x;
  }
};

// Attention of the g query heads of one row over the visible columns of KV
// head h. q / out point at the row's head h * g; the row sees columns
// col < n_tok (its position + 1, clipped at the valid length).
__device__ void attend_row(const __nv_bfloat16* __restrict__ q,
                           __nv_bfloat16* __restrict__ out, int g,
                           const __nv_bfloat16* __restrict__ kp,
                           const __nv_bfloat16* __restrict__ vp,
                           const int* __restrict__ pages, int page_size,
                           int hkv, int h, int n_tok, float scale) {
  __shared__ float sm_m[kWarps][MAXQ];
  __shared__ float sm_l[kWarps][MAXQ];
  __shared__ float sm_acc[kWarps][MAXQ][D];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  float qr[MAXQ][DPL], acc[MAXQ][DPL], m[MAXQ], l[MAXQ];
#pragma unroll
  for (int r = 0; r < MAXQ; ++r) {
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      qr[r][i] = r < g ? __bfloat162float(q[r * D + lane * DPL + i]) * scale
                       : 0.f;
      acc[r][i] = 0.f;
    }
    m[r] = kNegInf;
    l[r] = 0.f;
  }

  const size_t tok_stride = static_cast<size_t>(hkv) * D;
  const size_t head_off = static_cast<size_t>(h) * D + lane * DPL;
  for (int t0 = warp * kGroup; t0 < n_tok; t0 += kWarps * kGroup) {
    Chunk kc[kGroup], vc[kGroup];
#pragma unroll
    for (int t = 0; t < kGroup; ++t) {
      const int col = t0 + t;
      if (col < n_tok) {
        const size_t row = static_cast<size_t>(pages[col / page_size]) *
                               page_size + col % page_size;
        kc[t].load(kp + row * tok_stride + head_off);
        vc[t].load(vp + row * tok_stride + head_off);
      } else {
        kc[t].zero();
        vc[t].zero();
      }
    }
#pragma unroll
    for (int r = 0; r < MAXQ; ++r) {
      if (r >= g) break;
      float s[kGroup];
#pragma unroll
      for (int t = 0; t < kGroup; ++t) {
        float dot = 0.f;
#pragma unroll
        for (int i = 0; i < DPL; ++i) dot += qr[r][i] * kc[t].at(i);
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          dot += __shfl_xor_sync(0xffffffffu, dot, o);
        s[t] = t0 + t < n_tok ? dot : kNegInf;
      }
      float mx = kNegInf;
#pragma unroll
      for (int t = 0; t < kGroup; ++t) mx = fmaxf(mx, s[t]);
      const float m_new = fmaxf(m[r], mx);
      const float a = expf(m[r] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int t = 0; t < kGroup; ++t) {
        s[t] = expf(s[t] - m_new);
        sum += s[t];
      }
      l[r] = l[r] * a + sum;
      m[r] = m_new;
#pragma unroll
      for (int i = 0; i < DPL; ++i) {
        float v = acc[r][i] * a;
#pragma unroll
        for (int t = 0; t < kGroup; ++t) v += s[t] * vc[t].at(i);
        acc[r][i] = v;
      }
    }
  }

  // merge the warps' online-softmax states (a warp without columns carries
  // m = -1e30, l = 0, acc = 0 and drops out with weight exp(-1e30 - M) = 0)
#pragma unroll
  for (int r = 0; r < MAXQ; ++r) {
    if (lane == 0) {
      sm_m[warp][r] = m[r];
      sm_l[warp][r] = l[r];
    }
#pragma unroll
    for (int i = 0; i < DPL; ++i) sm_acc[warp][r][lane * DPL + i] = acc[r][i];
  }
  __syncthreads();
  for (int e = threadIdx.x; e < g * D; e += kThreads) {
    const int r = e / D, d = e % D;
    float mm = kNegInf;
    for (int w = 0; w < kWarps; ++w) mm = fmaxf(mm, sm_m[w][r]);
    float ll = 0.f, o = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      const float wt = expf(sm_m[w][r] - mm);
      ll += sm_l[w][r] * wt;
      o += sm_acc[w][r][d] * wt;
    }
    out[r * D + d] = __float2bfloat16(o / fmaxf(ll, 1e-30f));
  }
}

__global__ void __launch_bounds__(kThreads)
decode_kernel(const __nv_bfloat16* __restrict__ q,
              const __nv_bfloat16* __restrict__ kp,
              const __nv_bfloat16* __restrict__ vp,
              const int* __restrict__ page_table,
              const int* __restrict__ seq_lens,
              __nv_bfloat16* __restrict__ out, int hq, int hkv,
              int page_size, int max_pages, float scale) {
  const int b = blockIdx.x, h = blockIdx.y, g = hq / hkv;
  const int n_tok = min(seq_lens[b], max_pages * page_size);
  const size_t off = (static_cast<size_t>(b) * hq + h * g) * D;
  attend_row(q + off, out + off, g, kp, vp,
             page_table + static_cast<size_t>(b) * max_pages,
             page_size, hkv, h, max(n_tok, 0), scale);
}

__global__ void __launch_bounds__(kThreads)
prefill_kernel(const __nv_bfloat16* __restrict__ q,
               const __nv_bfloat16* __restrict__ kp,
               const __nv_bfloat16* __restrict__ vp,
               const int* __restrict__ page_row,
               __nv_bfloat16* __restrict__ out, int hq, int hkv,
               int page_size, int max_pages, int start, int total,
               float scale) {
  const int row = blockIdx.x, h = blockIdx.y, g = hq / hkv;
  // causal from the row's position start + row, clipped at the valid length
  const int n_tok = min(min(start + row + 1, total), max_pages * page_size);
  const size_t off = (static_cast<size_t>(row) * hq + h * g) * D;
  attend_row(q + off, out + off, g, kp, vp, page_row, page_size, hkv, h,
             max(n_tok, 0), scale);
}

int launch(bool decode, const void* q, const void* kp, const void* vp,
           const void* pages, const void* seq_lens, void* out, int rows,
           int hq, int hkv, int d, int page_size, int max_pages, int start,
           int total, void* stream) {
  if (d != D || hq % hkv || hq / hkv > MAXQ)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(rows, hkv);
  const float scale = static_cast<float>(1.0 / sqrt(static_cast<double>(D)));
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* qb = static_cast<const __nv_bfloat16*>(q);
  const auto* kb = static_cast<const __nv_bfloat16*>(kp);
  const auto* vb = static_cast<const __nv_bfloat16*>(vp);
  auto* ob = static_cast<__nv_bfloat16*>(out);
  if (decode) {
    decode_kernel<<<grid, kThreads, 0, s>>>(
        qb, kb, vb, static_cast<const int*>(pages),
        static_cast<const int*>(seq_lens), ob, hq, hkv, page_size, max_pages,
        scale);
  } else {
    prefill_kernel<<<grid, kThreads, 0, s>>>(
        qb, kb, vb, static_cast<const int*>(pages), ob, hq, hkv, page_size,
        max_pages, start, total, scale);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int paged_decode_attention(const void* q, const void* k_pages,
                                      const void* v_pages,
                                      const void* page_table,
                                      const void* seq_lens, void* out, int b,
                                      int hq, int hkv, int d, int page_size,
                                      int max_pages, void* stream) {
  return launch(true, q, k_pages, v_pages, page_table, seq_lens, out, b, hq,
                hkv, d, page_size, max_pages, 0, 0, stream);
}

extern "C" int paged_prefill_attention(const void* q, const void* k_pages,
                                       const void* v_pages,
                                       const void* page_row, void* out, int c,
                                       int hq, int hkv, int d, int page_size,
                                       int max_pages, int start, int total,
                                       void* stream) {
  return launch(false, q, k_pages, v_pages, page_row, nullptr, out, c, hq,
                hkv, d, page_size, max_pages, start, total, stream);
}
