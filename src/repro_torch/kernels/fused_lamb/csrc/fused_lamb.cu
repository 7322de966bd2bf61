// Fused LAMB (the paper's Fig. 3) for Hopper (sm_90a), one leaf a call:
//   stage 1: (w, g, m, v) -> m' = b1 m + (1 - b1) g*ginv,
//            v' = b2 v + (1 - b2) (g*ginv)^2,
//            u = (m' c1) / (sqrt(v' c2) + eps) + wd w,
//            and per-CTA partial sums of w^2 and u^2;
//   stage 2: r = ||w|| / ||u|| over each row, w' = w - (lr r) u.
// w, m, v fp32 (updated in place), g fp32 or bf16 (read in its own dtype,
// upcast in registers), u an fp32 workspace.
//
// Replaces the TPU kernels src/repro/kernels/fused_lamb/kernel.py:49
// lamb_stage1 (pallas_call at :61) and kernel.py:78 lamb_stage2 (pallas_call
// at :84). The plain version is repro_torch/kernels/fused_lamb/ref.py
// lamb_stage12. Unlike the Pallas path (fused_lamb/ops.py, which reduces per
// last-axis row), the trust ratio is one per layer, as Fig. 3 and
// repro/optim/lamb.py reduce it (its _layer_axes):
//   - a leaf is a layer, one row;
//   - a MoE expert leaf [E, ...] is E rows, a ratio each: blockIdx.y is the
//     row, each row's CTAs write their own partials;
//   - leaves that share their ratios (whisper's encoder layers, which JAX
//     stacks into one leaf) write their partials into one buffer at their
//     own offsets, and each leaf's stage 2 reduces the whole buffer; a lone
//     leaf is a group of one.
// Row r's partials are part[r * nparts + i] (w^2) and part[rows * nparts +
// r * nparts + i] (u^2), i < nparts, nparts the CTAs a row of every leaf
// of the group; stage 1 of a leaf gets part at its own offset.
//
// What bounds it on this card: bytes. Stage 1 reads w, m, v (fp32) and g
// (bf16 under master weights) and writes m, v, u: 26 bytes an element;
// stage 2 reads w and u and writes w: 12 bytes. For bert-large's 335,213,568
// parameters that is about 12.7 GB, 3.8 ms at 3.35 TB/s, against about 20
// operations an element. What the design does about it:
//   - each array moves once a stage, 16-byte loads for fp32 (8 for bf16 g),
//     the ragged tail (n % 4) masked in the kernel instead of padding;
//   - the TPU grid carries its partial norms in order across tiles; CTAs run
//     in no order here, so stage 1 has a fixed grid (at most 4 CTAs an SM,
//     grid-stride beyond) and each CTA writes its own pair of partials;
//   - stage 2 reduces those partials itself, every CTA of a row in the same
//     fixed order (so every CTA holds the same r), and CTA 0 writes r out:
//     no launch and no host read stand between the stages, so a step's
//     leaves queue their launches without a sync.
// Indices: a leaf has fewer than 2^31 elements (the wrapper checks), so
// every element index fits an int; llama3.2-3b's tied embedding, 394 M
// elements, is the largest leaf the trainer gives it.
// Numerics: every operation rounds once (no fused multiply-adds), in the
// plain version's order, so m', v' and u equal PyTorch's elementwise result;
// the norms are summed in this kernel's fixed order (each thread in index
// order, an xor butterfly in each warp, warp sums in warp order), so r may
// differ from the plain version's torch.sum in the last bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// Fixed-order block sum of two values; the result is valid in every thread.
__device__ void block_sum2(float& a, float& b, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int o = 16; o > 0; o >>= 1) {
    a = __fadd_rn(a, __shfl_xor_sync(0xffffffffu, a, o));
    b = __fadd_rn(b, __shfl_xor_sync(0xffffffffu, b, o));
  }
  if (lane == 0) {
    red[warp] = a;
    red[kWarps + warp] = b;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float sa = 0.f, sb = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      sa = __fadd_rn(sa, red[w]);
      sb = __fadd_rn(sb, red[kWarps + w]);
    }
    red[2 * kWarps] = sa;
    red[2 * kWarps + 1] = sb;
  }
  __syncthreads();
  a = red[2 * kWarps];
  b = red[2 * kWarps + 1];
}

__device__ __forceinline__ void load4(const float* p, float* o) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
}

__device__ __forceinline__ void load4(const bf16* p, float* o) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
  const float2 a = __bfloat1622float2(h2[0]);
  const float2 b = __bfloat1622float2(h2[1]);
  o[0] = a.x; o[1] = a.y; o[2] = b.x; o[3] = b.y;
}

__device__ __forceinline__ void store4(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

struct Hyper {
  float b1, omb1, b2, omb2, eps, wd;
};

// One element of stage 1; returns u and accumulates w^2 and u^2 in order.
__device__ __forceinline__ float stage1_elem(float w, float g, float& m,
                                             float& v, float ginv, float c1,
                                             float c2, const Hyper& h,
                                             float& wsq, float& usq) {
  const float gn = __fmul_rn(g, ginv);
  m = __fadd_rn(__fmul_rn(h.b1, m), __fmul_rn(h.omb1, gn));
  v = __fadd_rn(__fmul_rn(h.b2, v), __fmul_rn(h.omb2, __fmul_rn(gn, gn)));
  const float den = __fadd_rn(__fsqrt_rn(__fmul_rn(v, c2)), h.eps);
  const float u = __fadd_rn(__fdiv_rn(__fmul_rn(m, c1), den),
                            __fmul_rn(h.wd, w));
  wsq = __fadd_rn(wsq, __fmul_rn(w, w));
  usq = __fadd_rn(usq, __fmul_rn(u, u));
  return u;
}

template <typename TG>
__global__ void __launch_bounds__(kThreads)
stage1_kernel(const float* __restrict__ w, const TG* __restrict__ g,
              float* __restrict__ m, float* __restrict__ v,
              const float* __restrict__ scal, float* __restrict__ u,
              float* __restrict__ part, int n, int nparts, Hyper h) {
  __shared__ float red[2 * kWarps + 2];
  const float ginv = scal[0], c1 = scal[1], c2 = scal[2];
  const int base = blockIdx.y * n;       // this row's first element
  w += base; g += base; m += base; v += base; u += base;
  part += blockIdx.y * nparts;
  const int n4 = n / 4;
  const int stride = gridDim.x * kThreads;
  float wsq = 0.f, usq = 0.f;
  for (int q = blockIdx.x * kThreads + threadIdx.x; q < n4; q += stride) {
    const int e = 4 * q;
    float wv[4], gv[4], mv[4], vv[4], uv[4];
    load4(w + e, wv);
    load4(g + e, gv);
    load4(m + e, mv);
    load4(v + e, vv);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      uv[j] = stage1_elem(wv[j], gv[j], mv[j], vv[j], ginv, c1, c2, h, wsq,
                          usq);
    store4(m + e, mv);
    store4(v + e, vv);
    store4(u + e, uv);
  }
  // ragged tail: the last n % 4 elements, one each to CTA 0's first threads
  const int t = 4 * n4 + threadIdx.x;
  if (blockIdx.x == 0 && t < n) {
    float mt = m[t], vt = v[t];
    u[t] = stage1_elem(w[t], to_f(g[t]), mt, vt, ginv, c1, c2, h, wsq, usq);
    m[t] = mt;
    v[t] = vt;
  }
  block_sum2(wsq, usq, red);
  if (threadIdx.x == 0) {
    part[blockIdx.x] = wsq;
    part[gridDim.y * nparts + blockIdx.x] = usq;
  }
}

__global__ void __launch_bounds__(kThreads)
stage2_kernel(float* __restrict__ w, const float* __restrict__ u,
              const float* __restrict__ part, float* __restrict__ r_out,
              int n, int nparts, float lr) {
  __shared__ float red[2 * kWarps + 2];
  const int base = blockIdx.y * n;
  w += base; u += base;
  part += blockIdx.y * nparts;
  float wsq = 0.f, usq = 0.f;
  for (int i = threadIdx.x; i < nparts; i += kThreads) {
    wsq = __fadd_rn(wsq, part[i]);
    usq = __fadd_rn(usq, part[gridDim.y * nparts + i]);
  }
  block_sum2(wsq, usq, red);
  const float wn = __fsqrt_rn(wsq), un = __fsqrt_rn(usq);
  const float r = (wn > 0.f && un > 0.f) ? __fdiv_rn(wn, fmaxf(un, 1e-30f))
                                         : 1.0f;
  if (blockIdx.x == 0 && threadIdx.x == 0) r_out[blockIdx.y] = r;
  const float step = __fmul_rn(lr, r);
  const int n4 = n / 4;
  const int stride = gridDim.x * kThreads;
  for (int q = blockIdx.x * kThreads + threadIdx.x; q < n4; q += stride) {
    const int e = 4 * q;
    float wv[4], uv[4];
    load4(w + e, wv);
    load4(u + e, uv);
#pragma unroll
    for (int j = 0; j < 4; ++j) wv[j] = __fsub_rn(wv[j], __fmul_rn(step, uv[j]));
    store4(w + e, wv);
  }
  const int t = 4 * n4 + threadIdx.x;
  if (blockIdx.x == 0 && t < n) w[t] = __fsub_rn(w[t], __fmul_rn(step, u[t]));
}

}  // namespace

// w, m, v, u fp32 [rows * n]; g [rows * n] fp32 (g_f32 = 1) or bf16
// (g_f32 = 0); scal fp32 [3] = (ginv, c1, c2); part fp32 at this leaf's
// offset in its group's buffer, row r's CTA b writing part[r * nparts + b]
// and part[rows * nparts + r * nparts + b]. m and v are updated in place. A
// row of more than 3 elements starts 16-byte aligned (the wrapper checks
// n % 4 == 0 where rows > 1).
extern "C" int lamb_stage1(const void* w, const void* g, void* m, void* v,
                           const void* scal, void* u, void* part, int n,
                           int rows, int blocks, int nparts, int g_f32,
                           float b1, float omb1, float b2, float omb2,
                           float eps, float wd, void* stream) {
  const Hyper h{b1, omb1, b2, omb2, eps, wd};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(blocks, rows);
  const float* wp = static_cast<const float*>(w);
  float* mp = static_cast<float*>(m);
  float* vp = static_cast<float*>(v);
  const float* sp = static_cast<const float*>(scal);
  float* up = static_cast<float*>(u);
  float* pp = static_cast<float*>(part);
  if (g_f32)
    stage1_kernel<float><<<grid, kThreads, 0, s>>>(
        wp, static_cast<const float*>(g), mp, vp, sp, up, pp, n, nparts, h);
  else
    stage1_kernel<bf16><<<grid, kThreads, 0, s>>>(
        wp, static_cast<const bf16*>(g), mp, vp, sp, up, pp, n, nparts, h);
  return static_cast<int>(cudaGetLastError());
}

// w updated in place from u and the group's whole buffer of partials: row r
// reduces part[r * nparts + i] and part[rows * nparts + r * nparts + i],
// i < nparts; r_out fp32 [rows] receives each row's trust ratio.
extern "C" int lamb_stage2(void* w, const void* u, const void* part,
                           void* r_out, int n, int rows, int blocks,
                           int nparts, float lr, void* stream) {
  stage2_kernel<<<dim3(blocks, rows), kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(w), static_cast<const float*>(u),
      static_cast<const float*>(part), static_cast<float*>(r_out), n,
      nparts, lr);
  return static_cast<int>(cudaGetLastError());
}
