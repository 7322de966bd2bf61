// The training block's fused residual add + norm for Hopper (sm_90a):
// y = norm(x + residual) * scale (+ bias), rows [R, D], the add and the
// statistics in fp32, y in bf16.
//
// Replaces the TPU kernel src/repro/kernels/fused_layernorm/kernel.py:36
// fused_residual_layernorm (pallas_call at :55). The plain version is
// repro_torch/kernels/fused_layernorm/ref.py fused_residual_layernorm.
//
// What bounds it on this card: bytes. It reads x and residual and writes y
// once (6 bytes an element in bf16) plus the [D] scale and bias: at
// bert-large's [1024, 1024] (B8, S128) that is 6.3 MB, 1.9 us at
// 3.35 TB/s; about ten operations an element put it far below the fp32 peak.
// What its design does about it: every byte moves once. One warp owns one
// row and keeps it in registers (D / 32 fp32 values a lane), so the mean,
// the variance and the normalisation read no memory again; loads and stores
// are 16 bytes a lane, a warp's 32 lanes on 512 contiguous bytes; eight
// rows to a 256-thread CTA give 128 CTAs at 1024 rows.
//
// Numerics (fixed order, no fused multiply-adds):
//   - h = float(x) + float(residual), one fp32 rounding, as the plain version;
//   - each lane sums its values in column order, then an xor butterfly over
//     the warp (every lane ends with the same bits, since a + b == b + a);
//     mean = sum * (1 / D); the variance is the mean of (h - mean)^2 over
//     the registers (RMSNorm: of h^2);
//   - y = ((h - mean) * rsqrtf(var + eps)) * scale (+ bias), rounded once to
//     bf16. The plain version reduces in PyTorch's order, so y may differ
//     from it by an ulp of bf16.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kRowsPerCta = kThreads / 32;

__device__ __forceinline__ void load8(const bf16* p, float* out) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = __bfloat1622float2(h2[j]);
    out[2 * j] = f.x;
    out[2 * j + 1] = f.y;
  }
}

__device__ __forceinline__ void load8(const float* p, float* out) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}

__device__ __forceinline__ void store8(bf16* p, const float* v) {
  uint4 raw;
  __nv_bfloat162* h2 = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int j = 0; j < 4; ++j)
    h2[j] = __floats2bfloat162_rn(v[2 * j], v[2 * j + 1]);
  *reinterpret_cast<uint4*>(p) = raw;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// kVec chunks of 8 columns a lane: D = 256 * kVec. TP is the type of scale
// and bias (bf16 model params, or fp32 without master weights).
template <int kVec, typename TP>
__global__ void __launch_bounds__(kThreads)
resln_kernel(const bf16* __restrict__ x, const bf16* __restrict__ res,
             const TP* __restrict__ scale, const TP* __restrict__ bias,
             bf16* __restrict__ y, int rows, int rms, float eps) {
  constexpr int kD = 256 * kVec;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kRowsPerCta + (threadIdx.x >> 5);
  if (row >= rows) return;
  const size_t off = static_cast<size_t>(row) * kD;

  float h[kVec][8];
  float acc = 0.f;
#pragma unroll
  for (int c = 0; c < kVec; ++c) {
    const int col = c * 256 + lane * 8;
    float a[8], b[8];
    load8(x + off + col, a);
    load8(res + off + col, b);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      h[c][j] = __fadd_rn(a[j], b[j]);
      acc = rms ? __fadd_rn(acc, __fmul_rn(h[c][j], h[c][j]))
                : __fadd_rn(acc, h[c][j]);
    }
  }
  const float inv_d = 1.0f / static_cast<float>(kD);
  float mu = 0.f;
  if (!rms) {
    mu = __fmul_rn(warp_sum(acc), inv_d);
    acc = 0.f;
#pragma unroll
    for (int c = 0; c < kVec; ++c)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        h[c][j] = __fsub_rn(h[c][j], mu);
        acc = __fadd_rn(acc, __fmul_rn(h[c][j], h[c][j]));
      }
  }
  const float var = __fmul_rn(warp_sum(acc), inv_d);
  const float r = rsqrtf(__fadd_rn(var, eps));
#pragma unroll
  for (int c = 0; c < kVec; ++c) {
    const int col = c * 256 + lane * 8;
    float s[8], o[8];
    load8(scale + col, s);
    if (bias != nullptr) load8(bias + col, o);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float v = __fmul_rn(__fmul_rn(h[c][j], r), s[j]);
      o[j] = bias != nullptr ? __fadd_rn(v, o[j]) : v;
    }
    store8(y + off + col, o);
  }
}

template <typename TP>
int launch(const void* x, const void* res, const void* scale,
           const void* bias, void* y, int rows, int d, int rms, float eps,
           cudaStream_t stream) {
  const dim3 grid((rows + kRowsPerCta - 1) / kRowsPerCta);
  const bf16* xp = static_cast<const bf16*>(x);
  const bf16* rp = static_cast<const bf16*>(res);
  const TP* sp = static_cast<const TP*>(scale);
  const TP* bp = static_cast<const TP*>(bias);
  bf16* yp = static_cast<bf16*>(y);
  switch (d) {
#define CASE(V)                                                           \
    case 256 * V:                                                         \
      resln_kernel<V, TP><<<grid, kThreads, 0, stream>>>(xp, rp, sp, bp,  \
                                                         yp, rows, rms, eps); \
      break;
    CASE(1) CASE(2) CASE(3) CASE(4) CASE(6) CASE(8) CASE(12) CASE(16)
#undef CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, res, y bf16 [rows, d]; scale and bias [d], bf16 (param_f32 = 0) or fp32
// (param_f32 = 1); bias may be null. d is one of 256, 512, 768, 1024, 1536,
// 2048, 3072, 4096 (the wrapper checks).
extern "C" int fused_residual_layernorm(const void* x, const void* res,
                                        const void* scale, const void* bias,
                                        void* y, int rows, int d,
                                        int param_f32, int rms, float eps,
                                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return param_f32 ? launch<float>(x, res, scale, bias, y, rows, d, rms, eps, s)
                   : launch<bf16>(x, res, scale, bias, y, rows, d, rms, eps, s);
}
