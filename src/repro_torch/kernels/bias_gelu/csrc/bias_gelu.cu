// Fused bias add + tanh-approximate GeLU for Hopper (sm_90a):
// y = 0.5 * h * (1 + tanh(sqrt(2 / pi) * (h + 0.044715 * h^3))), h = x + b,
// x and y bf16 [R, F], b [F] in bf16 or fp32 (or absent), math in fp32.
//
// Replaces the TPU kernel src/repro/kernels/bias_gelu/kernel.py:28
// bias_gelu (pallas_call at :36 and :42), which also upcasts to fp32. The
// plain version, repro_torch/kernels/bias_gelu/ref.py, is the JAX reference:
// it adds in bf16 and applies GeLU to the rounded sum, so the kernel is held
// against the plain version run in fp32 on the same bf16 inputs.
//
// What bounds it on this card: bytes. It reads x and writes y once (4 bytes
// an element) plus the [F] bias: at bert-large's [1024, 4096] (B8, S128) that
// is 16.8 MB, 5.0 us at 3.35 TB/s; about 15 operations and one tanhf an
// element are far below the fp32 peak. What its design does about it: one
// pass, 16-byte loads and stores (8 elements a thread, a warp on 512
// contiguous bytes), the bias read through L1/L2 (F * 2 bytes, shared by all
// rows), no intermediate sum written to memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;

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

__device__ __forceinline__ float gelu_tanh(float h) {
  const float k = 0.7978845608028654f;        // sqrt(2 / pi)
  const float inner = k * (h + 0.044715f * h * h * h);
  return 0.5f * h * (1.0f + tanhf(inner));
}

// n8 chunks of 8 elements; f % 8 == 0, so a chunk never crosses a row.
template <typename TB>
__global__ void __launch_bounds__(kThreads)
bias_gelu_kernel(const bf16* __restrict__ x, const TB* __restrict__ b,
                 bf16* __restrict__ y, long long n8, int f) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads
                      + threadIdx.x;
  if (i >= n8) return;
  const long long e = i * 8;
  float v[8];
  load8(x + e, v);
  if (b != nullptr) {
    float bv[8];
    load8(b + static_cast<int>(e % f), bv);
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] += bv[j];
  }
  uint4 raw;
  __nv_bfloat162* h2 = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int j = 0; j < 4; ++j)
    h2[j] = __floats2bfloat162_rn(gelu_tanh(v[2 * j]),
                                  gelu_tanh(v[2 * j + 1]));
  *reinterpret_cast<uint4*>(y + e) = raw;
}

}  // namespace

// x, y bf16 with n elements, rows of f (f % 8 == 0); b [f] bf16
// (bias_f32 = 0) or fp32 (bias_f32 = 1), or null.
extern "C" int bias_gelu(const void* x, const void* b, void* y, int n, int f,
                         int bias_f32, void* stream) {
  const long long n8 = static_cast<long long>(n) / 8;
  const dim3 grid(static_cast<unsigned>((n8 + kThreads - 1) / kThreads));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* xp = static_cast<const bf16*>(x);
  bf16* yp = static_cast<bf16*>(y);
  if (bias_f32)
    bias_gelu_kernel<float><<<grid, kThreads, 0, s>>>(
        xp, static_cast<const float*>(b), yp, n8, f);
  else
    bias_gelu_kernel<bf16><<<grid, kThreads, 0, s>>>(
        xp, static_cast<const bf16*>(b), yp, n8, f);
  return static_cast<int>(cudaGetLastError());
}
