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
// is 16.8 MB, 5.0 us at 3.35 TB/s. At that rate the SMs have about 40
// instructions an element to spend, so the instruction count binds next:
// a full-precision tanhf and a 64-bit remainder for the bias column cost
// most of that budget. What the design does about both:
// - GeLU as h * sigmoid(2u) = h / (1 + 2^(-2u log2 e)): one ex2.approx, one
//   fast reciprocal and four FMA-pipe operations an element. It is the same
//   function, and in the negative tail it avoids the cancellation in
//   1 + tanh(u) (its error there is relative to the tiny result);
//   ref.gelu_as_sigmoid is this arithmetic in PyTorch, held by the tests.
// - a 2-D index with no division: a thread owns one 8-column chunk (16
//   bytes, a warp on 512 contiguous bytes of a row), loads its bias chunk
//   once and walks a run of rows, kRowsInFlight 16-byte loads of x issued
//   before any is used, and the next kRowsInFlight rows' loads issued
//   before this rows' math;
// - a grid sized to the SMs (ops.gelu_plan): about 4 CTAs a SM, one wave,
//   instead of one CTA per 2048 elements;
// - plain loads and stores of x and y: in the step x comes straight from
//   the GEMM before it and y goes to the GEMM after it, and at [1024, 4096]
//   both fit the 50 MB L2, so evict-first hints (__ldcs, __stcs) cost more
//   than they save (gelu_ablations.py); the bias through the read-only
//   path.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;       // a CTA, as (tx, ty) = (chunks, rows)
constexpr int kRowsInFlight = 4;    // ops.ROWS_IN_FLIGHT
// -2 sqrt(2 / pi) log2(e), and times 0.044715: -2u log2(e) = h (kA + kB h^2)
constexpr float kA = static_cast<float>(-2.0 * 0.7978845608028654
                                        * 1.4426950408889634);
constexpr float kB = static_cast<float>(-2.0 * 0.7978845608028654
                                        * 1.4426950408889634 * 0.044715);

__device__ __forceinline__ void load8(const bf16* p, float* out) {
  const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = __bfloat1622float2(h2[j]);
    out[2 * j] = f.x;
    out[2 * j + 1] = f.y;
  }
}

__device__ __forceinline__ void load8(const float* p, float* out) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p + 4));
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}

__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// h / (1 + e), e = 2^(h (kA + kB h^2)) = exp(-2u). As h -> -inf, e -> inf
// and the reciprocal -> 0; as h -> +inf, e -> 0 and y = h.
__device__ __forceinline__ float gelu(float h) {
  const float e = ex2_approx(h * fmaf(kB, h * h, kA));
  return __fdividef(h, 1.0f + e);
}

__device__ __forceinline__ uint4 gelu8(const uint4 raw, const float* bv) {
  const __nv_bfloat162* in = reinterpret_cast<const __nv_bfloat162*>(&raw);
  uint4 res;
  __nv_bfloat162* out = reinterpret_cast<__nv_bfloat162*>(&res);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = __bfloat1622float2(in[j]);
    out[j] = __floats2bfloat162_rn(gelu(f.x + bv[2 * j]),
                                   gelu(f.y + bv[2 * j + 1]));
  }
  return res;
}

// Thread (tx, ty) of CTA (bx, by) owns the 8 columns from
// c = (bx * blockDim.x + tx) * 8 of rows [r0, r0 + rows_per_thread),
// r0 = (by * blockDim.y + ty) * rows_per_thread; f % 8 == 0.
template <typename TB>
__global__ void __launch_bounds__(kThreads)
bias_gelu_kernel(const bf16* __restrict__ x, const TB* __restrict__ b,
                 bf16* __restrict__ y, int rows, int f,
                 int rows_per_thread) {
  const int c = (blockIdx.x * blockDim.x + threadIdx.x) * 8;
  const int r0 = (blockIdx.y * blockDim.y + threadIdx.y) * rows_per_thread;
  if (c >= f || r0 >= rows) return;
  const int r1 = min(rows, r0 + rows_per_thread);
  float bv[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  if (b != nullptr) load8(b + c, bv);
  const size_t stride = static_cast<size_t>(f) / 8;    // 16-byte words a row
  const size_t first = static_cast<size_t>(r0) * stride + c / 8;
  const uint4* xp = reinterpret_cast<const uint4*>(x) + first;
  uint4* yp = reinterpret_cast<uint4*>(y) + first;
  uint4 raw[kRowsInFlight];
  int n = min(kRowsInFlight, r1 - r0);
#pragma unroll
  for (int j = 0; j < kRowsInFlight; ++j)
    if (j < n) raw[j] = xp[j * stride];
  for (int r = r0; r < r1; r += kRowsInFlight) {
    // the next rows' loads go out before this rows' math and stores
    const int n_next = min(kRowsInFlight, r1 - r - kRowsInFlight);
    uint4 next[kRowsInFlight];
#pragma unroll
    for (int j = 0; j < kRowsInFlight; ++j)
      if (j < n_next) next[j] = xp[(kRowsInFlight + j) * stride];
#pragma unroll
    for (int j = 0; j < kRowsInFlight; ++j)
      if (j < n) yp[j * stride] = gelu8(raw[j], bv);
#pragma unroll
    for (int j = 0; j < kRowsInFlight; ++j)
      if (j < n_next) raw[j] = next[j];
    n = n_next;
    xp += kRowsInFlight * stride;
    yp += kRowsInFlight * stride;
  }
}

}  // namespace

// x, y bf16 [rows, f] (f % 8 == 0); b [f] bf16 (bias_f32 = 0) or fp32
// (bias_f32 = 1), or null. The grid is ops.gelu_plan's: CTAs (gx, gy) of
// threads (tx, ty), tx * ty <= 256, each thread rows_per_thread rows.
extern "C" int bias_gelu(const void* x, const void* b, void* y, int rows,
                         int f, int bias_f32, int tx, int ty, int gx, int gy,
                         int rows_per_thread, void* stream) {
  const dim3 grid(static_cast<unsigned>(gx), static_cast<unsigned>(gy));
  const dim3 block(static_cast<unsigned>(tx), static_cast<unsigned>(ty));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* xp = static_cast<const bf16*>(x);
  bf16* yp = static_cast<bf16*>(y);
  if (bias_f32)
    bias_gelu_kernel<float><<<grid, block, 0, s>>>(
        xp, static_cast<const float*>(b), yp, rows, f, rows_per_thread);
  else
    bias_gelu_kernel<bf16><<<grid, block, 0, s>>>(
        xp, static_cast<const bf16*>(b), yp, rows, f, rows_per_thread);
  return static_cast<int>(cudaGetLastError());
}
