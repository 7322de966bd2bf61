// The decode residual stream's fused add + norm for Hopper (sm_90a):
// (y, x) -> (h = norm(x + y) * scale [+ bias], x2 = x + y), rows [R, D].
//
// Replaces the TPU kernel src/repro/kernels/fused_layernorm/kernel.py:85
// decode_residual_norm (pallas_call at :113). The plain version is
// repro_torch/kernels/fused_layernorm/ref.py: the add in the model dtype,
// then the port's apply_norm (models/layers.py) verbatim.
//
// What bounds it on this card: latency. It reads y and x and writes h and x2
// once, plus the [D] scale: at the decode shape [8, 3072] bf16 that is
// 0.2 MB, 0.06 us at 3.35 TB/s; at a 64-row prefill chunk 1.6 MB, 0.5 us.
// Either way one launch and one trip to memory cost more than the bytes,
// so the design spends exactly one of each: one launch replaces the eager
// add + norm sequence (about ten launches) at each ln2 site, and each
// thread issues every load it needs (y, x, scale, bias) before it uses
// any, so the loads wait on memory once, together.
//
// Design (v2). The register path, for whole 16-byte vectors at 16-byte
// aligned bases: a row is `ctas` CTAs of `threads` threads, and each thread
// holds `vecs` vectors (8 bf16 values each) of y, x, scale and bias in
// registers, a template on vecs (1-4); thread t of rank c takes vectors
// (c * vecs + j) * threads + t, j < vecs, so neighbouring threads read
// neighbouring 16 bytes. x2 stays in registers and is stored with h after
// the sums; nothing goes through shared memory but the sums' warp partials
// (norm_reduce.cuh: one __syncthreads a sum, and a cluster barrier a sum
// when ctas > 1). ops.norm_plan(rows, d), a pure function of the shape,
// takes one CTA of at most 256 threads of 1-2 vectors where it can, else a
// cluster. Device times on an H100 80GB HBM3 at 700.00 W (norm_ablations.py;
// the runs are in PERF.md) that chose it: at [8, 3072] one CTA of 192
// threads 0.00177-0.00178 ms against 0.00194-0.00224 on 2-4 CTAs a row,
// 0.00260-0.00264 for the wide variant (v1's structure) and 0.00186
// with scale and bias loaded after the sum; at [8, 12288] 4 CTAs a row
// 0.00227-0.00228 against 0.00303 on one. The wide variant takes the rest
// (D not a multiple of 8, a misaligned base, rows past the register path):
// one CTA of 256 threads a row, scalar loads, x2 kept in shared memory as
// fp32 (so D <= 58096); it raises its shared-memory limit once a device,
// never on a call at the // serves' widths. Numerics, both variants:
//   - x2 = round(float(x) + float(y)) to bf16: one rounding of the fp32
//     sum, as PyTorch's elementwise add computes it, so x2 is bitwise equal
//     to the plain version;
//   - the fp32 statistics follow the fixed order of norm_reduce.cuh (each
//     thread adds its elements in vector order, then element order), the
//     layernorm in two passes (the mean, then the centred variance), mean =
//     sum * (1 / D), var + eps, rsqrtf, then (v * r) * scale [+ bias] with
//     no fused multiply-adds. torch.mean on the card reduces in another
//     order, so h may differ from the plain version by an ulp of the model
//     dtype.

#include "norm_reduce.cuh"

namespace {

namespace rn = rownorm;
using rn::bf16;

constexpr int kWideThreads = 256;
// The wide variant's static shared memory (its two sums' warp partials);
// a launch needs the opt-in once static plus dynamic pass 48 KB.
constexpr int kWideStatic = 2 * (kWideThreads / 32) * sizeof(float);
constexpr int kDefaultSmem = 48 * 1024 - kWideStatic;
constexpr int kMaxDevices = 64;

template <bool kLayerNorm, int V>
__global__ void __launch_bounds__(rn::kMaxThreads)
resnorm_kernel(const bf16* __restrict__ y, const bf16* __restrict__ x,
               const bf16* __restrict__ scale, const bf16* __restrict__ bias,
               bf16* __restrict__ h, bf16* __restrict__ xo, int d,
               float eps) {
  __shared__ __align__(16) float red[2][rn::kMaxWarps];
  __shared__ float slots[2][rn::kMaxCtas];
  const rn::RowPos pos = rn::row_pos();
  const int ctas = pos.ctas, threads = blockDim.x;
  const int first = pos.rank * V * threads + threadIdx.x;
  const size_t off = static_cast<size_t>(pos.row) * d;
  const float inv_d = 1.0f / static_cast<float>(d);

  uint4 yy[V], xx[V], ss[V], bb[V];
  rn::load(yy, reinterpret_cast<const uint4*>(y + off), first, threads);
  rn::load(xx, reinterpret_cast<const uint4*>(x + off), first, threads);
  rn::load(ss, reinterpret_cast<const uint4*>(scale), first, threads);
  if (bias != nullptr)
    rn::load(bb, reinterpret_cast<const uint4*>(bias), first, threads);
  rn::cluster_start(ctas);

  float acc = 0.f;
#pragma unroll
  for (int j = 0; j < V; ++j) {      // x2 = x + y, kept in xx
#pragma unroll
    for (int e = 0; e < rn::kLane; ++e) {
      rn::set_bf16(xx[j], e, __fadd_rn(rn::to_float(xx[j], e),
                                       rn::to_float(yy[j], e)));
      const float v = rn::to_float(xx[j], e);
      acc = kLayerNorm ? __fadd_rn(acc, v) : __fadd_rn(acc, __fmul_rn(v, v));
    }
  }
  float mu = 0.f;
  if (kLayerNorm) {
    mu = __fmul_rn(rn::row_sum<rn::kMaxWarps>(acc, red[0], slots[0], ctas,
                                              true),
                   inv_d);
    acc = 0.f;
#pragma unroll
    for (int j = 0; j < V; ++j)
#pragma unroll
      for (int e = 0; e < rn::kLane; ++e) {
        const float c = __fsub_rn(rn::to_float(xx[j], e), mu);
        acc = __fadd_rn(acc, __fmul_rn(c, c));
      }
  }
  const float var = __fmul_rn(
      rn::row_sum<rn::kMaxWarps>(acc, red[kLayerNorm], slots[kLayerNorm],
                                 ctas, !kLayerNorm),
      inv_d);
  const float r = rsqrtf(__fadd_rn(var, eps));
  uint4* xov = reinterpret_cast<uint4*>(xo + off);
  uint4* hv = reinterpret_cast<uint4*>(h + off);
#pragma unroll
  for (int j = 0; j < V; ++j) {
    uint4 o;
#pragma unroll
    for (int e = 0; e < rn::kLane; ++e) {
      const float v = rn::to_float(xx[j], e);
      const float c = kLayerNorm ? __fsub_rn(v, mu) : v;
      float t = __fmul_rn(__fmul_rn(c, r), rn::to_float(ss[j], e));
      if (bias != nullptr) t = __fadd_rn(t, rn::to_float(bb[j], e));
      rn::set_bf16(o, e, t);
    }
    xov[first + j * threads] = xx[j];
    hv[first + j * threads] = o;
  }
}

// The wide variant: any D, any alignment; x2 in fp32 shared memory.
template <bool kLayerNorm>
__global__ void __launch_bounds__(kWideThreads)
resnorm_kernel_wide(const bf16* __restrict__ y, const bf16* __restrict__ x,
                    const bf16* __restrict__ scale,
                    const bf16* __restrict__ bias, bf16* __restrict__ h,
                    bf16* __restrict__ xo, int d, float eps) {
  constexpr int kWarps = kWideThreads / 32;
  extern __shared__ float row[];             // x2 in fp32, [d]
  __shared__ __align__(16) float red[2][kWarps];
  const size_t off = static_cast<size_t>(blockIdx.x) * d;
  const float inv_d = 1.0f / static_cast<float>(d);

  float acc = 0.f;
  for (int i = threadIdx.x; i < d; i += kWideThreads) {
    const bf16 s = __float2bfloat16_rn(
        __fadd_rn(__bfloat162float(x[off + i]), __bfloat162float(y[off + i])));
    xo[off + i] = s;
    const float v = __bfloat162float(s);
    row[i] = v;
    acc = kLayerNorm ? __fadd_rn(acc, v) : __fadd_rn(acc, __fmul_rn(v, v));
  }
  float mu = 0.f;
  if (kLayerNorm) {
    mu = __fmul_rn(rn::cta_sum<kWarps>(acc, red[0]), inv_d);
    acc = 0.f;
    for (int i = threadIdx.x; i < d; i += kWideThreads) {
      const float c = __fsub_rn(row[i], mu);
      acc = __fadd_rn(acc, __fmul_rn(c, c));
    }
  }
  const float var =
      __fmul_rn(rn::cta_sum<kWarps>(acc, red[kLayerNorm]), inv_d);
  const float r = rsqrtf(__fadd_rn(var, eps));
  for (int i = threadIdx.x; i < d; i += kWideThreads) {
    const float c = kLayerNorm ? __fsub_rn(row[i], mu) : row[i];
    float o = __fmul_rn(__fmul_rn(c, r), __bfloat162float(scale[i]));
    if (bias != nullptr) o = __fadd_rn(o, __bfloat162float(bias[i]));
    h[off + i] = __float2bfloat16_rn(o);
  }
}

using Kernel = void (*)(const bf16*, const bf16*, const bf16*, const bf16*,
                        bf16*, bf16*, int, float);

template <bool kLayerNorm>
Kernel pick(int vecs) {
  switch (vecs) {
    case 1: return resnorm_kernel<kLayerNorm, 1>;
    case 2: return resnorm_kernel<kLayerNorm, 2>;
    case 3: return resnorm_kernel<kLayerNorm, 3>;
    case 4: return resnorm_kernel<kLayerNorm, 4>;
    default: return nullptr;
  }
}

int launch_wide(const bf16* y, const bf16* x, const bf16* scale,
                const bf16* bias, bf16* h, bf16* xo, int rows, int d,
                bool layernorm, float eps, cudaStream_t stream) {
  const int smem = d * static_cast<int>(sizeof(float));
  auto kern = layernorm ? resnorm_kernel_wide<true>
                        : resnorm_kernel_wide<false>;
  // Up to 48 KB of shared memory in all needs no opt-in (D <= 12272);
  // above it the limit is raised once per device and variant, to the
  // largest D seen.
  static int smem_limit[2][kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  int& limit = smem_limit[layernorm][dev];
  if (smem > kDefaultSmem && smem > limit) {
    err = cudaFuncSetAttribute(kern,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    limit = smem;
  }
  kern<<<rows, kWideThreads, smem, stream>>>(y, x, scale, bias, h, xo, d,
                                             eps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// y, x, h, xo bf16 [rows, d]; scale and bias bf16 [d]; bias may be null.
// The plan (threads, vecs, ctas) comes from ops.norm_plan: vecs == 0 takes
// the wide variant (threads and ctas are then ignored), else the register
// path, whose bases must be 16-byte aligned.
extern "C" int decode_residual_norm(const void* y, const void* x,
                                    const void* scale, const void* bias,
                                    void* h, void* xo, int rows, int d,
                                    int layernorm, int threads, int vecs,
                                    int ctas, float eps, void* stream) {
  const bf16* yp = static_cast<const bf16*>(y);
  const bf16* xp = static_cast<const bf16*>(x);
  const bf16* sp = static_cast<const bf16*>(scale);
  const bf16* bp = static_cast<const bf16*>(bias);
  bf16* hp = static_cast<bf16*>(h);
  bf16* xop = static_cast<bf16*>(xo);
  if (vecs == 0)
    return launch_wide(yp, xp, sp, bp, hp, xop, rows, d, layernorm != 0, eps,
                       static_cast<cudaStream_t>(stream));
  const Kernel kern = layernorm ? pick<true>(vecs) : pick<false>(vecs);
  if (kern == nullptr || !rn::plan_ok(d, threads, vecs, ctas))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      rn::launch_config(rows, ctas, threads, 0, stream, &attr);
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kern, yp, xp, sp, bp, hp,
                                             xop, d, eps);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
