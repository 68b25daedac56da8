// The whole default residual pass as one kernel: counts in, final
// (pre-denoise) residual out, one read of the counts and one write of the
// result.
//
// Replaces the TPU kernel
// infercnv_tpu/ops/residual_fused.py::_residual_band_kernel (launched by
// residual_fused_pallas, with its median in radix_median_rows).  Per cell row:
//   1. counts (u16, i16, i32, u32 or f32) -> f32; row sum
//   2. x = log2(c / rowsum * nf + 1)                 (no FMA contraction)
//   3. stage-1 bounds in where-form, then clip to +-mct
//   4. banded smooth (band_smooth.cuh, shared with smooth_banded.cu); with
//      the bf16 flag (the reference's matmul_dtype="bfloat16") x is rounded
//      to bf16 first and the caller passes bf16-rounded weights, so every
//      product is exact and only the f32 sums round
//   5. exact row median: 8-bit radix select on order-preserving uint32 keys
//      (radix_select.cuh, shared with median.cu), (v1 + v2) * 0.5 for even
//      G; or the mean with center_mean
//   6. stage-2 bounds, exp2, store f32 / f16 / bf16 (rounded only here);
//      optionally also the denoised f32 residual (values inside
//      mean_ref +- spread become mean_ref), which the engine would otherwise
//      compute in four more passes over the chunk
//
// What bounds it on the H100: a 32768 x 8448 u16 chunk moves 0.55 GB in and
// 1.1 GB out (f32), 0.50 ms at 3.35 TB/s, while the smooth alone is
// 2 x 797148 nonzero band entries x 32768 rows = 52.2 GFLOP, 0.78 ms at the
// 67 TFLOP/s f32 CUDA-core rate; so the bound is the operations.  With the
// denoised second output (what the engine runs when denoise is on) the
// traffic is 2.77 GB, 0.83 ms, and the bound is the bytes.  The design keeps
// every intermediate of a row in shared memory (8448 f32 = 33 KB a row,
// zero-padded by the halfband on both sides), so device memory sees the
// counts once and each result once.  One block holds one row.  In the smooth
// (band_smooth.cuh) each thread computes four neighbouring outputs from a
// sliding float4 window, so shared memory serves one load per 16 FMAs;
// interior genes take the band's common column from shared memory and only
// the chromosome-end groups read the band from L2, in a pass of their own so
// that they do not stall every tile.  The radix passes skip warps that hold
// no candidate key (after two passes nearly all of them).  The TPU kernel's
// 128-lane tiles, VMEM budget and zero-padded 384-deep block stack do not
// carry over.
//
// Build without --use_fast_math: log2f / exp2f must stay accurate, and
// flushing subnormals would change the median's keys.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include "band_smooth.cuh"
#include "radix_select.cuh"

namespace icnv {

// Input dtype codes (the Python wrapper's _IN_CODES).
enum InCode { kF32 = 0, kU16 = 1, kI16 = 2, kI32 = 3, kU32 = 4 };

template <typename OutT>
__device__ __forceinline__ OutT store_cast(float v);
template <>
__device__ __forceinline__ float store_cast<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __half store_cast<__half>(float v) {
  return __float2half_rn(v);
}
template <>
__device__ __forceinline__ __nv_bfloat16 store_cast<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// A counts row -> f32 in shared memory; returns this thread's partial sum.
template <typename InT>
__device__ inline float load_row(const InT* __restrict__ src, int G,
                                 float* x) {
  float part = 0.0f;
  for (int g = threadIdx.x; g < G; g += blockDim.x) {
    const float c = static_cast<float>(src[g]);
    x[g] = c;
    part += c;
  }
  return part;
}

struct ResidualSmem {
  float* csm;        // band_rows(t4): the band's common column
  float* row;        // the padded row: counts, then x, then the smooth
  float* ebuf;       // nedge * kOut: the smooth's edge groups
  float* red;        // 32: block sums
  SelectSmem* sel;   // the median select
};

__host__ __device__ inline size_t residual_smem_bytes(int G, int t4,
                                                      int nedge) {
  return band_smooth_smem_bytes(G, t4, nedge) + sizeof(float) * 32 +
         sizeof(SelectSmem);
}

// kBf16: round x to bf16 before the smooth (the reference's bf16 flag).
template <typename OutT, bool kBf16>
__global__ void __launch_bounds__(kThreads)
residual_fused_kernel(const void* __restrict__ counts, int in_code, Band bd,
                      const float* __restrict__ b1min,
                      const float* __restrict__ b1max,
                      const float* __restrict__ b2min,
                      const float* __restrict__ b2max, float nf, float mct,
                      int center_mean, OutT* __restrict__ out,
                      const float* __restrict__ noise,
                      float* __restrict__ denoised, int G, int t4) {
  extern __shared__ float4 smem4[];
  ResidualSmem sm;
  sm.csm = reinterpret_cast<float*>(smem4);
  sm.row = sm.csm + band_rows(t4);
  sm.ebuf = sm.row + row_stride(G, t4);
  sm.red = sm.ebuf + (size_t)bd.nedge * kOut;
  sm.sel = reinterpret_cast<SelectSmem*>(sm.red + 32);
  float* xs = sm.row + t4;  // x[0]
  const int tid = threadIdx.x;
  const int T = blockDim.x;
  const size_t base = (size_t)blockIdx.x * G;
  zero_row_pads(sm.row, G, t4);

  // 1. counts -> f32, row sum (exact for integer counts below 2^24)
  float cs;
  switch (in_code) {
    case kU16:
      cs = load_row(static_cast<const unsigned short*>(counts) + base, G, xs);
      break;
    case kI16:
      cs = load_row(static_cast<const short*>(counts) + base, G, xs);
      break;
    case kI32:
      cs = load_row(static_cast<const int*>(counts) + base, G, xs);
      break;
    case kU32:
      cs = load_row(static_cast<const unsigned*>(counts) + base, G, xs);
      break;
    default:
      cs = load_row(static_cast<const float*>(counts) + base, G, xs);
      break;
  }
  cs = block_sum(cs, sm.red);

  // 2-3. normalise + log2, stage-1 bounds (where-form), clip
  for (int g = tid; g < G; g += T) {
    float x = log2f(__fadd_rn(__fmul_rn(__fdiv_rn(xs[g], cs), nf), 1.0f));
    const float lo = b1min[g];
    const float hi = b1max[g];
    const float above = x > hi ? x - hi : 0.0f;
    x = x < lo ? x - lo : above;
    x = fminf(fmaxf(x, -mct), mct);
    xs[g] = kBf16 ? round_bf16(x) : x;
  }
  __syncthreads();

  // 4. banded smooth, in place
  band_smooth_row(sm.row, G, bd, t4, sm.csm, sm.ebuf);

  // 5. row centre: mean, or the exact median
  float centre;
  if (center_mean) {
    float v = 0.0f;
    for (int g = tid; g < G; g += T) v += xs[g];
    centre = __fdiv_rn(block_sum(v, sm.red), static_cast<float>(G));
  } else {
    centre = block_row_median(xs, G, sm.sel);
  }

  // 6. stage-2 bounds, exp2, store (and the denoised copy)
  float dn_mean = 0.0f, dn_lo = 0.0f, dn_hi = 0.0f;
  if (denoised != nullptr) {
    dn_mean = noise[0];
    dn_lo = dn_mean - noise[1];
    dn_hi = dn_mean + noise[1];
  }
  OutT* dst = out + base;
  float* dn = denoised == nullptr ? nullptr : denoised + base;
  for (int g = tid; g < G; g += T) {
    const float y = xs[g] - centre;
    const float lo = b2min[g];
    const float hi = b2max[g];
    const float above = y > hi ? y - hi : 0.0f;
    const float res = exp2f(y < lo ? y - lo : above);
    dst[g] = store_cast<OutT>(res);
    if (dn != nullptr) dn[g] = (res > dn_lo && res < dn_hi) ? dn_mean : res;
  }
}

template <typename OutT>
cudaError_t launch_residual(const void* counts, int in_code, const Band& bd,
                            const float* b1min, const float* b1max,
                            const float* b2min, const float* b2max, float nf,
                            float mct, int center_mean, int bf16, void* out,
                            const float* noise, float* denoised, int C, int G,
                            int t4, size_t smem, cudaStream_t stream) {
  auto kern = bf16 ? residual_fused_kernel<OutT, true>
                   : residual_fused_kernel<OutT, false>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  kern<<<C, kThreads, smem, stream>>>(
      counts, in_code, bd, b1min, b1max, b2min, b2max, nf, mct, center_mean,
      static_cast<OutT*>(out), noise, denoised, G, t4);
  return cudaGetLastError();
}

}  // namespace icnv

// in_code: icnv::InCode; out_code: 0 f32, 1 f16, 2 bf16.
// bf16: round x to bf16 before the smooth (band4 / common must then hold
// bf16-rounded weights).
// noise: device [2] (mean_ref, spread) and denoised: [C, G] f32, or both null.
// band4 / common / slot / edges / nedge: the band as struct Band of
// band_smooth.cuh; t4: the halfband rounded up to a multiple of 4.
// One block a row (fails if a row does not fit in shared memory).
extern "C" int ic_residual_fused(const void* counts, int in_code,
                                 const float* band4, const float* common,
                                 const int* slot, const int* edges, int nedge,
                                 const float* b1min,
                                 const float* b1max, const float* b2min,
                                 const float* b2max, float nf, float mct,
                                 int center_mean, int bf16, void* out,
                                 int out_code,
                                 const float* noise, float* denoised, int C,
                                 int G, int t4, void* stream) {
  using namespace icnv;
  if (C < 0 || G <= 0 || t4 < 0 || t4 % 4 || t4 + 4 > kThreads * kOut ||
      nedge < 0 || nedge > round4(G) / kOut || in_code < 0 ||
      in_code > kU32 || out_code < 0 || out_code > 2 ||
      (noise == nullptr) != (denoised == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (C == 0) return 0;
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  const size_t smem = residual_smem_bytes(G, t4, nedge);
  if (smem > (size_t)optin) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Band bd{band4, common, slot, edges, nedge};
  switch (out_code) {
    case 1:
      e = launch_residual<__half>(counts, in_code, bd, b1min, b1max, b2min,
                                  b2max, nf, mct, center_mean, bf16, out, noise,
                                  denoised, C, G, t4, smem, s);
      break;
    case 2:
      e = launch_residual<__nv_bfloat16>(counts, in_code, bd, b1min, b1max,
                                         b2min, b2max, nf, mct, center_mean,
                                         bf16, out, noise, denoised, C, G, t4,
                                         smem, s);
      break;
    default:
      e = launch_residual<float>(counts, in_code, bd, b1min, b1max, b2min,
                                 b2max, nf, mct, center_mean, bf16, out, noise,
                                 denoised, C, G, t4, smem, s);
      break;
  }
  return static_cast<int>(e);
}
