// Banded smooth along the gene axis: y[C, G] = x[C, G] . W, f32.
//
// Replaces two TPU kernels of infercnv_tpu/ops/smoothing.py, both launched
// by _apply_banded_pallas_k256: _smooth_kernel_k256, which applies the
// operator as 66 K=256 MXU contractions against zero-padded, half-shifted
// 128x128 blocks, and _smooth_kernel_k256_bf16, the same product with bf16
// operands and f32 accumulation (EngineConfig.matmul_dtype="bfloat16").  On
// the H100 the f32 product has no tensor-core path (TF32 would lose the
// reference's 1e-5 parity), so the work is 2t+1 FMAs per output on the CUDA
// cores: ~0.44 GFLOP for the 256 reference cells x 8448 genes of the main
// path, against ~21 MB moved, so it is bound by operations.  The design
// applies the band directly (108 taps: the window's 101 padded to whole
// float4s, instead of a 256- or 384-deep zero-padded stack), with each row
// staged once in shared memory, each thread computing four neighbouring
// outputs from a sliding float4 window, and the weights of interior genes
// taken from a shared-memory copy of the band's common column (see
// band_smooth.cuh, shared with residual_fused.cu).
//
// The bf16 variant rounds each x to bf16 as it is staged; the caller passes
// bf16-rounded weights.  A product of two bf16 values is exact in f32, so it
// differs from the reference's MXU result only in the order of the f32 sums
// (bf16 tensor cores are left for a later design).
//
// One block smooths one row with kThreads threads, the row zero-padded in
// shared memory; the caller allocates y.
#include <cuda_runtime.h>

#include "band_smooth.cuh"

namespace icnv {

// kBf16: the bf16 variant (two kernels, as the TPU has two bodies).
template <bool kBf16>
__global__ void __launch_bounds__(kThreads)
smooth_banded_kernel(const float* __restrict__ x, Band bd,
                     float* __restrict__ y, int G, int t4) {
  extern __shared__ float4 smem4[];
  float* csm = reinterpret_cast<float*>(smem4);
  float* row = csm + band_rows(t4);
  float* ebuf = row + row_stride(G, t4);
  zero_row_pads(row, G, t4);
  const float* src = x + (size_t)blockIdx.x * G;
  for (int g = threadIdx.x; g < G; g += blockDim.x)
    row[t4 + g] = kBf16 ? round_bf16(src[g]) : src[g];
  __syncthreads();
  band_smooth_row(row, G, bd, t4, csm, ebuf);
  float* dst = y + (size_t)blockIdx.x * G;
  for (int g = threadIdx.x; g < G; g += blockDim.x) dst[g] = row[t4 + g];
}

}  // namespace icnv

// band4 / common / slot / edges / nedge: the band as struct Band of
// band_smooth.cuh; t4: the halfband rounded up to a multiple of 4.
// bf16: round x to bf16 as it is read (the weights must be bf16-rounded).
extern "C" int ic_smooth_banded(const float* x, const float* band4,
                                const float* common, const int* slot,
                                const int* edges, int nedge, float* y, int C,
                                int G, int t4, int bf16, void* stream) {
  using namespace icnv;
  if (C < 0 || G <= 0 || t4 < 0 || t4 % 4 || t4 + 4 > kThreads * kOut ||
      nedge < 0 || nedge > round4(G) / kOut)
    return static_cast<int>(cudaErrorInvalidValue);
  if (C == 0) return 0;
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  const size_t smem = band_smooth_smem_bytes(G, t4, nedge);
  if (smem > (size_t)optin) return static_cast<int>(cudaErrorInvalidValue);
  auto kern = bf16 ? smooth_banded_kernel<true> : smooth_banded_kernel<false>;
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  kern<<<C, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      x, Band{band4, common, slot, edges, nedge}, y, G, t4);
  return static_cast<int>(cudaGetLastError());
}
