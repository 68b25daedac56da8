// Exact row medians, and the median-centred tail of the residual: one row a
// block.
//
// Replaces two TPU kernels of infercnv_tpu/ops/median.py:
//   _median_kernel (launched by row_median_pallas): the exact median of
//     each row with numpy's semantics;
//   _median_epilogue_kernel (median_center_residual_pallas): the same median
//     of a smooth output row, then y - median, the stage-2 where-bounds and
//     exp2, i.e. the final residual of the engine's unfused path.
// Both select with radix_select.cuh, as residual_fused.cu does, so the
// port's three medians cannot differ.  The TPU kernels pad rows with +inf to
// whole 128-lane tiles; here a row is read for its n values only and the
// rest of its stride (ld) is ignored.
//
// What bounds them on the H100: the bytes.  The median of a 32768 x 8448
// f32 chunk reads 1.1 GB (0.33 ms at 3.35 TB/s) for ~4 compares a value;
// the tail on 8192 x 60000 reads and writes 1.97 GB each (1.2 ms).  The
// select needs five sweeps of a row (four radix passes and, for an even
// count, the lower middle), so a row that fits in shared memory is staged
// there once and device memory sees it once.  A row that does not fit
// (60000 genes are 240 KB, above the 227 KB a block may hold) is swept from
// device memory on every pass, through L2 where it still sits.
#include <cuda_runtime.h>

#include "radix_select.cuh"

namespace icnv {

constexpr int kMedianThreads = 256;

// The row a block works on: its n values copied into shared memory (buf)
// when staged, else the row in device memory.
__device__ inline const float* block_row(const float* src, int n, float* buf,
                                         int staged) {
  if (!staged) return src;
  for (int g = threadIdx.x; g < n; g += blockDim.x) buf[g] = src[g];
  __syncthreads();
  return buf;
}

__global__ void __launch_bounds__(kMedianThreads)
row_median_kernel(const float* __restrict__ x, int ld, int n, int staged,
                  float* __restrict__ med) {
  extern __shared__ float4 smem4[];
  SelectSmem* sel = reinterpret_cast<SelectSmem*>(smem4);
  float* buf = reinterpret_cast<float*>(sel + 1);
  const float* row = block_row(x + (size_t)blockIdx.x * ld, n, buf, staged);
  const float m = block_row_median(row, n, sel);
  if (threadIdx.x == 0) med[blockIdx.x] = m;
}

// out[g] = exp2(where-bounds(y[g] - median(y), gmin[g], gmax[g])), in the
// reference's op order (infercnv_tpu/ops/median.py:121-126).  med, when not
// null, receives each row's median.
__global__ void __launch_bounds__(kMedianThreads)
median_epilogue_kernel(const float* __restrict__ y, int ld, int n, int staged,
                       const float* __restrict__ gmin,
                       const float* __restrict__ gmax, float* __restrict__ out,
                       int ldo, float* __restrict__ med) {
  extern __shared__ float4 smem4[];
  SelectSmem* sel = reinterpret_cast<SelectSmem*>(smem4);
  float* buf = reinterpret_cast<float*>(sel + 1);
  const float* row = block_row(y + (size_t)blockIdx.x * ld, n, buf, staged);
  const float m = block_row_median(row, n, sel);
  if (med != nullptr && threadIdx.x == 0) med[blockIdx.x] = m;
  float* dst = out + (size_t)blockIdx.x * ldo;
  for (int g = threadIdx.x; g < n; g += blockDim.x) {
    const float r = row[g] - m;
    const float lo = gmin[g];
    const float hi = gmax[g];
    const float above = r > hi ? r - hi : 0.0f;
    dst[g] = exp2f(r < lo ? r - lo : above);
  }
}

// Shared memory of a block, and whether its row is staged there.
inline cudaError_t median_smem(int n, size_t* smem, int* staged) {
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (e != cudaSuccess) return e;
  const size_t full = sizeof(SelectSmem) + sizeof(float) * (size_t)n;
  *staged = full <= (size_t)optin;
  *smem = *staged ? full : sizeof(SelectSmem);
  return cudaSuccess;
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kern, size_t smem) {
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

}  // namespace icnv

// x: C rows of stride ld (>= n); med: [C].
extern "C" int ic_row_median(const float* x, int ld, int C, int n, float* med,
                             void* stream) {
  using namespace icnv;
  if (C < 0 || n <= 0 || ld < n) return static_cast<int>(cudaErrorInvalidValue);
  if (C == 0) return 0;
  size_t smem = 0;
  int staged = 0;
  cudaError_t e = median_smem(n, &smem, &staged);
  if (e == cudaSuccess) e = allow_smem(row_median_kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  row_median_kernel<<<C, kMedianThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(x, ld, n, staged,
                                                           med);
  return static_cast<int>(cudaGetLastError());
}

// y: C rows of stride ld (>= n), the smooth output; gmin / gmax: [n];
// out: C rows of stride ldo (>= n); med: [C] or null.
extern "C" int ic_median_center_residual(const float* y, int ld,
                                         const float* gmin, const float* gmax,
                                         float* out, int ldo, float* med,
                                         int C, int n, void* stream) {
  using namespace icnv;
  if (C < 0 || n <= 0 || ld < n || ldo < n)
    return static_cast<int>(cudaErrorInvalidValue);
  if (C == 0) return 0;
  size_t smem = 0;
  int staged = 0;
  cudaError_t e = median_smem(n, &smem, &staged);
  if (e == cudaSuccess) e = allow_smem(median_epilogue_kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  median_epilogue_kernel<<<C, kMedianThreads, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      y, ld, n, staged, gmin, gmax, out, ldo, med);
  return static_cast<int>(cudaGetLastError());
}
