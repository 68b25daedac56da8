// Two row kernels of CnvEngine.ref_stats' one-shot form (ops/ref_stats.py);
// the third, kernel 1's front (ref_centred_kernel), lives with kernel 1 in
// residual_fused.cu.  They replace no TPU kernel: the reference leaves these
// passes to XLA (infercnv_tpu/parallel/engine.py _ref_stats), which fuses
// them; as separate PyTorch ops each wrote and read an f32 [R, G]
// temporary, ten passes over 443 MB at the cells' 13,108 x 8448.
//
//   log_norm_kernel: xlog = log2(c / rowsum * nf + 1) of each count row, in
//     f32, rounded step by step as the reference's ops (and kernel 1's
//     log_norm) round.  Bound by bytes: the counts read once (the second
//     read of a row, after its sum, hits L1) and xlog written once: 664 MB,
//     0.198 ms at 3.35 TB/s for 13,108 x 8448 u16.
//   noise_rows_kernel: of each row of the centred x, the sum and the
//     correction-1 standard deviation of exp2(where_bounds(x, lo, hi)) (the
//     reference residual before denoising), two-pass over the row in shared
//     memory: the values sit near 1, where a sum of squares would cancel.
//     Bound by bytes: x read once, 443 MB, 0.132 ms.  A row too wide for
//     shared memory is read twice instead.
//
// One block a row (256 threads), rows walked by persistent blocks; counts
// read 16 bytes a load (CountRow), xlog and x moved as float4 between a
// scalar head and tail wherever a row does not start 16-byte aligned.
// Build without --use_fast_math (log2f / exp2f accuracy).
#include <cuda_runtime.h>

#include "band_smooth.cuh"
#include "count_row.cuh"

namespace icnv {

constexpr int kRowThreads = 256;

// A row of G values at base (a row index times G): its scalar head up to
// the first 16-byte-aligned element, nvec float4s, its scalar tail.
struct RowParts {
  int head, nvec, tail;
  __device__ RowParts(size_t base, int G) {
    head = min(static_cast<int>((4 - (base & 3)) & 3), G);
    nvec = (G - head) / 4;
    tail = head + 4 * nvec;
  }
  // the i-th of the head's and tail's elements
  __device__ __forceinline__ int edge(int i) const {
    return i < head ? i : tail + (i - head);
  }
  __device__ __forceinline__ int nedge(int G) const { return head + (G - tail); }
};

template <typename InT>
__global__ void __launch_bounds__(kRowThreads)
log_norm_kernel(const InT* __restrict__ counts, float nf, int C, int G,
                float* __restrict__ out) {
  __shared__ float red[32];
  const int tid = threadIdx.x;
  const int T = blockDim.x;
  for (int r = blockIdx.x; r < C; r += gridDim.x) {
    const CountRow<InT> cr(counts, r, G);
    const float cs = block_sum(cr.part_sum(G), red);
    const InT* c = cr.glob;
    const size_t base = (size_t)r * G;
    float* dst = out + base;
    const RowParts rp(base, G);
    for (int i = tid; i < rp.nedge(G); i += T) {
      const int g = rp.edge(i);
      dst[g] = log_norm(static_cast<float>(__ldg(c + g)), cs, nf);
    }
    for (int v = tid; v < rp.nvec; v += T) {
      const int g = rp.head + 4 * v;
      float4 o;
      o.x = log_norm(static_cast<float>(__ldg(c + g)), cs, nf);
      o.y = log_norm(static_cast<float>(__ldg(c + g + 1)), cs, nf);
      o.z = log_norm(static_cast<float>(__ldg(c + g + 2)), cs, nf);
      o.w = log_norm(static_cast<float>(__ldg(c + g + 3)), cs, nf);
      *reinterpret_cast<float4*>(dst + g) = o;
    }
  }
}

// exp2 of x with the where-form bounds of gene g.
__device__ __forceinline__ float bounded_exp2(float x, int g,
                                              const float* __restrict__ lo,
                                              const float* __restrict__ hi) {
  const float l = __ldg(lo + g);
  const float h = __ldg(hi + g);
  const float above = x > h ? x - h : 0.0f;
  return exp2f(x < l ? x - l : above);
}

// kStaged: the row's values kept in shared memory (G floats) for the
// second pass; else the second pass reads x again.
template <bool kStaged>
__global__ void __launch_bounds__(kRowThreads)
noise_rows_kernel(const float* __restrict__ x, const float* __restrict__ lo,
                  const float* __restrict__ hi, int C, int G,
                  float* __restrict__ out) {
  extern __shared__ float vals[];
  __shared__ float red[32];
  const int tid = threadIdx.x;
  const int T = blockDim.x;
  for (int r = blockIdx.x; r < C; r += gridDim.x) {
    const size_t base = (size_t)r * G;
    const float* xr = x + base;
    const RowParts rp(base, G);
    // 1. the values, their sum
    float part = 0.0f;
    for (int i = tid; i < rp.nedge(G); i += T) {
      const int g = rp.edge(i);
      const float v = bounded_exp2(xr[g], g, lo, hi);
      if (kStaged) vals[g] = v;
      part += v;
    }
    for (int q = tid; q < rp.nvec; q += T) {
      const int g = rp.head + 4 * q;
      const float4 a = __ldcs(reinterpret_cast<const float4*>(xr + g));
      const float v[4] = {bounded_exp2(a.x, g, lo, hi),
                          bounded_exp2(a.y, g + 1, lo, hi),
                          bounded_exp2(a.z, g + 2, lo, hi),
                          bounded_exp2(a.w, g + 3, lo, hi)};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (kStaged) vals[g + j] = v[j];
        part += v[j];
      }
    }
    const float sum = block_sum(part, red);  // its syncs publish vals
    const float mean = __fdiv_rn(sum, static_cast<float>(G));
    // 2. squared deviations from the mean
    float sq = 0.0f;
    for (int g = tid; g < G; g += T) {
      const float d = (kStaged ? vals[g] : bounded_exp2(xr[g], g, lo, hi)) - mean;
      sq += d * d;
    }
    const float ss = block_sum(sq, red);
    if (tid == 0) {
      out[2 * (size_t)r] = sum;
      out[2 * (size_t)r + 1] = sqrtf(__fdiv_rn(ss, static_cast<float>(G - 1)));
    }
  }
}

// Persistent blocks: as many as fit on the card at smem bytes each, at most
// one a row.
template <typename Kern>
cudaError_t row_grid(Kern kern, size_t smem, int C, int& grid) {
  int dev = 0, nsm = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                      kRowThreads, smem);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  grid = min(C, per_sm * nsm);
  return cudaSuccess;
}

template <typename InT>
cudaError_t launch_log_norm(const void* counts, float nf, int C, int G,
                            float* out, cudaStream_t s) {
  int grid = 0;
  cudaError_t e = row_grid(log_norm_kernel<InT>, 0, C, grid);
  if (e != cudaSuccess) return e;
  log_norm_kernel<InT><<<grid, kRowThreads, 0, s>>>(
      static_cast<const InT*>(counts), nf, C, G, out);
  return cudaGetLastError();
}

}  // namespace icnv

// xlog [C, G] f32 (16-byte aligned) of counts [C, G] in icnv::InCode in_code.
extern "C" int ic_log_norm(const void* counts, int in_code, float nf, int C,
                           int G, float* out, void* stream) {
  using namespace icnv;
  if (C < 0 || G <= 0 || in_code < 0 || in_code > kU32)
    return static_cast<int>(cudaErrorInvalidValue);
  if (C == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (in_code) {
    case kU16:
      return static_cast<int>(launch_log_norm<unsigned short>(counts, nf, C, G, out, s));
    case kI16:
      return static_cast<int>(launch_log_norm<short>(counts, nf, C, G, out, s));
    case kI32:
      return static_cast<int>(launch_log_norm<int>(counts, nf, C, G, out, s));
    case kU32:
      return static_cast<int>(launch_log_norm<unsigned>(counts, nf, C, G, out, s));
    default:
      return static_cast<int>(launch_log_norm<float>(counts, nf, C, G, out, s));
  }
}

// out [C, 2] f32: each row's (sum, correction-1 sd) of exp2(where_bounds(x,
// lo, hi)); x [C, G] f32 (16-byte aligned), lo and hi [G] f32.  The row is
// staged in shared memory where G floats fit the card's opt-in limit.
extern "C" int ic_noise_rows(const float* x, const float* lo, const float* hi,
                             int C, int G, float* out, void* stream) {
  using namespace icnv;
  if (C < 0 || G < 2) return static_cast<int>(cudaErrorInvalidValue);
  if (C == 0) return 0;
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  // the static 32 floats of red beside the staged row
  const size_t staged = sizeof(float) * ((size_t)G + 32);
  const bool fits = staged <= (size_t)optin;
  const size_t smem = fits ? staged - 32 * sizeof(float) : 0;
  auto kern = fits ? noise_rows_kernel<true> : noise_rows_kernel<false>;
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
  int grid = 0;
  if (e == cudaSuccess) e = row_grid(kern, smem, C, grid);
  if (e != cudaSuccess) return static_cast<int>(e);
  kern<<<grid, kRowThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      x, lo, hi, C, G, out);
  return static_cast<int>(cudaGetLastError());
}
