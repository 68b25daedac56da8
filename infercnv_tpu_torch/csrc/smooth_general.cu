// Banded smooth along the gene axis for any band: y[C, G] = x[C, G] . W,
// f32, tiled over rows and genes.
//
// Replaces the TPU kernel infercnv_tpu/ops/smoothing.py::_smooth_kernel_sides
// (launched by _apply_banded_pallas_sides), the general (2S+1)-block form for
// wide bands.  The engine takes it where the one-row kernel of
// smooth_banded.cu / residual_fused.cu cannot go: coordinate smoothing (a
// 10 Mbp window gives halfbands of ~235 genes and weights that differ for
// every gene, so no common column exists and every group would read its
// band from L2 for every row), and genomes whose row does not fit in shared
// memory (60,000 genes are 240 KB).
//
// What bounds it on the H100: the operations.  On the coordinates chunk
// (32768 x 8448, ~1.12 M nonzero band entries) the smooth is ~73 GFLOP,
// ~1.1 ms at the 67 TFLOP/s f32 CUDA-core rate, against ~2.2 GB of x and y
// (~0.66 ms).  The design: a block computes a tile of kRows rows x kTileG
// genes.  It stages the tile's x, with the band's reach on both sides, in
// shared memory, and each thread computes 4 neighbouring genes of
// kRowsPerThread rows from a sliding float4 window, so one float4 of
// weights (read through L1, where the block's 8 warps share it) feeds
// 4 x kRowsPerThread FMAs.  Each gene tile sums only its taps that hold a
// nonzero weight ([tap_lo, tap_hi), computed on the host from the band), so
// the work follows the band's nonzeros and not its widest column.  The taps
// are staged in chunks of at most kChunk (x for the tile plus that reach),
// so any band fits and a block holds ~50 KB, four blocks an SM; the
// accumulators stay in registers across chunks and the taps are summed in
// order of e for each output.
//
// Band layout: band4 of band_smooth.cuh (rows e in [0, 2 t4 + 4) weight
// x[g + e - t4] for y[g], zero-padded to round4(G) columns), read from
// device memory.
#include <cuda_runtime.h>

#include "band_smooth.cuh"

namespace icnv {

constexpr int kTileG = 128;         // genes a block computes
constexpr int kGeneThreads = kTileG / kOut;  // 32: one warp spans the genes
constexpr int kRowsPerThread = 4;
constexpr int kRowGroups = 8;       // warps of a block, one per row group
constexpr int kRows = kRowGroups * kRowsPerThread;  // 32 rows a block
constexpr int kGeneralThreads = kGeneThreads * kRowGroups;  // 256
constexpr int kChunk = 256;         // taps staged at a time (a multiple of 4)

// Floats of a staged x row: the tile, a chunk of taps, one float4 of slack
// for the sliding window.
__host__ __device__ inline int general_stride(int chunk) {
  return round4(kTileG + chunk + 4);
}

__global__ void __launch_bounds__(kGeneralThreads)
smooth_general_kernel(const float* __restrict__ x,
                      const float* __restrict__ band4,
                      const int* __restrict__ tap_lo,
                      const int* __restrict__ tap_hi,
                      float* __restrict__ y, int ldy, int C, int G, int t4,
                      int chunk) {
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);  // [kRows][general_stride]
  const int SW = general_stride(chunk);
  const int Gr = round4(G);
  const int tile = blockIdx.x;
  const int g0 = tile * kTileG;
  const int r0 = blockIdx.y * kRows;
  const int e_lo = tap_lo[tile];
  const int e_hi = tap_hi[tile];
  const int gl = threadIdx.x % kGeneThreads;
  const int rg = threadIdx.x / kGeneThreads;
  const int g = g0 + gl * kOut;
  const bool active = g < Gr;
  const float* xr[kRowsPerThread];
  float acc[kRowsPerThread][kOut];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    xr[i] = xs + (rg * kRowsPerThread + i) * SW + gl * kOut;
#pragma unroll
    for (int j = 0; j < kOut; ++j) acc[i][j] = 0.0f;
  }
  for (int c0 = e_lo; c0 < e_hi; c0 += chunk) {
    const int c1 = min(c0 + chunk, e_hi);
    // staged column c holds x[:, gx0 + c]
    const int gx0 = g0 + c0 - t4;
    const int width = kTileG + (c1 - c0) + 4;
    __syncthreads();  // the previous chunk's reads are done
    for (int i = threadIdx.x; i < kRows * width; i += blockDim.x) {
      const int r = i / width;
      const int c = i - r * width;
      const int gx = gx0 + c;
      const int row = r0 + r;
      xs[r * SW + c] =
          (row < C && gx >= 0 && gx < G) ? x[(size_t)row * G + gx] : 0.0f;
    }
    __syncthreads();
    if (!active) continue;
    float4 a[kRowsPerThread];
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i)
      a[i] = *reinterpret_cast<const float4*>(xr[i]);
    for (int e = c0; e < c1; e += 4) {
      float w[4][kOut];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float4 v = __ldg(
            reinterpret_cast<const float4*>(band4 + (size_t)(e + k) * Gr + g));
        w[k][0] = v.x;
        w[k][1] = v.y;
        w[k][2] = v.z;
        w[k][3] = v.w;
      }
      const int off = e - c0 + 4;
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) {
        const float4 b = *reinterpret_cast<const float4*>(xr[i] + off);
        const float win[8] = {a[i].x, a[i].y, a[i].z, a[i].w,
                              b.x,    b.y,    b.z,    b.w};
#pragma unroll
        for (int k = 0; k < 4; ++k)
#pragma unroll
          for (int j = 0; j < kOut; ++j)
            acc[i][j] = fmaf(w[k][j], win[k + j], acc[i][j]);
        a[i] = b;
      }
    }
  }
  if (!active) return;
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int row = r0 + rg * kRowsPerThread + i;
    if (row >= C) break;
    float* dst = y + (size_t)row * ldy + g;
    if (g + kOut <= G && (ldy & 3) == 0) {
      *reinterpret_cast<float4*>(dst) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    } else {
#pragma unroll
      for (int j = 0; j < kOut; ++j)
        if (g + j < G) dst[j] = acc[i][j];
    }
  }
}

}  // namespace icnv

// x: [C, G] f32; band4: [2 t4 + 4, round4(G)] (band_smooth.cuh); tap_lo /
// tap_hi: [ceil(round4(G) / 128)] multiples of 4 in [0, 2 t4 + 4], each gene
// tile's taps with a nonzero weight; max_span: the largest tap_hi - tap_lo
// (any span: the kernel stages it in chunks); y: C rows of stride ldy
// (>= G); C <= 65535 * 32.
extern "C" int ic_smooth_general(const float* x, const float* band4,
                                 const int* tap_lo, const int* tap_hi,
                                 int max_span, float* y, int ldy, int C, int G,
                                 int t4, void* stream) {
  using namespace icnv;
  if (C < 0 || G <= 0 || t4 < 0 || t4 % 4 || ldy < G || max_span < 0 ||
      max_span % 4 || max_span > 2 * t4 + 4 ||
      (C + kRows - 1) / kRows > 65535)  // gridDim.y
    return static_cast<int>(cudaErrorInvalidValue);
  if (C == 0) return 0;
  const int chunk = min(max_span, kChunk);
  const size_t smem = sizeof(float) * (size_t)kRows * general_stride(chunk);
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (smem > (size_t)optin) return static_cast<int>(cudaErrorInvalidValue);
  e = cudaFuncSetAttribute(smooth_general_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((round4(G) + kTileG - 1) / kTileG, (C + kRows - 1) / kRows);
  smooth_general_kernel<<<grid, kGeneralThreads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      x, band4, tap_lo, tap_hi, y, ldy, C, G, t4, chunk);
  return static_cast<int>(cudaGetLastError());
}
