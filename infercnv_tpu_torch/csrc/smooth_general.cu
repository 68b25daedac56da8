// Banded smooth along the gene axis for any band: y[C, G] = x[C, G] . W,
// f32, tiled over rows and genes.
//
// Replaces the TPU kernel infercnv_tpu/ops/smoothing.py::_smooth_kernel_sides
// (launched by _apply_banded_pallas_sides), the general (2S+1)-block form for
// wide bands.  The engine takes it where the one-row kernel of
// smooth_banded.cu / residual_fused.cu cannot go: coordinate smoothing (a
// 10 Mbp window gives halfbands of ~235 genes and weights that differ for
// every gene, so no common column exists), and genomes whose row does not
// fit in shared memory (60,000 genes are 240 KB).
//
// What bounds it on the H100: the operations.  On the coordinates chunk
// (32768 x 8448, ~1.12 M nonzero band entries) the smooth is ~73 GFLOP,
// ~1.1 ms at the 67 TFLOP/s f32 CUDA-core rate, against ~2.2 GB of x and y
// (~0.66 ms).  Tensor cores are no route: TF32 keeps 10 mantissa bits
// against the residual's rtol = atol = 2e-5, and 3xTF32 would triple the
// products of a dense tile that is already ~2.3x wider than the band's
// nonzeros, landing on the CUDA-core bound it would replace.  So the design
// keeps the FMA pipe fed from shared memory, against what held the earlier
// design back (each thread loaded its own float4 of weights through L1, the
// block's 8 warps the same ones; a tile summed its whole tap span; staging
// was scalar with a division an element and not overlapped):
//   * A block computes 64 rows x 128 genes with 8 warps; a warp 32 rows x 32
//     genes; a thread 4 rows x 8 consecutive genes (32 accumulators).  The
//     lanes of a warp span rows at the same genes, so a float4 of weights
//     is read by every lane of a quarter warp at once, and one weight feeds
//     4 rows: per 4 taps a thread loads 8 float4s of weights and 4 of x for
//     128 FMAs.  x slides through registers (three float4s a row).
//   * The weights come from shared memory, staged by 16-byte cp.async in
//     chunks of 32 taps, double-buffered: the next chunk's copy overlaps the
//     current chunk's FMAs, and a whole chunk's taps run unrolled, the x
//     window rotating through registers.  Staging from L2 is what limits the kernel
//     (timed without its FMAs it keeps a third of its time on the
//     coordinates chunk and two thirds at 60,000 genes), and the weights
//     are most of it, so the block's two row halves share each staged
//     chunk.  x is staged per chunk of at most 128 taps, by 16-byte
//     cp.async where rows are 16-byte aligned (G a multiple of 4) and
//     4-byte ones otherwise, with zero fill outside the genome and past the
//     last row.  A row's staged stride is 4 mod 8 floats, so the x loads of
//     a quarter warp hit eight distinct bank groups.
//   * Each warp sums only its own 32 genes' nonzero taps (host-computed,
//     multiples of 4: 155.7 on average on the coordinates chunk against
//     176.1 for 128-gene tiles and 133 nonzeros a gene); the block stages
//     the union.  Taps are summed in order of e for each output.
//
// Band layout: band4 of band_smooth.cuh (rows e in [0, 2 t4 + 4) weight
// x[g + e - t4] for y[g], zero-padded to round4(G) columns), read from
// device memory.
#include <cuda_runtime.h>

#include "band_smooth.cuh"

namespace icnv {

constexpr int kTileG = 128;                 // genes a block computes
constexpr int kWarpG = 32;                  // genes a warp computes
constexpr int kGenOut = 8;                  // genes a thread computes
constexpr int kRowsPerThread = 4;
constexpr int kWarpRows = 32;               // rows a warp computes
constexpr int kRows = 64;                   // rows a block computes
constexpr int kGeneralThreads = 256;        // 8 warps
constexpr int kWChunk = 32;                 // taps of weights staged at a time
constexpr int kXChunk = 128;                // taps of x staged at a time (max)

// Floats of a staged x row: the tile, a chunk of taps, one float4 of slack
// for the sliding window, rounded to 4 mod 8 (conflict-free float4 loads).
__host__ __device__ inline int general_stride(int chunk) {
  const int w = round4(kTileG + chunk + 4);
  return w % 8 == 4 ? w : w + 4;
}

__host__ __device__ inline size_t general_smem_bytes(int xchunk) {
  return sizeof(float) * ((size_t)kRows * general_stride(xchunk) +
                          2 * (size_t)kWChunk * kTileG);
}

// cp.async of `bytes` (4 or 16) from src, or zeros if !valid.
template <int kBytes>
__device__ __forceinline__ void cp_async_zfill(void* smem, const void* src,
                                               bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = valid ? kBytes : 0;
  if constexpr (kBytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
                 "l"(src), "r"(n));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
                 "l"(src), "r"(n));
}

__global__ void __launch_bounds__(kGeneralThreads, 2)
smooth_general_kernel(const float* __restrict__ x,
                      const float* __restrict__ band4,
                      const int* __restrict__ tap_lo,
                      const int* __restrict__ tap_hi,
                      const int* __restrict__ warp_taps,
                      float* __restrict__ y, int ldy, int C, int G, int t4,
                      int xchunk, int vec) {
  extern __shared__ float4 smem4[];
  const int SW = general_stride(xchunk);
  float* xs = reinterpret_cast<float*>(smem4);  // [kRows][SW]
  float* ws = xs + (size_t)kRows * SW;          // [2][kWChunk][kTileG]
  const int Gr = round4(G);
  const int tile = blockIdx.x;
  const int g0 = tile * kTileG;
  const int r0 = blockIdx.y * kRows;
  const int e_lo = tap_lo[tile];
  const int e_hi = tap_hi[tile];
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int wg = warp & 3;                 // genes of the warp
  const int wr = (warp >> 2) * kWarpRows;  // first row of the warp
  const int lg = lane & 3;                 // gene group of the lane
  const int lr = wr + (lane >> 2);         // rows lr + 8 i of the lane
  const int lgo = wg * kWarpG + lg * kGenOut;  // first gene, in the tile
  const int wi = g0 / kWarpG + wg;
  const int wt = wi < (Gr + kWarpG - 1) / kWarpG ? warp_taps[wi] : 0;
  const int w_lo = wt & 0xFFFF;
  const int w_hi = wt >> 16;
  float acc[kRowsPerThread][kGenOut];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
    for (int j = 0; j < kGenOut; ++j) acc[i][j] = 0.0f;

  for (int xc0 = e_lo; xc0 < e_hi; xc0 += xchunk) {
    const int xc1 = min(xc0 + xchunk, e_hi);
    // staged column c holds x[:, gx0 + c]
    const int gx0 = g0 + xc0 - t4;
    const int width = kTileG + (xc1 - xc0) + 4;
    __syncthreads();  // the previous x chunk's reads are done
    if (vec) {
      const int w4 = width / 4;
      for (int i = tid; i < kRows * w4; i += kGeneralThreads) {
        const int r = i / w4;
        const int c = (i - r * w4) * 4;
        const int gx = gx0 + c;
        const int row = r0 + r;
        const bool ok = row < C && gx >= 0 && gx + 4 <= G;
        cp_async_zfill<16>(xs + r * SW + c,
                           ok ? x + (size_t)row * G + gx : x, ok);
      }
    } else {
      for (int i = tid; i < kRows * width; i += kGeneralThreads) {
        const int r = i / width;
        const int c = i - r * width;
        const int gx = gx0 + c;
        const int row = r0 + r;
        const bool ok = row < C && gx >= 0 && gx < G;
        cp_async_zfill<4>(xs + r * SW + c, ok ? x + (size_t)row * G + gx : x,
                          ok);
      }
    }
    const int nw = (xc1 - xc0 + kWChunk - 1) / kWChunk;
    auto stage_w = [&](int k) {
      const int c0 = xc0 + k * kWChunk;
      const int n = min(kWChunk, xc1 - c0);
      float* dst = ws + (size_t)(k & 1) * kWChunk * kTileG;
      for (int i = tid; i < n * (kTileG / 4); i += kGeneralThreads) {
        const int e = i / (kTileG / 4);
        const int c = (i - e * (kTileG / 4)) * 4;
        const bool ok = g0 + c < Gr;
        cp_async_zfill<16>(dst + e * kTileG + c,
                           ok ? band4 + (size_t)(c0 + e) * Gr + g0 + c : band4,
                           ok);
      }
      asm volatile("cp.async.commit_group;\n" ::);
    };
    stage_w(0);
    int e_cur = -1;  // the tap the window a, b of each row starts at
    float4 a[kRowsPerThread], b[kRowsPerThread];
    for (int k = 0; k < nw; ++k) {
      if (k + 1 < nw) {
        stage_w(k + 1);
        asm volatile("cp.async.wait_group 1;\n" ::);
      } else {
        asm volatile("cp.async.wait_group 0;\n" ::);
      }
      __syncthreads();
      const int c0 = xc0 + k * kWChunk;
      const int es = max(c0, w_lo);
      const int ee = min(min(c0 + kWChunk, xc1), w_hi);
      if (es < ee) {
        const float* wk = ws + (size_t)(k & 1) * kWChunk * kTileG + lgo;
        const float* xr = xs + lr * SW + lgo - xc0;  // + e: tap e's window
        if (es != e_cur) {
#pragma unroll
          for (int i = 0; i < kRowsPerThread; ++i) {
            a[i] = *reinterpret_cast<const float4*>(xr + 8 * i * SW + es);
            b[i] = *reinterpret_cast<const float4*>(xr + 8 * i * SW + es + 4);
          }
        }
        // taps e..e+3 of the thread's outputs; the window a, b slides on
        auto taps4 = [&](int e) {
          float4 c[kRowsPerThread];
#pragma unroll
          for (int i = 0; i < kRowsPerThread; ++i)
            c[i] = *reinterpret_cast<const float4*>(xr + 8 * i * SW + e + 8);
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            const float* wr = wk + (e + kk - c0) * kTileG;
            const float4 u = *reinterpret_cast<const float4*>(wr);
            const float4 v = *reinterpret_cast<const float4*>(wr + 4);
            const float w[8] = {u.x, u.y, u.z, u.w, v.x, v.y, v.z, v.w};
#pragma unroll
            for (int i = 0; i < kRowsPerThread; ++i) {
              const float win[12] = {a[i].x, a[i].y, a[i].z, a[i].w,
                                     b[i].x, b[i].y, b[i].z, b[i].w,
                                     c[i].x, c[i].y, c[i].z, c[i].w};
#pragma unroll
              for (int j = 0; j < kGenOut; ++j)
                acc[i][j] = fmaf(w[j], win[kk + j], acc[i][j]);
            }
          }
#pragma unroll
          for (int i = 0; i < kRowsPerThread; ++i) {
            a[i] = b[i];
            b[i] = c[i];
          }
        };
        if (es == c0 && ee == c0 + kWChunk) {
          // a whole chunk, unrolled: the window rotates through registers
#pragma unroll
          for (int e = 0; e < kWChunk; e += 4) taps4(c0 + e);
        } else {
#pragma unroll 3
          for (int e = es; e < ee; e += 4) taps4(e);
        }
        e_cur = ee;
      }
      __syncthreads();  // this chunk's buffer may be staged again
    }
  }
  const int g = g0 + lgo;
  if (g >= G) return;
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int row = r0 + lr + 8 * i;
    if (row >= C) continue;
    float* dst = y + (size_t)row * ldy + g;
    const bool v4 = (ldy & 3) == 0;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (v4 && g + 4 * h + 4 <= G) {
        *reinterpret_cast<float4*>(dst + 4 * h) =
            make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2],
                        acc[i][4 * h + 3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (g + 4 * h + j < G) dst[4 * h + j] = acc[i][4 * h + j];
      }
    }
  }
}

}  // namespace icnv

// x: [C, G] f32; band4: [2 t4 + 4, round4(G)] (band_smooth.cuh); tap_lo /
// tap_hi: [ceil(round4(G) / 128)] multiples of 4 in [0, 2 t4 + 4], each gene
// tile's taps with a nonzero weight; max_span: the largest tap_hi - tap_lo
// (any span: the kernel stages it in chunks); warp_taps:
// [ceil(round4(G) / 32)] each 32-gene run's nonzero taps, lo | hi << 16,
// within its tile's; y: C rows of stride ldy (>= G); C <= 65535 * 64.
extern "C" int ic_smooth_general(const float* x, const float* band4,
                                 const int* tap_lo, const int* tap_hi,
                                 const int* warp_taps, int max_span, float* y,
                                 int ldy, int C, int G, int t4, void* stream) {
  using namespace icnv;
  if (C < 0 || G <= 0 || t4 < 0 || t4 % 4 || ldy < G || max_span < 0 ||
      max_span % 4 || max_span > 2 * t4 + 4 || 2 * t4 + 4 > 0xFFFF ||
      (C + kRows - 1) / kRows > 65535)  // gridDim.y
    return static_cast<int>(cudaErrorInvalidValue);
  if (C == 0) return 0;
  const int xchunk = min(max_span, kXChunk);
  const size_t smem = general_smem_bytes(xchunk);
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
  const int vec = G % 4 == 0 && reinterpret_cast<size_t>(x) % 16 == 0;
  const dim3 grid((round4(G) + kTileG - 1) / kTileG, (C + kRows - 1) / kRows);
  smooth_general_kernel<<<grid, kGeneralThreads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      x, band4, tap_lo, tap_hi, warp_taps, y, ldy, C, G, t4, xchunk, vec);
  return static_cast<int>(cudaGetLastError());
}
