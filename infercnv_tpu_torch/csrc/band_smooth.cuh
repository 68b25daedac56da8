// Shared device routines of the row kernels (smooth_banded.cu and
// residual_fused.cu): the band's layout, bf16 rounding and a block-wide row
// sum, and the one-row banded smooth of smooth_banded.cu (band_smooth_row).
// residual_fused.cu keeps its own register-blocked smooth on a swizzled row
// (8 outputs a thread); the one-row kernels of the reference path (kernels 3
// and 4, ~0.08 ms a launch, once a run) keep the 4-output routine below.
// Both apply the same band and are held to the same plain version.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace icnv {

// Threads per block of the row kernels (one row a block).
constexpr int kThreads = 256;
// Consecutive outputs per thread in the smooth (one float4).
constexpr int kOut = 4;

__host__ __device__ inline int round4(int v) { return (v + 3) & ~3; }

// v rounded to the nearest bf16 (ties to even, as torch's and JAX's casts
// round), back in f32.  The bf16 smooth rounds both operands so: a product
// of two bf16 values is exact in f32, so only the f32 sums round.
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// A row of G values lives in shared memory zero-padded on both sides:
//   [t4 zeros | x[0..G) | zeros up to the stride]
// with t4 = round4(t), so the smooth reads every tap without a bounds check
// and every float4 is 16-byte aligned.  x[g] is at row[t4 + g].
__host__ __device__ inline int row_stride(int G, int t4) {
  return round4(G) + 2 * t4 + 4;
}

// The kernels' band layout: band4[e * round4(G) + g] weights x[g + e - t4]
// for y[g], e in [0, 2 * t4 + 4); it is the [2t+1, G] band shifted down by
// t4 - t rows and zero-padded (infercnv_tpu_torch/ops/smoothing.py
// kernel_band).
__host__ __device__ inline int band_rows(int t4) { return 2 * t4 + 4; }

// The band, as the kernels read it.  Besides band4 (see band_rows): a
// smoothing band's interior columns are all alike, so the kernels also get
// that most common column and the list of "edge" groups, the aligned groups
// of 4 genes with any other column (genes near chromosome ends), with each
// group's place in that list, or -1 for a common group (ops/smoothing.py
// common_column).  Common groups take their weights from a shared-memory copy
// of the column, edge groups from band4; the weights, and so the sums, are
// the same either way.
struct Band {
  const float* __restrict__ band4;   // [band_rows(t4), round4(G)]
  const float* __restrict__ common;  // [band_rows(t4)]
  const int* __restrict__ slot;      // [round4(G) / 4]: place in edges, or -1
  const int* __restrict__ edges;     // [nedge]: the edge groups
  int nedge;
};

// Shared memory of the smooth: the common column, the padded row, and the
// edge groups' results.
__host__ __device__ inline size_t band_smooth_smem_bytes(int G, int t4,
                                                         int nedge) {
  return sizeof(float) * ((size_t)band_rows(t4) + row_stride(G, t4) +
                          (size_t)nedge * kOut);
}

// Zero the pads of a padded row (the x part is filled by the caller).
__device__ inline void zero_row_pads(float* row, int G, int t4) {
  const int P = row_stride(G, t4);
  for (int i = threadIdx.x; i < t4; i += blockDim.x) row[i] = 0.0f;
  for (int i = t4 + G + threadIdx.x; i < P; i += blockDim.x) row[i] = 0.0f;
}

// kOut consecutive outputs g..g+3 (g a multiple of 4):
//   acc[j] = sum_e w[e][g + j] * x[g + j + e - t4]
// with w the common column (kCommon, from shared memory csm) or band4.  The
// thread slides a window of 8 values (two float4) along the row, so one
// shared-memory load and the weights of four taps feed 16 FMAs.  Taps are
// summed in order of e.
template <bool kCommon>
__device__ inline void smooth_group(const float* row,
                                    const float* __restrict__ band4,
                                    const float* csm, int Gr, int E, int g,
                                    float (&acc)[kOut]) {
#pragma unroll
  for (int j = 0; j < kOut; ++j) acc[j] = 0.0f;
  float4 a = *reinterpret_cast<const float4*>(row + g);
  for (int e0 = 0; e0 < E; e0 += 4) {
    float w[4][kOut];
    if constexpr (kCommon) {
      const float4 c = *reinterpret_cast<const float4*>(csm + e0);
      const float cw[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
      for (int k = 0; k < 4; ++k)
#pragma unroll
        for (int j = 0; j < kOut; ++j) w[k][j] = cw[k];
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float4 v = __ldg(reinterpret_cast<const float4*>(
            band4 + (size_t)(e0 + k) * Gr + g));
        w[k][0] = v.x;
        w[k][1] = v.y;
        w[k][2] = v.z;
        w[k][3] = v.w;
      }
    }
    const float4 b = *reinterpret_cast<const float4*>(row + g + e0 + 4);
    const float win[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
    for (int k = 0; k < 4; ++k)
#pragma unroll
      for (int j = 0; j < kOut; ++j)
        acc[j] = fmaf(w[k][j], win[k + j], acc[j]);
    a = b;
  }
}

// Outputs g..g+3 in the tiled pass: a common group is computed here, an
// edge group was computed before the pass and is read from ebuf.
__device__ inline void tile_group(const float* row, const Band& bd,
                                  const float* csm, const float* ebuf, int Gr,
                                  int E, int g, float (&acc)[kOut]) {
  const int s = g < Gr ? bd.slot[g >> 2] : -1;
  if (g < Gr && s < 0) {
    smooth_group<true>(row, bd.band4, csm, Gr, E, g, acc);
    return;
  }
#pragma unroll
  for (int j = 0; j < kOut; ++j) acc[j] = s >= 0 ? ebuf[s * kOut + j] : 0.0f;
}

__device__ inline void store_outputs(float* row, int G, int t4, int g,
                                     const float (&acc)[kOut]) {
  float* dst = row + t4 + g;
  if (g + kOut <= G) {
    *reinterpret_cast<float4*>(dst) = make_float4(acc[0], acc[1], acc[2], acc[3]);
  } else {
#pragma unroll
    for (int j = 0; j < kOut; ++j)
      if (g + j < G) dst[j] = acc[j];
  }
}

// In-place banded smooth of one padded row (see row_stride) in shared memory:
//
//   y[g] = sum_{d=0}^{2t} band[d][g] * x[g + d - t]
//
// (through Band, which carries the same weights; the band is zero across
// chromosome boundaries and renormalised at chromosome ends, see
// ops/layout.py _band_from_kernel).  csm: band_rows(t4) floats of shared
// memory for the common column; ebuf: bd.nedge * kOut floats for the edge
// groups.
//
// First the edge groups are smoothed, spread over all threads, from band4:
// their loads come from L2, and in the tiled pass they would stall the warp
// holding them and, through the barrier, the whole tile (nearly every tile
// holds a chromosome end).  Then the genes are processed in tiles of
// blockDim.x * kOut on the common column alone.  A tile's results stay in
// registers until the next tile has been computed, because that one still
// reads the last t4 values of x in this tile; then they overwrite x.  Two
// register sets alternate, so no staging buffer is needed.  Requires
// t4 + 4 <= blockDim.x * kOut.  The pads stay zero.
__device__ inline void band_smooth_row(float* row, int G, const Band& bd,
                                       int t4, float* csm, float* ebuf) {
  const int Gr = round4(G);
  const int E = band_rows(t4);
  const int TW = blockDim.x * kOut;
  const int ntile = (Gr + TW - 1) / TW;
  const int off = threadIdx.x * kOut;
  for (int i = threadIdx.x; i < E; i += blockDim.x) csm[i] = bd.common[i];
  for (int i = threadIdx.x; i < bd.nedge; i += blockDim.x) {
    float acc[kOut];
    smooth_group<false>(row, bd.band4, csm, Gr, E, bd.edges[i] * kOut, acc);
#pragma unroll
    for (int j = 0; j < kOut; ++j) ebuf[i * kOut + j] = acc[j];
  }
  __syncthreads();
  float acc_a[kOut];
  float acc_b[kOut];
  for (int k = 0; k < ntile; k += 2) {
    tile_group(row, bd, csm, ebuf, Gr, E, k * TW + off, acc_a);
    __syncthreads();
    if (k > 0) store_outputs(row, G, t4, (k - 1) * TW + off, acc_b);
    if (k + 1 < ntile) {
      tile_group(row, bd, csm, ebuf, Gr, E, (k + 1) * TW + off, acc_b);
      __syncthreads();
    }
    store_outputs(row, G, t4, k * TW + off, acc_a);
  }
  if ((ntile & 1) == 0) store_outputs(row, G, t4, (ntile - 1) * TW + off, acc_b);
  __syncthreads();
}

// Block-wide sum of v in a fixed order (deterministic); every thread
// receives the total.  red: 32 floats of shared memory.  blockDim.x must be
// a multiple of 32 and at most 1024.
__device__ inline float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xFFFFFFFFu, v, o);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float s = lane < nw ? red[lane] : 0.0f;
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xFFFFFFFFu, s, o);
  __syncthreads();
  return s;
}

}  // namespace icnv
