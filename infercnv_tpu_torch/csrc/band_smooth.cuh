// Shared device routines of the row kernels (residual_fused.cu,
// smooth_banded.cu and smooth_general.cu): the band's layout, bf16 rounding,
// a block-wide row sum, and the 8-output smooth of a swizzled row that the
// fused residual (kernel 1) and the one-row smooth (kernels 3 and 4) both
// run on the row plan of ops/smoothing.py (RowPlan).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace icnv {

// Outputs a thread computes in the smooth: one item of 8 coordinates.
constexpr int kGroup = 8;

__host__ __device__ inline int round4(int v) { return (v + 3) & ~3; }

// v rounded to the nearest bf16 (ties to even, as torch's and JAX's casts
// round), back in f32.  The bf16 smooth rounds both operands so: a product
// of two bf16 values is exact in f32, so only the f32 sums round.
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// The kernels' band layout: band4[e * round4(G) + g] weights x[g + e - t4]
// for y[g], e in [0, 2 * t4 + 4), t4 = round4(t); it is the [2t+1, G] band
// shifted down by t4 - t rows and zero-padded (infercnv_tpu_torch/ops/
// smoothing.py kernel_band).
__host__ __device__ inline int band_rows(int t4) { return 2 * t4 + 4; }

// Float4 slot f of a swizzled row: f ^ bit 3 of f.  Threads that read
// float4s 2 slots apart (8-output items) then hit eight distinct bank
// groups in every quarter warp.
__device__ __forceinline__ int swz_slot(int f) { return f ^ ((f >> 3) & 1); }
__device__ __forceinline__ int swz(int i) {
  return (swz_slot(i >> 2) << 2) | (i & 3);
}
__device__ __forceinline__ float4 ld_row4(const float* row, int i) {
  return reinterpret_cast<const float4*>(row)[swz_slot(i >> 2)];
}
__device__ __forceinline__ void st_row4(float* row, int i, float4 v) {
  reinterpret_cast<float4*>(row)[swz_slot(i >> 2)] = v;
}

// A swizzled row of `span` coordinates: the coordinate o in slot
// swz(o + t4), zeros in the gaps and pads.  The smooth of coordinate o
// reads slots o + [c_lo, c_hi) (and a float4 beyond); a multiple of 64
// floats, so the swizzle stays inside the row.
__host__ __device__ inline int swz_row_len(int span, int t4) {
  return ((span + 7) / 8 * 8 + 2 * t4 + 16 + 63) / 64 * 64;
}

// Four taps e..e+3 of 8 outputs: weights w (one a tap) on the window
// a, b, c (x at slots o + e .. o + e + 11).
__device__ __forceinline__ void taps4(float4 w4, float4 a, float4 b, float4 c,
                                      float (&acc)[kGroup]) {
  const float w[4] = {w4.x, w4.y, w4.z, w4.w};
  const float win[12] = {a.x, a.y, a.z, a.w, b.x, b.y,
                         b.z, b.w, c.x, c.y, c.z, c.w};
#pragma unroll
  for (int k = 0; k < 4; ++k)
#pragma unroll
    for (int j = 0; j < kGroup; ++j) acc[j] = fmaf(w[k], win[k + j], acc[j]);
}

// The same with a weight per output: bf16(s[j] * w[k]) (f32 product), the
// bf16 band's weights of a scaled gene.
__device__ __forceinline__ void taps4_scaled(float4 w4, float4 a, float4 b,
                                             float4 c, const float (&s)[kGroup],
                                             float (&acc)[kGroup]) {
  const float w[4] = {w4.x, w4.y, w4.z, w4.w};
  const float win[12] = {a.x, a.y, a.z, a.w, b.x, b.y,
                         b.z, b.w, c.x, c.y, c.z, c.w};
#pragma unroll
  for (int k = 0; k < 4; ++k)
#pragma unroll
    for (int j = 0; j < kGroup; ++j)
      acc[j] = fmaf(round_bf16(__fmul_rn(s[j], w[k])), win[k + j], acc[j]);
}

// Taps e0..e0+3 of 8 outputs on the window a, b, c.
template <bool kScaled>
__device__ __forceinline__ void taps4_of(const float4* cw4, int e0, float4 a,
                                         float4 b, float4 c,
                                         const float (&s)[kGroup],
                                         float (&acc)[kGroup]) {
  if (kScaled)
    taps4_scaled(cw4[e0 >> 2], a, b, c, s, acc);
  else
    taps4(cw4[e0 >> 2], a, b, c, acc);
}

// 8 outputs at coordinate o (a multiple of 8) on the column cw:
//   acc[j] = sum_{e in [c_lo, c_hi)} cw[e] * x(slot o + j + e)
// (kScaled: weight bf16(s[j] * cw[e])).  Taps summed in order of e, sixteen
// a step: four float4s of x and four of cw per 128 FMAs.
template <bool kScaled>
__device__ inline void smooth8(const float* row, const float* cw, int c_lo,
                               int c_hi, int o, const float (&s)[kGroup],
                               float (&acc)[kGroup]) {
#pragma unroll
  for (int j = 0; j < kGroup; ++j) acc[j] = 0.0f;
  const float4* cw4 = reinterpret_cast<const float4*>(cw);
  float4 a = ld_row4(row, o + c_lo);
  float4 b = ld_row4(row, o + c_lo + 4);
  int e0 = c_lo;
  for (; e0 + 16 <= c_hi; e0 += 16) {
    const float4 c = ld_row4(row, o + e0 + 8);
    const float4 d = ld_row4(row, o + e0 + 12);
    const float4 f = ld_row4(row, o + e0 + 16);
    const float4 h = ld_row4(row, o + e0 + 20);
    taps4_of<kScaled>(cw4, e0, a, b, c, s, acc);
    taps4_of<kScaled>(cw4, e0 + 4, b, c, d, s, acc);
    taps4_of<kScaled>(cw4, e0 + 8, c, d, f, s, acc);
    taps4_of<kScaled>(cw4, e0 + 12, d, f, h, s, acc);
    a = f;
    b = h;
  }
  for (; e0 < c_hi; e0 += 4) {
    const float4 c = ld_row4(row, o + e0 + 8);
    taps4_of<kScaled>(cw4, e0, a, b, c, s, acc);
    a = b;
    b = c;
  }
}

// The 8 scales of item i (of scales: iscale or sscale).
__device__ __forceinline__ void item_scales(const float* scales, int i,
                                            float (&s)[kGroup]) {
  const float4* p = reinterpret_cast<const float4*>(scales) + 2 * i;
  const float4 u = __ldg(p);
  const float4 v = __ldg(p + 1);
  s[0] = u.x; s[1] = u.y; s[2] = u.z; s[3] = u.w;
  s[4] = v.x; s[5] = v.y; s[6] = v.z; s[7] = v.w;
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
