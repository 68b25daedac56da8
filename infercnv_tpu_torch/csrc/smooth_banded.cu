// Banded smooth along the gene axis: y[C, G] = x[C, G] . W, f32.
//
// Replaces two TPU kernels of infercnv_tpu/ops/smoothing.py, both launched
// by _apply_banded_pallas_k256: _smooth_kernel_k256, which applies the
// operator as 66 K=256 MXU contractions against zero-padded, half-shifted
// 128x128 blocks, and _smooth_kernel_k256_bf16, the same product with bf16
// operands and f32 accumulation (EngineConfig.matmul_dtype="bfloat16").  On
// the H100 the f32 product has no tensor-core path (TF32 would lose the
// reference's 1e-5 parity), so the work is the band's nonzeros, one FMA
// each, on the CUDA cores: 0.41 GFLOP for the 256 reference cells x 8448
// genes of the main path (6.1 us at 67 TFLOP/s) against 17 MB moved (5.2
// us at 3.35 TB/s).  The bf16 variant rounds each x to bf16 as it is
// staged; the caller passes bf16-rounded weights, so every product is exact
// in f32 and only the f32 sums differ from the reference's MXU result.
//
// The design is the fused residual kernel's smooth (residual_fused.cu),
// on its row plan (ops/smoothing.py RowPlan, and SpanPlan for the spans):
//   * The row is laid out with a halfband of zeros between chromosomes, so
//     every gene whose column is the band's common column cut to its
//     chromosome (times a scale, for the renormalised ends) is smoothed by
//     one 8-output item on the common column (smooth8 of band_smooth.cuh,
//     shared with the fused kernel): no pass of its own for the genes near
//     chromosome ends.  Other columns ("general" genes) are read from band4
//     over their nonzero taps.
//   * A row is split over blocks: each block takes a span of kSpan
//     coordinates of the gapped row (one item a thread), staged with its
//     halo of t4 coordinates either side.  [256, 8448] is then 2560 blocks
//     (the earlier design, one block a row, had 256: two an SM); no barrier
//     separates tiles of a row, and a block's shared memory is 9 KB.
//   * The window is read and the outputs written 4 coordinates a thread and
//     step, as float4s where all 4 are genes of a 16-byte aligned row, the
//     genes found by walking the segment starts; an output stays in shared
//     memory until the store.
//   * With bf16 weights a scaled item's weights are bf16(scale * common32),
//     as the fused kernel's bf16 pass forms them, one rounding each; a block
//     of the bf16 kernel smooths kBf16Rows rows of its span, so each weight
//     is rounded once for all of them.
// The caller allocates y.
#include <cuda_runtime.h>
#include <stdint.h>

#include "band_smooth.cuh"

namespace icnv {

constexpr int kSpanThreads = 128;              // threads a block
constexpr int kSpan = kGroup * kSpanThreads;   // coordinates a block
// Rows a block of the bf16 kernel smooths: each bf16(scale * common32)
// weight of a scaled item is rounded once for all of them.
constexpr int kBf16Rows = 4;

// The band as this kernel reads it: the row plan (RowBand of
// residual_fused.cu, the same arrays) and the spans of kSpan coordinates.
struct SpanBand {
  const float* __restrict__ band4;     // band_smooth.cuh's layout
  const float* __restrict__ common;    // its common column
  const float* __restrict__ common32;  // the common column of the f32 band
  const int* __restrict__ seg;         // [nseg + 1] segment starts, then G
  const int* __restrict__ items;       // (q << 9) | (scaled << 8) | mask
  const float* __restrict__ iscale;    // [n_items * 8] the items' scales
  const int* __restrict__ sitems;      // bf16 scaled items
  const float* __restrict__ sscale;    // their scales
  const int2* __restrict__ general;    // (gene, coordinate)
  const int* __restrict__ gtaps;       // taps, lo | hi << 16
  // [nspan + 1] the first item, bf16 scaled item and general gene of each
  // span (then their numbers), and [nspan] the segment of each span's
  // first staged coordinate max(s0 - t4, 0)
  const int* __restrict__ span_items;
  const int* __restrict__ span_sitems;
  const int* __restrict__ span_general;
  const int* __restrict__ span_seg;
  int c_lo, c_hi, gap, nseg, span, nspan;
};

// A thread's walk along the segments, for coordinates that never
// decrease: the segment s whose genes' coordinates start at cs, its end
// gene ge, and the next segment's first coordinate nxt (INT_MAX past the
// last).
struct SegWalk {
  int s, cs, ge, nxt;
  __device__ __forceinline__ void set(const SpanBand& bd, int s_) {
    s = s_;
    cs = __ldg(bd.seg + s) + bd.gap * s;
    ge = __ldg(bd.seg + s + 1);
    nxt = s + 1 < bd.nseg ? ge + bd.gap * (s + 1) : 0x7FFFFFFF;
  }
  // to the segment of coordinate c (the last one starting at or before c)
  __device__ __forceinline__ void to(const SpanBand& bd, int c) {
    while (nxt <= c) set(bd, s + 1);
  }
};

// The genes of the 4 coordinates c .. c + 3 (c a multiple of 4, c + 3 >= 0):
// g[j] the gene, or -1 in a gap, before the row or past it.  They lie in
// one segment: segments are separated by gaps of t4 >= 4 coordinates, or
// there is one.  Returns whether all 4 are genes.
__device__ __forceinline__ bool genes4(const SpanBand& bd, SegWalk& w, int c,
                                       int (&g)[4]) {
  w.to(bd, c + 3);
  const int g0 = c - bd.gap * w.s;
  bool all = true;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const bool in = c + j >= w.cs && g0 + j < w.ge && c + j >= 0;
    g[j] = in ? g0 + j : -1;
    all &= in;
  }
  return all;
}

// The 8 outputs of an item into res (the coordinates of its mask), o its
// first coordinate in the span.
__device__ __forceinline__ void put_outputs(float* res, int o, int mask,
                                            const float (&acc)[kGroup]) {
#pragma unroll
  for (int j = 0; j < kGroup; ++j)
    if (mask & (1 << j)) res[o + j] = acc[j];
}

// 8 outputs at coordinate o of R rows (windows win + r * ws) of a bf16
// scaled item: weight bf16(s[j] * cw[e]) (f32 product), as taps4_scaled
// forms it, but rounded once for the R rows:
//   acc[r][j] = sum_{e in [c_lo, c_hi)} bf16(s[j] * cw[e]) * x_r(slot o + j + e)
// taps summed in order of e, as smooth8 sums them.
template <int R>
__device__ inline void smooth8_scaled_rows(const float* win, int ws,
                                           const float* cw, int c_lo,
                                           int c_hi, int o,
                                           const float (&s)[kGroup],
                                           float (&acc)[R][kGroup]) {
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int j = 0; j < kGroup; ++j) acc[r][j] = 0.0f;
  const float4* cw4 = reinterpret_cast<const float4*>(cw);
  for (int e0 = c_lo; e0 < c_hi; e0 += 4) {
    const float4 c4 = cw4[e0 >> 2];
    const float c[4] = {c4.x, c4.y, c4.z, c4.w};
    float w[4][kGroup];
#pragma unroll
    for (int k = 0; k < 4; ++k)
#pragma unroll
      for (int j = 0; j < kGroup; ++j) w[k][j] = round_bf16(__fmul_rn(s[j], c[k]));
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float* row = win + r * ws;
      const float4 a = ld_row4(row, o + e0);
      const float4 b = ld_row4(row, o + e0 + 4);
      const float4 d = ld_row4(row, o + e0 + 8);
      const float x[12] = {a.x, a.y, a.z, a.w, b.x, b.y,
                           b.z, b.w, d.x, d.y, d.z, d.w};
#pragma unroll
      for (int k = 0; k < 4; ++k)
#pragma unroll
        for (int j = 0; j < kGroup; ++j)
          acc[r][j] = fmaf(w[k][j], x[k + j], acc[r][j]);
    }
  }
}

// Span k of rows r0 .. r0 + R - 1 (those below C) by the block, in shared
// memory smem (span_smem_bytes): R = kBf16Rows for the bf16 variant (two
// kernels, as the TPU has two bodies), else 1.  vec: x's and y's rows start
// 16-byte aligned (float4 loads and stores).
template <bool kBf16>
__device__ __forceinline__ void smooth_span(const float* __restrict__ x,
                                            const SpanBand& bd,
                                            float* __restrict__ y, int C,
                                            int G, int t4, int k, int r0,
                                            bool vec, float* smem) {
  constexpr int R = kBf16 ? kBf16Rows : 1;
  const int E = band_rows(t4);
  const int W = swz_row_len(kSpan, t4);
  float* csm = smem;
  float* c32 = csm + E;
  float* win = c32 + (kBf16 ? E : 0);  // row r: win + r * W; slot p holds
                                       // coordinate s0 - t4 + p (swizzled)
  float* res = win + R * W;  // row r: res + r * kSpan, by coordinate - s0
  const int tid = threadIdx.x;
  const int s0 = k * kSpan;
  const int nr = min(R, C - r0);
  for (int i = tid; i < E; i += kSpanThreads) {
    csm[i] = bd.common[i];
    if (kBf16) c32[i] = bd.common32[i];
  }
  // the windows, 4 coordinates a step (float4 loads where all 4 are genes)
  SegWalk sw;
  sw.set(bd, bd.span_seg[k]);
  for (int q = tid; q < W / 4; q += kSpanThreads) {
    const int c = s0 - t4 + 4 * q;
    int g[4] = {-1, -1, -1, -1};
    bool all = false;
    if (c + 3 >= 0 && c < bd.span) all = genes4(bd, sw, c, g) && vec;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      const float* xr = x + (size_t)(r0 + r) * G;
      if (r < nr) {
        if (all) {
          const float4 u = __ldg(reinterpret_cast<const float4*>(xr + g[0]));
          v[0] = u.x;
          v[1] = u.y;
          v[2] = u.z;
          v[3] = u.w;
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (g[j] >= 0) v[j] = __ldg(xr + g[j]);
        }
      }
      if (kBf16) {
#pragma unroll
        for (int j = 0; j < 4; ++j) v[j] = round_bf16(v[j]);
      }
      st_row4(win + r * W, 4 * q, make_float4(v[0], v[1], v[2], v[3]));
    }
  }
  __syncthreads();

  // one item a thread: a common item (its sum scaled if its scaled bit is
  // set), else a bf16 scaled item; then the general genes
  const int i0 = bd.span_items[k];
  const int nc = bd.span_items[k + 1] - i0;
  const int si0 = kBf16 ? bd.span_sitems[k] : 0;
  const int ns = kBf16 ? bd.span_sitems[k + 1] - si0 : 0;
  float sc[kGroup];
  if (tid < nc) {
    const int it = bd.items[i0 + tid];
    const int o = (it >> 9) * kGroup - s0;
    if (it & 0x100) item_scales(bd.iscale, i0 + tid, sc);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float acc[kGroup];
      smooth8<false>(win + r * W, csm, bd.c_lo, bd.c_hi, o, sc, acc);
      if (it & 0x100) {
#pragma unroll
        for (int j = 0; j < kGroup; ++j) acc[j] = __fmul_rn(acc[j], sc[j]);
      }
      put_outputs(res + r * kSpan, o, it & 0xFF, acc);
    }
  } else if (kBf16 && tid < nc + ns) {
    const int i = si0 + tid - nc;
    const int it = bd.sitems[i];
    const int o = (it >> 9) * kGroup - s0;
    float acc[R][kGroup];
    item_scales(bd.sscale, i, sc);
    smooth8_scaled_rows<R>(win, W, c32, bd.c_lo, bd.c_hi, o, sc, acc);
#pragma unroll
    for (int r = 0; r < R; ++r) put_outputs(res + r * kSpan, o, it & 0xFF, acc[r]);
  }
  const int g0 = bd.span_general[k];
  const int ng = bd.span_general[k + 1] - g0;
  const int Gr = round4(G);
  for (int i = tid; i < ng; i += kSpanThreads) {
    const int2 gc = bd.general[g0 + i];
    const int tp = bd.gtaps[g0 + i];
    const int o = gc.y - s0;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float v = 0.0f;
      for (int e = tp & 0xFFFF; e < (tp >> 16); ++e)
        v = fmaf(__ldg(bd.band4 + (size_t)e * Gr + gc.x), win[r * W + swz(o + e)], v);
      res[r * kSpan + o] = v;
    }
  }
  __syncthreads();

  // the outputs, 4 coordinates a step (float4 stores where all 4 are genes)
  sw.set(bd, bd.span_seg[k]);
  for (int q = tid; q < kSpan / 4; q += kSpanThreads) {
    const int c = s0 + 4 * q;
    if (c >= bd.span) break;
    int g[4];
    const bool all = genes4(bd, sw, c, g) && vec;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (r >= nr) break;
      float* yr = y + (size_t)(r0 + r) * G;
      const float4 v = reinterpret_cast<const float4*>(res + r * kSpan)[q];
      if (all) {
        *reinterpret_cast<float4*>(yr + g[0]) = v;
      } else {
        const float u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (g[j] >= 0) yr[g[j]] = u[j];
      }
    }
  }
}

// Block blockIdx.x smooths span blockIdx.x % nspan of its rows (group
// blockIdx.x / nspan of R).
template <bool kBf16>
__global__ void __launch_bounds__(kSpanThreads)
smooth_banded_kernel(const float* __restrict__ x, SpanBand bd,
                     float* __restrict__ y, int C, int G, int t4, bool vec) {
  extern __shared__ float4 smem4[];
  constexpr int R = kBf16 ? kBf16Rows : 1;
  smooth_span<kBf16>(x, bd, y, C, G, t4, blockIdx.x % bd.nspan,
                     (blockIdx.x / bd.nspan) * R, vec,
                     reinterpret_cast<float*>(smem4));
}

// Shared memory of a block: the common column (and its f32 form for bf16),
// each row's window and outputs.
__host__ __device__ inline size_t span_smem_bytes(int t4, bool bf16) {
  const int R = bf16 ? kBf16Rows : 1;
  return sizeof(float) * ((bf16 ? 2 : 1) * (size_t)band_rows(t4) +
                          (size_t)R * (swz_row_len(kSpan, t4) + kSpan));
}

}  // namespace icnv

// band4 ... span: the row plan as struct SpanBand (ops/smoothing.py
// RowPlan and SpanPlan; span_coords: the plan's kSpan, which must be this
// build's); t4: the halfband rounded up to a multiple of 4.  bf16: round x to bf16 as it is read (the weights
// must be bf16-rounded).
extern "C" int ic_smooth_banded(
    const float* x, const float* band4, const float* common,
    const float* common32, int c_lo, int c_hi, int gap, const int* seg,
    int nseg, const int* items, const float* iscale, const int* sitems,
    const float* sscale, const int* general, const int* gtaps, int span,
    const int* span_items, const int* span_sitems, const int* span_general,
    const int* span_seg, int nspan, int span_coords, float* y, int C, int G,
    int t4, int bf16, void* stream) {
  using namespace icnv;
  if (C < 0 || G <= 0 || t4 < 0 || t4 % 4 || c_lo < 0 || c_lo % 4 ||
      c_hi < c_lo || c_hi % 4 || c_hi > band_rows(t4) || gap < 0 || gap % 4 ||
      nseg < 1 || span < G || span_coords != kSpan ||
      nspan != (span + kSpan - 1) / kSpan)
    return static_cast<int>(cudaErrorInvalidValue);
  if (C == 0) return 0;
  const int R = bf16 ? kBf16Rows : 1;
  const long long grid = static_cast<long long>((C + R - 1) / R) * nspan;
  if (grid > 0x7FFFFFFFLL)
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  const size_t smem = span_smem_bytes(t4, bf16 != 0);
  if (smem > (size_t)optin) return static_cast<int>(cudaErrorInvalidValue);
  auto kern = bf16 ? smooth_banded_kernel<true> : smooth_banded_kernel<false>;
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const SpanBand bd{band4,
                    common,
                    common32,
                    seg,
                    items,
                    iscale,
                    sitems,
                    sscale,
                    reinterpret_cast<const int2*>(general),
                    gtaps,
                    span_items,
                    span_sitems,
                    span_general,
                    span_seg,
                    c_lo,
                    c_hi,
                    gap,
                    nseg,
                    span,
                    nspan};
  kern<<<static_cast<int>(grid), kSpanThreads, smem,
         static_cast<cudaStream_t>(stream)>>>(
      x, bd, y, C, G, t4,
      G % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
          reinterpret_cast<uintptr_t>(y) % 16 == 0);
  return static_cast<int>(cudaGetLastError());
}
