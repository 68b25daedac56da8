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
//   4. banded smooth; with the bf16 flag (the reference's
//      matmul_dtype="bfloat16") x is rounded to bf16 first and the caller
//      passes bf16-rounded weights, so every product is exact and only the
//      f32 sums round
//   5. exact row median (radix_select.cuh, shared with median.cu), (v1 + v2)
//      * 0.5 for even G; or the mean with center_mean
//   6. stage-2 bounds, exp2, store f32 / f16 / bf16 (rounded only here);
//      optionally also the denoised f32 residual (values inside
//      mean_ref +- spread become mean_ref), which the engine would otherwise
//      compute in four more passes over the chunk
//
// What bounds it on the H100: with the denoised second output (what the
// engine runs) a 32768 x 8448 u16 chunk moves 0.55 GB in and 2.2 GB out,
// 0.83 ms at 3.35 TB/s; the smooth is 2 x 797148 band nonzeros x 32768 rows
// = 52.2 GFLOP, 0.78 ms at the 67 TFLOP/s f32 CUDA-core rate.  Tensor cores
// are no route: TF32 keeps 10 mantissa bits against the residual's
// rtol = atol = 2e-5, and 3xTF32 would triple the products of a band already
// stored as a dense tile.  So the design works on the FMA pipe and shared
// memory, against what held the earlier design back:
//   * The smooth was bound by shared memory, not FMAs (4 outputs a thread:
//     two shared float4 loads per 16 FMAs) and ran all 108 padded taps.
//     Here each thread computes 8 consecutive outputs from a sliding window
//     of x in registers, sixteen taps a step: four float4s of x and four
//     broadcast float4s of the band's common column feed 128 FMAs.  The
//     loop runs only over the common column's nonzero taps ([c_lo, c_hi),
//     host-computed: 104 of 108 at a window of 101).  This smooth
//     (smooth8, band_smooth.cuh) is shared with the one-row smooth of
//     smooth_banded.cu.
//   * A quarter of the genes (those within a halfband of a chromosome end)
//     have renormalised columns and took a slow pass of their own.  Here
//     the row lies in shared memory with a halfband of zeros between
//     chromosomes (the band's uncoupled segments, ops/smoothing.py
//     row_plan), so the common column cut to a gene's chromosome is what
//     the zeros leave of it, and such a gene's column is that times a scale
//     (host-checked to 2^-20 of its weights): one pass of 8-output items
//     over the whole row, the scaled items' sums scaled.  Genes whose
//     column is no such multiple (other bands) are "general", read from
//     band4 over their nonzero taps.  With bf16 weights a scaled weight is
//     bf16(scale * common32) and no multiple of the bf16 column, so those
//     items are computed in a pass of their own with those weights.  The
//     smooth works in place in rounds of blockDim.x items: a round's
//     results stay in registers until the next round has read its
//     neighbourhood.  Float4 slots are swizzled (slot f ^ bit 3 of f), so
//     threads reading float4s 32 bytes apart hit distinct banks.
//   * The select swept each row five times (four 8-bit passes and the lower
//     middle).  It takes three passes of 11/11/10 bits, scans its histograms
//     with all warps, folds the lower middle into the last pass and merges
//     a thread's equal digits before its shared-memory atomic
//     (radix_select.cuh); and the first pass needs no sweep: the smooth
//     counts each result's top digit as it writes it.  The gaps hold +inf
//     while the select reads the row, which leaves the order statistics
//     below G untouched.
//   * One block a row with 2-byte loads and scalar stores: persistent
//     blocks (as many as fit on the card) walk the rows; counts are read
//     16 bytes a load (rows whose start is not 16-byte aligned, e.g. 8447
//     u16 genes, read their aligned interior so and the few head and tail
//     values one by one); results are stored as float4 (four f16/bf16) with
//     streaming stores.  The next row's counts are not copied ahead: four
//     resident blocks an SM hide the read latency, and a counts buffer would
//     cost one of them.
// What still holds it back (benchmarks/torch_kernel_variants.py, PERF.md):
// the four bound rows (135 KB) come from L2 for every row, since four
// blocks' shared memory leaves L1 too small for them; the select's two
// remaining sweeps; the smooth at about two thirds of the FMA rate.
// The TPU kernel's 128-lane tiles, VMEM budget and zero-padded 384-deep
// block stack do not carry over.
//
// Build without --use_fast_math: log2f / exp2f must stay accurate, and
// flushing subnormals would change the median's keys.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include "band_smooth.cuh"
#include "count_row.cuh"
#include "radix_select.cuh"

namespace icnv {

constexpr int kResThreads = 256;  // threads a block

// The band as this kernel's smooth reads it (ops/smoothing.py RowPlan).
struct RowBand {
  const float* __restrict__ band4;     // band_smooth.cuh's layout
  const float* __restrict__ common;    // its common column
  const float* __restrict__ common32;  // the common column of the f32 band
  const int* __restrict__ seg;         // [nseg + 1] segment starts, then G
  const int* __restrict__ items;       // (q << 9) | (scaled << 8) | mask
  const float* __restrict__ iscale;    // [n_items * 8] the items' scales
  const int* __restrict__ sitems;      // [n_sitems] bf16 scaled items
  const float* __restrict__ sscale;    // [n_sitems * 8] their scales
  const int2* __restrict__ general;    // [n_general] (gene, coordinate)
  const int* __restrict__ gtaps;       // [n_general] taps, lo | hi << 16
  int c_lo, c_hi, gap, nseg, n_items, n_sitems, n_general;
  int span;  // coordinates: G + gap * (nseg - 1)
};

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

// Four outputs at p (aligned to 4 elements), streaming stores.
__device__ __forceinline__ void store4(float* p, float4 v) {
  __stcs(reinterpret_cast<float4*>(p), v);
}
__device__ __forceinline__ void store4(__half* p, float4 v) {
  __half2 a = __floats2half2_rn(v.x, v.y);
  __half2 b = __floats2half2_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<unsigned*>(&a);
  u.y = *reinterpret_cast<unsigned*>(&b);
  __stcs(reinterpret_cast<uint2*>(p), u);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  __nv_bfloat162 a = __floats2bfloat162_rn(v.x, v.y);
  __nv_bfloat162 b = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<unsigned*>(&a);
  u.y = *reinterpret_cast<unsigned*>(&b);
  __stcs(reinterpret_cast<uint2*>(p), u);
}

// Gene -> coordinate (g + gap * its segment): the segment starts (seg) and,
// for each group of 8 genes, the segment of its first gene (grp), both in
// shared memory.  Every segment holds at least 8 genes (row_plan merges
// smaller ones), so 8 consecutive genes cross at most one segment start.
struct SegMap {
  const int* seg;
  const unsigned short* grp;
  int gap;
  // the segment of gene g; next: the start of the following one
  __device__ __forceinline__ int seg_of(int g, int& next) const {
    int s = grp[g >> 3];
    next = seg[s + 1];
    if (g >= next) {
      ++s;
      next = seg[s + 1];
    }
    return s;
  }
  __device__ __forceinline__ int coord(int g) const {
    int next;
    return g + gap * seg_of(g, next);
  }
};

// Item it's outputs into the row (the slots of its mask only: gaps and
// general genes keep theirs), and their top digits into hist (the select's
// first pass) unless it is null.
__device__ __forceinline__ void put_item(float* row, int t4, int it,
                                         const float (&acc)[kGroup],
                                         int* hist) {
  const int o = (it >> 9) * kGroup + t4;
  const int mask = it & 0xFF;
  if (hist != nullptr) add_top_digits(hist, acc, mask);
  if (mask == 0xFF) {
    st_row4(row, o, make_float4(acc[0], acc[1], acc[2], acc[3]));
    st_row4(row, o + 4, make_float4(acc[4], acc[5], acc[6], acc[7]));
  } else {
#pragma unroll
    for (int j = 0; j < kGroup; ++j)
      if (mask & (1 << j)) row[swz(o + j)] = acc[j];
  }
}

// Item i of the common pass: 8 outputs, their sum scaled if its scaled bit
// is set (f32 weights only).
__device__ __forceinline__ int common_item(const float* row, const float* csm,
                                           const RowBand& bd, int i,
                                           float (&acc)[kGroup]) {
  if (i >= bd.n_items) return 0;
  const int it = bd.items[i];
  float s[kGroup];
  smooth8<false>(row, csm, bd.c_lo, bd.c_hi, (it >> 9) * kGroup, s, acc);
  if (it & 0x100) {
    item_scales(bd.iscale, i, s);
#pragma unroll
    for (int j = 0; j < kGroup; ++j) acc[j] = __fmul_rn(acc[j], s[j]);
  }
  return it;
}

// In-place banded smooth of the swizzled row (see RowBand), counting the top
// digit of each result into hist unless it is null:
//   y(g) = sum_e band4[e][g] * x(coordinate(g) + e - t4)
// csm / c32: the common column and its f32 form in shared memory; ebuf: 8
// floats a bf16 scaled item and one a general gene.  The general genes and
// the bf16 scaled items are smoothed first, into ebuf; then the items in
// rounds of blockDim.x; a round's results are written only after the next
// round has been computed, since that one still reads the last t4 values
// of x before it (requires 8 * blockDim.x >= t4 + 8); the ebuf results
// last.
template <bool kBf16>
__device__ inline void smooth_row(float* row, int G, int t4, const RowBand& bd,
                                  const float* csm, const float* c32,
                                  float* ebuf, int* hist) {
  const int tid = threadIdx.x;
  const int T = blockDim.x;
  const int Gr = round4(G);
  float* gbuf = ebuf + kGroup * bd.n_sitems;
  for (int i = tid; i < bd.n_general; i += T) {
    const int2 gc = bd.general[i];
    const int tp = bd.gtaps[i];
    float acc = 0.0f;
    for (int e = tp & 0xFFFF; e < (tp >> 16); ++e)
      acc = fmaf(__ldg(bd.band4 + (size_t)e * Gr + gc.x), row[swz(gc.y + e)],
                 acc);
    gbuf[i] = acc;
  }
  if (kBf16) {
    for (int i = tid; i < bd.n_sitems; i += T) {
      float s[kGroup], acc[kGroup];
      item_scales(bd.sscale, i, s);
      smooth8<true>(row, c32, bd.c_lo, bd.c_hi, (bd.sitems[i] >> 9) * kGroup,
                    s, acc);
      float4* dst = reinterpret_cast<float4*>(ebuf + kGroup * i);
      dst[0] = make_float4(acc[0], acc[1], acc[2], acc[3]);
      dst[1] = make_float4(acc[4], acc[5], acc[6], acc[7]);
    }
  }
  const int nround = (bd.n_items + T - 1) / T;
  float acc[kGroup];
  float prev[kGroup];
  int it_prev = 0;
  for (int k = 0; k < nround; ++k) {
    const int it = common_item(row, csm, bd, k * T + tid, acc);
    __syncthreads();
    if (it_prev) put_item(row, t4, it_prev, prev, hist);
#pragma unroll
    for (int j = 0; j < kGroup; ++j) prev[j] = acc[j];
    it_prev = it;
  }
  if (it_prev) put_item(row, t4, it_prev, prev, hist);
  __syncthreads();
  if (kBf16) {
    for (int i = tid; i < bd.n_sitems; i += T) {
      float acc[kGroup];
#pragma unroll
      for (int j = 0; j < kGroup; ++j) acc[j] = ebuf[kGroup * i + j];
      put_item(row, t4, bd.sitems[i], acc, hist);
    }
  }
  for (int i = tid; i < bd.n_general; i += T) {
    const float v[1] = {gbuf[i]};
    row[swz(bd.general[i].y + t4)] = v[0];
    if (hist != nullptr) add_top_digits(hist, v, 1u);
  }
  __syncthreads();
}

// The gaps between segments: v into each (+inf for the select, then 0
// again for the next row's smooth).
__device__ __forceinline__ void fill_gaps(float* row, int t4,
                                          const RowBand& bd, const int* seg,
                                          float v) {
  const int n = (bd.nseg - 1) * bd.gap;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int s = i / bd.gap;
    row[swz(t4 + seg[s + 1] + bd.gap * s + (i - s * bd.gap))] = v;
  }
}

// The swizzled row as the select reads it: a float4 slot a thread and step,
// over the slots that can hold the row's coordinates [0, span), each
// thread walking a run of its own (the select needs the values, not their
// order; a run of a smooth row shares its top digits, which the select
// merges before its atomics).  An odd run length keeps the lanes of a
// quarter warp on distinct banks.
struct SwzRow {
  const float* row;
  int t4, span, q0, q1, per;
  static constexpr int kPer = 4;
  static constexpr bool kVote = false;
  __device__ SwzRow(const float* r, int t4_, int span_, int P)
      : row(r), t4(t4_), span(span_) {
    q0 = (t4 / 4) & ~15;
    q1 = min(P / 4, ((t4 + span + 3) / 4 + 15) & ~15);
    per = ((q1 - q0 + blockDim.x - 1) / blockDim.x) | 1;
  }
  __device__ __forceinline__ int steps(int) const { return per; }
  __device__ __forceinline__ int full_steps(int) const { return 0; }
  __device__ __forceinline__ void load_full(int, float (&)[4]) const {}
  __device__ __forceinline__ void load(int step, float (&v)[4],
                                       bool (&ok)[4]) const {
    const int q = q0 + threadIdx.x * per + step;
    const int o = 4 * swz_slot(q) - t4;  // the slot's first coordinate
    const float4 a = q < q1 ? reinterpret_cast<const float4*>(row)[q]
                            : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    v[0] = a.x;
    v[1] = a.y;
    v[2] = a.z;
    v[3] = a.w;
#pragma unroll
    for (int j = 0; j < 4; ++j) ok[j] = q < q1 && o + j >= 0 && o + j < span;
  }
};

struct ResidualArgs {
  const void* counts;
  RowBand bd;
  const float* b1min;
  const float* b1max;
  const float* b2min;
  const float* b2max;
  const float* noise;
  float* denoised;
  float nf, mct;
  int center_mean, bf16, C, G, t4;
};

// Floats of ebuf: 8 a bf16 scaled item, one a general gene.
__host__ __device__ inline int residual_ebuf_len(const RowBand& bd) {
  return kGroup * bd.n_sitems + bd.n_general;
}

// Shared memory of a block: the common column and its f32 form, the
// swizzled row, ebuf, the segment starts, SegMap's groups (2 bytes each),
// block sums and the select.
__host__ __device__ inline size_t residual_smem_bytes(const ResidualArgs& a) {
  return sizeof(float) *
             (2 * (size_t)band_rows(a.t4) + swz_row_len(a.bd.span, a.t4) +
              residual_ebuf_len(a.bd) + a.bd.nseg + 1 + (a.G + 15) / 16 +
              32) +
         sizeof(SelectSmem);
}

// x of one gene from its log_norm lx: stage-1 bounds (where-form), clip,
// into slot i of the swizzled row.
template <bool kBf16>
__device__ __forceinline__ void put_x(float* row, int i, int g, float lx,
                                      const ResidualArgs& p) {
  float x = lx;
  const float lo = __ldg(p.b1min + g);
  const float hi = __ldg(p.b1max + g);
  const float above = x > hi ? x - hi : 0.0f;
  x = x < lo ? x - lo : above;
  x = fminf(fmaxf(x, -p.mct), p.mct);
  row[swz(i)] = kBf16 ? round_bf16(x) : x;
}

// The residual of smoothed value y - centre of gene g: stage-2 bounds, exp2.
__device__ __forceinline__ float residual_of(float y, int g,
                                             const ResidualArgs& p) {
  const float lo = __ldg(p.b2min + g);
  const float hi = __ldg(p.b2max + g);
  const float above = y > hi ? y - hi : 0.0f;
  return exp2f(y < lo ? y - lo : above);
}

// The rows of both kernels below.  kBf16: round x to bf16 before the
// smooth (the reference's bf16 flag).  kCentred: store the centred x of
// step 5 (f32) and skip step 6.
template <typename InT, typename OutT, bool kBf16, bool kCentred>
__device__ __forceinline__ void residual_rows(const ResidualArgs& p,
                                              OutT* __restrict__ out) {
  extern __shared__ float4 smem4[];
  using Row = CountRow<InT>;
  const RowBand& bd = p.bd;
  const int G = p.G;
  const int t4 = p.t4;
  float* csm = reinterpret_cast<float*>(smem4);
  float* c32 = csm + band_rows(t4);
  float* row = c32 + band_rows(t4);
  const int P = swz_row_len(bd.span, t4);
  float* ebuf = row + P;
  int* seg = reinterpret_cast<int*>(ebuf + residual_ebuf_len(bd));
  unsigned short* grp = reinterpret_cast<unsigned short*>(seg + bd.nseg + 1);
  float* red = reinterpret_cast<float*>(seg + bd.nseg + 1 + (G + 15) / 16);
  SelectSmem* sel = reinterpret_cast<SelectSmem*>(red + 32);
  const int tid = threadIdx.x;
  const int T = blockDim.x;
  const InT* counts = static_cast<const InT*>(p.counts);

  for (int i = tid; i < band_rows(t4); i += T) {
    csm[i] = bd.common[i];
    c32[i] = bd.common32[i];
  }
  for (int i = tid; i <= bd.nseg; i += T) seg[i] = bd.seg[i];
  for (int i = tid; i < P; i += T) row[i] = 0.0f;
  __syncthreads();
  for (int k = tid; k < (G + 7) / 8; k += T) {
    int lo = 0, hi = bd.nseg - 1;  // the last segment starting at or before 8k
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (seg[mid] <= 8 * k)
        lo = mid;
      else
        hi = mid - 1;
    }
    grp[k] = static_cast<unsigned short>(lo);
  }
  const SegMap map{seg, grp, bd.gap};
  float dn_mean = 0.0f, dn_lo = 0.0f, dn_hi = 0.0f;
  if (p.denoised != nullptr) {
    dn_mean = p.noise[0];
    dn_lo = dn_mean - p.noise[1];
    dn_hi = dn_mean + p.noise[1];
  }
  int* hist = p.center_mean ? nullptr : sel->hist;
  for (int r = blockIdx.x; r < p.C; r += gridDim.x) {
    __syncthreads();  // the previous row's reads of the row and select
    if (hist != nullptr)
      for (int i = tid; i < kSelectBins; i += T) hist[i] = 0;
    const Row cr(counts, r, G);
    const int nq = cr.nvec();
    const int ne = cr.nedge(G);

    // 1. counts -> f32, row sum
    const float cs = block_sum(cr.part_sum(G), red);

    // 2-3. normalise + log2, stage-1 bounds (where-form), clip, into the
    // gene's slot
    for (int q = tid; q < nq; q += T) {
      const typename Row::Pack v = cr.vec(q);
      const int g0 = cr.ia + q * Row::kVec;
      int next;
      const int i0 = g0 + bd.gap * map.seg_of(g0, next) + t4;
#pragma unroll
      for (int j = 0; j < Row::kVec; ++j)
        put_x<kBf16>(row, i0 + j + (g0 + j >= next ? bd.gap : 0), g0 + j,
                     log_norm(static_cast<float>(v.v[j]), cs, p.nf), p);
    }
    for (int i = tid; i < ne; i += T) {
      const int g = cr.edge_gene(i);
      put_x<kBf16>(row, map.coord(g) + t4, g,
                   log_norm(static_cast<float>(cr.glob[g]), cs, p.nf), p);
    }
    __syncthreads();

    // 4. banded smooth, in place
    smooth_row<kBf16>(row, G, t4, bd, csm, c32, ebuf, hist);

    // 5. row centre: mean (the gaps hold zeros), or the exact median (the
    // gaps hold +inf)
    float centre;
    if (p.center_mean) {
      float v = 0.0f;
      for (int o = tid; o < bd.span; o += T) v += row[swz(t4 + o)];
      centre = __fdiv_rn(block_sum(v, red), static_cast<float>(G));
    } else {
      fill_gaps(row, t4, bd, seg, __int_as_float(0x7F800000));
      centre = block_row_median(SwzRow(row, t4, bd.span, P), G, sel);
      fill_gaps(row, t4, bd, seg, 0.0f);
    }

    // 6. stage-2 bounds, exp2, store (and the denoised copy): a scalar head
    // up to the first 4-aligned element of the output row, 4 a thread, a
    // scalar tail (kCentred: the centred value y - centre, stored so)
    const size_t base = (size_t)r * G;
    OutT* dst = out + base;
    float* dn = p.denoised == nullptr ? nullptr : p.denoised + base;
    const int head = min(static_cast<int>((4 - (base & 3)) & 3), G);
    const int nvec = (G - head) / 4;
    const int tail = head + 4 * nvec;
    for (int i = tid; i < head + (G - tail); i += T) {
      const int g = i < head ? i : tail + (i - head);
      const float y = row[swz(map.coord(g) + t4)] - centre;
      const float res = kCentred ? y : residual_of(y, g, p);
      dst[g] = store_cast<OutT>(res);
      if (dn != nullptr) dn[g] = (res > dn_lo && res < dn_hi) ? dn_mean : res;
    }
    for (int v = tid; v < nvec; v += T) {
      const int g = head + 4 * v;
      int next;
      const int i0 = g + bd.gap * map.seg_of(g, next) + t4;
      float y[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        y[j] = row[swz(i0 + j + (g + j >= next ? bd.gap : 0))];
      float res[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        res[j] = kCentred ? y[j] - centre : residual_of(y[j] - centre, g + j, p);
      store4(dst + g, make_float4(res[0], res[1], res[2], res[3]));
      if (dn != nullptr) {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          res[j] = (res[j] > dn_lo && res[j] < dn_hi) ? dn_mean : res[j];
        store4(dn + g, make_float4(res[0], res[1], res[2], res[3]));
      }
    }
  }
}

// Kernel 1: counts in, the final residual out (steps 1-6).
template <typename InT, typename OutT, bool kBf16>
__global__ void __launch_bounds__(kResThreads, 4)
residual_fused_kernel(ResidualArgs p, OutT* __restrict__ out) {
  residual_rows<InT, OutT, kBf16, false>(p, out);
}

// Kernel 1's front, for CnvEngine.ref_stats: counts in, the centred x of
// step 5 out in f32 (the reference's x before its stage-2 bounds), whose
// group means are the second subtraction's.  A kernel of its own name, so
// that kernel 1's time and roofline stay the chunks'.  At ref_stats'
// 13,108 x 8448 u16 it moves 664 MB (0.198 ms) and smooths 20.9 GFLOP
// (0.312 ms): bound by operations, as kernel 1 at its chunks.
template <typename InT, bool kBf16>
__global__ void __launch_bounds__(kResThreads, 4)
ref_centred_kernel(ResidualArgs p, float* __restrict__ out) {
  residual_rows<InT, float, kBf16, true>(p, out);
}

template <typename OutT>
cudaError_t launch_rows(void (*kern)(ResidualArgs, OutT*), const ResidualArgs& a,
                        void* out, size_t smem, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  int dev = 0, nsm = 0, per_sm = 0;
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                      kResThreads, smem);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int grid = min(a.C, per_sm * nsm);
  kern<<<grid, kResThreads, smem, stream>>>(a, static_cast<OutT*>(out));
  return cudaGetLastError();
}

template <typename InT, typename OutT>
cudaError_t launch_residual(const ResidualArgs& a, void* out, size_t smem,
                            cudaStream_t s) {
  return launch_rows<OutT>(a.bf16 ? residual_fused_kernel<InT, OutT, true>
                                  : residual_fused_kernel<InT, OutT, false>,
                           a, out, smem, s);
}

// out_code -1: the front (ref_centred_kernel), f32 out.
template <typename InT>
cudaError_t launch_out(const ResidualArgs& a, void* out, int out_code,
                       size_t smem, cudaStream_t s) {
  switch (out_code) {
    case -1:
      return launch_rows<float>(a.bf16 ? ref_centred_kernel<InT, true>
                                       : ref_centred_kernel<InT, false>,
                                a, out, smem, s);
    case 1:
      return launch_residual<InT, __half>(a, out, smem, s);
    case 2:
      return launch_residual<InT, __nv_bfloat16>(a, out, smem, s);
    default:
      return launch_residual<InT, float>(a, out, smem, s);
  }
}

}  // namespace icnv

// in_code: icnv::InCode; out_code: 0 f32, 1 f16, 2 bf16, or -1 for kernel
// 1's front (ref_centred_kernel: the centred x in f32; b2min, b2max, noise
// and denoised unused, null).
// bf16: round x to bf16 before the smooth (band4 / common must then hold
// bf16-rounded weights).
// noise: device [2] (mean_ref, spread) and denoised: [C, G] f32, or both null.
// band4 ... span: the band as struct RowBand (ops/smoothing.py RowPlan); t4:
// the halfband rounded up to a multiple of 4.  out and denoised must start
// 16-byte aligned.  Fails if a row does not fit in shared memory.
extern "C" int ic_residual_fused(
    const void* counts, int in_code, const float* band4, const float* common,
    const float* common32, int c_lo, int c_hi, int gap, const int* seg,
    int nseg, const int* items, const float* iscale, int n_items,
    const int* sitems, const float* sscale, int n_sitems, const int* general,
    const int* gtaps, int n_general, int span, const float* b1min,
    const float* b1max, const float* b2min, const float* b2max, float nf,
    float mct, int center_mean, int bf16, void* out, int out_code,
    const float* noise, float* denoised, int C, int G, int t4, void* stream) {
  using namespace icnv;
  if (C < 0 || G <= 0 || t4 < 0 || t4 % 4 || t4 + 8 > kResThreads * kGroup ||
      c_lo < 0 || c_lo % 4 || c_hi < c_lo || c_hi % 4 ||
      c_hi > band_rows(t4) || gap < 0 || gap % 4 || nseg < 1 || nseg > 65536 ||
      (nseg > 1 && gap < t4) || span != G + gap * (nseg - 1) || n_items < 0 ||
      n_sitems < 0 || n_items + n_sitems > (span + kGroup - 1) / kGroup ||
      (n_sitems > 0 && !bf16) || n_general < 0 || n_general > G ||
      in_code < 0 || in_code > kU32 || out_code < -1 || out_code > 2 ||
      (noise == nullptr) != (denoised == nullptr) ||
      (out_code == -1 && noise != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (C == 0) return 0;
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  ResidualArgs a;
  a.counts = counts;
  a.bd = RowBand{band4,
                 common,
                 common32,
                 seg,
                 items,
                 iscale,
                 sitems,
                 sscale,
                 reinterpret_cast<const int2*>(general),
                 gtaps,
                 c_lo,
                 c_hi,
                 gap,
                 nseg,
                 n_items,
                 n_sitems,
                 n_general,
                 span};
  a.b1min = b1min;
  a.b1max = b1max;
  a.b2min = b2min;
  a.b2max = b2max;
  a.noise = noise;
  a.denoised = denoised;
  a.nf = nf;
  a.mct = mct;
  a.center_mean = center_mean;
  a.bf16 = bf16 != 0;
  a.C = C;
  a.G = G;
  a.t4 = t4;
  const size_t smem = residual_smem_bytes(a);
  if (smem > (size_t)optin) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (in_code) {
    case kU16:
      e = launch_out<unsigned short>(a, out, out_code, smem, s);
      break;
    case kI16:
      e = launch_out<short>(a, out, out_code, smem, s);
      break;
    case kI32:
      e = launch_out<int>(a, out, out_code, smem, s);
      break;
    case kU32:
      e = launch_out<unsigned>(a, out, out_code, smem, s);
      break;
    default:
      e = launch_out<float>(a, out, out_code, smem, s);
      break;
  }
  return static_cast<int>(e);
}
