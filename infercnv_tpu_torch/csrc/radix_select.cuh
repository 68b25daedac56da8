// The exact row median of the port's kernels (residual_fused.cu and
// median.cu): a radix select on order-preserving uint32 keys in three passes
// of 11, 11 and 10 bits, with numpy's semantics (the mean of the two middle
// values for an even count).  The three kernels that centre a row on its
// median include this one header, so they cannot select differently.
//
// The row may lie in shared memory or in device memory, in any order: the
// select reads it through a row type (PlainRow below, or a kernel's own:
// kPer values a thread and step, steps(T) steps, load(step, v, ok)), once
// per pass, three times in all.  The lower middle of an even row needs no
// sweep of its own: the last pass also keeps the largest key below the range
// of the prefix chosen so far, and its histogram holds the keys inside that
// range.
#pragma once

#include <cuda_runtime.h>

namespace icnv {

__device__ __forceinline__ unsigned f2key(float f) {
  const unsigned u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float key2f(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7FFFFFFFu) : ~k);
}

// Digits of the select, from the top: bits 31..21, 20..10, 9..0.
constexpr int kSelectBins = 2048;
constexpr int kTopShift = 21;
__device__ __forceinline__ int select_shift(int p) {
  return p == 0 ? 21 : (p == 1 ? 10 : 0);
}
__device__ __forceinline__ int select_bits(int p) { return p == 2 ? 10 : 11; }

// G values at x[0..G) (generic pointer), one a thread and step.
struct PlainRow {
  const float* x;
  int G;
  static constexpr int kPer = 1;
  __device__ __forceinline__ int steps(int T) const { return (G + T - 1) / T; }
  __device__ __forceinline__ void load(int step, float (&v)[1],
                                       bool (&ok)[1]) const {
    const int g = step * blockDim.x + threadIdx.x;
    ok[0] = g < G;
    v[0] = ok[0] ? x[g] : 0.0f;
  }
};

// Shared memory of one block's select.
struct SelectSmem {
  int hist[kSelectBins];  // radix histogram of the current digit
  int wsum[32];           // per-warp sums of the histogram scan
  unsigned prefix;        // the digits chosen so far
  int krem;               // k minus the keys below the prefix
  unsigned below;         // the largest key below the prefix's range
  int lobin;              // the last pass's largest nonempty bin below k's
};

// Block-wide: the bin of s->hist[0..nbins) that holds the krem-th key (in
// order of bins), written into s->prefix at shift; s->krem becomes krem minus
// the keys of the bins below it.  Every thread scans a contiguous run of
// bins; the runs' sums are scanned across the block.  Every thread must
// call it (after a barrier that follows the histogram).
__device__ inline void select_bin(SelectSmem* s, int nbins, int shift) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int T = blockDim.x;
  const int per = (nbins + T - 1) / T;
  const int b0 = min(tid * per, nbins);
  const int b1 = min(b0 + per, nbins);
  const int k = s->krem;
  int sum = 0;
  for (int b = b0; b < b1; ++b) sum += s->hist[b];
  int inc = sum;
  for (int o = 1; o < 32; o <<= 1) {
    const int n = __shfl_up_sync(0xFFFFFFFFu, inc, o);
    if (lane >= o) inc += n;
  }
  if (lane == 31) s->wsum[warp] = inc;
  __syncthreads();
  int run = inc - sum;
  for (int w = 0; w < warp; ++w) run += s->wsum[w];
  if (sum > 0 && k >= run && k < run + sum) {
    for (int b = b0; b < b1; ++b) {
      const int c = s->hist[b];
      if (k < run + c) {
        s->prefix |= static_cast<unsigned>(b) << shift;
        s->krem = k - run;
        break;
      }
      run += c;
    }
  }
  __syncthreads();
}

// The first pass's histogram as a kernel writes the row: the top digits of
// the values v[j] with bit j of mask, one atomic if they agree.
template <int N>
__device__ __forceinline__ void add_top_digits(int* hist, const float (&v)[N],
                                               unsigned mask) {
  int d[N];
  int d0 = -1;
  bool same = true;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    d[j] = static_cast<int>(f2key(v[j]) >> kTopShift);
    if (mask >> j & 1u) {
      if (d0 < 0) d0 = d[j];
      same = same && d[j] == d0;
    }
  }
  if (same) {
    if (d0 >= 0) atomicAdd(hist + d0, __popc(mask));
  } else {
#pragma unroll
    for (int j = 0; j < N; ++j)
      if (mask >> j & 1u) atomicAdd(hist + d[j], 1);
  }
}

// Exact k-th smallest (0-based) of the values of row x: three radix passes
// from the top digit down, each a shared-memory histogram of the next digit
// among the keys that match the digits chosen so far.  A thread's values of
// a step (kPer neighbours) whose digits agree are counted in one atomic:
// residual keys share their top bits, and a smooth row's neighbours their
// next ones, so one atomic a value would serialise on a few bins (merging
// across the warp with __match_any_sync measured slower).  The last pass
// also keeps s->below, the largest key below the prefix's range (0 if none).
// With top_done the caller has already counted the top digit of every value
// into s->hist (a kernel that produced the row counts it as it writes it,
// add_top_digits); the first pass then only picks its bin.  On return
// s->prefix is the key of the k-th value and s->krem is k minus the number
// of keys below it.  Every thread of the block must call it.
template <typename Row>
__device__ inline void radix_select_row(const Row& x, int k, SelectSmem* s,
                                        bool top_done = false) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int T = blockDim.x;
  if (tid == 0) {
    s->prefix = 0u;
    s->krem = k;
    s->below = 0u;
  }
  int p0 = 0;
  if (top_done) {
    __syncthreads();
    select_bin(s, kSelectBins, kTopShift);
    p0 = 1;
  }
#pragma unroll 1
  for (int p = p0; p < 3; ++p) {
    const int shift = select_shift(p);
    const int nbins = 1 << select_bits(p);
    for (int i = tid; i < nbins; i += T) s->hist[i] = 0;
    __syncthreads();
    const unsigned hmask = p == 0 ? 0u : (0xFFFFFFFFu << (shift + select_bits(p)));
    const unsigned pre = s->prefix;
    const unsigned dmask = static_cast<unsigned>(nbins - 1);
    unsigned bmax = 0u;
    const int nstep = x.steps(T);
    for (int step = 0; step < nstep; ++step) {
      float v[Row::kPer];
      bool ok[Row::kPer];
      x.load(step, v, ok);
      int d[Row::kPer];  // the digit of each value, -1 if it does not match
#pragma unroll
      for (int j = 0; j < Row::kPer; ++j) {
        d[j] = -1;
        if (ok[j]) {
          const unsigned key = f2key(v[j]);
          if (((key ^ pre) & hmask) == 0u)
            d[j] = static_cast<int>((key >> shift) & dmask);
          else if (p == 2 && key < pre)
            bmax = max(bmax, key);
        }
      }
      bool same = true;
#pragma unroll
      for (int j = 1; j < Row::kPer; ++j) same = same && d[j] == d[0];
      if (same) {
        if (d[0] >= 0) atomicAdd(s->hist + d[0], Row::kPer);
      } else {
#pragma unroll
        for (int j = 0; j < Row::kPer; ++j)
          if (d[j] >= 0) atomicAdd(s->hist + d[j], 1);
      }
    }
    if (p == 2) {
      bmax = __reduce_max_sync(0xFFFFFFFFu, bmax);
      if (lane == 0 && bmax != 0u) atomicMax(&s->below, bmax);
    }
    __syncthreads();
    select_bin(s, nbins, shift);
  }
}

// Exact median of the G values of row x (numpy semantics: for even G the
// mean of the two middle values, (v1 + v2) * 0.5 rounded once each); every
// thread of the block gets it.  The lower middle v1 of an even row is the
// upper middle v2 if v2 repeats below its rank (krem > 0); else the largest
// nonempty bin of the last histogram below v2's bin; else the largest key
// below the last prefix's range (s->below).  A block may call it again for
// another row after a barrier.
template <typename Row>
__device__ inline float block_row_median(const Row& x, int G, SelectSmem* s,
                                         bool top_done = false) {
  const int tid = threadIdx.x;
  const int k2 = G / 2;  // upper middle order statistic
  if (tid == 0) s->lobin = -1;
  radix_select_row(x, k2, s, top_done);
  const unsigned v2 = s->prefix;
  unsigned v1 = v2;
  if ((G & 1) == 0 && s->krem == 0) {
    const int d2 = static_cast<int>(v2 & 1023u);
    const int T = blockDim.x;
    const int per = (1024 + T - 1) / T;
    const int b0 = tid * per;
    for (int b = min(b0 + per, d2) - 1; b >= b0; --b)
      if (s->hist[b] > 0) {
        atomicMax(&s->lobin, b);
        break;
      }
    __syncthreads();
    v1 = s->lobin >= 0 ? (v2 & ~1023u) | static_cast<unsigned>(s->lobin)
                       : s->below;
  }
  return (G & 1) ? key2f(v2)
                 : __fmul_rn(__fadd_rn(key2f(v1), key2f(v2)), 0.5f);
}

}  // namespace icnv
