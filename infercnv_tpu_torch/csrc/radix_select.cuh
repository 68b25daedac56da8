// The exact row median of the port's kernels (residual_fused.cu and
// median.cu): a radix select on order-preserving uint32 keys in three passes
// of 11, 11 and 10 bits, with numpy's semantics (the mean of the two middle
// values for an even count).  The kernels that centre a row on its median
// include this one header, so they cannot select differently.
//
// The row may lie in shared memory or in device memory, in any order: the
// select reads it through a row type (a kernel's own: kPer values a thread
// and step, steps(T) steps, load(step, v, ok); the first full_steps(T) of
// them, in which every thread's values are all present, also through
// load_full(step, v); and kVote, whether a warp whose values share one
// digit counts them in one atomic), once per pass.
// The caller counts the first digit itself, as it writes or receives the
// row, so the select sweeps the row twice.  The lower middle of an even row
// needs no sweep of its own: the last pass also keeps the largest key below
// the range of the prefix chosen so far, and its histogram holds the keys
// inside that range.
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
// the keys of the bins below it.  Every thread owns a contiguous run of
// per bins; the runs' sums are scanned across the block.  kLean (the
// select of a row type with kVote): each thread reads its run from a
// rotated start, so a warp's loads hit distinct banks, the warps' sums are
// scanned with shuffles, and with clear every thread zeroes its run once it
// has read it, so the next pass counts into a clean histogram without a
// sweep or a barrier of its own.  Every thread must call it (after a
// barrier that follows the histogram).
__device__ __forceinline__ int select_per(int nbins) {
  const int T = blockDim.x;
  return (nbins + T - 1) / T;
}
// The j-th bin a thread visits of its run [b0, b0 + per), kLean: lanes
// whose runs start in one bank start at different bins of them (per
// divides 32).
__device__ __forceinline__ int select_run(int b0, int per, int j) {
  int i = j + (threadIdx.x & 31) * per / 32;
  if (i >= per) i -= per;
  return b0 + i;
}

template <bool kLean>
__device__ inline void select_bin(SelectSmem* s, int nbins, int shift,
                                  bool clear) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int per = select_per(nbins);
  const int b0 = min(tid * per, nbins);
  const int b1 = min(b0 + per, nbins);
  const int k = s->krem;
  int sum = 0;
  if (kLean) {
    for (int j = 0; j < per; ++j) {
      const int b = select_run(b0, per, j);
      if (b < b1) sum += s->hist[b];
    }
  } else {
    for (int b = b0; b < b1; ++b) sum += s->hist[b];
  }
  int inc = sum;
  for (int o = 1; o < 32; o <<= 1) {
    const int n = __shfl_up_sync(0xFFFFFFFFu, inc, o);
    if (lane >= o) inc += n;
  }
  if (lane == 31) s->wsum[warp] = inc;
  __syncthreads();
  int run = inc - sum;
  if (kLean) {  // the warps' sums before this warp: a scan across the lanes
    int ws = lane < ((blockDim.x + 31) >> 5) ? s->wsum[lane] : 0;
    for (int o = 1; o < 32; o <<= 1) {
      const int n = __shfl_up_sync(0xFFFFFFFFu, ws, o);
      if (lane >= o) ws += n;
    }
    const int before = __shfl_sync(0xFFFFFFFFu, ws, max(warp - 1, 0));
    run += warp > 0 ? before : 0;
  } else {
    for (int w = 0; w < warp; ++w) run += s->wsum[w];
  }
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
  if (kLean && clear)
    for (int j = 0; j < per; ++j) {
      const int b = select_run(b0, per, j);
      if (b < b1) s->hist[b] = 0;
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

// The digits d[0..N) of one thread's values (-1: not counted) into hist.
// Without kVote: one atomic if all N agree, else one a value.  With kVote
// the thread first merges the digits of the values it counts (n of them):
// if every lane of the warp that counts any has the same merged digit, lane
// 0 adds the warp's total in one atomic (a smooth row's 128 neighbouring
// values a warp share their top digits, whose 32 atomics would land on one
// bin and serialise); else each lane adds its merged count, or one a value.
// A warp none of whose values is counted (most steps of passes 2 and 3)
// does nothing more.  With kVote every lane of the warp must call it.
template <int N, bool kVote>
__device__ __forceinline__ void count_digits(int* hist, const int (&d)[N]) {
  if (!kVote) {
    bool same = true;
#pragma unroll
    for (int j = 1; j < N; ++j) same = same && d[j] == d[0];
    if (same) {
      if (d[0] >= 0) atomicAdd(hist + d[0], N);
    } else {
#pragma unroll
      for (int j = 0; j < N; ++j)
        if (d[j] >= 0) atomicAdd(hist + d[j], 1);
    }
    return;
  }
  int any = d[0];  // >= 0 iff some value is counted
#pragma unroll
  for (int j = 1; j < N; ++j) any &= d[j];
  if (!__any_sync(0xFFFFFFFFu, any >= 0)) return;
  // the thread's counted values: n of them, all of digit smax unless their
  // smallest (umin, as unsigned: -1 is the largest) differs
  int smax = d[0], n = N;
  unsigned umin = static_cast<unsigned>(d[0]);
#pragma unroll
  for (int j = 0; j < N; ++j) {
    smax = max(smax, d[j]);
    umin = min(umin, static_cast<unsigned>(d[j]));
    n += d[j] >> 31;
  }
  const bool mixed = smax >= 0 && static_cast<int>(umin) != smax;
  const int mine = mixed ? -2 : smax;  // -1: nothing to count
  const int top = __reduce_max_sync(0xFFFFFFFFu, mine);
  if (top >= 0 && __all_sync(0xFFFFFFFFu, mine == top || mine == -1)) {
    const int total = static_cast<int>(
        __reduce_add_sync(0xFFFFFFFFu, static_cast<unsigned>(n)));
    if ((threadIdx.x & 31) == 0) atomicAdd(hist + top, total);
  } else if (!mixed) {
    if (smax >= 0) atomicAdd(hist + smax, n);
  } else {
#pragma unroll
    for (int j = 0; j < N; ++j)
      if (d[j] >= 0) atomicAdd(hist + d[j], 1);
  }
}

// Exact k-th smallest (0-based) of the values of row x: three radix passes
// from the top digit down, each a shared-memory histogram of the next digit
// among the keys that match the digits chosen so far.  The caller has
// counted the top digit of every value into s->hist, which was clean, as it
// wrote or received the row (add_top_digits, or a sweep of its own): the
// first pass only picks its bin, and the select sweeps the row twice.  With
// Row::kVote the passes count into bins select_bin cleared; otherwise each
// pass clears the histogram first.  A
// thread's values of a step (kPer neighbours) whose digits agree are
// counted in one atomic, and with Row::kVote a warp whose values agree in
// one (count_digits): residual keys share their top bits, and a smooth row's
// neighbours their next ones, so one atomic a value would serialise on a few
// bins (merging across the warp with __match_any_sync measured slower).
// Every thread runs the same number of steps.  The last pass also keeps
// s->below, the largest key below the prefix's range (0 if none).  On return
// s->prefix is the key of the k-th value, s->krem is k minus the number of
// keys below it, and s->hist holds the last pass's histogram (with kVote the
// bins of the earlier passes cleared).  Every thread of the block must call
// it.
template <typename Row>
__device__ inline void radix_select_row(const Row& x, int k, SelectSmem* s) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int T = blockDim.x;
  if (tid == 0) {
    s->prefix = 0u;
    s->krem = k;
    s->below = 0u;
  }
  __syncthreads();
  select_bin<Row::kVote>(s, kSelectBins, kTopShift, true);
#pragma unroll 1
  for (int p = 1; p < 3; ++p) {
    const int shift = select_shift(p);
    const int nbins = 1 << select_bits(p);
    if (!Row::kVote) {
      for (int i = tid; i < nbins; i += T) s->hist[i] = 0;
      __syncthreads();
    }
    const unsigned hmask = 0xFFFFFFFFu << (shift + select_bits(p));
    const unsigned pre = s->prefix;
    const unsigned dmask = static_cast<unsigned>(nbins - 1);
    unsigned bmax = 0u;
    // the steps in which every thread's kPer values are present, then the
    // rest; keys in the prefix's range are >= pre, so those below it are
    // the keys below the range
    const int nfull = x.full_steps(T);
    for (int step = 0; step < nfull; ++step) {
      float v[Row::kPer];
      x.load_full(step, v);
      int d[Row::kPer];
#pragma unroll
      for (int j = 0; j < Row::kPer; ++j) {
        const unsigned key = f2key(v[j]);
        d[j] = ((key ^ pre) & hmask) == 0u
                   ? static_cast<int>((key >> shift) & dmask)
                   : -1;
        if (p == 2 && key < pre) bmax = max(bmax, key);
      }
      count_digits<Row::kPer, Row::kVote>(s->hist, d);
    }
    const int nstep = x.steps(T);
    for (int step = nfull; step < nstep; ++step) {
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
      count_digits<Row::kPer, Row::kVote>(s->hist, d);
    }
    if (p == 2) {
      bmax = __reduce_max_sync(0xFFFFFFFFu, bmax);
      if (lane == 0 && bmax != 0u) atomicMax(&s->below, bmax);
    }
    __syncthreads();
    select_bin<Row::kVote>(s, nbins, shift, p < 2);
  }
}

// Exact median of the G values of row x (numpy semantics: for even G the
// mean of the two middle values, (v1 + v2) * 0.5 rounded once each); every
// thread of the block gets it.  The caller has counted the top digits into
// a clean s->hist (radix_select_row); with Row::kVote s->hist is clean
// again on return.
// The lower middle v1 of an even row is the upper middle v2 if v2 repeats
// below its rank (krem > 0); else the largest nonempty bin of the last
// histogram below v2's bin; else the largest key below the last prefix's
// range (s->below).  A block may call it again for another row after a
// barrier.
template <typename Row>
__device__ inline float block_row_median(const Row& x, int G, SelectSmem* s) {
  const int tid = threadIdx.x;
  const int k2 = G / 2;  // upper middle order statistic
  if (tid == 0) s->lobin = -1;
  radix_select_row(x, k2, s);
  const unsigned v2 = s->prefix;
  unsigned v1 = v2;
  if ((G & 1) == 0 && s->krem == 0) {
    const int d2 = static_cast<int>(v2 & 1023u);
    const int per = select_per(1024);
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
  if (Row::kVote) {  // every thread clears its own run of the last histogram
    const int per = select_per(1024);
    const int b0 = tid * per;
    for (int b = b0; b < min(b0 + per, 1024); ++b) s->hist[b] = 0;
  }
  return (G & 1) ? key2f(v2)
                 : __fmul_rn(__fadd_rn(key2f(v1), key2f(v2)), 0.5f);
}

}  // namespace icnv
