// The exact row median of the port's kernels (residual_fused.cu and
// median.cu): an 8-bit radix select on order-preserving uint32 keys, with
// numpy's semantics (the mean of the two middle values for an even count).
// The three kernels that centre a row on its median include this one header,
// so they cannot select differently.
//
// The row may lie in shared memory or in device memory: the select takes a
// generic pointer and only reads it (one read of the row per pass).
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

// Shared memory of one block's select.
struct SelectSmem {
  int hist[256];    // radix histogram
  unsigned prefix;  // the digits chosen so far
  int krem;         // k minus the keys below the prefix
  unsigned maxkey;  // the largest key below the upper middle
};

// Exact k-th smallest (0-based) of the G values of x by an 8-bit radix
// select on the order-preserving keys: 4 passes from the top byte down, each
// a shared-memory histogram of the next digit among the keys that match the
// digits chosen so far.  Equal digits within a warp are merged before the
// atomic in the first pass (__match_any_sync): residual keys share their top
// bytes, so plain atomics would serialise on a few bins there; later passes
// spread over many bins and take plain atomics.  A warp with no key matching
// the prefix skips the pass.  Warp 0 then scans the 256 bins.  On return
// s->prefix is the key of the k-th value and s->krem is k minus the number
// of keys below it.  Every thread of the block must call it.
__device__ inline void radix_select_row(const float* x, int G, int k,
                                        SelectSmem* s) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int T = blockDim.x;
  if (tid == 0) {
    s->prefix = 0u;
    s->krem = k;
  }
  for (int shift = 24; shift >= 0; shift -= 8) {
    for (int i = tid; i < 256; i += T) s->hist[i] = 0;
    __syncthreads();
    const unsigned hmask = shift == 24 ? 0u : (0xFFFFFFFFu << (shift + 8));
    const unsigned pre = s->prefix;
    for (int base = 0; base < G; base += T) {
      const int g = base + tid;
      unsigned tag = 0x100u + lane;  // unique: merges with no digit
      if (g < G) {
        const unsigned key = f2key(x[g]);
        if (((key ^ pre) & hmask) == 0u) tag = (key >> shift) & 0xFFu;
      }
      if (__ballot_sync(0xFFFFFFFFu, tag < 0x100u) == 0u) continue;
      if (shift < 24) {
        if (tag < 0x100u) atomicAdd(s->hist + tag, 1);
        continue;
      }
      const unsigned peers = __match_any_sync(0xFFFFFFFFu, tag);
      if (tag < 0x100u && lane == __ffs(peers) - 1)
        atomicAdd(s->hist + tag, __popc(peers));
    }
    __syncthreads();
    if (tid < 32) {
      const int kk = s->krem;
      __syncwarp();
      int c[8];
      int sum = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        c[j] = s->hist[lane * 8 + j];
        sum += c[j];
      }
      int inc = sum;
      for (int o = 1; o < 32; o <<= 1) {
        const int n = __shfl_up_sync(0xFFFFFFFFu, inc, o);
        if (lane >= o) inc += n;
      }
      int run = inc - sum;
      if (kk >= run && kk < inc) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if (kk < run + c[j]) {
            s->prefix |= static_cast<unsigned>(lane * 8 + j) << shift;
            s->krem = kk - run;
            break;
          }
          run += c[j];
        }
      }
    }
    __syncthreads();
  }
}

// Exact median of the G values of x (numpy semantics: for even G the mean of
// the two middle values, (v1 + v2) * 0.5 rounded once each); every thread of
// the block gets it.  The lower middle of an even row is the largest key
// below the upper middle, unless the upper middle repeats there.  A block
// calls it once: s is not reset for a second select.
__device__ inline float block_row_median(const float* x, int G,
                                         SelectSmem* s) {
  const int tid = threadIdx.x;
  const int T = blockDim.x;
  const int k2 = G / 2;  // upper middle order statistic
  radix_select_row(x, G, k2, s);
  const unsigned v2 = s->prefix;
  float med;
  if (G & 1) {
    med = key2f(v2);
  } else {
    if (tid == 0) s->maxkey = 0u;
    __syncthreads();
    unsigned m = 0u;
    for (int g = tid; g < G; g += T) {
      const unsigned key = f2key(x[g]);
      if (key < v2 && key > m) m = key;
    }
    m = __reduce_max_sync(0xFFFFFFFFu, m);
    if ((tid & 31) == 0) atomicMax(&s->maxkey, m);
    __syncthreads();
    const unsigned v1 = s->krem > 0 ? v2 : s->maxkey;
    med = __fmul_rn(__fadd_rn(key2f(v1), key2f(v2)), 0.5f);
  }
  return med;
}

}  // namespace icnv
