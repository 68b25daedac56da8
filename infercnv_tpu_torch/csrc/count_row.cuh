// Reading a row of counts and its log-normalisation: shared by the fused
// residual (residual_fused.cu, kernel 1 and its front) and the
// log-normalise kernel of ref_stats (ref_stats.cu).
#pragma once

#include <cuda_runtime.h>

namespace icnv {

// Input dtype codes (the Python wrappers' _IN_CODES).
enum InCode { kF32 = 0, kU16 = 1, kI16 = 2, kI32 = 3, kU32 = 4 };

// Row r of the counts: its 16-byte-aligned interior [ia, ib) is read 16
// bytes a load, the head and tail (under 16 bytes each) one value a load.
template <typename InT>
struct CountRow {
  static constexpr int kVec = 16 / sizeof(InT);
  union Pack {
    uint4 u;
    InT v[kVec];
  };
  const InT* glob;
  int ia, ib;
  __device__ CountRow(const InT* counts, int r, int G) {
    glob = counts + (size_t)r * G;
    const size_t s = reinterpret_cast<size_t>(glob);
    const size_t e = s + (size_t)G * sizeof(InT);
    const size_t a = (s + 15) & ~size_t(15);
    const size_t b = e & ~size_t(15);
    ia = b > a ? static_cast<int>((a - s) / sizeof(InT)) : G;
    ib = b > a ? static_cast<int>((b - s) / sizeof(InT)) : G;
  }
  __device__ __forceinline__ int nvec() const { return (ib - ia) / kVec; }
  __device__ __forceinline__ Pack vec(int q) const {
    Pack p;
    p.u = __ldg(reinterpret_cast<const uint4*>(glob + ia) + q);
    return p;
  }
  // the i-th value of the head and tail
  __device__ __forceinline__ int edge_gene(int i) const {
    return i < ia ? i : ib + (i - ia);
  }
  __device__ __forceinline__ int nedge(int G) const { return ia + (G - ib); }
  // this thread's part of the row sum (exact for integer counts below 2^24)
  __device__ __forceinline__ float part_sum(int G) const {
    float part = 0.0f;
    for (int q = threadIdx.x; q < nvec(); q += blockDim.x) {
      const Pack v = vec(q);
#pragma unroll
      for (int j = 0; j < kVec; ++j) part += static_cast<float>(v.v[j]);
    }
    for (int i = threadIdx.x; i < nedge(G); i += blockDim.x)
      part += static_cast<float>(glob[edge_gene(i)]);
    return part;
  }
};

// log2(c / cs * nf + 1), rounded at each step as the reference's ops round.
__device__ __forceinline__ float log_norm(float c, float cs, float nf) {
  return log2f(__fadd_rn(__fmul_rn(__fdiv_rn(c, cs), nf), 1.0f));
}

}  // namespace icnv
