// Exact row medians, and the median-centred tail of the residual:
// persistent blocks that copy rows into shared memory by TMA and select on
// them there.
//
// Replaces two TPU kernels of infercnv_tpu/ops/median.py:
//   _median_kernel (launched by row_median_pallas): the exact median of
//     each row with numpy's semantics;
//   _median_epilogue_kernel (median_center_residual_pallas): the same median
//     of a smooth output row, then y - median, the stage-2 where-bounds and
//     exp2, i.e. the final residual of the engine's unfused path.
// Both select with radix_select.cuh, as residual_fused.cu does, so the
// port's three medians cannot differ.  The TPU kernels pad rows with +inf to
// whole 128-lane tiles; here a row is read for its n values only and the
// rest of its stride (ld) is ignored.
//
// What bounds them on the H100: the bytes.  The median of a 32768 x 8448
// f32 chunk reads 1.1 GB (0.33 ms at 3.35 TB/s); the tail on 8192 x 60000
// reads and writes 1.97 GB each (1.2 ms).  The select sweeps a row three
// times (its 11/11/10-bit passes; the lower middle of an even count is
// folded into the last), so the row is staged in shared memory and device
// memory sees it once.  A launch plan (ops/median.py median_plan, from the
// row width and the card) decides how:
//   * Persistent blocks walk the rows, each with one row buffer.  A row
//     reaches shared memory in chunks of up to 32 KB, each a bulk copy
//     (cp.async.bulk) completing on an mbarrier of its own; the select's
//     first pass counts each chunk as it lands, so the select sweeps the
//     row twice more.  A block issues the next row's copies as soon as its
//     sweeps are done.  Rows in flight hide the copies: at 8448 genes four
//     blocks share an SM (33.8 KB of row and 8.4 KB of select each).  Two
//     buffers a block, the next row's copy issued before the select,
//     measured slower there (three blocks an SM) and no faster at 4000
//     genes, and were not kept.
//   * A row wider than a block's 227 KB (60,000 genes are 240 KB): one block
//     an SM stages as much of it as fits (55,996 values) and reads the rest
//     (its tail, 6.7%) from device memory on each pass; 132 tails stay in
//     L2.  The tail kernel refills the buffer with the next row chunk by
//     chunk as its epilogue stores each chunk.
// Bulk copies need 16-byte alignment: a row that starts off a 16-byte
// boundary (e.g. G = 8447) reads its up to 3 head values, and its last
// values after whole 16-byte slots, from device memory on every pass.  A
// thread reads 4 consecutive values a step, and a warp whose values share
// one digit counts them in one atomic (count_digits); a warp none of whose
// values match the prefix (most of a pass 2 or 3) counts nothing.
// What still holds them back (benchmarks/torch_kernel_variants.py, PERF.md):
// the select's instructions, not its atomics (at 8448 genes the copies
// alone take about a third of the time); and in the tail, the stage-2
// bounds (480 KB a 60,000-gene row, read from L2 for every row) and a
// select that one block an SM cannot overlap with its own stores.
//
// Build without --use_fast_math: exp2f must stay accurate, and flushing
// subnormals would change the median's keys.
#include <cuda_runtime.h>
#include <stdint.h>

#include "radix_select.cuh"

namespace icnv {

constexpr int kMedianMaxThreads = 1024;
constexpr int kMaxChunks = 16;  // copies a row at most
// Shared memory before the row buffer: the select, and an mbarrier a copy
// (ops/median.py _HEAD_BYTES).
constexpr size_t kHeadBytes = sizeof(SelectSmem) + kMaxChunks * 8;
static_assert(kHeadBytes % 16 == 0, "the row buffer must be 16-byte aligned");

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// An mbarrier that completes a phase on one arrival and its copies' bytes.
__device__ __forceinline__ void bar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(bar))
               : "memory");
}

// One arrival on bar expecting `bytes`, then a bulk copy of them from src
// (16-byte aligned, device memory) to dst (shared memory); no copy for 0.
__device__ __forceinline__ void bar_copy(uint64_t* bar, float* dst,
                                         const float* src, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
  if (bytes > 0)
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];" ::"r"(smem_addr(dst)),
        "l"(src), "r"(bytes), "r"(smem_addr(bar))
        : "memory");
}

// Wait until bar has completed the phase of the given parity.  A copy that
// never lands traps (the launch fails) instead of hanging the card.
__device__ __forceinline__ void bar_wait(uint64_t* bar, unsigned parity) {
  const unsigned a = smem_addr(bar);
  for (unsigned tries = 0;; ++tries) {
    unsigned done;
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (done) return;
    if (tries == (1u << 26)) __trap();
  }
}

// Row r as the kernel reads it: h values before its first 16-byte boundary,
// then nf whole 16-byte slots (the first ns staged in shared memory, the
// rest in device memory), then the last G - h - 4 nf values.  Slot q < nf
// holds genes h + 4q .. h + 4q + 3; slot nf the h head values; slot nf + 1
// the last ones.
struct MedRow {
  const float* buf;   // the staged slots, in shared memory
  const float* glob;  // the row in device memory
  int G, h, ns, nf;
  static constexpr int kPer = 4;
  static constexpr bool kVote = true;
  // staged: the values the row buffer holds (a multiple of 4)
  __device__ MedRow(const float* buf_, const float* row, int G_, int staged)
      : buf(buf_), glob(row), G(G_) {
    const int mis = static_cast<int>((reinterpret_cast<size_t>(row) >> 2) & 3);
    h = min((4 - mis) & 3, G);
    nf = (G - h) >> 2;
    ns = min(staged >> 2, nf);
  }
  __device__ __forceinline__ int slots() const { return nf + 2; }
  __device__ __forceinline__ int steps(int T) const {
    return (nf + 2 + T - 1) / T;
  }
  // the steps whose slots are all staged, for every thread
  __device__ __forceinline__ int full_steps(int T) const { return ns / T; }
  __device__ __forceinline__ void load_full(int step, float (&v)[4]) const {
    const float4 a =
        reinterpret_cast<const float4*>(buf)[step * blockDim.x + threadIdx.x];
    v[0] = a.x;
    v[1] = a.y;
    v[2] = a.z;
    v[3] = a.w;
  }
  __device__ __forceinline__ int gene(int q) const {
    return q < nf ? h + 4 * q : (q == nf ? 0 : h + 4 * nf);
  }
  __device__ __forceinline__ void slot(int q, float (&v)[4],
                                       bool (&ok)[4]) const {
    if (q < nf) {
      const float4 a =
          q < ns ? reinterpret_cast<const float4*>(buf)[q]
                 : __ldg(reinterpret_cast<const float4*>(glob + h) + q);
      v[0] = a.x;
      v[1] = a.y;
      v[2] = a.z;
      v[3] = a.w;
#pragma unroll
      for (int j = 0; j < 4; ++j) ok[j] = true;
    } else {
      const int n = q == nf ? h : (q == nf + 1 ? G - h - 4 * nf : 0);
      const int g = gene(q);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        ok[j] = j < n;
        v[j] = ok[j] ? __ldg(glob + g + j) : 0.0f;
      }
    }
  }
  __device__ __forceinline__ void load(int step, float (&v)[4],
                                       bool (&ok)[4]) const {
    slot(step * blockDim.x + threadIdx.x, v, ok);
  }
};

struct MedianArgs {
  const float* x;  // C rows of stride ld
  int ld, C, G;
  int staged;  // values the row buffer holds (a multiple of 4)
  int chunk;   // values a copy (a multiple of 4)
  int nchunk;  // copies a row
  const float* gmin;  // the tail's stage-2 bounds [G]
  const float* gmax;
  float* out;  // the tail's output: C rows of stride ldo
  int ldo;
  float* med;  // [C] or null
};

// Chunk k's copies of row (into buf, completing on bar): its staged slots
// [k * chunk / 4, ...) up to the row's ns.  One thread issues it.
__device__ __forceinline__ void issue_chunk(const MedianArgs& a,
                                            const MedRow& row, int k,
                                            float* buf, uint64_t* bar) {
  const int cq = a.chunk >> 2;
  const int q0 = min(k * cq, row.ns);
  const int q1 = min(q0 + cq, row.ns);
  bar_copy(bar, buf + 4 * q0, row.glob + row.h + 4 * q0,
           16u * static_cast<unsigned>(q1 - q0));
}

__device__ __forceinline__ void issue_row(const MedianArgs& a, int r,
                                          float* buf, uint64_t* bar) {
  const MedRow row(buf, a.x + (size_t)r * a.ld, a.G, a.staged);
  for (int k = 0; k < a.nchunk; ++k) issue_chunk(a, row, k, buf, bar + k);
}

// The select's first pass over slots [q0, q1): the top digit of each value.
// Whole trips of staged slots (q1 <= ns) are read as they are, the rest
// through slot().
__device__ __forceinline__ void count_top(const MedRow& row, int q0, int q1,
                                          int* hist) {
  const int T = blockDim.x;
  int b = q0;
  if (q1 <= row.ns)
    for (; b + T <= q1; b += T) {
      const float4 a = reinterpret_cast<const float4*>(row.buf)[b + threadIdx.x];
      const int d[4] = {static_cast<int>(f2key(a.x) >> kTopShift),
                        static_cast<int>(f2key(a.y) >> kTopShift),
                        static_cast<int>(f2key(a.z) >> kTopShift),
                        static_cast<int>(f2key(a.w) >> kTopShift)};
      count_digits<4, true>(hist, d);
    }
  for (; b < q1; b += T) {  // the same trips in every lane
    const int q = b + threadIdx.x;
    float v[4];
    bool ok[4];
    row.slot(q < q1 ? q : row.slots(), v, ok);
    int d[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      d[j] = ok[j] ? static_cast<int>(f2key(v[j]) >> kTopShift) : -1;
    count_digits<4, true>(hist, d);
  }
}

// exp2(where-bounds(y - m, lo, hi)), in the reference's op order
// (infercnv_tpu/ops/median.py:121-126).
__device__ __forceinline__ float centred_tail(float y, float m, float lo,
                                              float hi) {
  const float r = y - m;
  const float above = r > hi ? r - hi : 0.0f;
  return exp2f(r < lo ? r - lo : above);
}

// The tail of the values of slots [q0, q1) into dst (the output row): 16
// bytes a load and a store where output and bounds are aligned so.  One
// slot a thread at a time: two, their loads before their stores, spill
// registers at 1024 threads.
__device__ __forceinline__ void tail_slots(const MedianArgs& a,
                                           const MedRow& row, float* dst,
                                           int q0, int q1, float m) {
  for (int q = q0 + threadIdx.x; q < q1; q += blockDim.x) {
    float v[4];
    bool ok[4];
    row.slot(q, v, ok);
    const int g = row.gene(q);
    const size_t al = reinterpret_cast<size_t>(dst + g) |
                      reinterpret_cast<size_t>(a.gmin + g) |
                      reinterpret_cast<size_t>(a.gmax + g);
    if (ok[3] && (al & 15) == 0) {
      const float4 lo = __ldg(reinterpret_cast<const float4*>(a.gmin + g));
      const float4 hi = __ldg(reinterpret_cast<const float4*>(a.gmax + g));
      __stcs(reinterpret_cast<float4*>(dst + g),
             make_float4(centred_tail(v[0], m, lo.x, hi.x),
                         centred_tail(v[1], m, lo.y, hi.y),
                         centred_tail(v[2], m, lo.z, hi.z),
                         centred_tail(v[3], m, lo.w, hi.w)));
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (ok[j])
          dst[g + j] = centred_tail(v[j], m, __ldg(a.gmin + g + j),
                                    __ldg(a.gmax + g + j));
    }
  }
}

// kEpi: the median tail (kernel 6); else the row median alone (kernel 7).
// Shared memory: SelectSmem, kMaxChunks mbarriers, the row buffer.  The
// block issues the next row's copies as soon as it is done with a part of
// the buffer: after the select's sweeps, or with kEpi chunk by chunk as the
// tail stores them.
template <bool kEpi>
__global__ void __launch_bounds__(kMedianMaxThreads)
median_rows_kernel(MedianArgs a) {
  extern __shared__ float4 smem4[];
  char* base = reinterpret_cast<char*>(smem4);
  SelectSmem* sel = reinterpret_cast<SelectSmem*>(base);
  uint64_t* bar = reinterpret_cast<uint64_t*>(base + sizeof(SelectSmem));
  float* buf = reinterpret_cast<float*>(base + kHeadBytes);
  const int tid = threadIdx.x;
  const int T = blockDim.x;
  const int cq = a.chunk >> 2;
  if (tid == 0) {
    for (int i = 0; i < a.nchunk; ++i) bar_init(bar + i);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  // block_row_median leaves the histogram clean for the next row
  for (int i = tid; i < kSelectBins; i += T) sel->hist[i] = 0;
  __syncthreads();
  int r = blockIdx.x;
  if (tid == 0 && r < a.C) issue_row(a, r, buf, bar);
  for (unsigned parity = 0; r < a.C; parity ^= 1u, r += gridDim.x) {
    const int rn = r + gridDim.x;
    const MedRow row(buf, a.x + (size_t)r * a.ld, a.G, a.staged);
    // the first pass as the row lands: each chunk once its copy is in, then
    // the values read from device memory
    for (int k = 0; k < a.nchunk; ++k) {
      bar_wait(bar + k, parity);
      count_top(row, min(k * cq, row.ns), min((k + 1) * cq, row.ns),
                sel->hist);
    }
    count_top(row, row.ns, row.slots(), sel->hist);
    const float m = block_row_median(row, a.G, sel);
    if (tid == 0 && a.med != nullptr) a.med[r] = m;
    // the select's sweeps are done (its last barriers passed)
    if (kEpi) {
      float* dst = a.out + (size_t)r * a.ldo;
      for (int k = 0; k < a.nchunk; ++k) {
        tail_slots(a, row, dst, min(k * cq, row.ns), min((k + 1) * cq, row.ns),
                   m);
        if (rn < a.C) {
          __syncthreads();
          if (tid == 0) {
            asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
            issue_chunk(a, MedRow(buf, a.x + (size_t)rn * a.ld, a.G, a.staged),
                        k, buf, bar + k);
          }
        }
      }
      tail_slots(a, row, dst, row.ns, row.slots(), m);
    } else if (rn < a.C && tid == 0) {
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      issue_row(a, rn, buf, bar);
    }
    __syncthreads();  // the select's histogram and this row's buffer
  }
}

// Checks the plan against the kernel's layout and the card, then launches
// a persistent grid of min(C, SMs x blocks_per_sm) blocks.  A plan the card
// cannot hold (shared memory, or fewer resident blocks than planned) fails
// here: no launch is tried and refused.
template <bool kEpi>
cudaError_t launch_median(const MedianArgs& a, int threads, int blocks_per_sm,
                          int smem, cudaStream_t stream) {
  const size_t need = kHeadBytes + sizeof(float) * (size_t)a.staged;
  if (threads < 32 || threads > kMedianMaxThreads || threads % 32 ||
      blocks_per_sm < 1 || a.staged < 0 || a.staged % 4 || a.chunk < 0 ||
      a.chunk % 4 || a.nchunk < 0 || a.nchunk > kMaxChunks ||
      (a.nchunk > 0 && a.chunk == 0) ||
      (size_t)a.nchunk * a.chunk < (size_t)a.staged || smem < 0 ||
      (size_t)smem < need)
    return cudaErrorInvalidValue;
  int dev = 0, optin = 0, nsm = 0, occ = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  if (smem > optin) return cudaErrorInvalidValue;
  auto kern = median_rows_kernel<kEpi>;
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kern, threads,
                                                      smem);
  if (e != cudaSuccess) return e;
  if (occ < blocks_per_sm) return cudaErrorInvalidConfiguration;
  const long long resident = static_cast<long long>(nsm) * blocks_per_sm;
  const int grid = a.C < resident ? a.C : static_cast<int>(resident);
  kern<<<grid, threads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace icnv

// The launch plan of ops/median.py MedianPlan: threads, blocks_per_sm,
// staged (values the row buffer holds), chunk, nchunk, smem (bytes).

// x: C rows of stride ld (>= n); med: [C].
extern "C" int ic_row_median(const float* x, int ld, int C, int n, float* med,
                             int threads, int blocks_per_sm, int staged,
                             int chunk, int nchunk, int smem, void* stream) {
  using namespace icnv;
  if (C < 0 || n <= 0 || ld < n) return static_cast<int>(cudaErrorInvalidValue);
  if (C == 0) return 0;
  MedianArgs a{x,      ld,      C,       n,       staged, chunk,
               nchunk, nullptr, nullptr, nullptr, 0,      med};
  return static_cast<int>(launch_median<false>(
      a, threads, blocks_per_sm, smem, static_cast<cudaStream_t>(stream)));
}

// y: C rows of stride ld (>= n), the smooth output; gmin / gmax: [n];
// out: C rows of stride ldo (>= n); med: [C] or null.
extern "C" int ic_median_center_residual(const float* y, int ld,
                                         const float* gmin, const float* gmax,
                                         float* out, int ldo, float* med,
                                         int C, int n, int threads,
                                         int blocks_per_sm, int staged,
                                         int chunk, int nchunk, int smem,
                                         void* stream) {
  using namespace icnv;
  if (C < 0 || n <= 0 || ld < n || ldo < n)
    return static_cast<int>(cudaErrorInvalidValue);
  if (C == 0) return 0;
  MedianArgs a{y, ld, C, n, staged, chunk, nchunk, gmin, gmax, out, ldo, med};
  return static_cast<int>(launch_median<true>(
      a, threads, blocks_per_sm, smem, static_cast<cudaStream_t>(stream)));
}
