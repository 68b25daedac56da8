// Viterbi over B padded, bin-packed sequences, in two regimes that the host
// plans (ops/viterbi_kernel.py viterbi_plan).
//
// Replaces the TPU kernel infercnv_tpu/ops/viterbi_pallas.py::_viterbi_kernel
// (launched by _viterbi_pallas_call / viterbi_pallas, emission through
// _log_sf_std_normal).  Per sequence b of valid length lens[b]:
//   emission  em_s = -log(-logSF(|x - mu_s| / sigma_b))   (unnormalised)
//   forward   nu_s <- max(nu_s + log_diag, max_j nu_j + log_off) + em_s,
//             backpointer ties to the first state (R's which.max);
//             a 1 in bnd restarts the chain (log_delta + em) and the
//             backtrace jumps to the previous segment's argmax there
//   backtrace from the argmax at the last valid position; positions at or
//             past lens[b] repeat that state
// and writes 1-based int8 states.  Built for the two models of the
// reference: i6 (S = 6) and i3 (S = 3, R/inferCNV_i3HMM.R).
//
// A step's backpointers are packed into one 16-bit word: the argmax am of
// nu (bits 0-2) and the mask of the states whose best move was the move
// from am (bits 3 and up; all of them at a restart), so the state before
// y is am if bit 3 + y is set, else y.
//
// What bounds it on the H100.  The recursion is sequential along L: with
// 16 subclusters (B = 208, L = 678) the work is 0.85 M (position, state)
// pairs, nothing for the card, and the time is L times the latency of one
// step.  In cells mode (B = 425,984 on a 32768-cell chunk) the card is full
// and the emissions' instructions bound it (1.7 G, each a 15-term
// polynomial or the asymptotic series and one to three logs).  So:
//   * Latency regime (viterbi_latency_kernel, B up to a few per SM): one
//     block a sequence.  Producer warps compute the emissions and restart
//     flags of 32 positions (a lane a position) into a slot of a ring in
//     shared memory, ahead of the recursion, behind two mbarriers a slot
//     (full: 32 producer arrivals; empty: the consumer's), with a flag a
//     slot saying whether its chunk restarts.  Thread 0 alone runs the
//     recursion on nu[S] in registers: a step reads its S emissions from
//     shared memory (off the chain) and leaves on it a max over S (a tree of
//     depth 3) and S max-adds; it logs the nu each step starts from into a
//     second ring, and a chunk that restarts nowhere runs without selects.
//     A packer warp turns each logged chunk into the packed words, a lane a
//     position, so the word's compares and argmax stay off the chain.  The
//     backtrace runs block-wide: a thread a segment maps every end state to
//     its start state, one thread walks the segments' ends, and each thread
//     replays its segment; the block writes the states, coalesced.
//   * Throughput regime (viterbi_batch_kernel): one thread a sequence,
//     persistent blocks sized by the plan so that the rounds over the
//     sequences come out nearly whole; x and the flag read as they come
//     ([B, L]: a thread's row stays in L1 between its steps) a step ahead;
//     the S emissions computed together, so their chains interleave; one
//     16-bit word a step into a [L, B] scratch (the earlier design stored S
//     bytes), and a backtrace that reads one coalesced word a step.
//
// The logSF polynomial and asymptotic series are the reference's (erfcf
// would underflow near z ~ 9; z reaches ~40 here).  Build without
// --use_fast_math and with -fmad=false, so the polynomial rounds as the
// plain PyTorch version does; the update sums in the plain version's order.
#include <cuda_runtime.h>
#include <stdint.h>

#include <cstring>

namespace icnv {

constexpr int kMaxStates = 8;
constexpr int kChunk = 32;     // positions a ring slot (a producer warp's lanes)
constexpr int kMaxRing = 16;   // ring slots at most
constexpr int kHist = 4;       // slots of the consumer's log of nu
constexpr int kLatencyMaxThreads = 256;
constexpr int kBatchThreads = 64;
constexpr int kBatchBlocksPerSm = 24;
// Shared memory of a latency block before its ring: 4 kMaxRing mbarriers,
// the last state, and a flag a ring slot (whether its chunk restarts).
constexpr int kRingHeadBytes = 4 * kMaxRing * 8 + 16 + 4 * kMaxRing;
// Positions of a segment of the block-wide backtrace, at least.
constexpr int kMinSegment = 16;

struct ViterbiParams {
  float means[kMaxStates];
  float log_delta[kMaxStates];
  float log_diag;
  float log_off;
};

// Floats a position takes in a ring slot: its S emissions and restart flag,
// padded to whole float4s.
template <int S>
struct RingStride {
  static constexpr int value = S <= 3 ? 4 : 8;
};

__host__ __device__ inline size_t round16(size_t v) { return (v + 15) & ~size_t(15); }

// Shared memory of a latency block of `threads` threads: the mbarriers and
// the last state, the emission ring and the log of nu (slots of kChunk
// positions, S floats and a flag each, padded to float4s), the backtrace's
// maps (8 bytes a thread), and (when bp_shared) the packed backpointers and
// the states.
__host__ __device__ inline size_t latency_smem_bytes(int S, int L, int ring,
                                                     int threads,
                                                     int bp_shared) {
  const size_t slots =
      (size_t)(ring + kHist) * kChunk * (S <= 3 ? 4 : 8) * sizeof(float);
  return kRingHeadBytes + slots + 8 * (size_t)threads +
         (bp_shared ? round16(2 * (size_t)L) + round16((size_t)L) : 0);
}

// The emissions of x in every state: -log(-logSF(|x - mu_s| / sigma)), with
// the reference's logSF (_LOGSF_POLY, a Chebyshev-derived polynomial of
// -log Phi(-z) on z in [0, 6] in u = z/3 - 1, lowest order first, each
// double literal rounded to float as the reference rounds it; above 6 the
// 4-term asymptotic series).  Each state's value is rounded as its own
// branch rounds it in the plain version, but the S states are computed
// together, so that their independent chains interleave: the polynomial for
// every state, the series for every state only where one of them needs it
// (z >= 6), then the logs.
template <int S>
__device__ __forceinline__ void emissions(float x, float sigma,
                                          const ViterbiParams& p,
                                          float (&em)[S]) {
  float z[S], u[S], q[S];
  bool far = false;
#pragma unroll
  for (int s = 0; s < S; ++s) {
    z[s] = fabsf(x - p.means[s]) / sigma;
    far |= !(z[s] < 6.0f);
    u[s] = z[s] * (1.0f / 3.0f) - 1.0f;
    q[s] = static_cast<float>(-1.018850375361854e-05);
  }
  constexpr float kPoly[14] = {
      static_cast<float>(-1.4737718057576076e-05),
      static_cast<float>(0.00012466292805241087),
      static_cast<float>(-0.0002004534568855845),
      static_cast<float>(0.00016607633590841293),
      static_cast<float>(5.6785208915892025e-06),
      static_cast<float>(-0.0008351692702736372),
      static_cast<float>(0.003606634430994035),
      static_cast<float>(-0.010807058987670455),
      static_cast<float>(0.02750005245776225),
      static_cast<float>(-0.06389011554893194),
      static_cast<float>(0.14161773540308858),
      static_cast<float>(4.182483637492412),
      static_cast<float>(9.849295972346816),
      static_cast<float>(6.6077262216734844)};
#pragma unroll
  for (int c = 0; c < 14; ++c)
#pragma unroll
    for (int s = 0; s < S; ++s) q[s] = q[s] * u[s] + kPoly[c];
  if (far) {
#pragma unroll
    for (int s = 0; s < S; ++s) {
      if (!(z[s] < 6.0f)) {
        const float inv2 = 1.0f / (z[s] * z[s]);
        const float series =
            1.0f +
            inv2 * (-1.0f + inv2 * (3.0f + inv2 * (-15.0f + inv2 * 105.0f)));
        q[s] = 0.5f * z[s] * z[s] + logf(z[s]) +
               static_cast<float>(0.9189385332046727) - logf(series);
      }
    }
  }
#pragma unroll
  for (int s = 0; s < S; ++s) em[s] = -logf(q[s]);
}

// (ma, aa) or (mb, ab), whichever is larger; ties to (ma, aa).
__device__ __forceinline__ void pick(float ma, int aa, float mb, int ab,
                                     float& m, int& a) {
  const bool b = mb > ma;
  m = b ? mb : ma;
  a = b ? ab : aa;
}

// The max of nu and its first index (R's which.max), by a tree whose pairs
// keep the lower index on ties: equal to the sequential first max.
template <int S>
__device__ __forceinline__ void first_max(const float (&nu)[S], float& m,
                                          int& am) {
  static_assert(S == 3 || S == 6, "the i3 or i6 model");
  if constexpr (S == 6) {
    float m01, m23, m45, m03;
    int a01, a23, a45, a03;
    pick(nu[0], 0, nu[1], 1, m01, a01);
    pick(nu[2], 2, nu[3], 3, m23, a23);
    pick(nu[4], 4, nu[5], 5, m45, a45);
    pick(m01, a01, m23, a23, m03, a03);
    pick(m03, a03, m45, a45, m, am);
  } else {
    float m01;
    int a01;
    pick(nu[0], 0, nu[1], 1, m01, a01);
    pick(m01, a01, nu[2], 2, m, am);
  }
}

// One forward step on nu (emissions em, restart flag), without its
// backpointers: the max of nu (its value is the first max's), then each
// state's update, rounded as the plain version rounds it.  kRestart: the
// step may restart the chain (a step known not to takes no select).
template <int S, bool kRestart = true>
__device__ __forceinline__ void advance(float (&nu)[S], const float (&em)[S],
                                        bool restart, const ViterbiParams& p) {
  float m;
  if constexpr (S == 6) {
    m = fmaxf(fmaxf(fmaxf(nu[0], nu[1]), fmaxf(nu[2], nu[3])),
              fmaxf(nu[4], nu[5]));
  } else {
    m = fmaxf(fmaxf(nu[0], nu[1]), nu[2]);
  }
  const float move = m + p.log_off;
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const float best = fmaxf(nu[s] + p.log_diag, move);
    nu[s] = (kRestart && restart ? p.log_delta[s] : best) + em[s];
  }
}

// The packed word of a step from the nu it starts from (and its flag).
template <int S>
__device__ __forceinline__ unsigned word_of(const float (&nu)[S], bool restart,
                                            const ViterbiParams& p) {
  float m;
  int am;
  first_max<S>(nu, m, am);
  const float move = m + p.log_off;
  unsigned mask = 0;
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const float stay = nu[s] + p.log_diag;
    mask |= static_cast<unsigned>(move > stay || (move == stay && am < s)) << s;
  }
  if (restart) mask = (1u << S) - 1;
  return static_cast<unsigned>(am) | (mask << 3);
}

// One forward step on nu (emissions em, restart flag): returns the packed
// backpointer word.
template <int S>
__device__ __forceinline__ unsigned step(float (&nu)[S], const float (&em)[S],
                                         bool restart, const ViterbiParams& p) {
  const unsigned w = word_of<S>(nu, restart, p);
  advance<S>(nu, em, restart, p);
  return w;
}

// The state before y, from the word of y's position.
__device__ __forceinline__ int back(unsigned w, int y) {
  return (w >> (3 + y)) & 1 ? static_cast<int>(w & 7) : y;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_addr(bar))
               : "memory");
}

// Wait until bar has completed the phase of the given parity.  A wait that
// never ends traps (the launch fails) instead of hanging the card.
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

// Ring position k of a slot: S emissions and the flag, as the consumer reads
// them.
template <int S>
__device__ __forceinline__ bool ring_load(const float* slot, int k,
                                          float (&em)[S]) {
  constexpr int kStride = RingStride<S>::value;
  const float4* q = reinterpret_cast<const float4*>(slot + k * kStride);
  const float4 u = q[0];
  if constexpr (S == 3) {
    em[0] = u.x;
    em[1] = u.y;
    em[2] = u.z;
    return u.w != 0.0f;
  } else {
    const float4 v = q[1];
    em[0] = u.x;
    em[1] = u.y;
    em[2] = u.z;
    em[3] = u.w;
    em[4] = v.x;
    em[5] = v.y;
    return v.z != 0.0f;
  }
}

template <int S>
__device__ __forceinline__ void ring_store(float* slot, int k,
                                           const float (&em)[S], bool flag) {
  constexpr int kStride = RingStride<S>::value;
  float4* q = reinterpret_cast<float4*>(slot + k * kStride);
  const float f = flag ? 1.0f : 0.0f;
  if constexpr (S == 3) {
    q[0] = make_float4(em[0], em[1], em[2], f);
  } else {
    q[0] = make_float4(em[0], em[1], em[2], em[3]);
    q[1] = make_float4(em[4], em[5], f, 0.0f);
  }
}

// Log position k of a slot: the nu a step started from and its flag (the
// ring's layout).  The stores are PTX the compiler sees as touching no
// memory of its own (the log and the ring never overlap), so the ring's
// loads of the steps that follow may be issued ahead of them; they stay in
// order with the mbarrier arrivals, which are volatile PTX as well.
__device__ __forceinline__ void st_shared4(float* p, float a, float b, float c,
                                           float d) {
  asm volatile("st.shared.v4.f32 [%0], {%1, %2, %3, %4};" ::"r"(smem_addr(p)),
               "f"(a), "f"(b), "f"(c), "f"(d));
}

template <int S>
__device__ __forceinline__ void log_nu(float* slot, int k, const float (&nu)[S],
                                       bool flag) {
  constexpr int kStride = RingStride<S>::value;
  float* q = slot + k * kStride;
  const float f = flag ? 1.0f : 0.0f;
  if constexpr (S == 3) {
    st_shared4(q, nu[0], nu[1], nu[2], f);
  } else {
    st_shared4(q, nu[0], nu[1], nu[2], nu[3]);
    st_shared4(q + 4, nu[4], nu[5], f, 0.0f);
  }
}

// The consumer's forward pass over one full chunk of kChunk positions:
// emissions and flags from the ring slot, the nu each step starts from
// into the log slot.  kRestart: the chunk restarts somewhere (a chunk
// that restarts nowhere, most of them, takes no select).
template <int S, bool kRestart>
__device__ __forceinline__ void forward_chunk(float (&nu)[S], const float* slot,
                                              float* log, const ViterbiParams& p) {
#pragma unroll
  for (int k = 0; k < kChunk; ++k) {
    float em[S];
    const bool fl = ring_load<S>(slot, k, em) && kRestart;
    log_nu<S>(log, k, nu, fl);
    advance<S, kRestart>(nu, em, fl, p);
  }
}

// The block-wide backtrace: the positions [0, len) in segments of seg
// positions, a thread a segment; words bp[i] (state at i -> state at i - 1)
// for i in [1, len); ylast the state at len - 1.  Each thread maps every
// state at its segment's last position to the state at its first (maps:
// 8 bytes a thread in shared memory; S chains interleaved), thread 0 walks
// the segments' ends from the last, and each thread replays its segment
// from its end, writing the 1-based states into st.
template <int S>
__device__ void block_backtrace(const uint16_t* bp, signed char* st,
                                unsigned char* maps, int len, int ylast) {
  const int T = blockDim.x;
  const int tid = threadIdx.x;
  const int seg = max(kMinSegment, (len + T - 1) / T);
  const int nseg = (len + seg - 1) / seg;
  const int a = tid * seg;
  const int b = min(a + seg, len);
  if (tid < nseg) {
    int y[S];
#pragma unroll
    for (int s = 0; s < S; ++s) y[s] = s;
    for (int i = b - 1; i > a; --i) {
      const unsigned w = bp[i];
#pragma unroll
      for (int s = 0; s < S; ++s) y[s] = back(w, y[s]);
    }
#pragma unroll
    for (int s = 0; s < S; ++s) maps[8 * tid + s] = static_cast<unsigned char>(y[s]);
  }
  __syncthreads();
  if (tid == 0) {
    int y = ylast;  // the state at the last position of segment k
    for (int k = nseg - 1; k >= 0; --k) {
      maps[8 * k + 7] = static_cast<unsigned char>(y);
      const int start = maps[8 * k + y];
      if (k > 0) y = back(bp[k * seg], start);
    }
  }
  __syncthreads();
  if (tid < nseg) {
    int y = maps[8 * tid + 7];
    st[b - 1] = static_cast<signed char>(y + 1);
    for (int i = b - 1; i > a; --i) {
      y = back(bp[i], y);
      st[i - 1] = static_cast<signed char>(y + 1);
    }
  }
}

// Latency regime: block b runs sequence b (x, bnd, out: [B, L]).  Thread 0
// is the consumer: it runs the recursion on nu alone and logs the nu each
// step starts from.  Warp 4 (the last warp of a smaller block) is the
// packer: it turns each chunk of the log into packed words, a lane a
// position.  The other warps are the producers, the j-th of them filling
// the ring with chunks j, j + P, ...  With 8 warps, the consumer and the
// packer share an SM sub-partition (warps 0 and 4 of a block), away from
// the producers' emissions.  Chunk c goes to ring slot c % ring and log
// slot c % kHist.  kShared: the words
// and the states stay in shared memory; else the words go to bp_glob ([B,
// L rounded up to 8]) and the states straight to out.
template <int S, bool kShared>
__global__ void __launch_bounds__(kLatencyMaxThreads)
viterbi_latency_kernel(const float* __restrict__ x, const int* __restrict__ lens,
                       const float* __restrict__ sigma,
                       const signed char* __restrict__ bnd,
                       uint16_t* __restrict__ bp_glob,
                       signed char* __restrict__ out, int L, int ring,
                       ViterbiParams p) {
  extern __shared__ float4 smem4[];
  constexpr int kStride = RingStride<S>::value;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem4);
  uint64_t* empty = full + kMaxRing;
  uint64_t* lfull = empty + kMaxRing;
  uint64_t* lempty = lfull + kMaxRing;
  int* last_state = reinterpret_cast<int*>(lempty + kMaxRing);
  int* restarts = last_state + 4;  // a flag a ring slot
  float* rbuf = reinterpret_cast<float*>(smem4) + kRingHeadBytes / 4;
  float* lbuf = rbuf + ring * kChunk * kStride;
  unsigned char* maps =
      reinterpret_cast<unsigned char*>(lbuf + kHist * kChunk * kStride);
  const int b = blockIdx.x;
  const size_t row = (size_t)b * L;
  uint16_t* bp;
  signed char* st;
  if constexpr (kShared) {
    bp = reinterpret_cast<uint16_t*>(maps + 8 * blockDim.x);
    st = reinterpret_cast<signed char*>(bp) + round16(2 * (size_t)L);
  } else {
    bp = bp_glob + (size_t)b * ((L + 7) & ~7);  // 16-byte aligned rows
    st = out + row;
  }
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int nwarp = blockDim.x >> 5;
  const int packer = nwarp > 5 ? 4 : nwarp - 1;
  const int len = max(min(lens[b], L), 1);
  const int nchunk = (len + kChunk - 1) / kChunk;
  if (tid == 0) {
    for (int r = 0; r < ring; ++r) {
      bar_init(full + r, kChunk);
      bar_init(empty + r, 1);
    }
    for (int h = 0; h < kHist; ++h) {
      bar_init(lfull + h, 1);
      bar_init(lempty + h, kChunk);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == packer) {
    // the words of each logged chunk, a lane a position
    for (int c = 0; c < nchunk; ++c) {
      const int h = c % kHist;
      bar_wait(lfull + h, (c / kHist) & 1);
      const int i = c * kChunk + lane;
      if (i < len) {
        float nu[S];
        const bool fl = ring_load<S>(lbuf + h * kChunk * kStride, lane, nu);
        bp[i] = static_cast<uint16_t>(word_of<S>(nu, fl, p));
      }
      bar_arrive(lempty + h);
    }
  } else if (warp > 0) {
    // producers: the emissions of a chunk, a lane a position (position 0
    // starts the chain; positions at or past len are not computed)
    const int P = nwarp - 2;
    const float sg = sigma[b];
    const float* xb = x + row;
    const signed char* fb = bnd + row;
    int c = warp - 1 - (warp > packer ? 1 : 0);
    int i = c * kChunk + lane;
    float xn = c < nchunk && i < len ? __ldg(xb + i) : 0.0f;
    bool fn = i == 0 || (c < nchunk && i < len && fb[i] != 0);
    for (; c < nchunk; c += P) {
      const float xv = xn;
      const bool fl = fn;
      i = (c + P) * kChunk + lane;
      if (i < len) {
        xn = __ldg(xb + i);
        fn = fb[i] != 0;
      }
      float em[S];
      emissions<S>(xv, sg, p, em);
      const int r = c % ring;
      const int n = c / ring;
      const bool any = __any_sync(0xFFFFFFFFu, fl && c * kChunk + lane < len);
      if (n > 0) bar_wait(empty + r, (n - 1) & 1);
      ring_store<S>(rbuf + r * kChunk * kStride, lane, em, fl);
      if (lane == 0) restarts[r] = any;
      bar_arrive(full + r);
    }
  } else if (tid == 0) {
    // the consumer: the recursion on nu, logged
    float nu[S];
#pragma unroll
    for (int s = 0; s < S; ++s) nu[s] = 0.0f;
    for (int c = 0; c < nchunk; ++c) {
      const int r = c % ring;
      const int h = c % kHist;
      bar_wait(full + r, (c / ring) & 1);
      if (c >= kHist) bar_wait(lempty + h, (c / kHist - 1) & 1);
      const float* slot = rbuf + r * kChunk * kStride;
      float* log = lbuf + h * kChunk * kStride;
      const int i0 = c * kChunk;
      if (i0 + kChunk <= len) {
        if (restarts[r])
          forward_chunk<S, true>(nu, slot, log, p);
        else
          forward_chunk<S, false>(nu, slot, log, p);
      } else {
        for (int k = 0; k < len - i0; ++k) {
          float em[S];
          const bool fl = ring_load<S>(slot, k, em);
          log_nu<S>(log, k, nu, fl);
          advance<S>(nu, em, fl, p);
        }
      }
      bar_arrive(empty + r);
      bar_arrive(lfull + h);
    }
    float m;
    int y;
    first_max<S>(nu, m, y);
    *last_state = y;
  }
  __syncthreads();
  block_backtrace<S>(bp, st, maps, len, *last_state);
  __syncthreads();
  // positions at or past len - 1 repeat the last state
  const signed char last = st[len - 1];
  if constexpr (kShared) {
    for (int i = tid; i < L; i += blockDim.x) out[row + i] = i < len ? st[i] : last;
  } else {
    for (int i = len + tid; i < L; i += blockDim.x) out[row + i] = last;
  }
}

// Throughput regime: a thread a sequence.  x and bnd are read as they come,
// [B, L]: a thread walks its own row, whose 32-byte sectors stay in L1
// between its steps; bp and out are [L, B], so that neighbouring threads
// write neighbouring words.
template <int S>
__global__ void __launch_bounds__(kBatchThreads, kBatchBlocksPerSm)
viterbi_batch_kernel(const float* __restrict__ x, const int* __restrict__ lens,
                     const float* __restrict__ sigma,
                     const signed char* __restrict__ bnd,
                     uint16_t* __restrict__ bp, signed char* __restrict__ out,
                     int B, int L, ViterbiParams p) {
  const size_t sB = static_cast<size_t>(B);
  const int stride = gridDim.x * blockDim.x;
  for (int b = blockIdx.x * blockDim.x + threadIdx.x; b < B; b += stride) {
    const float sg = sigma[b];
    const int len = max(min(lens[b], L), 1);
    float nu[S];
#pragma unroll
    for (int s = 0; s < S; ++s) nu[s] = 0.0f;
    const float* xb = x + (size_t)b * L;
    const signed char* fb = bnd + (size_t)b * L;
    float xn = __ldg(xb);
    bool fn = true;  // position 0 starts the chain
    for (int i = 0; i < len; ++i) {
      const float xv = xn;
      const bool fl = fn;
      if (i + 1 < len) {
        xn = __ldg(xb + i + 1);
        fn = __ldg(fb + i + 1) != 0;
      }
      float em[S];
      emissions<S>(xv, sg, p, em);
      const unsigned w = step<S>(nu, em, fl, p);
      if (i > 0) bp[i * sB + b] = static_cast<uint16_t>(w);
    }
    float m;
    int y;
    first_max<S>(nu, m, y);
    for (int i = L - 1; i >= len - 1; --i)
      out[i * sB + b] = static_cast<signed char>(y + 1);
#pragma unroll 4
    for (int i = len - 2; i >= 0; --i) {
      y = back(bp[(i + 1) * sB + b], y);
      out[i * sB + b] = static_cast<signed char>(y + 1);
    }
  }
}

template <int S>
cudaError_t launch_viterbi(const float* x, const int* lens, const float* sigma,
                           const signed char* bnd, uint16_t* bp,
                           signed char* out, int B, int L,
                           const ViterbiParams& p, int regime, int threads,
                           int blocks, int ring, int bp_shared, int smem,
                           cudaStream_t stream) {
  int dev = 0, optin = 0, nsm = 0, occ = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  if (smem > optin) return cudaErrorInvalidValue;
  if (regime == 0) {
    auto kern = bp_shared ? viterbi_latency_kernel<S, true>
                          : viterbi_latency_kernel<S, false>;
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kern, threads,
                                                        smem);
    if (e != cudaSuccess) return e;
    if (occ < 1) return cudaErrorInvalidConfiguration;
    kern<<<B, threads, smem, stream>>>(x, lens, sigma, bnd, bp, out, L, ring,
                                       p);
  } else {
    auto kern = viterbi_batch_kernel<S>;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kern, threads, 0);
    if (e != cudaSuccess) return e;
    // persistent blocks: all of them resident
    if ((long long)occ * nsm < blocks) return cudaErrorInvalidConfiguration;
    kern<<<blocks, threads, 0, stream>>>(x, lens, sigma, bnd, bp, out, B, L, p);
  }
  return cudaGetLastError();
}

}  // namespace icnv

// means / log_delta: S floats each, in host memory (copied into the launch).
// x, bnd: [B, L].  The launch plan of ops/viterbi_kernel.py ViterbiPlan:
// regime (0 latency: out [B, L], bp [B, L rounded up to 8] unless
// bp_shared; 1 throughput: bp, out [L, B]), threads, blocks, ring,
// bp_shared, smem (bytes).  A plan the card cannot hold is refused.
extern "C" int ic_viterbi(const float* x, const int* lens, const float* sigma,
                          const signed char* bnd, void* bp, signed char* out,
                          int B, int L, int S, const float* means,
                          const float* log_delta, float log_diag,
                          float log_off, int regime, int threads, int blocks,
                          int ring, int bp_shared, int smem, void* stream) {
  using namespace icnv;
  if (B < 0 || L <= 0 || (S != 3 && S != 6))
    return static_cast<int>(cudaErrorInvalidValue);
  if (regime == 0) {
    if (threads < 96 || threads > kLatencyMaxThreads || threads % 32 ||
        ring < 1 || ring > kMaxRing || blocks != B ||
        (size_t)smem != latency_smem_bytes(S, L, ring, threads, bp_shared) ||
        (!bp_shared && bp == nullptr))
      return static_cast<int>(cudaErrorInvalidValue);
  } else if (regime == 1) {
    if (threads != kBatchThreads || blocks < 1 || smem != 0 || bp == nullptr)
      return static_cast<int>(cudaErrorInvalidValue);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B == 0) return 0;
  ViterbiParams p{};
  std::memcpy(p.means, means, sizeof(float) * S);
  std::memcpy(p.log_delta, log_delta, sizeof(float) * S);
  p.log_diag = log_diag;
  p.log_off = log_off;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  uint16_t* w = static_cast<uint16_t*>(bp);
  const cudaError_t e =
      S == 3 ? launch_viterbi<3>(x, lens, sigma, bnd, w, out, B, L, p, regime,
                                 threads, blocks, ring, bp_shared, smem, s)
             : launch_viterbi<6>(x, lens, sigma, bnd, w, out, B, L, p, regime,
                                 threads, blocks, ring, bp_shared, smem, s);
  return static_cast<int>(e);
}
