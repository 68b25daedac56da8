// Viterbi over B padded, bin-packed sequences: one thread per sequence.
//
// Replaces the TPU kernel infercnv_tpu/ops/viterbi_pallas.py::_viterbi_kernel
// (launched by _viterbi_pallas_call / viterbi_pallas, emission through
// _log_sf_std_normal).  Per sequence b of valid length lens[b]:
//   emission  em_s = -log(-logSF(|x - mu_s| / sigma_b))   (unnormalised)
//   forward   nu_s <- max(nu_s + log_diag, max_j nu_j + log_off) + em_s,
//             backpointer ties to the first state (R's which.max);
//             a 1 in bnd restarts the chain (log_delta + em) and stores the
//             previous segment's argmax in backpointer row 0
//   backtrace from the argmax at the last valid position; positions at or
//             past lens[b] repeat that state
// and writes 1-based int8 states.  Built for the two models of the
// reference: i6 (S = 6) and i3 (S = 3, R/inferCNV_i3HMM.R).
//
// What bounds it on the H100: the recursion is sequential along L, so one
// thread carries one sequence and the card is filled only by the batch.  In
// cells mode (B = 425,984 on a 32768-cell chunk) that is ~3,300 blocks and
// the kernel streams x in and states out; with 16 subclusters (B = 208) it
// is two blocks and latency-bound on the L = 678 dependent steps, about
// 25 flops and a log per state each.  The design keeps nu[S] in registers,
// computes emissions on the fly (no [L, S, B] emission tensor), and keeps the
// int8 backpointers in a caller-allocated scratch laid out [L, S, B], so that
// neighbouring threads write neighbouring bytes at every step.
//
// The logSF polynomial and asymptotic series are the reference's (erfcf
// would underflow near z ~ 9; z reaches ~40 here).  Build without
// --use_fast_math and with -fmad=false, so the polynomial rounds as the
// plain PyTorch version does.
#include <cuda_runtime.h>

#include <cstring>

namespace icnv {

constexpr int kMaxStates = 8;
constexpr int kViterbiThreads = 128;

struct ViterbiParams {
  float means[kMaxStates];
  float log_delta[kMaxStates];
  float log_diag;
  float log_off;
};

// Chebyshev-derived polynomial of f(z) = -log Phi(-z) on z in [0, 6],
// in u = z/3 - 1 (the reference's _LOGSF_POLY, lowest order first; each
// double literal is rounded to float as the reference rounds it).
__device__ __forceinline__ float log_sf_std_normal(float z) {
  if (z < 6.0f) {
    const float u = z * (1.0f / 3.0f) - 1.0f;
    float p = static_cast<float>(-1.018850375361854e-05);
    p = p * u + static_cast<float>(-1.4737718057576076e-05);
    p = p * u + static_cast<float>(0.00012466292805241087);
    p = p * u + static_cast<float>(-0.0002004534568855845);
    p = p * u + static_cast<float>(0.00016607633590841293);
    p = p * u + static_cast<float>(5.6785208915892025e-06);
    p = p * u + static_cast<float>(-0.0008351692702736372);
    p = p * u + static_cast<float>(0.003606634430994035);
    p = p * u + static_cast<float>(-0.010807058987670455);
    p = p * u + static_cast<float>(0.02750005245776225);
    p = p * u + static_cast<float>(-0.06389011554893194);
    p = p * u + static_cast<float>(0.14161773540308858);
    p = p * u + static_cast<float>(4.182483637492412);
    p = p * u + static_cast<float>(9.849295972346816);
    p = p * u + static_cast<float>(6.6077262216734844);
    return -p;
  }
  const float inv2 = 1.0f / (z * z);
  const float series =
      1.0f + inv2 * (-1.0f + inv2 * (3.0f + inv2 * (-15.0f + inv2 * 105.0f)));
  const float asym = 0.5f * z * z + logf(z) +
                     static_cast<float>(0.9189385332046727) - logf(series);
  return -asym;
}

__device__ __forceinline__ float emission(float x, float mu, float sigma) {
  const float z = fabsf(x - mu) / sigma;
  return -logf(-log_sf_std_normal(z));
}

template <int S>
__global__ void __launch_bounds__(kViterbiThreads)
viterbi_kernel(const float* __restrict__ x,          // [L, B]
               const int* __restrict__ lens,         // [B]
               const float* __restrict__ sigma,      // [B]
               const signed char* __restrict__ bnd,  // [L, B]
               signed char* __restrict__ bp,         // [L, S, B] scratch
               signed char* __restrict__ out,        // [L, B]
               int B, int L, ViterbiParams p) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const size_t sB = static_cast<size_t>(B);
  const float sg = sigma[b];
  const int len = min(lens[b], L);
  float nu[S];
  {
    const float xv = x[b];
#pragma unroll
    for (int s = 0; s < S; ++s)
      nu[s] = p.log_delta[s] + emission(xv, p.means[s], sg);
  }
  for (int i = 1; i < len; ++i) {
    const float xv = x[i * sB + b];
    const bool restart = bnd[i * sB + b] != 0;
    float m = nu[0];
    int am = 0;
#pragma unroll
    for (int s = 1; s < S; ++s) {
      if (nu[s] > m) {
        m = nu[s];
        am = s;
      }
    }
    const float move = m + p.log_off;
    signed char* bpi = bp + static_cast<size_t>(i) * S * sB + b;
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const float em = emission(xv, p.means[s], sg);
      int arg;
      if (restart) {
        nu[s] = p.log_delta[s] + em;
        arg = s == 0 ? am : s;
      } else {
        const float stay = nu[s] + p.log_diag;
        nu[s] = fmaxf(stay, move) + em;
        arg = stay > move ? s : (move > stay ? am : min(s, am));
      }
      bpi[s * sB] = static_cast<signed char>(arg);
    }
  }
  float m = nu[0];
  int y = 0;
#pragma unroll
  for (int s = 1; s < S; ++s) {
    if (nu[s] > m) {
      m = nu[s];
      y = s;
    }
  }
  for (int i = L - 1; i >= max(len - 1, 0); --i)
    out[i * sB + b] = static_cast<signed char>(y + 1);
  for (int i = len - 2; i >= 0; --i) {
    const signed char* row = bp + static_cast<size_t>(i + 1) * S * sB + b;
    y = bnd[(i + 1) * sB + b] != 0 ? row[0] : row[y * sB];
    out[i * sB + b] = static_cast<signed char>(y + 1);
  }
}

template <int S>
cudaError_t launch_viterbi(const float* x, const int* lens, const float* sigma,
                           const signed char* bnd, signed char* bp,
                           signed char* out, int B, int L,
                           const ViterbiParams& p, cudaStream_t stream) {
  const int grid = (B + kViterbiThreads - 1) / kViterbiThreads;
  viterbi_kernel<S><<<grid, kViterbiThreads, 0, stream>>>(x, lens, sigma, bnd,
                                                          bp, out, B, L, p);
  return cudaGetLastError();
}

}  // namespace icnv

// means / log_delta: S floats each, in host memory (copied into the launch).
extern "C" int ic_viterbi(const float* x, const int* lens, const float* sigma,
                          const signed char* bnd, signed char* bp,
                          signed char* out, int B, int L, int S,
                          const float* means, const float* log_delta,
                          float log_diag, float log_off, void* stream) {
  using namespace icnv;
  if (B < 0 || L <= 0 || (S != 3 && S != 6))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  ViterbiParams p{};
  std::memcpy(p.means, means, sizeof(float) * S);
  std::memcpy(p.log_delta, log_delta, sizeof(float) * S);
  p.log_diag = log_diag;
  p.log_off = log_off;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      S == 3 ? launch_viterbi<3>(x, lens, sigma, bnd, bp, out, B, L, p, s)
             : launch_viterbi<6>(x, lens, sigma, bnd, bp, out, B, L, p, s);
  return static_cast<int>(e);
}
