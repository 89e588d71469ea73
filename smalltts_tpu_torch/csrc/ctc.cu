// The CTC recurrence of optax.ctc_loss for Hopper (sm_90a), forward and
// backward. It has no Pallas counterpart: the JAX package's ASR trainer and
// distiller run optax.ctc_loss inside their jitted steps, where XLA makes
// the recurrence one loop on the device (smalltts_tpu/train/asr_train.py:34,
// smalltts_tpu/train/distill.py). The port ran it as a Python loop of about
// ten PyTorch ops a frame and their autograd backward.
//
// What it computes, per sequence b, over T frames and N label positions:
// the blank states phi (N + 1) and the label states emit (N), log(0) = -1e5
// (finite). A frame t with log-probs lpe[n] (label n) and lpp (blank):
//
//   pin[0]   = phi[0]
//   pin[j]   = lae(phi[j], emit[j-1] + er[j-1])                 j = 1..N
//   emit'[n] = lae(pin[n] + lpe[n], emit[n] + lpe[n])           n = 0..N-1
//   phi'[0]  = pin[0] + lpp
//   phi'[j]  = lae(pin[j] + lpp, (emit[j-1] + lpp) + enr[j-1])  j = 1..N
//
// with lae(a, b) = max(a, b) + log1p(exp(-|a - b|)) (jnp.logaddexp), er =
// -1e5 * repeat and enr = -1e5 * (1 - repeat) (repeat[n] = 1 where label n
// equals label n + 1; the last is 0). A padded frame keeps its states. Every
// label position runs through the recurrence, also those past the sequence's
// label count; only the final gather reads the count l: loss = -(l == 0 ?
// phi[0] : lae(phi[l], emit[l-1])). The backward is the adjoint of exactly
// these fp32 operations in reverse time, with JAX's derivative of lae,
// g * exp(a - out) and g * exp(b - out) (at a tie each side takes ~0.5; at
// the -1e5 values out is rounded to 0.0078, and the derivative follows the
// rounded out as JAX's does); a padded frame passes its adjoint through.
//
// What bounds it on the H100: neither bytes nor operations but the chain.
// Frame t + 1 needs every state of frame t, so a sequence is T dependent
// steps, each a few exp/log1p deep. At the trainers' (2, 1024, 198) the
// bytes (the log-probs in, the states out: 4.9 MB) take 1.5 us at 3.35 TB/s;
// the chain, 1024 steps of a few hundred cycles, takes about a millisecond.
// The design keeps each step short: one block a sequence (B blocks; the card
// is mostly idle, and nothing in one sequence can run ahead of its chain);
// the states in shared memory, double-buffered, so a step is one
// __syncthreads(); each thread owns ceil((N + 1) / blockDim) state indices
// j (phi[j] and emit[j]) and reads its neighbour's emit[j - 1] from shared
// memory; the next frame's log-probs and padding are loaded into registers
// before the barrier, so the load overlaps the step. fp32 throughout, with
// expf/log1pf (no fast math: the values must match the PyTorch ops' to an
// ulp). The forward writes the states after every frame, (B, T + 1, 2N + 1)
// fp32, for the backward. The backward keeps the adjoint in shared memory in
// parts (phi's; emit's own-index part and the two from index j + 1, summed
// where read), so a step is again one barrier, and reduces the blank
// log-prob's adjoint over the states by warp shuffles, the warps' partial
// sums added by thread 0 after the next barrier. Its products and sums are
// __fmul_rn/__fadd_rn in the plain version's order (no contracted FMA, no
// other association), since the T-step chain is ill-conditioned in fp32 and
// carries a rounding difference of one step into every earlier frame's
// gradient: the adjoint's chain is the plain version's, op for op; only the
// blank adjoint's sum over the states, which feeds no later step, is taken
// in another order.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kLogEps = -1e5f;  // optax's log_epsilon

__device__ __forceinline__ float lae(float a, float b) {
  return fmaxf(a, b) + log1pf(expf(-fabsf(a - b)));
}

// forward: one block a sequence, PER state indices a thread
template <int PER>
__global__ void ctc_forward_kernel(const float* __restrict__ lp_emit, const float* __restrict__ lp_phi,
                                   const float* __restrict__ pad, const float* __restrict__ repeat,
                                   const int* __restrict__ labellens, float* __restrict__ alpha,
                                   float* __restrict__ loss, int T, int N) {
  extern __shared__ float sm[];  // two buffers of S: phi (N + 1), then emit (N)
  const int b = blockIdx.x, tid = threadIdx.x, bd = blockDim.x;
  const int S = 2 * N + 1;
  lp_emit += (size_t)b * T * N;
  lp_phi += (size_t)b * T;
  pad += (size_t)b * T;
  repeat += (size_t)b * N;
  alpha += (size_t)b * (T + 1) * S;

  float er[PER], enr[PER], lpe[PER], lpe_nx[PER];
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int j = tid + k * bd;
    const float r = (j >= 1 && j <= N) ? repeat[j - 1] : 0.f;
    er[k] = kLogEps * r;
    enr[k] = kLogEps * (1.f - r);
    lpe_nx[k] = (j < N && T > 0) ? lp_emit[j] : 0.f;
  }
  float lpp_nx = T > 0 ? lp_phi[0] : 0.f, pad_nx = T > 0 ? pad[0] : 0.f;
  for (int i = tid; i < S; i += bd) {
    const float v = i == 0 ? 0.f : kLogEps;
    sm[i] = v;
    alpha[i] = v;
  }
  __syncthreads();

  int cur = 0;
  for (int t = 0; t < T; ++t) {
#pragma unroll
    for (int k = 0; k < PER; ++k) lpe[k] = lpe_nx[k];
    const float lpp = lpp_nx, pd = pad_nx;
    if (t + 1 < T) {  // the next frame's inputs, in flight across this step
#pragma unroll
      for (int k = 0; k < PER; ++k) {
        const int j = tid + k * bd;
        if (j < N) lpe_nx[k] = lp_emit[(size_t)(t + 1) * N + j];
      }
      lpp_nx = lp_phi[t + 1];
      pad_nx = pad[t + 1];
    }
    const float* P = sm + cur * S;
    const float* E = P + (N + 1);
    float* NP = sm + (cur ^ 1) * S;
    float* NE = NP + (N + 1);
    float* out = alpha + (size_t)(t + 1) * S;
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int j = tid + k * bd;
      if (j > N) break;
      const float pj = P[j];
      float nphi, nemit = 0.f;
      if (pd != 0.f) {
        nphi = pj;
        if (j < N) nemit = E[j];
      } else {
        const float em1 = j > 0 ? E[j - 1] : 0.f;
        const float pin = j == 0 ? pj : lae(pj, em1 + er[k]);
        if (j < N) {
          const float ej = E[j];
          nemit = lae(pin + lpe[k], ej + lpe[k]);
        }
        nphi = j == 0 ? pin + lpp : lae(pin + lpp, (em1 + lpp) + enr[k]);
      }
      NP[j] = nphi;
      out[j] = nphi;
      if (j < N) {
        NE[j] = nemit;
        out[N + 1 + j] = nemit;
      }
    }
    __syncthreads();
    cur ^= 1;
  }
  if (tid == 0) {
    const float* P = sm + cur * S;
    const float* E = P + (N + 1);
    const int l = min(max(labellens[b], 0), N);
    loss[b] = -(l == 0 ? P[0] : lae(P[l], E[l - 1]));
  }
}

// backward: the adjoint of the forward's frames in reverse time
template <int PER>
__global__ void ctc_backward_kernel(const float* __restrict__ g, const float* __restrict__ lp_emit,
                                    const float* __restrict__ lp_phi, const float* __restrict__ pad,
                                    const float* __restrict__ repeat, const int* __restrict__ labellens,
                                    const float* __restrict__ alpha, float* __restrict__ d_emit,
                                    float* __restrict__ d_phi, int T, int N) {
  // two buffers of A = 4N + 3: gP (N + 1), gB (N), gD (N + 1), gQ (N + 1); then the warp sums, two
  // sets of 32. emit n's adjoint is (gB[n] + gD[n + 1]) + gQ[n + 1]: its own index's next_emit part,
  // then index n + 1's next_phi and phi_in parts, added in the plain version's order
  extern __shared__ float sm[];
  const int b = blockIdx.x, tid = threadIdx.x, bd = blockDim.x;
  const int S = 2 * N + 1, A = 4 * N + 3;
  const int lane = tid & 31, warp = tid >> 5, nwarps = (bd + 31) >> 5;
  float* wsum = sm + 2 * A;
  lp_emit += (size_t)b * T * N;
  lp_phi += (size_t)b * T;
  pad += (size_t)b * T;
  repeat += (size_t)b * N;
  alpha += (size_t)b * (T + 1) * S;
  d_emit += (size_t)b * T * N;
  d_phi += (size_t)b * T;

  for (int i = tid; i < A; i += bd) sm[i] = 0.f;
  __syncthreads();
  if (tid == 0) {  // the final gather's adjoint: -g into phi_last[l]
    const float* P = alpha + (size_t)T * S;
    const float* E = P + (N + 1);
    const int l = min(max(labellens[b], 0), N);
    const float ct = -g[b];
    if (l == 0) {
      sm[0] = ct;
    } else {
      const float out = lae(P[l], E[l - 1]);
      sm[l] = __fmul_rn(ct, expf(P[l] - out));
      sm[(N + 1) + (l - 1)] = __fmul_rn(ct, expf(E[l - 1] - out));
    }
  }

  float er[PER], enr[PER], lpe[PER], lpe_nx[PER], p[PER], em1[PER], e[PER], p_nx[PER], em1_nx[PER], e_nx[PER];
  auto load = [&](int t, float* lpe_d, float* p_d, float* em1_d, float* e_d) {
    const float* P = alpha + (size_t)t * S;
    const float* E = P + (N + 1);
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int j = tid + k * bd;
      lpe_d[k] = j < N ? lp_emit[(size_t)t * N + j] : 0.f;
      p_d[k] = j <= N ? P[j] : 0.f;
      em1_d[k] = (j >= 1 && j <= N) ? E[j - 1] : 0.f;
      e_d[k] = j < N ? E[j] : 0.f;
    }
  };
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int j = tid + k * bd;
    const float r = (j >= 1 && j <= N) ? repeat[j - 1] : 0.f;
    er[k] = kLogEps * r;
    enr[k] = kLogEps * (1.f - r);
  }
  float lpp_nx = 0.f, pad_nx = 0.f;
  if (T > 0) {
    load(T - 1, lpe_nx, p_nx, em1_nx, e_nx);
    lpp_nx = lp_phi[T - 1];
    pad_nx = pad[T - 1];
  }
  __syncthreads();

  int cur = 0;
  for (int t = T - 1; t >= 0; --t) {
    const int par = t & 1;
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      lpe[k] = lpe_nx[k];
      p[k] = p_nx[k];
      em1[k] = em1_nx[k];
      e[k] = e_nx[k];
    }
    const float lpp = lpp_nx, pd = pad_nx;
    if (t > 0) {
      load(t - 1, lpe_nx, p_nx, em1_nx, e_nx);
      lpp_nx = lp_phi[t - 1];
      pad_nx = pad[t - 1];
    }
    if (tid == 0 && t + 1 < T) {  // frame t + 1's blank adjoint: its warps' sums, complete after the barrier
      float s = 0.f;
      for (int w = 0; w < nwarps; ++w) s += wsum[32 * (par ^ 1) + w];
      d_phi[t + 1] = s;
    }
    const float* gP = sm + cur * A;
    const float* gB = gP + (N + 1);
    const float* gD = gB + N;
    const float* gQ = gD + (N + 1);
    float* nP = sm + (cur ^ 1) * A;
    float* nB = nP + (N + 1);
    float* nD = nB + N;
    float* nQ = nD + (N + 1);
    float lpsum = 0.f;
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int j = tid + k * bd;
      if (j > N) break;
      const float GP = gP[j];
      const float GE = j < N ? __fadd_rn(__fadd_rn(gB[j], gD[j + 1]), gQ[j + 1]) : 0.f;
      if (pd != 0.f) {  // a padded frame: the adjoint passes through, no log-prob gets any
        nP[j] = GP;
        nD[j] = 0.f;
        nQ[j] = 0.f;
        if (j < N) {
          nB[j] = GE;
          d_emit[(size_t)t * N + j] = 0.f;
        }
        continue;
      }
      const float er_e = em1[k] + er[k];
      const float pin = j == 0 ? p[k] : lae(p[k], er_e);
      float dA = 0.f;
      if (j < N) {
        const float a = pin + lpe[k], bv = e[k] + lpe[k];
        const float ne = lae(a, bv);
        dA = __fmul_rn(GE, expf(a - ne));
        const float dB = __fmul_rn(GE, expf(bv - ne));
        nB[j] = dB;
        d_emit[(size_t)t * N + j] = __fadd_rn(dA, dB);
      }
      if (j == 0) {
        nP[0] = __fadd_rn(dA, GP);
        nD[0] = 0.f;
        nQ[0] = 0.f;
        lpsum += GP;
      } else {
        const float c = pin + lpp, d = (em1[k] + lpp) + enr[k];
        const float np = lae(c, d);
        const float dC = __fmul_rn(GP, expf(c - np)), dD = __fmul_rn(GP, expf(d - np));
        lpsum += __fadd_rn(dC, dD);
        const float dpin = __fadd_rn(dA, dC);
        nP[j] = __fmul_rn(dpin, expf(p[k] - pin));
        nD[j] = dD;
        nQ[j] = __fmul_rn(dpin, expf(er_e - pin));
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) lpsum += __shfl_xor_sync(0xffffffffu, lpsum, o);
    if (lane == 0) wsum[32 * par + warp] = lpsum;
    __syncthreads();
    cur ^= 1;
  }
  if (tid == 0 && T > 0) {
    float s = 0.f;
    for (int w = 0; w < nwarps; ++w) s += wsum[w];  // frame 0's, parity 0
    d_phi[0] = s;
  }
}

// threads a block: one state index a thread up to 512, then PER a thread
int block_threads(int N) {
  const int n = ((N + 1 + 31) / 32) * 32;
  return n > 512 ? 512 : n;
}

template <typename... Args>
cudaError_t launch(void (*kernel)(Args...), int B, int threads, size_t smem, cudaStream_t s, Args... args) {
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kernel<<<B, threads, smem, s>>>(args...);
  return cudaGetLastError();
}

}  // namespace

// lp_emit (B, T, N), lp_phi (B, T), pad (B, T), repeat (B, N) fp32, labellens
// (B,) int32 in [0, N], all contiguous; writes alpha (B, T + 1, 2N + 1) and
// loss (B,). N from 1 to 4095.
extern "C" int st_ctc_forward(const float* lp_emit, const float* lp_phi, const float* pad, const float* repeat,
                              const int* labellens, float* alpha, float* loss, int B, int T, int N, void* stream) {
  if (N < 1 || B < 1 || T < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int threads = block_threads(N), per = (N + 1 + threads - 1) / threads;
  const size_t smem = 2 * (size_t)(2 * N + 1) * sizeof(float);
#define ST_CTC_FWD(P) \
  launch(ctc_forward_kernel<P>, B, threads, smem, s, lp_emit, lp_phi, pad, repeat, labellens, alpha, loss, T, N)
  if (per <= 1) return (int)ST_CTC_FWD(1);
  if (per <= 2) return (int)ST_CTC_FWD(2);
  if (per <= 4) return (int)ST_CTC_FWD(4);
  if (per <= 8) return (int)ST_CTC_FWD(8);
#undef ST_CTC_FWD
  return (int)cudaErrorInvalidValue;
}

// g (B,), the forward's inputs and its alpha; writes d_emit (B, T, N) and d_phi (B, T)
extern "C" int st_ctc_backward(const float* g, const float* lp_emit, const float* lp_phi, const float* pad,
                               const float* repeat, const int* labellens, const float* alpha, float* d_emit,
                               float* d_phi, int B, int T, int N, void* stream) {
  if (N < 1 || B < 1 || T < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int threads = block_threads(N), per = (N + 1 + threads - 1) / threads;
  const size_t smem = (2 * (size_t)(4 * N + 3) + 64) * sizeof(float);
#define ST_CTC_BWD(P)                                                                                        \
  launch(ctc_backward_kernel<P>, B, threads, smem, s, g, lp_emit, lp_phi, pad, repeat, labellens, alpha, d_emit, \
         d_phi, T, N)
  if (per <= 1) return (int)ST_CTC_BWD(1);
  if (per <= 2) return (int)ST_CTC_BWD(2);
  if (per <= 4) return (int)ST_CTC_BWD(4);
  if (per <= 8) return (int)ST_CTC_BWD(8);
#undef ST_CTC_BWD
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* st_ctc_error(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
