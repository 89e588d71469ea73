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
// Frame t + 1 needs the states of frame t, so a sequence is T dependent
// steps. At the trainers' (2, 1024, 198) the bytes (4.9 MB) take 1.5 us at
// 3.35 TB/s; the chain takes a tenth of a millisecond or more. fp32
// throughout, with expf/log1pf (no fast math: the values must match the
// PyTorch ops' to an ulp), and every product and sum of the adjoint as
// __fmul_rn/__fadd_rn in the plain version's order (no contracted FMA, no
// other association): the T-step chain is ill-conditioned in fp32 and
// carries a rounding difference of one step into every earlier frame's
// gradient. Only the blank adjoint's sum over the states, which feeds no
// later step, is taken in another order.
//
// Padded frames. A padded frame keeps the forward's states and passes the
// adjoint through but for folding in the neighbour's parts (zero after a
// padded frame): a run of them needs no exchange and no barrier, so the
// trainers' batches, mostly padding, pay for their unpadded frames. The
// forward reads the flags only where a run starts (run_length); the
// backward carries them as bits, 32 frames a word, loaded 64 frames ahead
// (PadBits). No frame waits for its flag.
//
// The forward (ctc_forward_kernel). One block a sequence, one state a
// thread up to 512 states, then PER (2 to 8) a thread. The states live in
// shared memory, double-buffered, so an unpadded frame is one
// __syncthreads(), and its chain is two lae deep; each thread loads the
// next frame's inputs a frame ahead. A run of unpadded frames is a counted
// loop with running pointers to the inputs and to alpha's rows: a test of
// the padding in every frame, or addresses recomputed from t each frame,
// made every unpadded frame slower. A padded run writes its rows of alpha
// from the states as they are.
//
// The backward (ctc_backward_kernel), one launch of two kinds of blocks.
// Every exp/log of the adjoint depends on the forward's states and the
// log-probs only, never on the adjoint: for each (b, t, j) six multipliers
// expf(a - ne), expf(bv - ne), expf(c - np), expf(d - np), expf(p - pin),
// expf(er_e - pin) (the same expressions as the forward's, so the same
// bits). The factor blocks compute these for groups of G frames of a
// sequence, in the order the chains consume them (last frame first),
// spread over the card, into a (B, T, 6 Np) fp32 buffer, and publish each
// group with a release store of its flag. One chain block a sequence walks
// t from T - 1 down to 0 and does only the adjoint's products and sums: a
// producer warp checks the flags of 32 groups at once and copies blocks of
// K frames of multipliers (one 1-D bulk copy each, cp.async.bulk on an
// mbarrier) into a ring of NB block slots in shared memory, so no global
// load sits on the chain; the consumer threads, PER contiguous states each,
// hold the adjoint in registers and exchange only the neighbour's two
// values (gD, gQ of state j + 1) through shared memory, one named barrier a
// frame. The blank adjoint's per-thread sums go to the producer warp, which
// adds them off the chain. Work is claimed through one counter: a chain's
// producer that finds its group unclaimed claims and computes groups
// itself, so the launch finishes however many blocks are resident.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "sm90_common.cuh"

namespace {

constexpr float kLogEps = -1e5f;  // optax's log_epsilon
constexpr int kMaxConsumers = 512;

__device__ __forceinline__ float lae(float a, float b) {
  return fmaxf(a, b) + log1pf(expf(-fabsf(a - b)));
}

// every wait below completes within microseconds; one that has spun ~10 s
// lost its partner, and traps (a launch error) rather than hang the card
__device__ __forceinline__ void watchdog(long long t0) {
  if (clock64() - t0 > (1ll << 34)) __trap();
}

// ------------------------------------------------------------------ forward

// the frames from t on whose padding is frame t's, to T: 128 flags at a
// time in the lanes of each warp. It runs where a run starts, so its loads'
// latency is paid once a run, not once a frame.
__device__ __forceinline__ int run_length(const float* pad, int T, int t, bool padded) {
  const int lane = threadIdx.x & 31;
  int L = 0;
  for (int base = t; base < T; base += 128) {
    bool same[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int f = base + 32 * q + lane;
      same[q] = f < T && (pad[f] != 0.f) == padded;
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const unsigned m = __ballot_sync(0xffffffffu, same[q]);
      const int run = m == 0xffffffffu ? 32 : __ffs(~m) - 1;
      L += run;
      if (run < 32) return L;
    }
  }
  return L;
}

// a padded run's L rows of alpha from `out`: this thread's states,
// unchanged (phi at P, emit at P + N + 1)
template <int PER>
__device__ void write_run(float* out, const float* P, int S, int N, int L) {
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int j = threadIdx.x + k * blockDim.x;
    if (j > N) break;
    const float ph = P[j], em = j < N ? P[N + 1 + j] : 0.f;
    for (int q = 0; q < L; ++q) {
      out[(size_t)q * S + j] = ph;
      if (j < N) out[(size_t)q * S + N + 1 + j] = em;
    }
  }
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
  float lpp_nx = T > 0 ? lp_phi[0] : 0.f;
  for (int i = tid; i < S; i += bd) {
    const float v = i == 0 ? 0.f : kLogEps;
    sm[i] = v;
    alpha[i] = v;
  }
  __syncthreads();

  // runs of frames of one padding; an unpadded run takes a barrier a frame
  int cur = 0;
  for (int t = 0; t < T;) {
    const bool padded = pad[t] != 0.f;
    const int L = run_length(pad, T, t, padded);
    if (padded) {  // the states as they are: no exchange, no barrier
      write_run<PER>(alpha + (size_t)(t + 1) * S, sm + cur * S, S, N, L);
      t += L;
      if (t < T) {  // the next frame's inputs
#pragma unroll
        for (int k = 0; k < PER; ++k) {
          const int j = tid + k * bd;
          if (j < N) lpe_nx[k] = lp_emit[(size_t)t * N + j];
        }
        lpp_nx = lp_phi[t];
      }
      continue;
    }
    // running pointers: the next frame's log-probs, this frame's row of alpha
    const float* lpe_src = lp_emit + (size_t)(t + 1) * N;
    float* out = alpha + (size_t)(t + 1) * S;
    for (const int end = t + L; t < end; ++t, lpe_src += N, out += S) {
#pragma unroll
      for (int k = 0; k < PER; ++k) lpe[k] = lpe_nx[k];
      const float lpp = lpp_nx;
      if (t + 1 < T) {  // the next frame's inputs, in flight across this step
#pragma unroll
        for (int k = 0; k < PER; ++k) {
          const int j = tid + k * bd;
          if (j < N) lpe_nx[k] = lpe_src[j];
        }
        lpp_nx = lp_phi[t + 1];
      }
      const float* P = sm + cur * S;
      const float* E = P + (N + 1);
      float* NP = sm + (cur ^ 1) * S;
      float* NE = NP + (N + 1);
#pragma unroll
      for (int k = 0; k < PER; ++k) {
        const int j = tid + k * bd;
        if (j > N) break;
        const float pj = P[j];
        const float em1 = j > 0 ? E[j - 1] : 0.f;
        const float pin = j == 0 ? pj : lae(pj, em1 + er[k]);
        float nemit = 0.f;
        if (j < N) {
          const float ej = E[j];
          nemit = lae(pin + lpe[k], ej + lpe[k]);
        }
        const float nphi = j == 0 ? pin + lpp : lae(pin + lpp, (em1 + lpp) + enr[k]);
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
  }
  if (tid == 0) {
    const float* P = sm + cur * S;
    const float* E = P + (N + 1);
    const int l = min(max(labellens[b], 0), N);
    loss[b] = -(l == 0 ? P[0] : lae(P[l], E[l - 1]));
  }
}

// ------------------------------------------------------------------ backward

// a sequence's padding flags as bits, 32 steps a chunk (step i is frame
// T - 1 - i: the backward walks time in reverse), read 64 steps ahead so no
// step waits for a global load: `cm` holds the current chunk (bit i & 31 of
// step i), `nm` the next. Every lane of the warp runs every step.
struct PadBits {
  const float* src;
  int T, lane;
  unsigned cm, nm;
  float pend;
  __device__ __forceinline__ float load(int i) const { return i < T ? src[T - 1 - i] : 0.f; }
  __device__ __forceinline__ PadBits(const float* s, int T_) : src(s), T(T_), lane(threadIdx.x & 31) {
    cm = __ballot_sync(0xffffffffu, load(lane) != 0.f);
    nm = __ballot_sync(0xffffffffu, load(32 + lane) != 0.f);
    pend = load(64 + lane);
  }
  __device__ __forceinline__ bool at(int i) const { return (cm >> (i & 31)) & 1u; }
  // after step i
  __device__ __forceinline__ void next(int i) {
    if ((i & 31) == 31) {
      cm = nm;
      nm = __ballot_sync(0xffffffffu, pend != 0.f);
      pend = load(i + 65 + lane);
    }
  }
};

// the padded steps from step i on, up to the end of its 32-step chunk
// (step i is padded: at least 1)
__device__ __forceinline__ int pad_run(const PadBits& p, int i) {
  const unsigned m = ~(p.cm >> (i & 31));  // 0 only for a chunk padded throughout, from its first step
  return m ? min(__ffs(m) - 1, 32 - (i & 31)) : 32;
}

struct Bwd {
  const float *g, *lp_emit, *lp_phi, *pad, *repeat;
  const int* labellens;
  const float* alpha;
  float* fac;  // (B, T, 6 Np): six rows of Np multipliers a frame (padded frames' unwritten)
  int* sync;   // the claim counter, then one ready flag a group; zero at launch
  float *d_emit, *d_phi;
  int B, T, N, Np, K, NB, G;  // chain: NB blocks of K stages; G frames a group
  int phases;                 // 3; ctc_probe.cu may run the factor blocks (1) or the chains (2) alone
};

// whether this launch runs the factor blocks (phase 1) or the chains (2):
// both, but in the timing build of ctc_probe.cu (CTC_PROBE)
__device__ __forceinline__ bool runs(const Bwd& a, int phase) {
#ifdef CTC_PROBE
  return a.phases & phase;
#else
  return true;
#endif
}

__device__ __forceinline__ int ld_relaxed(const int* p) {
  int v;
  asm volatile("ld.relaxed.gpu.global.b32 %0, [%1];\n" : "=r"(v) : "l"(reinterpret_cast<uint64_t>(p)) : "memory");
  return v;
}
// the generic-proxy writes this thread made (or acquired) are ordered before
// its later bulk copies (the async proxy) and, with a release, other blocks'
__device__ __forceinline__ void fence_async() {
  __threadfence();
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
}
__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;\n" ::"l"(reinterpret_cast<uint64_t>(p)), "r"(v) : "memory");
}
__device__ __forceinline__ void wait_phase(uint64_t* bar, int parity) {
  const long long t0 = clock64();
  uint32_t ok;
  for (;;) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\nselp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(ok)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
    if (ok) return;
    watchdog(t0);
  }
}
// `bytes` (a multiple of 16) from global `src` into shared `dst`, completing on `bar`
__device__ __forceinline__ void bulk_load(void* dst, const void* src, int bytes, uint64_t* bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
                   smem_u32(dst)),
               "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_u32(bar))
               : "memory");
}

// group k's multipliers (sequence k % B, G frames from T - 1 - (k / B) * G
// down) by `lanes` threads, this one `lane`: the forward's expressions,
// operand for operand
__device__ void factor_group(const Bwd& a, int k, int lane, int lanes) {
  const int N = a.N, T = a.T, Np = a.Np, S = 2 * N + 1, CH = 6 * Np;
  const int bb = k % a.B, t_hi = T - 1 - (k / a.B) * a.G;
  const int frames = min(a.G, t_hi + 1), states = N + 1;
  for (int x = lane; x < frames * states; x += lanes) {
    const int f = x / states, j = x - f * states, t = t_hi - f;
    const size_t bt = (size_t)bb * T + t;
    if (a.pad[bt] != 0.f) continue;  // a padded frame passes the adjoint through: no multiplier is read
    float* out = a.fac + bt * CH;
    const float* P = a.alpha + ((size_t)bb * (T + 1) + t) * S;
    const float* E = P + (N + 1);
    const float r = j > 0 ? a.repeat[(size_t)bb * N + j - 1] : 0.f;
    const float er = kLogEps * r, enr = kLogEps * (1.f - r);
    const float p = P[j], em1 = j > 0 ? E[j - 1] : 0.f;
    const float er_e = em1 + er;
    const float pin = j == 0 ? p : lae(p, er_e);
    if (j < N) {
      const float lpe = a.lp_emit[bt * N + j];
      const float av = pin + lpe, bv = E[j] + lpe;
      const float ne = lae(av, bv);
      out[j] = expf(av - ne);
      out[Np + j] = expf(bv - ne);
    }
    if (j > 0) {
      const float lpp = a.lp_phi[bt];
      const float c = pin + lpp, d = (em1 + lpp) + enr;
      const float np = lae(c, d);
      out[2 * Np + j] = expf(c - np);
      out[3 * Np + j] = expf(d - np);
      out[4 * Np + j] = expf(p - pin);
      out[5 * Np + j] = expf(er_e - pin);
    }
  }
}

// a factor block: claims groups in order until none is left
__device__ void factor_worker(const Bwd& a, int groups) {
  __shared__ int next;
  if (threadIdx.x == 0) next = atomicAdd(a.sync, 1);
  __syncthreads();
  int k = next;
  while (k < groups) {
    int claim = 0;
    if (threadIdx.x == 0) claim = atomicAdd(a.sync, 1);  // the next group, in flight while this one is computed
    factor_group(a, k, threadIdx.x, blockDim.x);
    fence_async();
    __syncthreads();
    if (threadIdx.x == 0) {
      st_release(a.sync + 1 + k, 1);
      next = claim;
    }
    __syncthreads();
    k = next;
  }
}

// a chain's producer warp, before its bulk copy of group gi's frames: the
// sequence's groups up to gi are ready (32 flags read at once; a group's
// data is acquired by the lane that read its flag, and the warp's
// synchronization orders it before lane 0's copies). Whenever the next
// group is unclaimed, claims and computes the next unclaimed group itself.
__device__ void wait_groups(const Bwd& a, int gi, int& ready, int lane) {
  const int per_seq = (a.T + a.G - 1) / a.G, groups = per_seq * a.B, b = blockIdx.x;
  const long long t0 = clock64();
  while (ready < gi) {
    const int g = ready + 1 + lane;
    const int f = g < per_seq ? ld_relaxed(a.sync + 1 + g * a.B + b) : 1;
    __threadfence();  // with the relaxed load that saw the release: an acquire
    const unsigned mask = __ballot_sync(0xffffffffu, f != 0);
    __syncwarp();
    const int n = mask == 0xffffffffu ? 32 : __ffs(~mask) - 1;
    if (n > 0) {
      ready += n;
      if (lane == 0) asm volatile("fence.proxy.async.global;\n" ::: "memory");
      continue;
    }
    const int k = (ready + 1) * a.B + b;
    int claim = -1;
    if (lane == 0 && ld_relaxed(a.sync) <= k) claim = atomicAdd(a.sync, 1);
    claim = __shfl_sync(0xffffffffu, claim, 0);
    if (claim >= 0 && claim < groups) {
      factor_group(a, claim, lane, 32);
      fence_async();
      __syncwarp();
      if (lane == 0) st_release(a.sync + 1 + claim, 1);
    }
    watchdog(t0);
  }
}

template <int PER>
__device__ __forceinline__ void load_row(const float* p, float* v) {
  if constexpr (PER == 1) {
    v[0] = p[0];
  } else if constexpr (PER == 2) {
    const float2 x = *reinterpret_cast<const float2*>(p);
    v[0] = x.x;
    v[1] = x.y;
  } else {
#pragma unroll
    for (int q = 0; q < PER / 4; ++q) {
      const float4 x = reinterpret_cast<const float4*>(p)[q];
      v[4 * q] = x.x;
      v[4 * q + 1] = x.y;
      v[4 * q + 2] = x.z;
      v[4 * q + 3] = x.w;
    }
  }
}

// The chain walks steps i = 0 .. T - 1 (frame T - 1 - i) in blocks of K
// steps: block k's frames [tlo, thi] are one contiguous run of the
// multiplier buffer, one bulk copy into the K stages of block slot
// n % NB (n: the blocks copied before it; a block of padded frames only is
// not copied), frame t at stage slot * K + t - tlo.
struct ChainSmem {
  float* stage;  // NB K stages of 6 Np
  uint64_t *full, *empty;  // a block slot's copy landed; its stages and sums are done with
  int* block;              // a block slot's block
  unsigned* padded;        // its frames' padding, bit q for frame thi - q
  float *xD, *xQ;          // [2][C + 1], the last 0: no state above
  float* lps;              // [NB K][C]: each consumer thread's blank sum of each stage's frame
  __device__ ChainSmem(float* sm, int CH, int K, int NB, int C) {
    stage = sm;
    full = reinterpret_cast<uint64_t*>(stage + (size_t)NB * K * CH);
    empty = full + NB;
    block = reinterpret_cast<int*>(empty + NB);
    padded = reinterpret_cast<unsigned*>(block + NB);
    xD = reinterpret_cast<float*>(padded + NB);
    xQ = xD + 2 * (C + 1);
    lps = xQ + 2 * (C + 1);
  }
};

// block k of the chain's steps: its frames [tlo, thi]
__device__ __forceinline__ void chain_block(const Bwd& a, int k, int& tlo, int& thi) {
  thi = a.T - 1 - k * a.K;
  tlo = max(0, thi - a.K + 1);
}

// a chain's consumer thread c: states c * PER .. c * PER + PER - 1, the adjoint in registers
template <int PER>
__device__ void chain_consumer(const Bwd& a, const ChainSmem& m_, int C) {
  const int b = blockIdx.x, c = threadIdx.x;
  const int N = a.N, T = a.T, Np = a.Np, K = a.K, NB = a.NB, CH = 6 * Np, S = 2 * N + 1;
  // gP: phi's adjoint; gB: emit's own-index next_emit part; gD, gQ: the next_phi and phi_in parts that
  // state j sends to emit j - 1, whose adjoint is (gB[j-1] + gD[j]) + gQ[j] in the plain version's order
  float gP[PER], gB[PER], gD[PER], gQ[PER];
  {  // the final gather's adjoint: -g into phi_last[l] through its logaddexp
    const float* PT = a.alpha + ((size_t)b * (T + 1) + T) * S;
    const float* ET = PT + (N + 1);
    const int l = min(max(a.labellens[b], 0), N);
    const float ct = -a.g[b];
#pragma unroll
    for (int q = 0; q < PER; ++q) {
      const int j = c * PER + q;
      gP[q] = gB[q] = gD[q] = gQ[q] = 0.f;
      if (l == 0) {
        if (j == 0) gP[q] = ct;
      } else if (j == l || j == l - 1) {
        const float out = lae(PT[l], ET[l - 1]);
        if (j == l)
          gP[q] = __fmul_rn(ct, expf(PT[l] - out));
        else
          gB[q] = __fmul_rn(ct, expf(ET[l - 1] - out));
      }
    }
  }
  PadBits pads(a.pad + (size_t)b * T, T);
  float* d_emit = a.d_emit + (size_t)b * T * N;
  int cur = 0, copied = 0, tlo = 0, thi = 0, bs = 0;
  bool prev_active = false;  // after a padded frame (and at the start) every gD and gQ is 0
  for (int i = 0; i < T;) {
    const int t = T - 1 - i, r = i % K;
    if (r == 0) {  // a block starts: its stages have landed unless every frame of it is padded
      chain_block(a, i / K, tlo, thi);
      const unsigned span = (1u << (thi - tlo + 1)) - 1u;
      bs = ((pads.cm >> (i & 31)) & span) == span ? -1 : copied % NB;
      if (bs >= 0) wait_phase(m_.full + bs, (copied / NB) & 1);
    }
    const float D1n = prev_active ? m_.xD[cur * (C + 1) + c + 1] : 0.f;  // state (c + 1) * PER's
    const float Q1n = prev_active ? m_.xQ[cur * (C + 1) + c + 1] : 0.f;
    int L = 1;
    if (pads.at(i)) {  // a run of padded frames within the block: the adjoint passes through, no exchange
      L = min(pad_run(pads, i), K - r);
#pragma unroll
      for (int q = 0; q < PER; ++q) {
        const int j = c * PER + q;
        if (j > N) break;
        const float D1 = q + 1 < PER ? gD[q + 1] : D1n, Q1 = q + 1 < PER ? gQ[q + 1] : Q1n;
        if (j < N) {
          // the first frame folds in the neighbour's parts, the rest add zeros (as the plain version does)
          float GE = __fadd_rn(__fadd_rn(gB[q], D1), Q1);
          float* de = d_emit + (size_t)t * N + j;
          de[0] = 0.f;
          for (int f = 1; f < L; ++f) {
            GE = __fadd_rn(__fadd_rn(GE, 0.f), 0.f);
            de[-(long long)f * N] = 0.f;
          }
          gB[q] = GE;
        }
        gD[q] = 0.f;
        gQ[q] = 0.f;
      }
      prev_active = false;
    } else {
      float* de = d_emit + (size_t)t * N;
      const int st = bs * K + (t - tlo);
      const float* M = m_.stage + (size_t)st * CH;
      float m[6][PER];
#pragma unroll
      for (int row = 0; row < 6; ++row) load_row<PER>(M + row * Np + c * PER, m[row]);
      float lpsum = 0.f;
#pragma unroll
      for (int q = 0; q < PER; ++q) {
        const int j = c * PER + q;
        if (j > N) break;
        const float D1 = q + 1 < PER ? gD[q + 1] : D1n, Q1 = q + 1 < PER ? gQ[q + 1] : Q1n;
        const float GP = gP[q];
        const float GE = j < N ? __fadd_rn(__fadd_rn(gB[q], D1), Q1) : 0.f;
        float dA = 0.f;
        if (j < N) {
          dA = __fmul_rn(GE, m[0][q]);
          const float dB = __fmul_rn(GE, m[1][q]);
          gB[q] = dB;
          de[j] = __fadd_rn(dA, dB);
        }
        if (j == 0) {
          gP[q] = __fadd_rn(dA, GP);
          gD[q] = 0.f;
          gQ[q] = 0.f;
          lpsum += GP;
        } else {
          const float dC = __fmul_rn(GP, m[2][q]), dD = __fmul_rn(GP, m[3][q]);
          lpsum += __fadd_rn(dC, dD);
          const float dpin = __fadd_rn(dA, dC);
          gP[q] = __fmul_rn(dpin, m[4][q]);
          gD[q] = dD;
          gQ[q] = __fmul_rn(dpin, m[5][q]);
        }
      }
      m_.xD[(cur ^ 1) * (C + 1) + c] = gD[0];
      m_.xQ[(cur ^ 1) * (C + 1) + c] = gQ[0];
      m_.lps[st * C + c] = lpsum;
      asm volatile("bar.sync 1, %0;\n" ::"r"(C) : "memory");
      cur ^= 1;
      prev_active = true;
    }
    i += L;
    if ((i % K == 0 || i == T) && bs >= 0) {  // the block's stages and sums are done with
      __syncwarp();
      if ((c & 31) == 0) mbar_arrive(m_.empty + bs);
      ++copied;
    }
    pads.next(i - 1);
  }
}

// a chain's producer warp: a bulk copy a block of K frames (not where all
// are padded), once the factor groups of its frames are ready; and each
// frame's blank adjoint: 0 where padded, else the consumers' per-thread
// sums once the block's stages are released (4 lanes a frame sum a
// strided quarter each, in order, then the lanes)
__device__ void chain_producer(const Bwd& a, const ChainSmem& m_, int C) {
  const int b = blockIdx.x, lane = threadIdx.x & 31;
  const int T = a.T, K = a.K, NB = a.NB, CH = 6 * a.Np, nblocks = (T + K - 1) / K;
  const int parts = 32 / K, r = lane % K, part = lane / K;
  auto release = [&](int n) {  // the n-th copied block: its unpadded frames' blank adjoints
    const int bs = n % NB;
    wait_phase(m_.empty + bs, (n / NB) & 1);
    int tlo, thi;
    chain_block(a, m_.block[bs], tlo, thi);
    const int t = thi - r;
    float sum = 0.f;
    if (t >= tlo) {
      const float* src = m_.lps + (size_t)(bs * K + (t - tlo)) * C;
#pragma unroll 8
      for (int c = part; c < C; c += parts) sum += src[c];
    }
    for (int o = K; o < 32; o <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    if (part == 0 && t >= tlo && !((m_.padded[bs] >> r) & 1u)) a.d_phi[(size_t)b * T + t] = sum;
  };
  PadBits pads(a.pad + (size_t)b * T, T);
  int copied = 0, ready = -1;
  for (int k = 0; k < nblocks; ++k) {
    int tlo, thi;
    chain_block(a, k, tlo, thi);
    const int nf = thi - tlo + 1, i0 = k * K;
    // bit q: frame thi - q (step i0 + q) is padded, or past the block
    const unsigned mask = ((pads.cm >> (i0 & 31)) & ((1u << nf) - 1u)) | ~((1u << nf) - 1u);
    pads.next(i0 + K - 1);  // K divides 32: a block ends a chunk or lies inside one
    if (lane < nf && ((mask >> lane) & 1u)) a.d_phi[(size_t)b * T + thi - lane] = 0.f;
    if (mask == 0xffffffffu) continue;
    const int bs = copied % NB;
    if (copied >= NB) release(copied - NB);
    if (runs(a, 1)) wait_groups(a, (k * K + nf - 1) / a.G, ready, lane);
    if (lane == 0) {
      m_.block[bs] = k;
      m_.padded[bs] = mask;
      mbar_expect_tx(m_.full + bs, nf * CH * 4);
      bulk_load(m_.stage + (size_t)bs * K * CH, a.fac + ((size_t)b * T + tlo) * CH, nf * CH * 4, m_.full + bs);
    }
    __syncwarp();
    ++copied;
  }
  for (int n = max(copied - NB, 0); n < copied; ++n) release(n);
}

// blocks 0..B-1: one chain a sequence, blockDim = C consumers + a producer
// warp; the rest: factor blocks
template <int PER>
__global__ void __launch_bounds__(kMaxConsumers + 32, 1) ctc_backward_kernel(const Bwd a) {
  extern __shared__ __align__(16) float smem[];
  if ((int)blockIdx.x >= a.B) {
    if (runs(a, 1)) factor_worker(a, ((a.T + a.G - 1) / a.G) * a.B);
    return;
  }
  if (!runs(a, 2)) return;
  const int C = blockDim.x - 32;
  const ChainSmem m_(smem, 6 * a.Np, a.K, a.NB, C);
  if (threadIdx.x == 0) {
    for (int s = 0; s < a.NB; ++s) {
      mbar_init(m_.full + s, 1);
      mbar_init(m_.empty + s, C / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int i = threadIdx.x; i < 4 * (C + 1); i += blockDim.x) m_.xD[i] = 0.f;
  __syncthreads();
  if ((int)threadIdx.x >= C)
    chain_producer(a, m_, C);
  else
    chain_consumer<PER>(a, m_, C);
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  return smem > 48 * 1024
             ? cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem)
             : cudaSuccess;
}

template <int PER>
cudaError_t launch_forward(int B, int threads, cudaStream_t s, const float* lp_emit, const float* lp_phi,
                           const float* pad, const float* repeat, const int* labellens, float* alpha, float* loss,
                           int T, int N) {
  const size_t smem = 2 * (size_t)(2 * N + 1) * sizeof(float);
  const cudaError_t e = allow_smem(ctc_forward_kernel<PER>, smem);
  if (e != cudaSuccess) return e;
  ctc_forward_kernel<PER><<<B, threads, smem, s>>>(lp_emit, lp_phi, pad, repeat, labellens, alpha, loss, T, N);
  return cudaGetLastError();
}

int padded_states(int N) { return (N + 1 + 7) / 8 * 8; }

// st_ctc_backward with `phases` (ctc_probe.cu times each kind of block alone)
cudaError_t backward(const float* g, const float* lp_emit, const float* lp_phi, const float* pad,
                     const float* repeat, const int* labellens, const float* alpha, float* fac, int* sync,
                     float* d_emit, float* d_phi, int B, int T, int N, int per, int phases, cudaStream_t s) {
  if (N < 1 || N > 4095 || B < 1 || T < 0 || phases < 1 || phases > 3) return cudaErrorInvalidValue;
  if (per != 1 && per != 2 && per != 4 && per != 8) return cudaErrorInvalidValue;
  const int C = ((N + 1 + per - 1) / per + 31) / 32 * 32, threads = C + 32;
  if (C > kMaxConsumers) return cudaErrorInvalidValue;
  const int Np = padded_states(N), CH = 6 * Np;
  // stages, their sums and the exchange within 220 KB: K stages a block (a power of two up to 8, so a
  // block's padding bits lie in one 32-step chunk; a block's copy under the mbarrier's 2^20 - 1
  // transaction bytes), at least 3 blocks in flight where they fit, and 2 at least
  const size_t per_stage = 4 * (size_t)CH + 4 * (size_t)C, fixed = 16 * (size_t)(C + 1) + 24 * 64;
  const int fit = (int)((220 * 1024 - fixed) / per_stage);
  if (fit < 2) return cudaErrorInvalidValue;
  int K = 8;
  while (K > 1 && (K * 3 > fit || (size_t)K * 4 * CH > (1u << 20) - 1)) K /= 2;
  const int NB = std::min(fit / K, 64);
  const size_t smem = (size_t)NB * K * per_stage + 24 * (size_t)NB + 16 * (size_t)(C + 1);
  const int G = std::max(1, std::min(8, 4096 / (N + 1)));
  const int factor_blocks = (phases & 1) ? std::max(sm_count() - B, 0) : 0;
  Bwd a{g, lp_emit, lp_phi, pad, repeat, labellens, alpha, fac, sync, d_emit, d_phi, B, T, N, Np, K, NB, G, phases};
  cudaError_t e = cudaSuccess;
#define ST_CTC_BWD(P)                                                            \
  if ((e = allow_smem(ctc_backward_kernel<P>, smem)) == cudaSuccess) {            \
    ctc_backward_kernel<P><<<B + factor_blocks, threads, smem, s>>>(a);          \
    e = cudaGetLastError();                                                       \
  }
  if (per == 1) {
    ST_CTC_BWD(1)
  } else if (per == 2) {
    ST_CTC_BWD(2)
  } else if (per == 4) {
    ST_CTC_BWD(4)
  } else {
    ST_CTC_BWD(8)
  }
#undef ST_CTC_BWD
  return e;
}

}  // namespace

// lp_emit (B, T, N), lp_phi (B, T), pad (B, T), repeat (B, N) fp32, labellens
// (B,) int32 in [0, N], all contiguous; writes alpha (B, T + 1, 2N + 1) and
// loss (B,). N from 1 to 4095.
extern "C" int st_ctc_forward(const float* lp_emit, const float* lp_phi, const float* pad, const float* repeat,
                              const int* labellens, float* alpha, float* loss, int B, int T, int N, void* stream) {
  if (N < 1 || N > 4095 || B < 1 || T < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // one state a thread up to 512, then PER a thread
  const int threads = std::min(512, (N + 1 + 31) / 32 * 32), per = (N + 1 + threads - 1) / threads;
#define ST_CTC_FWD(P) launch_forward<P>(B, threads, s, lp_emit, lp_phi, pad, repeat, labellens, alpha, loss, T, N)
  if (per <= 1) return (int)ST_CTC_FWD(1);
  if (per <= 2) return (int)ST_CTC_FWD(2);
  if (per <= 4) return (int)ST_CTC_FWD(4);
  return (int)ST_CTC_FWD(8);
#undef ST_CTC_FWD
}

// floats of the backward's multiplier buffer (B, T, 6 Np), Np = N + 1 rounded up to 8
extern "C" long long st_ctc_factor_floats(int B, int T, int N) {
  return (long long)B * T * 6 * padded_states(N);
}

// g (B,), the forward's inputs and its alpha; `fac` of st_ctc_factor_floats
// floats and `sync`, 1 + B * T int32 zeros, as scratch; writes d_emit (B, T,
// N) and d_phi (B, T). `per` states a consumer thread (1, 2, 4 or 8; at most
// 512 consumers).
extern "C" int st_ctc_backward(const float* g, const float* lp_emit, const float* lp_phi, const float* pad,
                               const float* repeat, const int* labellens, const float* alpha, float* fac, int* sync,
                               float* d_emit, float* d_phi, int B, int T, int N, int per, void* stream) {
  return (int)backward(g, lp_emit, lp_phi, pad, repeat, labellens, alpha, fac, sync, d_emit, d_phi, B, T, N, per,
                       3, static_cast<cudaStream_t>(stream));
}

extern "C" const char* st_ctc_error(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
