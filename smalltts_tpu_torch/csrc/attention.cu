// Masked attention for Hopper (sm_90a): port of the Pallas TPU kernel
// smalltts_tpu/ops/pallas/attention.py::fused_attention (and of the joint
// [self | cross] attention inside smalltts_tpu/ops/pallas/block.py::fused_dit_scan).
//
// What it computes, per (b, h): scores = (q . k) / sqrt(D) in fp32; masked
// keys are REPLACED by -1e9 (never -inf, so a fully-masked row averages its
// keys uniformly, as the reference does); max-subtracted softmax in fp32;
// PV with the fp32 probabilities; output in the input dtype. An optional
// second key/value source with its own key mask shares the one max and
// denominator (the two-piece softmax of block.py:344-377), and an optional
// gate multiplies the output by sigmoid(gate) before it is stored.
//
// What bounds it on the H100: at the serving shapes (S <= 880 keys, D <= 128,
// B*H <= 256 (b, h) pairs) the work is small; the bound is the bytes of
// q/k/v/out (a few MB) at 3.35 TB/s. The TPU kernel kept a whole (Tq, S)
// score tile in VMEM; here a block has at most 227 KB of shared memory, so
// both kernels below use an online softmax over key tiles of 64, with the
// running max / denominator in fp32:
//
//  * bf16 (the serving path): attn_tc_kernel. One block of 2 warps per
//    (b, h, 32-row q tile); each warp owns 16 query rows. QK^T and PV run on
//    the tensor cores (WMMA bf16 16x16x16, fp32 accumulation); K/V tiles are
//    double-buffered in shared memory with cp.async so the next tile loads
//    while this one computes. The fp32 probabilities enter PV as two bf16
//    terms (hi + lo), so PV sees them to ~2^-16 relative, not bf16's 2^-8.
//    D = 120 is zero-padded to 128 in shared memory; the scale stays 1/sqrt(D).
//  * fp32 (exact fp32 parity, tests): attn_kernel. One block of 128 threads
//    per (b, h, 16-row q tile), products on the CUDA cores in fp32.
//
// Layouts: every tensor is addressed by (batch, head, token) strides with the
// head dim contiguous, so the wrapper can pass views of the DiT's fused qkvg
// buffer and write straight into the (B, T, H*D) layout to_out reads.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>

using namespace nvcuda;

namespace {

constexpr int BQ = 16;   // query rows per block
constexpr int BK = 64;   // keys per shared-memory tile
constexpr int NT = 128;  // threads: 8 per query row

struct AttnArgs {
  const void* q;
  const void* k[2];
  const void* v[2];
  const unsigned char* m[2];
  const void* gate;
  void* out;
  long long sq[3], sk[2][3], sv[2][3], sg[3], so[3];
  long long msb[2];
  int B, H, Tq, S[2];
  float scale;
};

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (BQ * (D + 1) + BK * (D + 1) + BK * D + BQ * (BK + 8)) + BK;
}

// ------------------------------------------------------------------ fp32, CUDA cores

template <int D>
__global__ void __launch_bounds__(NT) attn_kernel(const AttnArgs a) {
  using T = float;
  static_assert(D % 8 == 0, "head dim must be a multiple of 8");
  constexpr int QST = D + 1, KST = D + 1, VST = D, PST = BK + 8, DPT = D / 8;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + BQ * QST;
  float* Vs = Ks + BK * KST;
  float* Ps = Vs + BK * VST;
  unsigned char* Ms = reinterpret_cast<unsigned char*>(Ps + BQ * PST);

  const int tid = threadIdx.x, r = tid >> 3, sub = tid & 7;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;

  const T* q = static_cast<const T*>(a.q) + b * a.sq[0] + h * a.sq[1];
  for (int i = tid; i < BQ * D; i += NT) {
    const int rr = i / D, d = i - rr * D, t = q0 + rr;
    Qs[rr * QST + d] = t < a.Tq ? q[(long long)t * a.sq[2] + d] : 0.f;
  }

  float m = -INFINITY, l = 0.f, acc[DPT];
#pragma unroll
  for (int c = 0; c < DPT; ++c) acc[c] = 0.f;

  for (int src = 0; src < 2; ++src) {
    const int S = a.S[src];
    if (S == 0) continue;
    const T* kp = static_cast<const T*>(a.k[src]) + b * a.sk[src][0] + h * a.sk[src][1];
    const T* vp = static_cast<const T*>(a.v[src]) + b * a.sv[src][0] + h * a.sv[src][1];
    const unsigned char* mp = a.m[src] + b * a.msb[src];
    const long long kst = a.sk[src][2], vst = a.sv[src][2];
    for (int j0 = 0; j0 < S; j0 += BK) {
      const int nk = min(BK, S - j0);
      __syncthreads();  // the previous tile's readers are done; Qs is visible
      for (int i = tid; i < BK * D; i += NT) {
        const int j = i / D, d = i - j * D;
        float kv = 0.f, vv = 0.f;
        if (j < nk) {
          kv = kp[(long long)(j0 + j) * kst + d];
          vv = vp[(long long)(j0 + j) * vst + d];
        }
        Ks[j * KST + d] = kv;
        Vs[j * VST + d] = vv;
      }
      if (tid < BK) Ms[tid] = tid < nk ? mp[j0 + tid] : 0;
      __syncthreads();

      float s[8];
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) s[jj] = 0.f;
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        const float qv = Qs[r * QST + d];
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) s[jj] = fmaf(qv, Ks[(sub + 8 * jj) * KST + d], s[jj]);
      }
      float tmax = -INFINITY;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int j = sub + 8 * jj;
        float sc = s[jj] * a.scale;
        if (j >= nk) sc = -INFINITY;      // past the end: no weight at all
        else if (!Ms[j]) sc = -1e9f;      // masked: replaced, as the reference does
        s[jj] = sc;
        tmax = fmaxf(tmax, sc);
      }
      tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
      tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 2));
      tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 4));
      const float mnew = fmaxf(m, tmax);
      const float alpha = expf(m - mnew);  // 0 on the first tile (m = -inf)
      float psum = 0.f;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const float p = expf(s[jj] - mnew);
        Ps[r * PST + sub + 8 * jj] = p;
        psum += p;
      }
      psum += __shfl_xor_sync(0xffffffffu, psum, 1);
      psum += __shfl_xor_sync(0xffffffffu, psum, 2);
      psum += __shfl_xor_sync(0xffffffffu, psum, 4);
      l = l * alpha + psum;
      m = mnew;
      __syncwarp();  // row r's probabilities are written and read by its own 8 lanes
#pragma unroll
      for (int c = 0; c < DPT; ++c) acc[c] *= alpha;
      for (int j = 0; j < nk; ++j) {
        const float p = Ps[r * PST + j];
#pragma unroll
        for (int c = 0; c < DPT; ++c) acc[c] = fmaf(p, Vs[j * VST + sub + 8 * c], acc[c]);
      }
    }
  }

  const int t = q0 + r;
  if (t >= a.Tq) return;
  const float inv = 1.f / l;
  T* out = static_cast<T*>(a.out) + b * a.so[0] + h * a.so[1] + (long long)t * a.so[2];
  const T* g = a.gate ? static_cast<const T*>(a.gate) + b * a.sg[0] + h * a.sg[1] +
                            (long long)t * a.sg[2]
                      : nullptr;
#pragma unroll
  for (int c = 0; c < DPT; ++c) {
    const int d = sub + 8 * c;
    float o = acc[c] * inv;
    if (g) o *= 1.f / (1.f + expf(-g[d]));
    out[d] = o;
  }
}

template <int D>
int launch(const AttnArgs& a, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(attn_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  dim3 grid((a.Tq + BQ - 1) / BQ, a.H, a.B);
  attn_kernel<D><<<grid, NT, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------------ bf16, tensor cores

constexpr int WQ = 16;            // query rows per warp
constexpr int TNW = 2;            // warps per block
constexpr int TBQ = WQ * TNW;     // query rows per block
constexpr int TBK = 64;           // keys per tile
constexpr int TNT = 32 * TNW;

template <int DP>
struct TcLayout {  // shared memory, every region a multiple of 32 bytes
  static constexpr int LD = DP + 8, SLD = TBK + 4, PLD = TBK + 8, OLD = DP + 4;
  static constexpr size_t O = 0;                                  // fp32 [TBQ][OLD]
  static constexpr size_t S = O + TBQ * OLD * 4;                  // fp32 [TNW][WQ][SLD]
  static constexpr size_t Q = S + TNW * WQ * SLD * 4;             // bf16 [TBQ][LD]
  static constexpr size_t K = Q + TBQ * LD * 2;                   // bf16 [2][TBK][LD]
  static constexpr size_t V = K + 2 * TBK * LD * 2;               // bf16 [2][TBK][LD]
  static constexpr size_t P = V + 2 * TBK * LD * 2;               // bf16 [2 (hi, lo)][TNW][WQ][PLD]
  static constexpr size_t ROW = P + 2 * TNW * WQ * PLD * 2;       // fp32 alpha[TBQ], l[TBQ]
  static constexpr size_t M = ROW + 2 * TBQ * 4;                  // u8 [2][TBK]
  static constexpr size_t BYTES = M + 2 * TBK;
};

__device__ __forceinline__ void cp_async16(void* smem_dst, const void* src, bool ok) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  const int bytes = ok ? 16 : 0;  // 0 source bytes: the 16 destination bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(bytes));
}

template <int DP>
__global__ void __launch_bounds__(TNT) attn_tc_kernel(const AttnArgs a, const int D) {
  using Lay = TcLayout<DP>;
  using bf16 = __nv_bfloat16;
  constexpr int LD = Lay::LD, SLD = Lay::SLD, PLD = Lay::PLD, OLD = Lay::OLD, CH = DP / 8;
  extern __shared__ __align__(128) unsigned char sm[];
  float* O = reinterpret_cast<float*>(sm + Lay::O);
  float* Sx = reinterpret_cast<float*>(sm + Lay::S);
  bf16* Qs = reinterpret_cast<bf16*>(sm + Lay::Q);
  bf16* Ks = reinterpret_cast<bf16*>(sm + Lay::K);
  bf16* Vs = reinterpret_cast<bf16*>(sm + Lay::V);
  bf16* Ps = reinterpret_cast<bf16*>(sm + Lay::P);
  float* alpha_s = reinterpret_cast<float*>(sm + Lay::ROW);
  float* l_s = alpha_s + TBQ;
  unsigned char* Ms = sm + Lay::M;

  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int q0 = blockIdx.x * TBQ, h = blockIdx.y, b = blockIdx.z;
  const int dch = D / 8;  // 16-byte chunks per row that hold data; the rest are zero

  const bf16* q = static_cast<const bf16*>(a.q) + b * a.sq[0] + h * a.sq[1];
  for (int i = tid; i < TBQ * CH; i += TNT) {
    const int r = i / CH, c = i % CH, t = q0 + r;
    const bool ok = t < a.Tq && c < dch;
    cp_async16(Qs + r * LD + c * 8, ok ? q + (long long)t * a.sq[2] + c * 8 : q, ok);
  }
  for (int i = tid; i < TBQ * OLD; i += TNT) O[i] = 0.f;

  const int n0 = (a.S[0] + TBK - 1) / TBK, nt = n0 + (a.S[1] + TBK - 1) / TBK;
  auto load_tile = [&](int t, int stage) {
    const int src = t < n0 ? 0 : 1, j0 = (t < n0 ? t : t - n0) * TBK;
    const int nk = min(TBK, a.S[src] - j0);
    const bf16* kp = static_cast<const bf16*>(a.k[src]) + b * a.sk[src][0] + h * a.sk[src][1];
    const bf16* vp = static_cast<const bf16*>(a.v[src]) + b * a.sv[src][0] + h * a.sv[src][1];
    bf16* ks = Ks + stage * TBK * LD;
    bf16* vs = Vs + stage * TBK * LD;
    for (int i = tid; i < TBK * CH; i += TNT) {
      const int j = i / CH, c = i % CH;
      const bool ok = j < nk && c < dch;
      cp_async16(ks + j * LD + c * 8, ok ? kp + (long long)(j0 + j) * a.sk[src][2] + c * 8 : kp, ok);
      cp_async16(vs + j * LD + c * 8, ok ? vp + (long long)(j0 + j) * a.sv[src][2] + c * 8 : vp, ok);
    }
    for (int j = tid; j < TBK; j += TNT)
      Ms[stage * TBK + j] = j < nk ? a.m[src][b * a.msb[src] + j0 + j] : 0;
    asm volatile("cp.async.commit_group;\n" ::);
  };

  float m = -INFINITY, l = 0.f;  // the running max and denominator of row `r` (2 lanes per row)
  const int r = lane >> 1, half = lane & 1;
  float* Sw = Sx + w * WQ * SLD;
  bf16* Phi = Ps + w * WQ * PLD;
  bf16* Plo = Ps + (TNW + w) * WQ * PLD;
  float* Ow = O + w * WQ * OLD;

  load_tile(0, 0);
  for (int t = 0; t < nt; ++t) {
    const int stage = t & 1;
    if (t + 1 < nt) {
      load_tile(t + 1, stage ^ 1);
      asm volatile("cp.async.wait_group 1;\n" ::);
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::);
    }
    __syncthreads();  // tile t (and Q, O on the first pass) visible to every warp
    const int src = t < n0 ? 0 : 1;
    const int nk = min(TBK, a.S[src] - (t < n0 ? t : t - n0) * TBK);
    const bf16* ks = Ks + stage * TBK * LD;
    const bf16* vs = Vs + stage * TBK * LD;
    const unsigned char* ms = Ms + stage * TBK;

    // scores for this warp's 16 rows: S = Q K^T
#pragma unroll
    for (int nf = 0; nf < TBK / 16; ++nf) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
        wmma::load_matrix_sync(fa, Qs + (w * WQ) * LD + kk * 16, LD);
        wmma::load_matrix_sync(fb, ks + (nf * 16) * LD + kk * 16, LD);
        wmma::mma_sync(acc, fa, fb, acc);
      }
      wmma::store_matrix_sync(Sw + nf * 16, acc, SLD, wmma::mem_row_major);
    }
    __syncwarp();

    // online softmax: lanes 2r and 2r+1 each hold 32 of row r's 64 scores
    float s[32];
    float tmax = -INFINITY;
#pragma unroll
    for (int c = 0; c < 32; ++c) {
      const int j = half * 32 + c;
      float v = Sw[r * SLD + j] * a.scale;
      if (j >= nk) v = -INFINITY;      // past the end: no weight at all
      else if (!ms[j]) v = -1e9f;      // masked: replaced, as the reference does
      s[c] = v;
      tmax = fmaxf(tmax, v);
    }
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
    const float mnew = fmaxf(m, tmax);
    const float alpha = expf(m - mnew);  // 0 on the first tile (m = -inf)
    float psum = 0.f;
#pragma unroll
    for (int c = 0; c < 32; ++c) {
      const int j = half * 32 + c;
      const float p = expf(s[c] - mnew);
      const bf16 hi = __float2bfloat16(p);
      Phi[r * PLD + j] = hi;
      Plo[r * PLD + j] = __float2bfloat16(p - __bfloat162float(hi));
      psum += p;
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    l = l * alpha + psum;
    m = mnew;
    if (half == 0) alpha_s[w * WQ + r] = alpha;
    __syncwarp();

    // O = alpha * O + P V for this warp's rows
    for (int i = lane; i < WQ * DP; i += 32) {
      const int rr = i / DP, d = i % DP;
      Ow[rr * OLD + d] *= alpha_s[w * WQ + rr];
    }
    __syncwarp();
#pragma unroll
    for (int df = 0; df < DP / 16; ++df) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::load_matrix_sync(acc, Ow + df * 16, OLD, wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < TBK / 16; ++kk) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fv;
        wmma::load_matrix_sync(fv, vs + (kk * 16) * LD + df * 16, LD);
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fp;
        wmma::load_matrix_sync(fp, Phi + kk * 16, PLD);
        wmma::mma_sync(acc, fp, fv, acc);
        wmma::load_matrix_sync(fp, Plo + kk * 16, PLD);
        wmma::mma_sync(acc, fp, fv, acc);
      }
      wmma::store_matrix_sync(Ow + df * 16, acc, OLD, wmma::mem_row_major);
    }
    __syncthreads();  // every warp is done with stage `stage` before it is refilled
  }

  if (half == 0) l_s[w * WQ + r] = l;
  __syncwarp();
  bf16* out = static_cast<bf16*>(a.out) + b * a.so[0] + h * a.so[1];
  const bf16* g = a.gate ? static_cast<const bf16*>(a.gate) + b * a.sg[0] + h * a.sg[1] : nullptr;
  for (int i = lane; i < WQ * D; i += 32) {
    const int rr = i / D, d = i % D, t = q0 + w * WQ + rr;
    if (t >= a.Tq) continue;
    float o = Ow[rr * OLD + d] / l_s[w * WQ + rr];
    if (g) o *= 1.f / (1.f + expf(-__bfloat162float(g[(long long)t * a.sg[2] + d])));
    out[(long long)t * a.so[2] + d] = __float2bfloat16(o);
  }
}

template <int DP>
int launch_tc(const AttnArgs& a, int D, cudaStream_t stream) {
  constexpr size_t smem = TcLayout<DP>::BYTES;
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(attn_tc_kernel<DP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  dim3 grid((a.Tq + TBQ - 1) / TBQ, a.H, a.B);
  attn_tc_kernel<DP><<<grid, TNT, smem, stream>>>(a, D);
  return (int)cudaGetLastError();
}

}  // namespace

// ptrs: q, k1, v1, m1, k2, v2, m2, gate, out (k2/v2/m2/gate may be null).
// strides: (b, h, t) for q, k1, v1, k2, v2, gate, out, then the two mask batch
// strides: 23 values. dims: B, H, Tq, S1, S2. dtype 0 = fp32, 1 = bf16.
extern "C" int st_attention(int dtype, int D, void** ptrs, const long long* strides,
                            const int* dims, float scale, void* stream) {
  AttnArgs a;
  a.q = ptrs[0];
  a.k[0] = ptrs[1]; a.v[0] = ptrs[2]; a.m[0] = static_cast<const unsigned char*>(ptrs[3]);
  a.k[1] = ptrs[4]; a.v[1] = ptrs[5]; a.m[1] = static_cast<const unsigned char*>(ptrs[6]);
  a.gate = ptrs[7];
  a.out = ptrs[8];
  for (int i = 0; i < 3; ++i) {
    a.sq[i] = strides[i];
    a.sk[0][i] = strides[3 + i];
    a.sv[0][i] = strides[6 + i];
    a.sk[1][i] = strides[9 + i];
    a.sv[1][i] = strides[12 + i];
    a.sg[i] = strides[15 + i];
    a.so[i] = strides[18 + i];
  }
  a.msb[0] = strides[21];
  a.msb[1] = strides[22];
  a.B = dims[0]; a.H = dims[1]; a.Tq = dims[2]; a.S[0] = dims[3]; a.S[1] = dims[4];
  a.scale = scale;
  if (a.S[1] > 0 && (!a.k[1] || !a.v[1] || !a.m[1])) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // fp32: the CUDA-core kernel; bf16: the tensor-core kernel (16-byte aligned
  // rows are the wrapper's check)
  switch (dtype * 1000 + D) {
    case 64: return launch<64>(a, s);
    case 120: return launch<120>(a, s);
    case 128: return launch<128>(a, s);
    case 1064: return launch_tc<64>(a, D, s);
    case 1120: return launch_tc<128>(a, D, s);
    case 1128: return launch_tc<128>(a, D, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* st_attention_error(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
