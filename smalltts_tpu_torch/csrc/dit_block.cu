// The cached DiT block for Hopper (sm_90a): port of the Pallas TPU kernel
// smalltts_tpu/ops/pallas/block.py::fused_dit_scan, re-derived for the H100.
//
// The TPU kernel keeps the whole (B, T, 960) residual and a 2 MB weight window
// resident in VMEM across all 12 layers. An SM has 227 KB of shared memory, so
// here the scan is a host loop over layers (ops/kernels/dit_block.py) and each
// layer is 8 launches of the kernels in this file plus the attention kernel
// (attention.cu):
//
//   adaln_modulate  LN(x) (fp32, eps 1e-6) * (1 + scale[b]) + shift[b]
//   gemm  EPI_BIAS   [q|k|v|gate] = h @ W_qkvg + b
//   qk_norm_rope     per-head RMSNorm (fp32, eps 1e-6) * scale, then
//                    interleaved RoPE on lanes [0, rot) in fp32, IN PLACE on
//                    the q and k columns of the qkvg buffer (the attention
//                    kernel reads q/k/v/gate from that buffer by strides, so
//                    no split copy is made)
//   attention        self keys + cross [ref|text] keys, one softmax, * sigmoid(gate)
//   gemm  EPI_RESID  x += tanh(gate_msa[b]) * (attn @ W_out) * row_mask
//   adaln_modulate
//   gemm  EPI_SWIGLU ff = silu(h @ W1 + b1) * (h @ W3 + b3)   (W13 = [W1 | W3])
//   gemm  EPI_RESID  x += tanh(gate_mlp[b]) * (ff @ W2 + b2)  (rows NOT masked)
//
// Numerics follow _block_core (smalltts_tpu/models/dit.py:371-382), the JAX
// default path: w2 is ONE fp32 accumulation over K = 2400, not the Pallas
// kernel's 4 row chunks summed in bf16 (block.py:418-427). Each linear's
// result is rounded to bf16 where the JAX path rounds it (after the bias),
// and the modulation / gating arithmetic is done in fp32 with one rounding.
// Every kernel here takes bf16 tensors: the scan runs in bf16 on the card.
//
// What bounds it on the H100: per denoise step the four products stream
// 276 MB of bf16 weights (83 us at 3.35 TB/s) and do 88.5 GFLOP at B=8, T=40
// (89 us at 989 TFLOP/s): at M = 320 rows the products sit at the ridge.
// This first design is a plain tiled WMMA GEMM (bf16 16x16x16 fragments,
// fp32 accumulation, 64x64 block tiles, BK=32, a 3-4 stage cp.async pipeline)
// with fused epilogues, so no product result makes an extra round trip
// through device memory. Measured on the H100 it takes about 4.5x cuBLAS's
// time on the qkvg product, and deeper pipelining barely moved it; the likely
// limit is that the small 64x64 tiles re-read A and W from L2 many times.
// Bigger tiles, wgmma, TMA, split-K for the N=960 products and a persistent
// multi-layer design are later work. The LayerNorm and RMSNorm passes are
// bound by bytes (a few hundred KB each).
//
// int8 weights (the w8_stream serving option, smalltts_tpu/models/dit.py::
// quantize_stream_weights): the same GEMM with W stored int8 (K, N) and an
// fp32 per-column scale, which halves the 276 MB a denoise step streams to
// 138 MB. The int8 tile is copied into shared memory by cp.async (16 columns
// a copy, so N and the row stride must be multiples of 16), then each stage
// is dequantized in shared memory to the bf16 tile the MMA reads, as the
// JAX nn.linear dequantizes: bf16(bf16(q) * bf16(scale)), one rounding, the
// scale applied to W and not in the epilogue. No bf16 copy of a weight is
// ever written to device memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>

using bf16 = __nv_bfloat16;

namespace {

__device__ __forceinline__ float ld(const bf16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void st(bf16* p, float v) { *p = __float2bfloat16(v); }
// the value `v` takes once stored in bf16 (rounding points of the JAX path)
__device__ __forceinline__ float rbf(float v) { return __bfloat162float(__float2bfloat16(v)); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// sum over a block of blockDim.x (a multiple of 32, <= 1024) threads
__device__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  v = warp_sum(v);
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float s = 0.f;
  for (int i = 0; i < nw; ++i) s += red[i];
  return s;
}

// ------------------------------------------------------------ adaln_modulate

__global__ void adaln_kernel(const bf16* x, bf16* out, const bf16* shift, const bf16* scale,
                             long long mod_sb, int T_len, int H, float eps) {
  __shared__ float red[32];
  const int m = blockIdx.x, b = m / T_len;
  const bf16* xr = x + (long long)m * H;
  float s = 0.f;
  for (int i = threadIdx.x; i < H; i += blockDim.x) s += ld(xr + i);
  const float mean = block_sum(s, red) / H;
  float v = 0.f;
  for (int i = threadIdx.x; i < H; i += blockDim.x) {
    const float d = ld(xr + i) - mean;
    v += d * d;
  }
  const float rstd = rsqrtf(block_sum(v, red) / H + eps);
  const bf16* sh = shift + b * mod_sb;
  const bf16* sc = scale + b * mod_sb;
  bf16* o = out + (long long)m * H;
  for (int i = threadIdx.x; i < H; i += blockDim.x)
    st(o + i, (ld(xr + i) - mean) * rstd * (1.f + ld(sc + i)) + ld(sh + i));
}

// -------------------------------------------------------------- qk_norm_rope

constexpr int QK_WARPS = 8;
constexpr int QK_DMAX = 256;

__global__ void qk_norm_rope_kernel(bf16* qkvg, long long ldq, int T_len, int heads, int D, int rot,
                                    const bf16* q_scale, const bf16* k_scale, const float* cos_t,
                                    const float* sin_t, float eps) {
  __shared__ float buf[QK_WARPS][QK_DMAX];
  const int m = blockIdx.x, which = blockIdx.y, t = m % T_len;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  bf16* row = qkvg + (long long)m * ldq + (long long)which * heads * D;
  const bf16* scl = which ? k_scale : q_scale;
  const float* ct = cos_t + (long long)t * rot;
  const float* stb = sin_t + (long long)t * rot;
  float* y = buf[warp];
  for (int h = warp; h < heads; h += QK_WARPS) {
    bf16* xh = row + h * D;
    float ss = 0.f;
    for (int d = lane; d < D; d += 32) {
      const float x = ld(xh + d);
      y[d] = x;
      ss += x * x;
    }
    const float inv = rsqrtf(warp_sum(ss) / D + eps);
    for (int d = lane; d < D; d += 32) y[d] = rbf(y[d] * inv * ld(scl + h * D + d));
    __syncwarp();
    for (int d = lane; d < D; d += 32) {
      float o = y[d];
      if (d < rot) {
        const float p = y[d ^ 1];
        o = (d & 1) ? o * ct[d] + p * stb[d] : o * ct[d] - p * stb[d];
      }
      st(xh + d, o);
    }
    __syncwarp();
  }
}

// ---------------------------------------------------------------------- gemm

using namespace nvcuda;

constexpr int GBM = 64, GBN = 64, GBK = 32, GNT = 128;
enum { EPI_BIAS = 0, EPI_SWIGLU = 1, EPI_RESID = 2 };

struct GemmArgs {
  const bf16* A;  // (M, K), row stride lda
  long long lda;
  const bf16* W;  // (K, cols), row stride ldw
  long long ldw;
  const signed char* Wq;  // int8 weights: (K, cols) at row stride ldw, in place of W
  const float* wscale;    // int8 weights: (cols,) fp32 per-column scale
  const bf16* bias;  // (cols,) or null
  bf16* out;         // (M, N), row stride ldo; EPI_RESID: the residual, updated in place
  long long ldo;
  const bf16* gate;  // EPI_RESID: (B, N) rows at stride gate_sb
  long long gate_sb;
  const unsigned char* row_mask;  // EPI_RESID: (M,) or null
  int M, N, K, T;
  int half;  // EPI_SWIGLU: column of W where the second (W3) half starts
};

__device__ __forceinline__ void cp_async16(void* smem_dst, const void* src, bool ok) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  const int bytes = ok ? 16 : 0;  // 0 source bytes: the 16 destination bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

template <int EPI, bool W8>
struct GemmShape {
  static constexpr int BNW = EPI == EPI_SWIGLU ? 2 * GBN : GBN;  // columns computed per block
  static constexpr int AST = GBK + 8, BST = BNW + 8, CST = BNW + 4;
  static constexpr int QST = BNW + 16;  // int8 stage row stride (bytes), 16-byte aligned rows
  static constexpr int NF = BNW / 32;  // 16-wide column fragments per warp
  // tiles in flight: each k step waits only for the load started STAGES-1 steps earlier
  static constexpr int STAGES = EPI == EPI_SWIGLU ? 3 : 4;
  // bf16: STAGES x (A tile, W tile). int8: STAGES x (A tile, int8 W tile), one
  // dequantized bf16 W tile and the block's column scales
  static constexpr int PIPE = W8 ? STAGES * (GBM * AST * 2 + GBK * QST) + GBK * BST * 2 + BNW * 4
                                 : STAGES * (GBM * AST + GBK * BST) * 2;
  static constexpr int CBYTES = GBM * CST * 4;
  static constexpr int SMEM = PIPE > CBYTES ? PIPE : CBYTES;
};

template <int EPI, bool W8>
__global__ void __launch_bounds__(GNT) gemm_kernel(const GemmArgs g) {
  using S = GemmShape<EPI, W8>;
  __shared__ __align__(128) unsigned char smem[S::SMEM];
  bf16* As = reinterpret_cast<bf16*>(smem);  // [STAGES][GBM][AST]
  bf16* Bs = As + S::STAGES * GBM * S::AST;  // bf16: [STAGES][GBK][BST]
  // int8: [STAGES][GBK][QST] int8 stages, then [GBK][BST] bf16, then [BNW] fp32 scales
  signed char* Bq = reinterpret_cast<signed char*>(Bs);
  bf16* Bc = reinterpret_cast<bf16*>(Bq + S::STAGES * GBK * S::QST);
  float* Ss = reinterpret_cast<float*>(Bc + GBK * S::BST);
  float* Cs = reinterpret_cast<float*>(smem);  // [GBM][CST], after the main loop

  const int m0 = blockIdx.y * GBM, n0 = blockIdx.x * GBN;
  const int warp = threadIdx.x >> 5, wm = warp >> 1, wn = warp & 1;

  // warp (wm, wn) owns rows wm*32..+32 and, in each 64-column half, columns wn*32..+32
  auto col_of = [&](int j) { return (j >> 1) * GBN + wn * 32 + (j & 1) * 16; };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][S::NF];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < S::NF; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  // the W column of block column c (c < BNW: the W3 half starts at g.half)
  auto w_col = [&](int c) { return (long long)(c >= GBN ? g.half : 0) + n0 + (c % GBN); };

  auto load_stage = [&](int stage, int k0) {
    bf16* as = As + stage * GBM * S::AST;
    for (int i = threadIdx.x; i < GBM * (GBK / 8); i += GNT) {
      const int r = i / (GBK / 8), c = (i % (GBK / 8)) * 8;
      const int gm = m0 + r, gk = k0 + c;
      const bool ok = gm < g.M && gk < g.K;
      cp_async16(as + r * S::AST + c, ok ? g.A + (long long)gm * g.lda + gk : g.A, ok);
    }
    if constexpr (W8) {
      signed char* bq = Bq + stage * GBK * S::QST;
      constexpr int CPR = S::BNW / 16;
      for (int i = threadIdx.x; i < GBK * CPR; i += GNT) {
        const int r = i / CPR, c = (i % CPR) * 16;
        const int gk = k0 + r;
        const bool ok = gk < g.K && n0 + (c % GBN) < g.N;
        cp_async16(bq + r * S::QST + c, ok ? g.Wq + (long long)gk * g.ldw + w_col(c) : g.Wq, ok);
      }
    } else {
      bf16* bs = Bs + stage * GBK * S::BST;
      constexpr int CPR = S::BNW / 8;
      for (int i = threadIdx.x; i < GBK * CPR; i += GNT) {
        const int r = i / CPR, c = (i % CPR) * 8;
        const int gk = k0 + r;
        const bool ok = gk < g.K && n0 + (c % GBN) < g.N;
        cp_async16(bs + r * S::BST + c, ok ? g.W + (long long)gk * g.ldw + w_col(c) : g.W, ok);
      }
    }
  };

  // int8: stage -> the bf16 tile Bc, each value bf16(q * bf16(scale[col]))
  auto dequant_stage = [&](int stage) {
    const signed char* bq = Bq + stage * GBK * S::QST;
    constexpr int CPR = S::BNW / 16;
    for (int i = threadIdx.x; i < GBK * CPR; i += GNT) {
      const int r = i / CPR, c = (i % CPR) * 16;
      const uint4 raw = *reinterpret_cast<const uint4*>(bq + r * S::QST + c);
      const unsigned words[4] = {raw.x, raw.y, raw.z, raw.w};
      unsigned packed[8];
#pragma unroll
      for (int j = 0; j < 16; j += 2) {
        const float q0 = static_cast<float>(static_cast<signed char>((words[j >> 2] >> (8 * (j & 3))) & 0xffu));
        const float q1 = static_cast<float>(static_cast<signed char>((words[j >> 2] >> (8 * (j & 3) + 8)) & 0xffu));
        const __nv_bfloat162 h = __floats2bfloat162_rn(q0 * Ss[c + j], q1 * Ss[c + j + 1]);
        packed[j >> 1] = *reinterpret_cast<const unsigned*>(&h);
      }
      uint4* dst = reinterpret_cast<uint4*>(Bc + r * S::BST + c);
      dst[0] = make_uint4(packed[0], packed[1], packed[2], packed[3]);
      dst[1] = make_uint4(packed[4], packed[5], packed[6], packed[7]);
    }
  };

  if constexpr (W8) {
    for (int c = threadIdx.x; c < S::BNW; c += GNT)
      Ss[c] = n0 + (c % GBN) < g.N ? rbf(g.wscale[w_col(c)]) : 0.f;
  }

  // one commit group per k step (empty past the end) keeps the wait counts uniform
  const int nk = (g.K + GBK - 1) / GBK;
#pragma unroll
  for (int st = 0; st < S::STAGES - 1; ++st) {
    if (st < nk) load_stage(st, st * GBK);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<S::STAGES - 2>();
    __syncthreads();  // tile kt is visible, and every warp is done with tile kt-1's stage
    const int pre = kt + S::STAGES - 1;
    if (pre < nk) load_stage(pre % S::STAGES, pre * GBK);
    cp_async_commit();
    const bf16* as = As + (kt % S::STAGES) * GBM * S::AST;
    const bf16* bs = Bs + (kt % S::STAGES) * GBK * S::BST;
    if constexpr (W8) {
      dequant_stage(kt % S::STAGES);  // Bc is free: every warp passed this step's barrier
      __syncthreads();
      bs = Bc;
    }
#pragma unroll
    for (int kk = 0; kk < GBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb[S::NF];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], as + (wm * 32 + i * 16) * S::AST + kk, S::AST);
#pragma unroll
      for (int j = 0; j < S::NF; ++j)
        wmma::load_matrix_sync(fb[j], bs + kk * S::BST + col_of(j), S::BST);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < S::NF; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the pipeline buffers become the epilogue's staging tile

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < S::NF; ++j)
      wmma::store_matrix_sync(Cs + (wm * 32 + i * 16) * S::CST + col_of(j), acc[i][j], S::CST,
                              wmma::mem_row_major);
  __syncthreads();

  for (int idx = threadIdx.x; idx < GBM * GBN; idx += GNT) {
    const int r = idx / GBN, c = idx % GBN, m = m0 + r, n = n0 + c;
    if (m >= g.M || n >= g.N) continue;
    float v = Cs[r * S::CST + c];
    bf16* o = g.out + (long long)m * g.ldo + n;
    if (EPI == EPI_BIAS) {
      if (g.bias) v += ld(g.bias + n);
      st(o, v);
    } else if (EPI == EPI_SWIGLU) {
      // JAX rounds the [w1|w3] linear to bf16, then silu(a) * b, with silu the
      // op chain of JAX's silu, a * (1 / (1 + exp(-a))), each op rounded to bf16
      const float a = rbf(v + ld(g.bias + n));
      const float bb = rbf(Cs[r * S::CST + GBN + c] + ld(g.bias + g.half + n));
      const float sig = rbf(1.f / rbf(1.f + rbf(expf(-a))));
      st(o, rbf(a * sig) * bb);
    } else {
      if (g.bias) v += ld(g.bias + n);
      v = rbf(v);
      if (g.row_mask && !g.row_mask[m]) v = 0.f;
      const float gt = tanhf(ld(g.gate + (long long)(m / g.T) * g.gate_sb + n));
      st(o, ld(o) + gt * v);
    }
  }
}

template <int EPI, bool W8>
int launch_gemm(const GemmArgs& g, cudaStream_t s) {
  dim3 grid((g.N + GBN - 1) / GBN, (g.M + GBM - 1) / GBM);
  gemm_kernel<EPI, W8><<<grid, GNT, 0, s>>>(g);
  return (int)cudaGetLastError();
}

template <bool W8>
int dispatch_gemm(int epi, const GemmArgs& g, cudaStream_t s) {
  switch (epi) {
    case EPI_BIAS: return launch_gemm<EPI_BIAS, W8>(g, s);
    case EPI_SWIGLU:
      if (!g.bias) return (int)cudaErrorInvalidValue;
      return launch_gemm<EPI_SWIGLU, W8>(g, s);
    case EPI_RESID:
      if (!g.gate || g.T <= 0) return (int)cudaErrorInvalidValue;
      return launch_gemm<EPI_RESID, W8>(g, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// bf16. x / out (M, H) contiguous; shift / scale rows of H at batch stride
// mod_sb (0 when one modulation serves the whole batch).
extern "C" int st_adaln_modulate(const void* x, void* out, const void* shift, const void* scale,
                                 long long mod_sb, int M, int T, int H, float eps, void* stream) {
  adaln_kernel<<<M, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<bf16*>(out), static_cast<const bf16*>(shift),
      static_cast<const bf16*>(scale), mod_sb, T, H, eps);
  return (int)cudaGetLastError();
}

// bf16 qkvg (M, ldq): q at column 0, k at column heads*D, each (heads, D) per
// row. cos/sin (T, rot) fp32 tables; q_scale / k_scale (heads, D) bf16.
extern "C" int st_qk_norm_rope(void* qkvg, long long ldq, int M, int T, int heads, int D, int rot,
                               const void* q_scale, const void* k_scale, const float* cos_t,
                               const float* sin_t, float eps, void* stream) {
  if (D > QK_DMAX || rot > D || (rot & 1)) return (int)cudaErrorInvalidValue;
  qk_norm_rope_kernel<<<dim3(M, 2), 32 * QK_WARPS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<bf16*>(qkvg), ldq, T, heads, D, rot, static_cast<const bf16*>(q_scale),
      static_cast<const bf16*>(k_scale), cos_t, sin_t, eps);
  return (int)cudaGetLastError();
}

// GEMM out = epilogue(A @ W), A bf16 (M, K) at row stride lda. epi: 0 bias,
// 1 swiglu, 2 gated residual. W (K, cols) at row stride ldw is bf16, or int8
// where wscale, an fp32 scale per W column (cols,), is given. K, lda and ldo
// must be multiples of 8 and A, W and out 16-byte aligned; N, ldw and half
// multiples of 8 for bf16 W, of 16 for int8 W.
extern "C" int st_gemm(int epi, const void* A, long long lda, const void* W, long long ldw,
                       const float* wscale, const void* bias, void* out, long long ldo,
                       const void* gate, long long gate_sb, const void* row_mask, int M, int N,
                       int K, int T, int half, void* stream) {
  const long long wmul = wscale ? 15 : 7;
  if (((K | lda | ldo) & 7) || ((N | ldw | half) & wmul)) return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<size_t>(A) | reinterpret_cast<size_t>(W) | reinterpret_cast<size_t>(out)) & 15)
    return (int)cudaErrorMisalignedAddress;
  GemmArgs g{};
  g.A = static_cast<const bf16*>(A); g.lda = lda;
  g.W = static_cast<const bf16*>(W); g.Wq = static_cast<const signed char*>(W); g.ldw = ldw;
  g.wscale = wscale;
  g.bias = static_cast<const bf16*>(bias);
  g.out = static_cast<bf16*>(out); g.ldo = ldo;
  g.gate = static_cast<const bf16*>(gate); g.gate_sb = gate_sb;
  g.row_mask = static_cast<const unsigned char*>(row_mask);
  g.M = M; g.N = N; g.K = K; g.T = T; g.half = half;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return wscale ? dispatch_gemm<true>(epi, g, s) : dispatch_gemm<false>(epi, g, s);
}

extern "C" const char* st_dit_block_error(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
