// The cached DiT block for Hopper (sm_90a): port of the Pallas TPU kernel
// smalltts_tpu/ops/pallas/block.py::fused_dit_scan, re-derived for the H100.
//
// The TPU kernel keeps the whole (B, T, 960) residual and a 2 MB weight window
// resident in VMEM across all 12 layers. An SM has 227 KB of shared memory, so
// here the scan is a host loop over layers (ops/kernels/dit_block.py) and each
// layer is 8 launches of the kernels in this file plus the attention kernel
// (attention.cu):
//
//   adaln_modulate   h = LN(x) * (1 + scale[b]) + shift[b]
//   gemm  EPI_BIAS   [q|k|v|gate] = h @ W_qkvg + b
//   qk_norm_rope     per-head RMSNorm * scale, then interleaved RoPE on lanes
//                    [0, rot) in fp32, IN PLACE on the q and k columns of the
//                    qkvg buffer (the attention kernel reads q/k/v/gate from
//                    that buffer by strides, so no split copy is made)
//   attention        self keys + cross [ref|text] keys, one softmax, * sigmoid(gate)
//   gemm  EPI_RESID  x += tanh(gate_msa[b]) * (attn @ W_out) * row_mask
//   adaln_modulate
//   gemm  EPI_SWIGLU ff = silu(h @ W1 + b1) * (h @ W3 + b3)   (W13 = [W1 | W3])
//   gemm  EPI_RESID  x += tanh(gate_mlp[b]) * (ff @ W2 + b2)  (rows NOT masked)
//
// Numerics follow _block_core (smalltts_tpu/models/dit.py:371-382), the JAX
// default path, rounding to bf16 where its bf16 ops round: each product is
// ONE fp32 accumulation per output (w2 over K = 2400 too, not the Pallas
// kernel's 4 row chunks summed in bf16, block.py:418-427), the bias added in
// fp32 and rounded once. The adaLN (nn.layernorm_noaffine, then * (1 + scale)
// + shift in bf16) rounds at four points: n = bf16((x - mean) * rstd) with
// mean and var in fp32, s = bf16(1 + scale), p = bf16(n * s), h = bf16(p +
// shift). The gated residual rounds at four: v = bf16(acc + bias), t =
// bf16(tanh(gate)), p = bf16(t * v) (0 on a masked row), x' = bf16(x + p).
// The q/k norm rounds after the RMSNorm and after the fp32 RoPE; SwiGLU after
// each of silu's four ops. Every kernel here takes bf16 tensors. The plain
// versions (ops/kernels/dit_block.py) do the same arithmetic.
//
// The two norm kernels are bound by a launch's fixed cost (adaln_modulate
// moves 1.2 MB at M = 320, 0.37 us at 3.35 TB/s; qk_norm_rope 2.5 MB): each
// reads its input once with 16-byte loads into registers, reduces in a warp
// or half-warp, and stores 16 bytes per 8 values. Folding either into the
// GEMM beside it (the adaLN into the A path of qkvg and w13, the q/k norm +
// RoPE into the qkvg epilogue with one block a head) was built and measured
// slower than the launch it saved (PERF.md section 6).
//
// The GEMM (gemm_wgmma_kernel). What bounds it on the H100: the four
// products of a layer stream 22 MB of bf16 weights (6.6 us at 3.35 TB/s) and
// do 7.4 GFLOP at M = B*T = 320 rows (7.5 us at 989 TFLOP/s): they sit at the
// card's ridge, so the design must both read each weight byte from HBM once
// and keep the tensor cores at their Hopper rate. The design:
//  * one consumer warpgroup issues wgmma.mma_async m64nNk16 (bf16 in, fp32
//    accumulators in registers) on 64-row tiles; A (activations, K-major) and
//    W in its stored (K, N) row-major layout (MN-major: the transpose-B bit,
//    no transposed copy) both come from shared memory in the 128-byte swizzle,
//    with BK = 64 (128 bytes of bf16, the swizzle's width);
//  * one TMA warp keeps a ring of 3-6 stages (100 KB) full with
//    cp.async.bulk.tensor.2d, mbarrier completion, zero fill past the edges
//    (M, N and K tails); the activation's tensor map is encoded per call in
//    C, each weight's once and cached (its key is everything the map holds);
//  * the tile width and a split of K are chosen per product on the host;
//    two blocks fit on an SM. Where the tiles leave most SMs idle and K is
//    long (w2 at M = 128) K is split: the K ranks of one output tile form a
//    thread-block cluster, and rank 0 adds the others' fp32 partials through
//    distributed shared memory in rank order and rounds once, in one launch,
//    with no scratch and no atomics (deterministic);
//  * the epilogues read the accumulator fragments in registers and store
//    bf16x2: bias; SwiGLU from two accumulator sets (w1's and w3's columns
//    n0..n0+63 land in the same thread), silu as JAX's op chain
//    a * (1 / (1 + exp(-a))) rounded to bf16 at each of its four ops; the
//    gated residual reads x, gate and row_mask and updates x in place.
// int8 weights (the w8_stream serving option, smalltts_tpu/models/dit.py::
// quantize_stream_weights): W is int8 (K, N) with an fp32 per-column scale,
// half the bytes. The int8 tile lands by TMA; the consumer warpgroup turns
// it into the swizzled bf16 tile wgmma reads, as the JAX nn.linear does,
// bf16(bf16(q) * bf16(scale)), with the block's scales held in registers,
// while the previous stage's wgmma runs; no bf16 copy of a weight is
// written to device memory.
// Measured times (H100 80GB HBM3, 700 W) and the grids each product gets are
// in PERF.md section 6.

#include <cuda_bf16.h>
#include <math.h>

#include <algorithm>

#include "sm90_wgmma.cuh"

using bf16 = __nv_bfloat16;

namespace {

constexpr float EPS = 1e-6f;  // the adaLN LayerNorm and the q/k RMSNorm (_block_core)

__device__ __forceinline__ float ld(const bf16* p) { return __bfloat162float(*p); }
// the value `v` takes once stored in bf16 (rounding points of the JAX path)
__device__ __forceinline__ float rbf(float v) { return __bfloat162float(__float2bfloat16(v)); }
__device__ __forceinline__ float bf_lo(uint32_t v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float bf_hi(uint32_t v) { return __uint_as_float(v & 0xffff0000u); }
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}
__device__ __forceinline__ __nv_bfloat162 as_bf2(uint32_t v) { return *reinterpret_cast<const __nv_bfloat162*>(&v); }
__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 v) { return *reinterpret_cast<const uint32_t*>(&v); }
// 1 / sqrt(v), both correctly rounded: torch.rsqrt's arithmetic, which the plain versions use
__device__ __forceinline__ float rsqrt_rn(float v) { return __fdiv_rn(1.f, __fsqrt_rn(v)); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// bf16(bf16(n * bf16(1 + scale)) + shift) on a bf16x2 pair. The bf16x2 ops
// round once from the exact result, which equals fp32 arithmetic rounded to
// bf16 for a sum or a product of two bf16 values (24 >= 2 * 8 + 2 bits); the
// _rn forms keep the compiler from contracting the product and the sum into
// one FMA, which would round once where JAX rounds twice.
__device__ __forceinline__ uint32_t modulate2(uint32_t n, uint32_t scale, uint32_t shift) {
  const __nv_bfloat162 s = __hadd2_rn(__float2bfloat162_rn(1.f), as_bf2(scale));
  return as_u32(__hadd2_rn(__hmul2_rn(as_bf2(n), s), as_bf2(shift)));
}

// ------------------------------------------------------------ adaln_modulate

constexpr int ADALN_ROWS = 4;  // rows (warps) per block

// one warp a row of H = 8 * 32 * NV or fewer values: lane l holds the
// 16-byte chunks l, l + 32, ... of x, scale and shift in registers; the
// mean, then the sum of squared deviations, each one warp reduction
template <int NV>
__global__ void __launch_bounds__(32 * ADALN_ROWS) adaln_kernel(const bf16* __restrict__ x, bf16* __restrict__ out,
                                                             const bf16* __restrict__ shift,
                                                             const bf16* __restrict__ scale, long long mod_sb,
                                                             int M, int T, int H) {
  const int row = blockIdx.x * ADALN_ROWS + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (row >= M) return;  // the whole warp
  const long long b = row / T;
  const bf16* xr = x + (long long)row * H;
  uint4 xv[NV], sc[NV], sh[NV];
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int c = 8 * (lane + 32 * i);
    const bool ok = c < H;  // H is a multiple of 8
    xv[i] = ok ? *reinterpret_cast<const uint4*>(xr + c) : make_uint4(0u, 0u, 0u, 0u);
    sc[i] = ok ? __ldg(reinterpret_cast<const uint4*>(scale + b * mod_sb + c)) : make_uint4(0u, 0u, 0u, 0u);
    sh[i] = ok ? __ldg(reinterpret_cast<const uint4*>(shift + b * mod_sb + c)) : make_uint4(0u, 0u, 0u, 0u);
  }
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const uint32_t w[4] = {xv[i].x, xv[i].y, xv[i].z, xv[i].w};
#pragma unroll
    for (int q = 0; q < 4; ++q) sum += bf_lo(w[q]) + bf_hi(w[q]);  // chunks past H are zeros
  }
  const float mean = __fdiv_rn(warp_sum(sum), static_cast<float>(H));
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    if (8 * (lane + 32 * i) >= H) continue;
    const uint32_t w[4] = {xv[i].x, xv[i].y, xv[i].z, xv[i].w};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float d0 = bf_lo(w[q]) - mean, d1 = bf_hi(w[q]) - mean;
      ss += d0 * d0 + d1 * d1;
    }
  }
  const float rstd = rsqrt_rn(__fadd_rn(__fdiv_rn(warp_sum(ss), static_cast<float>(H)), EPS));
  bf16* orow = out + (long long)row * H;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int c = 8 * (lane + 32 * i);
    if (c >= H) continue;
    const uint32_t w[4] = {xv[i].x, xv[i].y, xv[i].z, xv[i].w}, s[4] = {sc[i].x, sc[i].y, sc[i].z, sc[i].w},
                   f[4] = {sh[i].x, sh[i].y, sh[i].z, sh[i].w};
    uint32_t o[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const uint32_t n = pack_bf16x2(__fmul_rn(__fsub_rn(bf_lo(w[q]), mean), rstd),
                                     __fmul_rn(__fsub_rn(bf_hi(w[q]), mean), rstd));
      o[q] = modulate2(n, s[q], f[q]);
    }
    *reinterpret_cast<uint4*>(orow + c) = make_uint4(o[0], o[1], o[2], o[3]);
  }
}

// -------------------------------------------------------------- qk_norm_rope

constexpr int QK_UNITS = 16;  // (row, head) units per block, a half-warp each

// one half-warp per (row, head) of q or k, D = 8 * 16 * NV or fewer values:
// lane l of the half holds the 16-byte chunks l, l + 16, ... of the head, of
// its norm scale and, on the rotated lanes, of the row's cos and sin; the sum
// of squares is one 16-lane reduction, and RoPE's pairs (d, d + 1) are
// adjacent values of one chunk. y = bf16(v * rsqrt(mean(v^2) + eps) *
// scale[d]), then on d < rot the fp32 rotation of the pair, rounded again.
// Every load is issued before the reduction; the head is rewritten in place.
template <int NV>
__global__ void __launch_bounds__(16 * QK_UNITS) qk_norm_rope_kernel(bf16* __restrict__ qkvg, long long ldq, int M,
                                                                  int T, int heads, int D, int rot,
                                                                  const bf16* __restrict__ q_scale,
                                                                  const bf16* __restrict__ k_scale,
                                                                  const float* __restrict__ cos_t,
                                                                  const float* __restrict__ sin_t) {
  const int unit = blockIdx.x * QK_UNITS + (threadIdx.x >> 4), l = threadIdx.x & 15;
  const bool live = unit < 2 * heads * M;  // a unit past the end still takes part in the shuffles
  const int m = live ? unit / (2 * heads) : 0, hh = unit % (2 * heads);  // hh: q heads, then k heads
  bf16* xh = qkvg + (long long)m * ldq + (long long)hh * D;
  const bf16* nsc = hh < heads ? q_scale + hh * D : k_scale + (hh - heads) * D;
  const long long trow = (long long)(m % T) * rot;
  uint4 xv[NV], sv[NV];
  float4 cs[NV][2], sn[NV][2];
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int d = 8 * (l + 16 * i);
    const bool ok = live && d < D, r = ok && d < rot;  // D and rot are multiples of 8
    xv[i] = ok ? *reinterpret_cast<const uint4*>(xh + d) : make_uint4(0u, 0u, 0u, 0u);
    sv[i] = ok ? __ldg(reinterpret_cast<const uint4*>(nsc + d)) : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      cs[i][q] = r ? __ldg(reinterpret_cast<const float4*>(cos_t + trow + d) + q) : make_float4(1.f, 1.f, 1.f, 1.f);
      sn[i][q] = r ? __ldg(reinterpret_cast<const float4*>(sin_t + trow + d) + q) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const uint32_t w[4] = {xv[i].x, xv[i].y, xv[i].z, xv[i].w};
#pragma unroll
    for (int q = 0; q < 4; ++q)  // chunks past D are zeros
      ss = __fadd_rn(__fadd_rn(ss, __fmul_rn(bf_lo(w[q]), bf_lo(w[q]))), __fmul_rn(bf_hi(w[q]), bf_hi(w[q])));
  }
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);  // within the half-warp
  const float inv = rsqrt_rn(__fadd_rn(__fdiv_rn(ss, static_cast<float>(D)), EPS));
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int d = 8 * (l + 16 * i);
    if (!live || d >= D) continue;
    const uint32_t w[4] = {xv[i].x, xv[i].y, xv[i].z, xv[i].w}, s[4] = {sv[i].x, sv[i].y, sv[i].z, sv[i].w};
    const float c[8] = {cs[i][0].x, cs[i][0].y, cs[i][0].z, cs[i][0].w, cs[i][1].x, cs[i][1].y, cs[i][1].z, cs[i][1].w};
    const float n[8] = {sn[i][0].x, sn[i][0].y, sn[i][0].z, sn[i][0].w, sn[i][1].x, sn[i][1].y, sn[i][1].z, sn[i][1].w};
    uint32_t o[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float y0 = rbf(__fmul_rn(__fmul_rn(bf_lo(w[q]), inv), bf_lo(s[q])));
      const float y1 = rbf(__fmul_rn(__fmul_rn(bf_hi(w[q]), inv), bf_hi(s[q])));
      o[q] = d < rot ? pack_bf16x2(__fsub_rn(__fmul_rn(y0, c[2 * q]), __fmul_rn(y1, n[2 * q])),
                                   __fadd_rn(__fmul_rn(y1, c[2 * q + 1]), __fmul_rn(y0, n[2 * q + 1])))
                     : pack_bf16x2(y0, y1);
    }
    *reinterpret_cast<uint4*>(xh + d) = make_uint4(o[0], o[1], o[2], o[3]);
  }
}

// ---------------------------------------------------------------------- gemm

constexpr int GBM = 64;        // rows per block: the consumer warpgroup's one m64 wgmma row
constexpr int GBK = 64;        // k per stage: 128 bytes of bf16, the width of the 128-byte swizzle
constexpr int GSUB = 64;       // columns per W sub-tile: one TMA box of 64 k rows x 128 bytes
constexpr int GMAXSPLIT = 4;   // K ranks per output tile (the cluster's size)
enum { EPI_BIAS = 0, EPI_SWIGLU = 1, EPI_RESID = 2 };

struct GemmArgs {
  const float* wscale;  // int8 W: (wcols,) fp32 per-column scale
  const bf16* bias;     // (wcols,) or null
  bf16* out;            // (M, N), row stride ldo; EPI_RESID: the residual, updated in place
  long long ldo;
  const bf16* gate;  // EPI_RESID: (B, N) rows at stride gate_sb
  long long gate_sb;
  const unsigned char* row_mask;  // EPI_RESID: (M,) or null
  int M, N, K, T;
  int half;   // EPI_SWIGLU: column of W where the second (W3) half starts
  int wcols;  // W's width
};

// BN: W columns a block multiplies per k step (SwiGLU: 64 of w1 and the same 64 of w3)
template <int EPI, bool W8, int BN>
struct GemmCfg {
  static constexpr int NSUB = BN / GSUB;                     // W sub-tiles per stage
  static constexpr int BNO = EPI == EPI_SWIGLU ? GSUB : BN;  // output columns per block
  static constexpr int A_BYTES = GBM * GBK * 2;
  static constexpr int SUB_BYTES = GBK * GSUB * 2;              // one bf16 W sub-tile
  static constexpr int RAW_BYTES = W8 ? NSUB * GBK * GSUB : 0;  // int8 sub-tiles as TMA lands them
  static constexpr int STAGE = A_BYTES + NSUB * SUB_BYTES + RAW_BYTES;
  // as many stages as fit in 100 KB (3 to 6): two blocks per SM
  static constexpr int STAGES = 100 * 1024 / STAGE < 6 ? 100 * 1024 / STAGE : 6;
  static constexpr int BAR = STAGES * STAGE;                // mbarriers after the stages
  static constexpr int SMEM = BAR + 2 * STAGES * 8 + 1024;  // + slack for the 1024-byte alignment
  static constexpr int CONSUMERS = 128;
  static constexpr int THREADS = CONSUMERS + 32;  // the consumer warpgroup, then the TMA warp
  static constexpr int ACC = BN / 2;  // fp32 accumulators per consumer thread
  static_assert(STAGE % 1024 == 0, "every tile keeps the 1024-byte alignment of the 128-byte swizzle");
  static_assert(CONSUMERS * ACC * 4 <= BAR, "the split-K partials reuse the stages");
};

// d (64 x 64, fp32) += A (64 x 16, K-major) * B (16 x 64, MN-major), both from shared memory
__device__ __forceinline__ void wgmma_n64(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

// d (64 x 128, fp32) += A (64 x 16, K-major) * B (16 x 128, MN-major), both from shared memory
__device__ __forceinline__ void wgmma_n128(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// JAX's silu(a) * b on the rounded [w1|w3] linear: a * (1 / (1 + exp(-a))),
// each op rounded to bf16
__device__ __forceinline__ float swiglu(float a, float b) {
  a = rbf(a);
  const float sig = rbf(1.f / rbf(1.f + rbf(expf(-a))));
  return rbf(a * sig) * rbf(b);
}

// q * s for int8 q without I2F: byte b of u = q + 128 becomes the low
// mantissa byte of f = 2^23 + q + 128, and f * s - (2^23 + 128) * s is one
// FMA. Exact: s is a bf16 value, so (2^23 + 128) * s (`off`) fits in 24
// bits, and the FMA rounds the exact q * s, which fits in 16.
__device__ __forceinline__ float s8_scaled(uint32_t u, int b, float s, float off) {
  return fmaf(__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650 | b)), s, off);
}

// two blocks per SM: a 150-block grid is resident in one wave
template <int EPI, bool W8, int BN>
__global__ void __launch_bounds__(GemmCfg<EPI, W8, BN>::THREADS, 2)
    gemm_wgmma_kernel(const __grid_constant__ CUtensorMap tmA, const __grid_constant__ CUtensorMap tmW,
                      const GemmArgs g) {
  using C = GemmCfg<EPI, W8, BN>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  auto a_tile = [&](int s) { return sm + s * C::STAGE; };
  auto b_tile = [&](int s, int j) { return sm + s * C::STAGE + C::A_BYTES + j * C::SUB_BYTES; };
  auto raw_tile = [&](int s, int j) {
    return sm + s * C::STAGE + C::A_BYTES + C::NSUB * C::SUB_BYTES + j * GBK * GSUB;
  };
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + C::BAR);  // the stage's TMA tiles have landed
  uint64_t* empty = full + C::STAGES;                          // the consumers are done with it

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // grid.x is the cluster: the K ranks of one output tile
  const int split = blockIdx.x, nsplit = gridDim.x;
  const int n0 = blockIdx.y * C::BNO, m0 = blockIdx.z * GBM;
  const int nk = (g.K + GBK - 1) / GBK;
  const int kt0 = split * nk / nsplit, kt1 = (split + 1) * nk / nsplit;
  // W column of sub-tile j's first column (SwiGLU: w1's, then w3's)
  auto w_col = [&](int j) { return EPI == EPI_SWIGLU ? (j ? g.half : 0) + n0 : n0 + j * GSUB; };

  if (tid == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], C::CONSUMERS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  float acc[C::ACC];
#pragma unroll
  for (int i = 0; i < C::ACC; ++i) acc[i] = 0.f;

  if (warp == C::THREADS / 32 - 1) {
    // the TMA warp: one thread keeps the ring of stages full
    if (lane == 0) {
      for (int kt = kt0, i = 0; kt < kt1; ++kt, ++i) {
        const int s = i % C::STAGES, u = i / C::STAGES;
        mbar_wait(&empty[s], (u & 1) ^ 1);
        mbar_expect_tx(&full[s], C::A_BYTES + (W8 ? C::RAW_BYTES : C::NSUB * C::SUB_BYTES));
        tma_load_2d(a_tile(s), &tmA, kt * GBK, m0, &full[s]);
#pragma unroll
        for (int j = 0; j < C::NSUB; ++j)
          tma_load_2d(W8 ? raw_tile(s, j) : b_tile(s, j), &tmW, w_col(j), kt * GBK, &full[s]);
      }
    }
    __syncwarp();
  } else {
    // the consumer warpgroup: 4 k16 wgmmas per stage, one group kept in
    // flight. int8: before it issues, it turns the stage's int8 tile into the
    // swizzled bf16 tile wgmma reads, each value bf16(q * bf16(scale[col])),
    // while the previous stage's products run; a thread always handles the
    // same 8 columns of each sub-tile, so it holds their scales in registers
    const int c8 = tid & 7;
    float sc[W8 ? C::NSUB : 1][8], off[W8 ? C::NSUB : 1][8];
    if constexpr (W8) {
#pragma unroll
      for (int j = 0; j < C::NSUB; ++j)
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int n = n0 + (EPI == EPI_SWIGLU ? 0 : j * GSUB) + 8 * c8 + e, col = w_col(j) + 8 * c8 + e;
          sc[j][e] = n < g.N && col < g.wcols ? rbf(g.wscale[col]) : 0.f;
          off[j][e] = -8388736.f * sc[j][e];
        }
    }
    for (int kt = kt0, i = 0; kt < kt1; ++kt, ++i) {
      const int s = i % C::STAGES, u = i / C::STAGES;
      mbar_wait(&full[s], u & 1);
      if constexpr (W8) {
#pragma unroll
        for (int it = 0; it < C::NSUB * 4; ++it) {
          const int j = it / 4, r = (tid >> 3) + 16 * (it & 3);
          const uint2 q = *reinterpret_cast<const uint2*>(raw_tile(s, j) + r * GSUB + 8 * c8);
          const uint32_t qu[2] = {q.x ^ 0x80808080u, q.y ^ 0x80808080u};
          uint32_t pk[4];
#pragma unroll
          for (int e = 0; e < 8; e += 2) {
            const __nv_bfloat162 h = __floats2bfloat162_rn(s8_scaled(qu[e >> 2], e & 3, sc[j][e], off[j][e]),
                                                           s8_scaled(qu[e >> 2], (e & 3) + 1, sc[j][e + 1], off[j][e + 1]));
            pk[e >> 1] = *reinterpret_cast<const uint32_t*>(&h);
          }
          // 16-byte chunk c8 of k row r sits at chunk c8 ^ (r % 8): the 128-byte swizzle TMA would give
          *reinterpret_cast<uint4*>(b_tile(s, j) + r * 128 + ((c8 ^ (r & 7)) << 4)) =
              make_uint4(pk[0], pk[1], pk[2], pk[3]);
        }
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // visible to wgmma
        asm volatile("bar.sync 1, %0;\n" ::"n"(C::CONSUMERS) : "memory");  // the whole tile is written
      }
      fence_regs<C::ACC>(acc);
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < GBK / 16; ++k) {
        const uint64_t da = sw128_desc(a_tile(s) + 32 * k, 16, 1024);  // 16 k = 32 bytes along the row
        const uint64_t db = sw128_desc(b_tile(s, 0) + 2048 * k, C::SUB_BYTES, 1024);  // 16 k rows
        if constexpr (EPI == EPI_SWIGLU) {
          wgmma_n64(acc, da, db);
          wgmma_n64(acc + 32, da, sw128_desc(b_tile(s, 1) + 2048 * k, C::SUB_BYTES, 1024));
        } else if constexpr (BN == 128) {
          wgmma_n128(acc, da, db);
        } else {
          wgmma_n64(acc, da, db);
        }
      }
      wgmma_commit();
      wgmma_wait<1>();  // the previous stage's products are done: release it
      fence_regs<C::ACC>(acc);
      if (i > 0 && lane == 0) mbar_arrive(&empty[(i - 1) % C::STAGES]);
    }
    wgmma_wait<0>();
    fence_regs<C::ACC>(acc);
  }

  if (nsplit > 1) {
    // split K: ranks 1.. leave their fp32 partials in their own shared memory
    // (fragment order, so each read below is coalesced); rank 0 adds them in
    // rank order, then rounds once in the epilogue
    float4* part = reinterpret_cast<float4*>(sm);
    if (tid < C::CONSUMERS && split != 0) {
#pragma unroll
      for (int q = 0; q < C::ACC / 4; ++q)
        part[q * C::CONSUMERS + tid] = make_float4(acc[4 * q], acc[4 * q + 1], acc[4 * q + 2], acc[4 * q + 3]);
    }
    __syncwarp();
    cluster_sync();
    if (tid < C::CONSUMERS && split == 0) {
      for (int r = 1; r < nsplit; ++r)
#pragma unroll
        for (int h = 0; h < C::ACC / 4; h += 8) {  // 8 loads in flight, then their sums
          float4 v[8];
#pragma unroll
          for (int q = 0; q < 8; ++q) v[q] = ld_cluster4(part + (h + q) * C::CONSUMERS + tid, r);
#pragma unroll
          for (int q = 0; q < 8; ++q) {
            acc[4 * (h + q)] += v[q].x;
            acc[4 * (h + q) + 1] += v[q].y;
            acc[4 * (h + q) + 2] += v[q].z;
            acc[4 * (h + q) + 3] += v[q].w;
          }
        }
    }
    cluster_sync();  // no rank leaves while rank 0 reads its shared memory
    if (split != 0) return;
  }
  if (tid >= C::CONSUMERS) return;

  // epilogue from the accumulator fragments: thread (warp w, lane) holds rows
  // 16w + lane/4 (+8) and, in each 8-column group j, columns 8j + 2(lane%4)
  // (+1). Everything it reads is loaded before its first store: `out` may
  // alias bias, gate and x for all the compiler knows, so a load after a
  // store would wait for it, and the loads would run one round trip at a time.
  constexpr int NJ = C::BNO / 8;
  const int wr = warp * 16 + (lane >> 2), cq = 2 * (lane & 3);
  float2 b1[NJ], b3[NJ];  // the bias at each column pair (SwiGLU: w1's, and w3's in b3)
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int n = n0 + 8 * j + cq;  // N is a multiple of 8, so n < N means n + 1 < N as well
    const bool ok = n < g.N && g.bias;
    b1[j] = ok ? make_float2(ld(g.bias + n), ld(g.bias + n + 1)) : make_float2(0.f, 0.f);
    b3[j] = ok && EPI == EPI_SWIGLU ? make_float2(ld(g.bias + g.half + n), ld(g.bias + g.half + n + 1))
                                    : make_float2(0.f, 0.f);
  }
  float2 gt[EPI == EPI_RESID ? 2 : 1][NJ], xin[EPI == EPI_RESID ? 2 : 1][NJ];  // tanh(gate), x
  bool keep[2];
  if constexpr (EPI == EPI_RESID) {
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int m = m0 + wr + 8 * hr;
      keep[hr] = m < g.M && (!g.row_mask || g.row_mask[m]);
      const bf16* grow = g.gate + (long long)(m / g.T) * g.gate_sb;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int n = n0 + 8 * j + cq;
        const bool ok = m < g.M && n < g.N;
        gt[hr][j] = ok ? make_float2(rbf(tanhf(ld(grow + n))), rbf(tanhf(ld(grow + n + 1)))) : make_float2(0.f, 0.f);
        xin[hr][j] = ok ? __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(g.out + (long long)m * g.ldo + n))
                        : make_float2(0.f, 0.f);
      }
    }
  }
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int m = m0 + wr + 8 * hr;
    if (m >= g.M) continue;
    bf16* orow = g.out + (long long)m * g.ldo;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int n = n0 + 8 * j + cq;
      if (n >= g.N) continue;
      float v0 = acc[4 * j + 2 * hr] + b1[j].x, v1 = acc[4 * j + 2 * hr + 1] + b1[j].y;
      if constexpr (EPI == EPI_SWIGLU) {
        v0 = swiglu(v0, acc[32 + 4 * j + 2 * hr] + b3[j].x);
        v1 = swiglu(v1, acc[32 + 4 * j + 2 * hr + 1] + b3[j].y);
      } else if constexpr (EPI == EPI_RESID) {
        // x' = bf16(x + bf16(bf16(tanh(gate)) * bf16(acc + b))): the sum and
        // the product of two bf16 values in fp32 round to bf16 as bf16 ops do
        v0 = xin[hr][j].x + (keep[hr] ? rbf(gt[hr][j].x * rbf(v0)) : 0.f);
        v1 = xin[hr][j].y + (keep[hr] ? rbf(gt[hr][j].y * rbf(v1)) : 0.f);
      }
      *reinterpret_cast<__nv_bfloat162*>(orow + n) = __floats2bfloat162_rn(v0, v1);
    }
  }
}

// ------------------------------------------------------------- gemm, host side

template <int EPI, bool W8, int BN>
int launch_gemm(const CUtensorMap& ta, const CUtensorMap& tw, const GemmArgs& g, int split, cudaStream_t s) {
  using C = GemmCfg<EPI, W8, BN>;
  static const cudaError_t attr = cudaFuncSetAttribute(gemm_wgmma_kernel<EPI, W8, BN>,
                                                       cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (attr != cudaSuccess) return (int)attr;
  cudaLaunchConfig_t cfg{};
  cfg.gridDim = dim3(split, (g.N + C::BNO - 1) / C::BNO, (g.M + GBM - 1) / GBM);
  cfg.blockDim = dim3(C::THREADS);
  cfg.dynamicSmemBytes = C::SMEM;
  cfg.stream = s;
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = split;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  cfg.attrs = at;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, gemm_wgmma_kernel<EPI, W8, BN>, ta, tw, g);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

// Tile width and K split per product: 128 columns where 64-row x 128-column
// tiles already give most SMs a block (qkvg at M = 320), else 64. K is split
// over a cluster of up to GMAXSPLIT ranks only where the tiles leave more
// than half the SMs idle and each rank keeps 8 k tiles or more (w2 at M =
// 128): the split's merge and cluster barriers cost a few us, measured on
// the H100 (PERF.md section 6), more than the split gains elsewhere.
template <bool W8>
int dispatch_gemm(int epi, const CUtensorMap& ta, const CUtensorMap& tw, const GemmArgs& g, cudaStream_t s) {
  const int sms = sm_count(), mt = (g.M + GBM - 1) / GBM, nk = (g.K + GBK - 1) / GBK;
  const int tiles64 = mt * ((g.N + 63) / 64);
  auto split_for = [&](int blocks) {
    return blocks >= sms / 2 ? 1 : std::max(1, std::min({GMAXSPLIT, (sms + blocks - 1) / blocks, nk / 8}));
  };
  switch (epi) {
    case EPI_BIAS:
      if (mt * ((g.N + 127) / 128) >= (3 * sms) / 4) return launch_gemm<EPI_BIAS, W8, 128>(ta, tw, g, 1, s);
      return launch_gemm<EPI_BIAS, W8, 64>(ta, tw, g, split_for(tiles64), s);
    case EPI_SWIGLU:
      if (!g.bias) return (int)cudaErrorInvalidValue;
      return launch_gemm<EPI_SWIGLU, W8, 128>(ta, tw, g, split_for(tiles64), s);
    case EPI_RESID:
      if (!g.gate || g.T <= 0) return (int)cudaErrorInvalidValue;
      return launch_gemm<EPI_RESID, W8, 64>(ta, tw, g, split_for(tiles64), s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// bf16. x / out (M, H) contiguous, H a multiple of 8 up to 2048; shift /
// scale rows of H at batch stride mod_sb (0 when one modulation serves the
// whole batch); every row start 16-byte aligned.
extern "C" int st_adaln_modulate(const void* x, void* out, const void* shift, const void* scale,
                                 long long mod_sb, int M, int T, int H, void* stream) {
  if (M <= 0 || T <= 0 || H <= 0 || (H & 7) || H > 2048 || (mod_sb & 7) ||
      ((reinterpret_cast<size_t>(x) | reinterpret_cast<size_t>(out) | reinterpret_cast<size_t>(shift) |
        reinterpret_cast<size_t>(scale)) & 15))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((M + ADALN_ROWS - 1) / ADALN_ROWS), block(32 * ADALN_ROWS);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16 *xp = static_cast<const bf16*>(x), *sh = static_cast<const bf16*>(shift),
             *sc = static_cast<const bf16*>(scale);
  bf16* op = static_cast<bf16*>(out);
  const int chunks = (H / 8 + 31) / 32;  // 16-byte chunks per lane
  if (chunks <= 1) adaln_kernel<1><<<grid, block, 0, s>>>(xp, op, sh, sc, mod_sb, M, T, H);
  else if (chunks <= 2) adaln_kernel<2><<<grid, block, 0, s>>>(xp, op, sh, sc, mod_sb, M, T, H);
  else if (chunks <= 4) adaln_kernel<4><<<grid, block, 0, s>>>(xp, op, sh, sc, mod_sb, M, T, H);
  else adaln_kernel<8><<<grid, block, 0, s>>>(xp, op, sh, sc, mod_sb, M, T, H);
  return (int)cudaGetLastError();
}

// bf16 qkvg (M, ldq): q at column 0, k at column heads*D, each (heads, D) per
// row, normalized and rotated in place. cos/sin (T, rot) fp32 tables (null
// when rot is 0); q_scale / k_scale (heads, D) bf16. D a multiple of 8 up to
// 256, rot of 8 up to D, ldq of 8; every pointer 16-byte aligned (the loads
// and stores are 16 bytes).
extern "C" int st_qk_norm_rope(void* qkvg, long long ldq, int M, int T, int heads, int D, int rot,
                               const void* q_scale, const void* k_scale, const float* cos_t,
                               const float* sin_t, void* stream) {
  if (M <= 0 || T <= 0 || heads <= 0 || D <= 0 || D > 256 || (D & 7) || rot < 0 || rot > D || (rot & 7) ||
      (ldq & 7) || ldq < 2LL * heads * D || !q_scale || !k_scale || (rot && (!cos_t || !sin_t)) ||
      ((reinterpret_cast<size_t>(qkvg) | reinterpret_cast<size_t>(q_scale) | reinterpret_cast<size_t>(k_scale) |
        reinterpret_cast<size_t>(cos_t) | reinterpret_cast<size_t>(sin_t)) & 15))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((2 * heads * M + QK_UNITS - 1) / QK_UNITS), block(16 * QK_UNITS);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  bf16* qp = static_cast<bf16*>(qkvg);
  const bf16 *qs = static_cast<const bf16*>(q_scale), *ks = static_cast<const bf16*>(k_scale);
  if (D <= 128) qk_norm_rope_kernel<1><<<grid, block, 0, s>>>(qp, ldq, M, T, heads, D, rot, qs, ks, cos_t, sin_t);
  else qk_norm_rope_kernel<2><<<grid, block, 0, s>>>(qp, ldq, M, T, heads, D, rot, qs, ks, cos_t, sin_t);
  return (int)cudaGetLastError();
}

// GEMM out = epilogue(A @ W), A bf16 (M, K) at row stride lda. epi: 0 bias,
// 1 swiglu, 2 gated residual. W (K, cols) at row stride ldw is bf16, or int8
// where wscale, an fp32 scale per W column (cols,), is given. TMA reads A and
// W: K, lda and ldo must be multiples of 8 and A, W and out 16-byte aligned;
// N, ldw and half multiples of 8 for bf16 W, of 16 for int8 W.
extern "C" int st_gemm(int epi, const void* A, long long lda, const void* W, long long ldw,
                       const float* wscale, const void* bias, void* out, long long ldo,
                       const void* gate, long long gate_sb, const void* row_mask, int M, int N,
                       int K, int T, int half, void* stream) {
  const long long wmul = wscale ? 15 : 7;
  if (((K | lda | ldo) & 7) || ((N | ldw | half) & wmul)) return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<size_t>(A) | reinterpret_cast<size_t>(W) | reinterpret_cast<size_t>(out)) & 15)
    return (int)cudaErrorMisalignedAddress;
  const int wcols = epi == EPI_SWIGLU ? half + N : N;
  if (M <= 0 || N <= 0 || K <= 0 || wcols > ldw) return (int)cudaErrorInvalidValue;
  // 64 x 64 boxes: bf16 in the 128-byte swizzle wgmma reads, int8 unswizzled
  // (the consumer warpgroup swizzles it as it dequantizes)
  CUtensorMap ta, tw;
  if (!encode_map(&ta, MapSpec{A, false, M, K, lda, GBK, GBM, true}) ||
      !weight_map(&tw, MapSpec{W, wscale != nullptr, K, wcols, ldw, GSUB, GBK, wscale == nullptr}))
    return (int)cudaErrorInvalidValue;
  GemmArgs g{};
  g.wscale = wscale;
  g.bias = static_cast<const bf16*>(bias);
  g.out = static_cast<bf16*>(out); g.ldo = ldo;
  g.gate = static_cast<const bf16*>(gate); g.gate_sb = gate_sb;
  g.row_mask = static_cast<const unsigned char*>(row_mask);
  g.M = M; g.N = N; g.K = K; g.T = T; g.half = half; g.wcols = wcols;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return wscale ? dispatch_gemm<true>(epi, ta, tw, g, s) : dispatch_gemm<false>(epi, ta, tw, g, s);
}

extern "C" const char* st_dit_block_error(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
