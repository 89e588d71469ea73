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
// gate multiplies the output, rounded to the input dtype, by sigmoid(gate)
// = 1 / (1 + exp(-gate)) with each op rounded to it, as the DiT's XLA path
// does (models/dit.py::_attend).
//
// What bounds it on the H100: bytes at the served DiT's shapes. One DiT
// launch (B 8, H 8, Tq 40, keys T + 448, D 120) reads 14 MB of cross K/V
// (4.1 us at 3.35 TB/s) for 1.4 GFLOP; the 12 layers' cross K/V do not fit
// in L2, so every launch streams them from HBM, and only 64 (b, h) pairs
// exist to do it. The text encoder's shape (B 8, H 4, 384 x 384, D 128) is
// near the ridge. The trainers' fp32 shapes are bound by operations: fp32
// attention accurate to fp32 costs three TF32 products per product (below),
// an effective 495 / 3 = 165 TFLOP/s, so the teacher's DiT (B 2, H 8, 256 x
// 518, D 120) needs 6.2 us and the discriminator's (B 4, H 8, 1030 x 1030,
// D 64) 53 us, against 3.6 us and 6.8 us to move their bytes.
//
//  * bf16 (the serving path): attn_mma_kernel, FlashAttention-2 in
//    registers. A block has 4 warps, a warp 16 query rows. QK^T and PV run
//    on mma.sync m16n8k16 (bf16, fp32 accumulation) with ldmatrix (.trans
//    for V) from shared memory in an XOR swizzle; the scores, the online
//    softmax (quad shuffles) and O stay in registers, and P goes from the
//    score fragments straight into PV's A fragments as bf16 hi + lo (PV sees
//    the fp32 probabilities to ~2^-16). K/V tiles of 64 keys are
//    double-buffered by cp.async with D = 120 zero-padded to 128: 67 KB of
//    shared memory, 3 blocks (12 warps) per SM. Where the (b, h, q tile)
//    blocks cannot fill the card, the keys are split across blocks: the
//    splits of one (b, h, q tile) form a thread-block cluster, each keeps its
//    own (m, l, O), and they merge by a log-sum-exp combine through
//    distributed shared memory, in one launch with no scratch buffer.
//  * fp32 (the trainers' default compute dtype): attn_tf32_kernel, the same
//    FlashAttention-2 in registers, on the tensor cores with fp32 accuracy
//    (3xTF32): mma.sync m16n8k8 tf32, each operand split into tf32 hi + lo,
//    hi*lo + lo*hi + hi*hi accumulated in fp32. The dropped lo*lo and lo's
//    truncation are ~2^-21 of a product, inside the port's fp32 tolerance
//    (1e-5 max-rel), where one TF32 pass (2^-11) is not. It replaces a
//    CUDA-core kernel (16-row q tiles, element loads, P through shared
//    memory, no key split) that ran at 7-12% of the CUDA cores' 67
//    TFLOP/s. Against the 3xTF32 bound: 4 warps of 16 query rows (a K/V
//    tile is read once per 64 rows, not 16); K/V tiles of 32 keys (fp32
//    tiles are twice bf16's bytes), double-buffered by 16-byte cp.async;
//    the block's Q in shared memory, split where used (hi and lo of Q in
//    registers would take D of them); D = 120 zero-padded to 128: 104 KB
//    of shared memory and 255 registers, 2 blocks per SM, no spill. The
//    tensor cores truncate as they accumulate, a bias that grows with the
//    chain, so each key tile's PV goes to O through an fp32 add on the CUDA
//    cores. The k index of both products is permuted inside each group of
//    8 so that Q, K and V are read as float2 pairs (row strides make a
//    half-warp's reads conflict-free) and the score fragments are PV's A
//    fragments with no shuffle. The keys are split over a cluster and
//    merged as bf16 does where the (b, h, q tile) blocks cannot fill the
//    SMs (the teacher's DiT: 64 blocks, 6 splits).
//  * D = 4, fp32 and bf16 (the ASR conformer's 16 heads of 4, which the
//    distiller's CTC loss runs over 1024 frames): attn_small_kernel. An mma
//    tile needs K = 16, so a 4-wide head would be 3/4 zero padding; instead
//    one thread owns one query row, its q and O (4 floats each) in
//    registers, and the block's 128 rows share 64-key tiles of K, V and the
//    mask in shared memory (every lane reads the same key: a broadcast).
//    Scores, the online softmax and PV are fp32 on the CUDA cores; bf16
//    inputs are widened on load and the output rounded once, then gated as
//    the bf16 kernel gates.
//
// Measured times (H100 80GB HBM3, 700 W) are in PERF.md section 6.
//
// Layouts: every tensor is addressed by (batch, head, token) strides with the
// head dim contiguous, so the wrapper can pass views of the DiT's fused qkvg
// buffer and write straight into the (B, T, H*D) layout to_out reads.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

#include "sm90_common.cuh"

namespace {

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


// ------------------------------------------------------------------ small head dims, CUDA cores

template <typename T>
__device__ __forceinline__ float to_f(T v);
template <>
__device__ __forceinline__ float to_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) { return __bfloat162float(v); }

constexpr int SNT = 128;  // threads (query rows) per block
constexpr int SBK = 64;   // keys per shared-memory tile

template <typename T, int D>
__global__ void __launch_bounds__(SNT) attn_small_kernel(const AttnArgs a) {
  __shared__ float Ks[SBK * D];
  __shared__ float Vs[SBK * D];
  __shared__ unsigned char Ms[SBK];
  const int tid = threadIdx.x, t = blockIdx.x * SNT + tid, h = blockIdx.y, b = blockIdx.z;
  const bool live = t < a.Tq;

  float q[D], acc[D];
  const T* qp = static_cast<const T*>(a.q) + b * a.sq[0] + h * a.sq[1] + (long long)(live ? t : 0) * a.sq[2];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    q[d] = live ? to_f<T>(qp[d]) : 0.f;
    acc[d] = 0.f;
  }
  float m = -INFINITY, l = 0.f;

  for (int src = 0; src < 2; ++src) {
    const int S = a.S[src];
    if (S == 0) continue;
    const T* kp = static_cast<const T*>(a.k[src]) + b * a.sk[src][0] + h * a.sk[src][1];
    const T* vp = static_cast<const T*>(a.v[src]) + b * a.sv[src][0] + h * a.sv[src][1];
    const unsigned char* mp = a.m[src] + b * a.msb[src];
    for (int j0 = 0; j0 < S; j0 += SBK) {
      const int nk = min(SBK, S - j0);
      __syncthreads();  // the previous tile's readers are done
      for (int i = tid; i < SBK * D; i += SNT) {
        const int j = i / D, d = i - j * D;
        Ks[i] = j < nk ? to_f<T>(kp[(long long)(j0 + j) * a.sk[src][2] + d]) : 0.f;
        Vs[i] = j < nk ? to_f<T>(vp[(long long)(j0 + j) * a.sv[src][2] + d]) : 0.f;
      }
      if (tid < SBK) Ms[tid] = tid < nk ? mp[j0 + tid] : 0;
      __syncthreads();

      float s[SBK], tmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < SBK; ++j) {
        float dot = 0.f;
#pragma unroll
        for (int d = 0; d < D; ++d) dot = fmaf(q[d], Ks[j * D + d], dot);
        float sc = dot * a.scale;
        if (j >= nk) sc = -INFINITY;  // past the end: no weight at all
        else if (!Ms[j]) sc = -1e9f;  // masked: replaced, as the reference does
        s[j] = sc;
        tmax = fmaxf(tmax, sc);
      }
      const float mnew = fmaxf(m, tmax);  // finite: a tile holds at least one key
      const float alpha = expf(m - mnew);  // 0 on the first tile (m = -inf)
      float psum = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) acc[d] *= alpha;
#pragma unroll
      for (int j = 0; j < SBK; ++j) {
        const float p = expf(s[j] - mnew);
        psum += p;
#pragma unroll
        for (int d = 0; d < D; ++d) acc[d] = fmaf(p, Vs[j * D + d], acc[d]);
      }
      l = l * alpha + psum;
      m = mnew;
    }
  }

  if (!live) return;
  const float inv = 1.f / l;
  T* out = static_cast<T*>(a.out) + b * a.so[0] + h * a.so[1] + (long long)t * a.so[2];
  const T* g = a.gate ? static_cast<const T*>(a.gate) + b * a.sg[0] + h * a.sg[1] + (long long)t * a.sg[2] : nullptr;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    const float o = acc[d] * inv;
    if constexpr (std::is_same<T, float>::value) {
      out[d] = g ? __fmul_rn(o, __fdiv_rn(1.f, __fadd_rn(1.f, expf(-g[d])))) : o;  // o * (1 / (1 + exp(-g)))
    } else {
      // o rounded, then exp(-g), 1 + that, its reciprocal and the product each rounded to bf16
      const __nv_bfloat16 ob = __float2bfloat16_rn(o);
      if (!g) {
        out[d] = ob;
      } else {
        const __nv_bfloat16 e = __float2bfloat16_rn(expf(-__bfloat162float(g[d])));
        const __nv_bfloat16 den = __hadd_rn(__float2bfloat16_rn(1.f), e);
        out[d] = __hmul_rn(ob, __float2bfloat16_rn(__fdiv_rn(1.f, __bfloat162float(den))));
      }
    }
  }
}

template <typename T, int D>
int launch_small(const AttnArgs& a, cudaStream_t stream) {
  dim3 grid((a.Tq + SNT - 1) / SNT, a.H, a.B);
  attn_small_kernel<T, D><<<grid, SNT, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------------ bf16, tensor cores

// o * sigmoid(g) for a pair, rounded where the reference's bf16 path rounds
// (smalltts_tpu/models/dit.py::_attend): o is the attention output already
// rounded to bf16; exp(-g), 1 + that and its reciprocal are each rounded to
// bf16, and so is the product. expf (not __expf) and the _rn forms keep
// every step one correctly rounded operation, never a contracted FMA.
__device__ __forceinline__ __nv_bfloat162 gate_bf16x2(__nv_bfloat162 o, float g0, float g1) {
  const __nv_bfloat162 e = __floats2bfloat162_rn(expf(-g0), expf(-g1));
  const float2 d = __bfloat1622float2(__hadd2_rn(__float2bfloat162_rn(1.f), e));
  return __hmul2_rn(o, __floats2bfloat162_rn(__fdiv_rn(1.f, d.x), __fdiv_rn(1.f, d.y)));
}

constexpr int FNW = 4;             // warps per block, 16 query rows each
constexpr int FBQ = 16 * FNW;      // query rows per block
constexpr int FBK = 64;            // keys per tile
constexpr int FNT = 32 * FNW;
constexpr int FMAXSPLIT = 8;       // key splits of one (b, h, q tile): the cluster's size

template <int DP>
struct MmaLayout {  // shared memory; DP is the head dim padded to 64 or 128
  static constexpr int TILE = FBK * DP * 2;    // one bf16 K or V tile (Q's 64 rows have the same size)
  static constexpr int MASK = 4 * TILE;        // after [2 stages][K, V]: u8 key masks [2][FBK]
  static constexpr int ROW = MASK + 2 * FBK;   // then fp32 m[FBQ], l[FBQ], merge weights [FBQ][FMAXSPLIT]
  static constexpr int BYTES = ROW + FBQ * (2 + FMAXSPLIT) * 4;
  static constexpr int OST = DP + 8;           // fp32 row stride of the O partials, in the K/V tiles' place
  static_assert(FBQ * OST * 4 <= MASK, "the O partials fit in the K/V tiles");
};

// element offset of 16-byte chunk `c` of row `r` in a tile of DP-wide bf16
// rows: chunk c sits at c ^ (r % 8), so ldmatrix's 8 rows hit 8 bank groups
template <int DP>
__device__ __forceinline__ int swz(int r, int c) {
  return r * DP + ((c ^ (r & 7)) << 3);
}

__device__ __forceinline__ void cp_async16(void* smem_dst, const void* src, bool ok) {
  const int bytes = ok ? 16 : 0;  // 0 source bytes: the 16 destination bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(smem_dst)), "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
// d (16 x 8, fp32) += a (16 x 16, bf16) * b (16 x 8, bf16)
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// two fp32 probabilities as bf16 hi + lo terms, each packed in pairs
__device__ __forceinline__ void hi_lo(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x0 - hf.x, x1 - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// the float (pair) at `p` in the shared memory of cluster rank `rank`. No
// memory clobber: the cluster barriers order these loads, and without one a
// run of them is issued back to back instead of one round trip at a time.
__device__ __forceinline__ float ld_cluster(const float* p, int rank) {
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n" : "=f"(v) : "r"(cluster_addr(p, rank)));
  return v;
}
__device__ __forceinline__ float2 ld_cluster2(const float* p, int rank) {
  float2 v;
  asm volatile("ld.shared::cluster.v2.f32 {%0, %1}, [%2];\n" : "=f"(v.x), "=f"(v.y) : "r"(cluster_addr(p, rank)));
  return v;
}

// o * sigmoid(g) in fp32 as the reference's fp32 path computes it: o * (1 / (1 + exp(-g)))
__device__ __forceinline__ float gate_f32(float o, float g) {
  return __fmul_rn(o, __fdiv_rn(1.f, __fadd_rn(1.f, expf(-g))));
}

// An output pair (columns d, d + 1 of row t) in the output dtype, times
// sigmoid(gate) where a gate is given (`gp`, the gate of this (b, h), or
// null), and its store into `op`, the output of this (b, h).
template <typename T>
struct OutPair;
template <>
struct OutPair<__nv_bfloat16> {
  using bf16 = __nv_bfloat16;
  using type = __nv_bfloat162;
  static __device__ __forceinline__ type gated(const bf16* gp, long long sg, int t, int d, float v0, float v1) {
    const type o = __floats2bfloat162_rn(v0, v1);
    if (!gp) return o;
    const bf16* gr = gp + (long long)t * sg + d;
    return gate_bf16x2(o, __bfloat162float(gr[0]), __bfloat162float(gr[1]));
  }
  static __device__ __forceinline__ void store(bf16* op, long long so, int t, int d, type o) {
    *reinterpret_cast<type*>(op + (long long)t * so + d) = o;
  }
};
template <>
struct OutPair<float> {
  using type = float2;
  static __device__ __forceinline__ type gated(const float* gp, long long sg, int t, int d, float v0, float v1) {
    if (!gp) return make_float2(v0, v1);
    const float* gr = gp + (long long)t * sg + d;
    return make_float2(gate_f32(v0, gr[0]), gate_f32(v1, gr[1]));
  }
  static __device__ __forceinline__ void store(float* op, long long so, int t, int d, type o) {
    *reinterpret_cast<type*>(op + (long long)t * so + d) = o;
  }
};

// The merge of the key splits of one (b, h, 64-row q tile), a cluster of
// gridDim.x blocks, one a split. Each has left the (m, l) of its keys for
// its 64 rows in m_s and l_s and its unnormalized O in `part` (row stride
// OST floats) in its own shared memory; every thread of every rank calls
// this. Rank r merges rows [r * 64 / nsplit, ...) of every split, in rank
// order: M = max m_j, w_j = exp(m_j - M), O = sum_j (w_j / sum_i w_i l_i)
// O_j, then gated and stored in T. w_j is 0 where m_j = -inf: the slots past
// nsplit, or a split with no key tile, which split_launch never makes (a
// guard, so no NaN can arise).
template <typename T, int DP, int OST>
__device__ __forceinline__ void merge_splits(const AttnArgs& a, const float* part, const float* m_s, const float* l_s,
                                             float* w_s, int q0, T* op, const T* gp, int D) {
  using P = OutPair<T>;
  const int tid = threadIdx.x, split = blockIdx.x, nsplit = gridDim.x;
  cluster_sync();
  const int rows_per = (FBQ + nsplit - 1) / nsplit, r0 = split * rows_per;
  const int r1 = min(min(FBQ, r0 + rows_per), a.Tq - q0);
  if (tid < r1 - r0) {
    const int row = r0 + tid;
    float mj[FMAXSPLIT], lj[FMAXSPLIT], mx = -INFINITY, L = 0.f;
#pragma unroll
    for (int j = 0; j < FMAXSPLIT; ++j) {  // every split's (m, l) loads in flight together
      mj[j] = j < nsplit ? ld_cluster(m_s + row, j) : -INFINITY;
      lj[j] = j < nsplit ? ld_cluster(l_s + row, j) : 0.f;
    }
#pragma unroll
    for (int j = 0; j < FMAXSPLIT; ++j) mx = fmaxf(mx, mj[j]);
#pragma unroll
    for (int j = 0; j < FMAXSPLIT; ++j) {
      mj[j] = mj[j] == -INFINITY ? 0.f : expf(mj[j] - mx);
      L += mj[j] * lj[j];
    }
#pragma unroll
    for (int j = 0; j < FMAXSPLIT; ++j) w_s[tid * FMAXSPLIT + j] = mj[j] / L;
  }
  __syncthreads();
  // every load (gate, the other splits' partials) before the first store: `out`
  // may alias the gate for all the compiler knows. A thread merges at most EPT column pairs: rows [r0, r1) x D / 2 pairs <= 32 x 64 at 2+ splits
  constexpr int EPT = (FBQ / 2) * (DP / 2) / FNT;
  const int hd = D / 2, n_el = (r1 - r0) * hd;
  typename P::type res[EPT];
#pragma unroll
  for (int e = 0; e < EPT; ++e) {
    const int idx = tid + e * FNT, rr = idx / hd, d = 2 * (idx % hd), row = r0 + rr;
    if (idx >= n_el) continue;
    float2 pj[FMAXSPLIT];
#pragma unroll
    for (int j = 0; j < FMAXSPLIT; ++j) pj[j] = j < nsplit ? ld_cluster2(part + row * OST + d, j) : make_float2(0.f, 0.f);
    float2 sum = make_float2(0.f, 0.f);
#pragma unroll
    for (int j = 0; j < FMAXSPLIT; ++j) {
      const float wj = w_s[rr * FMAXSPLIT + j];
      sum.x += wj * pj[j].x;
      sum.y += wj * pj[j].y;
    }
    res[e] = P::gated(gp, a.sg[2], q0 + row, d, sum.x, sum.y);
  }
#pragma unroll
  for (int e = 0; e < EPT; ++e) {
    const int idx = tid + e * FNT;
    if (idx < n_el) P::store(op, a.so[2], q0 + r0 + idx / hd, 2 * (idx % hd), res[e]);
  }
  cluster_sync();  // no rank leaves while another reads its shared memory
}

// One block per (key split, 64-row q tile, (b, h)); a warp owns 16 query
// rows. `per` key tiles of 64 per split; the splits of one (b, h, q tile)
// are a cluster (grid.x) and merge through distributed shared memory.
template <int DP>
__global__ void __launch_bounds__(FNT, 3) attn_mma_kernel(const AttnArgs a, const int D, const int per) {
  using Lay = MmaLayout<DP>;
  using bf16 = __nv_bfloat16;
  constexpr int CH = DP / 8, KS = DP / 16, NF = FBK / 8;
  extern __shared__ __align__(128) unsigned char sm[];
  bf16* Kt[2] = {reinterpret_cast<bf16*>(sm), reinterpret_cast<bf16*>(sm + 2 * Lay::TILE)};
  bf16* Vt[2] = {reinterpret_cast<bf16*>(sm + Lay::TILE), reinterpret_cast<bf16*>(sm + 3 * Lay::TILE)};
  unsigned char* Ms = sm + Lay::MASK;
  float* m_s = reinterpret_cast<float*>(sm + Lay::ROW);
  float* l_s = m_s + FBQ;
  float* w_s = l_s + FBQ;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2, t4 = lane & 3;
  const int mi = lane >> 3, ri = lane & 7;  // ldmatrix: the 8x8 matrix this lane addresses, and its row
  const int split = blockIdx.x, nsplit = gridDim.x;
  const int q0 = blockIdx.y * FBQ, b = blockIdx.z / a.H, h = blockIdx.z % a.H;
  const int dch = D / 8;  // 16-byte chunks per row that hold data; the rest are zero
  const int n0 = (a.S[0] + FBK - 1) / FBK, nt = n0 + (a.S[1] + FBK - 1) / FBK;
  const int t_begin = min(nt, split * per), t_end = min(nt, t_begin + per);

  auto load_tile = [&](int t, int stage) {
    const int src = t < n0 ? 0 : 1, j0 = (t < n0 ? t : t - n0) * FBK;
    const int nk = min(FBK, a.S[src] - j0);
    const bf16* kp = static_cast<const bf16*>(a.k[src]) + b * a.sk[src][0] + h * a.sk[src][1];
    const bf16* vp = static_cast<const bf16*>(a.v[src]) + b * a.sv[src][0] + h * a.sv[src][1];
    for (int i = tid; i < FBK * CH; i += FNT) {
      const int j = i / CH, c = i % CH;
      const bool ok = j < nk && c < dch;  // zero fill: keys past the end, and D = 120's padding
      cp_async16(Kt[stage] + swz<DP>(j, c), ok ? kp + (long long)(j0 + j) * a.sk[src][2] + c * 8 : kp, ok);
      cp_async16(Vt[stage] + swz<DP>(j, c), ok ? vp + (long long)(j0 + j) * a.sv[src][2] + c * 8 : vp, ok);
    }
    for (int j = tid; j < FBK; j += FNT) Ms[stage * FBK + j] = j < nk ? a.m[src][b * a.msb[src] + j0 + j] : 0;
  };

  // the block's 64 query rows are staged in stage 1's K tile, then held in registers
  const bf16* qp = static_cast<const bf16*>(a.q) + b * a.sq[0] + h * a.sq[1];
  for (int i = tid; i < FBQ * CH; i += FNT) {
    const int r = i / CH, c = i % CH, t = q0 + r;
    const bool ok = t < a.Tq && c < dch;
    cp_async16(Kt[1] + swz<DP>(r, c), ok ? qp + (long long)t * a.sq[2] + c * 8 : qp, ok);
  }
  if (t_begin < t_end) load_tile(t_begin, 0);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  uint32_t qf[KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) ldsm_x4(qf[kk], Kt[1] + swz<DP>(warp * 16 + (mi & 1) * 8 + ri, 2 * kk + (mi >> 1)));
  __syncthreads();  // stage 1 is free for the first prefetch

  // O (16 rows x DP per warp), the running max and denominator of rows g and g + 8
  float o[DP / 8][4];
#pragma unroll
  for (int i = 0; i < DP / 8; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float mrow[2] = {-INFINITY, -INFINITY}, lrow[2] = {0.f, 0.f};

  for (int t = t_begin, i = 0; t < t_end; ++t, ++i) {
    const int st = i & 1;
    if (t + 1 < t_end) {
      load_tile(t + 1, st ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile t is visible to every warp
    const int src = t < n0 ? 0 : 1;
    const int nk = min(FBK, a.S[src] - (t < n0 ? t : t - n0) * FBK);
    const bf16* ks = Kt[st];
    const bf16* vs = Vt[st];
    const unsigned char* ms = Ms + st * FBK;

    // S = Q K^T for the warp's 16 rows, 8 fragments of 8 keys, in registers
    float s[NF][4];
#pragma unroll
    for (int n = 0; n < NF; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
#pragma unroll
      for (int np = 0; np < NF / 2; ++np) {
        uint32_t kb[4];
        ldsm_x4(kb, ks + swz<DP>(16 * np + (mi >> 1) * 8 + ri, 2 * kk + (mi & 1)));
        mma16816(s[2 * np], qf[kk], kb[0], kb[1]);
        mma16816(s[2 * np + 1], qf[kk], kb[2], kb[3]);
      }

    // online softmax; lanes 4g..4g+3 share rows g and g + 8
    float tmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < NF; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = 8 * n + 2 * t4 + (e & 1);
        float v = s[n][e] * a.scale;
        if (j >= nk) v = -INFINITY;   // past the end: no weight at all
        else if (!ms[j]) v = -1e9f;   // masked: replaced, as the reference does
        s[n][e] = v;
        tmax[e >> 1] = fmaxf(tmax[e >> 1], v);
      }
    float alpha[2], psum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(0xffffffffu, tmax[r], 1));
      tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(0xffffffffu, tmax[r], 2));
      const float mnew = fmaxf(mrow[r], tmax[r]);  // finite: a tile holds at least one key
      alpha[r] = expf(mrow[r] - mnew);             // 0 on the split's first tile (m = -inf)
      mrow[r] = mnew;
    }
#pragma unroll
    for (int n = 0; n < NF; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(s[n][e] - mrow[e >> 1]);
        s[n][e] = p;
        psum[e >> 1] += p;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      psum[r] += __shfl_xor_sync(0xffffffffu, psum[r], 1);
      psum[r] += __shfl_xor_sync(0xffffffffu, psum[r], 2);
      lrow[r] = lrow[r] * alpha[r] + psum[r];
    }
#pragma unroll
    for (int i2 = 0; i2 < DP / 8; ++i2)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[i2][e] *= alpha[e >> 1];

    // O += P V: the score fragments of keys 16kk..16kk+15 are the A fragment
    // of k step kk, as bf16 hi + lo (PV sees P to ~2^-16, not bf16's 2^-8)
#pragma unroll
    for (int kk = 0; kk < NF / 2; ++kk) {
      uint32_t ph[4], pl[4];
      hi_lo(s[2 * kk][0], s[2 * kk][1], ph[0], pl[0]);
      hi_lo(s[2 * kk][2], s[2 * kk][3], ph[1], pl[1]);
      hi_lo(s[2 * kk + 1][0], s[2 * kk + 1][1], ph[2], pl[2]);
      hi_lo(s[2 * kk + 1][2], s[2 * kk + 1][3], ph[3], pl[3]);
#pragma unroll
      for (int dp = 0; dp < KS; ++dp) {
        uint32_t vb[4];
        ldsm_x4_t(vb, vs + swz<DP>(16 * kk + (mi & 1) * 8 + ri, 2 * dp + (mi >> 1)));
        mma16816(o[2 * dp], ph, vb[0], vb[1]);
        mma16816(o[2 * dp], pl, vb[0], vb[1]);
        mma16816(o[2 * dp + 1], ph, vb[2], vb[3]);
        mma16816(o[2 * dp + 1], pl, vb[2], vb[3]);
      }
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }

  // The merge reads everything (gate, the other splits' partials) before its
  // first store: `out` may alias the gate for all the compiler knows, so a
  // load after a store would wait for it, one round trip at a time.
  using P = OutPair<bf16>;
  bf16* op = static_cast<bf16*>(a.out) + b * a.so[0] + h * a.so[1];
  const bf16* gp = a.gate ? static_cast<const bf16*>(a.gate) + b * a.sg[0] + h * a.sg[1] : nullptr;
  if (nsplit == 1) {  // one split: normalize, gate and store from registers
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int t = q0 + warp * 16 + g + 8 * r;
      if (t >= a.Tq) continue;
      const float inv = 1.f / lrow[r];
#pragma unroll
      for (int dn = 0; dn < DP / 8; ++dn) {
        const int d = 8 * dn + 2 * t4;
        if (d >= D) continue;
        P::store(op, a.so[2], t, d, P::gated(gp, a.sg[2], t, d, o[dn][2 * r] * inv, o[dn][2 * r + 1] * inv));
      }
    }
    return;
  }

  // several splits: each leaves (m, l, O) of its keys in its shared memory
  __syncthreads();  // the K/V tiles become the O partials
  float* part = reinterpret_cast<float*>(sm);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = warp * 16 + g + 8 * r;
#pragma unroll
    for (int dn = 0; dn < DP / 8; ++dn)
      *reinterpret_cast<float2*>(part + row * Lay::OST + 8 * dn + 2 * t4) = make_float2(o[dn][2 * r], o[dn][2 * r + 1]);
    if (t4 == 0) {
      m_s[row] = mrow[r];
      l_s[row] = lrow[r];
    }
  }
  merge_splits<bf16, DP, Lay::OST>(a, part, m_s, l_s, w_s, q0, op, gp, D);
}

// The key split is chosen from the shape: the keys are split where the (b,
// h, q tile) blocks alone cannot fill the SMs (the DiT's 64 pairs at Tq <=
// 64), up to about `per_sm` blocks per SM and FMAXSPLIT, with every split
// given at least one key tile of `tile_keys`. Fills `cfg` (and its cluster
// attribute `at`) for a grid of (splits, q tiles, B * H) blocks of FNT
// threads, the splits of one (b, h, q tile) a cluster; returns the key
// tiles per split.
int split_launch(const AttnArgs& a, int tile_keys, int smem, int per_sm, cudaStream_t stream,
                 cudaLaunchConfig_t& cfg, cudaLaunchAttribute (&at)[1]) {
  const int nt = (a.S[0] + tile_keys - 1) / tile_keys + (a.S[1] + tile_keys - 1) / tile_keys;
  const int qt = (a.Tq + FBQ - 1) / FBQ, base = qt * a.H * a.B, sms = sm_count();
  int splits = base >= sms ? 1 : std::max(1, std::min({FMAXSPLIT, nt, (per_sm * sms + base - 1) / base}));
  const int per = std::max(1, (nt + splits - 1) / splits);
  splits = std::max(1, (nt + per - 1) / per);
  cfg = cudaLaunchConfig_t{};
  cfg.gridDim = dim3(splits, qt, a.B * a.H);
  cfg.blockDim = dim3(FNT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = splits;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  cfg.attrs = at;
  cfg.numAttrs = 1;
  return per;
}

template <int DP>
int launch_mma(const AttnArgs& a, int D, cudaStream_t stream) {
  using Lay = MmaLayout<DP>;
  static const cudaError_t attr =
      cudaFuncSetAttribute(attn_mma_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, Lay::BYTES);
  if (attr != cudaSuccess) return (int)attr;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute at[1];
  const int per = split_launch(a, FBK, Lay::BYTES, 2, stream, cfg, at);
  const cudaError_t e = cudaLaunchKernelEx(&cfg, attn_mma_kernel<DP>, a, D, per);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

// ------------------------------------------------------------------ fp32, tensor cores (3xTF32)

// x = hi + lo as two tf32 mma operands: hi is x rounded to the nearest tf32
// (10 mantissa bits, ties away from zero: what cvt.rna.tf32.f32 gives, in
// two integer ops where cvt takes a longer sequence), lo = x - hi, exact in
// fp32 and at most 2^-11 of x, which the tensor core reads truncated to tf32
// (an error below 2^-21 of x, of either sign: lo's sign is x's rounding's)
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}
// d (16 x 8, fp32) += a (16 x 8, tf32) * b (8 x 8, tf32)
__device__ __forceinline__ void mma1688(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

constexpr int TBK = 32;  // keys per tile of the fp32 kernel

template <int D>
struct Tf32Layout {  // shared memory of attn_tf32_kernel<D>
  static constexpr int DP = (D + 15) / 16 * 16;        // Q's, K's, V's and O's columns (D = 120 zero-padded to 128)
  static constexpr int KST = DP + 8;                   // K's and Q's row stride in floats
  static constexpr int VST = DP + 4;                   // V's
  static constexpr int KT = TBK * KST * 4;             // bytes of one K tile
  static constexpr int VT = TBK * VST * 4;             // and of one V tile
  static constexpr int Q = 2 * (KT + VT);              // after [2 stages] K, [2 stages] V: Q [FBQ][KST]
  static constexpr int MASK = Q + FBQ * KST * 4;       // then the key masks, a bit a key: u32 [2]
  static constexpr int ROW = MASK + 2 * 4;             // then fp32 m[FBQ], l[FBQ], merge weights [FBQ][FMAXSPLIT]
  static constexpr int BYTES = ROW + FBQ * (2 + FMAXSPLIT) * 4;
  static constexpr int OST = DP + 4;                   // fp32 row stride of the O partials, in the K/V tiles' place
  // a half-warp's float2 reads of K and Q (rows g of 0..3 or 4..7, columns 2 t4) hit 32 distinct banks
  static_assert(KST % 32 == 8, "K's row stride");
  // a half-warp's float2 V reads (rows 2 t4, columns 2 g) likewise
  static_assert((2 * VST) % 32 == 8, "V's row stride");
  static_assert(FBQ * OST * 4 <= Q, "the O partials fit in the K/V tiles");
};

// One block per (key split, 64-row q tile, (b, h)); a warp owns 16 query
// rows. `per` key tiles of TBK per split; the splits of one (b, h, q tile)
// are a cluster (grid.x) and merge through distributed shared memory.
//
// Every product is 3xTF32 on mma.sync m16n8k8: each operand is split into
// tf32 hi + lo, and hi*lo + lo*hi + hi*hi is accumulated in fp32 (lo*lo,
// at most 2^-22 of the product, is dropped). The tensor cores truncate
// where they add into the accumulator, a bias of up to an ulp a step, so no
// chain of hi*hi terms runs long: QK^T's alternate between two accumulators
// (D / 16 steps each; the cross terms, 2^-11 of them, share a third), and
// PV accumulates each key tile in fresh registers that are added to O in
// fp32 on the CUDA cores (4 steps). The k index of both
// products is permuted inside each group of 8 so that no value moves
// between lanes:
//  * QK^T: the A column t4 / t4 + 4 of k step kq is head dim 8 kq + 2 t4 /
//    + 1, so Q and K are read as float2 pairs;
//  * PV: a score fragment holds keys 2 t4 and 2 t4 + 1 of its 8, which the
//    tf32 A fragment wants as columns t4 and t4 + 4, so column t4 / t4 + 4 of
//    k step kk is key 8 kk + 2 t4 / + 1 and V's rows are read in that order
//    (PV sums over keys, so the order is free): no quad shuffle. The two n
//    fragments 2p and 2p + 1 take head dims 16 p + 2 g and 16 p + 2 g + 1,
//    so one float2 of V feeds both, and a lane ends with head dims 16 p +
//    4 t4 .. + 3 of its two rows: one float4 store each.
template <int D>
__global__ void __launch_bounds__(FNT, 2) attn_tf32_kernel(const AttnArgs a, const int per) {
  using Lay = Tf32Layout<D>;
  constexpr int DP = Lay::DP, KST = Lay::KST, VST = Lay::VST;
  constexpr int KS = DP / 8, NF = TBK / 8, NP = DP / 16, CH = DP / 4;
  static_assert(TBK == 32, "a tile's key mask is one 32-bit word");
  static_assert(D % 8 == 0, "head dim must be a multiple of 8");
  extern __shared__ __align__(128) unsigned char sm[];
  float* Kt[2] = {reinterpret_cast<float*>(sm), reinterpret_cast<float*>(sm + Lay::KT)};
  float* Vt[2] = {reinterpret_cast<float*>(sm + 2 * Lay::KT), reinterpret_cast<float*>(sm + 2 * Lay::KT + Lay::VT)};
  float* Qs = reinterpret_cast<float*>(sm + Lay::Q);
  uint32_t* Mw = reinterpret_cast<uint32_t*>(sm + Lay::MASK);
  float* m_s = reinterpret_cast<float*>(sm + Lay::ROW);
  float* l_s = m_s + FBQ;
  float* w_s = l_s + FBQ;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2, t4 = lane & 3;
  const int split = blockIdx.x, nsplit = gridDim.x;
  const int q0 = blockIdx.y * FBQ, b = blockIdx.z / a.H, h = blockIdx.z % a.H;
  const int n0 = (a.S[0] + TBK - 1) / TBK, nt = n0 + (a.S[1] + TBK - 1) / TBK;
  const int t_begin = min(nt, split * per), t_end = min(nt, t_begin + per);

  auto load_tile = [&](int t, int stage) {
    const int src = t < n0 ? 0 : 1, j0 = (t < n0 ? t : t - n0) * TBK;
    const int nk = min(TBK, a.S[src] - j0);
    const float* kp = static_cast<const float*>(a.k[src]) + b * a.sk[src][0] + h * a.sk[src][1];
    const float* vp = static_cast<const float*>(a.v[src]) + b * a.sv[src][0] + h * a.sv[src][1];
    for (int i = tid; i < TBK * CH; i += FNT) {
      const int j = i / CH, c = i % CH;
      const bool ok = j < nk && c < D / 4;  // zero fill: keys past the end, and the columns past D
      cp_async16(Kt[stage] + j * KST + 4 * c, ok ? kp + (long long)(j0 + j) * a.sk[src][2] + 4 * c : kp, ok);
      cp_async16(Vt[stage] + j * VST + 4 * c, ok ? vp + (long long)(j0 + j) * a.sv[src][2] + 4 * c : vp, ok);
    }
    if (warp == 0) {  // bit j: key j0 + j is attended
      const uint32_t w = __ballot_sync(0xffffffffu, lane < nk && a.m[src][b * a.msb[src] + j0 + lane]);
      if (lane == 0) Mw[stage] = w;
    }
  };

  // the block's 64 query rows, fp32, in shared memory for the whole run (split where used)
  const float* qp = static_cast<const float*>(a.q) + b * a.sq[0] + h * a.sq[1];
  for (int i = tid; i < FBQ * CH; i += FNT) {
    const int r = i / CH, c = i % CH, t = q0 + r;
    const bool ok = t < a.Tq && c < D / 4;
    cp_async16(Qs + r * KST + 4 * c, ok ? qp + (long long)t * a.sq[2] + 4 * c : qp, ok);
  }
  if (t_begin < t_end) load_tile(t_begin, 0);
  cp_async_commit();
  const float* qw = Qs + (warp * 16 + g) * KST + 2 * t4;  // rows g and g + 8 of the warp, columns 2 t4, + 1

  // O (16 rows x DP per warp), the running max and denominator of rows g and g + 8
  float o[DP / 8][4];
#pragma unroll
  for (int i = 0; i < DP / 8; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float mrow[2] = {-INFINITY, -INFINITY}, lrow[2] = {0.f, 0.f};

  for (int t = t_begin, i = 0; t < t_end; ++t, ++i) {
    const int st = i & 1;
    cp_async_wait<0>();
    // tile t (and on the first, Q) is visible to every warp, and every warp
    // is done with tile t - 1, whose stage tile t + 1 now refills
    __syncthreads();
    if (t + 1 < t_end) load_tile(t + 1, st ^ 1);
    cp_async_commit();
    const int src = t < n0 ? 0 : 1;
    const int nk = min(TBK, a.S[src] - (t < n0 ? t : t - n0) * TBK);
    const float* ks = Kt[st];
    const float* vs = Vt[st];
    const uint32_t mw = Mw[st];

    // S = Q K^T for the warp's 16 rows, NF fragments of 8 keys
    float sb[2][NF][4], sx[NF][4];
#pragma unroll
    for (int n = 0; n < NF; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sb[0][n][e] = sb[1][n][e] = sx[n][e] = 0.f;
    // k steps in pairs, the hi*hi terms of the pair's two in two accumulators
    // (unrolled 4 pairs deep: fully, at D 128, ptxas spills to hold every load in flight)
#pragma unroll 4
    for (int kq = 0; kq < KS; kq += 2) {
#pragma unroll
      for (int k2 = 0; k2 < 2; ++k2) {
        const float2 qa = *reinterpret_cast<const float2*>(qw + 8 * (kq + k2));
        const float2 qb = *reinterpret_cast<const float2*>(qw + 8 * KST + 8 * (kq + k2));
        uint32_t ah[4], al[4];
        split_tf32(qa.x, ah[0], al[0]);  // (row g, column t4)
        split_tf32(qb.x, ah[1], al[1]);  // (g + 8, t4)
        split_tf32(qa.y, ah[2], al[2]);  // (g, t4 + 4)
        split_tf32(qb.y, ah[3], al[3]);  // (g + 8, t4 + 4)
#pragma unroll
        for (int n = 0; n < NF; ++n) {
          const float2 kv = *reinterpret_cast<const float2*>(ks + (8 * n + g) * KST + 8 * (kq + k2) + 2 * t4);
          uint32_t bh0, bl0, bh1, bl1;
          split_tf32(kv.x, bh0, bl0);
          split_tf32(kv.y, bh1, bl1);
          mma1688(sx[n], al, bh0, bh1);
          mma1688(sx[n], ah, bl0, bl1);
          mma1688(sb[k2][n], ah, bh0, bh1);
        }
      }
    }

    // online softmax; lanes 4g..4g+3 share rows g and g + 8
    float s[NF][4], tmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < NF; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = 8 * n + 2 * t4 + (e & 1);
        float v = (sb[0][n][e] + sb[1][n][e] + sx[n][e]) * a.scale;
        if (j >= nk) v = -INFINITY;      // past the end: no weight at all
        else if (!(mw >> j & 1)) v = -1e9f;  // masked: replaced, as the reference does
        s[n][e] = v;
        tmax[e >> 1] = fmaxf(tmax[e >> 1], v);
      }
    float alpha[2], psum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(0xffffffffu, tmax[r], 1));
      tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(0xffffffffu, tmax[r], 2));
      const float mnew = fmaxf(mrow[r], tmax[r]);  // finite: a tile holds at least one key
      alpha[r] = expf(mrow[r] - mnew);             // 0 on the split's first tile (m = -inf)
      mrow[r] = mnew;
    }
    // the probabilities as PV's A fragments, score fragment kk for k step kk:
    // keys 2 t4 and 2 t4 + 1 as columns t4 and t4 + 4
    uint32_t ph[NF][4], pl[NF][4];
#pragma unroll
    for (int n = 0; n < NF; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = expf(s[n][e] - mrow[e >> 1]);
        psum[e >> 1] += s[n][e];
      }
      split_tf32(s[n][0], ph[n][0], pl[n][0]);  // (row g, key 2 t4)
      split_tf32(s[n][2], ph[n][1], pl[n][1]);  // (g + 8, 2 t4)
      split_tf32(s[n][1], ph[n][2], pl[n][2]);  // (g, 2 t4 + 1)
      split_tf32(s[n][3], ph[n][3], pl[n][3]);  // (g + 8, 2 t4 + 1)
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      psum[r] += __shfl_xor_sync(0xffffffffu, psum[r], 1);
      psum[r] += __shfl_xor_sync(0xffffffffu, psum[r], 2);
      lrow[r] = lrow[r] * alpha[r] + psum[r];
    }

    // O = alpha O + P V, the tile's P V in fresh accumulators (hi*hi, and the cross terms)
    const float* v0 = vs + 2 * t4 * VST + 2 * g;
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      float tb[2][4], tx[2][4];
#pragma unroll
      for (int e = 0; e < 4; ++e) tb[0][e] = tb[1][e] = tx[0][e] = tx[1][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < NF; ++kk) {
        const float2 x0 = *reinterpret_cast<const float2*>(v0 + 8 * kk * VST + 16 * p);        // key 2 t4: row t4
        const float2 x1 = *reinterpret_cast<const float2*>(v0 + (8 * kk + 1) * VST + 16 * p);  // 2 t4 + 1: t4 + 4
        uint32_t h0[2], l0[2], h1[2], l1[2];
        split_tf32(x0.x, h0[0], l0[0]);  // fragment 2p, head dim 16 p + 2 g
        split_tf32(x1.x, h0[1], l0[1]);
        split_tf32(x0.y, h1[0], l1[0]);  // fragment 2p + 1, head dim 16 p + 2 g + 1
        split_tf32(x1.y, h1[1], l1[1]);
        mma1688(tx[0], pl[kk], h0[0], h0[1]);
        mma1688(tx[0], ph[kk], l0[0], l0[1]);
        mma1688(tb[0], ph[kk], h0[0], h0[1]);
        mma1688(tx[1], pl[kk], h1[0], h1[1]);
        mma1688(tx[1], ph[kk], l1[0], l1[1]);
        mma1688(tb[1], ph[kk], h1[0], h1[1]);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        o[2 * p][e] = o[2 * p][e] * alpha[e >> 1] + (tb[0][e] + tx[0][e]);
        o[2 * p + 1][e] = o[2 * p + 1][e] * alpha[e >> 1] + (tb[1][e] + tx[1][e]);
      }
    }
  }

  // lane (g, t4) holds head dims 16 p + 4 t4 .. + 3 of rows g and g + 8 as
  // (o[2p][2r], o[2p + 1][2r], o[2p][2r + 1], o[2p + 1][2r + 1])
  float* op = static_cast<float*>(a.out) + b * a.so[0] + h * a.so[1];
  const float* gp = a.gate ? static_cast<const float*>(a.gate) + b * a.sg[0] + h * a.sg[1] : nullptr;
  if (nsplit == 1) {  // one split: normalize, gate and store from registers
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int t = q0 + warp * 16 + g + 8 * r;
      if (t >= a.Tq) continue;
      const float inv = 1.f / lrow[r];
      float* orow = op + (long long)t * a.so[2];
      const float* gr = gp ? gp + (long long)t * a.sg[2] : nullptr;
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        const int d = 16 * p + 4 * t4;
        if (d >= D) continue;
        float4 v = make_float4(o[2 * p][2 * r] * inv, o[2 * p + 1][2 * r] * inv, o[2 * p][2 * r + 1] * inv,
                               o[2 * p + 1][2 * r + 1] * inv);
        if (gr) {
          const float4 gv = *reinterpret_cast<const float4*>(gr + d);
          v = make_float4(gate_f32(v.x, gv.x), gate_f32(v.y, gv.y), gate_f32(v.z, gv.z), gate_f32(v.w, gv.w));
        }
        *reinterpret_cast<float4*>(orow + d) = v;
      }
    }
    return;
  }

  // several splits: each leaves (m, l, O) of its keys in its shared memory
  __syncthreads();  // the K/V tiles become the O partials
  float* part = reinterpret_cast<float*>(sm);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = warp * 16 + g + 8 * r;
#pragma unroll
    for (int p = 0; p < NP; ++p)
      *reinterpret_cast<float4*>(part + row * Lay::OST + 16 * p + 4 * t4) =
          make_float4(o[2 * p][2 * r], o[2 * p + 1][2 * r], o[2 * p][2 * r + 1], o[2 * p + 1][2 * r + 1]);
    if (t4 == 0) {
      m_s[row] = mrow[r];
      l_s[row] = lrow[r];
    }
  }
  merge_splits<float, DP, Lay::OST>(a, part, m_s, l_s, w_s, q0, op, gp, D);
}

template <int D>
int launch_tf32(const AttnArgs& a, cudaStream_t stream) {
  using Lay = Tf32Layout<D>;
  static const cudaError_t attr =
      cudaFuncSetAttribute(attn_tf32_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, Lay::BYTES);
  if (attr != cudaSuccess) return (int)attr;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute at[1];
  // about three blocks per SM (two fit): shorter splits measured faster at
  // the teacher's DiT shape than one wave of longer ones (PERF.md)
  const int per = split_launch(a, TBK, Lay::BYTES, 3, stream, cfg, at);
  const cudaError_t e = cudaLaunchKernelEx(&cfg, attn_tf32_kernel<D>, a, per);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
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
  // fp32: the 3xTF32 tensor-core kernel (16-byte aligned q/k/v/gate/out rows
  // are the wrapper's check); bf16: the bf16 tensor-core kernel (16-byte
  // aligned q/k/v rows and 4-byte aligned out pairs); D = 4, either dtype: the
  // small-head kernel (element loads, no alignment needed)
  switch (dtype * 1000 + D) {
    case 4: return launch_small<float, 4>(a, s);
    case 64: return launch_tf32<64>(a, s);
    case 120: return launch_tf32<120>(a, s);
    case 128: return launch_tf32<128>(a, s);
    case 1004: return launch_small<__nv_bfloat16, 4>(a, s);
    case 1064: return launch_mma<64>(a, D, s);
    case 1120: return launch_mma<128>(a, D, s);
    case 1128: return launch_mma<128>(a, D, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* st_attention_error(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
