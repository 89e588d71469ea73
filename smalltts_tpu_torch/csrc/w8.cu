// int8-weight products for Hopper (sm_90a): port of the three Pallas TPU
// kernels of smalltts_tpu/ops/pallas/w8.py (w8_matmul, w8_matmul_stacked,
// w8_matmul_all_layers).
//
//   out[l, m, n] = bf16( sum_k float(x[m, k]) * float(q[l', k, n]) * scale[l', n] )
//
// x is (M, K) bf16, q (L, K, N) int8, scale (L, N) fp32; the sum is fp32 and
// the scale multiplies the fp32 sum before the one rounding, the order of
// _w8_kernel (w8.py:72-76). The layer l' is a grid index (all layers, out has
// L slabs), or is read by every block from a device int32 (stacked: the host
// never reads the index, so the launch makes no synchronizing call), or 0.
// An index out of [0, L) is clamped, as the plain version clamps it.
//
// Two kernels, chosen in st_w8_matmul from the shape and the alignment alone.
//
// w8_wgmma_kernel, on the tensor cores, wherever TMA can read the operands
// (N a multiple of 16, K of 8, 16-byte-aligned bases). What bounds it on the
// H100: with few rows (M <= 8, and the serving path's all-layers product at
// M = 4: 66.4 MB of int8, 20 us at 3.35 TB/s) the weight bytes, which must be
// in flight by the megabyte to reach the card's rate; with many rows
// (M = 320) the products, 1.8 GFLOP that the CUDA cores' 67 TFLOP/s fp32
// cannot do in the time the weight streams. One design serves both, the
// transposed product out^T = W^T x^T:
//   - the weight is wgmma's A operand, from registers. A 64 k x 128 column
//     int8 tile lands in shared memory by TMA in the 128-byte swizzle; each
//     consumer thread reads the 4 columns it owns with conflict-free 32-bit
//     loads, turns the bytes into bf16 exactly (0x4300 | the low 7 bits is
//     128 + m, 0x4300 | the top bit is 128 or 256, one bf16x2 subtraction
//     gives q) straight into the A fragments of two m64 tiles, and never
//     writes a bf16 weight anywhere. The scale stays out of the conversion:
//     the epilogue multiplies the fp32 sum by it and rounds once;
//   - x is the B operand, K-major as it is stored, by TMA in the swizzle
//     wgmma reads; its rows are wgmma's n (8, 32 or 64 a block), so M = 8
//     wastes no 64-row tile. TMA zero-fills the M, N and K tails;
//   - a ring of 4 stages (64 k each) is kept full by one thread of a TMA
//     warp, which starts the first round before the block has gathered; the
//     consumer warpgroup reads a stage's bytes in one shared-memory round
//     trip and keeps 4 wgmma groups in flight, converting the next 16 k
//     while the last products run;
//   - where the tiles are fewer than the SMs, K is split over a thread-block
//     cluster of 2, 4 or 8 ranks. The 8-row units of the tile are shared out
//     over the ranks; every rank stores its fp32 partial of a unit into its
//     own slot in the owner's shared memory (distributed shared memory), and
//     after one cluster barrier the owner adds the slots in rank order,
//     scales, rounds once and stores: one launch, no scratch, no atomics,
//     the same bits every run;
//   - a stack is one tensor map over (L * K, N): the block adds layer * K to
//     the row coordinate, so the index never leaves the card. A k tile past K
//     reads the next layer's rows against x columns TMA filled with zeros.
//
// w8_stream_kernel, on the CUDA cores, for what TMA cannot take (N a multiple
// of 8 only, K not of 8, an 8-byte-aligned view). The int8 tile goes from
// device memory straight into registers, 8 bytes (8 columns) a thread; a
// block owns 128 columns of one layer and 8 rows of x, staged transposed in
// shared memory; the products are fp32 FMAs (64 per 8 weight bytes);
// the 16 k-row groups of a block are reduced by a warp shuffle and then
// through shared memory.
//
// Measured times (H100 80GB HBM3, 700 W) and the grid each shape gets are in
// PERF.md section 6.

#include <cuda_bf16.h>

#include <algorithm>

#include "sm90_wgmma.cuh"

using bf16 = __nv_bfloat16;

namespace {

// ------------------------------------------------- the streaming kernel (CUDA cores)

constexpr int W8_WARPS = 8;
constexpr int W8_THREADS = 32 * W8_WARPS;
constexpr int W8_BN = 128;               // columns per block: 16 lanes x 8 columns
constexpr int W8_KR = W8_THREADS / 16;   // k rows in flight per block step (16)
constexpr int W8_UNROLL = 4;             // weight loads in flight per thread
constexpr int MT = 8;                    // rows of x per block

__device__ __forceinline__ float bf16_lo(uint32_t v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t v) { return __uint_as_float(v & 0xffff0000u); }
__device__ __forceinline__ float s8(uint32_t v, int j) {
  return static_cast<float>(static_cast<int8_t>((v >> (8 * j)) & 0xffu));
}

// the MT x values of one k, from the [K][MT] bf16 staging tile
__device__ __forceinline__ void load_x(const __nv_bfloat16* xs, int k, float (&xv)[MT]) {
  const uint4 v = *reinterpret_cast<const uint4*>(xs + k * MT);
  xv[0] = bf16_lo(v.x); xv[1] = bf16_hi(v.x); xv[2] = bf16_lo(v.y); xv[3] = bf16_hi(v.y);
  xv[4] = bf16_lo(v.z); xv[5] = bf16_hi(v.z); xv[6] = bf16_lo(v.w); xv[7] = bf16_hi(v.w);
}

__global__ void __launch_bounds__(W8_THREADS) w8_stream_kernel(const __nv_bfloat16* __restrict__ x,
                                                        const int8_t* __restrict__ wq,
                                                        const float* __restrict__ scale,
                                                        const int* __restrict__ idx,
                                                        __nv_bfloat16* __restrict__ out, int M, int K,
                                                        int N, int L) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem);  // [K][MT], then reused:
  float* red = reinterpret_cast<float*>(smem);                 // [W8_WARPS][MT][W8_BN]

  int layer = blockIdx.y;
  if (idx) layer = min(max(__ldg(idx), 0), L - 1);
  const int n0 = blockIdx.x * W8_BN, m0 = blockIdx.z * MT;

  for (int i = threadIdx.x; i < MT * K; i += W8_THREADS) {
    const int m = i / K, k = i % K;
    xs[k * MT + m] = m0 + m < M ? x[(long long)(m0 + m) * K + k] : __float2bfloat16(0.f);
  }
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int kr = warp * 2 + (lane >> 4);  // this thread's k row within a block step
  const int cg = lane & 15;               // its 8-column group
  const int n = n0 + cg * 8;
  const bool col_ok = n < N;
  const int8_t* wp = wq + (long long)layer * K * N + n;

  float acc[MT][8];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[m][j] = 0.f;

  for (int k0 = kr; k0 < K; k0 += W8_KR * W8_UNROLL) {
    uint2 wv[W8_UNROLL];
#pragma unroll
    for (int u = 0; u < W8_UNROLL; ++u) {
      const int k = k0 + u * W8_KR;
      wv[u] = (col_ok && k < K) ? __ldg(reinterpret_cast<const uint2*>(wp + (long long)k * N))
                                : make_uint2(0u, 0u);
    }
#pragma unroll
    for (int u = 0; u < W8_UNROLL; ++u) {
      const int k = k0 + u * W8_KR;
      if (k >= K) break;
      float xv[MT];
      load_x(xs, k, xv);
      float w[8];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        w[j] = s8(wv[u].x, j);
        w[4 + j] = s8(wv[u].y, j);
      }
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[m][j] = fmaf(xv[m], w[j], acc[m][j]);
    }
  }

  // the warp's two k rows first (lanes 16 apart), then the 8 warps through shared memory
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[m][j] += __shfl_xor_sync(0xffffffffu, acc[m][j], 16);
  __syncthreads();  // every thread is done with xs: the buffer becomes the reduction tile
  if (lane < 16) {
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int j = 0; j < 8; ++j) red[(warp * MT + m) * W8_BN + cg * 8 + j] = acc[m][j];
  }
  __syncthreads();

  __nv_bfloat16* o = out + (long long)blockIdx.y * M * N;
  for (int i = threadIdx.x; i < MT * W8_BN; i += W8_THREADS) {
    const int m = i / W8_BN, c = i % W8_BN;
    if (m0 + m >= M || n0 + c >= N) continue;
    float s = 0.f;
#pragma unroll
    for (int r = 0; r < W8_WARPS; ++r) s += red[(r * MT + m) * W8_BN + c];
    o[(long long)(m0 + m) * N + n0 + c] = __float2bfloat16(s * scale[(long long)layer * N + n0 + c]);
  }
}

int launch_stream(const void* x, const void* wq, const float* scale, const int* idx, void* out, int M, int K,
                  int N, int L, int grid_layers, cudaStream_t s) {
  const size_t stage = (size_t)K * MT * sizeof(__nv_bfloat16);
  const size_t reduce = (size_t)W8_WARPS * MT * W8_BN * sizeof(float);
  const size_t bytes = stage > reduce ? stage : reduce;
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(w8_stream_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               (int)bytes);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((N + W8_BN - 1) / W8_BN, grid_layers, (M + MT - 1) / MT);
  w8_stream_kernel<<<grid, W8_THREADS, bytes, s>>>(static_cast<const __nv_bfloat16*>(x),
                                            static_cast<const int8_t*>(wq), scale, idx,
                                            static_cast<__nv_bfloat16*>(out), M, K, N, L);
  return (int)cudaGetLastError();
}

// ----------------------------------------------- the tensor-core kernel (wgmma + TMA)

constexpr int TBN = 128;      // weight columns per block: two m64 wgmma tiles, 128 bytes a k row
constexpr int TBK = 64;       // k per stage
constexpr int TMAXSPLIT = 8;  // K ranks per output tile (the portable cluster size)
constexpr int TSTAGES = 4;    // stages in the ring

struct W8Args {
  const float* scale;  // (L, N)
  const int* idx;      // the layer, a device int32, or null
  bf16* out;           // (M, N), or (L, M, N) with a grid of layers
  int M, K, N, L;
  int mtiles;  // row tiles per layer: blockIdx.z = layer slab * mtiles + row tile
};

// NM: rows of x per block, wgmma's n
template <int NM>
struct W8Cfg {
  static constexpr int W_BYTES = TBK * TBN;     // the int8 tile as TMA lands it
  static constexpr int X_BYTES = NM * TBK * 2;  // NM rows of 64 bf16
  static constexpr int STAGE = W_BYTES + X_BYTES;
  static constexpr int BAR = TSTAGES * STAGE;  // mbarriers after the stages
  static constexpr int PART = BAR + 128;      // then, with K split, the ranks' partials
  static constexpr int CONSUMERS = 128;
  static constexpr int THREADS = CONSUMERS + 32;  // the consumer warpgroup, then the TMA warp
  static constexpr int UNITS = NM / 8;            // 8-row units of the tile: 8 accumulators a thread each
  static constexpr int SLOT = CONSUMERS * 8 * 4;  // one rank's partial of one unit
  // dynamic shared memory, with slack for the 1024-byte alignment; a unit's owner holds a slot per rank
  static constexpr int smem(int split) { return PART + 1024 + (split > 1 ? TMAXSPLIT * SLOT : 0); }
  static_assert(STAGE % 1024 == 0, "every tile keeps the 1024-byte alignment of the 128-byte swizzle");
  static_assert(2 * TSTAGES * 8 <= 128 && UNITS <= TMAXSPLIT, "barriers and slots fit their room");
};

// d (64 x 8, fp32) += A (64 x 16, bf16 fragments in registers) * B (16 x 8, K-major in shared memory)
__device__ __forceinline__ void wgmma_rs_n8(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3"
      "}, {%4, %5, %6, %7}, %8, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 32, fp32) += A (64 x 16, bf16 fragments in registers) * B (16 x 32, K-major in shared memory)
__device__ __forceinline__ void wgmma_rs_n32(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 64, fp32) += A (64 x 16, bf16 fragments in registers) * B (16 x 64, K-major in shared memory)
__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int NM>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a, uint64_t db) {
  if constexpr (NM == 8) wgmma_rs_n8(d, a, db);
  else if constexpr (NM == 32) wgmma_rs_n32(d, a, db);
  else wgmma_rs_n64(d, a, db);
}

// the int8 values in bytes 0 and 2 of v as a bf16 pair, exactly: with m the
// low 7 bits of a byte, 0x4300 | m is bf16 128 + m, and 0x4300 | the top bit
// is 128 (q >= 0, q = m) or 256 (q < 0, q = m - 128); the difference is q
__device__ __forceinline__ uint32_t s8x2_bf16x2(uint32_t v) {
  const uint32_t mag = (v & 0x007f007fu) | 0x43004300u, top = (v & 0x00800080u) | 0x43004300u;
  const __nv_bfloat162 q = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&mag),
                                   *reinterpret_cast<const __nv_bfloat162*>(&top));
  return *reinterpret_cast<const uint32_t*>(&q);
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

template <int NM>
__global__ void __launch_bounds__(W8Cfg<NM>::THREADS, 2)
    w8_wgmma_kernel(const __grid_constant__ CUtensorMap tmX, const __grid_constant__ CUtensorMap tmW,
                    const W8Args g) {
  using C = W8Cfg<NM>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  auto w_tile = [&](int s) { return sm + s * C::STAGE; };
  auto x_tile = [&](int s) { return sm + s * C::STAGE + C::W_BYTES; };
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + C::BAR);  // the stage's TMA tiles have landed
  uint64_t* empty = full + TSTAGES;                           // the consumers are done with it

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // grid.x is the cluster: the K ranks of one output tile
  const int split = blockIdx.x, nsplit = gridDim.x;
  const int n0 = blockIdx.y * TBN;
  const int slab = blockIdx.z / g.mtiles, m0 = (blockIdx.z % g.mtiles) * NM;
  const int layer = g.idx ? min(max(__ldg(g.idx), 0), g.L - 1) : slab;
  const int nk = (g.K + TBK - 1) / TBK;
  const int kt0 = split * nk / nsplit, kt1 = (split + 1) * nk / nsplit;

  // k tile kt0 + i into stage i % TSTAGES
  auto load_stage = [&](int i) {
    const int s = i % TSTAGES, kt = kt0 + i;
    mbar_expect_tx(&full[s], C::STAGE);
    tma_load_2d(w_tile(s), &tmW, n0, layer * g.K + kt * TBK, &full[s]);
    tma_load_2d(x_tile(s), &tmX, kt * TBK, m0, &full[s]);
  };
  const bool producer = warp == C::THREADS / 32 - 1;  // the TMA warp: its lane 0 keeps the ring full
  if (producer && lane == 0) {
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&tmW)) : "memory");
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&tmX)) : "memory");
    for (int s = 0; s < TSTAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], C::CONSUMERS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    // the first round of the ring needs no consumer: it is on its way before the block has gathered
    for (int i = 0; i < min(TSTAGES, kt1 - kt0); ++i) load_stage(i);
  }
  __syncthreads();
  // a rank may store into another's shared memory only once that block has
  // started: arrive here, wait before the first such store (long passed by then)
  if (nsplit > 1) cluster_arrive_relaxed();

  // the block's part of out^T: weight columns are wgmma's rows. acc[0, NM/2)
  // is the m64 tile of columns 4g and 4g + 1 of each thread's 4, acc[NM/2,
  // NM) that of columns 4g + 2 and 4g + 3 (below)
  float acc[NM];
#pragma unroll
  for (int i = 0; i < NM; ++i) acc[i] = 0.f;

  if (producer) {
    if (lane == 0) {
      for (int i = TSTAGES; i < kt1 - kt0; ++i) {
        mbar_wait(&empty[i % TSTAGES], (i / TSTAGES & 1) ^ 1);
        load_stage(i);
      }
    }
    __syncwarp();
  } else {
    // the consumer warpgroup. Warp w owns the tile's columns 32w .. 32w + 31
    // and lane 4g + c of it the columns 32w + 4g .. + 3: row g of a warp's
    // 16 wgmma rows is column 4g (first m64 tile) or 4g + 2 (second), row
    // g + 8 column 4g + 1 or 4g + 3. So the thread's A fragments of a k16
    // step are the bytes of 4 words, one per k row 2c, 2c + 1, 2c + 8, 2c + 9,
    // and every value of its 4 columns ends in one thread for the epilogue.
    const int g8 = lane >> 2, c = lane & 3;
    const int chunk = 2 * warp + (g8 >> 2), inb = 4 * (g8 & 3);  // 16-byte chunk of the k row, byte in it
    uint32_t a[TBK / 16][8];  // per k16 step: 4 registers of each m64 tile
    for (int kt = kt0, i = 0; kt < kt1; ++kt, ++i) {
      const int s = i % TSTAGES, u = i / TSTAGES;
      mbar_wait(&full[s], u & 1);
      const unsigned char* wt = w_tile(s);
      // the stage's 16 words of this thread up front: one shared-memory round trip a stage, not one a step
      uint32_t w[TBK / 16][4];
#pragma unroll
      for (int j = 0; j < TBK / 16; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          // k row r of the tile sits at 128 r, its 16-byte chunk ch at chunk ch ^ (r % 8)
          const int r = 16 * j + 2 * c + (q & 1) + 8 * (q >> 1);
          w[j][q] = *reinterpret_cast<const uint32_t*>(wt + r * TBN + ((chunk ^ (r & 7)) << 4) + inb);
        }
#pragma unroll
      for (int j = 0; j < TBK / 16; ++j) {
        // 4 groups stay in flight; the one that read a[j] a stage ago is done
        wgmma_wait<TBK / 16 - 1>();
        if (j == TBK / 16 - 1 && i > 0 && lane == 0) mbar_arrive(&empty[(i - 1) % TSTAGES]);  // and so is that stage
#pragma unroll
        for (int h = 0; h < 2; ++h) {  // k rows 2c, 2c + 1, then 2c + 8, 2c + 9
          const uint32_t lo = __byte_perm(w[j][2 * h], w[j][2 * h + 1], 0x5410);  // columns 4g, 4g + 1 of both k rows
          const uint32_t hi = __byte_perm(w[j][2 * h], w[j][2 * h + 1], 0x7632);  // columns 4g + 2, 4g + 3
          a[j][2 * h] = s8x2_bf16x2(lo);
          a[j][2 * h + 1] = s8x2_bf16x2(lo >> 8);
          a[j][4 + 2 * h] = s8x2_bf16x2(hi);
          a[j][4 + 2 * h + 1] = s8x2_bf16x2(hi >> 8);
        }
        fence_regs<NM>(acc);
        wgmma_fence();
        const uint64_t db = sw128_desc(x_tile(s) + 32 * j, 16, 1024);  // 16 k = 32 bytes along the row
        wgmma_rs<NM>(acc, a[j], db);
        wgmma_rs<NM>(acc + NM / 2, a[j] + 4, db);
        wgmma_commit();
      }
    }
    wgmma_wait<0>();
    fence_regs<NM>(acc);
  }

  // epilogue. Unit u of the tile is its x rows 8u .. 8u + 7: of those a
  // thread holds rows 2c and 2c + 1 for its 4 columns, va from the first m64
  // tile (x, y: the two rows at column 4g; z, w: at 4g + 1) and vb from the
  // second (columns 4g + 2, 4g + 3). Units past M are skipped.
  const int g8 = lane >> 2, c = lane & 3;
  const int units = min(C::UNITS, (g.M - m0 + 7) / 8);
  const int ncol = n0 + 32 * warp + 4 * g8;
  const bool col_ok = tid < C::CONSUMERS && ncol < g.N;  // N is a multiple of 16: all 4 columns or none
  float sc[4] = {0.f, 0.f, 0.f, 0.f};
  if (col_ok) {
#pragma unroll
    for (int e = 0; e < 4; ++e) sc[e] = __ldg(g.scale + (long long)layer * g.N + ncol + e);
  }
  bf16* orow = g.out + (long long)slab * g.M * g.N + ncol;
  auto store_unit = [&](int u, const float4& va, const float4& vb) {
    const int m = m0 + 8 * u + 2 * c;
    if (!col_ok) return;
    if (m < g.M)
      *reinterpret_cast<uint2*>(orow + (long long)m * g.N) =
          make_uint2(pack_bf16x2(va.x * sc[0], va.z * sc[1]), pack_bf16x2(vb.x * sc[2], vb.z * sc[3]));
    if (m + 1 < g.M)
      *reinterpret_cast<uint2*>(orow + (long long)(m + 1) * g.N) =
          make_uint2(pack_bf16x2(va.y * sc[0], va.w * sc[1]), pack_bf16x2(vb.y * sc[2], vb.w * sc[3]));
  };
  auto unit_a = [&](int u) { return make_float4(acc[4 * u], acc[4 * u + 1], acc[4 * u + 2], acc[4 * u + 3]); };
  auto unit_b = [&](int u) {
    return make_float4(acc[NM / 2 + 4 * u], acc[NM / 2 + 4 * u + 1], acc[NM / 2 + 4 * u + 2], acc[NM / 2 + 4 * u + 3]);
  };

  if (nsplit == 1) {
    if (tid < C::CONSUMERS) {
#pragma unroll
      for (int u = 0; u < C::UNITS; ++u)
        if (u < units) store_unit(u, unit_a(u), unit_b(u));
    }
    return;
  }

  // split K: the units of the tile are shared out over the ranks, unit u to
  // rank u % nsplit. Every rank stores its fp32 partial of a unit into a slot
  // of its own in the owner's shared memory (a thread's float4 next to its
  // neighbour's); after one cluster barrier the owner adds the slots in rank
  // order, scales, rounds once and stores. The slots are no stage of the
  // ring, so a rank may still be reading its stages while others store.
  float4* part = reinterpret_cast<float4*>(sm + C::PART);
  auto slot = [&](int t, int r) { return part + (t * nsplit + r) * (C::SLOT / 16) + tid; };  // t: the owner's t-th unit
  cluster_wait();  // every rank of the cluster has started (the arrive at the top)
  if (tid < C::CONSUMERS) {
#pragma unroll
    for (int u = 0; u < C::UNITS; ++u)
      if (u < units) {
        st_cluster4(slot(u / nsplit, split), u % nsplit, unit_a(u));
        st_cluster4(slot(u / nsplit, split) + C::CONSUMERS, u % nsplit, unit_b(u));
      }
  }
  __syncwarp();
  cluster_sync();
  if (tid < C::CONSUMERS) {
    for (int u = split, t = 0; u < units; u += nsplit, ++t) {
      float4 va[TMAXSPLIT], vb[TMAXSPLIT];  // every rank's loads in flight, then their sums
#pragma unroll
      for (int r = 0; r < TMAXSPLIT; ++r)
        if (r < nsplit) {
          va[r] = *slot(t, r);
          vb[r] = *(slot(t, r) + C::CONSUMERS);
        }
#pragma unroll
      for (int r = 1; r < TMAXSPLIT; ++r)
        if (r < nsplit) {
          va[0].x += va[r].x; va[0].y += va[r].y; va[0].z += va[r].z; va[0].w += va[r].w;
          vb[0].x += vb[r].x; vb[0].y += vb[r].y; vb[0].z += vb[r].z; vb[0].w += vb[r].w;
        }
      store_unit(u, va[0], vb[0]);
    }
  }
}

// K ranks per output tile, from the shape alone: the largest power of two
// that keeps 2 k tiles or more a rank and the blocks within `cap` (1 where
// the tiles alone come near it, or k is short). Measured on the H100: blocks
// of 64 rows are bound by what they read from L2, and more than one per SM
// gains nothing; blocks of 8 or 32 rows are bound by their own latency, and
// one and a half per SM still gains.
int pick_split(int blocks, int nk, int cap) {
  int split = 1;
  while (2 * split <= TMAXSPLIT && 2 * split <= nk / 2 && 2 * split * blocks <= cap) split *= 2;
  return split;
}

template <int NM>
int launch_wgmma(const void* x, const void* wq, const float* scale, const int* idx, void* out, int M, int K,
                 int N, int L, int grid_layers, cudaStream_t s) {
  using C = W8Cfg<NM>;
  static const cudaError_t attr =
      cudaFuncSetAttribute(w8_wgmma_kernel<NM>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::smem(2));
  if (attr != cudaSuccess) return (int)attr;
  // x in boxes of NM rows x 64 k, the stack as one (L * K, N) matrix in boxes of 64 k x 128 columns
  CUtensorMap tx, tw;
  if (!encode_map(&tx, MapSpec{x, false, M, K, K, TBK, NM, true}) ||
      !weight_map(&tw, MapSpec{wq, true, (long long)L * K, N, N, TBN, TBK, true}))
    return (int)cudaErrorInvalidValue;
  W8Args g{};
  g.scale = scale; g.idx = idx; g.out = static_cast<bf16*>(out);
  g.M = M; g.K = K; g.N = N; g.L = L;
  g.mtiles = (M + NM - 1) / NM;
  const int ntiles = (N + TBN - 1) / TBN;
  if ((long long)g.mtiles * grid_layers > 65535) return (int)cudaErrorInvalidValue;
  const int split = pick_split(ntiles * g.mtiles * grid_layers, (K + TBK - 1) / TBK,
                               NM == 64 ? sm_count() : sm_count() + sm_count() / 2);
  cudaLaunchConfig_t cfg{};
  cfg.gridDim = dim3(split, ntiles, g.mtiles * grid_layers);
  cfg.blockDim = dim3(C::THREADS);
  cfg.dynamicSmemBytes = C::smem(split);
  cfg.stream = s;
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = split;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  cfg.attrs = at;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, w8_wgmma_kernel<NM>, tx, tw, g);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

}  // namespace

// bf16 x (M, K) and out, int8 wq (L, K, N), fp32 scale (L, N), all contiguous;
// N a multiple of 8 and wq 8-byte aligned. grid_layers = L: every layer, out
// (L, M, N). grid_layers = 1: one layer, out (M, N); the layer is *idx (a
// device int32, clamped to [0, L)) or 0 when idx is null. Where TMA can read
// the operands (N a multiple of 16, K of 8, x and wq 16-byte aligned) the
// tensor-core kernel runs, with 8, 32 or 64 rows of x a block; else the
// streaming kernel.
extern "C" int st_w8_matmul(const void* x, const void* wq, const float* scale, const int* idx,
                            void* out, int M, int K, int N, int L, int grid_layers, void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || (N & 7) || L <= 0 || (grid_layers != 1 && grid_layers != L) ||
      (grid_layers != 1 && idx))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool tma_ok = !(N & 15) && !(K & 7) && (long long)L * K <= 0x7fffffffLL &&  // TMA's row coordinate is an int32
                      !((reinterpret_cast<size_t>(x) | reinterpret_cast<size_t>(wq)) & 15) &&
                      !(reinterpret_cast<size_t>(out) & 7);
  if (tma_ok) {
    if (M <= 8) return launch_wgmma<8>(x, wq, scale, idx, out, M, K, N, L, grid_layers, s);
    if (M <= 32) return launch_wgmma<32>(x, wq, scale, idx, out, M, K, N, L, grid_layers, s);
    return launch_wgmma<64>(x, wq, scale, idx, out, M, K, N, L, grid_layers, s);
  }
  return launch_stream(x, wq, scale, idx, out, M, K, N, L, grid_layers, s);
}

extern "C" const char* st_w8_error(int e) { return cudaGetErrorString(static_cast<cudaError_t>(e)); }
