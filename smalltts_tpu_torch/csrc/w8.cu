// int8-weight products for Hopper (sm_90a): port of the three Pallas TPU
// kernels of smalltts_tpu/ops/pallas/w8.py (w8_matmul, w8_matmul_stacked,
// w8_matmul_all_layers), all served by the one kernel below.
//
//   out[l, m, n] = bf16( sum_k float(x[m, k]) * float(q[l', k, n]) * scale[l', n] )
//
// x is (M, K) bf16, q (L, K, N) int8, scale (L, N) fp32; the sum is fp32 and
// the scale multiplies the fp32 sum before the one rounding, the order of
// _w8_kernel (w8.py:72-76). The layer l' is blockIdx.y (all layers, out has
// L slabs), or is read by every block from a device int32 (stacked: the host
// never reads the index, so the launch makes no synchronizing call), or 0.
// An index out of [0, L) is clamped, as the plain version clamps it.
//
// What bounds it on the H100: at the main path's shape (M = 4 step
// embeddings, K 960, N 5760, L 12) it is pure weight streaming: 66.4 MB of
// int8 and 0.28 MB of scales, 20 us at 3.35 TB/s, against 2 * 4 * 66.4 M =
// 0.53 GFLOP. So the design is about bytes:
//   - the int8 tile goes from device memory straight into registers, 8 bytes
//     (8 columns) a thread, a warp covering two 128-byte rows; it is converted
//     there and never written back as bf16 (the point of the TPU kernel,
//     w8.py:6-10);
//   - a block owns 128 columns of one layer and MT rows of x, so the main
//     shape runs 45 x 12 = 540 blocks, about 4 per SM, each with 4 loads in
//     flight per thread;
//   - x is staged in shared memory transposed, [K][MT] bf16, so one 16-byte
//     (MT 8) or 8-byte (MT 4) shared load gives a k's value for every row;
//   - the products run on the CUDA cores in fp32 (M <= 8 per block: 64 FMAs
//     per 8 weight bytes at MT 8, far under the FMA rate at this byte rate).
//     Larger M runs more row blocks over the same weight tile, which then
//     comes from L2; a tensor-core path for large M is later work.
// The 16 k-row groups of a block are reduced at the end: pairs by a warp
// shuffle, then the 8 warps through shared memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int W8_WARPS = 8;
constexpr int W8_THREADS = 32 * W8_WARPS;
constexpr int W8_BN = 128;               // columns per block: 16 lanes x 8 columns
constexpr int W8_KR = W8_THREADS / 16;   // k rows in flight per block step (16)
constexpr int W8_UNROLL = 4;             // weight loads in flight per thread

__device__ __forceinline__ float bf16_lo(uint32_t v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t v) { return __uint_as_float(v & 0xffff0000u); }
__device__ __forceinline__ float s8(uint32_t v, int j) {
  return static_cast<float>(static_cast<int8_t>((v >> (8 * j)) & 0xffu));
}

// the MT x values of one k, from the [K][MT] bf16 staging tile
template <int MT>
__device__ __forceinline__ void load_x(const __nv_bfloat16* xs, int k, float (&xv)[MT]) {
  if constexpr (MT == 8) {
    const uint4 v = *reinterpret_cast<const uint4*>(xs + k * 8);
    xv[0] = bf16_lo(v.x); xv[1] = bf16_hi(v.x); xv[2] = bf16_lo(v.y); xv[3] = bf16_hi(v.y);
    xv[4] = bf16_lo(v.z); xv[5] = bf16_hi(v.z); xv[6] = bf16_lo(v.w); xv[7] = bf16_hi(v.w);
  } else {
    const uint2 v = *reinterpret_cast<const uint2*>(xs + k * 4);
    xv[0] = bf16_lo(v.x); xv[1] = bf16_hi(v.x); xv[2] = bf16_lo(v.y); xv[3] = bf16_hi(v.y);
  }
}

template <int MT>
__global__ void __launch_bounds__(W8_THREADS) w8_kernel(const __nv_bfloat16* __restrict__ x,
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
      load_x<MT>(xs, k, xv);
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

template <int MT>
int launch(const void* x, const void* wq, const float* scale, const int* idx, void* out, int M, int K,
           int N, int L, int grid_layers, cudaStream_t s) {
  const size_t stage = (size_t)K * MT * sizeof(__nv_bfloat16);
  const size_t reduce = (size_t)W8_WARPS * MT * W8_BN * sizeof(float);
  const size_t bytes = stage > reduce ? stage : reduce;
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(w8_kernel<MT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               (int)bytes);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((N + W8_BN - 1) / W8_BN, grid_layers, (M + MT - 1) / MT);
  w8_kernel<MT><<<grid, W8_THREADS, bytes, s>>>(static_cast<const __nv_bfloat16*>(x),
                                                static_cast<const int8_t*>(wq), scale, idx,
                                                static_cast<__nv_bfloat16*>(out), M, K, N, L);
  return (int)cudaGetLastError();
}

}  // namespace

// bf16 x (M, K) and out, int8 wq (L, K, N), fp32 scale (L, N), all contiguous;
// N a multiple of 8 and wq 8-byte aligned. grid_layers = L: every layer, out
// (L, M, N). grid_layers = 1: one layer, out (M, N); the layer is *idx (a
// device int32, clamped to [0, L)) or 0 when idx is null.
extern "C" int st_w8_matmul(const void* x, const void* wq, const float* scale, const int* idx,
                            void* out, int M, int K, int N, int L, int grid_layers, void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || (N & 7) || L <= 0 || (grid_layers != 1 && grid_layers != L) ||
      (grid_layers != 1 && idx))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M <= 4) return launch<4>(x, wq, scale, idx, out, M, K, N, L, grid_layers, s);
  return launch<8>(x, wq, scale, idx, out, M, K, N, L, grid_layers, s);
}

extern "C" const char* st_w8_error(int e) { return cudaGetErrorString(static_cast<cudaError_t>(e)); }
