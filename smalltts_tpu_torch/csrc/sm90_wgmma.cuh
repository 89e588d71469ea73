// What the wgmma + TMA kernels of dit_block.cu and w8.cu share: the 2-D TMA
// load (completing on the mbarriers of sm90_common.cuh) and its tensor maps
// (encoded on the host, a weight's cached), the shared-memory descriptor of a
// 128-byte-swizzled tile, the wgmma fence / commit / wait, and a
// distributed-shared-memory load.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums; the encoder is reached through the runtime
#include <cuda_runtime.h>
#include <stdint.h>

#include <map>
#include <mutex>
#include <tuple>

#include "sm90_common.cuh"

namespace {

// wgmma descriptor of a shared-memory tile in the 128-byte swizzle (layout type 1).
// K-major (rows of 64 bf16 along k): sbo = 1024 (8 rows of 128 bytes), lbo unused.
// MN-major: sbo = 1024 (8 k rows), lbo = the distance between 64-column sub-tiles.
__device__ __forceinline__ uint64_t sw128_desc(const void* p, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) | static_cast<uint64_t>(lbo >> 4) << 16 |
         static_cast<uint64_t>(sbo >> 4) << 32 | 1ull << 62;
}

// the box of `map` at (c0 = column, c1 = row) into shared memory; its bytes complete on `bar`
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, int c0, int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3}], [%4];\n" ::
          "r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving the accumulators across an asynchronous wgmma
template <int N>
__device__ __forceinline__ void fence_regs(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// the 4 floats at `p` in the shared memory of cluster rank `rank`. No memory
// clobber: the cluster barriers order these loads, and without one a run of
// them goes out back to back instead of one round trip at a time.
__device__ __forceinline__ float4 ld_cluster4(const float4* p, uint32_t rank) {
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(cluster_addr(p, rank)));
  return v;
}

// stores 4 floats at `p`, a location of this block's shared memory, in the
// shared memory of cluster rank `rank`; a cluster barrier makes them visible
__device__ __forceinline__ void st_cluster4(float4* p, uint32_t rank, float4 v) {
  asm volatile("st.shared::cluster.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"r"(cluster_addr(p, rank)), "f"(v.x), "f"(v.y),
               "f"(v.z), "f"(v.w)
               : "memory");
}

// ------------------------------------------------------------------ host side

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the runtime's entry-point query (no -lcuda)
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q{};
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return e == cudaSuccess && q == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(p) : nullptr;
  }();
  return fn;
}

// what a tensor map is made from: a row-major (rows, cols) matrix of bf16 or
// int8 at row stride ld elements, read in boxes of box_rows x box_cols,
// landing in the 128-byte swizzle or unswizzled; past the edges TMA fills zeros
struct MapSpec {
  const void* base;
  bool int8;
  long long rows, cols, ld;
  int box_cols, box_rows;
  bool swizzle128;
  auto key() const { return std::make_tuple(base, int8, rows, cols, ld, box_cols, box_rows, swizzle128); }
};

bool encode_map(CUtensorMap* map, const MapSpec& m) {
  const EncodeTiled enc = encode_tiled();
  if (!enc) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(m.cols), static_cast<cuuint64_t>(m.rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(m.ld * (m.int8 ? 1 : 2))};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(m.box_cols), static_cast<cuuint32_t>(m.box_rows)};
  const cuuint32_t estr[2] = {1, 1};
  return enc(map, m.int8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
             const_cast<void*>(m.base), dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
             m.swizzle128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// a weight's map, encoded once: the key is everything the map holds, so a
// reused address with the same shape finds the same map
bool weight_map(CUtensorMap* map, const MapSpec& m) {
  static std::mutex mu;
  static std::map<decltype(m.key()), CUtensorMap> cache;
  std::lock_guard<std::mutex> lock(mu);
  const auto it = cache.find(m.key());
  if (it != cache.end()) {
    *map = it->second;
    return true;
  }
  if (!encode_map(map, m)) return false;
  if (cache.size() >= 4096) cache.clear();
  cache.emplace(m.key(), *map);
  return true;
}

}  // namespace
