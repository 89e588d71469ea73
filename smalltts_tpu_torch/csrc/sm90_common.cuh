// Device and host helpers shared by the Hopper kernels of attention.cu,
// dit_block.cu, w8.cu (the last two through sm90_wgmma.cuh) and ctc.cu:
// shared-memory addresses, the thread-block cluster barrier and distributed
// shared memory addressing, mbarriers, and the card's SM count.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// the 32-bit shared-memory address of a generic pointer into shared memory
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// every thread of every block of the cluster arrives and waits; the shared
// memory each wrote before is visible to the others after
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\nbarrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// the two halves of a cluster barrier that orders no memory: a block that
// arrives when it starts and waits just before its first access to another
// block's shared memory knows that every block of the cluster has started,
// which such an access requires. Every thread executes both.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// the address of `p`, a location in this block's shared memory, in the
// shared memory of cluster rank `rank`
__device__ __forceinline__ uint32_t cluster_addr(const void* p, uint32_t rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(remote) : "r"(smem_u32(p)), "r"(rank));
  return remote;
}

// mbarriers in shared memory: init (arrival count), an arrival that also
// expects `bytes` of asynchronous copies, a plain arrival, and the wait for
// a phase of the given parity
__device__ __forceinline__ void mbar_init(uint64_t* b, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(b)), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* b, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(b)), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* b) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(b)) : "memory");
}
// wait until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* b, int parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\nselp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(b)), "r"(parity)
        : "memory");
  } while (!done);
}
// SMs of the current device (132 on an H100 SXM), read once
int sm_count() {
  static const int n = [] {
    int dev = 0, v = 132;
    if (cudaGetDevice(&dev) != cudaSuccess || cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      v = 132;
    return v;
  }();
  return n;
}

}  // namespace
