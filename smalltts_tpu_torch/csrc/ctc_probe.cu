// Timing-only build of ctc.cu: the package never loads it. chip_smoke.py
// builds it beside the kernels (nvcc with the package's flags) to time the
// backward's two kinds of blocks apart and to measure the chain floors:
//
//   st_ctc_backward_phases: st_ctc_backward with `phases` 3 (the whole
//     kernel), 1 (its factor blocks alone) or 2 (its chains alone, over a
//     `fac` that an earlier call filled);
//   st_ctc_floor: ns a frame of ctc_floor_kernel.

#define CTC_PROBE
#include "ctc.cu"

namespace {

__device__ __forceinline__ uint64_t globaltimer() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// what a frame of each chain cannot go below: `frames` steps, each one
// exchange through shared memory (a store, a barrier, the neighbour's load)
// and the frame's dependent operations, one state a thread in one block of
// the kernel's threads. mode 0, the forward's: two lae deep; mode 1, the
// backward's adjoint: two adds, a product, an add, a product. Writes ns a
// step.
__global__ void ctc_floor_kernel(float* out_ns, float* sink, int frames, int mode) {
  __shared__ float x[2][1025];
  const int tid = threadIdx.x, bd = blockDim.x;
  float v = 1e-3f * tid;
  x[0][tid] = v;
  x[1][tid] = v;
  if (tid == 0) x[0][bd] = x[1][bd] = 0.f;
  __syncthreads();
  const uint64_t t0 = globaltimer();
  int cur = 0;
  for (int f = 0; f < frames; ++f) {
    const float nb = x[cur][tid + 1];
    if (mode == 0) {
      const float pin = lae(v, nb - 1.f);
      v = lae(pin - 0.5f, v - 0.25f);
    } else {
      const float ge = __fadd_rn(__fadd_rn(v, nb), nb);
      const float dpin = __fadd_rn(__fmul_rn(ge, 0.499f), 1.f);
      v = __fmul_rn(dpin, 0.499f);
    }
    x[cur ^ 1][tid] = v;
    __syncthreads();
    cur ^= 1;
  }
  const uint64_t t1 = globaltimer();
  sink[tid] = v;
  if (tid == 0) *out_ns = (float)(t1 - t0) / (float)max(frames, 1);
}

}  // namespace

extern "C" int st_ctc_backward_phases(const float* g, const float* lp_emit, const float* lp_phi, const float* pad,
                                      const float* repeat, const int* labellens, const float* alpha, float* fac,
                                      int* sync, float* d_emit, float* d_phi, int B, int T, int N, int per,
                                      int phases, void* stream) {
  return (int)backward(g, lp_emit, lp_phi, pad, repeat, labellens, alpha, fac, sync, d_emit, d_phi, B, T, N, per,
                       phases, static_cast<cudaStream_t>(stream));
}

// ns a frame into out_ns[0]; sink takes `threads` floats
extern "C" int st_ctc_floor(float* out_ns, float* sink, int threads, int frames, int mode, void* stream) {
  if (threads < 32 || threads > 1024 || threads % 32 || frames < 1 || mode < 0 || mode > 1)
    return (int)cudaErrorInvalidValue;
  ctc_floor_kernel<<<1, threads, 0, static_cast<cudaStream_t>(stream)>>>(out_ns, sink, frames, mode);
  return (int)cudaGetLastError();
}
