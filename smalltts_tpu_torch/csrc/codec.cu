// The codec decoder's pointwise work between two of its cuDNN convolutions
// (models/codec.py, the card's decode path). It replaces no Pallas kernel:
// the JAX package leaves the codec to XLA, which fuses these ops into the
// convolutions' neighbours. It was added because the port's decoder spent
// about as much device time in PyTorch's elementwise ops around its 27 fp32
// convolutions as in the convolutions themselves.
//
// One launch reads a convolution's raw NCW output y (B, C*r, T) and gives,
// for each element, the value of the op chain it replaces:
//   v = y + bias[ch]                       the convolution's bias
//   v = x + v        (mode 1)              the residual, x the unit's input
//   v = tanh(v)      (mode 2)              the head
// placed at (b, c, t*r + j) for v[b, j*C + c, t] (depth to time; r = 1:
// none). It writes v to `plain` (B, C, T*r) where a later residual or the
// caller reads it, and snake(v) with the next convolution's alpha (C,) into
// that convolution's input `snake` (B, C, lo + T*r + hi), borders zero: the
// next convolution then runs unpadded on the shape F.pad gives it.
//
// Bits: each op rounds once where the PyTorch op chain rounds, in
// bhaskara_snake's order (ops/kernels/codec.py), with the _rn intrinsics
// (nvcc never contracts them into FMAs), floorf, IEEE division, and tanhf
// as PyTorch's tanh calls it. The pass equals the op chain bit for bit; the
// tests hold it so.
//
// Bound: bytes. y (and x) are read once, one or two outputs written once:
// 8-16 bytes an element against about 120-300 for the op chain's passes.
// The design keeps every device access a 16-byte, coalesced one:
//   - a block owns a chunk of the output: a tile of one row's time steps,
//     or several whole rows where rows are short, 256-4096 outputs sized so
//     that the grid holds about four blocks an SM or more (4096 outputs a
//     block ran 3-10% faster than 2048 at the served shapes; limiting the
//     registers to raise the blocks an SM spilled and ran slower);
//   - x's chunk is loaded into registers first, with 16-byte loads, in
//     flight together with y's;
//   - y's r input row segments (one per j) are read with 16-byte loads,
//     up to four in flight a thread, into shared memory in output order
//     (the depth-to-time transpose happens there). The shared index takes
//     one word of padding every 32 so that the transposed stores (stride r)
//     and the 4-float strides of the vector phases hit distinct banks;
//   - the values are computed in place in shared memory, `plain` written
//     with 16-byte stores at x's offsets;
//   - the snake buffer is written from shared memory with 16-byte stores
//     aligned to the buffer (its rows start at odd offsets), the borders
//     in the same stores: no memset;
//   - per-row scalars (bias, alpha) are staged once a block;
//   - ranges whose ends are not 16-byte aligned take single floats at the
//     ends (odd T, C or borders).

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "sm90_common.cuh"

namespace {

constexpr int PW_THREADS = 256;
constexpr int PW_MIN = 256, PW_MAX = 4096;  // outputs a block
constexpr int PW_UNITS = PW_MAX / (4 * PW_THREADS);  // 16-byte units of x a thread at most
constexpr float INV_PI = static_cast<float>(1.0 / 3.14159265358979323846);

// n / d for 0 <= n < 2^31 by a multiply-high and a shift; the magic number
// made on the host (the method of PyTorch's IntDivider)
struct FastDiv {
  unsigned d, m, s;
};

FastDiv make_div(unsigned d) {
  FastDiv q{d, 0u, 0u};
  while (q.s < 31 && (1u << q.s) < d) ++q.s;
  q.m = static_cast<unsigned>(((uint64_t(1) << 32) * ((uint64_t(1) << q.s) - d)) / d + 1);
  return q;
}

__device__ __forceinline__ int fdiv(const FastDiv& q, int n) {
  const unsigned u = static_cast<unsigned>(n);
  return static_cast<int>((__umulhi(u, q.m) + u) >> q.s);
}

struct PwArgs {
  const float* y;
  const float* bias;
  const float* x;
  const float* a;
  float* plain;
  float* snake;
  int C, T, r, lo, hi, mode;
  int rows, tile, tiles, groups;  // the chunking: see st_codec_pointwise
  FastDiv by_T, by_Tout, by_L;
};

// x + sin^2(a x)/a, Bhaskara's |sin|, in bhaskara_snake's order
__device__ __forceinline__ float snake_rn(float x, float a) {
  const float y = __fmul_rn(__fmul_rn(a, x), INV_PI);
  const float f = __fsub_rn(y, floorf(y));
  const float g = __fmul_rn(f, __fsub_rn(1.0f, f));
  const float s = __fdiv_rn(__fmul_rn(16.0f, g), __fsub_rn(5.0f, __fmul_rn(4.0f, g)));
  return __fadd_rn(x, __fdiv_rn(__fmul_rn(s, s), a));
}

// one padding word every 32: conflict-free strided shared accesses
__device__ __forceinline__ int sidx(int e) { return e + (e >> 5); }

// floats of a range of n at p before its first 16-byte boundary
__device__ __forceinline__ int head_of(const void* p, int n) {
  const int h = static_cast<int>(((16u - (reinterpret_cast<uintptr_t>(p) & 15u)) & 15u) >> 2);
  return h < n ? h : n;
}

// f(s, i, value) for i < n of each range p0 + s * stride, s < nseg: 16-byte
// loads between the boundaries, up to four in flight a thread; single floats
// at the ends. Ranges whose stride is a multiple of 4 floats share one
// alignment and are read as one sequence of vectors.
template <class F>
__device__ __forceinline__ void read_ranges(const float* __restrict__ p0, long long stride, int nseg, int n, F f) {
  const int per = (stride & 3) ? 1 : nseg;
  for (int s0 = 0; s0 < nseg; s0 += per) {
    const float* p = p0 + s0 * stride;
    const int h = head_of(p, n), nv = (n - h) >> 2, ends = n - 4 * nv;
    const int units = per * nv;
    for (int u0 = threadIdx.x; u0 < units; u0 += 4 * PW_THREADS) {
      float4 q[4];
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const int u = u0 + m * PW_THREADS;
        if (u < units) {
          const int s = u / nv;
          q[m] = __ldcs(reinterpret_cast<const float4*>(p + s * stride + h) + (u - s * nv));
        }
      }
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const int u = u0 + m * PW_THREADS;
        if (u < units) {
          const int s = u / nv, i = h + 4 * (u - s * nv);
          f(s0 + s, i, q[m].x);
          f(s0 + s, i + 1, q[m].y);
          f(s0 + s, i + 2, q[m].z);
          f(s0 + s, i + 3, q[m].w);
        }
      }
    }
    for (int u = threadIdx.x; u < per * ends; u += PW_THREADS) {
      const int s = u / ends, k = u - s * ends, i = k < h ? k : k + 4 * nv;
      f(s0 + s, i, __ldcs(p + s * stride + i));
    }
  }
}

// p[i] = g(i) for i < n: 16-byte stores between the boundaries
template <class G>
__device__ __forceinline__ void write_range(float* __restrict__ p, int n, G g) {
  const int h = head_of(p, n), nv = (n - h) >> 2, ends = n - 4 * nv;
  for (int k = threadIdx.x; k < nv; k += PW_THREADS) {
    const int i = h + 4 * k;
    reinterpret_cast<float4*>(p + h)[k] = make_float4(g(i), g(i + 1), g(i + 2), g(i + 3));
  }
  for (int k = threadIdx.x; k < ends; k += PW_THREADS) {
    const int i = k < h ? k : k + 4 * nv;
    p[i] = g(i);
  }
}

__global__ void __launch_bounds__(PW_THREADS) codec_pointwise_kernel(const PwArgs p) {
  extern __shared__ float smem[];
  const int C = p.C, T = p.T, r = p.r, Tout = T * r, L = p.lo + Tout + p.hi;
  int b, c0, nr, t0, tt;
  if (p.tiles == 1) {  // whole rows, up to p.rows of one batch row
    b = blockIdx.x / p.groups;
    c0 = (blockIdx.x - b * p.groups) * p.rows;
    nr = min(p.rows, C - c0);
    t0 = 0;
    tt = T;
  } else {  // one tile of one row
    const int row = blockIdx.x / p.tiles, k = blockIdx.x - row * p.tiles;
    b = row / C;
    c0 = row - b * C;
    nr = 1;
    t0 = k * p.tile;
    tt = min(p.tile, T - t0);
  }
  const int span = tt * r;  // outputs of a row in this chunk (Tout where nr > 1)
  const int n = nr * span;
  float* s_v = smem;                                    // the values, then their snake, sidx-padded
  float* s_b = smem + sidx(p.rows * p.tile * r) + 1;    // bias by (row, j)
  float* s_a = s_b + p.rows * r;                        // alpha by row

  // the chunk's range of x and plain (the same offsets): x's vectors are
  // loaded first, in flight with y's below; 16-byte accesses where x and
  // plain share an alignment
  const long long o0 = (static_cast<long long>(b) * C + c0) * Tout + static_cast<long long>(t0) * r;
  const float* __restrict__ x = p.mode == 1 ? p.x + o0 : nullptr;
  float* __restrict__ out = p.plain ? p.plain + o0 : nullptr;
  const void* ref = out ? static_cast<const void*>(out) : static_cast<const void*>(x);
  int h = ref ? head_of(ref, n) : n;
  if (x && out && ((reinterpret_cast<uintptr_t>(x) ^ reinterpret_cast<uintptr_t>(out)) & 15u)) h = n;
  const int nv = (n - h) >> 2, ends = n - 4 * nv;
  float4 xq[PW_UNITS];
#pragma unroll
  for (int m = 0; m < PW_UNITS; ++m) {
    const int k = threadIdx.x + m * PW_THREADS;
    xq[m] = (x && k < nv) ? __ldcs(reinterpret_cast<const float4*>(x + h) + k) : make_float4(0.f, 0.f, 0.f, 0.f);
  }

  for (int k = threadIdx.x; k < nr * r; k += PW_THREADS) {
    const int rl = k / r, j = k - rl * r;
    s_b[k] = p.bias[j * C + c0 + rl];
  }
  if (p.snake)
    for (int k = threadIdx.x; k < nr; k += PW_THREADS) s_a[k] = p.a[c0 + k];
  __syncthreads();

  // y's r row segments (channels j*C + c0 .. + nr, steps t0 .. t0 + tt): contiguous, since nr == 1 or tt == T
  const long long in_row = static_cast<long long>(C) * T;  // from one j to the next
  read_ranges(p.y + (static_cast<long long>(b) * C * r + c0) * T + t0, in_row, r, nr * tt,
              [&](int j, int i, float v) {
                const int rl = nr == 1 ? 0 : fdiv(p.by_T, i);
                s_v[sidx(rl * span + (i - rl * T) * r + j)] = __fadd_rn(v, s_b[rl * r + j]);
              });
  __syncthreads();

  // the values in place: residual, tanh; plain out; their snake back into s_v
  auto value = [&](int i, float xv) {
    float v = s_v[sidx(i)];
    if (p.mode == 1)
      v = __fadd_rn(xv, v);
    else if (p.mode == 2)
      v = tanhf(v);
    if (p.snake) s_v[sidx(i)] = snake_rn(v, s_a[nr == 1 ? 0 : fdiv(p.by_Tout, i)]);
    return v;
  };
#pragma unroll
  for (int m = 0; m < PW_UNITS; ++m) {
    const int k = threadIdx.x + m * PW_THREADS;
    if (k < nv) {
      const int i = h + 4 * k;
      const float4 o = make_float4(value(i, xq[m].x), value(i + 1, xq[m].y), value(i + 2, xq[m].z),
                                   value(i + 3, xq[m].w));
      if (out) reinterpret_cast<float4*>(out + h)[k] = o;
    }
  }
  for (int k = threadIdx.x; k < ends; k += PW_THREADS) {
    const int i = k < h ? k : k + 4 * nv;
    const float o = value(i, x ? __ldcs(x + i) : 0.f);
    if (out) out[i] = o;
  }

  if (p.snake) {
    __syncthreads();
    // the buffer's range of this chunk: from the row's start (first tile) to its end (last tile)
    const int q0 = t0 == 0 ? 0 : p.lo + t0 * r;
    const int q1 = t0 + tt == T ? L : p.lo + (t0 + tt) * r;
    const int shift = p.lo + t0 * r;
    write_range(p.snake + (static_cast<long long>(b) * C + c0) * L + q0, (nr - 1) * L + q1 - q0, [&](int i) {
      const int g = i + q0;
      const int rl = nr == 1 ? 0 : fdiv(p.by_L, g);
      const int o = g - rl * L - shift;
      return (o >= 0 && o < span) ? s_v[sidx(rl * span + o)] : 0.0f;
    });
  }
}

}  // namespace

// y (B, C*r, T), bias (C*r,), x (B, C, T*r) for mode 1 else null, a (C,)
// where snake is given; plain (B, C, T*r) or null, snake (B, C, lo + T*r +
// hi) or null. All float32, contiguous.
extern "C" int st_codec_pointwise(const float* y, const float* bias, const float* x, const float* a, float* plain,
                                  float* snake, int B, int C, int T, int r, int lo, int hi, int mode, void* stream) {
  if (B <= 0 || C <= 0 || T <= 0 || r <= 0 || lo < 0 || hi < 0 || mode < 0 || mode > 2 ||
      (mode == 1) != (x != nullptr) || (!plain && !snake) || (snake && !a))
    return (int)cudaErrorInvalidValue;
  const long long Tout = static_cast<long long>(T) * r;
  if (Tout + lo + hi > (1LL << 30) || static_cast<long long>(C) * r > (1LL << 30))
    return (int)cudaErrorInvalidValue;
  const long long total = static_cast<long long>(B) * C * Tout;
  const int target = static_cast<int>(std::max<long long>(PW_MIN, std::min<long long>(PW_MAX, total / (4LL * sm_count()))));
  int rows, tile, tiles;
  if (Tout <= target) {
    rows = static_cast<int>(std::min<long long>(C, target / Tout));
    tile = T;
    tiles = 1;
  } else {
    rows = 1;
    tile = std::max(4, (target / r) & ~3);
    if (tile >= T) tile = T;
    tiles = (T + tile - 1) / tile;
  }
  const int groups = (C + rows - 1) / rows;
  const long long blocks = tiles == 1 ? static_cast<long long>(B) * groups : static_cast<long long>(B) * C * tiles;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int cap = rows * tile * r;
  if (cap > PW_MAX) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (static_cast<size_t>(cap + (cap >> 5) + 1) + static_cast<size_t>(rows) * r + rows);
  PwArgs p{y, bias, x, a, plain, snake, C, T, r, lo, hi, mode, rows, tile, tiles, groups,
           make_div(static_cast<unsigned>(T)), make_div(static_cast<unsigned>(Tout)),
           make_div(static_cast<unsigned>(Tout + lo + hi))};
  codec_pointwise_kernel<<<static_cast<unsigned>(blocks), PW_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

extern "C" const char* st_codec_error(int e) { return cudaGetErrorString(static_cast<cudaError_t>(e)); }
