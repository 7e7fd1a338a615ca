// Input-moment reduction (paper Eqs. 8-9), written by hand for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel act_stats_p
// (src/repro/kernels/act_stats.py:33, pallas_call at :49).
//
// Per row of x, f32 or bf16:  s1 = sum_k x,  s2 = sum_k x^2, in f32.
//
// Rows are addressed in two levels, row r at (r / inner) * outer_stride +
// (r % inner) * inner_stride elements, with the K elements of a row
// contiguous.  A plain (M, K) matrix is one outer entry; the sampling
// stride gamma of the ops layer (x[..., ::gamma, :] of a (B, T, K) tensor)
// is read where it lies, without a copy.
//
// Bound on the H100: bytes.  The kernel reads x once and writes 8 bytes a
// row; it does 3 flops an element, far below the card's ratio of compute to
// bandwidth.  So what matters is that a row's bytes are in flight at once
// and that nothing stands between the launch and the first load.
//
// Design: one block a row.  The row's units (16-byte vectors when the
// base, K and both strides allow it, else single elements) are spread over
// the block's threads, C units a thread (unit i of thread t at t + i *
// threads), all C loads issued before the first add; rows longer than
// threads * C units loop.  The wrapper (kernels/act_stats.py, `plan`)
// sizes the block and C to the row, about two units a thread, so a row of
// 2048 f32 is one round trip of 256 threads.  A plain matrix needs no
// division to find its row, a strided one a multiply by a constant the
// host computes.  Each thread sums its units in order, a fixed butterfly
// ends each warp, and the first warp adds the warps' sums with another, so
// two launches on the same input give the same bits.  s2 adds the rounded
// square (no fused multiply-add), as the plain version does.  An input
// larger than the L2 is read with evict-first loads (`stream`): it cannot
// stay resident, so it should not push out the lines around it.  The
// ragged end of K is masked; nothing is padded.  The route, the block, C
// and the loads are the wrapper's; this file makes no choice.
//
// A persistent grid with one warp a row, and persistent teams of 2-4 warps
// a row, were built and measured too (PERF.md §6): each was slower than
// the first design at some shape, and they are not kept.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_THREADS = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

struct Sums {
  float s1, s2;
};

__device__ __forceinline__ void add(Sums& s, float v) {
  s.s1 += v;
  s.s2 = __fadd_rn(s.s2, __fmul_rn(v, v));
}

// butterfly over aligned groups of `width` lanes (a power of two <= 32)
__device__ __forceinline__ Sums lane_reduce(Sums s, int width) {
  for (int off = width >> 1; off > 0; off >>= 1) {
    s.s1 += __shfl_xor_sync(0xffffffffu, s.s1, off);
    s.s2 += __shfl_xor_sync(0xffffffffu, s.s2, off);
  }
  return s;
}

// One unit of a row: a single element, or (VECTOR) a 16-byte vector of 4
// f32 or 8 bf16, loaded evict-first where STREAM.
template <typename T, bool VECTOR, bool STREAM>
struct Unit {
  using Raw = T;
  __device__ static Raw load(const T* row, int u) { return row[u]; }
  __device__ static void add_all(Sums& s, Raw r) { add(s, to_f32(r)); }
};
template <bool STREAM>
struct Unit<float, true, STREAM> {
  using Raw = float4;
  static constexpr int N = 4;
  __device__ static Raw load(const float* row, int u) {
    const float4* p = reinterpret_cast<const float4*>(row) + u;
    return STREAM ? __ldcs(p) : *p;
  }
  __device__ static void add_all(Sums& s, Raw v) {
    add(s, v.x);
    add(s, v.y);
    add(s, v.z);
    add(s, v.w);
  }
};
template <bool STREAM>
struct Unit<__nv_bfloat16, true, STREAM> {
  using Raw = uint4;
  static constexpr int N = 8;
  __device__ static Raw load(const __nv_bfloat16* row, int u) {
    const uint4* p = reinterpret_cast<const uint4*>(row) + u;
    return STREAM ? __ldcs(p) : *p;
  }
  __device__ static void add_all(Sums& s, Raw v) {
    const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&v);
#pragma unroll
    for (int i = 0; i < 8; ++i) add(s, __bfloat162float(h[i]));
  }
};

// row / inner is (row * magic) >> shift for every row < 2^31 (the grid's
// limit): magic = ceil(2^shift / inner), shift = 31 + ceil(log2 inner),
// exact as row * (magic * inner - 2^shift) < 2^shift.  One multiply on the
// way to the first load instead of a division.
struct Rows {
  long long rows, inner, outer_stride, inner_stride;
  unsigned long long magic;
  int shift, units;
};

Rows make_rows(long long rows, long long inner, long long outer_stride,
               long long inner_stride) {
  int shift = 31;
  while ((1LL << (shift - 31)) < inner) ++shift;
  const unsigned long long p = 1ULL << shift;
  const unsigned long long d = static_cast<unsigned long long>(inner);
  return Rows{rows, inner, outer_stride, inner_stride, (p + d - 1) / d, shift, 0};
}

// element offset of a row; a plain matrix (one outer entry) multiplies
// nothing but the row
__device__ __forceinline__ long long row_offset(const Rows& g, long long row) {
  if (g.inner >= g.rows) return row * g.inner_stride;
  const unsigned long long r = static_cast<unsigned long long>(row);
  const long long o = static_cast<long long>((r * g.magic) >> g.shift);
  return o * g.outer_stride + (row - o * g.inner) * g.inner_stride;
}

template <typename T, bool VECTOR, bool STREAM, int C>
__global__ void __launch_bounds__(MAX_THREADS)
act_stats_kernel(const T* __restrict__ x, float* __restrict__ s1, float* __restrict__ s2,
                 Rows g) {
  using U = Unit<T, VECTOR, STREAM>;
  __shared__ Sums part[MAX_THREADS / 32];
  const long long row = blockIdx.x;
  const T* xr = x + row_offset(g, row);
  const int step = blockDim.x;
  Sums s{0.f, 0.f};
  for (int u0 = threadIdx.x; u0 < g.units; u0 += step * C) {
    typename U::Raw r[C];
#pragma unroll
    for (int i = 0; i < C; ++i) {
      if (u0 + i * step < g.units) r[i] = U::load(xr, u0 + i * step);
    }
#pragma unroll
    for (int i = 0; i < C; ++i) {
      if (u0 + i * step < g.units) U::add_all(s, r[i]);
    }
  }
  s = lane_reduce(s, 32);
  const int lane = threadIdx.x & 31;
  if (lane == 0) part[threadIdx.x >> 5] = s;
  __syncthreads();
  if (threadIdx.x < 32) {
    const int warps = blockDim.x >> 5;
    s = lane < warps ? part[lane] : Sums{0.f, 0.f};
    s = lane_reduce(s, warps);
    if (lane == 0) {
      s1[row] = s.s1;
      s2[row] = s.s2;
    }
  }
}

template <typename T, bool VECTOR, bool STREAM>
void launch_chunk(const T* x, float* s1, float* s2, const Rows& g, int chunk, int threads,
                  cudaStream_t st) {
  const unsigned grid = static_cast<unsigned>(g.rows);
#define ACT_STATS_LAUNCH(C) \
  act_stats_kernel<T, VECTOR, STREAM, C><<<grid, threads, 0, st>>>(x, s1, s2, g)
  switch (chunk) {
    case 1: ACT_STATS_LAUNCH(1); break;
    case 2: ACT_STATS_LAUNCH(2); break;
    case 4: ACT_STATS_LAUNCH(4); break;
    default: ACT_STATS_LAUNCH(8);
  }
#undef ACT_STATS_LAUNCH
}

template <typename T>
int launch(const void* x, float* s1, float* s2, Rows g, int K, bool vector, bool stream,
           int threads, int chunk, cudaStream_t st) {
  constexpr int V = Unit<T, true, false>::N;
  if (vector && (reinterpret_cast<uintptr_t>(x) % 16 != 0 || K % V != 0 ||
                 g.outer_stride % V != 0 || g.inner_stride % V != 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  g.units = vector ? K / V : K;
  const T* xt = static_cast<const T*>(x);
  if (vector && stream) launch_chunk<T, true, true>(xt, s1, s2, g, chunk, threads, st);
  else if (vector) launch_chunk<T, true, false>(xt, s1, s2, g, chunk, threads, st);
  else launch_chunk<T, false, false>(xt, s1, s2, g, chunk, threads, st);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  rows = outer * inner (one block
// each, at most 2^31 - 1); strides in elements.  The route is the
// caller's: vector (16-byte units) or not, stream (evict-first loads,
// vector only), `threads` a block (32, 64, 128 or 256) and `chunk` units a
// thread in flight (1, 2, 4 or 8).
extern "C" int act_stats(const void* x, int dtype, void* s1, void* s2, long long rows,
                         long long inner, long long outer_stride, long long inner_stride,
                         int K, int vector, int stream, int threads, int chunk,
                         void* stream_ptr) {
  if (rows <= 0) return 0;
  if (rows > 0x7fffffffLL || inner <= 0 ||
      (threads != 32 && threads != 64 && threads != 128 && threads != 256) ||
      (chunk != 1 && chunk != 2 && chunk != 4 && chunk != 8) || (stream && !vector)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Rows g = make_rows(rows, inner, outer_stride, inner_stride);
  cudaStream_t st = static_cast<cudaStream_t>(stream_ptr);
  float* a = static_cast<float*>(s1);
  float* b = static_cast<float*>(s2);
  if (dtype == 0) {
    return launch<float>(x, a, b, g, K, vector != 0, stream != 0, threads, chunk, st);
  }
  return launch<__nv_bfloat16>(x, a, b, g, K, vector != 0, stream != 0, threads, chunk, st);
}
