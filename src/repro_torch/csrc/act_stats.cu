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
// bandwidth.
//
// Design: one block of 256 threads per row.  When the base, K and both
// strides allow it, each thread reads 16-byte vectors (4 f32 or 8 bf16),
// else one element at a time; the ragged end of K is masked by the loop
// bound, and nothing is padded.  Each thread sums its elements in order,
// then a fixed butterfly across the warp and across the 8 warps, so two
// launches on the same input give the same bits.  s2 adds the rounded
// square (no fused multiply-add), as the plain version does.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

struct Sums {
  float s1, s2;
};

__device__ __forceinline__ void add(Sums& s, float v) {
  s.s1 += v;
  s.s2 = __fadd_rn(s.s2, __fmul_rn(v, v));
}

__device__ __forceinline__ Sums warp_reduce(Sums s) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    s.s1 += __shfl_xor_sync(0xffffffffu, s.s1, off);
    s.s2 += __shfl_xor_sync(0xffffffffu, s.s2, off);
  }
  return s;
}

// 16 bytes of x as VEC elements
template <typename T>
struct Vec;
template <>
struct Vec<float> {
  static constexpr int N = 4;
  __device__ static void add_all(Sums& s, const float* p) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    add(s, v.x);
    add(s, v.y);
    add(s, v.z);
    add(s, v.w);
  }
};
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void add_all(Sums& s, const __nv_bfloat16* p) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&v);
#pragma unroll
    for (int i = 0; i < 8; ++i) add(s, __bfloat162float(h[i]));
  }
};

template <typename T, bool VECTOR>
__global__ void __launch_bounds__(THREADS)
act_stats_kernel(const T* __restrict__ x, float* __restrict__ s1,
                 float* __restrict__ s2, long long inner, long long outer_stride,
                 long long inner_stride, int K) {
  __shared__ Sums part[WARPS];
  const long long row = blockIdx.x;
  const T* xr = x + (row / inner) * outer_stride + (row % inner) * inner_stride;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  Sums s{0.f, 0.f};
  if (VECTOR) {
    constexpr int V = Vec<T>::N;
    for (int k = threadIdx.x * V; k < K; k += THREADS * V) Vec<T>::add_all(s, xr + k);
  } else {
    for (int k = threadIdx.x; k < K; k += THREADS) add(s, to_f32(xr[k]));
  }
  s = warp_reduce(s);
  if (lane == 0) part[warp] = s;
  __syncthreads();
  if (warp == 0) {
    s = lane < WARPS ? part[lane] : Sums{0.f, 0.f};
    s = warp_reduce(s);
    if (lane == 0) {
      s1[row] = s.s1;
      s2[row] = s.s2;
    }
  }
}

template <typename T>
void launch(const void* x, float* s1, float* s2, long long rows, long long inner,
            long long outer_stride, long long inner_stride, int K, cudaStream_t st) {
  constexpr int V = Vec<T>::N;
  const bool vector = reinterpret_cast<uintptr_t>(x) % 16 == 0 && K % V == 0 &&
                      outer_stride % V == 0 && inner_stride % V == 0;
  const T* xt = static_cast<const T*>(x);
  const dim3 grid(static_cast<unsigned>(rows));
  if (vector) {
    act_stats_kernel<T, true><<<grid, THREADS, 0, st>>>(xt, s1, s2, inner, outer_stride,
                                                        inner_stride, K);
  } else {
    act_stats_kernel<T, false><<<grid, THREADS, 0, st>>>(xt, s1, s2, inner, outer_stride,
                                                         inner_stride, K);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  rows = outer * inner; strides in elements.
extern "C" int act_stats(const void* x, int dtype, void* s1, void* s2, long long rows,
                         long long inner, long long outer_stride, long long inner_stride,
                         int K, void* stream) {
  if (rows <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* a = static_cast<float*>(s1);
  float* b = static_cast<float*>(s2);
  if (dtype == 0) {
    launch<float>(x, a, b, rows, inner, outer_stride, inner_stride, K, st);
  } else {
    launch<__nv_bfloat16>(x, a, b, rows, inner, outer_stride, inner_stride, K, st);
  }
  return static_cast<int>(cudaGetLastError());
}
