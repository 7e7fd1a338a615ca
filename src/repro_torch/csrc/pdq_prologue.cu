// Fused PDQ prologue, written by hand for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel pdq_prologue_p
// (src/repro/kernels/pdq_prologue.py:56, pallas_call at :75).
//
// Per row of x (M, K), f32 or bf16:
//   s_x = max(amax, 1e-8) / 127,  x_q = clip(round(x / s_x), +-127) int8,
//   s1 = sum x,  s2 = sum x^2.
//
// Bound on the H100: bytes.  The kernel reads x and writes x_q (plus three
// floats a row); at the main path's shapes (K = 2048) it does ~4 flops a
// byte, far below the card's ratio of compute to bandwidth.
//
// Design: one block of 256 threads per row.  Pass 1 reduces amax, s1 and
// s2 in f32, each thread over a strided slice, then a fixed butterfly
// across the warp and across the 8 warps, so the sums do not change from
// run to run.  Pass 2 reads the row again (it is in L1/L2 by then) and
// quantizes.  The code divides by s_x, as the plain version
// (kernels/ref.py) does, instead of multiplying by a reciprocal as the
// TPU kernel did: IEEE division (nvcc's default, no fast math) and
// __float2int_rn (round half to even, like torch.round) give exactly the
// plain version's codes.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

struct Stats {
  float amax, s1, s2;
};

// Butterfly over the 32 lanes; every caller reads lane 0's result, whose
// summation order is fixed.
__device__ __forceinline__ Stats warp_reduce(Stats s) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    s.amax = fmaxf(s.amax, __shfl_xor_sync(0xffffffffu, s.amax, off));
    s.s1 += __shfl_xor_sync(0xffffffffu, s.s1, off);
    s.s2 += __shfl_xor_sync(0xffffffffu, s.s2, off);
  }
  return s;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
pdq_prologue_kernel(const T* __restrict__ x, int8_t* __restrict__ xq,
                    float* __restrict__ sx, float* __restrict__ s1,
                    float* __restrict__ s2, int K) {
  __shared__ Stats part[WARPS];
  __shared__ float scale;
  const long long row = blockIdx.x;
  const T* xr = x + row * K;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  Stats s{0.f, 0.f, 0.f};
  for (int k = threadIdx.x; k < K; k += THREADS) {
    const float v = to_f32(xr[k]);
    s.amax = fmaxf(s.amax, fabsf(v));
    s.s1 += v;
    s.s2 = __fadd_rn(s.s2, __fmul_rn(v, v));
  }
  s = warp_reduce(s);
  if (lane == 0) part[warp] = s;
  __syncthreads();
  if (warp == 0) {
    s = lane < WARPS ? part[lane] : Stats{0.f, 0.f, 0.f};
    s = warp_reduce(s);
    if (lane == 0) {
      const float sc = fmaxf(s.amax, 1e-8f) / 127.0f;
      scale = sc;
      sx[row] = sc;
      s1[row] = s.s1;
      s2[row] = s.s2;
    }
  }
  __syncthreads();
  const float sc = scale;
  int8_t* qr = xq + row * K;
  for (int k = threadIdx.x; k < K; k += THREADS) {
    const int q = __float2int_rn(to_f32(xr[k]) / sc);
    qr[k] = static_cast<int8_t>(max(-127, min(127, q)));
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Rows are contiguous, K elements each.
extern "C" int pdq_prologue(const void* x, int dtype, void* xq, void* sx,
                            void* s1, void* s2, long long M, int K,
                            void* stream) {
  if (M <= 0) return 0;
  const dim3 grid(static_cast<unsigned>(M));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int8_t* q = static_cast<int8_t*>(xq);
  float* a = static_cast<float*>(sx);
  float* b = static_cast<float*>(s1);
  float* c = static_cast<float*>(s2);
  if (dtype == 0) {
    pdq_prologue_kernel<float><<<grid, THREADS, 0, st>>>(
        static_cast<const float*>(x), q, a, b, c, K);
  } else {
    pdq_prologue_kernel<__nv_bfloat16><<<grid, THREADS, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), q, a, b, c, K);
  }
  return static_cast<int>(cudaGetLastError());
}
