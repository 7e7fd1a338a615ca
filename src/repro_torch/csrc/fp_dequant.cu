// The guarded PDQ projection's fp-dequant fallback, predicated on the
// device, written by hand for Hopper (sm_90a).
//
// Replaces the fallback branch of the reference's guard
// (src/repro/kernels/ops.py: _guard_pdq's lax.cond over
// _fp_dequant_matmul).  The reference's cond runs only the branch taken;
// here the launch is always in the stream (so a captured decode graph stays
// static) and decides on the device:
//   flag[0] == 0: nothing (the projection's y was finite);
//   flag[0] != 0: y = (x.f32 @ (q.f32 * scale)).to(y's dtype) and, with a
//                 counter pointer, tel[0] (fallbacks) += 1.
// flag[0] is the non-finite flag that the projection's W8A8 epilogue set
// (csrc/w8a8_matmul.cu); flag[1] is this kernel's ticket.  Both are zero at
// rest: every block reads flag[0], then draws a ticket, and the last block
// puts both back to 0 (and counts the fallback), so the next projection
// finds them clear.
//
// x: (M, K) f32 or bf16, row-major; q: the weight (K, N) stored K-major,
// i.e. (N, K) row-major int8; scale: (N,) f32; y: (M, N) f32 or bf16.
//
// Bound on the H100, when taken: bytes at decode (the int8 weight is read
// once: 12.6 MB for QKV), f32 operations at prefill (2 M N K at 67
// TFLOP/s).  Not taken: one flag read and one atomic a block.  Design: the
// simple tiled f32 FMA loop (a block owns 16 rows x 64 columns and walks K
// in 32-deep tiles through shared memory, the weight dequantized on its way
// in, as the reference rounds it: q * scale in f32, then the product).  It
// runs only on a fault; it is not made fast.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 16, BN = 64, BK = 32, THREADS = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

template <typename XT, typename YT>
__global__ void __launch_bounds__(THREADS)
fallback_kernel(const XT* __restrict__ x, const int8_t* __restrict__ q,
                const float* __restrict__ scale, YT* __restrict__ y, long long M, int K,
                int N, int* flag, unsigned long long* tel) {
  __shared__ int take;
  __shared__ float xs[BM][BK + 1];
  __shared__ float ws[BK][BN + 1];
  if (threadIdx.x == 0) {
    const int f = *reinterpret_cast<volatile int*>(flag);
    take = f;
    __threadfence();
    const unsigned blocks = gridDim.x * gridDim.y;
    if (atomicAdd(reinterpret_cast<unsigned*>(flag + 1), 1u) == blocks - 1) {
      // every block has read the flag: clear it and the ticket
      atomicExch(flag, 0);
      atomicExch(flag + 1, 0);
      if (f && tel) atomicAdd(tel, 1ull);
    }
  }
  __syncthreads();
  if (!take) return;

  const long long m0 = static_cast<long long>(blockIdx.y) * BM;
  const int n0 = blockIdx.x * BN;
  const int tx = threadIdx.x % BN, ty = threadIdx.x / BN;   // ty: 0..3
  float acc[BM / 4] = {};
  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int i = threadIdx.x; i < BM * BK; i += THREADS) {
      const int r = i / BK, k = i % BK;
      const long long m = m0 + r;
      xs[r][k] = m < M && k0 + k < K ? to_f32(x[m * K + k0 + k]) : 0.f;
    }
    for (int i = threadIdx.x; i < BN * BK; i += THREADS) {
      const int n = i / BK, k = i % BK;
      const int c = n0 + n;
      ws[k][n] = c < N && k0 + k < K
                     ? __fmul_rn(static_cast<float>(q[static_cast<long long>(c) * K + k0 + k]),
                                 scale[c])
                     : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < BK; ++k) {
      const float w = ws[k][tx];
#pragma unroll
      for (int i = 0; i < BM / 4; ++i) acc[i] = fmaf(xs[ty + 4 * i][k], w, acc[i]);
    }
    __syncthreads();
  }
  const int n = n0 + tx;
  if (n >= N) return;
#pragma unroll
  for (int i = 0; i < BM / 4; ++i) {
    const long long m = m0 + ty + 4 * i;
    if (m < M) put(y + m * N + n, acc[i]);
  }
}

template <typename XT, typename YT>
void launch(const void* x, const void* q, const void* scale, void* y, long long M, int K,
            int N, void* flag, void* tel, cudaStream_t st) {
  const dim3 grid((N + BN - 1) / BN, static_cast<unsigned>((M + BM - 1) / BM));
  fallback_kernel<XT, YT><<<grid, THREADS, 0, st>>>(
      static_cast<const XT*>(x), static_cast<const int8_t*>(q),
      static_cast<const float*>(scale), static_cast<YT*>(y), M, K, N,
      static_cast<int*>(flag), static_cast<unsigned long long*>(tel));
}

}  // namespace

// kinds: 0 float32, 1 bfloat16.  flag: (2,) int32, zero at rest; tel: null or
// the (3,) int64 counters.  The grid must stay below 2^32 blocks.
extern "C" int fp_dequant_fallback(const void* x, int x_kind, const void* q,
                                   const void* scale, void* y, int y_kind, long long M,
                                   int K, int N, void* flag, void* tel, void* stream) {
  if (M <= 0 || N <= 0) return 0;
  if (!flag || (M + BM - 1) / BM > 65535) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_kind == 0 && y_kind == 0)
    launch<float, float>(x, q, scale, y, M, K, N, flag, tel, st);
  else if (x_kind == 0)
    launch<float, __nv_bfloat16>(x, q, scale, y, M, K, N, flag, tel, st);
  else if (y_kind == 0)
    launch<__nv_bfloat16, float>(x, q, scale, y, M, K, N, flag, tel, st);
  else
    launch<__nv_bfloat16, __nv_bfloat16>(x, q, scale, y, M, K, N, flag, tel, st);
  return static_cast<int>(cudaGetLastError());
}
