// Affine int8 quantize and dequantize, written by hand for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels quantize_p (src/repro/kernels/quantize.py:31,
// pallas_call at :41) and dequantize_p (quantize.py:51, pallas_call at :61).
//
// quantize:   q = clamp(rint(x / s) + z, -128, 127)      x (M, N) f32/bf16 -> int8
// dequantize: y = (q - z) * s                            q (M, N) int8 -> f32/bf16
// s (f32) and z (int32) are per row, M values, or per channel, N values.
//
// Rounding and division follow the plain versions (kernels/ref.py) bit for
// bit: IEEE division by the scale (nvcc's default -prec-div=true; no fast
// math), never a reciprocal multiply, and rintf, which rounds half to even
// like torch.round; a reciprocal or roundf would move codes at .5 ties.
// Dequantize to bf16 follows the reference's ops contract
// (repro/kernels/ref.py dequantize_ref): q - z and s each round to bf16,
// their product forms in f32 (exact for two bf16 values) and rounds once.
// The TPU kernel instead rounded the f32 product (q - z) * s once, which
// differs in about a quarter of the elements; to f32 the two agree.
//
// Bound on the H100: bytes.  Each element is read once and written once
// (5 bytes an element f32 -> int8, 3 for bf16); a few flops an element.
//
// Design: elementwise.  Grid x covers a row's columns, THREADS * 4 a block,
// grid y the rows (a loop when M exceeds the grid).  Each thread takes 4
// consecutive columns: one vector load and one vector store when N, the
// bases and the element sizes allow it, else element by element.  The
// ragged end of each row is masked; nothing is padded.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int V = 4;                   // columns a thread
constexpr unsigned MAX_GRID_Y = 65535;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ int8_t quant(float v, float s, int z) {
  const float r = rintf(v / s) + static_cast<float>(z);
  return static_cast<int8_t>(static_cast<int>(fminf(fmaxf(r, -128.f), 127.f)));
}

__device__ __forceinline__ void dequant(int8_t q, float s, int z, float* out) {
  *out = __fmul_rn(static_cast<float>(static_cast<int>(q) - z), s);
}

__device__ __forceinline__ void dequant(int8_t q, float s, int z, __nv_bfloat16* out) {
  const float d = __bfloat162float(__float2bfloat16_rn(static_cast<float>(static_cast<int>(q) - z)));
  const float sb = __bfloat162float(__float2bfloat16_rn(s));
  *out = __float2bfloat16_rn(__fmul_rn(d, sb));
}

// V elements as one aligned vector of their type
template <typename T>
struct alignas(sizeof(T) * V) Pack {
  T v[V];
};

template <typename T, bool PER_CHANNEL, bool VECTOR>
__global__ void __launch_bounds__(THREADS)
quantize_kernel(const T* __restrict__ x, const float* __restrict__ s,
                const int* __restrict__ z, int8_t* __restrict__ q, long long M, int N) {
  const int c0 = (blockIdx.x * THREADS + threadIdx.x) * V;
  if (c0 >= N) return;
  for (long long row = blockIdx.y; row < M; row += gridDim.y) {
    const T* xr = x + row * N;
    int8_t* qr = q + row * N;
    if (VECTOR) {
      const Pack<T> in = *reinterpret_cast<const Pack<T>*>(xr + c0);
      Pack<int8_t> out;
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const long long j = PER_CHANNEL ? c0 + i : row;
        out.v[i] = quant(to_f32(in.v[i]), s[j], z[j]);
      }
      *reinterpret_cast<Pack<int8_t>*>(qr + c0) = out;
    } else {
      for (int c = c0; c < min(c0 + V, N); ++c) {
        const long long j = PER_CHANNEL ? c : row;
        qr[c] = quant(to_f32(xr[c]), s[j], z[j]);
      }
    }
  }
}

template <typename T, bool PER_CHANNEL, bool VECTOR>
__global__ void __launch_bounds__(THREADS)
dequantize_kernel(const int8_t* __restrict__ q, const float* __restrict__ s,
                  const int* __restrict__ z, T* __restrict__ y, long long M, int N) {
  const int c0 = (blockIdx.x * THREADS + threadIdx.x) * V;
  if (c0 >= N) return;
  for (long long row = blockIdx.y; row < M; row += gridDim.y) {
    const int8_t* qr = q + row * N;
    T* yr = y + row * N;
    if (VECTOR) {
      const Pack<int8_t> in = *reinterpret_cast<const Pack<int8_t>*>(qr + c0);
      Pack<T> out;
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const long long j = PER_CHANNEL ? c0 + i : row;
        dequant(in.v[i], s[j], z[j], &out.v[i]);
      }
      *reinterpret_cast<Pack<T>*>(yr + c0) = out;
    } else {
      for (int c = c0; c < min(c0 + V, N); ++c) {
        const long long j = PER_CHANNEL ? c : row;
        dequant(qr[c], s[j], z[j], &yr[c]);
      }
    }
  }
}

bool aligned(const void* p, size_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

dim3 grid_of(long long M, int N) {
  const unsigned gx = static_cast<unsigned>((N + THREADS * V - 1) / (THREADS * V));
  const unsigned gy = static_cast<unsigned>(M < MAX_GRID_Y ? M : MAX_GRID_Y);
  return dim3(gx, gy);
}

// One of the four (per channel, vector) instances of KERNEL<T, ...>.
#define DISPATCH(KERNEL, T, PC, VEC, ...)                              \
  do {                                                                          \
    if (PC && VEC) KERNEL<T, true, true><<<grid, THREADS, 0, st>>>(__VA_ARGS__); \
    else if (PC) KERNEL<T, true, false><<<grid, THREADS, 0, st>>>(__VA_ARGS__);  \
    else if (VEC) KERNEL<T, false, true><<<grid, THREADS, 0, st>>>(__VA_ARGS__); \
    else KERNEL<T, false, false><<<grid, THREADS, 0, st>>>(__VA_ARGS__);         \
  } while (0)

template <typename T>
void launch_quantize(const void* x, const float* s, const int* z, int8_t* q,
                     long long M, int N, bool per_channel, cudaStream_t st) {
  const bool vec = N % V == 0 && aligned(x, sizeof(T) * V) && aligned(q, V);
  const dim3 grid = grid_of(M, N);
  const T* xt = static_cast<const T*>(x);
  DISPATCH(quantize_kernel, T, per_channel, vec, xt, s, z, q, M, N);
}

template <typename T>
void launch_dequantize(const int8_t* q, const float* s, const int* z, void* y,
                       long long M, int N, bool per_channel, cudaStream_t st) {
  const bool vec = N % V == 0 && aligned(q, V) && aligned(y, sizeof(T) * V);
  const dim3 grid = grid_of(M, N);
  T* yt = static_cast<T*>(y);
  DISPATCH(dequantize_kernel, T, per_channel, vec, q, s, z, yt, M, N);
}

}  // namespace

// dtype of x: 0 = float32, 1 = bfloat16.  s/z hold M values (per row) or N
// (per_channel != 0).  Rows are contiguous, N elements each.
extern "C" int quantize(const void* x, int dtype, const void* s, const void* z, void* q,
                        long long M, int N, int per_channel, void* stream) {
  if (M <= 0 || N <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* sf = static_cast<const float*>(s);
  const int* zi = static_cast<const int*>(z);
  int8_t* qi = static_cast<int8_t*>(q);
  if (dtype == 0) {
    launch_quantize<float>(x, sf, zi, qi, M, N, per_channel != 0, st);
  } else {
    launch_quantize<__nv_bfloat16>(x, sf, zi, qi, M, N, per_channel != 0, st);
  }
  return static_cast<int>(cudaGetLastError());
}

// out_dtype of y: 0 = float32, 1 = bfloat16; s/z as for quantize.
extern "C" int dequantize(const void* q, const void* s, const void* z, void* y,
                          int out_dtype, long long M, int N, int per_channel,
                          void* stream) {
  if (M <= 0 || N <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* qi = static_cast<const int8_t*>(q);
  const float* sf = static_cast<const float*>(s);
  const int* zi = static_cast<const int*>(z);
  if (out_dtype == 0) {
    launch_dequantize<float>(qi, sf, zi, y, M, N, per_channel != 0, st);
  } else {
    launch_dequantize<__nv_bfloat16>(qi, sf, zi, y, M, N, per_channel != 0, st);
  }
  return static_cast<int>(cudaGetLastError());
}
