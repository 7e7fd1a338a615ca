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
// math), never a reciprocal multiply, and round half to even, like
// torch.round; a reciprocal or roundf would move codes at .5 ties.
// Dequantize to bf16 follows the reference's ops contract
// (repro/kernels/ref.py dequantize_ref): q - z and s each round to bf16,
// their product forms in f32 (exact for two bf16 values) and rounds once.
// The TPU kernel instead rounded the f32 product (q - z) * s once, which
// differs in about a quarter of the elements; to f32 the two agree.
//
// Bound on the H100: bytes.  Each element is read once and written once
// (5 bytes an element f32 -> int8, 3 for bf16); a few flops an element.
// But K9's IEEE division, rintf and its two conversions run on the card's
// quarter-rate units (16 an SM a clock): with the data in L2, or at bf16,
// they and not the bytes set its time.
//
// K9's design.  A thread takes E consecutive columns of one row, one (row,
// E columns) pair a thread over a 1-D grid (no limit on M): on the vector
// route one 16-byte load (E = 4 f32 or 8 bf16), the scale and zero point
// once (per row) or as 16-byte loads (per channel), and one store of the E
// codes; on the wide route, for f32 per row larger than the L2, E = 16
// (four 16-byte loads, evict-first, and one 16-byte store); else element
// by element, the ragged end of a row masked (the element route: N % E or
// a base off 16 bytes).  Nothing is padded.  The codes: t = x / s by IEEE
// division, then t + 1.5 * 2^23, whose low mantissa bits hold rint(t)
// (the FADD rounds half to even) when |t| < 2^22, and the zero point and
// the clamp in integers, exact when |z| < 2^23 as the plain version's
// float sum then is; a unit with any other t or z (huge, NaN, inf) takes
// the float formula, rintf and all.  The zero point is used right after
// the loads: a load first used past the first division waits behind the
// division's slow-path call, a second round trip for every thread.  The
// wrapper (kernels/quantize.py, `plan`) picks the route and the grid.
// Measured and not kept (PERF.md §6): 16 columns a thread on every
// route, a persistent grid, and warp-coalesced 512-element chunks with the
// codes exchanged through shared memory.
//
// K10's design follows K9's: 16 codes a thread on a 1-D grid (the file's
// Divisor: no limit on M, no row loop), a plan from the wrapper
// (kernels/quantize.py `dequantize_plan`).  Its bytes are mostly the
// output's (four of f32 a code), so the stores set its time: on the
// vector route a thread's 16 codes are 16 / G groups of G codes, one
// 16-byte store of f32 (G = 4) or bf16 (G = 8) each, spread so that the
// lanes of a warp store one contiguous span an instruction (a thread's 16
// consecutive codes, one 16-byte load and four 16-byte stores 16 bytes
// apart from its neighbours', wrote half sectors a store and measured
// slower than the first K10 at f32, PERF.md).  Per channel a group's scales
// and zero points come as 16-byte loads; per row, once a group.  Stores are
// plain: evict-first ones past the L2 measured slower.  N % 16 or a base
// off 16 bytes takes the element route: one (row, 16 columns) pair a
// thread, element by element, the ragged end of a row masked.  Nothing is
// padded.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

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

constexpr int Q_THREADS = 256;         // K9, K10: threads a block at most
constexpr int DQ = 16;                 // K10: codes a unit
constexpr float MAGIC = 12582912.f;    // 1.5 * 2^23
constexpr int BIAS = 0x4B400000;       // its bits

// A zero point ready for quant_n: z - BIAS, and whether |z| >= 2^23.
struct Zero {
  int zb;
  bool big;
};
__device__ __forceinline__ Zero zero(int z) {
  return Zero{static_cast<int>(static_cast<unsigned>(z) - BIAS),
              z >= (1 << 23) || z <= -(1 << 23)};
}

// K9's codes of n values, equal to quant()'s (the note above).
template <int n>
__device__ __forceinline__ void quant_n(const float (&v)[n], const float (&sc)[n],
                                        const Zero (&zc)[n], int (&out)[n]) {
  bool slow = false;
#pragma unroll
  for (int k = 0; k < n; ++k) {
    const float t = v[k] / sc[k];
    slow |= !(fabsf(t) < 4194304.f) || zc[k].big;
    const unsigned bits = static_cast<unsigned>(__float_as_int(__fadd_rn(t, MAGIC)));
    const int i = static_cast<int>(bits + static_cast<unsigned>(zc[k].zb));
    out[k] = min(max(i, -128), 127);
  }
  if (slow) {
#pragma unroll
    for (int k = 0; k < n; ++k) {
      out[k] = quant(v[k], sc[k], static_cast<int>(static_cast<unsigned>(zc[k].zb) + BIAS));
    }
  }
}

// four codes as one 32-bit word, the first in the lowest byte
__device__ __forceinline__ int pack4(const int* c) {
  return (c[0] & 0xff) | (c[1] & 0xff) << 8 | (c[2] & 0xff) << 16 | (c[3] & 0xff) << 24;
}

// n / d as (n * magic) >> shift for n < 2^31, with magic = ceil(2^shift /
// d) and shift = 31 + ceil(log2 d) (exact: n * (magic * d - 2^shift) <
// 2^shift); a division past that
struct Divisor {
  unsigned long long magic;
  int shift, d;
};

Divisor make_divisor(int d) {
  int shift = 31;
  while ((1LL << (shift - 31)) < d) ++shift;
  const unsigned long long p = 1ULL << shift;
  return Divisor{(p + static_cast<unsigned>(d) - 1) / static_cast<unsigned>(d), shift, d};
}

__device__ __forceinline__ long long divide(long long n, const Divisor& v) {
  if ((n >> 31) == 0) {
    return static_cast<long long>((static_cast<unsigned long long>(n) * v.magic) >> v.shift);
  }
  return n / v.d;
}

// E values of x from 16-byte loads, x 16-byte aligned
template <typename T, int E, bool STREAM>
__device__ __forceinline__ void load_cols(const T* x, float (&v)[E]) {
  constexpr int L = E * sizeof(T) / 16;
  uint4 r[L];
#pragma unroll
  for (int i = 0; i < L; ++i) {
    const uint4* p = reinterpret_cast<const uint4*>(x) + i;
    r[i] = STREAM ? __ldcs(p) : *p;
  }
  const T* h = reinterpret_cast<const T*>(r);
#pragma unroll
  for (int i = 0; i < E; ++i) v[i] = to_f32(h[i]);
}

// E codes as one store of E bytes, q E-byte aligned
template <int E, bool STREAM>
__device__ __forceinline__ void store_cols(int8_t* q, const int (&c)[E]) {
  if constexpr (E == 4) {
    *reinterpret_cast<int*>(q) = pack4(c);
  } else if constexpr (E == 8) {
    *reinterpret_cast<int2*>(q) = make_int2(pack4(c), pack4(c + 4));
  } else {
    const int4 w = make_int4(pack4(c), pack4(c + 4), pack4(c + 8), pack4(c + 12));
    if (STREAM) {
      __stcs(reinterpret_cast<int4*>(q), w);
    } else {
      *reinterpret_cast<int4*>(q) = w;
    }
  }
}

// One (row, E columns) pair a thread: units = ceil(N / E) pairs a row.
template <typename T, bool PER_CHANNEL, int E, bool VECTOR, bool STREAM>
__global__ void __launch_bounds__(Q_THREADS)
quantize_kernel(const T* __restrict__ x, const float* __restrict__ s,
                const int* __restrict__ z, int8_t* __restrict__ q, long long M, int N,
                Divisor units) {
  const long long g = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long row = divide(g, units);
  if (row >= M) return;
  const int c0 = static_cast<int>(g - row * units.d) * E;
  const long long at = row * N + c0;
  float v[E], sc[E];
  Zero zc[E];
  int out[E];
  if (VECTOR) {
    load_cols<T, E, STREAM>(x + at, v);
  } else {
#pragma unroll
    for (int i = 0; i < E; ++i) v[i] = c0 + i < N ? to_f32(x[at + i]) : 0.f;
  }
  if (PER_CHANNEL) {
    if (VECTOR) {
#pragma unroll
      for (int k = 0; k < E; k += 4) {
        const float4 a = *reinterpret_cast<const float4*>(s + c0 + k);
        const int4 b = *reinterpret_cast<const int4*>(z + c0 + k);
        sc[k] = a.x, sc[k + 1] = a.y, sc[k + 2] = a.z, sc[k + 3] = a.w;
        zc[k] = zero(b.x), zc[k + 1] = zero(b.y), zc[k + 2] = zero(b.z), zc[k + 3] = zero(b.w);
      }
    } else {
#pragma unroll
      for (int i = 0; i < E; ++i) {
        sc[i] = c0 + i < N ? s[c0 + i] : 1.f;
        zc[i] = zero(c0 + i < N ? z[c0 + i] : 0);
      }
    }
  } else {
    const float sr = s[row];
    const Zero zr = zero(z[row]);
#pragma unroll
    for (int i = 0; i < E; ++i) sc[i] = sr, zc[i] = zr;
  }
  quant_n<E>(v, sc, zc, out);
  if (VECTOR) {
    store_cols<E, STREAM>(q + at, out);
  } else {
#pragma unroll
    for (int i = 0; i < E; ++i) {
      if (c0 + i < N) q[at + i] = static_cast<int8_t>(out[i]);
    }
  }
}

// K10's vector and stream routes.  The rows are contiguous and N % 16 == 0,
// so the codes are read as one flat array: a block owns 256 x 16
// consecutive codes, as 16 / G groups a thread of G = 16 / sizeof(T) codes
// (one 16-byte store of output each), group j of thread t at the block's
// base + (j * 256 + t) * G: each load and each store instruction of a
// warp covers one contiguous span.  A group lies in one row (G divides N):
// its row is e / N (`cols`), its column e % N.
template <typename T, bool PER_CHANNEL>
__global__ void __launch_bounds__(Q_THREADS)
dequantize_vector_kernel(const int8_t* __restrict__ q, const float* __restrict__ s,
                         const int* __restrict__ z, T* __restrict__ y, long long total,
                         Divisor cols) {
  constexpr int G = 16 / sizeof(T), NG = DQ / G;
  using Codes = typename std::conditional<G == 4, int, int2>::type;
  const long long base = static_cast<long long>(blockIdx.x) * blockDim.x * DQ;
  Codes codes[NG];
#pragma unroll
  for (int j = 0; j < NG; ++j) {
    const long long e = base + (static_cast<long long>(j) * blockDim.x + threadIdx.x) * G;
    if (e < total) {
      const Codes* p = reinterpret_cast<const Codes*>(q + e);
      codes[j] = __ldg(p);
    }
  }
#pragma unroll
  for (int j = 0; j < NG; ++j) {
    const long long e = base + (static_cast<long long>(j) * blockDim.x + threadIdx.x) * G;
    if (e >= total) break;
    const long long row = divide(e, cols);
    const int c0 = static_cast<int>(e - row * cols.d);
    const int8_t* c = reinterpret_cast<const int8_t*>(&codes[j]);
    float sc[G];
    int zc[G];
    if (PER_CHANNEL) {
#pragma unroll
      for (int k = 0; k < G; k += 4) {
        const float4 a = __ldg(reinterpret_cast<const float4*>(s + c0 + k));
        const int4 b = __ldg(reinterpret_cast<const int4*>(z + c0 + k));
        sc[k] = a.x, sc[k + 1] = a.y, sc[k + 2] = a.z, sc[k + 3] = a.w;
        zc[k] = b.x, zc[k + 1] = b.y, zc[k + 2] = b.z, zc[k + 3] = b.w;
      }
    } else {
      const float sr = __ldg(s + row);
      const int zr = __ldg(z + row);
#pragma unroll
      for (int i = 0; i < G; ++i) sc[i] = sr, zc[i] = zr;
    }
    alignas(16) T out[G];
#pragma unroll
    for (int i = 0; i < G; ++i) dequant(c[i], sc[i], zc[i], &out[i]);
    *reinterpret_cast<uint4*>(y + e) = *reinterpret_cast<const uint4*>(out);
  }
}

// K10's element route: one (row, 16 columns) pair a thread, units =
// ceil(N / 16) pairs a row, element by element, the ragged end masked.
template <typename T, bool PER_CHANNEL>
__global__ void __launch_bounds__(Q_THREADS)
dequantize_kernel(const int8_t* __restrict__ q, const float* __restrict__ s,
                  const int* __restrict__ z, T* __restrict__ y, long long M, int N,
                  Divisor units) {
  const long long g = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long row = divide(g, units);
  if (row >= M) return;
  const int c0 = static_cast<int>(g - row * units.d) * DQ;
  const long long at = row * N + c0;
#pragma unroll
  for (int i = 0; i < DQ; ++i) {
    if (c0 + i < N) {
      const long long j = PER_CHANNEL ? c0 + i : row;
      dequant(q[at + i], s[j], z[j], &y[at + i]);
    }
  }
}

bool aligned(const void* p, size_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// route: 0 element, 1 vector, 2 wide (f32 per row only)
template <typename T>
int launch_quantize(const void* x, const float* s, const int* z, int8_t* q, long long M,
                    int N, bool per_channel, int route, int threads, int grid,
                    cudaStream_t st) {
  constexpr int E = 16 / sizeof(T);
  const int cols = route == 2 ? 16 : E;
  if (route != 0 && (N % cols != 0 || !aligned(x, 16) || !aligned(q, 16) ||
                     (per_channel && (!aligned(s, 16) || !aligned(z, 16))))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (route == 2 && (per_channel || sizeof(T) != 4)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int units = (N + cols - 1) / cols;
  if (static_cast<long long>(grid) * threads < M * units) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const T* xt = static_cast<const T*>(x);
  const Divisor div = make_divisor(units);
#define QUANTIZE_LAUNCH(PC, COLS, VEC, STREAM)                                         \
  quantize_kernel<T, PC, COLS, VEC, STREAM><<<grid, threads, 0, st>>>(xt, s, z, q, M, N, \
                                                                      div)
  if (route == 2) {
    if constexpr (sizeof(T) == 4) QUANTIZE_LAUNCH(false, 16, true, true);
  } else if (route == 1) {
    if (per_channel) QUANTIZE_LAUNCH(true, E, true, false);
    else QUANTIZE_LAUNCH(false, E, true, false);
  } else {
    if (per_channel) QUANTIZE_LAUNCH(true, E, false, false);
    else QUANTIZE_LAUNCH(false, E, false, false);
  }
#undef QUANTIZE_LAUNCH
  return static_cast<int>(cudaGetLastError());
}

// route: 0 element, 1 vector
template <typename T>
int launch_dequantize(const int8_t* q, const float* s, const int* z, void* y, long long M,
                      int N, bool per_channel, int route, int threads, int grid,
                      cudaStream_t st) {
  if (route != 0 && (N % DQ != 0 || !aligned(q, 16) || !aligned(y, 16) ||
                     (per_channel && (!aligned(s, 16) || !aligned(z, 16))))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int units = (N + DQ - 1) / DQ;
  if (static_cast<long long>(grid) * threads < M * units) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  T* yt = static_cast<T*>(y);
  if (route == 1) {
    const Divisor cols = make_divisor(N);
    if (per_channel)
      dequantize_vector_kernel<T, true><<<grid, threads, 0, st>>>(q, s, z, yt, M * N, cols);
    else
      dequantize_vector_kernel<T, false><<<grid, threads, 0, st>>>(q, s, z, yt, M * N, cols);
  } else {
    const Divisor div = make_divisor(units);
    if (per_channel)
      dequantize_kernel<T, true><<<grid, threads, 0, st>>>(q, s, z, yt, M, N, div);
    else
      dequantize_kernel<T, false><<<grid, threads, 0, st>>>(q, s, z, yt, M, N, div);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype of x: 0 = float32, 1 = bfloat16.  s/z hold M values (per row) or N
// (per_channel != 0).  Rows are contiguous, N elements each.  The route is
// the caller's: 0 element by element, 1 vector (E = 4 f32 or 8 bf16
// columns a thread), 2 wide (16 f32 columns a thread, per row); one (row,
// columns) pair a thread, `threads` a block (32 to 256) and `grid` blocks
// covering every pair.
extern "C" int quantize(const void* x, int dtype, const void* s, const void* z, void* q,
                        long long M, int N, int per_channel, int route, int threads, int grid,
                        void* stream) {
  if (M <= 0 || N <= 0) return 0;
  if (route < 0 || route > 2 || threads < 32 || threads > Q_THREADS || threads % 32 != 0 ||
      grid <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* sf = static_cast<const float*>(s);
  const int* zi = static_cast<const int*>(z);
  int8_t* qi = static_cast<int8_t*>(q);
  if (dtype == 0) {
    return launch_quantize<float>(x, sf, zi, qi, M, N, per_channel != 0, route, threads, grid,
                                  st);
  }
  return launch_quantize<__nv_bfloat16>(x, sf, zi, qi, M, N, per_channel != 0, route, threads,
                                        grid, st);
}

// out_dtype of y: 0 = float32, 1 = bfloat16; s/z as for quantize.  The
// route is the caller's: 0 element by element, 1 vector (16-byte stores);
// 16 codes a thread, `threads` a block (32 to 256) and `grid` blocks
// covering every code.
extern "C" int dequantize(const void* q, const void* s, const void* z, void* y,
                          int out_dtype, long long M, int N, int per_channel, int route,
                          int threads, int grid, void* stream) {
  if (M <= 0 || N <= 0) return 0;
  if (route < 0 || route > 1 || threads < 32 || threads > Q_THREADS || threads % 32 != 0 ||
      grid <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* qi = static_cast<const int8_t*>(q);
  const float* sf = static_cast<const float*>(s);
  const int* zi = static_cast<const int*>(z);
  if (out_dtype == 0) {
    return launch_dequantize<float>(qi, sf, zi, y, M, N, per_channel != 0, route, threads,
                                    grid, st);
  }
  return launch_dequantize<__nv_bfloat16>(qi, sf, zi, y, M, N, per_channel != 0, route,
                                          threads, grid, st);
}
