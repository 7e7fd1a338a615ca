// Fused PDQ prologue (kernel K1), written by hand for Hopper (sm_90a), with
// the RMSNorm in front of it (all but its mean of squares) and the PDQ
// interval after it folded into the same launch when the caller asks for
// them.
//
// Replaces the Pallas TPU kernel pdq_prologue_p
// (src/repro/kernels/pdq_prologue.py:56, pallas_call at :75), and, on the
// main path, the plain-torch RMSNorm before it (but its mean of squares)
// and the interval math after it (kernels/ref.py: rms_norm, pdq_interval,
// grid_extent, blockwise).
//
// Per row h of x (M, K), f32 or bf16:
//   norm (w != null):  y = round_to_T(h * rsqrt(ms + eps) * (1 + w)), with
//                      ms the row's mean of squares (an operand),
//                      else y = h;
//   prologue:          s_x = max(amax y, 1e-8) / 127,
//                      x_q = clip(round(y / s_x), +-127) int8,
//                      s1 = sum y,  s2 = sum y^2;
//   interval (n_seg > 0), for each segment i of the weight record:
//     mean = mu_i s1,  sigma = sqrt(max(var_i s2, 0)) + 1e-8,
//     lo = min(mean - alpha_i sigma, 0),  hi = max(mean + beta_i sigma, 0),
//     s_out = max((hi - lo) / 255, 1e-8),  z = -round(lo / s_out) - 128,
//     lo_g = (-128 - z) s_out,  hi_g = (127 - z) s_out,
//   written to blocks[i] consecutive columns of the row of lo/hi (one per
//   128-column block of the segment's output, the W8A8 clamp's layout).
//
// Bound on the H100: bytes.  A launch reads h once (and w, K values, once
// per CTA from L2, and ms, a float a row) and writes x_q, three floats a
// row and the interval's columns; it does ~5 flops a byte.
//
// Design.  One CTA a row, the whole row in registers, loaded once with
// 16-byte vectors (8 bf16 or 4 f32; scalar loads when K is not a multiple
// of that or a row operand is not 16-byte aligned), so the norm, the
// statistics and the quantization all read registers and nothing is read
// twice.  At decode (M < PREFILL_ROWS) a thread holds one vector where the
// row fits 1024 threads (256 threads for K = 2048 bf16), which keeps the
// dependent chain to one load, one CTA reduction and one store; at
// prefill two (128 threads), which measured faster than one and than 4 or
// 8 vectors a thread, and than a warp a row (PERF.md).  Reductions
// are fixed xor butterflies in each warp (every lane gets the same bits:
// IEEE addition commutes), then each thread adds the warps' partials in
// warp order: two launches are bit-equal.
//
// Numerics.  Every step is written with an explicit IEEE rounding
// (__fmul_rn, __fadd_rn, __fdiv_rn, __fsqrt_rn) so that nvcc's default
// contraction into FMAs cannot change a value: the interval is bit-equal
// to the plain version given the same s1/s2, and x_q/s_x to the plain
// prologue of the same row (true division by s_x and __float2int_rn, half
// to even, like torch.round).  The norm's mean of squares ms is an
// operand: torch computes it before the launch with the plain version's
// own reduction (kernels/ref.py mean_square).  A sum over the row here
// would take another order than torch's CUDA mean and round apart from it
// in some rows; a normed value one ulp away moves int8 codes downstream,
// and the logits of path C (every other kernel bit-equal to its plain
// version) would no longer match.  From ms the kernel takes rsqrtf, the
// function torch's CUDA rsqrt calls, and the plain version's products in
// its order, so the normed row is the plain version's bit for bit.  The
// row maximum takes max.NaN (max_nan): a NaN in the row gives a NaN s_x,
// s1 and s2, and so a NaN y downstream, as torch's amax and jnp.max do
// (fmaxf would skip the NaN lane).
#include <climits>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int MAX_SEG = 8;          // kernels/pdq_prologue.py MAX_SEG
constexpr int MAX_THREADS = 1024;
constexpr int PREFILL_ROWS = 33;    // M from which a thread holds two packs or more

struct Params {
  const void* x;
  const void* w;                    // norm weight (K,) of x's type, or null
  const float* ms;                  // with w: each row's mean of squares (M,)
  float eps;
  const float* mu;                  // interval: n_seg values each
  const float* var;
  const float* alpha;
  const float* beta;
  int n_seg, cols;                  // cols = sum(blocks)
  int blocks[MAX_SEG];
  int8_t* xq;
  float* sx;
  float* s1;
  float* s2;
  float* lo;                        // (M, cols) each, or null
  float* hi;
  void* y;                          // the normed row, or null
  long long M;
  int K;
};

struct Stats {
  float amax, s1, s2;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// VEC elements of T moved as one access: 16 bytes, or one element.
template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

template <typename T, int VEC>
__device__ __forceinline__ Pack<T, VEC> load(const Pack<T, VEC>* ptr) {
  Pack<T, VEC> p;
  if constexpr (sizeof(Pack<T, VEC>) == 16) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(ptr));
    memcpy(&p, &u, 16);
  } else {
    p = *ptr;
  }
  return p;
}

template <typename T, int VEC>
__device__ __forceinline__ void store(Pack<T, VEC>* ptr, const Pack<T, VEC>& p) {
  if constexpr (sizeof(Pack<T, VEC>) == 16) {
    uint4 u;
    memcpy(&u, &p, 16);
    *reinterpret_cast<uint4*>(ptr) = u;
  } else {
    *ptr = p;
  }
}

__device__ __forceinline__ uint32_t pack4(const int* q) {
  return (q[0] & 0xff) | (q[1] & 0xff) << 8 | (q[2] & 0xff) << 16 |
         static_cast<uint32_t>(q[3] & 0xff) << 24;
}

// VEC int8 codes in one store: 8 bytes for bf16 vectors, 4 for f32 ones.
template <int VEC>
__device__ __forceinline__ void store_codes(int8_t* dst, const int* q) {
  if constexpr (VEC == 8) {
    *reinterpret_cast<uint2*>(dst) = make_uint2(pack4(q), pack4(q + 4));
  } else if constexpr (VEC == 4) {
    *reinterpret_cast<uint32_t*>(dst) = pack4(q);
  } else {
    *dst = static_cast<int8_t>(q[0]);
  }
}

// max(a, b) that returns NaN when either is NaN (PTX max.NaN, sm_80+): the
// row maximum of torch.amax / jnp.max.
__device__ __forceinline__ float max_nan(float a, float b) {
  float d;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

__device__ __forceinline__ Stats warp_stats(Stats s) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    s.amax = max_nan(s.amax, __shfl_xor_sync(0xffffffffu, s.amax, off));
    s.s1 = __fadd_rn(s.s1, __shfl_xor_sync(0xffffffffu, s.s1, off));
    s.s2 = __fadd_rn(s.s2, __shfl_xor_sync(0xffffffffu, s.s2, off));
  }
  return s;
}

// The row's statistics over the CTA, through ``part``: every thread
// returns the same bits.
__device__ __forceinline__ Stats row_stats(Stats s, Stats* part) {
  s = warp_stats(s);
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = s;
  __syncthreads();
  s = part[0];
  for (int i = 1; i < static_cast<int>(blockDim.x >> 5); ++i) {
    const Stats o = part[i];
    s.amax = max_nan(s.amax, o.amax);
    s.s1 = __fadd_rn(s.s1, o.s1);
    s.s2 = __fadd_rn(s.s2, o.s2);
  }
  return s;
}

// torch.clamp_min / clamp_max: a NaN passes through
__device__ __forceinline__ float clamp_min(float v, float lo) { return v < lo ? lo : v; }
__device__ __forceinline__ float clamp_max(float v, float hi) { return v > hi ? hi : v; }

// ref.pdq_interval then ref.grid_extent for segment i, op for op.
__device__ __forceinline__ void grid_extent(const Params& p, int i, float s1, float s2,
                                            float& lo_g, float& hi_g) {
  const float mean = __fmul_rn(p.mu[i], s1);
  const float sigma =
      __fadd_rn(__fsqrt_rn(clamp_min(__fmul_rn(p.var[i], s2), 0.0f)), 1e-8f);
  const float lo = clamp_max(__fsub_rn(mean, __fmul_rn(p.alpha[i], sigma)), 0.0f);
  const float hi = clamp_min(__fadd_rn(mean, __fmul_rn(p.beta[i], sigma)), 0.0f);
  const float s_out = clamp_min(__fdiv_rn(__fsub_rn(hi, lo), 255.0f), 1e-8f);
  const float z = __fsub_rn(-rintf(__fdiv_rn(lo, s_out)), 128.0f);
  lo_g = __fmul_rn(__fsub_rn(-128.0f, z), s_out);
  hi_g = __fmul_rn(__fsub_rn(127.0f, z), s_out);
}

// One row a CTA.  Each thread holds NV packs of VEC elements: pack j of
// the row is vector j * G + g of thread g (consecutive threads on
// consecutive 16-byte chunks).
template <typename T, int VEC, int NV>
__global__ void __launch_bounds__(MAX_THREADS) prologue_kernel(const Params p) {
  using V = Pack<T, VEC>;
  __shared__ Stats part_s[32];
  const long long row = blockIdx.x;
  const int g = threadIdx.x, G = blockDim.x;
  const int nvec = p.K / VEC;
  const V* xr = reinterpret_cast<const V*>(static_cast<const T*>(p.x) + row * p.K);
  const V* wr = static_cast<const V*>(p.w);

  // the row (and the norm weight) in flight together
  V r[NV], wv[NV];
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int v = j * G + g;
    if (v < nvec) {
      r[j] = load(xr + v);
      if (wr != nullptr) wv[j] = load(wr + v);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) r[j].v[e] = from_f32<T>(0.0f);
    }
  }

  if (wr != nullptr) {
    const float rs = rsqrtf(__fadd_rn(p.ms[row], p.eps));
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      if (j * G + g >= nvec) continue;
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        r[j].v[e] = from_f32<T>(__fmul_rn(__fmul_rn(to_f32(r[j].v[e]), rs),
                                          __fadd_rn(1.0f, to_f32(wv[j].v[e]))));
    }
  }

  Stats s{0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int j = 0; j < NV; ++j)
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      const float f = to_f32(r[j].v[e]);
      s.amax = max_nan(s.amax, fabsf(f));
      s.s1 = __fadd_rn(s.s1, f);
      s.s2 = __fadd_rn(s.s2, __fmul_rn(f, f));
    }
  s = row_stats(s, part_s);
  const float sc = __fdiv_rn(max_nan(s.amax, 1e-8f), 127.0f);

  int8_t* qr = p.xq + row * p.K;
  V* yr = p.y == nullptr ? nullptr : reinterpret_cast<V*>(static_cast<T*>(p.y) + row * p.K);
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int v = j * G + g;
    if (v >= nvec) continue;
    int q[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e)
      q[e] = max(-127, min(127, __float2int_rn(__fdiv_rn(to_f32(r[j].v[e]), sc))));
    store_codes<VEC>(qr + static_cast<long long>(v) * VEC, q);
    if (yr != nullptr) store(yr + v, r[j]);
  }
  if (g == 0) {
    p.sx[row] = sc;
    p.s1[row] = s.s1;
    p.s2[row] = s.s2;
  }

  if (p.n_seg > 0) {
    float* lr = p.lo + row * p.cols;
    float* hr = p.hi + row * p.cols;
    for (int c = g; c < p.cols; c += G) {
      int seg = 0, end = p.blocks[0];
      while (c >= end) end += p.blocks[++seg];
      float lo_g, hi_g;
      grid_extent(p, seg, s.s1, s.s2, lo_g, hi_g);
      lr[c] = lo_g;
      hr[c] = hi_g;
    }
  }
}

template <typename T, int VEC, int NV>
cudaError_t run(const Params& p, int n, cudaStream_t st) {
  const int threads = ((n + NV - 1) / NV + 31) / 32 * 32;
  prologue_kernel<T, VEC, NV><<<dim3(static_cast<unsigned>(p.M)), threads, 0, st>>>(p);
  return cudaGetLastError();
}

// The launch for p's rows of K elements in packs of VEC: a CTA a row, each
// thread holding the fewest packs that fit MAX_THREADS threads: one below
// PREFILL_ROWS rows, else two or more.
template <typename T, int VEC>
cudaError_t dispatch(const Params& p, cudaStream_t st) {
  constexpr int max_nv = VEC == 1 ? 32 : 8;
  const int n = p.K / VEC;
  int nv = p.M >= PREFILL_ROWS ? 2 : 1;
  while (nv < max_nv && (n + nv - 1) / nv > MAX_THREADS) nv *= 2;
  if ((n + nv - 1) / nv > MAX_THREADS) return cudaErrorInvalidValue;  // row too long
  switch (nv) {
    case 1: return run<T, VEC, 1>(p, n, st);
    case 2: return run<T, VEC, 2>(p, n, st);
    case 4: return run<T, VEC, 4>(p, n, st);
    case 8: return run<T, VEC, 8>(p, n, st);
    case 16: if constexpr (VEC == 1) return run<T, VEC, 16>(p, n, st); break;
    case 32: if constexpr (VEC == 1) return run<T, VEC, 32>(p, n, st); break;
  }
  return cudaErrorInvalidValue;
}

bool aligned16(const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 16 == 0; }

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Rows are contiguous, K elements each.
// w: the norm weight (K,) of x's type, or null for no norm; ms: with w,
// each row's mean of squares (M,) f32.  n_seg > 0:
// the interval over n_seg segments, mu/var/alpha/beta n_seg floats each on
// the device, blocks[i] columns of lo/hi (M, sum(blocks)) for segment i.
// y: where to write the normed row (x's type), or null.
extern "C" int pdq_prologue_fused(const void* x, int dtype, const void* w, const void* ms,
                                  float eps,
                                  const void* mu, const void* var, const void* alpha,
                                  const void* beta, const int* blocks, int n_seg,
                                  void* xq, void* sx, void* s1, void* s2, void* lo,
                                  void* hi, void* y, long long M, int K, void* stream) {
  if (M <= 0) return 0;
  if (M > INT_MAX || K <= 0 || n_seg < 0 || n_seg > MAX_SEG)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{};
  p.x = x;
  p.w = w;
  p.ms = static_cast<const float*>(ms);
  p.eps = eps;
  p.mu = static_cast<const float*>(mu);
  p.var = static_cast<const float*>(var);
  p.alpha = static_cast<const float*>(alpha);
  p.beta = static_cast<const float*>(beta);
  p.n_seg = n_seg;
  for (int i = 0; i < n_seg; ++i) {
    if (blocks[i] <= 0) return static_cast<int>(cudaErrorInvalidValue);
    p.blocks[i] = blocks[i];
    p.cols += blocks[i];
  }
  p.xq = static_cast<int8_t*>(xq);
  p.sx = static_cast<float*>(sx);
  p.s1 = static_cast<float*>(s1);
  p.s2 = static_cast<float*>(s2);
  p.lo = static_cast<float*>(lo);
  p.hi = static_cast<float*>(hi);
  p.y = y;
  p.M = M;
  p.K = K;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int vec = dtype == 0 ? 4 : 8;
  const bool packed = K % vec == 0 && aligned16(x) && aligned16(w) && aligned16(y) &&
                      reinterpret_cast<uintptr_t>(xq) % vec == 0;
  cudaError_t err;
  if (dtype == 0)
    err = packed ? dispatch<float, 4>(p, st) : dispatch<float, 1>(p, st);
  else
    err = packed ? dispatch<__nv_bfloat16, 8>(p, st)
                 : dispatch<__nv_bfloat16, 1>(p, st);
  return static_cast<int>(err);
}

// The prologue alone (no norm, no interval).
extern "C" int pdq_prologue(const void* x, int dtype, void* xq, void* sx, void* s1,
                            void* s2, long long M, int K, void* stream) {
  return pdq_prologue_fused(x, dtype, nullptr, nullptr, 0.0f, nullptr, nullptr, nullptr, nullptr,
                            nullptr, 0, xq, sx, s1, s2, nullptr, nullptr, nullptr, M, K, stream);
}
