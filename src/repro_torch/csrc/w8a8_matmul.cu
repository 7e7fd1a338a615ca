// W8A8 matmul with the PDQ epilogue, and its fused SwiGLU variant, written
// by hand for Hopper (sm_90a).
//
// w8a8_matmul replaces the Pallas TPU kernel w8a8_matmul_p
// (src/repro/kernels/w8a8_matmul.py:72, pallas_call at :125):
//   y = (x_q @ w_q - z_x * colsum) * (s_x * s_w)     (int32 accumulation)
// then either the `requant` epilogue, int8 on the (s_out, z_out) grid, or
// the `fp_clamp` epilogue, clip to [lo, hi] and cast to f32/bf16.  The
// epilogue operands are per row (epi_cols == 1) or per (row, 128-column
// block) (epi_cols == N/128, indexed by col / 128 whatever the tile is).
// An operand the chosen epilogue does not read is passed as a null pointer
// and never touched: z_x (null means 0, and then colsum is not read either:
// the main path's activations are symmetric), s_out/z_out (read only for
// int8 out) and lo/hi (null means no clamp).
//
// w8a8_swiglu_matmul replaces w8a8_swiglu_matmul_p
// (src/repro/kernels/w8a8_matmul.py:200, pallas_call at :245): the
// fp_clamp per-block product over [gate | up] (P = N/2 columns each), plus
// hsw = silu(gate) * up and w_down's PDQ prologue of hsw (hsw_q, s_x, s1,
// s2), in one launch.
//
// Bound on the H100: bytes at decode (M = 4..8 rows: the weights, 4-23 MB a
// call, are read once and each weight byte does 2*M int8 operations);
// operations at prefill (M up to 2048 rows).  The SwiGLU kernel also moves
// its f32 hsw scratch (written once, read back once: 8 bytes per hsw
// element), which this design needs and the bound does not count.
//
// Design (simple and right first): a block owns a BM x 64 output tile and
// walks K in 64-byte stages through shared memory.  X is staged as packed
// int32 words of 4 consecutive k; W, stored (K, N) row-major, is read with
// 16-byte loads along N and transposed byte-wise into the same packing, so
// the inner loop is __dp4a (4 int8 products into int32, exact).  BM is 16
// for decode-sized M and 64 otherwise.  Ragged M, N and K edges are masked
// in the kernel.  No tensor cores, no TMA, no pipelining yet: those are the
// next kernel's work, and PERF.md records this one's times.
//
// The SwiGLU kernel cannot stage a whole output row the way the TPU kernel
// did (its grid ran in order on one core; here blocks run in parallel in
// no order).  Instead block j owns gate columns [64j, 64j+64) AND the up
// columns P + [64j, 64j+64), with one accumulator each, so silu(g) * u is
// formed in registers.  The gate/up outputs themselves are never stored.
// A row's scale is known only once every block of the row has finished, so
// each block writes its hsw values to an f32 scratch plus per-(row, block)
// partial amax / sum / sum of squares; the last block of a row tile to
// finish (an atomic ticket after __threadfence) reduces the partials in
// fixed column-block order and quantizes hsw from the scratch.  No float
// atomics: s1 and s2 are the same from run to run.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BN = 64;        // output columns per block (per half for SwiGLU)
constexpr int BK = 64;        // k bytes per shared-memory stage
constexpr int KW = BK / 4;    // packed int32 words per stage
constexpr int THREADS = 256;  // 16 column groups x 16 row groups
constexpr int LANE = 128;     // per-block epilogue operands span 128 columns

template <int BM, int NW>
struct Smem {
  int xs[BM][KW + 1];         // xs[r][kw] packs x[m0 + r][k0 + 4kw .. +3]
  int ws[NW][KW][BN];         // ws[t][kw][n] packs w[k0 + 4kw .. +3][col_t + n]
};

// Stage BM rows x BK bytes of x into packed words.  vec_x: rows are 4-byte
// aligned (K % 4 == 0), so an in-range word is one 4-byte load.
template <int BM, int NW>
__device__ __forceinline__ void load_x(Smem<BM, NW>& sm, const int8_t* __restrict__ x,
                                       long long M, int K, long long m0, int k0,
                                       bool vec_x) {
  for (int i = threadIdx.x; i < BM * KW; i += THREADS) {
    const int r = i / KW, kw = i % KW;
    const long long m = m0 + r;
    const int k = k0 + 4 * kw;
    int v = 0;
    if (m < M) {
      const int8_t* p = x + m * K + k;
      if (vec_x && k + 3 < K) {
        v = *reinterpret_cast<const int*>(p);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (k + j < K) v |= static_cast<int>(static_cast<uint8_t>(p[j])) << (8 * j);
      }
    }
    sm.xs[r][kw] = v;
  }
}

// Stage BK rows x 64 columns of w for each of the NW column tiles
// (col[t] .. col[t] + 63, valid below end[t]), transposed into packed
// words: byte kk % 4 of ws[t][kk / 4][n] holds w[k0 + kk][col[t] + n].
// vec_w: rows and tile starts are 16-byte aligned.
template <int BM, int NW>
__device__ __forceinline__ void load_w(Smem<BM, NW>& sm, const int8_t* __restrict__ w,
                                       int K, int N, int k0, const int* col,
                                       const int* end, bool vec_w) {
  constexpr int CHUNKS = BK * (BN / 16);
  for (int i = threadIdx.x; i < NW * CHUNKS; i += THREADS) {
    const int t = i / CHUNKS, rem = i % CHUNKS;
    const int kk = rem / (BN / 16), c = (rem % (BN / 16)) * 16;
    const int k = k0 + kk, n = col[t] + c;
    uint8_t* dst = reinterpret_cast<uint8_t*>(&sm.ws[t][kk / 4][c]) + (kk % 4);
    const int8_t* src = w + static_cast<long long>(k) * N + n;
    if (vec_w && k < K && n + 15 < end[t]) {
      const int4 v = *reinterpret_cast<const int4*>(src);
      const uint8_t* b = reinterpret_cast<const uint8_t*>(&v);
#pragma unroll
      for (int j = 0; j < 16; ++j) dst[4 * j] = b[j];
    } else {
#pragma unroll
      for (int j = 0; j < 16; ++j)
        dst[4 * j] = (k < K && n + j < end[t]) ? static_cast<uint8_t>(src[j]) : 0;
    }
  }
}

// acc[t][i][c] += x row (ty + 16 i) . w column (col[t] + 4 tx + c) over
// all of K.
template <int BM, int NW>
__device__ __forceinline__ void gemm(Smem<BM, NW>& sm, int (&acc)[NW][BM / 16][4],
                                     const int8_t* __restrict__ x,
                                     const int8_t* __restrict__ w, long long M,
                                     int K, int N, long long m0, const int* col,
                                     const int* end, bool vec_x, bool vec_w) {
  constexpr int TM = BM / 16;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int t = 0; t < NW; ++t)
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[t][i][c] = 0;
  for (int k0 = 0; k0 < K; k0 += BK) {
    load_x(sm, x, M, K, m0, k0, vec_x);
    load_w(sm, w, K, N, k0, col, end, vec_w);
    __syncthreads();
#pragma unroll
    for (int kw = 0; kw < KW; ++kw) {
      int a[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = sm.xs[ty + 16 * i][kw];
#pragma unroll
      for (int t = 0; t < NW; ++t) {
        const int4 b = *reinterpret_cast<const int4*>(&sm.ws[t][kw][4 * tx]);
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          acc[t][i][0] = __dp4a(a[i], b.x, acc[t][i][0]);
          acc[t][i][1] = __dp4a(a[i], b.y, acc[t][i][1]);
          acc[t][i][2] = __dp4a(a[i], b.z, acc[t][i][2]);
          acc[t][i][3] = __dp4a(a[i], b.w, acc[t][i][3]);
        }
      }
    }
    __syncthreads();
  }
}

// (acc - z_x colsum) * (s_x s_w) in f32, the plain version's exact sequence;
// zc = z_x * colsum of the column (0 when z_x is null).
__device__ __forceinline__ float dequant(int acc, int zc, float sx, float sw) {
  return __int2float_rn(acc - zc) * (sx * sw);
}

__device__ __forceinline__ int zero_corr(const int* __restrict__ zx,
                                         const int* __restrict__ colsum,
                                         long long m, int n) {
  return zx ? zx[m] * colsum[n] : 0;
}

__device__ __forceinline__ float clip(float y, const float* __restrict__ lo,
                                      const float* __restrict__ hi, long long e) {
  return lo ? fminf(fmaxf(y, lo[e]), hi[e]) : y;
}

// Epilogue store of output element i, epilogue operand cell e.
__device__ __forceinline__ void store(float* out, long long i, float y, const float* so,
                                      const int* zo, const float* lo, const float* hi,
                                      long long e) {
  out[i] = clip(y, lo, hi, e);
}
__device__ __forceinline__ void store(__nv_bfloat16* out, long long i, float y,
                                      const float* so, const int* zo, const float* lo,
                                      const float* hi, long long e) {
  out[i] = __float2bfloat16_rn(clip(y, lo, hi, e));
}
__device__ __forceinline__ void store(int8_t* out, long long i, float y, const float* so,
                                      const int* zo, const float* lo, const float* hi,
                                      long long e) {
  const float q = rintf(y / so[e]) + static_cast<float>(zo[e]);
  out[i] = static_cast<int8_t>(static_cast<int>(fminf(fmaxf(q, -128.f), 127.f)));
}

template <int BM, typename OutT>
__global__ void __launch_bounds__(THREADS)
w8a8_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
            const float* __restrict__ sx, const int* __restrict__ zx,
            const float* __restrict__ sw, const int* __restrict__ colsum,
            const float* __restrict__ so, const int* __restrict__ zo,
            const float* __restrict__ lo, const float* __restrict__ hi,
            OutT* __restrict__ out, long long M, int K, int N, int epi_cols,
            bool vec_x, bool vec_w) {
  __shared__ Smem<BM, 1> sm;
  constexpr int TM = BM / 16;
  const long long m0 = static_cast<long long>(blockIdx.y) * BM;
  const int col[1] = {static_cast<int>(blockIdx.x) * BN};
  const int end[1] = {N};
  int acc[1][TM][4];
  gemm<BM, 1>(sm, acc, x, w, M, K, N, m0, col, end, vec_x, vec_w);

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const long long m = m0 + ty + 16 * i;
    if (m >= M) continue;
    const float sxm = sx[m];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int n = col[0] + 4 * tx + c;
      if (n >= N) continue;
      const long long e = epi_cols == 1 ? m : m * epi_cols + n / LANE;
      const float y = dequant(acc[0][i][c], zero_corr(zx, colsum, m, n), sxm, sw[n]);
      store(out, m * N + n, y, so, zo, lo, hi, e);
    }
  }
}

template <int BM>
__global__ void __launch_bounds__(THREADS)
swiglu_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
              const float* __restrict__ sx, const int* __restrict__ zx,
              const float* __restrict__ sw, const int* __restrict__ colsum,
              const float* __restrict__ lo, const float* __restrict__ hi,
              float* __restrict__ hsw,
              int8_t* __restrict__ hsw_q, float* __restrict__ osx,
              float* __restrict__ os1, float* __restrict__ os2,
              float* __restrict__ part, int* __restrict__ tickets, long long M,
              int K, int N, bool vec_x, bool vec_w) {
  __shared__ Smem<BM, 2> sm;
  __shared__ int is_last;
  __shared__ float srow[BM];
  constexpr int TM = BM / 16;
  const int P = N / 2, nb = N / LANE, nj = gridDim.x, j = blockIdx.x;
  const long long m0 = static_cast<long long>(blockIdx.y) * BM;
  const int col[2] = {j * BN, P + j * BN};
  const int end[2] = {P, N};
  int acc[2][TM][4];
  gemm<BM, 2>(sm, acc, x, w, M, K, N, m0, col, end, vec_x, vec_w);

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const long long m = m0 + ty + 16 * i;
    const bool row_ok = m < M;
    float amax = 0.f, t1 = 0.f, t2 = 0.f;
    if (row_ok) {
      const float sxm = sx[m];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int n = col[0] + 4 * tx + c;
        if (n >= P) continue;
        const int nu = P + n;
        const long long eg = m * nb + n / LANE, eu = m * nb + nu / LANE;
        const float g = clip(dequant(acc[0][i][c], zero_corr(zx, colsum, m, n), sxm,
                                     sw[n]), lo, hi, eg);
        const float u = clip(dequant(acc[1][i][c], zero_corr(zx, colsum, m, nu), sxm,
                                     sw[nu]), lo, hi, eu);
        const float h = g / (1.0f + expf(-g)) * u;
        hsw[m * P + n] = h;
        amax = fmaxf(amax, fabsf(h));
        t1 += h;
        t2 = __fadd_rn(t2, __fmul_rn(h, h));
      }
    }
    // the 16 threads of a row are lanes 0-15 or 16-31 of one warp
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) {
      amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
      t1 += __shfl_xor_sync(0xffffffffu, t1, off);
      t2 += __shfl_xor_sync(0xffffffffu, t2, off);
    }
    if (row_ok && tx == 0) {
      float* p = part + (m * nj + j) * 3;
      p[0] = amax;
      p[1] = t1;
      p[2] = t2;
    }
  }

  // last block of this row tile: reduce partials in column-block order
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) is_last = atomicAdd(&tickets[blockIdx.y], 1) == nj - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  if (threadIdx.x < BM) {
    const long long m = m0 + threadIdx.x;
    if (m < M) {
      float amax = 0.f, t1 = 0.f, t2 = 0.f;
      for (int jj = 0; jj < nj; ++jj) {
        const float* p = part + (m * nj + jj) * 3;
        amax = fmaxf(amax, __ldcg(p));
        t1 += __ldcg(p + 1);
        t2 += __ldcg(p + 2);
      }
      const float sc = fmaxf(amax, 1e-8f) / 127.0f;
      srow[threadIdx.x] = sc;
      osx[m] = sc;
      os1[m] = t1;
      os2[m] = t2;
    }
  }
  __syncthreads();
  for (int r = 0; r < BM; ++r) {
    const long long m = m0 + r;
    if (m >= M) break;
    const float sc = srow[r];
    for (int c = threadIdx.x; c < P; c += THREADS) {
      const int q = __float2int_rn(__ldcg(hsw + m * P + c) / sc);
      hsw_q[m * P + c] = static_cast<int8_t>(max(-127, min(127, q)));
    }
  }
}

template <typename T>
const T* cp(const void* p) { return static_cast<const T*>(p); }

bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

template <int BM, typename OutT>
void launch_w8a8(const void* x, const void* w, const void* sx, const void* zx,
                 const void* sw, const void* colsum, const void* so,
                 const void* zo, const void* lo, const void* hi, void* out,
                 long long M, int K, int N, int epi_cols, cudaStream_t st) {
  const dim3 grid((N + BN - 1) / BN, static_cast<unsigned>((M + BM - 1) / BM));
  const bool vec_x = K % 4 == 0 && aligned(x, 4);
  const bool vec_w = N % 16 == 0 && aligned(w, 16);
  w8a8_kernel<BM, OutT><<<grid, THREADS, 0, st>>>(
      cp<int8_t>(x), cp<int8_t>(w), cp<float>(sx), cp<int>(zx), cp<float>(sw),
      cp<int>(colsum), cp<float>(so), cp<int>(zo), cp<float>(lo), cp<float>(hi),
      static_cast<OutT*>(out), M, K, N, epi_cols, vec_x, vec_w);
}

template <typename OutT>
void dispatch_w8a8(const void* x, const void* w, const void* sx, const void* zx,
                   const void* sw, const void* colsum, const void* so,
                   const void* zo, const void* lo, const void* hi, void* out,
                   long long M, int K, int N, int epi_cols, cudaStream_t st) {
  if (M <= 16)
    launch_w8a8<16, OutT>(x, w, sx, zx, sw, colsum, so, zo, lo, hi, out, M, K, N,
                          epi_cols, st);
  else
    launch_w8a8<64, OutT>(x, w, sx, zx, sw, colsum, so, zo, lo, hi, out, M, K, N,
                          epi_cols, st);
}

template <int BM>
void launch_swiglu(const void* x, const void* w, const void* sx, const void* zx,
                   const void* sw, const void* colsum, const void* lo,
                   const void* hi, void* hsw, void* hsw_q, void* osx,
                   void* os1, void* os2, void* part, void* tickets, long long M,
                   int K, int N, cudaStream_t st) {
  const int P = N / 2;
  const dim3 grid((P + BN - 1) / BN, static_cast<unsigned>((M + BM - 1) / BM));
  const bool vec_x = K % 4 == 0 && aligned(x, 4);
  const bool vec_w = N % 16 == 0 && P % 16 == 0 && aligned(w, 16);
  swiglu_kernel<BM><<<grid, THREADS, 0, st>>>(
      cp<int8_t>(x), cp<int8_t>(w), cp<float>(sx), cp<int>(zx), cp<float>(sw),
      cp<int>(colsum), cp<float>(lo), cp<float>(hi), static_cast<float*>(hsw), static_cast<int8_t*>(hsw_q),
      static_cast<float*>(osx), static_cast<float*>(os1), static_cast<float*>(os2),
      static_cast<float*>(part), static_cast<int*>(tickets), M, K, N, vec_x, vec_w);
}

}  // namespace

// out_kind: 0 = float32 out, 1 = bfloat16 out, 2 = int8 out (requant on
// so/zo).  Epilogue operands are (M, epi_cols).  May be null: zx (zero,
// and then colsum may be null too), so/zo for fp outs, lo/hi (no clamp).
extern "C" int w8a8_matmul(const void* x, const void* w, const void* sx,
                           const void* zx, const void* sw, const void* colsum,
                           const void* so, const void* zo, const void* lo,
                           const void* hi, void* out, int out_kind, long long M,
                           int K, int N, int epi_cols, void* stream) {
  if (M <= 0 || N <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (out_kind == 0)
    dispatch_w8a8<float>(x, w, sx, zx, sw, colsum, so, zo, lo, hi, out, M, K, N,
                         epi_cols, st);
  else if (out_kind == 1)
    dispatch_w8a8<__nv_bfloat16>(x, w, sx, zx, sw, colsum, so, zo, lo, hi, out, M,
                                 K, N, epi_cols, st);
  else
    dispatch_w8a8<int8_t>(x, w, sx, zx, sw, colsum, so, zo, lo, hi, out, M, K, N,
                          epi_cols, st);
  return static_cast<int>(cudaGetLastError());
}

// lo/hi: (M, N/128).  zx may be null (zero; colsum may then be null).
// hsw: (M, P) f32 and part: (M, ceil(P/64), 3) f32 scratch.  tickets:
// (ceil(M/BM),) int32, zero on entry; BM is 16 when M <= 16, else 64.
extern "C" int w8a8_swiglu_matmul(const void* x, const void* w, const void* sx,
                                  const void* zx, const void* sw,
                                  const void* colsum, const void* lo,
                                  const void* hi, void* hsw,
                                  void* hsw_q, void* osx, void* os1, void* os2,
                                  void* part, void* tickets, long long M, int K,
                                  int N, void* stream) {
  if (M <= 0 || N <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M <= 16)
    launch_swiglu<16>(x, w, sx, zx, sw, colsum, lo, hi, hsw, hsw_q, osx, os1, os2,
                      part, tickets, M, K, N, st);
  else
    launch_swiglu<64>(x, w, sx, zx, sw, colsum, lo, hi, hsw, hsw_q, osx, os1, os2,
                      part, tickets, M, K, N, st);
  return static_cast<int>(cudaGetLastError());
}
