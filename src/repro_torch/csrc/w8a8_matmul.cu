// W8A8 matmul with the PDQ epilogue (K2), and its fused SwiGLU variant
// (K3), written by hand for Hopper (sm_90a).
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
// The weight w_q (K, N) is stored K-major: an (N, K) row-major array, each
// output column's K codes contiguous (models/linops.py keeps the records'
// logical (K, N) shape as a transposed view).  That is the layout Hopper's
// integer wgmma reads both operands in.
//
// Bound on the H100: bytes at decode (M = 4..8 rows: the weights, 4-23 MB a
// call, are read once and each weight byte does 2*M int8 operations);
// operations at prefill (M up to 2048 rows, 26-48 us at 1979 TOP/s).  K3
// also moves its f32 hsw scratch (written once, read back once: 92 MB at
// 2048 rows, past the 50 MB L2), which its design needs and the bound does
// not count.
//
// Two routes, chosen by the wrapper (kernels/w8a8_matmul.py route_for) from
// the operands' shapes and addresses alone, never after a failure:
//
// * wgmma (K % 16 == 0, 16-byte aligned bases, K-major w): the main path.
//   TMA loads 128-byte K stages of both operands, with the 128-byte
//   swizzle, into a ring of shared-memory stages guarded by mbarriers; one
//   producer warp keeps the ring full while two consumer warpgroups run
//   wgmma.mma_async m64nNk32 .s32.s8.s8 on the stages that have landed.
//   Blocks are persistent (one per SM): each walks work items blockIdx.x,
//   + gridDim.x, ..., and the producer runs ahead into the next item while
//   the consumers finish the current one's epilogue.  Two orientations:
//   - prefill (M > 64): A = a 128-row tile of x, B = 128 weight rows
//     (output columns; 128 gate + 128 up for K3).  Items are ordered with
//     the row tile outermost, so the blocks in flight share x rows and
//     the weights stay in the 50 MB L2.  Bound by operations on paper; a
//     128 x 128 tile does 128 operations per byte it loads from L2 and
//     reaches 15-20% of the int8 peak (PERF.md).
//   - decode (M <= 64), swap-AB: A = 64 weight rows per warpgroup (the
//     output columns), B = x with n = M rounded up to 8, 16, 32 or 64.
//     Bound by the weight bytes: K is split so that enough items exist to
//     keep every SM streaming (the plan is computed by the wrapper,
//     kernels/w8a8_matmul.py wgmma_plan).  Each split adds its exact int32
//     partial to an int32 workspace with atomicAdd (the same sum in any
//     order); the last split of a column tile (an atomic ticket) takes the
//     totals back with atomicExch, which also zeroes the workspace, resets
//     its ticket and runs the epilogue, so the buffers are zeroed once per
//     device and never per call.  z_x * colsum is subtracted there, once.
//   The epilogues are the generic route's arithmetic on the wgmma
//   accumulator fragment (transposed under swap-AB), so both routes give
//   the same bits.  At prefill they load each row's operands once and
//   store neighbouring column pairs with one vector store; K2's out_kind is
//   a template parameter, so an instance holds one epilogue's code.  The
//   epilogue runs on the consumer warpgroups between items, with the
//   tensor cores idle: at prefill it, not the main loop, is most of the
//   time (PERF.md).
// * generic (any K, any alignment): the first kernel of this port, kept for
//   shapes TMA cannot describe.  A block owns a BM x 64 output tile and
//   walks K in 64-byte stages through shared memory as packed int32 words
//   of 4 consecutive k (one 4-byte load when K % 4 == 0), with __dp4a on
//   the CUDA cores.  BM is 16 for decode-sized M and 64 otherwise.  Ragged
//   M, N and K edges are masked in the kernel.
//
// K3 cannot stage a whole output row the way the TPU kernel did (its grid
// ran in order on one core).  A block owns gate columns [c, c+BN) AND the
// up columns P + [c, c+BN), with one accumulator each, so silu(g) * u is
// formed in registers; the gate/up outputs are never stored.  A row's
// scale is known only once every column block of the row has finished, so
// each block writes its hsw values to an f32 scratch plus per-(row, column
// block) partial amax / sum / sum of squares, reduced in fixed column-block
// order (no float atomics: s1 and s2 are the same from run to run).
// - wgmma route: a cooperative launch of at most one wave.  Phase 1 runs
//   the GEMM items; a grid-wide barrier; every row's scale, one warp a row;
//   a second barrier; then the whole grid streams hsw into hsw_q.
// - generic route: the last block of a row tile (an atomic ticket, reset
//   by that block) reduces the partials and quantizes the row tile.
#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int LANE = 128;     // per-block epilogue operands span 128 columns

// ------------------------------------------------ epilogue arithmetic (both)

// (acc - z_x colsum) * (s_x s_w) in f32, the plain version's exact sequence;
// zc = z_x * colsum of the column (0 when z_x is null).
__device__ __forceinline__ float dequant(int acc, int zc, float sx, float sw) {
  return __int2float_rn(acc - zc) * (sx * sw);
}

__device__ __forceinline__ int zero_corr(const int* __restrict__ zx,
                                         const int* __restrict__ colsum,
                                         long long m, int n) {
  return zx ? __ldg(zx + m) * __ldg(colsum + n) : 0;
}

__device__ __forceinline__ float clip(float y, const float* __restrict__ lo,
                                      const float* __restrict__ hi, long long e) {
  return lo ? fminf(fmaxf(y, __ldg(lo + e)), __ldg(hi + e)) : y;
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
  const float q = rintf(y / __ldg(so + e)) + static_cast<float>(__ldg(zo + e));
  out[i] = static_cast<int8_t>(static_cast<int>(fminf(fmaxf(q, -128.f), 127.f)));
}

// hsw = silu(g) * u as the plain version writes it.
__device__ __forceinline__ float silu_mul(float g, float u) {
  return g / (1.0f + expf(-g)) * u;
}

template <typename T>
const T* cp(const void* p) { return static_cast<const T*>(p); }

bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// ================================================================ generic

namespace generic {

constexpr int BN = 64;        // output columns per block (per half for SwiGLU)
constexpr int BK = 64;        // k bytes per shared-memory stage
constexpr int KW = BK / 4;    // packed int32 words per stage
constexpr int THREADS = 256;  // 16 column groups x 16 row groups

template <int BM, int NW>
struct Smem {
  int xs[BM][KW + 1];         // xs[r][kw] packs x[m0 + r][k0 + 4kw .. +3]
  int ws[NW][KW][BN];         // ws[t][kw][n] packs w[k0 + 4kw .. +3][col_t + n]
};

// Word kw of row r of a K-major (rows, K) int8 array, 4 consecutive k packed
// little-endian, zero past K.  vec: rows are 4-byte aligned (K % 4 == 0).
__device__ __forceinline__ int load_word(const int8_t* __restrict__ row, int K, int k,
                                         bool vec) {
  if (vec && k + 3 < K) return *reinterpret_cast<const int*>(row + k);
  int v = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (k + j < K) v |= static_cast<int>(static_cast<uint8_t>(row[k + j])) << (8 * j);
  return v;
}

// Stage BM rows x BK bytes of x into packed words.
template <int BM, int NW>
__device__ __forceinline__ void load_x(Smem<BM, NW>& sm, const int8_t* __restrict__ x,
                                       long long M, int K, long long m0, int k0,
                                       bool vec) {
  for (int i = threadIdx.x; i < BM * KW; i += THREADS) {
    const int r = i / KW, kw = i % KW;
    const long long m = m0 + r;
    sm.xs[r][kw] = m < M ? load_word(x + m * K, K, k0 + 4 * kw, vec) : 0;
  }
}

// Stage BK bytes of 64 weight columns for each of the NW column tiles
// (col[t] .. col[t] + 63, valid below end[t]); w is K-major, so a packed
// word is 4 consecutive bytes of one column.  Neighbouring threads take
// neighbouring columns: conflict-free shared-memory stores.
template <int BM, int NW>
__device__ __forceinline__ void load_w(Smem<BM, NW>& sm, const int8_t* __restrict__ w,
                                       int K, int k0, const int* col, const int* end,
                                       bool vec) {
  for (int i = threadIdx.x; i < NW * KW * BN; i += THREADS) {
    const int t = i / (KW * BN), rem = i % (KW * BN);
    const int kw = rem / BN, n = rem % BN;
    const int c = col[t] + n;
    sm.ws[t][kw][n] =
        c < end[t] ? load_word(w + static_cast<long long>(c) * K, K, k0 + 4 * kw, vec) : 0;
  }
}

// acc[t][i][c] += x row (ty + 16 i) . w column (col[t] + 4 tx + c) over
// all of K.
template <int BM, int NW>
__device__ __forceinline__ void gemm(Smem<BM, NW>& sm, int (&acc)[NW][BM / 16][4],
                                     const int8_t* __restrict__ x,
                                     const int8_t* __restrict__ w, long long M,
                                     int K, long long m0, const int* col,
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
    load_w(sm, w, K, k0, col, end, vec_w);
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
  gemm<BM, 1>(sm, acc, x, w, M, K, m0, col, end, vec_x, vec_w);

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
  gemm<BM, 2>(sm, acc, x, w, M, K, m0, col, end, vec_x, vec_w);

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
        const float h = silu_mul(g, u);
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

  // last block of this row tile: reduce partials in column-block order,
  // and return the ticket to 0 for the next launch
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) is_last = atomicAdd(&tickets[blockIdx.y], 1) == nj - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  if (threadIdx.x == 0) atomicExch(&tickets[blockIdx.y], 0);
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

template <int BM, typename OutT>
void launch_w8a8(const void* x, const void* w, const void* sx, const void* zx,
                 const void* sw, const void* colsum, const void* so,
                 const void* zo, const void* lo, const void* hi, void* out,
                 long long M, int K, int N, int epi_cols, cudaStream_t st) {
  const dim3 grid((N + BN - 1) / BN, static_cast<unsigned>((M + BM - 1) / BM));
  const bool vec_x = K % 4 == 0 && aligned(x, 4);
  const bool vec_w = K % 4 == 0 && aligned(w, 4);
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
  const bool vec_w = K % 4 == 0 && aligned(w, 4);
  swiglu_kernel<BM><<<grid, THREADS, 0, st>>>(
      cp<int8_t>(x), cp<int8_t>(w), cp<float>(sx), cp<int>(zx), cp<float>(sw),
      cp<int>(colsum), cp<float>(lo), cp<float>(hi), static_cast<float*>(hsw),
      static_cast<int8_t*>(hsw_q), static_cast<float*>(osx), static_cast<float*>(os1),
      static_cast<float*>(os2), static_cast<float*>(part), static_cast<int*>(tickets),
      M, K, N, vec_x, vec_w);
}

}  // namespace generic

// ================================================================= wgmma

namespace wg {

constexpr int KB = 128;            // k bytes per stage: 4 wgmma k32 steps
constexpr int CT = 128;            // output columns per item (per half for K3)
constexpr int BM = 128;            // x rows per item at prefill (2 x m64)
constexpr int CONSUMERS = 256;     // two consumer warpgroups
constexpr int THREADS = CONSUMERS + 32;  // + the producer warp
constexpr int SMEM_BUDGET = 200 * 1024;
constexpr int MAX_STAGES = 8;
// the ticket buffer: one ticket per column tile, then the grid barrier
constexpr int BAR_COUNT = 4096, BAR_GEN = 4097;

// Tile geometry of one instance: SWAP is the decode orientation (weights
// as the A operand), H the halves of 128 weight rows (2: K3's gate and up
// columns), T the token rows of the B operand under SWAP.
template <bool SWAP, bool SWIGLU, int T>
struct Tile {
  static constexpr int H = SWIGLU ? 2 : 1;
  static constexpr int A_ROWS = SWAP ? CT * H : BM;
  static constexpr int B_ROWS = SWAP ? T : CT * H;
  static constexpr int A_BYTES = A_ROWS * KB;
  static constexpr int STAGE = (A_ROWS + B_ROWS) * KB;      // a multiple of 1024
  static constexpr int STAGES =
      SMEM_BUDGET / STAGE < MAX_STAGES ? SMEM_BUDGET / STAGE : MAX_STAGES;
  static constexpr int MMA_N = SWAP ? T : CT;                // wgmma n
  static constexpr int NACC = MMA_N / 2;                     // s32 registers
  static constexpr int SMEM = STAGES * STAGE + 1024;         // + 1024-B alignment
};

struct Args {
  const float* sx;
  const int* zx;
  const float* sw;
  const int* colsum;
  const float* so;
  const int* zo;
  const float* lo;
  const float* hi;
  void* out;              // K2's output, out_kind 0 f32, 1 bf16, 2 int8
  float* hsw;             // K3's outputs and scratch
  int8_t* hsw_q;
  float* osx;
  float* os1;
  float* os2;
  float* part;
  int* ws;                // split-K int32 workspace, zero at rest
  int* tickets;           // per-column-tile tickets + grid barrier, zero at rest
  long long* stamps;      // K3, optional: per block, ns at the end of phase 1, 2
  int M, K, N, epi_cols, out_kind;
  int col_tiles, nks, kc, splits, items;
};

// ---- PTX wrappers: mbarriers, TMA, wgmma

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
               "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

// A wait that outlives SPIN_NS traps: a fault ends the launch with an
// error instead of hanging the card.
constexpr unsigned long long SPIN_NS = 10000000000ull;

__device__ __forceinline__ unsigned long long now_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ bool mbar_try(uint32_t bar, uint32_t parity) {
  uint32_t ok;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.b32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(ok)
      : "r"(bar), "r"(parity)
      : "memory");
  return ok != 0;
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try(bar, parity)) return;
  const unsigned long long t0 = now_ns();
  while (!mbar_try(bar, parity))
    if (now_ns() - t0 > SPIN_NS) __trap();
}

// TMA: the box at (inner k, row) of a 2-D map into shared memory, completing
// its bytes on the mbarrier.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int k,
                                         int row, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];" ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)),
      "r"(k), "r"(row), "r"(bar) : "memory");
}

// wgmma shared-memory descriptor of a K-major tile of 128-byte rows with the
// 128-byte swizzle: 8-row groups 1024 bytes apart (stride byte offset), the
// leading byte offset unused, layout type 1 (bits 62-63).
__device__ __forceinline__ uint64_t desc(uint32_t saddr) {
  return static_cast<uint64_t>((saddr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// the two consumer warpgroups only (named barrier 1)
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(CONSUMERS) : "memory");
}

// D (64 x N, s32) += A (64 x 32, s8, K-major) . B (N x 32, s8, K-major)^T
template <int N> struct Mma;
template <> struct Mma<8> {
  __device__ static void run(int (&d)[4], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k32.s32.s8.s8 "
        "{%0, %1, %2, %3}, "
        "%4, %5, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
        : "l"(a), "l"(b), "r"(1));
  }
};
template <> struct Mma<16> {
  __device__ static void run(int (&d)[8], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, "
        "%8, %9, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7])
        : "l"(a), "l"(b), "r"(1));
  }
};
template <> struct Mma<32> {
  __device__ static void run(int (&d)[16], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "%16, %17, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
          "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
        : "l"(a), "l"(b), "r"(1));
  }
};
template <> struct Mma<64> {
  __device__ static void run(int (&d)[32], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
          "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
          "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
        : "l"(a), "l"(b), "r"(1));
  }
};
template <> struct Mma<128> {
  __device__ static void run(int (&d)[64], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
          "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
          "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
          "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
          "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
          "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
          "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
        : "l"(a), "l"(b), "r"(1));
  }
};

// Accumulator register r of this thread in the m64nN fragment: row ra
// (0..63) and column rb (0..N-1).
__device__ __forceinline__ void frag(int r, int& ra, int& rb) {
  const int w = (threadIdx.x % 128) / 32, l = threadIdx.x % 32;
  ra = 16 * w + l / 4 + 8 * ((r >> 1) & 1);
  rb = 8 * (r >> 2) + 2 * (l % 4) + (r & 1);
}

// The first weight row of half h of column tile ct (K3: gate, then up).
__device__ __forceinline__ int half_row(int h, int ct, int P) {
  return h * P + ct * CT;
}

// Output row m (of x) and column n of register r of warpgroup wgi in row
// tile rt, for a half whose first column is col0 (K3: the gate column; its
// up column is P + n).
template <bool SWAP>
__device__ __forceinline__ void coords(int r, int wgi, int rt, int col0, long long& m,
                                       int& n) {
  int ra, rb;
  frag(r, ra, rb);
  if constexpr (SWAP) {
    n = col0 + 64 * wgi + ra;
    m = rb;
  } else {
    m = static_cast<long long>(rt) * BM + 64 * wgi + ra;
    n = col0 + rb;
  }
}

template <bool SWAP>
__device__ __forceinline__ void item_range(const Args& a, int item, int& rt, int& ct,
                                           int& ks0, int& ks1) {
  if constexpr (SWAP) {
    ct = item / a.splits;
    rt = 0;
    ks0 = (item % a.splits) * a.kc;
    ks1 = min(a.nks, ks0 + a.kc);
  } else {
    rt = item / a.col_tiles;
    ct = item % a.col_tiles;
    ks0 = 0;
    ks1 = a.nks;
  }
}

// K2's output types by out_kind: 0 f32, 1 bf16, 2 int8 (requant)
template <int KIND> struct Out;
template <> struct Out<0> { using T = float; };
template <> struct Out<1> { using T = __nv_bfloat16; };
template <> struct Out<2> { using T = int8_t; };

template <int KIND>
__device__ __forceinline__ void store_any(const Args& a, long long i, float y,
                                          long long e) {
  store(static_cast<typename Out<KIND>::T*>(a.out), i, y, a.so, a.zo, a.lo, a.hi, e);
}

// The epilogue operands of one output row, loaded once a row: s_x, z_x
// and the row's (lo, hi) or (s_out, z_out) cell e (at prefill a thread's
// columns all lie in one 128-column block, so the cell is the row's).
struct RowOps {
  float sx, lo, hi, so;
  int zx, zo;
};

// REQUANT false: the clamp epilogue only (s_out, z_out left unread)
template <bool REQUANT = true>
__device__ __forceinline__ RowOps row_ops(const Args& a, long long m, long long e) {
  RowOps o;
  o.sx = __ldg(a.sx + m);
  o.zx = a.zx ? __ldg(a.zx + m) : 0;
  o.lo = a.lo ? __ldg(a.lo + e) : 0.f;
  o.hi = a.lo ? __ldg(a.hi + e) : 0.f;
  o.so = REQUANT && a.so ? __ldg(a.so + e) : 1.f;
  o.zo = REQUANT && a.so ? __ldg(a.zo + e) : 0;
  return o;
}

// y of column n (scale swn), clipped when the epilogue clamps; the generic
// route's arithmetic (dequant, clip, store) on values instead of pointers
__device__ __forceinline__ float y_of(const Args& a, const RowOps& o, int acc, int n,
                                      float swn) {
  const float y = dequant(acc, a.zx ? o.zx * __ldg(a.colsum + n) : 0, o.sx, swn);
  return a.lo ? fminf(fmaxf(y, o.lo), o.hi) : y;
}

__device__ __forceinline__ int8_t requant(const RowOps& o, float y) {
  const float q = rintf(y / o.so) + static_cast<float>(o.zo);
  return static_cast<int8_t>(static_cast<int>(fminf(fmaxf(q, -128.f), 127.f)));
}

// K2's outputs n and n + 1 (n even) of row m: one vector store when both
// lie in the row and N is even (the pair is then aligned to its size).
template <int KIND>
__device__ __forceinline__ void store_pair(const Args& a, const RowOps& o, long long m,
                                           int n, int acc0, int acc1, float sw0, float sw1) {
  if (n >= a.N) return;
  const bool two = n + 1 < a.N, vec = two && a.N % 2 == 0;
  const float y0 = y_of(a, o, acc0, n, sw0), y1 = two ? y_of(a, o, acc1, n + 1, sw1) : 0.f;
  const long long i = m * a.N + n;
  if constexpr (KIND == 0) {
    float* out = static_cast<float*>(a.out);
    if (vec) {
      *reinterpret_cast<float2*>(out + i) = make_float2(y0, y1);
    } else {
      out[i] = y0;
      if (two) out[i + 1] = y1;
    }
  } else if constexpr (KIND == 1) {
    __nv_bfloat16* out = static_cast<__nv_bfloat16*>(a.out);
    const __nv_bfloat16 v0 = __float2bfloat16_rn(y0), v1 = __float2bfloat16_rn(y1);
    if (vec) {
      *reinterpret_cast<__nv_bfloat162*>(out + i) = __halves2bfloat162(v0, v1);
    } else {
      out[i] = v0;
      if (two) out[i + 1] = v1;
    }
  } else {
    int8_t* out = static_cast<int8_t*>(a.out);
    const int8_t v0 = requant(o, y0), v1 = requant(o, y1);
    if (vec) {
      *reinterpret_cast<char2*>(out + i) = make_char2(v0, v1);
    } else {
      out[i] = v0;
      if (two) out[i + 1] = v1;
    }
  }
}

// A grid-wide barrier for a cooperative launch, left at rest (count 0) for
// the next launch: the last block to arrive resets the count and moves the
// generation on.
__device__ void grid_sync(int* tickets) {
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned* count = reinterpret_cast<unsigned*>(tickets + BAR_COUNT);
    unsigned* gen = reinterpret_cast<unsigned*>(tickets + BAR_GEN);
    const unsigned g = atomicAdd(gen, 0u);
    __threadfence();
    if (atomicAdd(count, 1u) == gridDim.x - 1) {
      atomicExch(count, 0u);
      __threadfence();
      atomicAdd(gen, 1u);
    } else {
      const unsigned long long t0 = now_ns();
      while (atomicAdd(gen, 0u) == g) {
        __nanosleep(64);
        if (now_ns() - t0 > SPIN_NS) __trap();
      }
    }
    __threadfence();
  }
  __syncthreads();
}

// KIND: K2's out_kind (a template, so that an instance holds one epilogue's
// code); 0 for K3.
template <bool SWAP, bool SWIGLU, int T, int KIND>
__global__ void __launch_bounds__(THREADS, 1)
gemm_kernel(const __grid_constant__ CUtensorMap tmx, const __grid_constant__ CUtensorMap tmw,
            const Args a) {
  using G = Tile<SWAP, SWIGLU, T>;
  constexpr int H = G::H, NACC = G::NACC, STAGES = G::STAGES;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[STAGES], empty[STAGES];
  __shared__ int s_last;
  // K3 decode: per-warp row partials of a tile, [warp][token][3]
  __shared__ float red[SWAP && SWIGLU ? 8 : 1][SWAP && SWIGLU ? T : 1][3];

  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;   // swizzle atoms
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int P = a.N / 2;                 // K3's half width
  const int cols = SWIGLU ? P : a.N;     // output columns of one half

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(smem_u32(&full[s]), 1);
      mbar_init(smem_u32(&empty[s]), CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  }
  __syncthreads();

  if (warp == CONSUMERS / 32) {
    // ---- producer: one thread keeps the ring full
    if (lane == 0) {
      asm volatile("prefetch.tensormap [%0];" ::"l"(reinterpret_cast<uint64_t>(&tmx)));
      asm volatile("prefetch.tensormap [%0];" ::"l"(reinterpret_cast<uint64_t>(&tmw)));
      int s = 0;
      uint32_t ph = 0;
      for (int item = blockIdx.x; item < a.items; item += gridDim.x) {
        int rt, ct, ks0, ks1;
        item_range<SWAP>(a, item, rt, ct, ks0, ks1);
        for (int ks = ks0; ks < ks1; ++ks) {
          const uint32_t fb = smem_u32(&full[s]);
          mbar_wait(smem_u32(&empty[s]), ph ^ 1);
          mbar_expect_tx(fb, G::STAGE);
          const uint32_t sa = base + s * G::STAGE, sb = sa + G::A_BYTES;
          const int k = ks * KB;
          // the weight halves go to A under swap-AB, else to B
          const uint32_t wdst = SWAP ? sa : sb;
#pragma unroll
          for (int h = 0; h < H; ++h)
            tma_load(wdst + h * CT * KB, &tmw, k, half_row(h, ct, P), fb);
          tma_load(SWAP ? sb : sa, &tmx, k, SWAP ? 0 : rt * BM, fb);
          if (++s == STAGES) {
            s = 0;
            ph ^= 1;
          }
        }
      }
    }
    __syncwarp();
  } else {
    // ---- consumers: warpgroup wgi owns 64 rows of the A operand
    const int wgi = threadIdx.x / 128;
    int s = 0;
    uint32_t ph = 0;
    for (int item = blockIdx.x; item < a.items; item += gridDim.x) {
      int rt, ct, ks0, ks1;
      item_range<SWAP>(a, item, rt, ct, ks0, ks1);
      int acc[H][NACC];
#pragma unroll
      for (int h = 0; h < H; ++h)
#pragma unroll
        for (int r = 0; r < NACC; ++r) acc[h][r] = 0;
      int prev = -1;
      for (int ks = ks0; ks < ks1; ++ks) {
        mbar_wait(smem_u32(&full[s]), ph);
        const uint32_t sa = base + s * G::STAGE, sb = sa + G::A_BYTES;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < KB / 32; ++kk) {
#pragma unroll
          for (int h = 0; h < H; ++h) {
            const uint32_t ad = SWAP ? sa + (h * CT + 64 * wgi) * KB : sa + 64 * wgi * KB;
            const uint32_t bd = SWAP ? sb : sb + h * CT * KB;
            Mma<G::MMA_N>::run(acc[h], desc(ad + 32 * kk), desc(bd + 32 * kk));
          }
        }
        wgmma_commit();
        // keep this stage's products in flight; the previous stage's are
        // done, so its slot goes back to the producer
        wgmma_wait<1>();
        if (prev >= 0) mbar_arrive(smem_u32(&empty[prev]));
        prev = s;
        if (++s == STAGES) {
          s = 0;
          ph ^= 1;
        }
      }
      wgmma_wait<0>();
      mbar_arrive(smem_u32(&empty[prev]));

      if constexpr (SWAP) if (a.splits > 1) {
        // split K: add this split's exact partial; the last split of the
        // column tile takes the totals back and zeroes the workspace
#pragma unroll
        for (int h = 0; h < H; ++h)
#pragma unroll
          for (int r = 0; r < NACC; ++r) {
            long long m;
            int n;
            coords<SWAP>(r, wgi, rt, ct * CT, m, n);
            if (m < a.M && n < cols) atomicAdd(&a.ws[m * a.N + h * P + n], acc[h][r]);
          }
        __threadfence();
        consumer_sync();
        if (threadIdx.x == 0) s_last = atomicAdd(&a.tickets[ct], 1) == a.splits - 1;
        consumer_sync();
        if (!s_last) continue;
        __threadfence();
#pragma unroll
        for (int h = 0; h < H; ++h)
#pragma unroll
          for (int r = 0; r < NACC; ++r) {
            long long m;
            int n;
            coords<SWAP>(r, wgi, rt, ct * CT, m, n);
            acc[h][r] = (m < a.M && n < cols) ? atomicExch(&a.ws[m * a.N + h * P + n], 0) : 0;
          }
        if (threadIdx.x == 0) atomicExch(&a.tickets[ct], 0);
      }

      if constexpr (!SWIGLU) {
        // ---- K2 epilogue.  Register r = 4 j + 2 i + b holds row 8 i and
        // column 8 j + 2 (lane % 4) + b of the warp's fragment (frag).
        // All of a thread's columns lie in 128-column block ct.
        if constexpr (SWAP) {
          // a token's two columns are 8 apart: one store each
#pragma unroll
          for (int r = 0; r < NACC; ++r) {
            long long m;
            int n;
            coords<SWAP>(r, wgi, rt, ct * CT, m, n);
            if (m >= a.M || n >= a.N) continue;
            const long long e = a.epi_cols == 1 ? m : m * a.epi_cols + ct;
            store_any<KIND>(a, m * a.N + n, dequant(acc[0][r], zero_corr(a.zx, a.colsum, m, n),
                                             __ldg(a.sx + m), __ldg(a.sw + n)), e);
          }
        } else {
          // a row's columns come in neighbouring pairs, one store a pair;
          // the thread's two rows share its 32 columns' scales, loaded first
          const int n0 = ct * CT + 2 * (lane % 4);
          float swv[NACC / 2];
#pragma unroll
          for (int c = 0; c < NACC / 2; ++c) {
            const int n = n0 + 8 * (c / 2) + c % 2;
            swv[c] = n < a.N ? __ldg(a.sw + n) : 0.f;
          }
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const long long m = static_cast<long long>(rt) * BM + 64 * wgi +
                                16 * (warp % 4) + lane / 4 + 8 * i;
            if (m >= a.M) continue;
            const RowOps o = row_ops<KIND == 2>(a, m, a.epi_cols == 1 ? m : m * a.epi_cols + ct);
#pragma unroll
            for (int j = 0; j < NACC / 4; ++j)
              store_pair<KIND>(a, o, m, n0 + 8 * j, acc[0][4 * j + 2 * i],
                               acc[0][4 * j + 2 * i + 1], swv[2 * j], swv[2 * j + 1]);
          }
        }
      } else {
        // ---- K3 epilogue: hsw to the scratch, row partials of this tile
        const int nb = a.N / LANE, nj = a.col_tiles;
        // SWAP: a thread's tokens are 8 j + 2 (lane % 4) + b (T / 4 of them);
        // else its rows are ra and ra + 8 (2 of them)
        constexpr int NK = SWAP ? T / 4 : 2;
        float pa[NK], p1[NK], p2[NK];
#pragma unroll
        for (int i = 0; i < NK; ++i) pa[i] = p1[i] = p2[i] = 0.f;
        const auto part_add = [&](int i, float hv) {
          pa[i] = fmaxf(pa[i], fabsf(hv));
          p1[i] += hv;
          p2[i] = __fadd_rn(p2[i], __fmul_rn(hv, hv));
        };
        if constexpr (SWAP) {
#pragma unroll
          for (int r = 0; r < NACC; ++r) {
            long long m;
            int n;
            coords<SWAP>(r, wgi, rt, ct * CT, m, n);
            if (m >= a.M) continue;
            const int nu = P + n;
            const float sxm = __ldg(a.sx + m);
            const float g = clip(dequant(acc[0][r], zero_corr(a.zx, a.colsum, m, n), sxm,
                                         __ldg(a.sw + n)), a.lo, a.hi, m * nb + ct);
            const float u = clip(dequant(acc[1][r], zero_corr(a.zx, a.colsum, m, nu), sxm,
                                         __ldg(a.sw + nu)), a.lo, a.hi, m * nb + P / LANE + ct);
            const float hv = silu_mul(g, u);
            a.hsw[m * P + n] = hv;
            part_add(2 * (r >> 2) + (r & 1), hv);
          }
        } else {
          // rows 8 i of the fragment; neighbouring column pairs, one store
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const long long m = static_cast<long long>(rt) * BM + 64 * wgi +
                                16 * (warp % 4) + lane / 4 + 8 * i;
            if (m >= a.M) continue;
            const RowOps og = row_ops<false>(a, m, m * nb + ct);
            const RowOps ou = row_ops<false>(a, m, m * nb + P / LANE + ct);
#pragma unroll
            for (int j = 0; j < NACC / 4; ++j) {
              const int n = ct * CT + 8 * j + 2 * (lane % 4), r = 4 * j + 2 * i;
              float hv[2];
#pragma unroll
              for (int b = 0; b < 2; ++b) {
                hv[b] = silu_mul(y_of(a, og, acc[0][r + b], n + b, __ldg(a.sw + n + b)),
                                 y_of(a, ou, acc[1][r + b], P + n + b, __ldg(a.sw + P + n + b)));
                part_add(i, hv[b]);
              }
              *reinterpret_cast<float2*>(a.hsw + m * P + n) = make_float2(hv[0], hv[1]);
            }
          }
        }
        if constexpr (!SWAP) {
          // a row's 128 columns are the 4 lanes of one quad
#pragma unroll
          for (int i = 0; i < NK; ++i)
#pragma unroll
            for (int off = 1; off < 4; off <<= 1) {
              pa[i] = fmaxf(pa[i], __shfl_xor_sync(0xffffffffu, pa[i], off));
              p1[i] += __shfl_xor_sync(0xffffffffu, p1[i], off);
              p2[i] += __shfl_xor_sync(0xffffffffu, p2[i], off);
            }
          if (lane % 4 == 0) {
#pragma unroll
            for (int i = 0; i < NK; ++i) {
              const long long m =
                  static_cast<long long>(rt) * BM + 64 * wgi + 16 * (warp % 4) + lane / 4 + 8 * i;
              if (m < a.M) {
                float* p = a.part + (m * nj + ct) * 3;
                p[0] = pa[i];
                p[1] = p1[i];
                p[2] = p2[i];
              }
            }
          }
        } else {
          // a token's 128 columns: 8 lane groups of each of the 8 warps
#pragma unroll
          for (int i = 0; i < NK; ++i)
#pragma unroll
            for (int off = 4; off < 32; off <<= 1) {
              pa[i] = fmaxf(pa[i], __shfl_xor_sync(0xffffffffu, pa[i], off));
              p1[i] += __shfl_xor_sync(0xffffffffu, p1[i], off);
              p2[i] += __shfl_xor_sync(0xffffffffu, p2[i], off);
            }
          if (lane < 4) {
#pragma unroll
            for (int i = 0; i < NK; ++i) {
              const int tok = 8 * (i / 2) + 2 * lane + (i % 2);
              red[warp][tok][0] = pa[i];
              red[warp][tok][1] = p1[i];
              red[warp][tok][2] = p2[i];
            }
          }
          consumer_sync();
          if (threadIdx.x < T && threadIdx.x < a.M) {
            const int tok = threadIdx.x;
            float am = 0.f, t1 = 0.f, t2 = 0.f;
            for (int wi = 0; wi < 8; ++wi) {
              am = fmaxf(am, red[wi][tok][0]);
              t1 += red[wi][tok][1];
              t2 += red[wi][tok][2];
            }
            float* p = a.part + (static_cast<long long>(tok) * nj + ct) * 3;
            p[0] = am;
            p[1] = t1;
            p[2] = t2;
          }
          consumer_sync();
        }
      }
    }
  }

  if constexpr (SWIGLU) {
    // ---- phase 2, grid-wide: (a) every row's scale and sums from its
    // partials in fixed order, one warp a row; (b) hsw_q = hsw / s_x, four
    // values a thread, streaming the scratch
    constexpr int WARPS = THREADS / 32;
    __threadfence();
    if (a.stamps && threadIdx.x == 0) a.stamps[2 * blockIdx.x] = now_ns();
    grid_sync(a.tickets);
    const int nj = a.col_tiles;
    for (int m = blockIdx.x * WARPS + warp; m < a.M; m += gridDim.x * WARPS) {
      float am = 0.f, t1 = 0.f, t2 = 0.f;
      for (int jj = lane; jj < nj; jj += 32) {
        const float* p = a.part + (static_cast<long long>(m) * nj + jj) * 3;
        am = fmaxf(am, __ldcg(p));
        t1 += __ldcg(p + 1);
        t2 += __ldcg(p + 2);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        am = fmaxf(am, __shfl_xor_sync(0xffffffffu, am, off));
        t1 += __shfl_xor_sync(0xffffffffu, t1, off);
        t2 += __shfl_xor_sync(0xffffffffu, t2, off);
      }
      if (lane == 0) {
        a.osx[m] = fmaxf(am, 1e-8f) / 127.0f;
        a.os1[m] = t1;
        a.os2[m] = t2;
      }
    }
    __threadfence();
    grid_sync(a.tickets);
    // P % 4 == 0: a float4 never straddles two rows
    constexpr int U = 16;                      // float4 loads in flight a thread
    const long long n4 = static_cast<long long>(a.M) * P / 4;
    const long long step = static_cast<long long>(gridDim.x) * THREADS;
    const float4* h4 = reinterpret_cast<const float4*>(a.hsw);
    char4* q4 = reinterpret_cast<char4*>(a.hsw_q);
    // newest rows first: phase 1 wrote them last, so they are likeliest in L2
    for (long long j0 = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
         j0 < n4; j0 += U * step) {
      float4 v[U];
      float sc[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const long long i = n4 - 1 - (j0 + u * step);
        if (i >= 0) {
          v[u] = __ldcg(h4 + i);
          sc[u] = __ldcg(a.osx + 4 * i / P);
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const long long i = n4 - 1 - (j0 + u * step);
        if (i >= 0) {
          char4 q;
          q.x = static_cast<signed char>(max(-127, min(127, __float2int_rn(v[u].x / sc[u]))));
          q.y = static_cast<signed char>(max(-127, min(127, __float2int_rn(v[u].y / sc[u]))));
          q.z = static_cast<signed char>(max(-127, min(127, __float2int_rn(v[u].z / sc[u]))));
          q.w = static_cast<signed char>(max(-127, min(127, __float2int_rn(v[u].w / sc[u]))));
          q4[i] = q;
        }
      }
    }
    if (a.stamps) {
      __syncthreads();
      if (threadIdx.x == 0) a.stamps[2 * blockIdx.x + 1] = now_ns();
    }
  }
}

// ---- host side

PFN_cuTensorMapEncodeTiled_v12000 encode_fn() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault, &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
  }
  return fn;
}

// A 2-D map over a K-major (rows, K) int8 array: boxes of 128 k x box_rows
// rows, 128-byte swizzle, zeros outside the array.
bool make_map(CUtensorMap* map, const void* base, int K, long long rows, int box_rows) {
  const auto fn = encode_fn();
  if (!fn) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(K), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(K)};
  const cuuint32_t box[2] = {KB, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(base), dims, strides,
            box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <bool SWAP, bool SWIGLU, int T, int KIND>
int launch(const void* x, const void* w, const Args& a, int grid, cudaStream_t st) {
  using G = Tile<SWAP, SWIGLU, T>;
  auto kernel = gemm_kernel<SWAP, SWIGLU, T, KIND>;
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, G::SMEM);
    if (e != cudaSuccess) return static_cast<int>(e);
    attr_set = true;
  }
  CUtensorMap tmx, tmw;
  if (!make_map(&tmx, x, a.K, a.M, SWAP ? T : BM) || !make_map(&tmw, w, a.K, a.N, CT))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = G::SMEM;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = SWIGLU ? 1 : 0;     // K3's grid barrier needs one wave
  return static_cast<int>(cudaLaunchKernelEx(&cfg, kernel, tmx, tmw, a));
}

template <bool SWIGLU, int KIND>
int dispatch_rows(const void* x, const void* w, const Args& a, int grid, cudaStream_t st) {
  if (a.M > 64) return launch<false, SWIGLU, 8, KIND>(x, w, a, grid, st);
  if (a.M > 32) return launch<true, SWIGLU, 64, KIND>(x, w, a, grid, st);
  if (a.M > 16) return launch<true, SWIGLU, 32, KIND>(x, w, a, grid, st);
  if (a.M > 8) return launch<true, SWIGLU, 16, KIND>(x, w, a, grid, st);
  return launch<true, SWIGLU, 8, KIND>(x, w, a, grid, st);
}

template <bool SWIGLU>
int dispatch(const void* x, const void* w, const Args& a, int grid, cudaStream_t st) {
  if constexpr (SWIGLU) {
    return dispatch_rows<true, 0>(x, w, a, grid, st);
  } else {
    if (a.out_kind == 0) return dispatch_rows<false, 0>(x, w, a, grid, st);
    if (a.out_kind == 1) return dispatch_rows<false, 1>(x, w, a, grid, st);
    return dispatch_rows<false, 2>(x, w, a, grid, st);
  }
}

// The wrapper's plan, checked: items cover the work, the splits cover K.
bool plan_ok(const Args& a, int grid, bool swiglu) {
  const bool swap = a.M <= 64;
  const int nks = (a.K + KB - 1) / KB;
  if (a.col_tiles != ((swiglu ? a.N / 2 : a.N) + CT - 1) / CT) return false;
  if (a.nks != nks || a.kc < 1 || a.splits < 1 || grid < 1 || grid > a.items) return false;
  if (!swap && (a.splits != 1 || a.kc != nks)) return false;
  if ((a.splits - 1) * a.kc >= nks || a.splits * a.kc < nks) return false;
  if (a.splits > 1 && (a.col_tiles > BAR_COUNT || !a.ws)) return false;
  const long long rows = swap ? 1 : (a.M + BM - 1) / BM;
  return a.items == rows * a.col_tiles * a.splits;
}

}  // namespace wg

}  // namespace

// ------------------------------------------------------------ entry points
// Every weight w is K-major: (N, K) row-major storage of the (K, N) codes.

// Generic route.  out_kind: 0 = float32 out, 1 = bfloat16 out, 2 = int8
// out (requant on so/zo).  Epilogue operands are (M, epi_cols).  May be
// null: zx (zero, and then colsum may be null too), so/zo for fp outs,
// lo/hi (no clamp).
extern "C" int w8a8_matmul(const void* x, const void* w, const void* sx,
                           const void* zx, const void* sw, const void* colsum,
                           const void* so, const void* zo, const void* lo,
                           const void* hi, void* out, int out_kind, long long M,
                           int K, int N, int epi_cols, void* stream) {
  using namespace generic;
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

// Generic route.  lo/hi: (M, N/128).  zx may be null (zero; colsum may then
// be null).  hsw: (M, P) f32 and part: (M, ceil(P/64), 3) f32 scratch.
// tickets: (ceil(M/BM),) int32, zero at rest (the kernel returns each
// ticket it draws to 0); BM is 16 when M <= 16, else 64.
extern "C" int w8a8_swiglu_matmul(const void* x, const void* w, const void* sx,
                                  const void* zx, const void* sw,
                                  const void* colsum, const void* lo,
                                  const void* hi, void* hsw,
                                  void* hsw_q, void* osx, void* os1, void* os2,
                                  void* part, void* tickets, long long M, int K,
                                  int N, void* stream) {
  using namespace generic;
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

// wgmma route of K2: the operands as w8a8_matmul's, with K % 16 == 0 and x,
// w 16-byte aligned; the plan (kernels/w8a8_matmul.py wgmma_plan): col_tiles
// = ceil(N/128), nks = ceil(K/128) stages, kc stages per split, splits,
// items, grid.  ws: (M, N) int32 and tickets: (4098,) int32, zero at rest
// (read only when splits > 1).
extern "C" int w8a8_matmul_wgmma(const void* x, const void* w, const void* sx,
                                 const void* zx, const void* sw, const void* colsum,
                                 const void* so, const void* zo, const void* lo,
                                 const void* hi, void* out, int out_kind, int M, int K,
                                 int N, int epi_cols, int col_tiles, int nks, int kc,
                                 int splits, int items, int grid, void* ws,
                                 void* tickets, void* stream) {
  if (M <= 0 || N <= 0) return 0;
  wg::Args a = {};
  a.sx = cp<float>(sx);
  a.zx = cp<int>(zx);
  a.sw = cp<float>(sw);
  a.colsum = cp<int>(colsum);
  a.so = cp<float>(so);
  a.zo = cp<int>(zo);
  a.lo = cp<float>(lo);
  a.hi = cp<float>(hi);
  a.out = out;
  a.out_kind = out_kind;
  a.ws = static_cast<int*>(ws);
  a.tickets = static_cast<int*>(tickets);
  a.M = M;
  a.K = K;
  a.N = N;
  a.epi_cols = epi_cols;
  a.col_tiles = col_tiles;
  a.nks = nks;
  a.kc = kc;
  a.splits = splits;
  a.items = items;
  if (K % 16 || !aligned(x, 16) || !aligned(w, 16) || !wg::plan_ok(a, grid, false))
    return static_cast<int>(cudaErrorInvalidValue);
  return wg::dispatch<false>(x, w, a, grid, static_cast<cudaStream_t>(stream));
}

// wgmma route of K3: the operands as w8a8_swiglu_matmul's, with K % 16 ==
// 0, x and w 16-byte aligned and P a multiple of 128; part: (M, P/128, 3)
// f32; the plan as for K2 with col_tiles = P/128; ws: (M, N) int32 and
// tickets: (4098,) int32, zero at rest.  stamps: null, or (2 grid,) int64
// that receives each block's globaltimer at the end of phase 1 and 2.  A
// cooperative launch (grid at most one wave).
extern "C" int w8a8_swiglu_matmul_wgmma(const void* x, const void* w, const void* sx,
                                        const void* zx, const void* sw,
                                        const void* colsum, const void* lo,
                                        const void* hi, void* hsw, void* hsw_q,
                                        void* osx, void* os1, void* os2, void* part,
                                        int M, int K, int N, int col_tiles, int nks,
                                        int kc, int splits, int items, int grid,
                                        void* ws, void* tickets, void* stamps,
                                        void* stream) {
  if (M <= 0 || N <= 0) return 0;
  wg::Args a = {};
  a.sx = cp<float>(sx);
  a.zx = cp<int>(zx);
  a.sw = cp<float>(sw);
  a.colsum = cp<int>(colsum);
  a.lo = cp<float>(lo);
  a.hi = cp<float>(hi);
  a.hsw = static_cast<float*>(hsw);
  a.hsw_q = static_cast<int8_t*>(hsw_q);
  a.osx = static_cast<float*>(osx);
  a.os1 = static_cast<float*>(os1);
  a.os2 = static_cast<float*>(os2);
  a.part = static_cast<float*>(part);
  a.ws = static_cast<int*>(ws);
  a.tickets = static_cast<int*>(tickets);
  a.stamps = static_cast<long long*>(stamps);
  a.M = M;
  a.K = K;
  a.N = N;
  a.epi_cols = N / LANE;
  a.col_tiles = col_tiles;
  a.nks = nks;
  a.kc = kc;
  a.splits = splits;
  a.items = items;
  if (K % 16 || N % (2 * wg::CT) || !aligned(x, 16) || !aligned(w, 16) ||
      !tickets || !wg::plan_ok(a, grid, true))
    return static_cast<int>(cudaErrorInvalidValue);
  return wg::dispatch<true>(x, w, a, grid, static_cast<cudaStream_t>(stream));
}
