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
// Bound on the H100, when taken: the weight bytes at decode (the int8
// weight is read once: 12.6 MB for QKV, 3.8 us); at prefill the operations,
// 2 M N K of them, on the bf16 tensor cores for bf16 x (989 TFLOP/s: 52 us
// for QKV at 2048 rows) and on the f32 units for f32 x (67 TFLOP/s).  Not
// taken: one flag read and one atomic a block, so the grid is persistent
// and small: at most one block an SM (two on the CUDA-core routes), each
// walking the work items of the plan, whatever M is.
//
// Three routes, chosen by the wrapper (kernels/fp_dequant.py route_for)
// from the operands' dtypes, shapes and addresses alone:
//
// * wgmma (bf16 x, K % 16 == 0, x and q 16-byte aligned): every card path.
//   An int8 code is exact in bf16, and so is its product with a bf16 x, so
//   y = scale[n] * sum_k x[m, k] q[k, n]: a bf16 product on the tensor
//   cores with f32 accumulation, the column's scale applied once in the
//   epilogue; only the order of the f32 roundings differs from the plain
//   version's.  One producer warp keeps a ring of 64-deep k stages full
//   with TMA: the int8 weight (128 output columns x 64 bytes) and x (bf16,
//   128-byte swizzle); two consumer warpgroups convert the codes to bf16
//   with byte permutes and one f32 add a code (no conversion unit) and run
//   wgmma .f32.bf16.bf16.  Decode rows (M <= 64) swap A and B, as K2 does:
//   A = 64 output columns a warpgroup, converted straight into wgmma's
//   register fragments (each thread reads its codes as 4-byte words from
//   the stage, which TMA lays out in the 64-byte swizzle so that a warp's
//   words hit distinct banks), B = x with n = M rounded up to 8, 16, 32 or
//   64, and K is split so that the weight streams through most SMs (the
//   wrapper's plan, after K2's).  Converting into registers spares the
//   bf16 copy's shared-memory traffic, a proxy fence and a barrier a stage,
//   which set a stage's time when the copy went through shared memory.
//   Prefill rows: A = 128 x rows (64 a warpgroup), B = the 128 weight
//   columns converted into shared memory in the 128-byte swizzle that
//   wgmma reads, n = 128; row tiles outermost, so the weights stay in the
//   L2.
// * fma (f32 x, the same shapes): the f32 FMA loop on the CUDA cores, as
//   the reference rounds it (q * scale in f32, then the product), over the
//   same plan: a 16 x 64 tile, 64-deep k stages of 16-byte weight loads.
// * generic (K % 16 != 0 or a base off 16 bytes): the fma route's loop
//   with element loads, for shapes TMA cannot describe.
//
// Split K is deterministic: each split stores its f32 partial (a thread's
// accumulators, contiguous) to a workspace and draws a ticket of its tile;
// the last split sums the partials in split order, zeroing them, returns
// the ticket to 0 and runs the epilogue.  So the workspace and tickets stay
// zero at rest, and the same inputs give the same bits on every call.
#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int KS = 64;             // k a stage, every route
constexpr int THREADS = 256;       // the fma block; the wgmma route's consumers
constexpr int MAX_TICKETS = 4096;  // tiles a split launch
constexpr int MAX_DEVICES = 64;    // cards whose launch attribute is kept set
// route codes
constexpr int GENERIC = 0, FMA = 1, WGMMA = 2;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// The wrapper's plan (kernels/fp_dequant.py Plan) and the operands.
struct Args {
  const void* x;
  const int8_t* q;
  const float* scale;
  void* y;
  float* ws;              // split partials, zero at rest
  int* tickets;           // one a tile, zero at rest
  int* flag;              // [non-finite flag, ticket], zero at rest
  unsigned long long* tel;
  int M, K, N;
  int rows, row_tiles, col_tiles, nks, kc, splits, items;
};

// Every block reads the flag, then draws a ticket (`ticket`); the last block
// to draw puts flag and ticket back to 0 and counts a taken fallback
// (`release`).
__device__ __forceinline__ unsigned ticket(int* flag) {
  return atomicAdd(reinterpret_cast<unsigned*>(flag + 1), 1u);
}
__device__ __forceinline__ void release(unsigned t, int* flag, int f,
                                        unsigned long long* tel) {
  if (t == gridDim.x - 1) {
    atomicExch(flag, 0);
    atomicExch(flag + 1, 0);
    if (f && tel) atomicAdd(tel, 1ull);
  }
}

// Whether the fallback is taken, for every thread of the block: thread 0
// reads the flag and draws the ticket.
__device__ __forceinline__ bool taken(int* flag, unsigned long long* tel) {
  __shared__ int take;
  if (threadIdx.x == 0) {
    const int f = *reinterpret_cast<volatile int*>(flag);
    take = f;
    __threadfence();
    release(ticket(flag), flag, f, tel);
  }
  __syncthreads();
  return take != 0;
}

// Work item -> (tile, split) and the tile's (row tile, column tile) and k
// stages [ks0, ks1): the splits of a tile are neighbours, row tiles
// outermost.
struct Item {
  int tile, split, rt, ct, ks0, ks1;
};
__device__ __forceinline__ Item item_of(const Args& a, int item) {
  Item it;
  it.tile = item / a.splits;
  it.split = item % a.splits;
  it.rt = it.tile / a.col_tiles;
  it.ct = it.tile % a.col_tiles;
  it.ks0 = it.split * a.kc;
  it.ks1 = min(a.nks, it.ks0 + a.kc);
  return it;
}

// Split K: store this split's ACC accumulators, draw the tile's ticket;
// the last split sums every split's partial in split order (zeroing the
// workspace behind it), returns the ticket to 0 and keeps the total in acc.
// False for the other splits.  `sync` is a barrier of the THREADS threads
// that hold the accumulators (thread index tid), s_last a shared word.
template <int ACC, typename Sync>
__device__ __forceinline__ bool merge(const Args& a, const Item& it, float (&acc)[ACC],
                                      int tid, int* s_last, Sync sync) {
  static_assert(ACC % 4 == 0, "partials are stored as float4");
  if (a.splits == 1) return true;
  const long long tiles = static_cast<long long>(a.row_tiles) * a.col_tiles;
  const auto slot = [&](int s) {
    return reinterpret_cast<float4*>(a.ws + ((s * tiles + it.tile) * THREADS + tid) * ACC);
  };
  float4* mine = slot(it.split);
#pragma unroll
  for (int r = 0; r < ACC; r += 4)
    __stcg(mine + r / 4, make_float4(acc[r], acc[r + 1], acc[r + 2], acc[r + 3]));
  __threadfence();
  sync();
  if (tid == 0) *s_last = atomicAdd(a.tickets + it.tile, 1) == a.splits - 1;
  sync();
  if (!*s_last) return false;
  __threadfence();
  // the sums first, with no store between the loads (so they are in flight
  // together), then the zeros
#pragma unroll
  for (int r = 0; r < ACC; r += 4) {
    const float4 v = __ldcg(slot(0) + r / 4);
    acc[r] = v.x, acc[r + 1] = v.y, acc[r + 2] = v.z, acc[r + 3] = v.w;
  }
#pragma unroll 4
  for (int s = 1; s < a.splits; ++s) {
#pragma unroll
    for (int r = 0; r < ACC; r += 4) {
      const float4 v = __ldcg(slot(s) + r / 4);
      acc[r] += v.x, acc[r + 1] += v.y, acc[r + 2] += v.z, acc[r + 3] += v.w;
    }
  }
  const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int s = 0; s < a.splits; ++s)
#pragma unroll
    for (int r = 0; r < ACC; r += 4) __stcg(slot(s) + r / 4, z);
  if (tid == 0) atomicExch(a.tickets + it.tile, 0);
  return true;
}

bool aligned(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// ========================================================== fma, generic

namespace cores {

constexpr int BM = 16, BN = 64;    // a tile: x rows, output columns
constexpr int ACC = BM / 4;        // a thread's rows: ty + 4 i

// x rows m0 .. m0 + BM - 1, k0 .. k0 + KS - 1 into xs as f32, zero outside;
// VEC: 16-byte loads (the rows 16-byte aligned, K % 16 == 0).
template <typename XT, bool VEC>
__device__ __forceinline__ void load_x(float (&xs)[BM][KS + 1], const XT* __restrict__ x,
                                       int M, int K, long long m0, int k0) {
  if constexpr (VEC) {
    constexpr int E = 16 / sizeof(XT), CH = KS / E;
    for (int i = threadIdx.x; i < BM * CH; i += THREADS) {
      const int r = i / CH, c = i % CH;
      const long long m = m0 + r;
      alignas(16) XT v[E];
      if (m < M && k0 + c * E < K) {
        *reinterpret_cast<uint4*>(v) = __ldg(reinterpret_cast<const uint4*>(x + m * K + k0 + c * E));
#pragma unroll
        for (int e = 0; e < E; ++e) xs[r][c * E + e] = to_f32(v[e]);
      } else {
#pragma unroll
        for (int e = 0; e < E; ++e) xs[r][c * E + e] = 0.f;
      }
    }
  } else {
    for (int i = threadIdx.x; i < BM * KS; i += THREADS) {
      const int r = i / KS, k = i % KS;
      const long long m = m0 + r;
      xs[r][k] = m < M && k0 + k < K ? to_f32(x[m * K + k0 + k]) : 0.f;
    }
  }
}

// Columns n0 .. n0 + BN - 1 of the weight, k0 .. k0 + KS - 1, dequantized as
// the reference rounds them (q * scale in f32) into ws[column][k]; VEC: one
// 16-byte load of 16 codes a thread, four threads a column.
template <bool VEC>
__device__ __forceinline__ void load_w(float (&ws)[BN][KS + 1], const int8_t* __restrict__ q,
                                       const float* __restrict__ scale, int K, int N, int n0,
                                       int k0) {
  if constexpr (VEC) {
    const int n = threadIdx.x / 4, c = threadIdx.x % 4;    // THREADS == 4 BN
    const int col = n0 + n, k = k0 + 16 * c;
    alignas(16) int8_t v[16];
    if (col < N && k < K) {
      *reinterpret_cast<int4*>(v) =
          __ldg(reinterpret_cast<const int4*>(q + static_cast<long long>(col) * K + k));
      const float s = __ldg(scale + col);
#pragma unroll
      for (int e = 0; e < 16; ++e) ws[n][16 * c + e] = __fmul_rn(static_cast<float>(v[e]), s);
    } else {
#pragma unroll
      for (int e = 0; e < 16; ++e) ws[n][16 * c + e] = 0.f;
    }
  } else {
    for (int i = threadIdx.x; i < BN * KS; i += THREADS) {
      const int n = i / KS, k = i % KS;
      const int col = n0 + n;
      ws[n][k] = col < N && k0 + k < K
                     ? __fmul_rn(static_cast<float>(q[static_cast<long long>(col) * K + k0 + k]),
                                 scale[col])
                     : 0.f;
    }
  }
}

template <typename XT, typename YT, bool VEC>
__global__ void __launch_bounds__(THREADS)
fma_kernel(const Args a) {
  static_assert(THREADS == 4 * BN, "load_w: four threads a column");
  if (!taken(a.flag, a.tel)) return;
  __shared__ float xs[BM][KS + 1];
  __shared__ float ws[BN][KS + 1];
  __shared__ int s_last;
  const XT* x = static_cast<const XT*>(a.x);
  YT* y = static_cast<YT*>(a.y);
  const int tx = threadIdx.x % BN, ty = threadIdx.x / BN;   // ty: 0..3
  for (int item = blockIdx.x; item < a.items; item += gridDim.x) {
    const Item it = item_of(a, item);
    const long long m0 = static_cast<long long>(it.rt) * BM;
    const int n0 = it.ct * BN;
    float acc[ACC] = {};
    for (int ks = it.ks0; ks < it.ks1; ++ks) {
      load_x<XT, VEC>(xs, x, a.M, a.K, m0, ks * KS);
      load_w<VEC>(ws, a.q, a.scale, a.K, a.N, n0, ks * KS);
      __syncthreads();
#pragma unroll 8
      for (int k = 0; k < KS; ++k) {
        const float w = ws[tx][k];
#pragma unroll
        for (int i = 0; i < ACC; ++i) acc[i] = fmaf(xs[ty + 4 * i][k], w, acc[i]);
      }
      __syncthreads();
    }
    if (!merge<ACC>(a, it, acc, threadIdx.x, &s_last, [] { __syncthreads(); })) continue;
    const int n = n0 + tx;
    if (n >= a.N) continue;
#pragma unroll
    for (int i = 0; i < ACC; ++i) {
      const long long m = m0 + ty + 4 * i;
      if (m < a.M) put(y + m * a.N + n, acc[i]);
    }
  }
}

}  // namespace cores

// ================================================================= wgmma

namespace wg {

constexpr int CT = 128;                  // output columns a tile
constexpr int BM = 128;                  // x rows a tile at prefill
constexpr int CONSUMERS = THREADS;       // two consumer warpgroups
constexpr int NTHREADS = CONSUMERS + 32; // + the producer warp
constexpr int SMEM_BUDGET = 200 * 1024;
constexpr int MAX_STAGES = 16;
constexpr int WB_BYTES = CT * KS;        // the int8 weight stage: 128 rows x 64 B

// One instance: SWAP the decode orientation, R the x rows of a stage (B's n
// under SWAP; BM at prefill).  A stage: [x, R rows x 64 bf16 | the int8
// weight | at prefill, the weight converted to bf16, 128 rows x 64].
template <bool SWAP, int R>
struct Tile {
  static constexpr int X_BYTES = R * 128;
  static constexpr int CB_BYTES = SWAP ? 0 : CT * 128;
  static constexpr int STAGE = X_BYTES + WB_BYTES + CB_BYTES;   // a multiple of 1024
  static constexpr int TX = X_BYTES + WB_BYTES;            // TMA bytes a stage
  static constexpr int STAGES =
      SMEM_BUDGET / STAGE < MAX_STAGES ? SMEM_BUDGET / STAGE : MAX_STAGES;
  static constexpr int MMA_N = SWAP ? R : CT;              // wgmma n
  static constexpr int NACC = MMA_N / 2;                   // f32 accumulators a thread
  static constexpr int SMEM = STAGES * STAGE + 1024;       // + 1024-B alignment
};

// ---- PTX wrappers: mbarriers, TMA, wgmma (as csrc/w8a8_matmul.cu's)

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

// D (64 x 128, f32) += A (64 x 16, bf16, K-major) . B (128 x 16, bf16, K-major)^T
template <int N> struct Mma;
template <> struct Mma<128> {
  __device__ static void run(float (&d)[64], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(a), "l"(b), "r"(1));
  }
};

// D (64 x N, f32) += A (64 x 16, bf16, four registers a thread) . B (N x 16,
// bf16, K-major)^T
template <int N> struct MmaRS;
template <> struct MmaRS<8> {
  __device__ static void run(float (&d)[4], const uint32_t (&a)[4], uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, %8, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};
template <> struct MmaRS<16> {
  __device__ static void run(float (&d)[8], const uint32_t (&a)[4], uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7}, "
        "{%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};
template <> struct MmaRS<32> {
  __device__ static void run(float (&d)[16], const uint32_t (&a)[4], uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};
template <> struct MmaRS<64> {
  __device__ static void run(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

// Accumulator register r of this thread in the m64nN fragment: row ra
// (0..63) and column rb (0..N-1).
__device__ __forceinline__ void frag(int r, int& ra, int& rb) {
  const int w = (threadIdx.x % 128) / 32, l = threadIdx.x % 32;
  ra = 16 * w + l / 4 + 8 * ((r >> 1) & 1);
  rb = 8 * (r >> 2) + 2 * (l % 4) + (r & 1);
}

// Four int8 codes (one word, the first in the low byte) as two bf16x2 words,
// exact: each code + 128 is placed in the mantissa of 2^23, 2^23 + 128 is
// subtracted, and the f32 integer's upper half is its bf16 (it has at most
// 8 significant bits).
__device__ __forceinline__ void bf16x4(uint32_t w, uint32_t& lo, uint32_t& hi) {
  const uint32_t u = w ^ 0x80808080u;
  const float f0 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650)) - 8388736.f;
  const float f1 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7651)) - 8388736.f;
  const float f2 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7652)) - 8388736.f;
  const float f3 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7653)) - 8388736.f;
  lo = __byte_perm(__float_as_uint(f0), __float_as_uint(f1), 0x7632);
  hi = __byte_perm(__float_as_uint(f2), __float_as_uint(f3), 0x7632);
}

// Prefill: the consumers' share of a stage's conversion, the int8 stage
// (128 rows x 64 bytes, unswizzled) into bf16 rows of 128 bytes in the
// 128-byte swizzle (16-byte chunk c of row r at chunk c ^ (r % 8)); two
// 16-code units a thread, four threads a row.
__device__ __forceinline__ void convert(const uint8_t* wb, uint8_t* cb) {
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int i = threadIdx.x + CONSUMERS * j;
    const int r = i / 4, c = i % 4;
    const uint4 v = *reinterpret_cast<const uint4*>(wb + r * KS + 16 * c);
    uint4 o0, o1;
    bf16x4(v.x, o0.x, o0.y);
    bf16x4(v.y, o0.z, o0.w);
    bf16x4(v.z, o1.x, o1.y);
    bf16x4(v.w, o1.z, o1.w);
    uint8_t* row = cb + r * 128;
    *reinterpret_cast<uint4*>(row + 16 * ((2 * c) ^ (r & 7))) = o0;
    *reinterpret_cast<uint4*>(row + 16 * ((2 * c + 1) ^ (r & 7))) = o1;
  }
}

// Decode: two int8 codes of a word (byte `at` and the next, of the word's
// four, the first in the low byte) as one bf16x2 register, exact (as
// bf16x4).
__device__ __forceinline__ uint32_t bf16x2(uint32_t w, uint32_t at) {
  const uint32_t u = w ^ 0x80808080u;
  const float f0 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650 + at)) - 8388736.f;
  const float f1 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7651 + at)) - 8388736.f;
  return __byte_perm(__float_as_uint(f0), __float_as_uint(f1), 0x7632);
}

// Decode: this thread's A fragments of a stage's four k16 steps, read from
// the int8 stage (128 rows x 64 bytes in the 64-byte swizzle: 16-byte chunk
// c of row r at chunk c ^ ((r / 2) % 4)).  In step j, register 0 holds row
// g's codes 16 j + 2 t and + 1, register 1 row g + 8's, registers 2 and 3
// the same rows' codes 16 j + 2 t + 8 and + 9 (g = lane / 4, t = lane % 4;
// the warp's 16 rows from 64 wgi + 16 (warp % 4)): one 4-byte load a
// register, conflict-free in that swizzle.
__device__ __forceinline__ void fragments(const uint8_t* wb, uint32_t (&fa)[KS / 16][4]) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int r0 = 64 * (threadIdx.x / 128) + 16 * ((threadIdx.x / 32) % 4) + g;
  const uint32_t at = 2 * (t % 2);
#pragma unroll
  for (int j = 0; j < KS / 16; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int r = r0 + 8 * (q & 1), h = q >> 1;
      const uint32_t w = *reinterpret_cast<const uint32_t*>(
          wb + r * KS + 16 * (j ^ ((r >> 1) & 3)) + 8 * h + 4 * (t / 2));
      fa[j][q] = bf16x2(w, at);
    }
}

template <bool SWAP, int R, typename YT>
__global__ void __launch_bounds__(NTHREADS, 1)
gemm_kernel(const __grid_constant__ CUtensorMap tmx, const __grid_constant__ CUtensorMap tmw,
            const Args a) {
  using G = Tile<SWAP, R>;
  constexpr int NACC = G::NACC, STAGES = G::STAGES;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[STAGES], empty[STAGES];
  __shared__ int s_last, take;
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;   // swizzle atoms
  uint8_t* const gbase = smem_raw + (base - smem_u32(smem_raw));
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  // the flag's read in flight while the barriers are set up; the producer
  // draws the block's ticket once every thread knows the flag (after the
  // barrier below, so after the read) and releases it after its loads
  if (threadIdx.x == 0) {
    const int f = *reinterpret_cast<volatile int*>(a.flag);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(smem_u32(&full[s]), 1);
      mbar_init(smem_u32(&empty[s]), CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    take = f;
  }
  __syncthreads();
  if (!take) {
    if (threadIdx.x == CONSUMERS) release(ticket(a.flag), a.flag, 0, a.tel);
    return;
  }

  if (warp == CONSUMERS / 32) {
    // ---- producer: one thread draws the ticket and keeps the ring full
    if (lane == 0) {
      const unsigned t = ticket(a.flag);
      asm volatile("prefetch.tensormap [%0];" ::"l"(reinterpret_cast<uint64_t>(&tmx)));
      asm volatile("prefetch.tensormap [%0];" ::"l"(reinterpret_cast<uint64_t>(&tmw)));
      int s = 0;
      uint32_t ph = 0;
      for (int item = blockIdx.x; item < a.items; item += gridDim.x) {
        const Item it = item_of(a, item);
        for (int ks = it.ks0; ks < it.ks1; ++ks) {
          const uint32_t fb = smem_u32(&full[s]);
          mbar_wait(smem_u32(&empty[s]), ph ^ 1);
          mbar_expect_tx(fb, G::TX);
          const uint32_t st = base + s * G::STAGE;
          tma_load(st, &tmx, ks * KS, SWAP ? 0 : it.rt * BM, fb);
          tma_load(st + G::X_BYTES, &tmw, ks * KS, it.ct * CT, fb);
          if (++s == STAGES) {
            s = 0;
            ph ^= 1;
          }
        }
      }
      release(t, a.flag, 1, a.tel);
    }
    __syncwarp();
    return;
  }

  // ---- consumers: warpgroup wgi owns 64 rows of the A operand
  const int wgi = threadIdx.x / 128;
  YT* y = static_cast<YT*>(a.y);
  int s = 0;
  uint32_t ph = 0;
  for (int item = blockIdx.x; item < a.items; item += gridDim.x) {
    const Item it = item_of(a, item);
    float acc[NACC];
#pragma unroll
    for (int r = 0; r < NACC; ++r) acc[r] = 0.f;
    int prev = -1;
    for (int ks = it.ks0; ks < it.ks1; ++ks) {
      mbar_wait(smem_u32(&full[s]), ph);
      const uint32_t sx = base + s * G::STAGE, sc = sx + G::X_BYTES + WB_BYTES;
      uint8_t* const wb = gbase + s * G::STAGE + G::X_BYTES;
      if constexpr (SWAP) {
        // A = this warpgroup's 64 weight rows (output columns), converted
        // straight into registers; B = x
        uint32_t fa[KS / 16][4];
        fragments(wb, fa);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < KS / 16; ++kk)
          MmaRS<G::MMA_N>::run(acc, fa[kk], desc(sx + 32 * kk));
      } else {
        // A = x's 64 rows of this warpgroup, B = the 128 weight columns,
        // converted to bf16 in shared memory (generic proxy writes, which
        // wgmma reads through the async proxy)
        convert(wb, gbase + s * G::STAGE + G::X_BYTES + WB_BYTES);
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        consumer_sync();
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < KS / 16; ++kk)
          Mma<G::MMA_N>::run(acc, desc(sx + 64 * wgi * 128 + 32 * kk), desc(sc + 32 * kk));
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
    if (prev >= 0) mbar_arrive(smem_u32(&empty[prev]));

    if (!merge<NACC>(a, it, acc, threadIdx.x, &s_last, [] { consumer_sync(); })) continue;

    // ---- epilogue: y = acc * scale of the column
    if constexpr (SWAP) {
#pragma unroll
      for (int r = 0; r < NACC; ++r) {
        int ra, rb;
        frag(r, ra, rb);
        const int n = it.ct * CT + 64 * wgi + ra, m = rb;
        if (m < a.M && n < a.N) put(y + static_cast<long long>(m) * a.N + n,
                                    __fmul_rn(acc[r], __ldg(a.scale + n)));
      }
    } else {
      // register pairs (r, r + 1) are neighbouring columns of one row
      const bool vec = a.N % 2 == 0;
#pragma unroll
      for (int r = 0; r < NACC; r += 2) {
        int ra, rb;
        frag(r, ra, rb);
        const long long m = static_cast<long long>(it.rt) * BM + 64 * wgi + ra;
        const int n = it.ct * CT + rb;
        if (m >= a.M || n >= a.N) continue;
        const float v0 = __fmul_rn(acc[r], __ldg(a.scale + n));
        YT* p = y + m * a.N + n;
        if (n + 1 < a.N) {
          const float v1 = __fmul_rn(acc[r + 1], __ldg(a.scale + n + 1));
          if constexpr (sizeof(YT) == 4) {
            if (vec) {
              *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
              continue;
            }
          } else {
            if (vec) {
              *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
              continue;
            }
          }
          put(p + 1, v1);
        }
        put(p, v0);
      }
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

// A 2-D map over a row-major (rows, K) array: boxes of KS k x box_rows
// rows, zeros outside the array; x bf16 in the 128-byte swizzle (the layout
// wgmma reads); the int8 weight in the 64-byte swizzle at decode (where
// each thread reads its A fragments) and unswizzled at prefill (where four
// threads convert a row's 64 bytes).
bool make_map(CUtensorMap* map, const void* base, int K, long long rows, int box_rows,
              bool bf16, CUtensorMapSwizzle swizzle) {
  const auto fn = encode_fn();
  if (!fn) return false;
  const int elem = bf16 ? 2 : 1;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(K), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(K) * elem};
  const cuuint32_t box[2] = {KS, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t step[2] = {1, 1};
  return fn(map, bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_UINT8, 2,
            const_cast<void*>(base), dims, strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
            swizzle,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <bool SWAP, int R, typename YT>
int launch(const Args& a, int grid, cudaStream_t st) {
  using G = Tile<SWAP, R>;
  auto kernel = gemm_kernel<SWAP, R, YT>;
  // the attribute is the current device's: raised once on each card, at
  // its first launch there (outside any capture: the decode graph warms up)
  static bool attr_set[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  const bool kept = dev >= 0 && dev < MAX_DEVICES;
  if (!kept || !attr_set[dev]) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, G::SMEM);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (kept) attr_set[dev] = true;
  }
  CUtensorMap tmx, tmw;
  if (!make_map(&tmx, a.x, a.K, a.M, R, true, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !make_map(&tmw, a.q, a.K, a.N, CT, false,
                SWAP ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_NONE))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(NTHREADS);
  cfg.dynamicSmemBytes = G::SMEM;
  cfg.stream = st;
  return static_cast<int>(cudaLaunchKernelEx(&cfg, kernel, tmx, tmw, a));
}

template <typename YT>
int dispatch(const Args& a, int grid, cudaStream_t st) {
  switch (a.rows) {
    case 8: return launch<true, 8, YT>(a, grid, st);
    case 16: return launch<true, 16, YT>(a, grid, st);
    case 32: return launch<true, 32, YT>(a, grid, st);
    case 64: return launch<true, 64, YT>(a, grid, st);
    default: return launch<false, BM, YT>(a, grid, st);
  }
}

// B's rows under swap-AB for M decode rows: M rounded up to 8, 16, 32, 64.
int swap_rows(int M) { return M <= 8 ? 8 : M <= 16 ? 16 : M <= 32 ? 32 : 64; }

}  // namespace wg

template <typename XT, typename YT>
int launch_fma(const Args& a, bool vec, int grid, cudaStream_t st) {
  if (vec)
    cores::fma_kernel<XT, YT, true><<<grid, THREADS, 0, st>>>(a);
  else
    cores::fma_kernel<XT, YT, false><<<grid, THREADS, 0, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename XT>
int launch_fma_y(const Args& a, int y_kind, bool vec, int grid, cudaStream_t st) {
  return y_kind == 0 ? launch_fma<XT, float>(a, vec, grid, st)
                     : launch_fma<XT, __nv_bfloat16>(a, vec, grid, st);
}

// The wrapper's plan, checked: the route's tile geometry, items covering
// every tile and split, the splits covering K, the buffers a split needs.
bool plan_ok(const Args& a, int route, int x_kind, int grid) {
  const bool tma = a.K % 16 == 0 && aligned(a.x) && aligned(a.q);
  long long rows, row_tiles, col_tiles;
  if (route == WGMMA) {
    if (!tma || x_kind != 1) return false;
    rows = a.M <= 64 ? wg::swap_rows(a.M) : wg::BM;
    row_tiles = a.M <= 64 ? 1 : (a.M + wg::BM - 1) / wg::BM;
    col_tiles = (a.N + wg::CT - 1) / wg::CT;
  } else {
    if (route == FMA && !tma) return false;
    rows = cores::BM;
    row_tiles = (a.M + cores::BM - 1) / cores::BM;
    col_tiles = (a.N + cores::BN - 1) / cores::BN;
  }
  const int nks = a.K > 0 ? (a.K + KS - 1) / KS : 1;
  if (a.rows != rows || a.row_tiles != row_tiles || a.col_tiles != col_tiles) return false;
  if (a.nks != nks || a.kc < 1 || a.splits < 1 || grid < 1 || grid > a.items) return false;
  if ((a.splits - 1) * a.kc >= nks || a.splits * a.kc < nks) return false;
  if (a.splits > 1 && (row_tiles * col_tiles > MAX_TICKETS || !a.ws || !a.tickets))
    return false;
  return a.items == row_tiles * col_tiles * a.splits;
}

}  // namespace

// kinds: 0 float32, 1 bfloat16.  route: 0 generic, 1 fma, 2 wgmma (bf16 x);
// the plan is the wrapper's (kernels/fp_dequant.py plan): rows, row_tiles,
// col_tiles, nks = ceil(K / 64) stages, kc stages a split, splits, items =
// row_tiles x col_tiles x splits, grid (persistent) blocks.  ws: the split
// partials (f32) and tickets: (4096,) int32, zero at rest (read only when
// splits > 1).  flag: (2,) int32, zero at rest; tel: null or the (3,) int64
// counters.
extern "C" int fp_dequant_fallback(const void* x, int x_kind, const void* q,
                                   const void* scale, void* y, int y_kind, int route, int M,
                                   int K, int N, int rows, int row_tiles, int col_tiles,
                                   int nks, int kc, int splits, int items, int grid, void* ws,
                                   void* tickets, void* flag, void* tel, void* stream) {
  if (M <= 0 || N <= 0) return 0;
  Args a = {};
  a.x = x;
  a.q = static_cast<const int8_t*>(q);
  a.scale = static_cast<const float*>(scale);
  a.y = y;
  a.ws = static_cast<float*>(ws);
  a.tickets = static_cast<int*>(tickets);
  a.flag = static_cast<int*>(flag);
  a.tel = static_cast<unsigned long long*>(tel);
  a.M = M;
  a.K = K;
  a.N = N;
  a.rows = rows;
  a.row_tiles = row_tiles;
  a.col_tiles = col_tiles;
  a.nks = nks;
  a.kc = kc;
  a.splits = splits;
  a.items = items;
  if (!flag || route < GENERIC || route > WGMMA || !plan_ok(a, route, x_kind, grid))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (route == WGMMA)
    return y_kind == 0 ? wg::dispatch<float>(a, grid, st)
                       : wg::dispatch<__nv_bfloat16>(a, grid, st);
  const bool vec = route == FMA;
  return x_kind == 0 ? launch_fma_y<float>(a, y_kind, vec, grid, st)
                     : launch_fma_y<__nv_bfloat16>(a, y_kind, vec, grid, st);
}
