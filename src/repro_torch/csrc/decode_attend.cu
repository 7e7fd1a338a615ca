// Flash-decode attention over an int8 KV cache, plain and with wo's PDQ
// prologue fused into its output stage, written by hand for Hopper (sm_90a).
//
// decode_attend_i8kv replaces the Pallas TPU kernel decode_attend_i8kv_p
// (src/repro/kernels/kv_cache.py:62, pallas_call at :83).  For one query
// token per batch row b and every query head h (kv head h / G):
//   o[b, h] = softmax_s(q[b, h] . (k[b, h/G, s] * ks[b, h/G, s]) / sqrt(Dh))
//             . (v[b, h/G, s] * vs[b, h/G, s]),   s < length[b]
// with k/v int8 in kernel layout (B, Hkv, Sp, Dh) and f32 scales per
// (head, position).  A row of length 0 gives o = 0.
//
// decode_attend_i8kv_fused replaces decode_attend_i8kv_fused_p
// (src/repro/kernels/kv_cache.py:161, pallas_call at :193): the same
// attention, then the PDQ prologue of each row's flattened (H * Dh) output,
// rounded first to bf16 when pro_bf16 is set (the reference's ops-level
// contract; its TPU kernel skips that cast):
//   s_x = max(amax, 1e-8) / 127,  o_q = clip(rint(o / s_x), +-127),
//   s1 = sum o,  s2 = sum o^2.
//
// Bound on the H100: bytes.  Each valid position moves 2 * Dh int8 bytes
// and two f32 scales and costs ~4 * G * Dh flops: far below the card's
// ratio of compute to bandwidth.  At decode sizes (a few MB) the kernel is
// bound by latency instead: how many dependent trips to memory its longest
// path makes, and how many SMs share the rows.
//
// Two routes, both with a fixed summation order (no float atomics: two
// launches give the same bits), both leaving every ticket at zero.
//
// "split" (decode_attend_i8kv_split; the route every caller takes):
// Flash-Decoding.  The grid is (splits, Hkv, B) with splits = ceil(Sp /
// CHUNK), sized from the cache's shape and never from length (which lives
// on the device; reading it would sync the host every step).  Block (s, h,
// b) owns positions [s * CHUNK, (s + 1) * CHUNK) of row b; a block whose
// chunk starts at or past length[b] returns before any load (block 0 always
// runs, so that a row of length 0 writes its zeros).  CHUNK = 128 = one
// position per thread.  Inside a block:
//   - q's loads go out beside length's; then two cp.async stages: the
//     chunk's valid K rows (stage 1) and V rows (stage 2), in 16-byte units
//     that consecutive threads copy from consecutive addresses, so a warp
//     moves whole lines.  The block waits for stage 1 only, so V is in
//     flight while the logits and the softmax are computed.  K rows sit at
//     an odd stride of 16-byte units, so a quarter-warp's 16-byte reads of
//     its own rows hit distinct banks.
//   - logits: thread t dots position t's K row with q (shared, broadcast
//     float4 reads); int8 turns into f32 exactly by a byte permute into the
//     mantissa of 2^23 and one subtraction (no I2F, a quarter-rate unit).
//   - softmax and P.V per warp over its 32 positions: lanes split a V row
//     into 4-byte words, lane groups take alternate positions four at a
//     time (their weights p * vs from shared memory), a fixed xor-shuffle
//     tree sums the groups; then the 4 warps' (m, l, acc) merge through
//     shared memory in warp order.
// A row whose valid prefix fits one chunk is written at once.  Otherwise
// each split writes its partial (m, l, acc[G * Dh]) in f32 to a workspace
// and draws a ticket for its (b, h) behind a release fence (take_ticket);
// the block that draws the last one merges the partials in split order,
//   m = max m_i,  l = sum l_i e^(m_i - m),  o = sum acc_i e^(m_i - m) / l,
// reading them all back from L2 (its own too), so the bits do not depend on
// which block came last, and resets the ticket.  K5 adds a second ticket
// per batch row over that row's Hkv merges; its last block runs the
// prologue (row_prologue, shared with the single route).  No wait spins:
// a block that is not last simply exits.  The workspace is never filled:
// a merge reads only the records its row's active splits have written.
//
// "single" (decode_attend_i8kv / decode_attend_i8kv_fused; the first
// design, kept to time the two against each other in one call): one block
// of 128 threads per (kv head, batch row) walks its row in 128-position
// tiles up to length[b], staging each tile with plain 16-byte loads; an
// online softmax rescales the accumulators tile by tile, and 64-128
// threads each own outputs and sum p * v over the tile serially.
// K5's last block per row (an atomic ticket) runs the prologue.
//
// Both routes: expf and IEEE arithmetic, no fast math; reductions in fixed
// shuffle trees and fixed orders across warps and splits.
//
// Shapes: Dh a multiple of 16, and G <= 8 at Dh <= 128 (the (8, 128)
// instance; the main path's (1, 64) has a lean one on the split route) or
// G <= 2 at Dh <= 256 (the wide instance, gemma3-12b's global layers: G 2,
// Dh 256).  The wide instance's split block holds 128 K rows and 128 V rows
// of 256 bytes (~70 KB of shared memory, dynamic) and a lane two 4-byte
// words of a V row in P.V; its merge, tickets and K5's prologue over the
// H * Dh row are the same code as at Dh 64.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;            // one position of a tile per thread
constexpr int TILE = THREADS;
constexpr int WARPS = THREADS / 32;
// The two register and shared-memory plans, both routes: up to GMAX query
// heads per kv head at a head dim up to DMAX (G * Dh up to 1024: yi-6b's
// G 8, Dh 128 fills it), or up to GWIDE heads at a head dim up to DWIDE
// (G * Dh up to 512: gemma3-12b's G 2, Dh 256).  Dh is a multiple of 16.  Each instance's shared memory is
// dynamic (the wide one needs ~70 KB, past the 48 KB of a static array),
// its limit raised once per device, at the first launch there (set_smem).
constexpr int GMAX = 8, DMAX = 128;
constexpr int GWIDE = 2, DWIDE = 256;

template <int GM, int DM>
struct Smem {
  int kt[TILE][DM / 4 + 1];             // K tile, 4 int8 a word; odd stride in words
  int4 vt[TILE][DM / 16];               // V tile
  float q[GM][DM];
  float p[GM][TILE];
  float ks[TILE], vs[TILE];
  float wmax[GM][WARPS], wsum[GM][WARPS];
  float m[GM], l[GM], corr[GM];
};

// Raise ``kernel``'s dynamic shared memory limit to ``bytes`` once per
// device (the attribute is the current device's), ``done`` being the
// instance's own flags (the first launch of each instance on a device,
// outside any graph capture: the decode graph warms its block up first).
// Past MAX_DEVICES a device raises it at every launch.
constexpr int MAX_DEVICES = 64;
template <typename K>
cudaError_t set_smem(K kernel, int bytes, bool (&done)[MAX_DEVICES]) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const bool kept = dev >= 0 && dev < MAX_DEVICES;
  if (kept && done[dev]) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess && kept) done[dev] = true;
  return e;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// max(a, b) that returns NaN when either is NaN (PTX max.NaN, sm_80+): wo's
// prologue takes its row maximum with it, as torch.amax / jnp.max do, so a
// NaN in o gives a NaN s_x.  The softmax maxima keep fmaxf.
__device__ __forceinline__ float max_nan(float a, float b) {
  float d;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

__device__ __forceinline__ float warp_max_nan(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = max_nan(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// The last block of batch row b: wo's PDQ prologue over o[b] (n values).
__device__ void row_prologue(const float* __restrict__ orow, int n, bool pro_bf16,
                             int8_t* __restrict__ oq, float* __restrict__ sx,
                             float* __restrict__ s1, float* __restrict__ s2) {
  __shared__ float part[3][WARPS];
  __shared__ float scale;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float amax = 0.f, t1 = 0.f, t2 = 0.f;
  for (int i = threadIdx.x; i < n; i += THREADS) {
    float v = __ldcg(orow + i);
    if (pro_bf16) v = __bfloat162float(__float2bfloat16_rn(v));
    amax = max_nan(amax, fabsf(v));
    t1 += v;
    t2 = __fadd_rn(t2, __fmul_rn(v, v));
  }
  amax = warp_max_nan(amax);
  t1 = warp_sum(t1);
  t2 = warp_sum(t2);
  if (lane == 0) {
    part[0][warp] = amax;
    part[1][warp] = t1;
    part[2][warp] = t2;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float a = 0.f, b = 0.f, c = 0.f;
    for (int w = 0; w < WARPS; ++w) {
      a = max_nan(a, part[0][w]);
      b += part[1][w];
      c += part[2][w];
    }
    const float sc = max_nan(a, 1e-8f) / 127.0f;
    scale = sc;
    *sx = sc;
    *s1 = b;
    *s2 = c;
  }
  __syncthreads();
  const float sc = scale;
  for (int i = threadIdx.x; i < n; i += THREADS) {
    float v = __ldcg(orow + i);
    if (pro_bf16) v = __bfloat162float(__float2bfloat16_rn(v));
    const int q = __float2int_rn(v / sc);
    oq[i] = static_cast<int8_t>(max(-127, min(127, q)));
  }
}

template <int GM, int DM, bool FUSED>
__global__ void __launch_bounds__(THREADS)
attend_kernel(const float* __restrict__ q, const int8_t* __restrict__ kq,
              const int8_t* __restrict__ vq, const float* __restrict__ ksc,
              const float* __restrict__ vsc, const int* __restrict__ length,
              float* __restrict__ o, int Hkv, int G, int Sp, int Dh, float scale,
              bool pro_bf16, int8_t* __restrict__ oq, float* __restrict__ osx,
              float* __restrict__ os1, float* __restrict__ os2,
              int* __restrict__ tickets) {
  constexpr int ACC = GM * DM / THREADS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<GM, DM>& sm = *reinterpret_cast<Smem<GM, DM>*>(smem_raw);
  __shared__ int is_last;
  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int H = Hkv * G, GD = G * Dh, dw = Dh / 16;
  const long long slab = static_cast<long long>(b) * Hkv + h;   // (b, h) of the cache
  const int8_t* kb = kq + slab * Sp * Dh;
  const int8_t* vb = vq + slab * Sp * Dh;
  const float* ksb = ksc + slab * Sp;
  const float* vsb = vsc + slab * Sp;
  const int n = min(max(length[b], 0), Sp);

  const float* qb = q + (static_cast<long long>(b) * H + static_cast<long long>(h) * G) * Dh;
  for (int i = tid; i < GD; i += THREADS) sm.q[i / Dh][i % Dh] = qb[i];
  if (tid < G) {
    sm.m[tid] = -INFINITY;
    sm.l[tid] = 0.f;
  }
  float acc[ACC];
#pragma unroll
  for (int r = 0; r < ACC; ++r) acc[r] = 0.f;
  __syncthreads();                      // m, l and q before any reader (n may be 0)

  for (int t0 = 0; t0 < n; t0 += TILE) {
    const int nt = min(TILE, n - t0);
    // stage the tile: 16-byte loads of K and V rows, and the scales
    for (int c = tid; c < nt * dw; c += THREADS) {
      const int r = c / dw, w = c % dw;
      const long long off = static_cast<long long>(t0 + r) * Dh + 16 * w;
      const int4 kv4 = *reinterpret_cast<const int4*>(kb + off);
      sm.kt[r][4 * w + 0] = kv4.x;
      sm.kt[r][4 * w + 1] = kv4.y;
      sm.kt[r][4 * w + 2] = kv4.z;
      sm.kt[r][4 * w + 3] = kv4.w;
      sm.vt[r][w] = *reinterpret_cast<const int4*>(vb + off);
    }
    if (tid < nt) {
      sm.ks[tid] = ksb[t0 + tid];
      sm.vs[tid] = vsb[t0 + tid];
    }
    __syncthreads();

    // logits of position tid for every query head of the group
    float lg[GM];
#pragma unroll
    for (int g = 0; g < GM; ++g) lg[g] = 0.f;
    if (tid < nt) {
      const float kscale = sm.ks[tid];
      for (int w = 0; w < Dh / 4; ++w) {
        const int word = sm.kt[tid][w];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float kf = static_cast<float>(static_cast<int8_t>(word >> (8 * j))) * kscale;
#pragma unroll
          for (int g = 0; g < GM; ++g)
            if (g < G) lg[g] += sm.q[g][4 * w + j] * kf;
        }
      }
    }
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      if (g >= G) break;
      lg[g] = tid < nt ? lg[g] * scale : -INFINITY;
      const float mx = warp_max(lg[g]);
      if (lane == 0) sm.wmax[g][warp] = mx;
    }
    __syncthreads();
    if (tid < G) {
      float mt = sm.wmax[tid][0];
      for (int w = 1; w < WARPS; ++w) mt = fmaxf(mt, sm.wmax[tid][w]);
      const float m_new = fmaxf(sm.m[tid], mt);     // finite: the tile has a valid position
      sm.corr[tid] = expf(sm.m[tid] - m_new);
      sm.m[tid] = m_new;
    }
    __syncthreads();
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      if (g >= G) break;
      const float p = tid < nt ? expf(lg[g] - sm.m[g]) : 0.f;
      sm.p[g][tid] = p;
      const float s = warp_sum(p);
      if (lane == 0) sm.wsum[g][warp] = s;
    }
    __syncthreads();
    if (tid < G) {
      float s = 0.f;
      for (int w = 0; w < WARPS; ++w) s += sm.wsum[tid][w];
      sm.l[tid] = sm.l[tid] * sm.corr[tid] + s;
    }
    // acc[g, d] = acc * corr[g] + sum_t p[g, t] * v[t, d] * vs[t]
#pragma unroll
    for (int r = 0; r < ACC; ++r) {
      const int i = tid + r * THREADS;
      if (i >= GD) break;
      const int g = i / Dh, d = i % Dh;
      float a = acc[r] * sm.corr[g];
      for (int t = 0; t < nt; ++t) {
        const int8_t vb8 = reinterpret_cast<const int8_t*>(sm.vt[t])[d];
        a += sm.p[g][t] * (static_cast<float>(vb8) * sm.vs[t]);
      }
      acc[r] = a;
    }
    __syncthreads();
  }

  float* ob = o + (static_cast<long long>(b) * H + static_cast<long long>(h) * G) * Dh;
#pragma unroll
  for (int r = 0; r < ACC; ++r) {
    const int i = tid + r * THREADS;
    if (i >= GD) break;
    ob[i] = acc[r] / fmaxf(sm.l[i / Dh], 1e-30f);
  }
  if (!FUSED) return;

  __threadfence();
  __syncthreads();
  if (tid == 0) is_last = atomicAdd(&tickets[b], 1) == Hkv - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  const long long row = static_cast<long long>(b) * H * Dh;
  row_prologue(o + row, H * Dh, pro_bf16, oq + row, osx + b, os1 + b, os2 + b);
  if (tid == 0) tickets[b] = 0;
}

template <int GM, int DM, bool FUSED>
int launch_single(const void* q, const void* kq, const void* vq, const void* ks,
                  const void* vs, const void* length, void* o, int B, int Hkv, int G,
                  int Sp, int Dh, bool pro_bf16, void* oq, void* sx, void* s1, void* s2,
                  void* tickets, void* stream) {
  auto kernel = attend_kernel<GM, DM, FUSED>;
  constexpr int SMEM = sizeof(Smem<GM, DM>);
  static bool smem_set[MAX_DEVICES] = {};
  const cudaError_t e = set_smem(kernel, SMEM, smem_set);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(static_cast<unsigned>(Hkv), static_cast<unsigned>(B));
  kernel<<<grid, THREADS, SMEM, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const int8_t*>(kq),
      static_cast<const int8_t*>(vq), static_cast<const float*>(ks),
      static_cast<const float*>(vs), static_cast<const int*>(length),
      static_cast<float*>(o), Hkv, G, Sp, Dh, 1.0f / sqrtf(static_cast<float>(Dh)),
      pro_bf16, static_cast<int8_t*>(oq), static_cast<float*>(sx),
      static_cast<float*>(s1), static_cast<float*>(s2), static_cast<int*>(tickets));
  return static_cast<int>(cudaGetLastError());
}

// Which plan takes (G, Dh): 0 the (GMAX, DMAX) one, 1 the wide one, -1 none.
int plan_for(int G, int Dh) {
  if (G < 1 || Dh < 16 || Dh % 16) return -1;
  if (G <= GMAX && Dh <= DMAX) return 0;
  if (G <= GWIDE && Dh <= DWIDE) return 1;
  return -1;
}

// The split route's instance for (G, Dh): 0 the lean (LEAN_G, LEAN_D) one
// (the main path's G 1, Dh 64), 1 the (GMAX, DMAX) one, 2 the wide one, -1
// none.
constexpr int LEAN_G = 1, LEAN_D = 64;
int split_instance(int G, int Dh) {
  const int plan = plan_for(G, Dh);
  if (plan < 0) return -1;
  return G <= LEAN_G && Dh <= LEAN_D ? 0 : plan + 1;
}

template <bool FUSED>
int launch(const void* q, const void* kq, const void* vq, const void* ks,
           const void* vs, const void* length, void* o, int B, int Hkv, int G,
           int Sp, int Dh, bool pro_bf16, void* oq, void* sx, void* s1, void* s2,
           void* tickets, void* stream) {
  if (B <= 0 || Hkv <= 0) return 0;
  const int plan = plan_for(G, Dh);
  if (plan < 0 || B > 65535) return static_cast<int>(cudaErrorInvalidValue);
  return plan == 0
             ? launch_single<GMAX, DMAX, FUSED>(q, kq, vq, ks, vs, length, o, B, Hkv, G, Sp,
                                                Dh, pro_bf16, oq, sx, s1, s2, tickets, stream)
             : launch_single<GWIDE, DWIDE, FUSED>(q, kq, vq, ks, vs, length, o, B, Hkv, G,
                                                  Sp, Dh, pro_bf16, oq, sx, s1, s2, tickets,
                                                  stream);
}

// ------------------------------------------------------------ split route
namespace split {

constexpr int WARPS_S = 4;
constexpr int CHUNK = 32 * WARPS_S;     // positions per split, one per thread
static_assert(CHUNK == THREADS, "row_prologue runs on a block of THREADS");

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four int8 values (one word) as exact f32: the byte x + 128 placed in the
// mantissa of 2^23 is 2^23 + 128 + x; one subtraction leaves x.
__device__ __forceinline__ void i8x4_to_f32(int w, float* f) {
  const unsigned u = static_cast<unsigned>(w) ^ 0x80808080u;
  f[0] = __int_as_float(__byte_perm(u, 0x4B000000u, 0x7440)) - 8388736.0f;
  f[1] = __int_as_float(__byte_perm(u, 0x4B000000u, 0x7441)) - 8388736.0f;
  f[2] = __int_as_float(__byte_perm(u, 0x4B000000u, 0x7442)) - 8388736.0f;
  f[3] = __int_as_float(__byte_perm(u, 0x4B000000u, 0x7443)) - 8388736.0f;
}

// A block's ticket after its global writes, in the release / acquire
// pattern of CUTLASS's barriers: the block's barrier orders its threads'
// writes before thread 0's acq_rel fence, which publishes them at gpu scope
// (fences are cumulative) before the relaxed atomic draws; the block that
// draws the last of ``count`` fences again before the barrier that lets its
// threads read the others' writes, and resets the ticket.  Returns true for
// every block but the last.
__device__ __forceinline__ bool take_ticket(int* ticket, int count, int* is_last) {
  __syncthreads();
  if (threadIdx.x == 0) {
    int prev;
    asm volatile("fence.acq_rel.gpu;\n\tatom.relaxed.gpu.global.add.s32 %0, [%1], 1;"
                 : "=r"(prev) : "l"(ticket) : "memory");
    const bool last = prev == count - 1;
    if (last) {
      asm volatile("fence.acq_rel.gpu;" ::: "memory");
      *ticket = 0;
    }
    *is_last = last;
  }
  __syncthreads();
  return !*is_last;
}

// GM query heads per kv head and DM head dim at most; the main path (G 1,
// Dh 64) gets a lean instance, every other shape the (8, 128) one up to Dh
// 128, and the wide (2, 256) one past it (gemma3-12b's global layers).
template <int GM, int DM>
struct SplitSmem {
  union {
    int4 kt[CHUNK * (DM / 16 + 1)];     // K rows, (Dh / 16) | 1 units apart
    struct {
      float m[WARPS_S][GM], l[WARPS_S][GM];
      float acc[WARPS_S][GM * DM];
    } red;                              // the warps' partials, after the logits
  } u;
  int4 vt[CHUNK * DM / 16];             // V rows, Dh bytes apart
  float4 q[GM * DM / 4];
  float pw[WARPS_S][GM][32];            // p * vs of each warp's positions
};

template <int GM, int DM, bool FUSED>
__global__ void __launch_bounds__(CHUNK)
split_kernel(const float* __restrict__ q, const int8_t* __restrict__ kq,
             const int8_t* __restrict__ vq, const float* __restrict__ ksc,
             const float* __restrict__ vsc, const int* __restrict__ length,
             float* __restrict__ o, int B, int Hkv, int G, int Sp, int Dh,
             float scale, float* __restrict__ ws, int rec, int* __restrict__ tickets,
             bool pro_bf16, int8_t* __restrict__ oq, float* __restrict__ osx,
             float* __restrict__ os1, float* __restrict__ os2) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  SplitSmem<GM, DM>& sm = *reinterpret_cast<SplitSmem<GM, DM>*>(smem_raw);
  __shared__ int is_last;
  const int s = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int H = Hkv * G, GD = G * Dh, du = Dh / 16, ku = du | 1, wr = Dh / 4;
  // q's loads go out beside length's
  const float* qb = q + (static_cast<long long>(b) * H + static_cast<long long>(h) * G) * Dh;
  constexpr int QR = (GM * DM + CHUNK - 1) / CHUNK;
  float qr[QR];
#pragma unroll
  for (int r = 0; r < QR; ++r)
    if (tid + r * CHUNK < GD) qr[r] = qb[tid + r * CHUNK];
  const int n = min(max(length[b], 0), Sp);
  const int nsplit = max(1, (n + CHUNK - 1) / CHUNK);
  if (s >= nsplit) return;              // past the valid prefix: no loads

  const long long slab = static_cast<long long>(b) * Hkv + h;
  const int p = s * CHUNK + tid;
  const bool valid = p < n;
  const int nb = min(CHUNK, n - s * CHUNK);          // valid positions here
  const long long base = (slab * Sp + s * CHUNK) * Dh;

  // the scales, then stage 1, the chunk's K rows, and stage 2, its V rows,
  // each copied in 16-byte units that consecutive threads take from
  // consecutive addresses (whole lines a warp); V stays in flight through
  // the logits and the softmax
  const float ks = valid ? ksc[slab * Sp + p] : 0.f;
  const float vs = valid ? vsc[slab * Sp + p] : 0.f;
  for (int c = tid; c < nb * du; c += CHUNK)
    cp_async16(&sm.u.kt[(c / du) * ku + c % du], kq + base + 16LL * c);
  cp_async_commit();
  for (int c = tid; c < nb * du; c += CHUNK) cp_async16(&sm.vt[c], vq + base + 16LL * c);
  cp_async_commit();
  float* qs = reinterpret_cast<float*>(sm.q);
#pragma unroll
  for (int r = 0; r < QR; ++r) {
    const int i = tid + r * CHUNK;
    if (i < GD) qs[(i / Dh) * DM + i % Dh] = qr[r];
  }
  cp_async_wait<1>();
  __syncthreads();                      // q and every K row in place

  // logits of position p for the G query heads
  float lg[GM];
#pragma unroll
  for (int g = 0; g < GM; ++g) lg[g] = 0.f;
  if (valid) {
#pragma unroll
    for (int u = 0; u < DM / 16; ++u) {
      if (u >= du) break;
      const int4 kw = sm.u.kt[tid * ku + u];
      float kf[16];
      i8x4_to_f32(kw.x, kf);
      i8x4_to_f32(kw.y, kf + 4);
      i8x4_to_f32(kw.z, kf + 8);
      i8x4_to_f32(kw.w, kf + 12);
#pragma unroll
      for (int g = 0; g < GM; ++g) {
        if (g >= G) break;
        float a = lg[g];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float4 qq = sm.q[g * (DM / 4) + 4 * u + j];
          a = fmaf(qq.x, kf[4 * j], a);
          a = fmaf(qq.y, kf[4 * j + 1], a);
          a = fmaf(qq.z, kf[4 * j + 2], a);
          a = fmaf(qq.w, kf[4 * j + 3], a);
        }
        lg[g] = a;
      }
    }
  }

  // the warp's softmax over its 32 positions; p * vs weighs V's row
  float mw[GM], lw[GM];
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    if (g >= G) break;
    const float x = valid ? lg[g] * ks * scale : -INFINITY;
    mw[g] = warp_max(x);
    const float pr = valid ? expf(x - mw[g]) : 0.f;
    lw[g] = warp_sum(pr);
    sm.pw[warp][g][lane] = pr * vs;
  }

  // P.V: a lane group of LG lanes covers one V row in 4-byte words (a lane
  // WM of them, WM = 2 past Dh 128, where a row has more words than a warp
  // has lanes); the 32 / LG groups take alternate positions of the warp's
  // valid ones, four at a time so that their shared-memory reads are in
  // flight together.  Rows past the valid ones are read too (finite int8
  // codes) and weighed 0.
  cp_async_wait<0>();
  __syncthreads();                      // every V row (and p * vs) in place
  constexpr int WM = (DM / 4 + 31) / 32;
  const int LG = wr > 16 ? 32 : wr > 8 ? 16 : wr > 4 ? 8 : 4;
  const int groups = 32 / LG, grp = lane / LG;
  int wi[WM];
#pragma unroll
  for (int k = 0; k < WM; ++k) wi[k] = min(lane % LG + k * LG, wr - 1);
  const int nv = min(max(n - (s * CHUNK + 32 * warp), 0), 32);
  const int* vw = reinterpret_cast<const int*>(sm.vt) + warp * 32 * wr;
  float acc[GM][4 * WM];
#pragma unroll
  for (int g = 0; g < GM; ++g)
#pragma unroll
    for (int e = 0; e < 4 * WM; ++e) acc[g][e] = 0.f;
  for (int j0 = grp; j0 < nv; j0 += 4 * groups) {
    int word[4][WM];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int k = 0; k < WM; ++k) word[r][k] = vw[min(j0 + r * groups, 31) * wr + wi[k]];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int j = j0 + r * groups;
#pragma unroll
      for (int k = 0; k < WM; ++k) {
        float vf[4];
        i8x4_to_f32(word[r][k], vf);
#pragma unroll
        for (int g = 0; g < GM; ++g) {
          if (g >= G) break;
          const float w = j < nv ? sm.pw[warp][g][min(j, 31)] : 0.f;
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[g][4 * k + e] = fmaf(w, vf[e], acc[g][4 * k + e]);
        }
      }
    }
  }
  for (int off = LG; off < 32; off <<= 1)
#pragma unroll
    for (int g = 0; g < GM; ++g)
#pragma unroll
      for (int e = 0; e < 4 * WM; ++e)
        acc[g][e] += __shfl_xor_sync(0xffffffffu, acc[g][e], off);

  // the 4 warps' partials merge in warp order (the K rows' space is reused)
  __syncthreads();
  if (lane == 0)
#pragma unroll
    for (int g = 0; g < GM; ++g)
      if (g < G) {
        sm.u.red.m[warp][g] = mw[g];
        sm.u.red.l[warp][g] = lw[g];
      }
#pragma unroll
  for (int k = 0; k < WM; ++k) {
    const int w = lane + k * LG;        // lanes of group 0 hold the sums
    if (lane < LG && w < wr)
#pragma unroll
      for (int g = 0; g < GM; ++g)
        if (g < G)
#pragma unroll
          for (int e = 0; e < 4; ++e) sm.u.red.acc[warp][g * Dh + 4 * w + e] = acc[g][4 * k + e];
  }
  __syncthreads();

  float* ob = o + (static_cast<long long>(b) * H + static_cast<long long>(h) * G) * Dh;
  float* rb = ws + (slab * gridDim.x + s) * rec;      // this split's record: m, l, acc
  for (int i = tid; i < GD; i += CHUNK) {
    const int g = i / Dh;
    float m = -INFINITY;
    for (int w = 0; w < WARPS_S; ++w) m = fmaxf(m, sm.u.red.m[w][g]);
    float l = 0.f, a = 0.f;
    for (int w = 0; w < WARPS_S; ++w) {
      const float mi = sm.u.red.m[w][g];
      const float f = mi == -INFINITY ? 0.f : expf(mi - m);
      l += sm.u.red.l[w][g] * f;
      a += sm.u.red.acc[w][i] * f;
    }
    if (nsplit == 1) {
      ob[i] = a / fmaxf(l, 1e-30f);
    } else {
      if (i % Dh == 0) {
        rb[g] = m;
        rb[G + g] = l;
      }
      rb[2 * G + i] = a;
    }
  }

  if (nsplit > 1) {
    // the last split of (b, h) merges every split's record in split order
    if (take_ticket(&tickets[slab], nsplit, &is_last)) return;
    const float* r0 = ws + slab * gridDim.x * rec;
    for (int i = tid; i < GD; i += CHUNK) {
      const int g = i / Dh;
      float m = -INFINITY;
#pragma unroll 4
      for (int k = 0; k < nsplit; ++k) m = fmaxf(m, __ldcg(r0 + k * rec + g));
      float l = 0.f, a = 0.f;
#pragma unroll 4
      for (int k = 0; k < nsplit; ++k) {
        const float* r = r0 + k * rec;
        const float f = expf(__ldcg(r + g) - m);
        l += __ldcg(r + G + g) * f;
        a += __ldcg(r + 2 * G + i) * f;
      }
      ob[i] = a / fmaxf(l, 1e-30f);
    }
  }
  if (!FUSED) return;

  // K5: the last of row b's Hkv merges runs wo's prologue over the row
  if (take_ticket(&tickets[static_cast<long long>(B) * Hkv + b], Hkv, &is_last)) return;
  const long long orow = static_cast<long long>(b) * H * Dh;
  row_prologue(o + orow, H * Dh, pro_bf16, oq + orow, osx + b, os1 + b, os2 + b);
}

template <int GM, int DM, bool FUSED>
cudaError_t launch_split(dim3 grid, cudaStream_t st, const void* q, const void* kq,
                         const void* vq, const void* ks, const void* vs,
                         const void* length, void* o, int B, int Hkv, int G, int Sp,
                         int Dh, void* ws, int rec, void* tickets, bool pro_bf16, void* oq,
                         void* sx, void* s1, void* s2) {
  auto kernel = split_kernel<GM, DM, FUSED>;
  constexpr int SMEM = sizeof(SplitSmem<GM, DM>);
  static bool smem_set[MAX_DEVICES] = {};
  const cudaError_t e = set_smem(kernel, SMEM, smem_set);
  if (e != cudaSuccess) return e;
  kernel<<<grid, CHUNK, SMEM, st>>>(
      static_cast<const float*>(q), static_cast<const int8_t*>(kq),
      static_cast<const int8_t*>(vq), static_cast<const float*>(ks),
      static_cast<const float*>(vs), static_cast<const int*>(length),
      static_cast<float*>(o), B, Hkv, G, Sp, Dh,
      1.0f / sqrtf(static_cast<float>(Dh)), static_cast<float*>(ws), rec,
      static_cast<int*>(tickets), pro_bf16, static_cast<int8_t*>(oq),
      static_cast<float*>(sx), static_cast<float*>(s1), static_cast<float*>(s2));
  return cudaSuccess;
}

}  // namespace split

}  // namespace

// q (B, Hkv * G, Dh) f32; kq/vq (B, Hkv, Sp, Dh) int8, 16-byte aligned;
// ks/vs (B, Hkv, Sp) f32; length (B,) int32; o (B, Hkv * G, Dh) f32 out.
// Dh a multiple of 16, with G <= 8 up to Dh 128 or G <= 2 up to Dh 256;
// B <= 65535.
extern "C" int decode_attend_i8kv(const void* q, const void* kq, const void* vq,
                                  const void* ks, const void* vs, const void* length,
                                  void* o, int B, int Hkv, int G, int Sp, int Dh,
                                  void* stream) {
  return launch<false>(q, kq, vq, ks, vs, length, o, B, Hkv, G, Sp, Dh, false,
                       nullptr, nullptr, nullptr, nullptr, nullptr, stream);
}

// As decode_attend_i8kv, plus per batch row: oq (B, H * Dh) int8 and sx,
// s1, s2 (B,) f32, the PDQ prologue of o's row (rounded to bf16 first when
// pro_bf16 != 0).  tickets: (B,) int32, zero on entry; zero again on exit.
extern "C" int decode_attend_i8kv_fused(const void* q, const void* kq, const void* vq,
                                        const void* ks, const void* vs,
                                        const void* length, void* o, void* oq,
                                        void* sx, void* s1, void* s2, void* tickets,
                                        int B, int Hkv, int G, int Sp, int Dh,
                                        int pro_bf16, void* stream) {
  return launch<true>(q, kq, vq, ks, vs, length, o, B, Hkv, G, Sp, Dh, pro_bf16 != 0,
                      oq, sx, s1, s2, tickets, stream);
}

// The split route's instance for (G, Dh), the one decode_attend_i8kv_split
// launches: its (max G, max Dh) in *gm, *dm.  Returns 0, or
// cudaErrorInvalidValue where no instance takes the shape.
extern "C" int decode_attend_split_instance(int G, int Dh, int* gm, int* dm) {
  const int inst = split_instance(G, Dh);
  if (inst < 0) return static_cast<int>(cudaErrorInvalidValue);
  *gm = inst == 0 ? LEAN_G : inst == 1 ? GMAX : GWIDE;
  *dm = inst == 0 ? LEAN_D : inst == 1 ? DMAX : DWIDE;
  return 0;
}

// The split route of both kernels: q, kq, vq, ks, vs, length and o as
// decode_attend_i8kv; fused != 0 adds oq, sx, s1, s2 as
// decode_attend_i8kv_fused (otherwise they may be null).  splits = ceil(Sp /
// 128) (at least 1); ws: f32 scratch of B * Hkv * splits * rec values, rec
// >= G * (Dh + 2), never read before it is written; tickets: B * Hkv + B
// int32, zero on entry and zero again on exit.
extern "C" int decode_attend_i8kv_split(const void* q, const void* kq, const void* vq,
                                        const void* ks, const void* vs,
                                        const void* length, void* o, void* oq,
                                        void* sx, void* s1, void* s2, void* ws,
                                        void* tickets, int B, int Hkv, int G, int Sp,
                                        int Dh, int splits, int rec, int fused,
                                        int pro_bf16, void* stream) {
  if (B <= 0 || Hkv <= 0) return 0;
  const int plan = plan_for(G, Dh);
  if (plan < 0 || B > 65535 || Hkv > 65535 || splits < 1 ||
      static_cast<long long>(splits) * split::CHUNK < Sp || rec < G * (Dh + 2))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(splits), static_cast<unsigned>(Hkv),
                  static_cast<unsigned>(B));
  const auto st = static_cast<cudaStream_t>(stream);
  const int inst = split_instance(G, Dh);
  const bool pb = pro_bf16 != 0;
#define SPLIT(GM, DM, F)                                                                  \
  split::launch_split<GM, DM, F>(grid, st, q, kq, vq, ks, vs, length, o, B, Hkv, G, Sp, Dh, \
                                 ws, rec, tickets, pb, oq, sx, s1, s2)
  const cudaError_t e =
      inst == 0   ? (fused ? SPLIT(LEAN_G, LEAN_D, true) : SPLIT(LEAN_G, LEAN_D, false))
      : inst == 1 ? (fused ? SPLIT(GMAX, DMAX, true) : SPLIT(GMAX, DMAX, false))
                  : (fused ? SPLIT(GWIDE, DWIDE, true) : SPLIT(GWIDE, DWIDE, false));
#undef SPLIT
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}
