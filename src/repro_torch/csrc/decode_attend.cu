// Flash-decode attention over an int8 KV cache, plain and with wo's PDQ
// prologue fused into its output stage, written by hand for Hopper (sm_90a).
//
// decode_attend_i8kv replaces the Pallas TPU kernel decode_attend_i8kv_p
// (src/repro/kernels/kv_cache.py:62, pallas_call at :83).  For one query
// token per batch row b and every query head h (kv head h / G):
//   o[b, h] = softmax_s(q[b, h] . (k[b, h/G, s] * ks[b, h/G, s]) / sqrt(Dh))
//             . (v[b, h/G, s] * vs[b, h/G, s]),   s < length[b]
// with k/v int8 in kernel layout (B, Hkv, Sp, Dh) and f32 scales per
// (head, position).
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
// ratio of compute to bandwidth.
//
// Design (simple and right first): one block of 128 threads per (kv head,
// batch row); 256 blocks at stablelm-1.6b's full width.  The block walks
// its row in tiles of 128 positions up to length[b] only: tiles past the
// length are never read (the TPU kernel streamed the whole cache and
// masked it), and the ragged last tile is masked here.  A tile's K and V
// rows are copied to shared memory with 16-byte loads; K rows are padded
// to an odd word stride so that thread t reading row t hits distinct
// banks.  Thread t computes the G logits of position t, dequantizing K in
// registers; an online softmax (running max and sum per query head, exact
// zeros for masked positions, expf and IEEE arithmetic, no fast math)
// rescales the accumulators; then each thread owns up to 8 of the G * Dh
// outputs and sums p * v over the tile.  Reductions use fixed shuffle
// trees and a fixed order across warps: no float atomics, the same result
// every run.  Split-S (several blocks per row and a combine step) and TMA
// are later work.
//
// The fused prologue needs every head of a row.  Each block writes its o
// slice, fences, and draws an atomic ticket for its batch row; the block
// that draws the last ticket reads the row back from L2, reduces amax,
// s1 and s2 in a fixed order, quantizes, and resets the row's ticket to 0,
// so the ticket buffer is zero again for the next launch on the stream.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;            // one position of a tile per thread
constexpr int TILE = THREADS;
constexpr int WARPS = THREADS / 32;
constexpr int GMAX = 8;                 // query heads per kv head
constexpr int DMAX = 128;               // head dim, a multiple of 16
constexpr int KWORDS = DMAX / 4 + 1;    // padded K row: odd stride in words
constexpr int ACC = GMAX * DMAX / THREADS;

struct Smem {
  int kt[TILE][KWORDS];                 // K tile, 4 int8 a word
  int4 vt[TILE][DMAX / 16];             // V tile
  float q[GMAX][DMAX];
  float p[GMAX][TILE];
  float ks[TILE], vs[TILE];
  float wmax[GMAX][WARPS], wsum[GMAX][WARPS];
  float m[GMAX], l[GMAX], corr[GMAX];
};

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
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
    amax = fmaxf(amax, fabsf(v));
    t1 += v;
    t2 = __fadd_rn(t2, __fmul_rn(v, v));
  }
  amax = warp_max(amax);
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
      a = fmaxf(a, part[0][w]);
      b += part[1][w];
      c += part[2][w];
    }
    const float sc = fmaxf(a, 1e-8f) / 127.0f;
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

template <bool FUSED>
__global__ void __launch_bounds__(THREADS)
attend_kernel(const float* __restrict__ q, const int8_t* __restrict__ kq,
              const int8_t* __restrict__ vq, const float* __restrict__ ksc,
              const float* __restrict__ vsc, const int* __restrict__ length,
              float* __restrict__ o, int Hkv, int G, int Sp, int Dh, float scale,
              bool pro_bf16, int8_t* __restrict__ oq, float* __restrict__ osx,
              float* __restrict__ os1, float* __restrict__ os2,
              int* __restrict__ tickets) {
  __shared__ Smem sm;
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
    float lg[GMAX];
#pragma unroll
    for (int g = 0; g < GMAX; ++g) lg[g] = 0.f;
    if (tid < nt) {
      const float kscale = sm.ks[tid];
      for (int w = 0; w < Dh / 4; ++w) {
        const int word = sm.kt[tid][w];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float kf = static_cast<float>(static_cast<int8_t>(word >> (8 * j))) * kscale;
#pragma unroll
          for (int g = 0; g < GMAX; ++g)
            if (g < G) lg[g] += sm.q[g][4 * w + j] * kf;
        }
      }
    }
#pragma unroll
    for (int g = 0; g < GMAX; ++g) {
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
    for (int g = 0; g < GMAX; ++g) {
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

template <bool FUSED>
int launch(const void* q, const void* kq, const void* vq, const void* ks,
           const void* vs, const void* length, void* o, int B, int Hkv, int G,
           int Sp, int Dh, bool pro_bf16, void* oq, void* sx, void* s1, void* s2,
           void* tickets, void* stream) {
  if (B <= 0 || Hkv <= 0) return 0;
  if (G < 1 || G > GMAX || Dh < 16 || Dh > DMAX || Dh % 16 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(Hkv), static_cast<unsigned>(B));
  attend_kernel<FUSED><<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const int8_t*>(kq),
      static_cast<const int8_t*>(vq), static_cast<const float*>(ks),
      static_cast<const float*>(vs), static_cast<const int*>(length),
      static_cast<float*>(o), Hkv, G, Sp, Dh, 1.0f / sqrtf(static_cast<float>(Dh)),
      pro_bf16, static_cast<int8_t*>(oq), static_cast<float*>(sx),
      static_cast<float*>(s1), static_cast<float*>(s2), static_cast<int*>(tickets));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q (B, Hkv * G, Dh) f32; kq/vq (B, Hkv, Sp, Dh) int8, 16-byte aligned;
// ks/vs (B, Hkv, Sp) f32; length (B,) int32; o (B, Hkv * G, Dh) f32 out.
// G <= 8, Dh a multiple of 16 up to 128, B <= 65535.
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
