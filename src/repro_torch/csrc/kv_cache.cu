// Cache-row scatter (K6) and page scatter (K7), written by hand for Hopper
// (sm_90a).
//
// K6 replaces the Pallas TPU kernel cache_scatter_p
// (src/repro/kernels/kv_cache.py:246, pallas_call at :283):
//   out[b] = src[map[b]] if map[b] >= 0 else dst[b], bit-exact, any dtype.
//
// This kernel writes dst IN PLACE (the serving pool is rebound to the
// result anyway; the reference's engine donates it for the same reason),
// so rows with map[b] == -1 need no work at all: their blocks return at
// once.  A row is moved as raw bytes, whatever the element type.
//
// Bound on the H100: bytes (each landed row is read once and written once;
// no arithmetic).  Design: grid (chunks of 16 KB, rows); each thread moves
// 16-byte vectors when the row length and both bases are 16-byte aligned,
// and single bytes otherwise (the 4-byte `len` rows).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int VEC = 16;
constexpr int UNROLL = 4;
constexpr long long CHUNK = static_cast<long long>(THREADS) * VEC * UNROLL;

__global__ void __launch_bounds__(THREADS)
scatter_rows(const int* __restrict__ map, uint8_t* __restrict__ dst,
             const uint8_t* __restrict__ src, long long row_bytes, bool vec) {
  const int s = map[blockIdx.y];
  if (s < 0) return;
  uint8_t* d = dst + static_cast<long long>(blockIdx.y) * row_bytes;
  const uint8_t* sp = src + static_cast<long long>(s) * row_bytes;
  const long long base = static_cast<long long>(blockIdx.x) * CHUNK;
  if (vec) {
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long o = base + (static_cast<long long>(u) * THREADS + threadIdx.x) * VEC;
      if (o < row_bytes)
        *reinterpret_cast<int4*>(d + o) = *reinterpret_cast<const int4*>(sp + o);
    }
  } else {
    const long long stop = base + CHUNK < row_bytes ? base + CHUNK : row_bytes;
    for (long long o = base + threadIdx.x; o < stop; o += THREADS) d[o] = sp[o];
  }
}

}  // namespace

// map: (rows,) int32 in [-1, src_rows); dst: (rows, row_bytes) bytes,
// updated in place; src: (src_rows, row_bytes) bytes.  rows <= 65535.
extern "C" int cache_scatter(const void* map, void* dst, const void* src,
                             long long rows, long long row_bytes, void* stream) {
  if (rows <= 0 || row_bytes <= 0) return 0;
  const bool vec = row_bytes % VEC == 0 &&
                   reinterpret_cast<uintptr_t>(dst) % VEC == 0 &&
                   reinterpret_cast<uintptr_t>(src) % VEC == 0;
  const dim3 grid(static_cast<unsigned>((row_bytes + CHUNK - 1) / CHUNK),
                  static_cast<unsigned>(rows));
  scatter_rows<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(map), static_cast<uint8_t*>(dst),
      static_cast<const uint8_t*>(src), row_bytes, vec);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// K7: page scatter.  Replaces cache_scatter_pages_p
// (src/repro/kernels/kv_cache.py:291), which is cache_scatter_p over PAGE
// ROWS: dst page row p takes src page row map[p] where map[p] >= 0, and
// keeps its bits otherwise; exact for any dtype.
//
// The reference reaches page rows by reshaping each side (to_page_rows), a
// free relayout under XLA and a full copy of the leaf in PyTorch.  This
// kernel addresses each side in its own layout instead, from a Side: page
// row r (counted over the whole stack) starts at
//   (r / rows_per_outer) * outer_stride + (r % rows_per_outer) * page_stride
// and is the concatenation of runs of chunk_bytes, chunk_stride apart.  A
// physical pool page is one contiguous run; a logical int8 K/V leaf (n, B,
// Hkv, Sp, Dh) has rows_per_outer = Sp / page and one run of page * Dh
// bytes per kv head.  Stack entry z of an (n, rows, ...) leaf reads src
// row z * src_rows + map[p] into dst row z * dst_rows + p.
//
// Bound on the H100: bytes (each moved page read once and written once; no
// arithmetic).  Design: grid (16 KB ranges of the page row, dst rows, stack
// entries); a block whose map entry is -1 returns at once; each thread moves
// 16-byte vectors when every run, stride and base is 16-byte aligned (a
// vector then never straddles a run on either side), single bytes
// otherwise.
struct Side {
  long long outer_stride, page_stride, chunk_stride, rows_per_outer;
  unsigned chunk_bytes;
};

namespace {

// byte o (< 2^31) of a page row, as an offset from the row's start
__device__ __forceinline__ long long side_offset(const Side& s, unsigned o) {
  return static_cast<long long>(o / s.chunk_bytes) * s.chunk_stride + o % s.chunk_bytes;
}

__global__ void __launch_bounds__(THREADS)
scatter_pages(const int* __restrict__ map, uint8_t* __restrict__ dst,
              const uint8_t* __restrict__ src, Side ds, Side ss,
              long long dst_rows, long long src_rows, unsigned row_bytes, bool vec) {
  const int m = map[blockIdx.y];
  if (m < 0) return;
  const long long rd = static_cast<long long>(blockIdx.z) * dst_rows + blockIdx.y;
  const long long rs = static_cast<long long>(blockIdx.z) * src_rows + m;
  uint8_t* d = dst + (rd / ds.rows_per_outer) * ds.outer_stride +
               (rd % ds.rows_per_outer) * ds.page_stride;
  const uint8_t* sp = src + (rs / ss.rows_per_outer) * ss.outer_stride +
                      (rs % ss.rows_per_outer) * ss.page_stride;
  const unsigned base = blockIdx.x * static_cast<unsigned>(CHUNK);
  if (vec) {
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const unsigned o = base + (u * THREADS + threadIdx.x) * VEC;
      if (o < row_bytes)
        *reinterpret_cast<int4*>(d + side_offset(ds, o)) =
            *reinterpret_cast<const int4*>(sp + side_offset(ss, o));
    }
  } else {
    const unsigned stop = row_bytes - base < CHUNK ? row_bytes : base + CHUNK;
    for (unsigned o = base + threadIdx.x; o < stop; o += THREADS)
      d[side_offset(ds, o)] = sp[side_offset(ss, o)];
  }
}

bool side_aligned(const Side& s, const void* p) {
  return reinterpret_cast<uintptr_t>(p) % VEC == 0 && s.outer_stride % VEC == 0 &&
         s.page_stride % VEC == 0 && s.chunk_stride % VEC == 0 &&
         s.chunk_bytes % VEC == 0;
}

}  // namespace

// map: (dst_rows,) int32 in [-1, src_rows), one map for every stack entry;
// dst/src: n_stack * dst_rows / src_rows page rows of row_bytes (< 2^31)
// bytes each, laid out as their side's (outer_stride, page_stride,
// chunk_stride, rows_per_outer, chunk_bytes) say, in bytes.  dst is
// updated in place; the caller guarantees that no page row is both read
// and written.  dst_rows and n_stack <= 65535.
extern "C" int cache_scatter_pages(const void* map, void* dst, const void* src,
                                   long long n_stack, long long dst_rows,
                                   long long src_rows, long long row_bytes,
                                   long long d_outer, long long d_page,
                                   long long d_chunk_stride, long long d_rows_per_outer,
                                   long long d_chunk_bytes, long long s_outer,
                                   long long s_page, long long s_chunk_stride,
                                   long long s_rows_per_outer, long long s_chunk_bytes,
                                   void* stream) {
  if (n_stack <= 0 || dst_rows <= 0 || row_bytes <= 0) return 0;
  const Side ds{d_outer, d_page, d_chunk_stride, d_rows_per_outer,
                static_cast<unsigned>(d_chunk_bytes)};
  const Side ss{s_outer, s_page, s_chunk_stride, s_rows_per_outer,
                static_cast<unsigned>(s_chunk_bytes)};
  const bool vec = side_aligned(ds, dst) && side_aligned(ss, src);
  const dim3 grid(static_cast<unsigned>((row_bytes + CHUNK - 1) / CHUNK),
                  static_cast<unsigned>(dst_rows), static_cast<unsigned>(n_stack));
  scatter_pages<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(map), static_cast<uint8_t*>(dst),
      static_cast<const uint8_t*>(src), ds, ss, dst_rows, src_rows,
      static_cast<unsigned>(row_bytes), vec);
  return static_cast<int>(cudaGetLastError());
}
