// Cache-row scatter, written by hand for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel cache_scatter_p
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
