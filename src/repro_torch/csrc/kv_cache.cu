// Pool movements of the serving KV cache: the cache-row scatter (K6) and the
// page scatter (K7), written by hand for Hopper (sm_90a) as ONE kernel that
// runs a whole movement - every leaf of the cache - in one launch.
//
// Replaces the Pallas TPU kernels cache_scatter_p
// (src/repro/kernels/kv_cache.py:246, pallas_call at :283) and
// cache_scatter_pages_p (:291, cache_scatter_p over page rows):
//   out[p] = src[map[p]] if map[p] >= 0 else dst[p], bit-exact, any dtype.
//
// A leaf is described by a Leaf record (below); a movement passes up to
// MAX_LEAVES of them as one kernel parameter.  64 leaves hold gemma3-12b's
// int8-KV cache (6 pattern kinds x k, v, k_scale, v_scale, pos, len = 36).
// A table of 64 records (12.8 KB) is past the 4 KB that kernel parameters
// had before CUDA 12.1; since 12.1, sm_70 and later take up to 32 764 bytes
// of parameters, so the table stays ONE __grid_constant__ parameter.  The
// other way, a table in device memory written before the launch, would put
// a host-to-device copy in front of every movement - a memcpy node inside
// the captured decode graph, which the engine keeps free of them - and a
// buffer whose contents must outlive the launch; the parameter is copied
// into the launch (and into a graph node) by value.  Page row r (counted over
// the whole stack) of a side starts at
//   (r / rows_per_outer) * outer_stride + (r % rows_per_outer) * page_stride
// and is the concatenation of chunks of chunk_bytes, chunk_stride apart: a
// physical pool page or a slot row is one contiguous chunk (rows_per_outer
// 1); a logical int8 K/V leaf (n, B, Hkv, Sp, Dh) has rows_per_outer = Sp /
// page and one chunk of page * Dh bytes per kv head.  Stack entry z of an
// (n, rows, ...) leaf reads src row z * src_rows + map[p] into dst row
// z * dst_rows + p.
//
// Two rules for a row whose map entry is -1.  A leaf with the FILL flag (the
// decode gather, which writes a fresh scratch) writes the row with its fill
// word, the leaf's init element repeated: every byte of the scratch is
// written once, from src or from the broadcast init, as the TPU kernel
// writes every output row.  Any other leaf keeps the row's bits: dst is
// updated IN PLACE (a landing, write-back, COW copy or restore), and only
// the rows the wrapper lists (`rows`, the map's targets) are visited.
//
// Bound on the H100: bytes (each moved row read once and written once, each
// filled row written once; no arithmetic).  Design: the unit of work is a
// piece (<= PIECE bytes) of a RUN, a byte range contiguous on both sides;
// (leaf, stack entry, dst row, run, piece) is flattened into one index
// space.  A warp takes 32 >> lanes_log2 units at a time (a 4 KiB run takes
// the whole warp, a 256-byte run of a scale or pos leaf half of it, so two
// ride together) and decodes each unit's addresses once.  Blocks stride
// over the space, sized to fill the SMs.  Each lane moves 16-byte vectors,
// UNROLL loads in flight before their stores, when the leaf's runs, strides
// and both bases are 16-byte aligned, single bytes otherwise.
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int VEC = 16;
constexpr int UNROLL = 8;
constexpr unsigned PIECE = 32u * VEC * UNROLL;   // 4 KiB: one pass of a warp
constexpr int MAX_LEAVES = 64;        // kernels/kv_cache.py MAX_LEAVES
constexpr long long FILL = 1, VECTOR = 2;

// One leaf of a movement, every field 64-bit, in the order the wrapper
// (kernels/kv_cache.py, cache_move_cuda) writes them.
struct Leaf {
  long long dst, src, map, rows;     // addresses; rows 0: visit every dst row
  long long d_outer, d_page, d_chunk_stride, d_rows_per_outer, d_chunk;
  long long s_outer, s_page, s_chunk_stride, s_rows_per_outer, s_chunk;
  long long dst_rows, src_rows;      // page rows per stack entry
  long long listed;                  // dst rows visited per stack entry
  long long run, runs, pieces;       // run bytes; runs a row; pieces a run
  long long lanes_log2;              // lanes a unit: 1 << lanes_log2
  long long units, item_begin;       // this leaf's units; its first warp item
  long long fill, flags;             // the fill word; FILL | VECTOR
};
static_assert(sizeof(Leaf) == 25 * 8, "Leaf is 25 64-bit fields");

struct Table {
  Leaf leaf[MAX_LEAVES];
  long long n, items;
};
static_assert(sizeof(Table) <= 32764,
              "the table fits the kernel parameter space (CUDA 12.1+, sm_70+)");

__device__ __forceinline__ long long row_start(unsigned r, long long rpo, long long outer,
                                               long long page) {
  const unsigned q = r / static_cast<unsigned>(rpo);
  return static_cast<long long>(q) * outer +
         static_cast<long long>(r - q * static_cast<unsigned>(rpo)) * page;
}

// byte o of a page row (o a run's start), as an offset from the row's start
__device__ __forceinline__ long long chunk_offset(unsigned o, long long chunk,
                                                  long long stride) {
  const unsigned q = o / static_cast<unsigned>(chunk);
  return static_cast<long long>(q) * stride + (o - q * static_cast<unsigned>(chunk));
}

__global__ void __launch_bounds__(THREADS) move_pages(const __grid_constant__ Table t) {
  const unsigned lane = threadIdx.x & 31;
  const long long step = static_cast<long long>(gridDim.x) * WARPS;
  for (long long item = static_cast<long long>(blockIdx.x) * WARPS + (threadIdx.x >> 5);
       item < t.items; item += step) {
    int l = 0, hi = static_cast<int>(t.n) - 1;   // the leaf this warp item lies
    while (l < hi) {                             // in: the last that begins at
      const int mid = (l + hi + 1) >> 1;         // or before it
      if (item >= t.leaf[mid].item_begin)
        l = mid;
      else
        hi = mid - 1;
    }
    const Leaf& f = t.leaf[l];
    const unsigned lg = static_cast<unsigned>(f.lanes_log2);
    const unsigned L = 1u << lg;
    const unsigned u = static_cast<unsigned>(item - f.item_begin) * (32u >> lg) + (lane >> lg);
    if (u >= f.units) continue;
    const unsigned sub = lane & (L - 1);
    // unit -> (stack entry z, listed row i, run, piece)
    const unsigned per_row = static_cast<unsigned>(f.runs * f.pieces);
    const unsigned rr = u / per_row, rem = u - rr * per_row;
    const unsigned listed = static_cast<unsigned>(f.listed);
    const unsigned z = rr / listed, i = rr - z * listed;
    const unsigned p = f.rows ? static_cast<unsigned>(reinterpret_cast<const int*>(f.rows)[i]) : i;
    const int m = reinterpret_cast<const int*>(f.map)[p];
    if (m < 0 && !(f.flags & FILL)) continue;
    const unsigned pieces = static_cast<unsigned>(f.pieces);
    const unsigned run = rem / pieces, piece = rem - run * pieces;
    const unsigned run_bytes = static_cast<unsigned>(f.run);
    const unsigned start = piece * PIECE;
    const unsigned len = min(PIECE, run_bytes - start);
    const unsigned o = run * run_bytes;
    const long long d_off =
        row_start(z * static_cast<unsigned>(f.dst_rows) + p, f.d_rows_per_outer, f.d_outer,
                  f.d_page) + chunk_offset(o, f.d_chunk, f.d_chunk_stride) + start;
    uint8_t* d = reinterpret_cast<uint8_t*>(f.dst) + d_off;
    const uint8_t* s = nullptr;
    if (m >= 0)
      s = reinterpret_cast<const uint8_t*>(f.src) +
          row_start(z * static_cast<unsigned>(f.src_rows) + static_cast<unsigned>(m),
                    f.s_rows_per_outer, f.s_outer, f.s_page) +
          chunk_offset(o, f.s_chunk, f.s_chunk_stride) + start;
    const unsigned w = static_cast<unsigned>(f.fill);
    if (f.flags & VECTOR) {
      int4* dv = reinterpret_cast<int4*>(d);
      const unsigned nv = len / VEC;
      if (s == nullptr) {
        const int4 fw = make_int4(w, w, w, w);
        for (unsigned v = sub; v < nv; v += L) dv[v] = fw;
        continue;
      }
      const int4* sv = reinterpret_cast<const int4*>(s);
      for (unsigned v0 = sub; v0 < nv; v0 += L * UNROLL) {
        int4 r[UNROLL];
#pragma unroll
        for (int k = 0; k < UNROLL; ++k)
          if (v0 + k * L < nv) r[k] = sv[v0 + k * L];
#pragma unroll
        for (int k = 0; k < UNROLL; ++k)
          if (v0 + k * L < nv) dv[v0 + k * L] = r[k];
      }
    } else if (s == nullptr) {
      // the fill word repeats the element, so byte (offset % 4) of it is
      // the element's byte at any element-aligned offset from the leaf base
      for (unsigned b = sub; b < len; b += L)
        d[b] = static_cast<uint8_t>(w >> (8 * ((d_off + b) & 3)));
    } else {
      for (unsigned b = sub; b < len; b += L) d[b] = s[b];
    }
  }
}

int grid_size(long long items) {
  static int dev_blocks[64];                 // resident blocks per device, cached
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 1;
  if (dev_blocks[dev] == 0) {
    int sms = 0, per_sm = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, move_pages, THREADS, 0);
    dev_blocks[dev] = sms * per_sm > 0 ? sms * per_sm : 1;
  }
  const long long want = (items + WARPS - 1) / WARPS;
  return static_cast<int>(want < 1 ? 1 : want < dev_blocks[dev] ? want : dev_blocks[dev]);
}

}  // namespace

// table: n Leaf records as 25 int64 each (n <= MAX_LEAVES); items: the warp
// items of the whole movement (the last leaf's item_begin plus its items).
// Launches once on `stream`, even with no items, so that a movement is
// always one launch.  Allocates nothing.
extern "C" int cache_move(const long long* table, long long n, long long items,
                          void* stream) {
  if (n < 1 || n > MAX_LEAVES || items < 0) return static_cast<int>(cudaErrorInvalidValue);
  Table t;
  memset(&t, 0, sizeof t);
  memcpy(t.leaf, table, static_cast<size_t>(n) * sizeof(Leaf));
  t.n = n;
  t.items = items;
  move_pages<<<grid_size(items), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(t);
  return static_cast<int>(cudaGetLastError());
}
