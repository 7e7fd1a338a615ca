"""Kernels of the serving KV-cache pool: port of
``repro/kernels/kv_cache.py``.

K4, flash-decode attention over the int8 KV cache in kernel layout (B,
Hkv, Sp, Dh), and K5, the same with wo's PDQ prologue over each row's
flattened output (``csrc/decode_attend.cu``; plain versions
``ref.decode_attend_i8kv_ref`` / ``ref.decode_attend_i8kv_fused_ref``).
Each launch takes one of two routes: ``split`` (Flash-Decoding: the
sequence axis split into CHUNK-position pieces across blocks, merged in
split order; ``attend_plan`` lays it out), which every caller takes, or
``single`` (one block per (kv head, row), the first design), which only
the card tests and ``chip_smoke.py`` ask for, to time the two in one call.
``ROUTES`` counts the launches of each.

K6 and K7, the pool movements (``csrc/kv_cache.cu``): ONE kernel runs a
whole movement - every cache leaf, each a ``Move`` - in one launch.  A
leaf's dst page row p of every stack entry takes src page row ``map[p]``
of the same entry; a -1 entry keeps the row's bits (dst is updated IN
PLACE, unlike the functional TPU kernel: a landing, write-back, COW copy
or restore) or, for a leaf with a ``fill`` (the decode gather into a fresh
scratch), is written with the leaf's init element, so that every byte of
the scratch is written once.  Each side is addressed in its own layout - a
physical pool leaf, a slot row (a page row of a whole sequence), or a
logical (n, B, ...) cache leaf whose seq axis splits into pages - from the
strides ``page_side`` computes; no side is relaid out to page rows first.
``COUNT`` (K6) counts the launches of slot-row landings, ``PAGES_COUNT``
(K7) those of the paged pool's movements.  The plain versions are
``ref.cache_scatter_ref`` (slot rows) and ``ref.cache_scatter_pages_ref``
(page rows, the reference's composition through ``to_page_rows``);
``cache_move_plain`` loops over the leaves with them.
"""
from __future__ import annotations

import array
import ctypes
import dataclasses
import math
from typing import Any, NamedTuple

import numpy as np
import torch

from . import _build, ref

COUNT = _build.OpCount()               # K6: slot-row landings
PAGES_COUNT = _build.OpCount()         # K7: the paged pool's movements
ATTEND_COUNT = _build.OpCount()        # K4
FUSED_COUNT = _build.OpCount()         # K5
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIG = {"cache_move": [_P, _L, _L, _P]}
_ATTEND_SIG = {"decode_attend_i8kv": [_P] * 7 + [_I] * 5 + [_P],
               "decode_attend_i8kv_fused": [_P] * 12 + [_I] * 6 + [_P],
               "decode_attend_i8kv_split": [_P] * 13 + [_I] * 9 + [_P],
               "decode_attend_split_instance": [_I, _I] + [ctypes.POINTER(_I)] * 2}
# K4/K5 launches per route, beside ATTEND_COUNT / FUSED_COUNT
ROUTES = {"decode_attend_i8kv": {"split": 0, "single": 0},
          "decode_attend_i8kv_fused": {"split": 0, "single": 0}}
MAX_ROWS = 65535                       # the attend kernels' grid y/z extent
MAX_ROW_BYTES = 2 ** 31 - 1            # a page row's offsets are 32-bit
MAX_UNITS = 2 ** 31 - 1                # a leaf's units and stacked rows, 32-bit
MAX_LEAVES = 64                        # leaves a movement (csrc MAX_LEAVES)
PIECE = 4096                           # bytes of a unit of work (csrc PIECE)
VEC = 16                               # the vector path's bytes a load
_FILL, _VECTOR = 1, 2                  # a leaf's flags (csrc FILL, VECTOR)
# the attend kernels' register and shared-memory plans (csrc GMAX/DMAX,
# GWIDE/DWIDE): (max G, max Dh) pairs, Dh a multiple of 16
ATTEND_PLANS = ((8, 128), (2, 256))
CHUNK = 128                            # split route: positions a block owns
_PRO_BF16 = {None: 0, torch.float32: 0, torch.bfloat16: 1}
_TICKETS: dict = {}                    # per device; the kernels leave them zero
_WS: dict = {}                         # per device; the split route's partials
_LAYOUTS: dict = {}                    # a leaf's shapes -> its LeafLayout
_FILLS: dict = {}                      # id(fill) -> (fill, its fill word)
_MAX_CACHED = 1024

cache_scatter_plain = ref.cache_scatter_ref
cache_scatter_pages_plain = ref.cache_scatter_pages_ref


class Move(NamedTuple):
    """One leaf of a pool movement: dst page row p of every stack entry
    takes src page row ``map[p]`` of the same entry.

    ``map`` is (dst rows,) int32 on dst's device; at the ops level it may
    be None, and ``host_map``, the same map in numpy, is sent instead.  A -1
    entry writes ``fill`` (a 0-dim tensor of dst's dtype, the element the
    leaf's init repeats) into the row, or without one keeps the row.
    ``rows`` (int32, on the device) lists the dst rows to visit - the map's
    targets, so that an in-place movement over a large pool reads no more
    of the map than it moves - and None visits every row.  ``seq_axis`` and
    ``page`` split a logical leaf's seq axis into pages (None: both sides
    are page rows already, a slot row being one); ``batch_axis`` 1 stacks
    (n, B, ...) leaves.  ``src is dst`` (the COW copy) needs ``host_map``
    to prove that no row is both a target and a source."""
    dst: torch.Tensor
    src: torch.Tensor
    map: Any = None
    seq_axis: int | None = None
    page: int | None = None
    batch_axis: int = 0
    fill: torch.Tensor | None = None
    rows: torch.Tensor | None = None
    host_map: Any = None


def overlaps(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Whether two contiguous tensors share any byte."""
    a0, b0 = a.data_ptr(), b.data_ptr()
    return a0 < b0 + b.nbytes and b0 < a0 + a.nbytes


def page_side(x: torch.Tensor, seq_axis, page, batch_axis: int):
    """The kernel's view of one side: (stack, rows per stack entry, row
    bytes) and the byte strides (outer_stride, page_stride, chunk_stride,
    rows_per_outer, chunk_bytes) that place page row r of the flattened
    (stack * rows) at (r // rows_per_outer) * outer_stride + (r %
    rows_per_outer) * page_stride, as chunks of chunk_bytes, chunk_stride
    apart.  ``x`` is contiguous; ``seq_axis`` None means x is page rows
    already (everything after the batch axis is one row)."""
    esz = x.element_size()
    shape = tuple(x.shape)
    stack = shape[0] if batch_axis == 1 else 1
    B = shape[batch_axis]
    outer = math.prod(shape[batch_axis + 1:]) * esz        # one batch row
    if seq_axis is None:
        return stack, B, outer, (outer, outer, outer, 1, outer)
    S = shape[seq_axis]
    if S % page:
        raise ValueError(f"page {page} does not divide the seq extent {S} of "
                         f"{shape}")
    inner = math.prod(shape[seq_axis + 1:]) * esz          # one position
    n_chunks = math.prod(shape[batch_axis + 1:seq_axis])   # axes between
    n_leaf = S // page
    if n_leaf == 1:                       # a physical pool: contiguous pages
        return stack, B, outer, (outer, outer, outer, 1, outer)
    return (stack, B * n_leaf, page * inner * n_chunks,
            (outer, page * inner, S * inner, n_leaf, page * inner))


@dataclasses.dataclass(frozen=True)
class LeafLayout:
    """How the movement kernel walks one leaf, from its two sides' shapes
    alone: ``n`` stack entries of ``dst_rows`` / ``src_rows`` page rows of
    ``row_bytes``; each row is ``runs`` RUNS of ``run`` bytes contiguous on
    both sides, each run ``pieces`` units of at most PIECE bytes; a unit
    takes 2**lanes_vec lanes on the 16-byte path and 2**lanes_byte on the
    byte path.  ``aligned``: every stride and the run are 16-byte multiples
    (the vector path then needs only 16-byte aligned bases)."""
    n: int
    dst_rows: int
    src_rows: int
    row_bytes: int
    ds: tuple
    ss: tuple
    run: int
    runs: int
    pieces: int
    lanes_vec: int
    lanes_byte: int
    aligned: bool

    @property
    def static(self) -> tuple:
        """The leaf record's fields from d_outer to src_rows (csrc Leaf)."""
        return (*self.ds, *self.ss, self.dst_rows, self.src_rows)


def _lanes_log2(n: int) -> int:
    """log2 of the lanes a unit of ``n`` vectors (or bytes) takes: enough
    for one each, at most a warp."""
    return min(5, max(0, (n - 1).bit_length()))


def leaf_layout(dst, src, seq_axis=None, page=None, batch_axis: int = 0) -> LeafLayout:
    """A leaf's layout from the shapes and dtypes of its two sides (meta
    tensors do: nothing is read).  Raises for sides that do not pair."""
    if batch_axis not in (0, 1):
        raise ValueError(f"batch_axis must be 0 or 1, got {batch_axis}")
    n, rows, row_bytes, ds = page_side(dst, seq_axis, page, batch_axis)
    n_s, rows_s, row_bytes_s, ss = page_side(src, seq_axis, page, batch_axis)
    if src.dtype != dst.dtype or n_s != n or row_bytes_s != row_bytes:
        raise ValueError(
            f"cache_move: dst {tuple(dst.shape)} {dst.dtype} and src "
            f"{tuple(src.shape)} {src.dtype} give ({n}, {rows}) and ({n_s}, "
            f"{rows_s}) page rows of {row_bytes} and {row_bytes_s} bytes")
    run = min(ds[4], ss[4])
    if row_bytes and (max(ds[4], ss[4]) % run or row_bytes % run):
        raise ValueError(f"cache_move: chunks of {ds[4]} and {ss[4]} bytes share "
                         f"no run")
    runs = row_bytes // run if row_bytes else 0
    pieces = -(-run // PIECE) if row_bytes else 0
    seg = min(run, PIECE)
    if (row_bytes > MAX_ROW_BYTES
            or n * max(rows, rows_s, 1) * max(runs * pieces, 1) > MAX_UNITS):
        raise ValueError(f"cache_move takes rows of < 2 GiB and < 2^31 units a "
                         f"leaf; got {n} x {rows} rows of {row_bytes} bytes")
    aligned = all(x % VEC == 0 for x in (*ds[:3], ds[4], *ss[:3], ss[4], run))
    return LeafLayout(n, rows, rows_s, row_bytes, ds, ss, run, runs, pieces,
                      _lanes_log2(-(-seg // VEC)), _lanes_log2(seg), aligned)


def layout(mv: Move) -> LeafLayout:
    """``leaf_layout`` of a move, checked and computed once per shape."""
    key = (mv.dst.shape, mv.dst.dtype, mv.src.shape, mv.src.dtype, mv.seq_axis,
           mv.page, mv.batch_axis)
    hit = _LAYOUTS.get(key)
    if hit is None:
        if len(_LAYOUTS) >= _MAX_CACHED:
            _LAYOUTS.clear()
        hit = _LAYOUTS[key] = leaf_layout(mv.dst, mv.src, mv.seq_axis, mv.page,
                                          mv.batch_axis)
    return hit


def fill_word(fill: torch.Tensor, dtype) -> int:
    """The 32-bit word that repeats a 0-dim ``fill`` of ``dtype`` (1, 2 or
    4 bytes an element); cached per fill tensor, which the entry holds."""
    hit = _FILLS.get(id(fill))
    if hit is None or hit[0] is not fill:
        if fill.dim() != 0 or fill.dtype != dtype or fill.element_size() not in (1, 2, 4):
            raise ValueError(f"a fill is a 0-dim tensor of the leaf's dtype {dtype} "
                             f"of 1, 2 or 4 bytes; got {tuple(fill.shape)} {fill.dtype}")
        b = bytes(fill.reshape(1).cpu().view(torch.uint8).tolist())
        if len(_FILLS) >= _MAX_CACHED:
            _FILLS.clear()
        hit = _FILLS[id(fill)] = (fill, int.from_bytes(b * (4 // len(b)), "little"))
    return hit[1]


def targets_meet_sources(host_map) -> bool:
    """Whether a numpy page map has a page row that is both written and
    read (the one case where an in-place copy of a pool onto itself would
    race)."""
    m = np.asarray(host_map)
    return bool(np.intersect1d(np.nonzero(m >= 0)[0], m[m >= 0]).size)


@dataclasses.dataclass(frozen=True)
class LeafPlan:
    """What one leaf of a movement does: its layout, the dst rows visited
    (``listed``, per stack entry) and those with a source (``moved``),
    the kernel's units and runs, and the bytes written and read (each
    visited row written once, each moved row read once)."""
    layout: LeafLayout
    listed: int
    moved: int
    units: int
    runs: int
    bytes_written: int
    bytes_read: int


def move_plan(moves) -> list[LeafPlan]:
    """The plan of a movement from shapes and host maps alone (meta tensors
    do): each move's ``host_map`` (else its ``map``, read to the host)."""
    out = []
    for mv in moves:
        lay = leaf_layout(mv.dst, mv.src, mv.seq_axis, mv.page, mv.batch_axis)
        m = np.asarray(mv.host_map if mv.host_map is not None else mv.map.cpu())
        moved = int((m >= 0).sum())
        listed = lay.dst_rows if mv.fill is not None else moved
        out.append(LeafPlan(lay, listed, moved, lay.n * listed * lay.runs * lay.pieces,
                            lay.n * listed * lay.runs, lay.n * listed * lay.row_bytes,
                            lay.n * moved * lay.row_bytes))
    return out


def cache_move_cuda(moves, count: _build.OpCount = PAGES_COUNT) -> None:
    """Launch ONE movement of 1 to MAX_LEAVES leaves (``Move``s with maps on
    the card) and add one to ``count``.  Every dst and src is contiguous;
    map values lie in [-1, src rows) and ``rows`` values in [0, dst rows)
    (the ops layer checks its host maps); a leaf with a fill visits every
    row.  dst and src may be one tensor (the COW copy) only with a
    ``host_map`` whose targets and sources are disjoint.  A leaf's layout
    is checked once per shape (``layout``); a call then checks and fills in
    its pointers, maps and row counts."""
    if not 1 <= len(moves) <= MAX_LEAVES:
        raise ValueError(f"cache_move takes 1 to {MAX_LEAVES} leaves, got {len(moves)}")
    ts = [t for mv in moves for t in (mv.dst, mv.src, mv.map, mv.rows) if t is not None]
    dev = ts[0].get_device()
    if not all(t.is_cuda and t.get_device() == dev for t in ts):
        _build.require_cuda(*ts)
    table, items = [], 0
    for mv in moves:
        dst, src, m, rows = mv.dst, mv.src, mv.map, mv.rows
        lay = layout(mv)
        if m is None or m.dtype != torch.int32 or m.shape != (lay.dst_rows,):
            raise ValueError(f"cache_move: map {None if m is None else tuple(m.shape)} "
                             f"{None if m is None else m.dtype}, expected "
                             f"({lay.dst_rows},) int32 on the card")
        if not (dst.is_contiguous() and src.is_contiguous() and m.is_contiguous()):
            raise ValueError("cache_move needs contiguous dst, src and map")
        d, s = dst.data_ptr(), src.data_ptr()
        if (d < s + src.nbytes and s < d + dst.nbytes
                and not (src is dst and mv.fill is None and mv.host_map is not None
                         and not targets_meet_sources(mv.host_map))):
            raise ValueError("cache_move: dst and src overlap; only src is dst with "
                             "a host map whose targets and sources are disjoint is "
                             "allowed")
        flags = word = r = 0
        listed = lay.dst_rows
        if mv.fill is not None:
            if rows is not None:
                raise ValueError("cache_move: a leaf with a fill visits every row")
            flags, word = _FILL, fill_word(mv.fill, dst.dtype)
        elif rows is not None:
            if rows.dtype != torch.int32 or rows.dim() != 1 or rows.numel() > listed:
                raise ValueError(f"cache_move: rows {tuple(rows.shape)} {rows.dtype}, "
                                 f"expected at most {listed} int32")
            listed, r = rows.numel(), rows.data_ptr()
        lg = lay.lanes_byte
        if lay.aligned and d % VEC == 0 and s % VEC == 0:
            flags, lg = flags | _VECTOR, lay.lanes_vec
        units = lay.n * listed * lay.runs * lay.pieces
        table += (d, s, m.data_ptr(), r, *lay.static, listed, lay.run, lay.runs,
                  lay.pieces, lg, units, items, word, flags)
        items += -(-units // (32 >> lg))
    lib = _build.library("kv_cache", _SIG)
    buf = array.array("q", table)          # the kernel copies it into its parameter
    count.launches += 1
    _build.check(lib.cache_move(buf.buffer_info()[0], len(moves), items,
                                _build.stream_ptr(moves[0].dst.device)), "cache_move")


def cache_move_plain(moves, count=None) -> None:
    """The plain movement: each leaf's fill first (a leaf with one), then
    the single-leaf reference scatter."""
    for mv in moves:
        if mv.fill is not None:
            mv.dst.fill_(mv.fill)
        cache_scatter_pages_plain(mv.dst, mv.src, mv.map, mv.seq_axis, mv.page,
                                  mv.batch_axis)


def cache_move(moves, count: _build.OpCount = PAGES_COUNT) -> None:
    """One movement: the plain version when the leaves lie on the CPU or
    are fake (``_build.plain_here``), the CUDA kernel otherwise."""
    if _build.plain_here(moves[0].dst):
        return cache_move_plain(moves, count)
    return cache_move_cuda(moves, count)


def cache_scatter_cuda(dst: torch.Tensor, src: torch.Tensor,
                       src_map: torch.Tensor) -> torch.Tensor:
    """K6 on one leaf of flat rows: dst (B, ...) and src (Bs, ...) of one
    dtype and row shape, both contiguous; src_map (B,) int32 in [-1, Bs)."""
    _build.require_cuda(dst, src, src_map)
    B = dst.shape[0]
    if (src.dtype != dst.dtype or src.shape[1:] != dst.shape[1:]
            or src_map.shape != (B,) or src_map.dtype != torch.int32):
        raise ValueError(
            f"cache_scatter: dst {tuple(dst.shape)} {dst.dtype}, src "
            f"{tuple(src.shape)} {src.dtype}, map {tuple(src_map.shape)} "
            f"{src_map.dtype}")
    cache_move_cuda([Move(dst, src, src_map)], COUNT)
    return dst


def cache_scatter(dst, src, src_map):
    """Row scatter into ``dst`` in place: the plain version for CPU or
    fake tensors (``_build.plain_here``), the CUDA kernel otherwise."""
    if _build.plain_here(dst):
        return cache_scatter_plain(dst, src, src_map)
    return cache_scatter_cuda(dst, src, src_map)


def cache_scatter_pages_cuda(dst, src, page_map, seq_axis=None, page=None,
                             batch_axis: int = 0, host_map=None):
    """K7 on one leaf: dst page row p of every stack entry takes src page
    row ``page_map[p]`` of the same entry (-1 keeps), in place; page_map
    (dst rows,) int32 on the card; ``host_map`` as for ``Move``."""
    cache_move_cuda([Move(dst, src, page_map, seq_axis, page, batch_axis,
                          host_map=host_map)], PAGES_COUNT)
    return dst


def cache_scatter_pages(dst, src, page_map, seq_axis=None, page=None,
                        batch_axis: int = 0, host_map=None):
    """K7 on one leaf: the plain version for CPU or fake tensors
    (``_build.plain_here``), the CUDA kernel otherwise."""
    if _build.plain_here(dst):
        return cache_scatter_pages_plain(dst, src, page_map, seq_axis, page, batch_axis)
    return cache_scatter_pages_cuda(dst, src, page_map, seq_axis, page, batch_axis,
                                    host_map)


decode_attend_i8kv_plain = ref.decode_attend_i8kv_ref
decode_attend_i8kv_fused_plain = ref.decode_attend_i8kv_fused_ref


def attend_plan_of(G: int, Dh: int) -> int | None:
    """The index in ``ATTEND_PLANS`` of the built instance that takes (G,
    Dh) (the first that fits), or None."""
    if G < 1 or Dh < 16 or Dh % 16:
        return None
    return next((i for i, (gm, dm) in enumerate(ATTEND_PLANS) if G <= gm and Dh <= dm),
                None)


def attend_limits(B: int, H: int, Hkv: int, Dh: int) -> int:
    """The attend kernels' shape limits (both routes); returns G = H /
    Hkv.  B and Hkv are grid extents; G and Dh pick one of the built
    register and shared-memory plans (``ATTEND_PLANS``)."""
    G = H // Hkv if Hkv > 0 else 0
    if (Hkv <= 0 or H % Hkv or attend_plan_of(G, Dh) is None
            or not 0 <= B <= MAX_ROWS or Hkv > MAX_ROWS):
        raise ValueError(f"decode_attend_i8kv takes H = G * Hkv and Dh a multiple of "
                         f"16 with (G, Dh) at most one of {list(ATTEND_PLANS)}, and "
                         f"B, Hkv <= {MAX_ROWS}; got B {B}, H {H}, Hkv {Hkv}, Dh {Dh}")
    return G


@dataclasses.dataclass(frozen=True)
class AttendPlan:
    """The split route's launch: block (s, h, b) of ``grid`` = (splits,
    Hkv, B) owns positions [s * chunk, (s + 1) * chunk) of row b's cache
    (the last chunk ends at Sp).  Each split that holds a valid position
    of a row longer than one chunk writes a ``record`` of f32 (m and l per
    query head, then the G * Dh unnormalised outputs, padded to a multiple
    of 4) into the workspace, ``B * Hkv * splits * record * 4`` bytes.
    ``tickets`` int32: one per (b, h) for the split merge, then one per b
    for K5's prologue."""
    chunk: int
    splits: int
    grid: tuple
    record: int
    workspace_bytes: int
    tickets: int


def attend_plan(B: int, Hkv: int, G: int, Sp: int, Dh: int) -> AttendPlan:
    """The split route's plan from the cache's shape alone: never from the
    lengths, which live on the device (reading them would sync every
    decode step).  Blocks whose chunk starts past a row's length return
    before any load."""
    attend_limits(B, G * Hkv, Hkv, Dh)
    splits = max(1, -(-Sp // CHUNK))
    record = -(-G * (Dh + 2) // 4) * 4
    return AttendPlan(CHUNK, splits, (splits, Hkv, B), record,
                      B * Hkv * splits * record * 4, B * Hkv + B)


def attend_instance(G: int, Dh: int) -> tuple:
    """The (max G, max Dh) of the kernel instance the split route launches
    for (G, Dh), as the library itself chooses it (csrc
    ``decode_attend_split_instance``): the lean (1, 64) at G 1 and Dh <= 64,
    else the first of ``ATTEND_PLANS`` that fits.  Builds the library if
    needed."""
    lib = _build.library("decode_attend", _ATTEND_SIG)
    gm, dm = ctypes.c_int(), ctypes.c_int()
    if lib.decode_attend_split_instance(G, Dh, ctypes.byref(gm), ctypes.byref(dm)):
        raise ValueError(f"no decode_attend_i8kv instance takes G {G}, Dh {Dh}")
    return gm.value, dm.value


def _attend_check(q, k_q, v_q, k_scale, v_scale, length):
    """The attend kernels' operands: q (B, H, Dh) f32; k_q/v_q (B, Hkv,
    Sp, Dh) int8, 16-byte aligned; scales (B, Hkv, Sp) f32; length (B,)
    int32; all contiguous.  Returns (B, Hkv, G, Sp, Dh)."""
    _build.require_cuda(q, k_q, v_q, k_scale, v_scale, length)
    B, H, Dh = q.shape
    Hkv, Sp = k_q.shape[1], k_q.shape[2]
    want = [(q, (B, H, Dh), torch.float32), (k_q, (B, Hkv, Sp, Dh), torch.int8),
            (v_q, (B, Hkv, Sp, Dh), torch.int8),
            (k_scale, (B, Hkv, Sp), torch.float32),
            (v_scale, (B, Hkv, Sp), torch.float32), (length, (B,), torch.int32)]
    for t, shape, dtype in want:
        if tuple(t.shape) != shape or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"decode_attend_i8kv operand {tuple(t.shape)} {t.dtype} "
                             f"(contiguous {t.is_contiguous()}), expected "
                             f"contiguous {shape} {dtype}")
    G = attend_limits(B, H, Hkv, Dh)
    if k_q.data_ptr() % 16 or v_q.data_ptr() % 16:
        raise ValueError("decode_attend_i8kv needs 16-byte aligned k_q and v_q")
    return B, Hkv, G, Sp, Dh


def _tickets(device, n):
    """A zeroed (>= n,) int32 ticket buffer for ``device``.  Both routes
    return every ticket they draw to 0, so the buffer is zeroed once, when
    it grows, not per call; launches on one stream never overlap."""
    t = _TICKETS.get(device)
    if t is None or t.numel() < n:
        t = torch.zeros((max(n, 64),), dtype=torch.int32, device=device)
        _TICKETS[device] = t
    return t


def _workspace(device, nbytes):
    """The split route's f32 workspace of ``device`` (>= nbytes), grown when
    needed and never filled: a merge reads only records written in the
    same launch."""
    ws = _WS.get(device)
    n = -(-nbytes // 4)
    if ws is None or ws.numel() < n:
        ws = torch.empty((max(n, 1 << 16),), dtype=torch.float32, device=device)
        _WS[device] = ws
    return ws


def _route(route):
    if route not in (None, "split", "single"):
        raise ValueError(f"route must be None, 'split' or 'single', got {route!r}")
    return route or "split"


def _launch_split(op, count, args, dims, o, outs=(None,) * 4, pro_bf16=0):
    """The split route of K4 (``outs`` None) or K5 (``outs`` = o_q, s_x,
    s1, s2) on checked operands ``args`` of shape ``dims``."""
    B, Hkv, G, Sp, Dh = dims
    plan = attend_plan(B, Hkv, G, Sp, Dh)
    dev = o.device
    ws = _workspace(dev, plan.workspace_bytes)
    tk = _tickets(dev, plan.tickets)
    lib = _build.library("decode_attend", _ATTEND_SIG)
    count.launches += 1
    ROUTES[op]["split"] += 1
    _build.check(lib.decode_attend_i8kv_split(
        *(t.data_ptr() for t in args), o.data_ptr(),
        *(None if t is None else t.data_ptr() for t in outs), ws.data_ptr(),
        tk.data_ptr(), B, Hkv, G, Sp, Dh, plan.splits, plan.record,
        int(outs[0] is not None), pro_bf16, _build.stream_ptr(dev)), op)


def decode_attend_i8kv_cuda(q, k_q, v_q, k_scale, v_scale, length, *, route=None):
    """Launch K4 on ``route`` (None: ``split``); returns o (B, H, Dh) f32."""
    route = _route(route)
    args = (q, k_q, v_q, k_scale, v_scale, length)
    dims = B, Hkv, G, Sp, Dh = _attend_check(*args)
    o = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    if route == "split":
        _launch_split("decode_attend_i8kv", ATTEND_COUNT, args, dims, o)
        return o
    lib = _build.library("decode_attend", _ATTEND_SIG)
    ATTEND_COUNT.launches += 1
    ROUTES["decode_attend_i8kv"]["single"] += 1
    _build.check(lib.decode_attend_i8kv(
        q.data_ptr(), k_q.data_ptr(), v_q.data_ptr(), k_scale.data_ptr(),
        v_scale.data_ptr(), length.data_ptr(), o.data_ptr(), B, Hkv, G, Sp, Dh,
        _build.stream_ptr(q.device)), "decode_attend_i8kv")
    return o


def decode_attend_i8kv_fused_cuda(q, k_q, v_q, k_scale, v_scale, length,
                                  pro_dtype=None, *, route=None):
    """Launch K5 on ``route`` (None: ``split``); returns (o (B, H, Dh) f32,
    o_q (B, H * Dh) int8, s_x, s1, s2 each (B, 1) f32).  ``pro_dtype``
    (None, float32 or bfloat16) is the type o is rounded to before the
    prologue."""
    route = _route(route)
    args = (q, k_q, v_q, k_scale, v_scale, length)
    dims = B, Hkv, G, Sp, Dh = _attend_check(*args)
    if pro_dtype not in _PRO_BF16:
        raise ValueError(f"pro_dtype must be None, float32 or bfloat16, got {pro_dtype}")
    dev = q.device
    o = torch.empty(q.shape, dtype=torch.float32, device=dev)
    o_q = torch.empty((B, q.shape[1] * Dh), dtype=torch.int8, device=dev)
    s_x, s1, s2 = (torch.empty((B, 1), dtype=torch.float32, device=dev)
                   for _ in range(3))
    if route == "split":
        _launch_split("decode_attend_i8kv_fused", FUSED_COUNT, args, dims, o,
                      (o_q, s_x, s1, s2), _PRO_BF16[pro_dtype])
        return o, o_q, s_x, s1, s2
    lib = _build.library("decode_attend", _ATTEND_SIG)
    FUSED_COUNT.launches += 1
    ROUTES["decode_attend_i8kv_fused"]["single"] += 1
    _build.check(lib.decode_attend_i8kv_fused(
        q.data_ptr(), k_q.data_ptr(), v_q.data_ptr(), k_scale.data_ptr(),
        v_scale.data_ptr(), length.data_ptr(), o.data_ptr(), o_q.data_ptr(),
        s_x.data_ptr(), s1.data_ptr(), s2.data_ptr(), _tickets(dev, B).data_ptr(),
        B, Hkv, G, Sp, Dh, _PRO_BF16[pro_dtype], _build.stream_ptr(dev)),
        "decode_attend_i8kv_fused")
    return o, o_q, s_x, s1, s2


def decode_attend_i8kv(q, k_q, v_q, k_scale, v_scale, length):
    """K4: the plain version for CPU or fake tensors
    (``_build.plain_here``), the CUDA kernel otherwise."""
    if _build.plain_here(q):
        return decode_attend_i8kv_plain(q, k_q, v_q, k_scale, v_scale, length)
    return decode_attend_i8kv_cuda(q, k_q, v_q, k_scale, v_scale, length)


def decode_attend_i8kv_fused(q, k_q, v_q, k_scale, v_scale, length, pro_dtype=None):
    """K5: the plain version for CPU or fake tensors
    (``_build.plain_here``), the CUDA kernel otherwise."""
    fn = (decode_attend_i8kv_fused_plain if _build.plain_here(q)
          else decode_attend_i8kv_fused_cuda)
    return fn(q, k_q, v_q, k_scale, v_scale, length, pro_dtype)
