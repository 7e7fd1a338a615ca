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

K6, the cache-row scatter: ``dst[b] = src[src_map[b]]`` where ``src_map[b]
>= 0``; other rows keep their bits.  Unlike the functional TPU kernel, this
one updates ``dst`` in place (``csrc/kv_cache.cu``), so a pool is landed
into without a copy.  The plain version is ``ref.cache_scatter_ref``.

K7, the page scatter (``csrc/kv_cache.cu``): K6 over PAGE rows, every
movement of the paged pool.  It reads and writes each side in its own
layout - a physical pool leaf, or a logical (n, B, ...) cache leaf whose
seq axis splits into pages - from the strides ``page_side`` computes, so
no side is relaid out to page rows first.  The plain version is
``ref.cache_scatter_pages_ref``, the reference's composition through
``to_page_rows``.
"""
from __future__ import annotations

import ctypes
import dataclasses
import math

import numpy as np
import torch

from . import _build, ref

COUNT = _build.OpCount()               # K6
PAGES_COUNT = _build.OpCount()         # K7
ATTEND_COUNT = _build.OpCount()        # K4
FUSED_COUNT = _build.OpCount()         # K5
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIG = {"cache_scatter": [_P, _P, _P, _L, _L, _P],
        "cache_scatter_pages": [_P, _P, _P] + [_L] * 14 + [_P]}
_ATTEND_SIG = {"decode_attend_i8kv": [_P] * 7 + [_I] * 5 + [_P],
               "decode_attend_i8kv_fused": [_P] * 12 + [_I] * 6 + [_P],
               "decode_attend_i8kv_split": [_P] * 13 + [_I] * 9 + [_P]}
# K4/K5 launches per route, beside ATTEND_COUNT / FUSED_COUNT
ROUTES = {"decode_attend_i8kv": {"split": 0, "single": 0},
          "decode_attend_i8kv_fused": {"split": 0, "single": 0}}
MAX_ROWS = 65535                       # the kernels' grid y/z (and K7's z) extent
MAX_ROW_BYTES = 2 ** 31 - 1            # K7 offsets within a page row are 32-bit
MAX_GROUP, MAX_HEAD_DIM = 8, 128       # the attend kernel's register/smem plan
CHUNK = 128                            # split route: positions a block owns
_PRO_BF16 = {None: 0, torch.float32: 0, torch.bfloat16: 1}
_TICKETS: dict = {}                    # per device; the kernels leave them zero
_WS: dict = {}                         # per device; the split route's partials

cache_scatter_plain = ref.cache_scatter_ref


def overlaps(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Whether two contiguous tensors share any byte."""
    a0, b0 = a.data_ptr(), b.data_ptr()
    return (a0 < b0 + b.numel() * b.element_size()
            and b0 < a0 + a.numel() * a.element_size())


def cache_scatter_cuda(dst: torch.Tensor, src: torch.Tensor,
                       src_map: torch.Tensor) -> torch.Tensor:
    """Launch the kernel: dst (B, ...) and src (Bs, ...) of one dtype and
    row shape, both contiguous; src_map (B,) int32 in [-1, Bs)."""
    _build.require_cuda(dst, src, src_map)
    B = dst.shape[0]
    if (src.dtype != dst.dtype or src.shape[1:] != dst.shape[1:]
            or src_map.shape != (B,) or src_map.dtype != torch.int32):
        raise ValueError(
            f"cache_scatter: dst {tuple(dst.shape)} {dst.dtype}, src "
            f"{tuple(src.shape)} {src.dtype}, map {tuple(src_map.shape)} "
            f"{src_map.dtype}")
    if not (dst.is_contiguous() and src.is_contiguous()):
        raise ValueError("cache_scatter needs contiguous dst and src")
    if B > MAX_ROWS:
        raise ValueError(f"cache_scatter takes at most {MAX_ROWS} rows, got {B}")
    row_bytes = dst[0].numel() * dst.element_size() if B else 0
    if overlaps(dst, src):
        raise ValueError("cache_scatter: dst and src must not overlap")
    lib = _build.library("kv_cache", _SIG)
    COUNT.launches += 1
    _build.check(lib.cache_scatter(src_map.data_ptr(), dst.data_ptr(),
                                   src.data_ptr(), B, row_bytes,
                                   _build.stream_ptr(dst.device)),
                 "cache_scatter")
    return dst


def cache_scatter(dst, src, src_map):
    """Row scatter into ``dst`` in place: the plain version for CPU
    tensors, the CUDA kernel otherwise."""
    if dst.device.type == "cpu":
        return cache_scatter_plain(dst, src, src_map)
    return cache_scatter_cuda(dst, src, src_map)


cache_scatter_pages_plain = ref.cache_scatter_pages_ref


def page_side(x: torch.Tensor, seq_axis, page, batch_axis: int):
    """K7's view of one side: (stack, rows per stack entry, row bytes) and
    the byte strides (outer_stride, page_stride, chunk_stride,
    rows_per_outer, chunk_bytes) that place page row r of the flattened
    (stack * rows) at (r // rows_per_outer) * outer_stride + (r %
    rows_per_outer) * page_stride, as runs of chunk_bytes, chunk_stride
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


def targets_meet_sources(host_map) -> bool:
    """Whether a numpy page map has a page row that is both written and
    read (the one case where an in-place scatter of a pool onto itself
    would race)."""
    m = np.asarray(host_map)
    return bool(np.intersect1d(np.nonzero(m >= 0)[0], m[m >= 0]).size)


def cache_scatter_pages_cuda(dst, src, page_map, seq_axis=None, page=None,
                             batch_axis: int = 0, host_map=None):
    """Launch K7: dst page row p of every stack entry takes src page row
    ``page_map[p]`` of the same entry (-1 keeps), in place.  dst and src
    are contiguous, of one dtype and page-row size; page_map (dst rows,)
    int32 on the device.  dst and src may be one tensor (the COW copy)
    only with ``host_map``, the same map in numpy, proving that no page
    row is both a target and a source."""
    _build.require_cuda(dst, src, page_map)
    if src.dtype != dst.dtype or not (dst.is_contiguous() and src.is_contiguous()):
        raise ValueError(f"cache_scatter_pages: dst {dst.dtype}, src {src.dtype}; "
                         f"both must be contiguous and of one dtype")
    n, rows, row_bytes, ds = page_side(dst, seq_axis, page, batch_axis)
    n_s, rows_s, row_bytes_s, ss = page_side(src, seq_axis, page, batch_axis)
    if (n_s != n or row_bytes_s != row_bytes or page_map.shape != (rows,)
            or page_map.dtype != torch.int32):
        raise ValueError(
            f"cache_scatter_pages: dst {tuple(dst.shape)} and src "
            f"{tuple(src.shape)} give ({n}, {rows}) and ({n_s}, {rows_s}) page "
            f"rows of {row_bytes} and {row_bytes_s} bytes; map "
            f"{tuple(page_map.shape)} {page_map.dtype}")
    if rows > MAX_ROWS or n > MAX_ROWS or row_bytes > MAX_ROW_BYTES:
        raise ValueError(f"cache_scatter_pages takes at most {MAX_ROWS} rows and "
                         f"stack entries of < 2 GiB rows; got {n} x {rows} rows "
                         f"of {row_bytes} bytes")
    if overlaps(dst, src) and not (src is dst and host_map is not None
                                   and not targets_meet_sources(host_map)):
        raise ValueError("cache_scatter_pages: dst and src overlap; only src is "
                         "dst with a host map whose targets and sources are "
                         "disjoint is allowed")
    lib = _build.library("kv_cache", _SIG)
    PAGES_COUNT.launches += 1
    _build.check(lib.cache_scatter_pages(
        page_map.data_ptr(), dst.data_ptr(), src.data_ptr(), n, rows, rows_s,
        row_bytes, *ds, *ss, _build.stream_ptr(dst.device)), "cache_scatter_pages")
    return dst


def cache_scatter_pages(dst, src, page_map, seq_axis=None, page=None,
                        batch_axis: int = 0, host_map=None):
    """K7: the plain version for CPU tensors, the CUDA kernel otherwise."""
    fn = (cache_scatter_pages_plain if dst.device.type == "cpu"
          else cache_scatter_pages_cuda)
    return fn(dst, src, page_map, seq_axis, page, batch_axis, host_map)


decode_attend_i8kv_plain = ref.decode_attend_i8kv_ref
decode_attend_i8kv_fused_plain = ref.decode_attend_i8kv_fused_ref


def attend_limits(B: int, H: int, Hkv: int, Dh: int) -> int:
    """The attend kernels' shape limits (both routes); returns G = H /
    Hkv.  B and Hkv are grid extents; G and Dh size the registers and
    shared memory."""
    G = H // Hkv if Hkv > 0 else 0
    if (Hkv <= 0 or H % Hkv or not 1 <= G <= MAX_GROUP or Dh % 16
            or not 16 <= Dh <= MAX_HEAD_DIM or not 0 <= B <= MAX_ROWS
            or Hkv > MAX_ROWS):
        raise ValueError(f"decode_attend_i8kv takes H = G * Hkv with G <= "
                         f"{MAX_GROUP}, Dh a multiple of 16 up to {MAX_HEAD_DIM} "
                         f"and B, Hkv <= {MAX_ROWS}; got B {B}, H {H}, Hkv {Hkv}, "
                         f"Dh {Dh}")
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
    """K4: the plain version for CPU tensors, the CUDA kernel otherwise."""
    if q.device.type == "cpu":
        return decode_attend_i8kv_plain(q, k_q, v_q, k_scale, v_scale, length)
    return decode_attend_i8kv_cuda(q, k_q, v_q, k_scale, v_scale, length)


def decode_attend_i8kv_fused(q, k_q, v_q, k_scale, v_scale, length, pro_dtype=None):
    """K5: the plain version for CPU tensors, the CUDA kernel otherwise."""
    fn = (decode_attend_i8kv_fused_plain if q.device.type == "cpu"
          else decode_attend_i8kv_fused_cuda)
    return fn(q, k_q, v_q, k_scale, v_scale, length, pro_dtype)
