"""Affine int8 quantize (kernel K9) and dequantize (kernel K10): port of
``repro/kernels/quantize.py``.

K9 writes int8 codes ``clamp(round(x / s) + z, -128, 127)`` from f32/bf16
values with a per-row or per-channel scale and zero point; K10 maps codes
back, ``(q - z) * s`` in f32 or bf16.  Both are in ``csrc/quantize.cu``,
whose note says what bounds them and which bf16 arithmetic K10 follows;
``plan`` and ``dequantize_plan`` pick K9's and K10's route and grid from
the shape, alignment and the card's L2.  The plain versions are
``ref.quantize_ref`` and ``ref.dequantize_ref``.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from . import _build, ref

QUANTIZE_COUNT = _build.OpCount()      # K9
DEQUANTIZE_COUNT = _build.OpCount()    # K10
# K9's and K10's launches per route (``plan``, ``dequantize_plan``)
ROUTES = {"quantize": {"vector": 0, "wide": 0, "element": 0},
          "dequantize": {"vector": 0, "element": 0}}
_ROUTE_CODE = {"element": 0, "vector": 1, "wide": 2}
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIG = {"quantize": [_P, _I, _P, _P, _P, _L, _I, _I, _I, _I, _I, _P],
        "dequantize": [_P, _P, _P, _P, _I, _L, _I, _I, _I, _I, _I, _P]}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_GRID = 2 ** 31 - 1                 # K9's and K10's blocks (a 1-D grid)
DQ_COLUMNS = 16                        # K10: codes a thread (one 16-byte load)

quantize_plain = ref.quantize_ref
dequantize_plain = ref.dequantize_ref


@dataclasses.dataclass(frozen=True)
class Plan:
    """A K9 or K10 launch: ``route`` ("vector": one 16-byte load a thread,
    ``columns`` = 4 f32 or 8 bf16; "wide": 16 f32 columns a thread, four
    16-byte loads; "element": element by element; K10's routes in
    ``dequantize_plan``), ``units`` = ceil(N /
    columns) pairs (row, columns) a row, one a thread, ``threads`` a block
    and ``grid`` blocks."""
    route: str
    columns: int
    units: int
    threads: int
    grid: int


@functools.lru_cache(maxsize=1024)
def plan(M: int, N: int, elem: int, per_channel: bool, aligned: bool,
         l2_bytes: int) -> Plan:
    """K9's launch for x (M, N) of ``elem`` bytes; ``aligned``: x, q and
    (per channel) s and z all start 16-byte aligned; ``l2_bytes``: the
    card's L2.  The vector route needs that and N a multiple of its
    columns, so that every row starts aligned; f32 per row larger than the
    L2 takes the wide route (16 columns a thread, evict-first).  One pair a
    thread over a 1-D grid: 128 threads a block per channel, else 256
    (what measured faster on the card, PERF.md §6)."""
    cols = 16 // elem
    if aligned and not per_channel and elem == 4 and N % 16 == 0 and M * N * elem > l2_bytes:
        route, cols = "wide", 16
    elif aligned and N % cols == 0:
        route = "vector"
    else:
        route = "element"
    units = -(-N // cols)
    threads = 128 if per_channel and route == "vector" else 256
    return Plan(route, cols, units, threads, -(-M * units // threads))


@functools.lru_cache(maxsize=1024)
def dequantize_plan(M: int, N: int, out_elem: int, aligned: bool) -> Plan:
    """K10's launch for q (M, N) into ``out_elem``-byte values; ``aligned``:
    q, y and (per channel) s and z all start 16-byte aligned.  16 codes a
    thread on a 1-D grid of 256-thread blocks (``units`` = N / 16 a row,
    rounded up).  The vector route where the bases are aligned and N is a
    multiple of 16, so that every row starts aligned: a block takes 4096
    consecutive codes, a thread groups of 16 / ``out_elem`` codes 256
    groups apart, one 16-byte store each; "element" takes the rest, one
    (row, 16 columns) pair a thread, element by element."""
    route = "vector" if aligned and N % DQ_COLUMNS == 0 else "element"
    units = -(-N // DQ_COLUMNS)
    return Plan(route, DQ_COLUMNS, units, 256, -(-M * units // 256))


def _layout(a, s, z, what):
    """Check the operands of a launch: a (M, N) contiguous, s f32 and z
    int32 both (M, 1) (per row) or (1, N) (per channel), contiguous.
    Returns (M, N, per_channel)."""
    if a.dim() != 2 or not a.is_contiguous():
        raise ValueError(f"{what} takes a contiguous (M, N) tensor, got "
                         f"{tuple(a.shape)} strides {a.stride()}")
    M, N = a.shape
    shape = tuple(s.shape)
    if shape not in ((M, 1), (1, N)):
        raise ValueError(f"{what}: scale {shape} is neither ({M}, 1) nor (1, {N})")
    for t, dtype in ((s, torch.float32), (z, torch.int32)):
        if tuple(t.shape) != shape or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"{what}: operand {tuple(t.shape)} {t.dtype}, expected "
                             f"contiguous {shape} {dtype}")
    return M, N, shape != (M, 1)


def quantize_cuda(x, s, z):
    """Launch K9 on x (M, N) f32/bf16; s f32 and z int32 per row (M, 1) or
    per channel (1, N).  Returns int8 (M, N)."""
    _build.require_cuda(x, s, z)
    if x.dtype not in _DTYPES:
        raise ValueError(f"quantize takes float32/bfloat16, not {x.dtype}")
    M, N, per_channel = _layout(x, s, z, "quantize")
    q = torch.empty((M, N), dtype=torch.int8, device=x.device)
    bases = (x, q, s, z) if per_channel else (x, q)
    p = plan(M, N, x.element_size(), per_channel, all(t.data_ptr() % 16 == 0 for t in bases),
             _build.l2_bytes(x.device))
    if p.grid > MAX_GRID:
        raise ValueError(f"quantize: {M} x {N} needs {p.grid} blocks (> {MAX_GRID})")
    lib = _build.library("quantize", _SIG)
    QUANTIZE_COUNT.launches += 1
    ROUTES["quantize"][p.route] += 1
    _build.check(lib.quantize(x.data_ptr(), _DTYPES[x.dtype], s.data_ptr(), z.data_ptr(),
                              q.data_ptr(), M, N, int(per_channel), _ROUTE_CODE[p.route],
                              p.threads, p.grid, _build.stream_ptr(x.device)), "quantize")
    return q


def dequantize_cuda(q, s, z, out_dtype=torch.float32):
    """Launch K10 on q (M, N) int8; s/z as for ``quantize_cuda``.  Returns
    (M, N) in ``out_dtype`` (float32 or bfloat16)."""
    _build.require_cuda(q, s, z)
    if q.dtype != torch.int8 or out_dtype not in _DTYPES:
        raise ValueError(f"dequantize maps int8 to float32/bfloat16, not {q.dtype} "
                         f"to {out_dtype}")
    M, N, per_channel = _layout(q, s, z, "dequantize")
    y = torch.empty((M, N), dtype=out_dtype, device=q.device)
    bases = (q, y, s, z) if per_channel else (q, y)
    p = dequantize_plan(M, N, y.element_size(), all(t.data_ptr() % 16 == 0 for t in bases))
    if p.grid > MAX_GRID:
        raise ValueError(f"dequantize: {M} x {N} needs {p.grid} blocks (> {MAX_GRID})")
    lib = _build.library("quantize", _SIG)
    DEQUANTIZE_COUNT.launches += 1
    ROUTES["dequantize"][p.route] += 1
    _build.check(lib.dequantize(q.data_ptr(), s.data_ptr(), z.data_ptr(), y.data_ptr(),
                                _DTYPES[out_dtype], M, N, int(per_channel),
                                _ROUTE_CODE[p.route], p.threads, p.grid,
                                _build.stream_ptr(q.device)), "dequantize")
    return y


def quantize(x, s, z):
    """K9: the plain version for a CPU or a fake tensor
    (``_build.plain_here``), the CUDA kernel otherwise."""
    if _build.plain_here(x):
        return quantize_plain(x, s, z)
    return quantize_cuda(x, s, z)


def dequantize(q, s, z, out_dtype=torch.float32):
    """K10: the plain version for a CPU or a fake tensor
    (``_build.plain_here``), the CUDA kernel otherwise."""
    if _build.plain_here(q):
        return dequantize_plain(q, s, z, out_dtype)
    return dequantize_cuda(q, s, z, out_dtype)
