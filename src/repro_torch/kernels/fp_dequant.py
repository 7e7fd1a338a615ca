"""The guarded PDQ projection's fp-dequant fallback, predicated on the
device: the port of the fallback branch of the reference's
``ops._guard_pdq`` (``lax.cond(ok, y, _fp_dequant_matmul(x, q, scale))``).

A guarded projection's W8A8 epilogue (kernel K2) sets the guard's
non-finite flag where it stores a NaN or an infinity.  This kernel runs
after it on every call: it reads the flag on the device and returns at
once when it is clear; when it is set it overwrites ``y`` with ``(x.f32 @
(q.f32 * scale)).to(y.dtype)`` and adds 1 to the collector's fallbacks.
Either way it leaves the flag clear for the next projection.  So no host
read decides the branch, and a captured decode graph stays one static
sequence of launches; the untaken branch costs one launch of a persistent
grid (at most one block an SM) that reads a word.  A ``torch.where`` over
an always-computed fallback would dequantize every weight on every step
instead.

The flag is one int32 (2,) buffer per device (``flag_buffer``: the flag
and the kernel's ticket), zero at rest; launches on one stream run in
order, so every guarded projection shares it (a tensor-parallel shard on
a stream of its own takes its own set's, ``_build.buffer_set``), and so
do the split-K workspace and tickets.  The CUDA kernel is
``csrc/fp_dequant.cu``; each call takes one of three routes, chosen from
the operands alone (``route_for``): ``wgmma`` (bf16 x on the tensor cores,
TMA weight loads), ``fma`` (f32 x, the f32 FMA loop with 16-byte weight
loads) or ``generic`` (the same loop element by element, for shapes TMA
cannot describe); ``plan`` sizes the work.  ``ROUTES`` counts the
launches of each.  The plain version is ``ref.fp_dequant_fallback_ref``
(it reads the flag on the host, so the CPU path decides there).
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from . import _build, ref

COUNT = _build.OpCount()
ROUTES = {"fp_dequant": {"wgmma": 0, "fma": 0, "generic": 0}}
_ROUTE_CODE = {"generic": 0, "fma": 1, "wgmma": 2}

# the routes' geometry (csrc/fp_dequant.cu)
KS = 64             # k a stage, every route
CT = 128            # wgmma: output columns a tile
BM = 128            # wgmma: x rows a tile at prefill
DECODE_ROWS = 64    # wgmma: M up to this swaps A and B (n = M rounded up to 8..64)
FMA_BM, FMA_BN = 16, 64   # fma, generic: a tile's x rows and output columns
THREADS = 256       # the threads that hold a tile's accumulators
PER_SM = {"wgmma": 1, "fma": 2, "generic": 2}   # persistent blocks an SM
SPLIT_TAIL = 4      # an item's split-K merge, in stage loads, + acc / 2 (its partials)
EPI_TAIL = 1        # an item's epilogue alone
MAX_TICKETS = 4096  # tiles of a split launch (the ticket buffer)

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIG = {"fp_dequant_fallback": [_P, _I, _P, _P, _P, _I] + [_I] * 12 + [_P] * 5}
_KINDS = {torch.float32: 0, torch.bfloat16: 1}
_FLAGS: dict = {}       # (device, buffer set) -> the guard's (2,) int32 flag, zero at rest
_WS: dict = {}          # (device, buffer set) -> split-K f32 workspace, zero at rest
_TICKETS: dict = {}     # (device, buffer set) -> split-K tickets, zero at rest

fp_dequant_fallback_plain = ref.fp_dequant_fallback_ref


def flag_buffer(device) -> torch.Tensor:
    """The guard's flag of ``device`` in the current buffer set: int32
    [non-finite flag, ticket], zero at rest (the fallback kernel, or its
    plain version, clears it)."""
    key = _build.buffer_key(device)
    f = _FLAGS.get(key)
    if f is None:
        f = torch.zeros((2,), dtype=torch.int32, device=key[0])
        _FLAGS[key] = f
    return f


def route_for(x, w_q) -> str:
    """``"wgmma"`` for bf16 x where TMA can describe both operands (K a
    positive multiple of 16, 16-byte aligned bases), ``"fma"`` for f32 x
    there, else ``"generic"``.  Shapes, dtypes and addresses only."""
    K = x.shape[1]
    tma = K > 0 and K % 16 == 0 and x.data_ptr() % 16 == 0 and w_q.data_ptr() % 16 == 0
    if not tma:
        return "generic"
    return "wgmma" if x.dtype == torch.bfloat16 else "fma"


@dataclasses.dataclass(frozen=True)
class Plan:
    """A launch: ``route``; a tile is ``rows`` x rows (wgmma: B's n under
    swap-AB, else BM; fma, generic: FMA_BM) by CT (wgmma) or FMA_BN output
    columns, ``row_tiles`` x ``col_tiles`` of them; split s covers k
    stages [s kc, (s + 1) kc) of ``nks``; ``items`` = tiles x ``splits``,
    walked by ``grid`` persistent blocks; ``acc`` f32 accumulators a
    thread and ``ws`` workspace floats (0 without a split)."""
    route: str
    rows: int
    row_tiles: int
    col_tiles: int
    nks: int
    kc: int
    splits: int
    items: int
    grid: int
    acc: int
    ws: int


@functools.lru_cache(maxsize=1024)
def plan(route: str, M: int, K: int, N: int, sms: int) -> Plan:
    """The work split of an (M, K) @ (K, N) fallback on ``route`` over a
    card of ``sms`` SMs.  wgmma: decode rows (M <= DECODE_ROWS) take one
    row tile of n = M rounded up to 8, 16, 32 or 64 (64 output columns a
    consumer warpgroup, ``acc`` = n / 2), prefill rows 128-row tiles
    (``acc`` 64); fma and generic 16 x 64 tiles (``acc`` 4).  K is split into
    ``kc``-stage pieces with ``kc`` chosen, as K2's ``wgmma_plan`` does, to
    minimize the busiest block's stages plus each item's tail (with a
    merge SPLIT_TAIL + acc / 2, the partials a thread stores and sums;
    EPI_TAIL without), so that a few column tiles still spread the weight
    over the SMs; ties keep fewer splits.  The tail is fitted to the split
    counts ``tools/torch_fallback_sweep.py`` times on the card (PERF.md)."""
    if route == "wgmma":
        if M <= DECODE_ROWS:
            rows = next(r for r in (8, 16, 32, 64) if M <= r)
            row_tiles, acc = 1, rows // 2
        else:
            rows, row_tiles, acc = BM, -(-M // BM), CT // 2
        col_tiles = -(-N // CT)
    elif route in ("fma", "generic"):
        rows, row_tiles, acc = FMA_BM, -(-M // FMA_BM), FMA_BM // 4
        col_tiles = -(-N // FMA_BN)
    else:
        raise ValueError(f"route must be 'wgmma', 'fma' or 'generic', got {route!r}")
    tiles = row_tiles * col_tiles
    blocks = PER_SM[route] * sms
    nks = max(1, -(-K // KS))
    tail = SPLIT_TAIL + acc // 2
    best = None
    for kc in range(nks, 0, -1):
        splits = -(-nks // kc)
        if splits > 1 and tiles > MAX_TICKETS:
            break
        cost = -(-tiles * splits // blocks) * (kc + (tail if splits > 1 else EPI_TAIL))
        if best is None or cost < best[0]:
            best = (cost, kc, splits)
    _, kc, splits = best
    items = tiles * splits
    ws = splits * tiles * THREADS * acc if splits > 1 else 0
    return Plan(route, rows, row_tiles, col_tiles, nks, kc, splits, items,
                min(items, blocks), acc, ws)


@functools.lru_cache(maxsize=None)
def _sms(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _workspace(device, numel):
    """The zeroed split-K workspace of ``device`` (>= numel f32) in the
    current buffer set.  The kernel leaves it zero, so it is filled once,
    when it grows."""
    key = _build.buffer_key(device)
    ws = _WS.get(key)
    if ws is None or ws.numel() < numel:
        ws = torch.zeros((max(numel, 1 << 16),), dtype=torch.float32, device=device)
        _WS[key] = ws
    return ws


def _tickets(device):
    """The zeroed split-K tickets of ``device`` in the current buffer set,
    one a tile; the last split of a tile returns its ticket to 0."""
    key = _build.buffer_key(device)
    t = _TICKETS.get(key)
    if t is None:
        t = torch.zeros((MAX_TICKETS,), dtype=torch.int32, device=device)
        _TICKETS[key] = t
    return t


def fp_dequant_fallback_cuda(y, x, w_q, scale, flag, tel=None):
    """Launch the predicated fallback on the current stream of the
    operands' card, on the route ``route_for`` gives: y (M, N) f32/bf16
    contiguous, in place (nothing is allocated but, once, a larger
    workspace); x (M, K) f32/bf16 contiguous; w_q the (K, N) int8 weight,
    K-major; scale (N,) f32; flag the (2,) int32 buffer; tel None or the
    int64 (3,) counters."""
    from .w8a8_matmul import is_k_major

    _build.require_cuda(y, x, w_q, scale, flag, tel)
    M, K = x.shape
    N = w_q.shape[1]
    if (tuple(w_q.shape) != (K, N) or w_q.dtype != torch.int8 or not is_k_major(w_q)
            or tuple(y.shape) != (M, N) or y.dtype not in _KINDS or not y.is_contiguous()
            or x.dtype not in _KINDS or not x.is_contiguous()
            or scale.dtype != torch.float32 or scale.numel() != N
            or not scale.is_contiguous()):
        raise ValueError(f"fp_dequant_fallback: y {tuple(y.shape)} {y.dtype}, x "
                         f"{tuple(x.shape)} {x.dtype}, w_q {tuple(w_q.shape)} {w_q.dtype} "
                         f"(K-major {is_k_major(w_q)}), scale {tuple(scale.shape)}")
    if flag.dtype != torch.int32 or flag.numel() != 2 or not flag.is_contiguous():
        raise ValueError("flag: the (2,) int32 buffer of flag_buffer()")
    if tel is not None and (tel.dtype != torch.int64 or tel.numel() != 3):
        raise ValueError("tel: an int64 (3,) tensor")
    if max(M, K, N) >= 2 ** 31:
        raise ValueError(f"fp_dequant_fallback: ({M}, {K}) @ ({K}, {N}) past int32")
    r = route_for(x, w_q)
    dev = x.device
    p = plan(r, M, K, N, _sms(dev))
    ws = _workspace(dev, p.ws).data_ptr() if p.splits > 1 else None
    lib = _build.library("fp_dequant", _SIG)
    COUNT.launches += 1
    ROUTES["fp_dequant"][r] += 1
    code = lib.fp_dequant_fallback(
        x.data_ptr(), _KINDS[x.dtype], w_q.data_ptr(), scale.data_ptr(), y.data_ptr(),
        _KINDS[y.dtype], _ROUTE_CODE[r], M, K, N, p.rows, p.row_tiles, p.col_tiles, p.nks,
        p.kc, p.splits, p.items, p.grid, ws, _tickets(dev).data_ptr(), flag.data_ptr(),
        None if tel is None else tel.data_ptr(), _build.stream_ptr(dev))
    _build.check(code, "fp_dequant_fallback")
    return y


def fp_dequant_fallback(y, x, w_q, scale, flag, tel=None):
    """The fallback on its operands: plain version for CPU or fake tensors
    (``_build.plain_here``), the CUDA kernel otherwise.  A dry run's fake
    flag has no value to read: its trace takes the plain version's branch
    not taken (y kept, the flag cleared), a clean run's."""
    if x.device.type == "cpu":
        return fp_dequant_fallback_plain(y, x, w_q, scale, flag, tel)
    if _build.plain_here(x):
        flag[0] = 0
        return y
    return fp_dequant_fallback_cuda(y, x, w_q, scale, flag, tel)
