"""W8A8 matmul with the PDQ epilogue (kernel K2) and its fused SwiGLU
variant (kernel K3): port of ``repro/kernels/w8a8_matmul.py``.

K2: ``y = (x_q @ w_q - z_x * colsum) * (s_x * s_w)`` with int32
accumulation, then the ``requant`` epilogue (int8 on the predicted
``(s_out, z_out)`` grid) or the ``fp_clamp`` epilogue (clip to the
predicted ``[lo, hi]`` and cast).  Epilogue operands are per row ``(M, 1)``
or per (row, 128-column block) ``(M, N/128)``.

K3: K2's fp_clamp per-block product over ``[gate | up]`` plus ``hsw =
silu(gate) * up`` and w_down's PDQ prologue of hsw, in one launch.

The weight ``w_q`` is logically ``(K, N)`` and stored K-major: a view
``q_nk.t()`` of a contiguous ``(N, K)`` tensor (``k_major``), the layout
the card's integer tensor cores read.  Tensor code reads such a view as
any ``(K, N)`` tensor.

The CUDA kernels are ``csrc/w8a8_matmul.cu`` (its note says what bounds
them and how they are laid out).  Each call takes one of two routes,
chosen from the operands alone (``route_for``): ``wgmma`` (TMA and the
int8 tensor cores; K a multiple of 16, 16-byte aligned bases) or
``generic`` (``__dp4a`` on the CUDA cores, any shape).  ``ROUTES`` counts
the launches of each.  The plain versions compute the product in float64,
which is exact (``ref.w8a8_matmul_ref``).
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from . import _build, ref

LANE = 128                       # columns covered by one per-block operand
COUNT = _build.OpCount()         # K2
SWIGLU_COUNT = _build.OpCount()  # K3
# launches per route, beside COUNT / SWIGLU_COUNT
ROUTES = {"w8a8_matmul": {"wgmma": 0, "generic": 0},
          "w8a8_swiglu_matmul": {"wgmma": 0, "generic": 0}}

# the wgmma route's geometry (csrc/w8a8_matmul.cu namespace wg)
KB = 128            # k bytes per pipeline stage
CT = 128            # output columns per work item (per half for K3)
BM = 128            # x rows per work item at prefill
DECODE_ROWS = 64    # M up to this runs swap-AB (n <= 64: the kernel's largest instance)
SPLIT_TAIL = 4      # an item's split-K merge (atomics, fence, ticket), in stage loads
EPI_TAIL = 1        # an item's epilogue alone, in stage loads
BAR = 4096          # tickets below BAR are per column tile; BAR, BAR + 1 the grid barrier

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIG = {
    "w8a8_matmul": [_P] * 11 + [_I, _L, _I, _I, _I, _P],
    "w8a8_swiglu_matmul": [_P] * 15 + [_L, _I, _I, _P],
    "w8a8_matmul_wgmma": [_P] * 11 + [_I] * 11 + [_P] * 3,
    "w8a8_swiglu_matmul_wgmma": [_P] * 14 + [_I] * 9 + [_P] * 4,
}
_OUT_KIND = {torch.float32: 0, torch.bfloat16: 1}
_WS: dict = {}          # device -> split-K int32 workspace, zero at rest
_TICKETS: dict = {}     # device -> tickets and grid barrier, zero at rest


def k_major(q: torch.Tensor) -> torch.Tensor:
    """``q`` (K, N) as the K-major view ``q_nk.t()`` of a contiguous (N, K)
    copy: the same values, each column's K codes contiguous."""
    return q.t().contiguous().t()


def is_k_major(q: torch.Tensor) -> bool:
    return q.dim() == 2 and q.t().is_contiguous()


def route_for(x_q, w_q) -> str:
    """``"wgmma"`` where TMA can describe both operands (K a positive
    multiple of 16, so that rows are 16-byte strided; 16-byte aligned
    bases; w K-major), else ``"generic"``.  Shapes and addresses only."""
    K = x_q.shape[1]
    ok = (K > 0 and K % 16 == 0 and x_q.data_ptr() % 16 == 0
          and w_q.data_ptr() % 16 == 0 and is_k_major(w_q))
    return "wgmma" if ok else "generic"


@dataclasses.dataclass(frozen=True)
class Plan:
    """A wgmma launch: ``items`` work items (row tile x column tile at
    prefill; column tile x K split under swap-AB) walked by ``grid``
    persistent blocks; a column tile is 128 output columns (per half for
    K3); split s covers pipeline stages [s kc, (s+1) kc) of
    ``nks``."""
    swap: bool
    col_tiles: int
    nks: int
    kc: int
    splits: int
    items: int
    grid: int


@functools.lru_cache(maxsize=1024)
def wgmma_plan(M: int, K: int, N: int, swiglu: bool, sms: int) -> Plan:
    """The wgmma route's work split for an (M, K) @ (K, N) call on a card
    of ``sms`` SMs.  Prefill rows (M > DECODE_ROWS) take one item per (128
    rows, 128 columns) over all of K.  Decode rows take one per 128
    columns and K split into ``kc``-stage pieces, with ``kc`` chosen to
    minimize the busiest block's time: its items' stages plus each item's
    tail (SPLIT_TAIL for a split's merge, EPI_TAIL without one), counted
    in stage loads.  So the split spreads the weights over the SMs in
    about one wave."""
    cols = N // 2 if swiglu else N
    col_tiles = -(-cols // CT)
    nks = -(-K // KB)
    if M > DECODE_ROWS:
        items = -(-M // BM) * col_tiles
        return Plan(False, col_tiles, nks, nks, 1, items, min(items, sms))
    best = None
    for kc in range(nks, 0, -1):
        splits = -(-nks // kc)
        if splits > 1 and col_tiles > BAR:
            break
        cost = -(-col_tiles * splits // sms) * (kc + (SPLIT_TAIL if splits > 1 else EPI_TAIL))
        if best is None or cost < best[0]:
            best = (cost, kc, splits)
    _, kc, splits = best
    items = col_tiles * splits
    return Plan(True, col_tiles, nks, kc, splits, items, min(items, sms))


@functools.lru_cache(maxsize=None)
def _sms(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _workspace(device, numel):
    """The zeroed split-K workspace of ``device`` (>= numel int32).  The
    kernel leaves it zero, so it is filled once, when it grows."""
    ws = _WS.get(device)
    if ws is None or ws.numel() < numel:
        ws = torch.zeros((max(numel, 1 << 16),), dtype=torch.int32, device=device)
        _WS[device] = ws
    return ws


def _tickets(device):
    """The zeroed ticket buffer of ``device``: per-column-tile tickets of the
    wgmma route's splits, per-row-tile tickets of the generic K3, and the
    grid barrier at BAR.  Every kernel returns what it draws to 0, and
    launches on one stream never overlap."""
    t = _TICKETS.get(device)
    if t is None:
        t = torch.zeros((BAR + 2,), dtype=torch.int32, device=device)
        _TICKETS[device] = t
    return t


def _per_column(a, N):
    """(M, 1) stays; (M, N/128) spreads each block value over its columns."""
    return a if a.shape[1] == 1 else torch.repeat_interleave(a, LANE, dim=1)[:, :N]


def _ptr(t):
    return None if t is None else t.data_ptr()


def _pick_route(route, x_q, w_q, op):
    """The route a launch takes: ``route`` if given (checked), else
    ``route_for``."""
    if route not in (None, "wgmma", "generic"):
        raise ValueError(f"route must be None, 'wgmma' or 'generic', got {route!r}")
    auto = route_for(x_q, w_q)
    if route == "wgmma" and auto != "wgmma":
        raise ValueError(f"{op}: the wgmma route needs K % 16 == 0, 16-byte aligned "
                         f"x_q and w_q and a K-major w_q")
    return route or auto


def w8a8_matmul_plain(x_q, w_q, s_x, z_x, s_w, colsum, s_out=None, z_out=None,
                      lo=None, hi=None, *, out_dtype=torch.float32):
    """Plain version of K2 on the kernel's operands (``colsum`` is
    recomputed from ``w_q`` by the oracle)."""
    N = w_q.shape[1]
    z_x = 0 if z_x is None else z_x
    if s_out is not None:
        return ref.w8a8_matmul_ref(x_q, w_q, s_x, z_x, s_w,
                                   _per_column(s_out, N), _per_column(z_out, N))
    y = ref.w8a8_matmul_ref(x_q, w_q, s_x, z_x, s_w)
    if lo is not None:
        y = torch.minimum(torch.maximum(y, _per_column(lo, N)), _per_column(hi, N))
    return y.to(out_dtype)


def _check(x_q, w_q, s_x, z_x, s_w, colsum, epi):
    """Shapes, dtypes and layout of the operands the kernel reads (``None``
    marks one it does not read): w_q K-major, the rest contiguous."""
    M, K = x_q.shape
    N = w_q.shape[1]
    if z_x is not None and colsum is None:
        raise ValueError("a zero point z_x needs colsum")
    if tuple(w_q.shape) != (K, N) or w_q.dtype != torch.int8 or not is_k_major(w_q):
        raise ValueError(f"w8a8 weight {tuple(w_q.shape)} {w_q.dtype} strides "
                         f"{w_q.stride()}, expected a K-major ({K}, {N}) int8 view")
    want = [(x_q, (M, K), torch.int8), (s_x, (M, 1), torch.float32),
            (z_x, (M, 1), torch.int32), (s_w, (1, N), torch.float32),
            (colsum, (1, N), torch.int32)]
    for t, shape, dtype in want + epi:
        if t is not None and (tuple(t.shape) != shape or t.dtype != dtype
                              or not t.is_contiguous()):
            raise ValueError(f"w8a8 operand {tuple(t.shape)} {t.dtype} (contiguous "
                             f"{t.is_contiguous()}), expected contiguous {shape} {dtype}")
    return M, K, N


def w8a8_matmul_cuda(x_q, w_q, s_x, z_x, s_w, colsum, s_out=None, z_out=None,
                     lo=None, hi=None, *, out_dtype=torch.float32, route=None):
    """Launch K2.  ``s_out``/``z_out`` select the requant epilogue (int8
    out), ``lo``/``hi`` the clamp of an fp out; ``z_x=None`` is a zero
    point of 0, and then ``colsum`` is not read.  Operands come as
    ``ops.w8a8_matmul`` makes them: w_q K-major, the rest contiguous.
    ``route`` (None: ``route_for``) forces a route, for the tests and
    ``chip_smoke.py``."""
    _build.require_cuda(x_q, w_q, s_x, z_x, s_w, colsum, s_out, z_out, lo, hi)
    if (s_out is None) != (z_out is None) or (lo is None) != (hi is None):
        raise ValueError("s_out/z_out and lo/hi come in pairs")
    if s_out is not None and lo is not None:
        raise ValueError("the requant and fp clamp epilogues are exclusive")
    M, N = x_q.shape[0], w_q.shape[1]
    E = 1 if s_out is None and lo is None else (s_out if lo is None else lo).shape[1]
    if E not in (1, N // LANE) or (E > 1 and N % LANE):
        raise ValueError(f"epilogue operands (M, {E}) for N = {N}")
    epi = [(s_out, (M, E), torch.float32), (z_out, (M, E), torch.int32),
           (lo, (M, E), torch.float32), (hi, (M, E), torch.float32)]
    M, K, N = _check(x_q, w_q, s_x, z_x, s_w, colsum, epi)
    if s_out is not None:
        out, kind = torch.empty((M, N), dtype=torch.int8, device=x_q.device), 2
    elif out_dtype in _OUT_KIND:
        out = torch.empty((M, N), dtype=out_dtype, device=x_q.device)
        kind = _OUT_KIND[out_dtype]
    else:
        raise ValueError(f"w8a8_matmul emits float32/bfloat16, not {out_dtype}")
    dev = x_q.device
    lib = _build.library("w8a8_matmul", _SIG)
    operands = map(_ptr, (x_q, w_q, s_x, z_x, s_w, colsum, s_out, z_out, lo, hi))
    r = _pick_route(route, x_q, w_q, "w8a8_matmul")
    if r == "wgmma":
        p = wgmma_plan(M, K, N, False, _sms(dev))
        ws = _workspace(dev, M * N) if p.splits > 1 else None
        COUNT.launches += 1
        ROUTES["w8a8_matmul"][r] += 1
        code = lib.w8a8_matmul_wgmma(
            *operands, out.data_ptr(), kind, M, K, N, E, p.col_tiles, p.nks, p.kc,
            p.splits, p.items, p.grid, _ptr(ws), _tickets(dev).data_ptr(),
            _build.stream_ptr(dev))
    else:
        COUNT.launches += 1
        ROUTES["w8a8_matmul"][r] += 1
        code = lib.w8a8_matmul(*operands, out.data_ptr(), kind, M, K, N, E,
                               _build.stream_ptr(dev))
    _build.check(code, "w8a8_matmul")
    return out


def w8a8_matmul(*args, out_dtype=torch.float32):
    """K2 on its normalized operands: plain version for CPU tensors, the
    CUDA kernel otherwise."""
    fn = w8a8_matmul_plain if args[0].device.type == "cpu" else w8a8_matmul_cuda
    return fn(*args, out_dtype=out_dtype)


def w8a8_swiglu_matmul_plain(x_q, w_q, s_x, z_x, s_w, colsum, lo, hi):
    """Plain version of K3 (``colsum`` is recomputed by the oracle)."""
    return ref.w8a8_swiglu_ref(x_q, w_q, s_x, 0 if z_x is None else z_x, s_w,
                               lo, hi)[1:]


def w8a8_swiglu_matmul_cuda(x_q, w_q, s_x, z_x, s_w, colsum, lo, hi, *, route=None,
                            stamps=None):
    """Launch K3: w_q (K, N), K-major, holds [gate | up], P = N/2 columns
    each, with P a multiple of 128; lo/hi (M, N/128); ``z_x=None`` as in
    K2; ``route`` as in K2.  Returns (hsw (M, P) f32, hsw_q (M, P) int8,
    s_x, s1, s2 each (M, 1) f32).

    hsw is the kernel's scratch: a row's scale is known only when every
    block of the row has finished, so the kernel reads hsw back to quantize
    it.  It is returned for the checks against the plain version;
    ``ops.pdq_mlp`` uses hsw_q and the three row values.

    ``stamps`` (wgmma route only; ``chip_smoke.py`` passes it): an int64
    tensor of >= 2 entries per SM that receives each block's globaltimer
    (ns) at the end of phase 1 (the GEMM items) and of phase 2 (the
    quantize), to time the quantize tail."""
    _build.require_cuda(x_q, w_q, s_x, z_x, s_w, colsum, lo, hi)
    if stamps is not None and (stamps.dtype != torch.int64 or stamps.device != x_q.device
                               or stamps.numel() < 2 * _sms(x_q.device)):
        raise ValueError("stamps: an int64 tensor of 2 entries per SM on x_q's device")
    M, N = x_q.shape[0], w_q.shape[1]
    if N % (2 * LANE):
        raise ValueError(f"swiglu halves must be 128-column multiples, N = {N}")
    epi = [(lo, (M, N // LANE), torch.float32), (hi, (M, N // LANE), torch.float32)]
    M, K, N = _check(x_q, w_q, s_x, z_x, s_w, colsum, epi)
    P = N // 2
    dev = x_q.device
    hsw = torch.empty((M, P), dtype=torch.float32, device=dev)
    hsw_q = torch.empty((M, P), dtype=torch.int8, device=dev)
    sx, s1, s2 = (torch.empty((M, 1), dtype=torch.float32, device=dev)
                  for _ in range(3))
    lib = _build.library("w8a8_matmul", _SIG)
    tickets = _tickets(dev)
    operands = map(_ptr, (x_q, w_q, s_x, z_x, s_w, colsum, lo, hi, hsw, hsw_q,
                          sx, s1, s2))
    r = _pick_route(route, x_q, w_q, "w8a8_swiglu_matmul")
    if r == "wgmma":
        p = wgmma_plan(M, K, N, True, _sms(dev))
        part = torch.empty((M, p.col_tiles, 3), dtype=torch.float32, device=dev)
        ws = _workspace(dev, M * N) if p.splits > 1 else None
        SWIGLU_COUNT.launches += 1
        ROUTES["w8a8_swiglu_matmul"][r] += 1
        code = lib.w8a8_swiglu_matmul_wgmma(
            *operands, part.data_ptr(), M, K, N, p.col_tiles, p.nks, p.kc, p.splits,
            p.items, p.grid, _ptr(ws), tickets.data_ptr(), _ptr(stamps),
            _build.stream_ptr(dev))
    else:
        if stamps is not None:
            raise ValueError("stamps are taken on the wgmma route only")
        bm = 16 if M <= 16 else 64                   # the kernel's row tile
        if -(-M // bm) > BAR:
            raise ValueError(f"the generic w8a8_swiglu_matmul takes at most "
                             f"{BAR * bm} rows, got {M}")
        part = torch.empty((M, -(-P // 64), 3), dtype=torch.float32, device=dev)
        SWIGLU_COUNT.launches += 1
        ROUTES["w8a8_swiglu_matmul"][r] += 1
        code = lib.w8a8_swiglu_matmul(*operands, part.data_ptr(), tickets.data_ptr(),
                                      M, K, N, _build.stream_ptr(dev))
    _build.check(code, "w8a8_swiglu_matmul")
    return hsw, hsw_q, sx, s1, s2


def w8a8_swiglu_matmul(*args):
    """K3: plain version for CPU tensors, the CUDA kernel otherwise."""
    if args[0].device.type == "cpu":
        return w8a8_swiglu_matmul_plain(*args)
    return w8a8_swiglu_matmul_cuda(*args)
