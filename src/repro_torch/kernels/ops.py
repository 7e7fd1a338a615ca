"""Public ops over the hand-written kernels: port of
``repro/kernels/ops.py`` for the serving path (PDQ weights, fp or int8 KV
cache, paged pool) and the ops-level quantization entry points (the
unfused PDQ projection, ``act_stats``, ``quantize``, ``dequantize``).

Dispatch is by the tensor's device, never by a global switch: a CPU tensor
takes a kernel's plain version (``kernels/ref.py``), a CUDA tensor launches
the CUDA kernel or raises.  There is no fallback from a failed build or
launch.

Every kernel keeps two counts (``counts()``): ``entries``, the calls of its
op here on any device, and ``launches``, the CUDA launches its wrapper
made.  On the card the two are equal on the main path; ``chip_smoke.py``
reads them to show that the path went through the kernels.

All ops take arbitrary leading batch dims.  Ragged shapes are masked in
the kernels, so nothing is padded here.

Tensor parallelism (``tp_shard``): the sharded serving engine runs each
replica's program inside its mesh row's ``TPRow``, and the projections
whose weights the row split run each shard's columns on its device (see
the section below).

The guarded fp fallback (``pdq_guard``) and PDQ health (``pdq_telemetry``)
are the reference's, with the counting and the finite check moved into the
kernels: see the section below.
"""
from __future__ import annotations

import contextlib
import math

import numpy as np
import torch

from . import _build
from . import act_stats as _as
from . import fp_dequant as _fd
from . import kv_cache as _kv
from . import pdq_prologue as _pro
from . import quantize as _qz
from . import ref
from . import w8a8_matmul as _mm
from .ref import from_page_rows as from_page_rows
from .ref import grid_extent as _grid_extent
from .ref import pdq_interval as pdq_interval
from .ref import to_page_rows as to_page_rows
from .ref import true_div
from .w8a8_matmul import k_major as k_major

LANE = _mm.LANE

COUNTS = {
    "pdq_prologue": _pro.COUNT,
    "w8a8_matmul": _mm.COUNT,
    "w8a8_swiglu_matmul": _mm.SWIGLU_COUNT,
    "decode_attend_i8kv": _kv.ATTEND_COUNT,
    "decode_attend_i8kv_fused": _kv.FUSED_COUNT,
    "cache_scatter": _kv.COUNT,
    "cache_scatter_pages": _kv.PAGES_COUNT,
    "act_stats": _as.COUNT,
    "quantize": _qz.QUANTIZE_COUNT,
    "dequantize": _qz.DEQUANTIZE_COUNT,
    "fp_dequant": _fd.COUNT,
}


def _count_cells():
    """(owner, key) of every count: each op's entries and launches, each
    route's and each K1 mode's launches."""
    for c in COUNTS.values():
        yield c.__dict__, "entries"
        yield c.__dict__, "launches"
    for r in (*_mm.ROUTES.values(), *_kv.ROUTES.values(), *_as.ROUTES.values(),
              *_qz.ROUTES.values(), *_fd.ROUTES.values(), _pro.MODES):
        yield from ((r, k) for k in r)


def reset_counts() -> None:
    for d, k in _count_cells():
        d[k] = 0


def count_state() -> list[int]:
    """Every count as one flat list (``_count_cells`` order): what a
    captured graph compares before and after its capture."""
    return [d[k] for d, k in _count_cells()]


def set_counts(state) -> None:
    """Put back a ``count_state``: capture and warm-up leave the counts as
    they found them."""
    for (d, k), v in zip(_count_cells(), state, strict=True):
        d[k] = v


def add_counts(delta) -> None:
    """Add a ``count_state`` difference: each replay of a captured graph
    adds what its capture counted, so the counts still say what ran."""
    for (d, k), v in zip(_count_cells(), delta, strict=True):
        d[k] += v


def persistent_buffers() -> list:
    """The kernels' device buffers that outlive a call (K2/K3's split-K
    workspace, tickets and grid barrier; K4/K5's and the fallback's split
    workspace and tickets).  A module replaces one when a later call needs it larger and
    drops the old one; a captured graph keeps this list, so the buffers it
    launches on are never freed under it (each is zero at rest, so the
    graph and eager calls may use different ones).  The guard's flag
    (``fp_dequant.flag_buffer``) is one of them."""
    return [*_mm._WS.values(), *_mm._TICKETS.values(), *_kv._WS.values(),
            *_kv._TICKETS.values(), *_fd._FLAGS.values(), *_fd._WS.values(),
            *_fd._TICKETS.values()]


def counts() -> dict[str, dict[str, int]]:
    return {k: {"entries": c.entries, "launches": c.launches}
            for k, c in COUNTS.items()}


def route_counts() -> dict[str, dict[str, int]]:
    """Launches per route of K2 and K3 (``wgmma``, ``generic``), of K4
    and K5 (``split``, ``single``), of K8 (``vector``, ``element``), of K9
    (``vector``, ``wide``, ``element``), of K10 (``vector``, ``stream``,
    ``element``) and of the guard's fallback (``wgmma``, ``fma``,
    ``generic``)."""
    return {k: dict(r) for k, r in (*_mm.ROUTES.items(), *_kv.ROUTES.items(),
                                    *_as.ROUTES.items(), *_qz.ROUTES.items(),
                                    *_fd.ROUTES.items())}


def prologue_modes() -> dict[str, int]:
    """K1's launches per mode: ``prologue`` alone, with the ``norm`` in
    front, with the ``interval`` after it, or ``norm+interval``."""
    return dict(_pro.MODES)


def _rows(x) -> int:
    return math.prod(x.shape[:-1])


# ---------------------------------------------------------------------------
# Tensor parallelism (serving): column split + gather (reference ops.py:44-82)
# ---------------------------------------------------------------------------
#
# ``serve/sharded.py`` runs each data-parallel replica's program inside
# ``tp_shard(row)``, ``row`` a ``TPRow`` over the replica's mesh row: shard
# j on entry j's device, entry 0 the home, where the program runs.  The
# row holds each shard's own block of columns of every weight it splits
# (``models/linops.tp_place``, placed once when the engine is built: a
# copy on a card other than the home, a view where the entries share one).
# A projection whose weight has blocks then runs each shard on its device:
# K1's outputs (x_q, s_x and the shard's slice of a per-block interval
# grid; the fp x under a guard) are copied there, K2 runs over the shard's
# block, the guard checks and falls back there, and the block comes back to
# the home into its columns of the output: the reference's tiled
# all-gather.  Every output column is the same full-K int8 accumulation and
# epilogue the unsplit launch computes, so the result is the unsplit one
# bit for bit.  A weight without blocks (its columns do not divide over
# the row) runs whole on the home.
#
# The prologue (K1) runs once a replica and every shard reads its x_q and
# s_x (the reference recomputes it on every shard, an SPMD shard having no
# other source; the values are the same).  A shard on the home's card
# counts its clip hits into the active collector; one on another card into
# counters of that card, which the collector's exit adds into the home's
# (``TPRow.fold``), so the totals equal an unsplit run's (the reference
# psums them).
#
# Streams: shard 0 runs on the home's current stream, every other shard on
# a stream of the row's own on its card, which waits for the home's stream
# first (the fork) and which the home's stream waits for after the shard's
# block has come back (the join); the same fork and join hold in eager
# launches and inside a decode graph's capture, whose graph then spans the
# row's cards.  Shards that share a card run concurrently on their own
# streams, each with its own set of the card's kernel buffers
# (``_build.buffer_set``).  Nothing a shard touches on another card than the home
# is allocated while it runs: its inputs and outputs are buffers of the row
# kept by shape (``TPRow.buf``), made at their first use - outside any
# capture, since a decode graph warms its block up first.


class TPRow:
    """A replica's tensor-parallel shards: ``devices`` (shard j on entry
    j's device; entry 0 the home) and ``blocks``, ``linops.tp_place``'s
    {id(leaf): (leaf, [shard j's block])} of every weight the row splits.
    ``shards`` is the row's width."""

    def __init__(self, devices, blocks):
        self.devices = [torch.device(d) for d in devices]
        self.home = self.devices[0]
        self.shards = len(self.devices)
        self.blocks = blocks
        self.buffer_sets = [self.devices[:j].count(d) for j, d in enumerate(self.devices)]
        cuda = self.home.type == "cuda"
        self.streams = [None] + [torch.cuda.Stream(d) if cuda else None
                                 for d in self.devices[1:]]
        self._bufs: dict = {}
        self._tel: dict = {}      # a card other than the home -> its shards' counters
        # bytes the row's copies moved between two devices, counted on the
        # host where each copy is made (a graph's replay moves what its
        # capture counted)
        self.peer_bytes = 0

    def split(self, leaf):
        """Shard j's block of ``leaf`` for every j, or None (unsplit)."""
        got = self.blocks.get(id(leaf))
        return None if got is None else got[1]

    def stream_count(self) -> int:
        """The streams a dispatch of the replica runs on."""
        return 1 + sum(s is not None for s in self.streams)

    def weight_bytes(self, seen=None) -> dict:
        """{device: bytes} of the split weights' storage on each of the row's
        devices (a view counts its base once; ``seen``, a set shared over
        several rows, counts a storage they share once)."""
        seen = set() if seen is None else seen
        out = {str(d): 0 for d in dict.fromkeys(self.devices)}
        for _, blocks in self.blocks.values():
            for b in blocks:
                for t in (b.values() if isinstance(b, dict) else (b,)):
                    st = t.untyped_storage()
                    key = (str(t.device), st.data_ptr())
                    if key not in seen:
                        seen.add(key)
                        out[str(t.device)] += st.nbytes()
        return out

    @contextlib.contextmanager
    def shard(self, j: int, *, fork: bool = True, join: bool = True):
        """Run shard j's work inside: its card and stream current (the
        fork: the stream first waits for the home's), its set of the
        card's kernel buffers; the home's stream waits for it after (the
        join)."""
        s = self.streams[j]
        if s is None:
            on = (torch.cuda.device(self.devices[j]) if self.devices[j].type == "cuda"
                  else contextlib.nullcontext())
            with on, _build.buffer_set(self.buffer_sets[j]):
                yield
            return
        home = torch.cuda.current_stream(self.home)
        if fork:
            s.wait_stream(home)
        with torch.cuda.device(s.device), torch.cuda.stream(s), \
                _build.buffer_set(self.buffer_sets[j]):
            yield
        if join:
            home.wait_stream(s)

    def buf(self, j: int, role: str, shape, dtype) -> torch.Tensor:
        """Shard j's kept buffer for ``role`` at ``shape`` and ``dtype``."""
        key = (j, role, tuple(shape), dtype)
        b = self._bufs.get(key)
        if b is None:
            b = self._bufs[key] = torch.empty(tuple(shape), dtype=dtype,
                                              device=self.devices[j])
        return b

    def take(self, j: int, role: str, t):
        """``t`` for shard j: itself where it is already a contiguous tensor
        of the shard's device, else copied into the shard's buffer."""
        if t.device == self.devices[j] and t.is_contiguous():
            return t
        return self._copy(self.buf(j, role, t.shape, t.dtype), t)

    def _copy(self, dst, src):
        if dst.device != src.device:
            self.peer_bytes += src.numel() * src.element_size()
        return dst.copy_(src)

    def tel_of(self, j: int, tel):
        """The counters shard j counts into: the collector's ``tel`` on the
        home's card, the row's own on another card."""
        d = self.devices[j]
        if tel is None or d == self.home:
            return tel
        t = self._tel.get(d)
        if t is None:
            t = self._tel[d] = torch.zeros((PDQ_TEL_WIDTH,), dtype=torch.int64, device=d)
        return t

    def fold(self, counters) -> None:
        """Add what the shards on other cards counted into the home's
        ``counters`` and clear theirs."""
        for d, t in self._tel.items():
            j = self.devices.index(d)
            stage = self.buf(0, f"tel {d}", t.shape, t.dtype)
            with self.shard(j):
                self._copy(stage, t)
                t.zero_()
            counters.add_(stage)

    def columns(self, blocks, M: int, N: int, dtype, launch):
        """The (M, N) output on the home whose shard-j columns are
        ``launch(j, block_j)`` (an (M, N / T) tensor on shard j's device).
        Shards are forked last to first, so that the copies the home's
        stream makes for shards 1.. run before shard 0's own launch; the
        blocks come back in shard order."""
        T = len(blocks)
        n = N // T
        out = torch.empty((M, N), dtype=dtype, device=self.home)
        ys = [None] * T
        for j in reversed(range(T)):
            with self.shard(j, join=False):
                ys[j] = launch(j, blocks[j])
        for j in range(T):
            with self.shard(j, fork=False):
                self._copy(out[:, j * n:(j + 1) * n], ys[j])
        return out


_TP: TPRow | None = None     # the row of the replica being run


@contextlib.contextmanager
def tp_shard(row: TPRow | None):
    """Split the columns of the projections run inside over ``row``'s
    shards; None, or a row of one shard, is a no-op."""
    global _TP
    prev = _TP
    _TP = row if row is not None and row.shards > 1 else None
    try:
        yield
    finally:
        _TP = prev


def tp_ctx() -> TPRow | None:
    """The active row, or None outside ``tp_shard``."""
    return _TP


def tp_matmul(x, w):
    """``x @ w`` of an fp weight with blocks in the active row, each shard's
    columns on its device (``linops.lin``); None when w is not split.  A
    narrower GEMM may sum in another order than the whole one."""
    blocks = None if _TP is None else _TP.split(w)
    if blocks is None:
        return None
    row, K = _TP, x.shape[-1]
    x2 = x.reshape(-1, K)
    M, N = x2.shape[0], w.shape[-1]

    def launch(j, wj):
        y = row.buf(j, "y", (M, wj.shape[-1]), x.dtype)
        return torch.matmul(row.take(j, "x", x2), wj, out=y)

    return row.columns(blocks, M, N, x.dtype, launch).reshape(*x.shape[:-1], N)


# ---------------------------------------------------------------------------
# Guarded PDQ fallback and PDQ health (the reference's ops.py:88-222)
# ---------------------------------------------------------------------------
#
# With ``pdq_guard`` active, every PDQ fp-out projection checks its result
# and, per projection and per launch, falls back to the plain fp-dequant
# matmul ``x @ (q * scale)`` when any element is non-finite.  The check is
# the W8A8 epilogue's (it sets the guard's flag where it stores a NaN or an
# infinity) and the branch is the predicated fallback kernel
# (``kernels/fp_dequant.py``), which reads the flag on the device: nothing
# reads the host inside a projection, and a captured graph holds both.
#
# ``pdq_telemetry`` collects [fallbacks, clip_hits, clip_total] into ONE
# int64 (3,) tensor on the projections' device: K2/K3 add their clip hits
# and M x N in their epilogues and the fallback kernel its activation (the
# plain versions do the same with tensor ops on the CPU).  Engines read it
# in the copy that brings their tokens to the host.
#
# The switches are read when a projection runs: on the card, that is when
# an engine captures its decode graph (the reference reads them when it
# traces), on the CPU whenever the block runs.

_PDQ_GUARD = False
_PDQ_FAULT = False      # test hook: poison every guarded fast-path result
_PDQ_TEL: "PdqTelemetryCollector | None" = None

# the summary layout engines unpack: [fallbacks, clip_hits, clip_total]
PDQ_TEL_WIDTH = 3


@contextlib.contextmanager
def pdq_guard(enable: bool = True):
    """Enable the per-projection PDQ -> fp-dequant fallback for the
    projections run inside."""
    global _PDQ_GUARD
    prev = _PDQ_GUARD
    _PDQ_GUARD = bool(enable)
    try:
        yield
    finally:
        _PDQ_GUARD = prev


class PdqTelemetryCollector:
    """The PDQ health counters of the projections run while it is active:
    ``counters``, int64 (3,) [fallbacks, clip_hits, clip_total] on their
    device, made at the first projection unless given (an engine passes its
    own, e.g. a captured graph's static buffer, to accumulate over a block).
    ``summary()`` gives the reference's (3,) float32 layout."""

    def __init__(self, counters=None):
        self.counters = counters

    def on(self, device) -> torch.Tensor:
        if self.counters is None:
            self.counters = torch.zeros((PDQ_TEL_WIDTH,), dtype=torch.int64,
                                        device=device)
        return self.counters

    def summary(self) -> torch.Tensor:
        if self.counters is None:
            return torch.zeros((PDQ_TEL_WIDTH,), dtype=torch.float32)
        return self.counters.float()


@contextlib.contextmanager
def pdq_telemetry(enable: bool = True, counters=None):
    """Collect PDQ health from every projection run inside (nests with
    ``pdq_guard``).  ``counters``: an int64 (3,) tensor to add into.
    ``enable=False`` yields a collector that nothing counts into, whose
    summary is zeros (the kernels get null counter pointers)."""
    global _PDQ_TEL
    col = PdqTelemetryCollector(counters)
    prev = _PDQ_TEL
    _PDQ_TEL = col if enable else None
    try:
        yield col
        if enable and _TP is not None and col.counters is not None:
            _TP.fold(col.counters)      # the shards' counts on other cards
    finally:
        _PDQ_TEL = prev


@contextlib.contextmanager
def pdq_fault():
    """Test-only: poison every guarded fast-path output with NaN, so the
    fallback is forced to carry the computation."""
    global _PDQ_FAULT
    prev = _PDQ_FAULT
    _PDQ_FAULT = True
    try:
        yield
    finally:
        _PDQ_FAULT = prev


# the fallback's precision, under the reference's name; the plain versions
# of the kernels' counting (its _tel_clip, _tel_clip_q) are ref.tel_clip and
# ref.tel_clip_q
_fp_dequant_matmul = ref.fp_dequant_matmul


def _tel(device):
    """The active collector's counters on ``device``, or None."""
    return None if _PDQ_TEL is None else _PDQ_TEL.on(device)


def _guard_flag(device):
    """The guard's non-finite flag for a projection's epilogue, or None
    when no guard is active."""
    return _fd.flag_buffer(device) if _PDQ_GUARD else None


def _guard_pdq(y, x, w_q, scale, flag, tel):
    """y, or - where the projection's epilogue flagged a non-finite value -
    the fp-dequant fallback, written into y in place and counted into
    ``tel``; a no-op without a guard (``flag`` None).  Under ``pdq_fault``
    y is poisoned first and the flag taken from it, as the reference adds
    NaN before its check."""
    if flag is None:
        return y
    N = y.shape[-1]
    y2 = y.reshape(-1, N)
    if _PDQ_FAULT:
        y2.add_(float("nan"))
        ref.flag_non_finite(y2, flag)
    if not _mm.is_k_major(w_q):
        w_q = k_major(w_q)
    COUNTS["fp_dequant"].entries += 1
    _fd.fp_dequant_fallback(y2, x.reshape(-1, x.shape[-1]).contiguous(), w_q,
                            scale.float().contiguous(), flag, tel)
    return y


def _norm_epi(a, M, cols, dtype, device):
    """Broadcast a scalar, (M,)-like or (M, 1 | cols) operand to a
    contiguous (M, cols).  A Python number is filled on the device (no
    host-to-device copy on the decode path)."""
    if not torch.is_tensor(a):
        return torch.full((M, cols), a, dtype=dtype, device=device)
    a = a.to(device=device, dtype=dtype)
    if a.dim() == 0:
        return a.expand(M, cols).contiguous()
    a = a.reshape(M, -1)
    if a.shape[1] not in (1, cols):
        raise ValueError(f"epilogue operand has {a.shape[1]} columns; "
                         f"expected 1 (per-row) or {cols} (per-N-block)")
    return a.expand(M, cols).contiguous()


def _norm_row(a, M, dtype, device):
    """Broadcast a scalar / (M,) / (M, 1) quantity to a contiguous (M, 1)."""
    return _norm_epi(a, M, 1, dtype, device)


def w8a8_matmul(x_q, w_q, s_x, z_x, s_w, s_out=None, z_out=None, *,
                colsum=None, fp_range=None, out_dtype=torch.float32, tel=None,
                flag=None, out=None):
    """y = s_x*s_w*(x_q @ w_q - z_x*colsum); requantized int8 iff s_out given.

    x_q: (..., K) int8; w_q: (K, N) int8, K-major as the weight records
    store it (any other layout is made K-major here, a copy on every call).
    s_x/z_x: scalar, (...) or
    (..., 1) per row; s_w: scalar or (N,) per channel.  ``fp_range=(lo,
    hi)`` (exclusive with s_out) clamps in the epilogue and emits
    ``out_dtype``.  Epilogue operands are per row, or per (row, 128-column
    block) shaped (..., N // 128) - the grouped projections' layout.
    ``tel`` / ``flag``: the PDQ health counters and the guard's flag the
    epilogue writes (``kernels/w8a8_matmul.py``); ``out``: a contiguous (M,
    N) tensor the kernel writes instead of a new one.
    """
    lead = x_q.shape[:-1]
    K, N = x_q.shape[-1], w_q.shape[-1]
    M = _rows(x_q)
    dev = x_q.device
    requant = s_out is not None
    if requant and fp_range is not None:
        raise ValueError("fp_range and s_out are exclusive")
    # only the chosen epilogue's operands go to the kernel; the rest stay None
    if requant:
        epi, dtypes = (s_out, z_out), (torch.float32, torch.int32)
    else:
        epi, dtypes = fp_range or (), (torch.float32, torch.float32)
    per_nblock = any(torch.is_tensor(a) and a.dim() == len(lead) + 1
                     and a.shape[-1] > 1 for a in epi)
    if per_nblock and N % LANE:
        raise ValueError(f"per-(row, N-block) epilogue operands need N "
                         f"({N}) to be a multiple of {LANE}")
    cols = N // LANE if per_nblock else 1
    epi = [_norm_epi(a, M, cols, dt, dev) for a, dt in zip(epi, dtypes)]
    s_out, z_out = epi if requant else (None, None)
    lo, hi = epi if fp_range is not None else (None, None)
    # a zero point of 0 (the main path's symmetric activations) needs
    # neither z_x nor colsum
    if not torch.is_tensor(z_x) and z_x == 0:
        z_x = colsum = None
    else:
        z_x = _norm_row(z_x, M, torch.int32, dev)
        if colsum is None:
            colsum = w_q.sum(0, keepdim=True, dtype=torch.int32)
        colsum = colsum.reshape(1, N)
    if not _mm.is_k_major(w_q):
        w_q = k_major(w_q)
    COUNTS["w8a8_matmul"].entries += 1
    y = _mm.w8a8_matmul(
        x_q.reshape(M, K).contiguous(), w_q, _norm_row(s_x, M, torch.float32, dev),
        z_x, _norm_epi(s_w, 1, N, torch.float32, dev), colsum, s_out, z_out, lo, hi,
        out_dtype=out_dtype, tel=tel, flag=flag, out=out)
    return y.reshape(*lead, N)


def pdq_prologue(x):
    """ONE pass over x (..., K) emits (x_q int8 like x, s_x, s1, s2 each
    shaped (..., 1)); see kernels/pdq_prologue.py."""
    lead, K = x.shape[:-1], x.shape[-1]
    x_q, s_x, s1, s2 = _prologue(x)
    return (x_q.reshape(*lead, K), s_x.reshape(*lead, 1),
            s1.reshape(*lead, 1), s2.reshape(*lead, 1))


def _prologue(x, norm=None, wrec=None, blocks=None):
    """K1 over the rows of x (..., K), as (M, ...) tensors: (x_q, s_x, s1,
    s2) and with ``wrec`` the interval's (lo_g, hi_g), per segment or, with
    ``blocks``, per 128-column block; ``norm = (w, eps)`` RMS-normalizes
    each row first."""
    COUNTS["pdq_prologue"].entries += 1
    return _pro.pdq_prologue(x.reshape(_rows(x), x.shape[-1]), norm,
                             None if wrec is None else (wrec, blocks))


def _blocks(segs) -> tuple:
    """Each segment's count of 128-column blocks."""
    return tuple(p // LANE for p in segs.padded)


def _blockwise(a, segs):
    """Per-segment (..., n_seg) -> per-128-column-block (..., N/128)."""
    return ref.blockwise(a, _blocks(segs))


def _fp_matmul(x, x_q, s_x, wrec, lo_g, hi_g, out_dtype):
    """The fp-clamp W8A8 product (M, N) of K1's (M, ...) outputs,
    counted by an active collector and checked by an active guard (whose
    fallback reads x).  ``lo_g``/``hi_g`` are per row (M, 1) or per
    128-column block (M, N / 128).  Under ``tp_shard`` a record with blocks
    in the row runs each shard over its own block on its device (the
    interval's blocks sliced to the shard's): reference
    ``pdq_dense_from_prologue`` and ``pdq_dense_grouped``."""
    out_dtype = torch.float32 if out_dtype is None else out_dtype
    M, N = x_q.shape[0], wrec["q"].shape[-1]
    x = x.reshape(M, -1)
    tel = _tel(x.device)
    blocks = None if _TP is None else _TP.split(wrec)
    if blocks is None:
        return _fp_shard(x, x_q, s_x, wrec, lo_g, hi_g, out_dtype, tel)
    row, T, nb = _TP, len(blocks), lo_g.shape[-1]

    def launch(j, b):
        g = slice(None) if nb == 1 else slice(j * nb // T, (j + 1) * nb // T)
        return _fp_shard(row.take(j, "x", x) if _PDQ_GUARD else None,
                         row.take(j, "x_q", x_q), row.take(j, "s_x", s_x), b,
                         row.take(j, "lo", lo_g[:, g]), row.take(j, "hi", hi_g[:, g]),
                         out_dtype, row.tel_of(j, tel),
                         out=row.buf(j, "y", (M, b["q"].shape[-1]), out_dtype))

    return row.columns(blocks, M, N, out_dtype, launch)


def _fp_shard(x, x_q, s_x, wrec, lo_g, hi_g, out_dtype, tel, out=None):
    """One K2 launch of ``_fp_matmul`` over ``wrec``'s columns (into
    ``out`` when given), then the guard's check and fallback over them (x
    is read by the fallback alone)."""
    flag = _guard_flag(x_q.device)
    y = w8a8_matmul(x_q, wrec["q"], s_x, 0, wrec["scale"], colsum=wrec["colsum"],
                    fp_range=(lo_g, hi_g), out_dtype=out_dtype, tel=tel, flag=flag, out=out)
    return _guard_pdq(y, x, wrec["q"], wrec["scale"], flag, tel)


def pdq_dense(x, wrec, *, out="fp", out_dtype=None, norm=None):
    """The fused PDQ dense layer: one prologue + one W8A8 matmul.

    ``wrec`` is a record from ``models.linops.quantize_weight``.  out='fp'
    returns y (..., N) in ``out_dtype`` (default f32) with the interval
    clamp in the epilogue, priced in the prologue's launch; ``norm = (w,
    eps)``: x is the un-normed input and the prologue's launch applies
    ``ref.rms_norm`` first (under a guard plain torch applies it before the
    launch, as in ``pdq_dense_grouped``).  out='int8' returns (y_q (..., N)
    int8, s_out (..., 1) f32, z_out (..., 1) i32).
    """
    if out not in ("fp", "int8"):
        raise ValueError(out)
    if norm is not None and (out == "int8" or _PDQ_GUARD):
        x, norm = ref.rms_norm(x, *norm), None
    if out == "int8":
        x_q, s_x, s1, s2 = pdq_prologue(x)
        lo, hi, s_out, z_out = pdq_interval(wrec, s1, s2)
        z_out = z_out.to(torch.int32)
        y_q = w8a8_matmul(x_q, wrec["q"], s_x, 0, wrec["scale"], s_out, z_out,
                          colsum=wrec["colsum"], tel=_tel(x.device))
        return y_q, s_out, z_out
    x_q, s_x, _, _, lo_g, hi_g = _prologue(x, norm, wrec)
    y = _fp_matmul(x, x_q, s_x, wrec, lo_g, hi_g, out_dtype)
    return y.reshape(*x.shape[:-1], y.shape[-1])


def pdq_dense_from_prologue(x, x_q, s_x, s1, s2, wrec, *, out_dtype=None):
    """``pdq_dense(out='fp')`` with the prologue already computed upstream.
    The fp ``x`` is read only by an active guard's fallback, rounded to
    ``out_dtype`` first: the reference's model hands its fp input over in
    that dtype, the port's passes the attend kernel's f32 output and leaves
    the rounding to the guard, which alone reads it."""
    out_dtype = torch.float32 if out_dtype is None else out_dtype
    _, _, s_out, z_out = pdq_interval(wrec, s1, s2)
    lo_g, hi_g = _grid_extent(s_out, z_out)
    M = _rows(x_q)
    lead = x_q.shape[:-1]
    x = (x.to(out_dtype) if _PDQ_GUARD else x).reshape(M, -1)   # the guard alone reads x
    y = _fp_matmul(x, x_q.reshape(M, -1), s_x.reshape(M, 1), wrec,
                   lo_g.reshape(M, 1), hi_g.reshape(M, 1), out_dtype)
    return y.reshape(*lead, y.shape[-1])


def pdq_dense_grouped(x, grec, *, out="fp", out_dtype=None, norm=None):
    """Grouped PDQ dense: ONE prologue + ONE wide W8A8 matmul for every
    projection that reads the same input.  ``grec`` is a record from
    ``models.linops.group_quantize_weights``; every segment prices its own
    interval from the shared (s1, s2) and the matmul applies it per
    128-column block.  ``norm = (w, eps)``: x is the un-normed input and
    the prologue's launch applies ``ref.rms_norm`` first (under a guard
    plain torch applies it before the launch, so that the fallback reads the
    normed x, as the reference's does).

    out='fp' returns a tuple of per-segment outputs (..., N_i) in
    ``out_dtype`` (default f32); out='int8' returns (tuple of per-segment
    int8 outputs, s_out (..., n_seg) f32, z_out (..., n_seg) i32).
    """
    if out not in ("fp", "int8"):
        raise ValueError(out)
    segs = grec["segs"]
    bounds = list(zip(segs.offsets, segs.sizes))
    if out == "int8":
        lead = x.shape[:-1]
        x_q, s_x, s1, s2 = _prologue(x, norm)
        _, _, s_out, z_out = pdq_interval(grec, s1, s2)      # (M, n_seg)
        z_out = z_out.to(torch.int32)
        y_q = w8a8_matmul(x_q, grec["q"], s_x, 0, grec["scale"],
                          _blockwise(s_out, segs), _blockwise(z_out, segs),
                          colsum=grec["colsum"], tel=_tel(x.device)).reshape(*lead, -1)
        return (tuple(y_q[..., o:o + n] for o, n in bounds),
                s_out.reshape(*lead, -1), z_out.reshape(*lead, -1))
    if _PDQ_GUARD and norm is not None:
        x, norm = ref.rms_norm(x, *norm), None
    x_q, s_x, _, _, lo_g, hi_g = _prologue(x, norm, grec, _blocks(segs))
    y = _fp_matmul(x, x_q, s_x, grec, lo_g, hi_g, out_dtype).reshape(*x.shape[:-1], -1)
    return tuple(y[..., o:o + n] for o, n in bounds)


def pdq_mlp(x, grec, down_rec, *, out_dtype=None, norm=None):
    """Quantized SwiGLU MLP in three launches: the prologue of x (with the
    gate/up interval, and with ``norm = (w, eps)`` the RMSNorm of x in
    front), the fused gate/up matmul whose epilogue also computes silu(g) *
    u and w_down's prologue (kernel K3), and the w_down matmul.

    ``grec`` must be the two equal, 128-column padded segments
    ``group_quantize_weights((w_gate, w_up))`` makes.  The reference's
    unfused composition (``pdq_dense_grouped`` + silu + ``pdq_dense``)
    agrees to float tolerance; the tests hold the two together.  Under an
    active guard or ``tp_shard`` the MLP takes that composition, as the
    reference does (the fallback needs the gate/up output; a shard owns
    columns of both gate and up), and K3 does not run.  A collector
    counts K3's f32 gate/up values, as the reference's fused kernel's.
    """
    out_dtype = torch.float32 if out_dtype is None else out_dtype
    segs = grec["segs"]
    if not (len(segs.sizes) == 2 and segs.padded[0] == segs.padded[1]
            and segs.padded[0] % LANE == 0):
        raise ValueError(f"pdq_mlp needs two equal 128-padded segments, got "
                         f"{segs.padded}")
    if _PDQ_GUARD or tp_ctx() is not None:
        # the unfused composition: under TP each shard owns columns of both
        # gate and up, while w_down's prologue needs the whole silu(g) * u row
        g, u = pdq_dense_grouped(x, grec, out="fp", out_dtype=out_dtype, norm=norm)
        return pdq_dense(torch.nn.functional.silu(g) * u, down_rec, out="fp",
                         out_dtype=out_dtype)
    lead, K = x.shape[:-1], x.shape[-1]
    M, Nt = _rows(x), segs.total
    x_q, s_x, _, _, lo_g, hi_g = _prologue(x, norm, grec, _blocks(segs))
    COUNTS["w8a8_swiglu_matmul"].entries += 1
    tel = _tel(x.device)
    _hsw, hsw_q, sxo, s1o, s2o = _mm.w8a8_swiglu_matmul(
        x_q, grec["q"], s_x, None, grec["scale"].reshape(1, Nt), None, lo_g, hi_g,
        tel=tel)
    dff = down_rec["q"].shape[0]
    hq = hsw_q[:, :dff].reshape(*lead, dff)
    _, _, so2, zo2 = pdq_interval(down_rec, s1o.reshape(*lead, 1),
                                  s2o.reshape(*lead, 1))
    lo2, hi2 = _grid_extent(so2, zo2)
    return w8a8_matmul(hq, down_rec["q"], sxo.reshape(*lead, 1), 0,
                       down_rec["scale"], colsum=down_rec["colsum"],
                       fp_range=(lo2, hi2), out_dtype=out_dtype, tel=tel)


def pdq_dense_unfused(x, wrec):
    """The pre-fusion PDQ projection, kept as the oracle and baseline of
    the fused ``pdq_dense``: three passes over x in plain torch and K8 (amax,
    the round to int8, the moments), the W8A8 matmul with the requant
    epilogue, and the dequant in plain torch.  ``pdq_dense(out='fp')``
    matches it to within one int8 step of each row's grid.  Returns (y
    (..., N) f32, s_out (..., 1) f32)."""
    x32 = x.float()
    amax = x32.abs().amax(-1).clamp_min(1e-8)
    s_x = true_div(amax, 127.0)
    x_q = torch.round(x32 / s_x[..., None]).clamp(-127, 127).to(torch.int8)
    s1, s2 = act_stats(x32)
    _, _, s_out, z_out = pdq_interval(wrec, s1[..., None], s2[..., None])
    z_out = z_out.to(torch.int32)
    y_q = w8a8_matmul(x_q, wrec["q"], s_x[..., None], 0, wrec["scale"], s_out, z_out,
                      colsum=wrec["colsum"])
    y = (y_q.float() - z_out.float()) * s_out
    return y, s_out


def act_stats(x, gamma: int = 1):
    """(sum x, sum x^2) over the last axis in f32 (kernel K8), each shaped
    ``x.shape[:-1]``.  ``gamma`` > 1 subsamples the second-to-last
    ("position") axis, as the paper's sampling stride; like the reference
    it applies only when x has more than two dims.  The kernel reads the
    subsampled rows where they lie."""
    if x.dim() > 2 and gamma > 1:
        x = x[..., ::gamma, :]
    lead, K = x.shape[:-1], x.shape[-1]
    if x.dim() > 2:
        x3 = x.reshape(math.prod(x.shape[:-2]), x.shape[-2], K)
    else:
        x3 = x.reshape(1, _rows(x), K)
    if K > 1 and x3.stride(-1) != 1:
        x3 = x3.contiguous()
    COUNTS["act_stats"].entries += 1
    s1, s2 = _as.act_stats(x3)
    return s1.reshape(lead), s2.reshape(lead)


def _affine_operands(scale, zero_point, M, N, per_channel, device):
    """Scale (f32) and zero point (int32) per row as contiguous (M, 1), or
    per channel as (1, N): a scalar, (M,)-like or (M, 1) operand, or with
    ``per_channel`` a scalar, (N,) or (1, N) one."""
    rows, cols = (1, N) if per_channel else (M, 1)
    return (_norm_epi(scale, rows, cols, torch.float32, device),
            _norm_epi(zero_point, rows, cols, torch.int32, device))


def quantize(x, scale, zero_point, *, per_channel: bool = False):
    """Affine int8 quantize (kernel K9): clamp(round(x / scale) + z, -128,
    127) of x (..., N) f32/bf16.  Scale and zero point are per row
    (broadcast over the last axis) by default, per channel (the last axis)
    with ``per_channel=True``."""
    lead, N = x.shape[:-1], x.shape[-1]
    M = _rows(x)
    s, z = _affine_operands(scale, zero_point, M, N, per_channel, x.device)
    COUNTS["quantize"].entries += 1
    return _qz.quantize(x.reshape(M, N).contiguous(), s, z).reshape(*lead, N)


def dequantize(q, scale, zero_point, *, per_channel: bool = False,
               out_dtype=torch.float32):
    """(q - z) * scale of int8 q (..., N) in ``out_dtype`` (kernel K10),
    scale and zero point as for ``quantize``; bf16 follows the reference's
    ops contract (``ref.dequantize_ref``)."""
    lead, N = q.shape[:-1], q.shape[-1]
    M = _rows(q)
    s, z = _affine_operands(scale, zero_point, M, N, per_channel, q.device)
    COUNTS["dequantize"].entries += 1
    return _qz.dequantize(q.reshape(M, N).contiguous(), s, z, out_dtype).reshape(*lead, N)


def decode_attend_i8kv(q, k_q, v_q, k_scale, v_scale, length, *,
                       wo_prologue: bool = False, pro_dtype=None):
    """One-token attention over an int8 KV cache in KERNEL layout.

    q: (B, H, Dh) f32; k_q/v_q: (B, Hkv, Sp, Dh) int8; k_scale/v_scale:
    (B, Hkv, Sp) f32; length: (B,) int32, each row's valid prefix (a ragged
    Sp and ragged lengths are masked in the kernel).  Returns o (B, H, Dh)
    f32.

    ``wo_prologue=True`` also runs the wo projection's PDQ prologue over
    each row's flattened (H * Dh) output, after rounding it to
    ``pro_dtype`` (default f32), in the same launch, and returns (o, o_q
    (B, H * Dh) int8, s_x, s1, s2 each (B, 1) f32): feed them to
    ``pdq_dense_from_prologue`` and the quantized wo costs one launch.
    """
    if wo_prologue:
        COUNTS["decode_attend_i8kv_fused"].entries += 1
        return _kv.decode_attend_i8kv_fused(q, k_q, v_q, k_scale, v_scale,
                                            length, pro_dtype)
    COUNTS["decode_attend_i8kv"].entries += 1
    return _kv.decode_attend_i8kv(q, k_q, v_q, k_scale, v_scale, length)


def cache_scatter_rows(dst, src, src_map, *, batch_axis: int = 0):
    """Cache-row scatter IN PLACE: dst row s takes src[src_map[s]] when
    src_map[s] >= 0 and keeps its bits otherwise; returns ``dst``.  Any
    dtype and trailing shape.  One leaf of ``cache_move``: a slot row is a
    page row of the whole sequence.

    ``batch_axis=1`` handles stacked per-block leaves (n, B, ...): one map
    serves every stack entry.  A numpy ``src_map`` (the scheduler's plans)
    is range-checked on the host.
    """
    if not torch.is_tensor(src_map):
        mv = _kv.Move(dst, src, batch_axis=batch_axis,
                      host_map=np.asarray(src_map, np.int32))
    else:
        mv = _kv.Move(dst, src, src_map.to(device=dst.device, dtype=torch.int32),
                      batch_axis=batch_axis)
    cache_move([mv], "cache_scatter")
    return dst


# ---------------------------------------------------------------------------
# Pool movements: the paged pool (serve/pages.py's device half) and the
# slot-row landing.  A cache leaf's seq axis splits into pages and the page
# index folds into the batch axis (``to_page_rows``); every pool movement -
# prefill landing, decode gather and write-back, COW copy, spill restore -
# is then a row scatter over page rows of every leaf, which ONE launch of
# the movement kernel runs without relaying either side out.
# ---------------------------------------------------------------------------


def device_moves(moves):
    """The moves with their host maps on the device, in ONE host-to-device
    copy: each distinct ``host_map`` of a move without a device map, and
    for each such in-place leaf the list of the map's targets (the rows the
    kernel visits).  A move with a device map is left as it is."""
    parts, at, where = [], 0, {}

    def put(key, a):
        nonlocal at
        parts.append(a)
        where[key] = slice(at, at + a.size)
        at += a.size

    for mv in moves:
        k = id(mv.host_map)
        if mv.map is None and ("map", k) not in where:
            put(("map", k), np.asarray(mv.host_map, np.int32))
        if mv.map is None and mv.fill is None and ("rows", k) not in where:
            put(("rows", k), np.flatnonzero(np.asarray(mv.host_map) >= 0).astype(np.int32))
    if not parts:
        return list(moves)
    flat = torch.as_tensor(np.concatenate(parts), device=moves[0].dst.device)
    return [mv if mv.map is not None else mv._replace(
        map=flat[where[("map", id(mv.host_map))]],
        rows=None if mv.fill is not None else flat[where[("rows", id(mv.host_map))]])
        for mv in moves]


def cache_move(moves, op: str = "cache_scatter_pages"):
    """ONE pool movement over every leaf in ``moves`` (``kernels.kv_cache.
    Move``), in one launch, counted under ``op``: ``cache_scatter`` (K6)
    for a slot-row landing, ``cache_scatter_pages`` (K7) for the paged
    pool's movements.  Each dst is updated in place (a leaf with a fill:
    every row written) and must be contiguous.

    A move carries its map as ``host_map`` (numpy, the scheduler's plans;
    sent with the others in one copy) or as a device ``map``.  A host map
    is range-checked here.  ``src is dst`` (the COW copy) needs a host map
    whose targets and sources are disjoint; any other overlap raises.
    """
    bounds = {}
    for mv in moves:
        if not mv.dst.is_contiguous():
            raise ValueError(f"{op} writes dst in place: it must be contiguous")
        rows_s = _kv.layout(mv).src_rows        # the two sides pair
        h = mv.host_map
        if h is not None:
            if id(h) not in bounds:
                a = np.asarray(h)
                bounds[id(h)] = (int(a.min()), int(a.max())) if a.size else (-1, -1)
            lo, hi = bounds[id(h)]
            if lo < -1 or hi >= rows_s:
                raise ValueError(f"{op}: map values must lie in [-1, {rows_s})")
        if _kv.overlaps(mv.dst, mv.src):
            if mv.src is not mv.dst or h is None:
                raise ValueError(f"{op}: dst and src overlap; only src is dst with "
                                 f"a host map is allowed")
            if _kv.targets_meet_sources(h):
                raise ValueError(f"{op}: a page is both a target and a source of "
                                 f"an in-place copy")
    COUNTS[op].entries += 1
    _kv.cache_move(device_moves(moves), COUNTS[op])


def cache_scatter_pages(dst, src, page_map, *, batch_axis: int = 0,
                        seq_axis: int | None = None, page: int | None = None,
                        host_map=None):
    """Row scatter over PAGES, IN PLACE: dst page row p takes src page row
    ``page_map[p]`` (-1 keeps its bits); returns ``dst``.  Any dtype.  One
    leaf of ``cache_move``.

    With ``seq_axis`` None both sides are page rows already (a physical
    pool, or ``to_page_rows`` of a leaf), as in the reference.  With
    ``seq_axis`` and ``page`` either side may be a logical leaf whose seq
    axis splits into pages; the kernel addresses it where it lies, and a
    pool side (seq extent ``page``) is unchanged by the split.

    ``batch_axis=1`` handles stacked per-block leaves (n, B, ...): one map
    serves every stack entry.  A numpy ``page_map`` (the scheduler's plans)
    is range-checked on the host, as is ``host_map``, the numpy copy of a
    device ``page_map``.  ``src is dst`` (the COW copy) needs a host map
    whose targets and sources are disjoint; any other overlap raises.
    """
    if torch.is_tensor(page_map):
        mv = _kv.Move(dst, src, page_map.to(device=dst.device, dtype=torch.int32),
                      seq_axis, page, batch_axis, host_map=host_map)
    else:
        mv = _kv.Move(dst, src, None, seq_axis, page, batch_axis,
                      host_map=np.asarray(page_map, np.int32))
    cache_move([mv], "cache_scatter_pages")
    return dst
