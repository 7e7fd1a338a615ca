"""Public ops over the hand-written kernels: port of
``repro/kernels/ops.py`` for the serving path (PDQ weights, fp or int8 KV
cache).

Dispatch is by the tensor's device, never by a global switch: a CPU tensor
takes a kernel's plain version (``kernels/ref.py``), a CUDA tensor launches
the CUDA kernel or raises.  There is no fallback from a failed build or
launch.

Every kernel keeps two counts (``counts()``): ``entries``, the calls of its
op here on any device, and ``launches``, the CUDA launches its wrapper
made.  On the card the two are equal on the main path; ``chip_smoke.py``
reads them to show that the path went through the kernels.

All ops take arbitrary leading batch dims.  Ragged shapes are masked in
the kernels, so nothing is padded here.  Tensor parallelism, the guarded
fp fallback and PDQ telemetry wait for later slices (ROADMAP.md Queue 1).
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch

from . import kv_cache as _kv
from . import pdq_prologue as _pro
from . import w8a8_matmul as _mm
from .ref import true_div

LANE = _mm.LANE

COUNTS = {
    "pdq_prologue": _pro.COUNT,
    "w8a8_matmul": _mm.COUNT,
    "w8a8_swiglu_matmul": _mm.SWIGLU_COUNT,
    "decode_attend_i8kv": _kv.ATTEND_COUNT,
    "decode_attend_i8kv_fused": _kv.FUSED_COUNT,
    "cache_scatter": _kv.COUNT,
}


def reset_counts() -> None:
    for c in COUNTS.values():
        c.entries = c.launches = 0


def counts() -> dict[str, dict[str, int]]:
    return {k: {"entries": c.entries, "launches": c.launches}
            for k, c in COUNTS.items()}


def _rows(x) -> int:
    return math.prod(x.shape[:-1])


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
                colsum=None, fp_range=None, out_dtype=torch.float32):
    """y = s_x*s_w*(x_q @ w_q - z_x*colsum); requantized int8 iff s_out given.

    x_q: (..., K) int8; w_q: (K, N) int8.  s_x/z_x: scalar, (...) or
    (..., 1) per row; s_w: scalar or (N,) per channel.  ``fp_range=(lo,
    hi)`` (exclusive with s_out) clamps in the epilogue and emits
    ``out_dtype``.  Epilogue operands are per row, or per (row, 128-column
    block) shaped (..., N // 128) - the grouped projections' layout.
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
    COUNTS["w8a8_matmul"].entries += 1
    y = _mm.w8a8_matmul(
        x_q.reshape(M, K).contiguous(), w_q, _norm_row(s_x, M, torch.float32, dev),
        z_x, _norm_epi(s_w, 1, N, torch.float32, dev), colsum, s_out, z_out, lo, hi,
        out_dtype=out_dtype)
    return y.reshape(*lead, N)


def pdq_prologue(x):
    """ONE pass over x (..., K) emits (x_q int8 like x, s_x, s1, s2 each
    shaped (..., 1)); see kernels/pdq_prologue.py."""
    lead, K = x.shape[:-1], x.shape[-1]
    COUNTS["pdq_prologue"].entries += 1
    x_q, s_x, s1, s2 = _pro.pdq_prologue(x.reshape(_rows(x), K))
    return (x_q.reshape(*lead, K), s_x.reshape(*lead, 1),
            s1.reshape(*lead, 1), s2.reshape(*lead, 1))


def pdq_interval(wrec, s1, s2):
    """PDQ surrogate interval from the prologue sums (paper Eqs. 8-9).

    s1/s2: (..., 1).  Returns (lo, hi, s_out, z_out) per row; grouped
    records carry (n_seg,) weight stats and broadcast to (..., n_seg).
    """
    mean = wrec["mu_w"] * s1
    sigma = torch.sqrt(torch.clamp_min(wrec["var_w"] * s2, 0.0)) + 1e-8
    lo = torch.clamp_max(mean - wrec["alpha"] * sigma, 0.0)
    hi = torch.clamp_min(mean + wrec["beta"] * sigma, 0.0)
    s_out = torch.clamp_min(true_div(hi - lo, 255.0), 1e-8)
    z_out = -torch.round(lo / s_out) - 128.0
    return lo, hi, s_out, z_out


def _grid_extent(s_out, z_out):
    """The representable extent [(-128 - z) s, (127 - z) s] of the int8
    grid: fp-out clamps to it (not the raw interval) so that it matches
    requant -> dequant at the clip boundaries."""
    return (-128.0 - z_out) * s_out, (127.0 - z_out) * s_out


def pdq_dense(x, wrec, *, out="fp", out_dtype=None):
    """The fused PDQ dense layer: one prologue + one W8A8 matmul.

    ``wrec`` is a record from ``models.linops.quantize_weight``.  out='fp'
    returns y (..., N) in ``out_dtype`` (default f32) with the interval
    clamp in the epilogue; out='int8' returns (y_q (..., N) int8, s_out
    (..., 1) f32, z_out (..., 1) i32).
    """
    if out not in ("fp", "int8"):
        raise ValueError(out)
    x_q, s_x, s1, s2 = pdq_prologue(x)
    if out == "int8":
        lo, hi, s_out, z_out = pdq_interval(wrec, s1, s2)
        z_out = z_out.to(torch.int32)
        y_q = w8a8_matmul(x_q, wrec["q"], s_x, 0, wrec["scale"], s_out, z_out,
                          colsum=wrec["colsum"])
        return y_q, s_out, z_out
    return pdq_dense_from_prologue(x, x_q, s_x, s1, s2, wrec,
                                   out_dtype=out_dtype)


def pdq_dense_from_prologue(x, x_q, s_x, s1, s2, wrec, *, out_dtype=None):
    """``pdq_dense(out='fp')`` with the prologue already computed upstream
    (``x`` is kept in the signature for the reference's guarded fallback,
    which arrives with the fault-handling slice)."""
    out_dtype = torch.float32 if out_dtype is None else out_dtype
    _, _, s_out, z_out = pdq_interval(wrec, s1, s2)
    lo_g, hi_g = _grid_extent(s_out, z_out)
    return w8a8_matmul(x_q, wrec["q"], s_x, 0, wrec["scale"],
                       colsum=wrec["colsum"], fp_range=(lo_g, hi_g),
                       out_dtype=out_dtype)


@functools.lru_cache(maxsize=64)
def _block_index(padded: tuple, device: torch.device):
    """Segment index of every 128-column block: segment i spans padded[i]
    / 128 blocks.  Built once per layout and device."""
    idx = np.repeat(np.arange(len(padded)), [p // LANE for p in padded])
    return torch.as_tensor(idx, device=device)


def _blockwise(a, segs):
    """Per-segment (..., n_seg) -> per-128-column-block (..., N/128)."""
    return a.index_select(-1, _block_index(segs.padded, a.device))


def pdq_dense_grouped(x, grec, *, out="fp", out_dtype=None):
    """Grouped PDQ dense: ONE prologue + ONE wide W8A8 matmul for every
    projection that reads the same input.  ``grec`` is a record from
    ``models.linops.group_quantize_weights``; every segment prices its own
    interval from the shared (s1, s2) and the matmul applies it per
    128-column block.

    out='fp' returns a tuple of per-segment outputs (..., N_i) in
    ``out_dtype`` (default f32); out='int8' returns (tuple of per-segment
    int8 outputs, s_out (..., n_seg) f32, z_out (..., n_seg) i32).
    """
    if out not in ("fp", "int8"):
        raise ValueError(out)
    out_dtype = torch.float32 if out_dtype is None else out_dtype
    segs = grec["segs"]
    x_q, s_x, s1, s2 = pdq_prologue(x)
    _, _, s_out, z_out = pdq_interval(grec, s1, s2)          # (..., n_seg)
    bounds = list(zip(segs.offsets, segs.sizes))
    if out == "int8":
        z_out = z_out.to(torch.int32)
        y_q = w8a8_matmul(x_q, grec["q"], s_x, 0, grec["scale"],
                          _blockwise(s_out, segs), _blockwise(z_out, segs),
                          colsum=grec["colsum"])
        return tuple(y_q[..., o:o + n] for o, n in bounds), s_out, z_out
    lo_g, hi_g = _grid_extent(s_out, z_out)
    y = w8a8_matmul(x_q, grec["q"], s_x, 0, grec["scale"], colsum=grec["colsum"],
                    fp_range=(_blockwise(lo_g, segs), _blockwise(hi_g, segs)),
                    out_dtype=out_dtype)
    return tuple(y[..., o:o + n] for o, n in bounds)


def pdq_mlp(x, grec, down_rec, *, out_dtype=None):
    """Quantized SwiGLU MLP in three launches: the prologue of x, the fused
    gate/up matmul whose epilogue also computes silu(g) * u and w_down's
    prologue (kernel K3), and the w_down matmul.

    ``grec`` must be the two equal, 128-column padded segments
    ``group_quantize_weights((w_gate, w_up))`` makes.  The reference's
    unfused composition (``pdq_dense_grouped`` + silu + ``pdq_dense``)
    agrees to float tolerance; the tests hold the two together.
    """
    out_dtype = torch.float32 if out_dtype is None else out_dtype
    segs = grec["segs"]
    if not (len(segs.sizes) == 2 and segs.padded[0] == segs.padded[1]
            and segs.padded[0] % LANE == 0):
        raise ValueError(f"pdq_mlp needs two equal 128-padded segments, got "
                         f"{segs.padded}")
    lead, K = x.shape[:-1], x.shape[-1]
    M, Nt = _rows(x), segs.total
    x_q, s_x, s1, s2 = pdq_prologue(x)
    _, _, s_out, z_out = pdq_interval(grec, s1, s2)           # (..., 2)
    lo_g, hi_g = _grid_extent(s_out, z_out)
    nb = Nt // LANE
    COUNTS["w8a8_swiglu_matmul"].entries += 1
    _hsw, hsw_q, sxo, s1o, s2o = _mm.w8a8_swiglu_matmul(
        x_q.reshape(M, K), grec["q"], s_x.reshape(M, 1), None,
        grec["scale"].reshape(1, Nt), None,
        _blockwise(lo_g, segs).reshape(M, nb), _blockwise(hi_g, segs).reshape(M, nb))
    dff = down_rec["q"].shape[0]
    hq = hsw_q[:, :dff].reshape(*lead, dff)
    _, _, so2, zo2 = pdq_interval(down_rec, s1o.reshape(*lead, 1),
                                  s2o.reshape(*lead, 1))
    lo2, hi2 = _grid_extent(so2, zo2)
    return w8a8_matmul(hq, down_rec["q"], sxo.reshape(*lead, 1), 0,
                       down_rec["scale"], colsum=down_rec["colsum"],
                       fp_range=(lo2, hi2), out_dtype=out_dtype)


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
    dtype and trailing shape.

    ``batch_axis=1`` handles stacked per-block leaves (n, B, ...): the stack
    folds into the row axis and src_map is expanded per stack entry, so
    the kernel sees one flat (rows, R) problem.  A numpy ``src_map`` (the
    scheduler's plans) is range-checked on the host.
    """
    if not dst.is_contiguous():
        raise ValueError("cache_scatter_rows writes dst in place: it must be "
                         "contiguous")
    Bs = src.shape[batch_axis]
    if not torch.is_tensor(src_map):
        m = np.asarray(src_map, np.int32)
        if m.size and (m.min() < -1 or m.max() >= Bs):
            raise ValueError(f"src_map values must lie in [-1, {Bs})")
        src_map = torch.as_tensor(m, device=dst.device)
    if batch_axis == 1:
        n, B = dst.shape[0], dst.shape[1]
        stack = torch.arange(n, dtype=torch.int32, device=dst.device)[:, None]
        m = torch.where(src_map[None, :] >= 0, src_map[None, :] + Bs * stack,
                        -1).reshape(n * B).to(torch.int32)
        cache_scatter_rows(dst.view((n * B,) + dst.shape[2:]),
                           src.reshape((n * Bs,) + src.shape[2:]), m)
        return dst
    if batch_axis != 0:
        raise ValueError(f"batch_axis must be 0 or 1, got {batch_axis}")
    COUNTS["cache_scatter"].entries += 1
    _kv.cache_scatter(dst, src, src_map.to(torch.int32))
    return dst
