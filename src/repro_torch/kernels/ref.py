"""Plain PyTorch versions of the hand-written kernels (port of
``repro/kernels/ref.py``).

They are the semantics contract: a kernel wrapper takes them for tensors on
the CPU, the CPU tests hold them against the JAX oracles, and
``chip_smoke.py`` holds every CUDA kernel against them on the card.  They
run on any device.

Rounding is half to even everywhere (``torch.round``), as ``jnp.round``.
"""
from __future__ import annotations

import functools

import numpy as np
import torch


def true_div(a, b: float):
    """a / b by IEEE division on every device.  PyTorch's CUDA division by
    a Python number multiplies by its reciprocal instead, which can move
    the result by an ulp (and an int8 code at a .5 tie); a 0-dim device
    tensor divisor takes the true division, as JAX and the kernels do.
    ``torch.full`` fills it on the device, with no host-to-device copy."""
    return a / torch.full((), b, dtype=a.dtype, device=a.device)


def w8a8_matmul_ref(x_q, w_q, s_x, z_x, s_w, s_out=None, z_out=None):
    """int8 x int8 -> int32 matmul with dequant (or requant) epilogue.

    x_q (M, K) int8; w_q (K, N) int8; s_x/z_x () or (M, 1); s_w () or
    (1, N); s_out/z_out () or broadcastable to (M, N).

    y_fp = s_x * s_w * (x_q @ w_q - z_x * colsum(w_q)); with (s_out, z_out)
    y_q = clamp(round(y_fp / s_out) + z_out, -128, 127) as int8.

    The product runs in float64, which is exact here: |acc| <= 127^2 * K
    stays far below 2^53 (CUDA has no int32 matmul).
    """
    acc = torch.matmul(x_q.double(), w_q.double()).long()
    colsum = w_q.long().sum(0, keepdim=True)
    acc = acc - torch.as_tensor(z_x, device=acc.device).long() * colsum
    scale = (torch.as_tensor(s_x, dtype=torch.float32, device=acc.device)
             * torch.as_tensor(s_w, dtype=torch.float32, device=acc.device))
    y = acc.float() * scale
    if s_out is None:
        return y
    q = torch.round(y / s_out) + torch.as_tensor(z_out, device=y.device).float()
    return q.clamp(-128, 127).to(torch.int8)


def pdq_prologue_ref(x):
    """Fused PDQ prologue: x (M, K) float -> (x_q (M, K) int8, s_x, s1, s2
    each (M, 1) f32) with s_x = max(amax, 1e-8)/127, x_q = clip(round(x /
    s_x), +-127), s1 = sum x, s2 = sum x^2.  Divides by s_x, as the
    reference oracle does."""
    x32 = x.float()
    amax = x32.abs().amax(-1, keepdim=True).clamp_min(1e-8)
    s_x = true_div(amax, 127.0)
    x_q = torch.round(x32 / s_x).clamp(-127, 127).to(torch.int8)
    s1 = x32.sum(-1, keepdim=True)
    s2 = (x32 * x32).sum(-1, keepdim=True)
    return x_q, s_x, s1, s2


def mean_square(x):
    """Each row's mean of squares in f32, (..., 1): the reduction inside
    ``rms_norm``, which K1's norm takes from here so that its bits are the
    plain version's on any device."""
    x = x.float()
    return torch.mean(x * x, dim=-1, keepdim=True)


def rms_norm(x, weight, eps: float = 1e-6):
    """RMSNorm in f32, rounded back to x's dtype: x * rsqrt(mean(x^2) + eps)
    * (1 + weight) (the reference's ``models/layers.py``)."""
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(mean_square(x) + eps)
    return (x * (1.0 + weight.float())).to(dt)


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


def grid_extent(s_out, z_out):
    """The representable extent [(-128 - z) s, (127 - z) s] of the int8
    grid: fp-out clamps to it (not the raw interval) so that it matches
    requant -> dequant at the clip boundaries."""
    return (-128.0 - z_out) * s_out, (127.0 - z_out) * s_out


@functools.lru_cache(maxsize=None)
def _block_index(blocks: tuple, device: torch.device):
    """Segment index of every 128-column block: segment i spans blocks[i]
    blocks.  Built once per layout and device and never dropped: a captured
    decode graph reads it."""
    idx = np.repeat(np.arange(len(blocks)), blocks)
    return torch.as_tensor(idx, device=device)


def blockwise(a, blocks: tuple):
    """Per-segment (..., n_seg) -> per-128-column-block (..., sum(blocks))."""
    # a dry run's fake card (a meta device) keeps no index between traces
    index = _block_index.__wrapped__ if a.device.type == "meta" else _block_index
    return a.index_select(-1, index(tuple(blocks), a.device))


def pdq_prologue_fused_ref(x, norm=None, interval=None, return_normed=False):
    """K1 in every mode, as the composition it replaces: ``rms_norm(x, w,
    eps)`` first when ``norm = (w, eps)``; the prologue of that row; with
    ``interval = (wrec, blocks)`` also the interval's grid extent (lo_g,
    hi_g) priced from the row's own s1/s2, one column per segment, or per
    128-column block when ``blocks`` (each segment's block count) is given.
    Returns (x_q, s_x, s1, s2[, lo_g, hi_g][, the normed row])."""
    if norm is not None:
        x = rms_norm(x, *norm)
    out = pdq_prologue_ref(x)
    if interval is not None:
        wrec, blocks = interval
        lo_g, hi_g = grid_extent(*pdq_interval(wrec, out[2], out[3])[2:])
        if blocks is not None:
            lo_g, hi_g = blockwise(lo_g, blocks), blockwise(hi_g, blocks)
        out += (lo_g, hi_g)
    if return_normed:
        out += (x,)
    return out


# ---------------------------------------------------------------------------
# PDQ health: the plain versions of what the W8A8 kernels count, and of the
# guarded projection's fp-dequant fallback (kernels/fp_dequant.py).  The
# counters are one int64 (3,) tensor [fallbacks, clip_hits, clip_total],
# updated in place with tensor ops (no host read on any device).
# ---------------------------------------------------------------------------


def tel_clip(y, lo, hi, tel):
    """Add the clip hits of a clamped output ``y`` (elements on or past
    either edge of [lo, hi], compared in f32; a NaN is no hit) and its size
    to ``tel``: the reference's ``ops._tel_clip``."""
    y = y.float()
    hits = ((y <= lo) | (y >= hi)).sum()
    tel[1:].add_(torch.stack((hits, torch.full_like(hits, y.numel()))))


def tel_clip_q(y_q, tel):
    """``tel_clip`` of int8 codes: saturation is the grid's edge codes
    -128 and 127 (the reference's ``ops._tel_clip_q``)."""
    tel_clip(y_q, -128.0, 127.0, tel)


def flag_non_finite(y, flag):
    """Set ``flag`` (int32 (1,) or more) to 1 where ``y`` holds a NaN or an
    infinity: the guard's finite check, which the kernels run in their
    epilogue."""
    flag[:1].bitwise_or_((~torch.isfinite(y).all()).to(flag.dtype))


def fp_dequant_matmul(x, w_q, scale, out_dtype):
    """The always-available fallback precision: the int8 weight
    dequantized in f32 and the projection in f32, ``(x @ (q * scale))``
    cast to ``out_dtype`` (the reference's ``ops._fp_dequant_matmul``)."""
    w = w_q.float() * scale.float().reshape(1, -1)
    return (x.float() @ w).to(out_dtype)


def fp_dequant_fallback_ref(y, x, w_q, scale, flag, tel=None):
    """Plain version of the predicated fallback kernel: when ``flag[0]`` is
    set, overwrite ``y`` (M, N) with ``fp_dequant_matmul`` of x (M, K) and
    add 1 to ``tel[0]``; either way put the flag back to 0.  Reads the flag
    on the host, so it is for CPU tensors and for checks."""
    if int(flag[0]):
        y.copy_(fp_dequant_matmul(x, w_q, scale, y.dtype))
        if tel is not None:
            tel[0] += 1
    flag[0] = 0
    return y


def act_stats_ref(x):
    """Row moments: s1 = sum x, s2 = sum x^2 over the last axis, in f32;
    x (..., K) -> two (...) tensors."""
    x32 = x.float()
    return x32.sum(-1), (x32 * x32).sum(-1)


def quantize_ref(x, scale, zero_point):
    """Affine int8 quantize: clamp(round(x / scale) + z, -128, 127), with
    true division by the scale tensor and rounding half to even."""
    q = torch.round(x.float() / scale) + torch.as_tensor(zero_point, device=x.device).float()
    return q.clamp(-128, 127).to(torch.int8)


def dequantize_ref(q, scale, zero_point, dtype=torch.float32):
    """(q - z) * scale computed in ``dtype``, as the reference's oracle:
    q - z and the scale each round to ``dtype`` first, then one product
    (for bf16 an f32 product of two bf16 values, exact, rounded once)."""
    z = torch.as_tensor(zero_point, device=q.device)
    return (q.to(torch.int32) - z).to(dtype) * torch.as_tensor(scale, device=q.device).to(dtype)


def silu_mul(g, u):
    """silu(g) * u written as g / (1 + exp(-g)) * u: the exact float
    sequence the SwiGLU kernel's epilogue evaluates."""
    return g / (1.0 + torch.exp(-g)) * u


def w8a8_swiglu_ref(x_q, w_q, s_x, z_x, s_w, lo, hi):
    """The fused SwiGLU matmul: the fp-clamp W8A8 product over [gate | up]
    (P = N/2 columns each) with per-(row, 128-column block) bounds lo/hi
    (M, N/128), then hsw = silu(gate) * up and hsw's PDQ prologue.

    Returns (y (M, N) f32, hsw (M, P) f32, hsw_q (M, P) int8, s_x, s1, s2
    each (M, 1) f32)."""
    lo_c = torch.repeat_interleave(lo, 128, dim=-1)
    hi_c = torch.repeat_interleave(hi, 128, dim=-1)
    y = w8a8_matmul_ref(x_q, w_q, s_x, z_x, s_w)
    y = torch.minimum(torch.maximum(y, lo_c), hi_c)
    P = y.shape[-1] // 2
    hsw = silu_mul(y[:, :P], y[:, P:])
    return (y, hsw, *pdq_prologue_ref(hsw))


def decode_attend_i8kv_ref(q, k_q, v_q, k_scale, v_scale, length):
    """One-token attention over an int8 KV cache in kernel layout.

    q (B, H, Dh) f32; k_q/v_q (B, Hkv, Sp, Dh) int8; k_scale/v_scale (B,
    Hkv, Sp) f32 per (head, position); length (B,) int32, the valid prefix
    of each row.  Returns o (B, H, Dh) f32, query head h reading kv head
    h // (H / Hkv).  Positions past the length are masked with -inf before
    the softmax, so a row of length 0 gives NaN, as the reference does.
    """
    B, H, Dh = q.shape
    Hkv, Sp = k_q.shape[1], k_q.shape[2]
    k = k_q.float() * k_scale[..., None]
    v = v_q.float() * v_scale[..., None]
    qg = q.float().reshape(B, Hkv, H // Hkv, Dh)
    logits = true_div(torch.einsum("bhgd,bhsd->bhgs", qg, k), Dh ** 0.5)
    mask = torch.arange(Sp, device=q.device)[None, :] < length[:, None].long()
    logits = torch.where(mask[:, None, None, :], logits, float("-inf"))
    p = torch.softmax(logits, dim=-1)
    return torch.einsum("bhgs,bhsd->bhgd", p, v).reshape(B, H, Dh)


def decode_attend_i8kv_fused_ref(q, k_q, v_q, k_scale, v_scale, length,
                                 pro_dtype=None):
    """``decode_attend_i8kv_ref`` plus wo's PDQ prologue over each row's
    flattened (H * Dh) output, after rounding it to ``pro_dtype`` (default
    float32).  Returns (o (B, H, Dh) f32, o_q (B, H * Dh) int8, s_x, s1, s2
    each (B, 1) f32)."""
    o = decode_attend_i8kv_ref(q, k_q, v_q, k_scale, v_scale, length)
    of = o if pro_dtype is None else o.to(pro_dtype)
    return (o, *pdq_prologue_ref(of.reshape(o.shape[0], -1)))


def cache_scatter_ref(dst, src, src_map):
    """dst[b] = src[src_map[b]] where src_map[b] >= 0; other rows of dst
    keep their bits.  Updates ``dst`` in place and returns it."""
    rows = torch.nonzero(src_map >= 0).flatten()
    dst[rows] = src[src_map[rows].long()]
    return dst


def to_page_rows(x, seq_axis: int, page: int, *, batch_axis: int = 0):
    """A cache leaf as PAGE ROWS: the seq axis (S, a multiple of ``page``)
    splits into (S // page, page) and the page index merges into the batch
    axis, giving (..., B * S // page, *page_block), each page block laid
    out like a physical pool page.  A copy unless the leaf is already
    paged (movedim + reshape of a non-contiguous tensor)."""
    S = x.shape[seq_axis]
    if S % page:
        raise ValueError(f"page {page} does not divide the seq extent {S}")
    n_pp = S // page
    x = x.reshape(x.shape[:seq_axis] + (n_pp, page) + x.shape[seq_axis + 1:])
    lead = batch_axis + 1
    x = torch.movedim(x, seq_axis, lead)         # page index next to batch
    B = x.shape[batch_axis]
    return x.reshape(x.shape[:batch_axis] + (B * n_pp,) + x.shape[lead + 1:])


def from_page_rows(x, shape, seq_axis: int, page: int, *, batch_axis: int = 0):
    """Inverse of ``to_page_rows``: page rows back to the leaf ``shape``."""
    n_pp = shape[seq_axis] // page
    B = shape[batch_axis]
    lead = batch_axis + 1
    x = x.reshape(x.shape[:batch_axis] + (B, n_pp) + x.shape[lead:])
    return torch.movedim(x, lead, seq_axis).reshape(shape)


def _page_rows(x, seq_axis, page, batch_axis):
    """One side of a paged scatter as page rows, and those as a 2-D
    (stack * rows, R) tensor; a side with ``seq_axis`` None is page rows
    already."""
    if seq_axis is not None:
        x = to_page_rows(x, seq_axis, page, batch_axis=batch_axis)
    return x, x.reshape(-1, x[(0,) * (batch_axis + 1)].numel())


def cache_scatter_pages_ref(dst, src, page_map, seq_axis=None, page=None,
                            batch_axis: int = 0, host_map=None):
    """Row scatter over PAGES, the reference's composition: each side goes
    to page rows (``to_page_rows`` when ``seq_axis`` is given, else it is
    page rows already), dst page row p of stack entry i takes src page row
    ``page_map[p]`` of the same entry (-1 keeps), and the result goes back
    into ``dst`` in place.  ``batch_axis`` 1 stacks (n, B, ...) leaves;
    ``host_map`` is the kernel's aliasing proof and unused here."""
    dp, d = _page_rows(dst, seq_axis, page, batch_axis)
    _, s = _page_rows(src, seq_axis, page, batch_axis)
    n = dst.shape[0] if batch_axis == 1 else 1
    rows_d, rows_s = d.shape[0] // n, s.shape[0] // n
    stack = torch.arange(n, device=page_map.device)[:, None]
    m = torch.where(page_map[None, :] >= 0, page_map[None, :] + rows_s * stack,
                    -1).reshape(n * rows_d)
    cache_scatter_ref(d, s, m)
    if d.untyped_storage().data_ptr() != dst.untyped_storage().data_ptr():
        # dst's page rows were a copy: write the result back into the leaf
        dst.copy_(from_page_rows(d.reshape(dp.shape), tuple(dst.shape),
                                 seq_axis, page, batch_axis=batch_axis))
    return dst
