"""Plain PyTorch versions of the hand-written kernels (port of
``repro/kernels/ref.py``).

They are the semantics contract: a kernel wrapper takes them for tensors on
the CPU, the CPU tests hold them against the JAX oracles, and
``chip_smoke.py`` holds every CUDA kernel against them on the card.  They
run on any device.

Rounding is half to even everywhere (``torch.round``), as ``jnp.round``.
"""
from __future__ import annotations

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
