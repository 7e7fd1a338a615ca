"""Shared building blocks (port of ``repro/models/layers.py``).

Params are nested dicts of tensors whose leaf names match the reference's,
so ``bridge.params_from_numpy`` maps a JAX param tree one to one.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops
from repro_torch.kernels.ref import true_div
from .linops import _common_group, is_quantized, is_segment_view, lin, lin_grouped


def uniform_init(shape, scale, dtype, gen: torch.Generator):
    """U(-scale, scale) drawn in float32, then cast (the reference's init)."""
    u = torch.rand(shape, generator=gen, dtype=torch.float32, device=gen.device)
    return ((2.0 * u - 1.0) * scale).to(dtype)


def dense_init(d_in, d_out, dtype, gen: torch.Generator):
    return uniform_init((d_in, d_out), (3.0 / d_in) ** 0.5, dtype, gen)


def rms_norm(x, weight, eps: float = 1e-6):
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * (1.0 + weight.float())).to(dt)


def softcap(x, cap: float | None):
    if cap is None:
        return x
    return cap * torch.tanh(true_div(x, cap))


def rope_freqs(head_dim: int, theta: float, device=None):
    idx = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device)
    return 1.0 / (theta ** true_div(idx, float(head_dim)))


def apply_rope(x, positions, theta: float):
    """x: (..., seq, heads, head_dim); positions: (..., seq)."""
    dh = x.shape[-1]
    freqs = rope_freqs(dh, theta, x.device)                    # (dh/2,)
    angles = positions[..., None].float() * freqs              # (..., seq, dh/2)
    sin = torch.sin(angles)[..., None, :]                      # (..., seq, 1, dh/2)
    cos = torch.cos(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def mlp_init(d_model, d_ff, dtype, gen):
    return {
        "w_gate": dense_init(d_model, d_ff, dtype, gen),
        "w_up": dense_init(d_model, d_ff, dtype, gen),
        "w_down": dense_init(d_ff, d_model, dtype, gen),
    }


def mlp_apply(p, x):
    # gate/up read the same normed input: quantized params run the fused
    # prologue + SwiGLU matmul + w_down triple (ops.pdq_mlp)
    grec = _common_group((p["w_gate"], p["w_up"]))
    if (grec is not None and is_quantized(p["w_down"])
            and not is_segment_view(p["w_down"])):
        return ops.pdq_mlp(x, grec, p["w_down"], out_dtype=x.dtype)
    g, u = lin_grouped(x, (p["w_gate"], p["w_up"]))
    return lin(torch.nn.functional.silu(g) * u, p["w_down"])


def embed_init(vocab, d_model, dtype, gen):
    e = torch.randn((vocab, d_model), generator=gen, dtype=torch.float32,
                    device=gen.device)
    return {"embedding": (0.02 * e).to(dtype)}


def embed_apply(p, tokens):
    return p["embedding"][tokens]
