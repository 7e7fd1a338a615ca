"""Shared building blocks (port of ``repro/models/layers.py``).

Params are nested dicts of tensors whose leaf names match the reference's,
so ``bridge.params_from_numpy`` maps a JAX param tree one to one.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels import ops
from repro_torch.kernels.ref import rms_norm as rms_norm
from repro_torch.kernels.ref import true_div
from .linops import _common_group, is_quantized, is_segment_view, lin, lin_grouped


class MetaGenerator:
    """Stands in for a ``torch.Generator`` where only a param tree's shapes
    and dtypes are wanted: every init draws on the ``meta`` device and
    allocates nothing (the reference's ``jax.eval_shape`` over its init)."""
    device = torch.device("meta")


def draw_kw(gen) -> dict:
    """The keywords a random init draws with from ``gen``."""
    return {"device": gen.device} | ({} if isinstance(gen, MetaGenerator)
                                     else {"generator": gen})


def uniform_init(shape, scale, dtype, gen: torch.Generator):
    """U(-scale, scale) drawn in float32, then cast (the reference's init)."""
    u = torch.rand(shape, dtype=torch.float32, **draw_kw(gen))
    return ((2.0 * u - 1.0) * scale).to(dtype)


def dense_init(d_in, d_out, dtype, gen: torch.Generator):
    return uniform_init((d_in, d_out), (3.0 / d_in) ** 0.5, dtype, gen)


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


def mlp_apply(p, x, norm=None):
    """The SwiGLU MLP of x, or with ``norm = (w, eps)`` of rms_norm(x, w,
    eps)."""
    # gate/up read the same normed input: quantized params run the fused
    # norm + prologue + interval, SwiGLU matmul and w_down triple (ops.pdq_mlp)
    grec = _common_group((p["w_gate"], p["w_up"]))
    if (grec is not None and is_quantized(p["w_down"])
            and not is_segment_view(p["w_down"])):
        return ops.pdq_mlp(x, grec, p["w_down"], out_dtype=x.dtype, norm=norm)
    g, u = lin_grouped(x, (p["w_gate"], p["w_up"]), norm=norm)
    return lin(torch.nn.functional.silu(g) * u, p["w_down"])


def embed_init(vocab, d_model, dtype, gen):
    e = torch.randn((vocab, d_model), dtype=torch.float32, **draw_kw(gen))
    return {"embedding": (0.02 * e).to(dtype)}


def embed_apply(p, tokens):
    return p["embedding"][tokens]


def _xent_chunk(hc, yc, embedding, logit_softcap):
    """Sum over one chunk of (logsumexp - gold logit), f32."""
    logits = softcap((hc @ embedding.T).float(), logit_softcap)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.take_along_dim(logits, yc[..., None].long(), dim=-1)[..., 0]
    return torch.sum(lse - gold)


def chunked_xent_loss(embedding, h, labels, *, chunk: int = 512,
                      logit_softcap: float | None = None):
    """Mean cross-entropy of h (B, S, d) against labels (B, S) under the
    tied ``embedding`` (V, d), without the (B, S, V) logits: each chunk of
    ``chunk`` positions runs under ``torch.utils.checkpoint``, so its
    logits exist only inside it and are recomputed in the backward (the
    reference's ``jax.checkpoint``-ed scan body).  As in the reference, S is
    cut to ``n_chunks * chunk`` with ``chunk = min(chunk, S)``: positions
    past the last whole chunk are not in the loss, and the sum is divided
    by ``B * n_chunks * chunk``."""
    B, S, _ = h.shape
    chunk = min(chunk, S)
    n_chunks = S // chunk
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for c in range(n_chunks):
        sl = slice(c * chunk, (c + 1) * chunk)
        total = total + checkpoint(_xent_chunk, h[:, sl], labels[:, sl], embedding,
                                   logit_softcap, use_reentrant=False)
    return true_div(total, float(B * n_chunks * chunk))
