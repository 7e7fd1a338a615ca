"""Analytic MODEL_FLOPS per (arch x shape): the MFU denominator (port of
``repro/launch/model_flops.py``).

MODEL_FLOPS = useful flops only: 6*N_active*T for training (2*N fwd + 4*N
bwd), 2*N_active*T for prefill, 2*N_active*B for decode, plus causal
attention-score flops (the 6N rule excludes them):

  attn_train  = 12 * L_attn * B * S^2 * H * Dh * 0.5      (fwd+bwd, causal)
  attn_prefill=  4 * L_attn * B * S^2 * H * Dh * 0.5
  attn_decode =  4 * L_attn * B * S_ctx * H * Dh

Sliding-window layers use S_ctx = min(S, window).  N counts come from the
param tree built on the ``meta`` device (``MetaGenerator``: shapes only, no
allocation - the reference's ``jax.eval_shape``); MoE expert leaves
(``we_gate`` / ``we_up`` / ``we_down``, under each layer's path here) are
down-weighted by top_k/E (plus shared/dense applied to all tokens).
"""
from __future__ import annotations

import numpy as np

from repro_torch import tree as tr
from repro_torch.models.api import SHAPES, ShapeSpec
from repro_torch.models.layers import MetaGenerator
from repro_torch.models.transformer import lm_init


def param_counts(cfg) -> dict[str, float]:
    params = lm_init(MetaGenerator(), cfg.validate())
    total = expert = embed = 0
    for p, leaf in tr.leaves_with_path(params):
        n = int(np.prod(leaf.shape))
        name = tr.path_str(p)
        total += n
        if "/we_" in name or name.endswith(("we_gate", "we_up", "we_down")):
            expert += n
        if "embedding" in name:
            embed += n
    n_active = total - expert
    if cfg.moe is not None and expert:
        n_active += expert * cfg.moe.top_k / cfg.moe.n_experts
    return {"params_total": float(total), "params_expert": float(expert),
            "active": float(n_active), "params_embed": float(embed)}


def _attn_layers(cfg) -> list[int]:
    """Effective attention context bound per layer kind instance."""
    kinds = list(cfg.head) + list(cfg.pattern) * cfg.n_blocks + list(cfg.tail)
    out = []
    for k in kinds:
        if k == "mamba":
            continue
        if k == "local":
            out.append(cfg.window or 1 << 30)
        else:
            out.append(1 << 30)
    return out


def model_flops(cfg, shape: str | ShapeSpec) -> dict[str, float]:
    """MODEL_FLOPS at a ``SHAPES`` entry, named, or at any ``ShapeSpec``."""
    sp = SHAPES[shape] if isinstance(shape, str) else shape
    counts = param_counts(cfg)
    N = counts["active"]
    B, S = sp.batch, sp.seq
    H, Dh = cfg.n_heads, cfg.hd
    if cfg.mla is not None:
        Dh = cfg.mla.qk_nope + cfg.mla.qk_rope

    windows = _attn_layers(cfg)
    if sp.kind == "train":
        T = B * S
        dense = 6.0 * N * T
        attn = sum(12.0 * B * min(S, w) * S * H * Dh * 0.5 for w in windows)
    elif sp.kind == "prefill":
        T = B * S
        dense = 2.0 * N * T
        attn = sum(4.0 * B * min(S, w) * S * H * Dh * 0.5 for w in windows)
    else:  # decode: one token, context S
        T = B
        dense = 2.0 * N * B
        attn = sum(4.0 * B * min(S, w) * H * Dh for w in windows)
    return {**counts, "dense": dense, "attn": attn, "total": dense + attn}
