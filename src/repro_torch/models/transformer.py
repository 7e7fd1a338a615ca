"""Decoder-only LM assembly (port of ``repro/models/transformer.py``).

The reference scans stacked block params with ``lax.scan``; the port keeps
one param dict per layer in ``params["blocks"]``, a single list in LAYER
order (block i's kind j is layer ``i * len(pattern) + j``), and loops over
it.  Caches keep the reference's stacked layout: ``caches["blocks"]`` is a
tuple with one cache per pattern kind, each holding (n_blocks, B, ...)
tensors, and each layer works on its own slice in place.  A ``local`` kind
attends over a sliding window and its cache is a ring of ``min(max_len,
window)`` positions.
"""
from __future__ import annotations

import torch

from .attention import AttnDims, gqa_apply, gqa_init, init_cache
from .config import ArchConfig
from .layers import embed_apply, embed_init, mlp_apply, mlp_init, rms_norm, softcap

KINDS = ("global", "local")


def _check_supported(cfg: ArchConfig) -> None:
    if (cfg.family != "lm" or cfg.head or cfg.tail
            or not set(cfg.pattern) <= set(KINDS)):
        raise NotImplementedError(
            f"{cfg.name}: the port runs dense GQA decoders of global and local "
            f"layers only (no head/tail layers, MoE, MLA, SSM, encoder-decoder "
            f"or frontend); the other families are ROADMAP.md Queue 1, item 6")


def attn_dims(cfg: ArchConfig, kind: str = "global") -> AttnDims:
    """The reference's ``_attn_dims``: only a ``local`` kind has a window."""
    return AttnDims(d_model=cfg.d_model, n_heads=cfg.n_heads,
                    n_kv_heads=cfg.n_kv_heads, head_dim=cfg.hd,
                    rope_theta=cfg.rope_theta, attn_softcap=cfg.attn_softcap,
                    window=cfg.window if kind == "local" else None,
                    quant_kv=cfg.quant_kv)


def model_dtype(cfg: ArchConfig):
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def layer_init(cfg: ArchConfig, kind: str, dtype, gen: torch.Generator) -> dict:
    zeros = dict(dtype=dtype, device=gen.device)
    return {"attn_norm": torch.zeros((cfg.d_model,), **zeros),
            "attn": gqa_init(attn_dims(cfg, kind), dtype, gen),
            "ffn_norm": torch.zeros((cfg.d_model,), **zeros),
            "ffn": mlp_init(cfg.d_model, cfg.d_ff, dtype, gen)}


def lm_init(gen: torch.Generator, cfg: ArchConfig) -> dict:
    """Random weights on ``gen``'s device, from the reference's
    distributions: U(+-sqrt(3/d_in)) projections, N(0, 0.02) embedding,
    zero norms.  The numbers differ from JAX's draws."""
    _check_supported(cfg)
    dtype = model_dtype(cfg)
    return {"embed": embed_init(cfg.vocab, cfg.d_model, dtype, gen),
            "final_norm": torch.zeros((cfg.d_model,), dtype=dtype, device=gen.device),
            "blocks": [layer_init(cfg, kind, dtype, gen)
                       for _ in range(cfg.n_blocks) for kind in cfg.pattern]}


def lm_init_caches(cfg: ArchConfig, batch: int, max_len: int, device) -> dict:
    """{'head': (), 'tail': (), 'blocks': (one stacked cache per pattern
    kind,)} with leaves (n_blocks, batch, ...), the reference's layout."""
    def stacked(kind):
        c = init_cache(attn_dims(cfg, kind), batch, max_len, model_dtype(cfg), device)
        return {k: v.expand(cfg.n_blocks, *v.shape).contiguous() for k, v in c.items()}
    return {"head": (), "tail": (), "blocks": tuple(stacked(k) for k in cfg.pattern)}


def embed_tokens(params, cfg: ArchConfig, tokens):
    """The embedded rows in the model's dtype, times sqrt(d_model) where
    ``embed_scale``: the reference's ``jnp.asarray(d_model ** 0.5, dtype)``,
    a scalar rounded to the dtype first (sqrt(3840) -> 62.0 in bf16)."""
    dtype = model_dtype(cfg)
    h = embed_apply(params["embed"], tokens).to(dtype)
    if cfg.embed_scale:
        # a 0-dim CPU tensor: the op takes it as a scalar of its (rounded)
        # value, with no host-to-device copy (a captured graph holds none)
        h = h * torch.tensor(cfg.d_model ** 0.5, dtype=dtype)
    return h


def lm_apply(params, cfg: ArchConfig, *, tokens, positions, mode: str,
             caches, seq_lens=None, chunked: bool = False):
    """Returns (h_final, caches); ``caches`` are updated in place.
    ``seq_lens`` (B,) marks the valid prefix of right-padded prefill rows;
    ``chunked`` marks a chunked-prefill continuation (``positions`` are
    absolute and attention also reads the rows the caches already hold)."""
    eps = cfg.norm_eps
    h = embed_tokens(params, cfg, tokens)
    P = len(cfg.pattern)
    dims = [attn_dims(cfg, kind) for kind in cfg.pattern]
    for i in range(cfg.n_blocks):
        for j in range(P):
            p = params["blocks"][i * P + j]
            cache = {k: v[i] for k, v in caches["blocks"][j].items()}
            # each block's norm runs inside the prologue that reads its
            # output (one K1 launch) wherever that input feeds one PDQ group
            a, _ = gqa_apply(p["attn"], dims[j], h, positions, mode=mode, cache=cache,
                             seq_lens=seq_lens, norm=(p["attn_norm"], eps),
                             chunked=chunked)
            h = h + a
            h = h + mlp_apply(p["ffn"], h, norm=(p["ffn_norm"], eps))
    return rms_norm(h, params["final_norm"], eps), caches


def lm_logits(params, cfg: ArchConfig, h):
    logits = h @ params["embed"]["embedding"].T.to(h.dtype)
    return softcap(logits.float(), cfg.logit_softcap)
