"""Decoder-only LM assembly (port of ``repro/models/transformer.py``).

The reference scans stacked block params with ``lax.scan``; the port keeps
one param dict per layer in ``params["blocks"]`` and loops over them.
Caches keep the reference's stacked layout - ``caches["blocks"][0]`` holds
(n_blocks, B, ...) tensors - and each layer works on its own slice in
place.  Only the ``("global",)`` pattern runs in this slice.
"""
from __future__ import annotations

import torch

from .attention import AttnDims, gqa_apply, gqa_init, init_cache
from .config import ArchConfig
from .layers import embed_apply, embed_init, mlp_apply, mlp_init, rms_norm, softcap


def _check_supported(cfg: ArchConfig) -> None:
    if (cfg.family != "lm" or cfg.pattern != ("global",) or cfg.head
            or cfg.tail or cfg.embed_scale):
        raise NotImplementedError(
            f"{cfg.name}: the port runs the dense GQA decoder only; other "
            f"families are ROADMAP.md Queue 1, item 6")


def attn_dims(cfg: ArchConfig) -> AttnDims:
    return AttnDims(d_model=cfg.d_model, n_heads=cfg.n_heads,
                    n_kv_heads=cfg.n_kv_heads, head_dim=cfg.hd,
                    rope_theta=cfg.rope_theta, attn_softcap=cfg.attn_softcap,
                    quant_kv=cfg.quant_kv)


def model_dtype(cfg: ArchConfig):
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def layer_init(cfg: ArchConfig, dtype, gen: torch.Generator) -> dict:
    zeros = dict(dtype=dtype, device=gen.device)
    return {"attn_norm": torch.zeros((cfg.d_model,), **zeros),
            "attn": gqa_init(attn_dims(cfg), dtype, gen),
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
            "blocks": [layer_init(cfg, dtype, gen) for _ in range(cfg.n_blocks)]}


def lm_init_caches(cfg: ArchConfig, batch: int, max_len: int, device) -> dict:
    """{'head': (), 'tail': (), 'blocks': (stacked layer cache,)} with
    leaves (n_blocks, batch, ...), the reference's layout."""
    c = init_cache(attn_dims(cfg), batch, max_len, model_dtype(cfg), device)
    stacked = {k: v.expand(cfg.n_blocks, *v.shape).contiguous()
               for k, v in c.items()}
    return {"head": (), "tail": (), "blocks": (stacked,)}


def lm_apply(params, cfg: ArchConfig, *, tokens, positions, mode: str,
             caches, seq_lens=None):
    """Returns (h_final, caches); ``caches`` are updated in place.
    ``seq_lens`` (B,) marks the valid prefix of right-padded prefill rows."""
    dims = attn_dims(cfg)
    eps = cfg.norm_eps
    h = embed_apply(params["embed"], tokens).to(model_dtype(cfg))
    stacked = caches["blocks"][0]
    for i, p in enumerate(params["blocks"]):
        cache = {k: v[i] for k, v in stacked.items()}
        # each block's norm runs inside the prologue that reads its output
        # (one K1 launch) wherever that input feeds one PDQ group
        a, _ = gqa_apply(p["attn"], dims, h, positions, mode=mode, cache=cache,
                         seq_lens=seq_lens, norm=(p["attn_norm"], eps))
        h = h + a
        h = h + mlp_apply(p["ffn"], h, norm=(p["ffn_norm"], eps))
    return rms_norm(h, params["final_norm"], eps), caches


def lm_logits(params, cfg: ArchConfig, h):
    logits = h @ params["embed"]["embedding"].T.to(h.dtype)
    return softcap(logits.float(), cfg.logit_softcap)
