"""Decoder-only LM assembly (port of ``repro/models/transformer.py``).

Layer layout: ``head`` layers (unrolled in the reference too), ``n_blocks``
repeats of ``pattern`` (the reference scans their stacked params with
``lax.scan``), ``tail`` layers.  The port keeps one param dict per layer:
``params["head"]`` and ``params["tail"]`` lists, and ``params["blocks"]``,
a single list in LAYER order (block i's kind j is layer ``i * len(pattern)
+ j``); it loops over them.  Caches keep the reference's layout:
``caches["head"]`` / ``["tail"]`` hold one cache per layer, and
``caches["blocks"]`` is a tuple with one cache per pattern kind, each
holding (n_blocks, B, ...) tensors; each layer works on its own slice in
place.  A ``local`` kind attends over a sliding window and its cache is a
ring of ``min(max_len, window)`` positions.

With ``cfg.mla`` a ``global`` / ``global_dense`` layer attends with MLA
(``attention.mla_apply``); with ``cfg.moe`` a ``global`` or ``local``
layer's FFN is the mixture of experts (``moe.py``: capacity-bucketed at
prefill, dense-masked at decode) plus DeepSeek's shared experts or
Arctic's dense residual MLP, and a ``global_dense`` layer's is a dense MLP
of ``moe.d_ff_dense``.  The MoE FFN's router, experts and shared / dense
MLP read one rms_norm(h), run in plain torch (the MLP's prologue then takes
the interval alone); a dense FFN's norm runs inside its prologue.

A ``mamba`` layer is h + the SSD block of rms_norm(h) (``ssm.py``; the norm
runs inside ``in_proj``'s prologue), its cache the conv window and the
state.  A ``shared`` entry of the pattern (zamba2) runs
``params["shared_block"]``, ONE ``global`` layer's params, over its own
occurrence's ``global`` cache; ``params["blocks"]`` keeps an empty dict at
each ``shared`` position, as the reference's stacked ``{}`` does.
"""
from __future__ import annotations

import torch

from .attention import (AttnDims, MLADims, gqa_apply, gqa_init, init_cache, mla_apply,
                        mla_init, mla_init_cache)
from .config import ArchConfig
from .layers import embed_apply, embed_init, mlp_apply, mlp_init, rms_norm, softcap
from .moe import moe_ffn_dense_masked, moe_ffn_tokens, moe_init
from .ssm import ssm_apply, ssm_init, ssm_init_cache

KINDS = ("global", "global_dense", "local", "mamba", "shared")


def _check_supported(cfg: ArchConfig) -> None:
    kinds = set(cfg.head) | set(cfg.pattern) | set(cfg.tail)
    if cfg.family != "lm" or cfg.frontend is not None or not kinds <= set(KINDS):
        raise NotImplementedError(
            f"{cfg.name}: the port runs decoders of global, global_dense, local, "
            f"mamba and shared layers (GQA or MLA, dense or MoE FFN, Mamba2 SSD); "
            f"encoder-decoder and frontend configs are ROADMAP.md Queue 1, item 6")


def attn_dims(cfg: ArchConfig, kind: str = "global") -> AttnDims:
    """The reference's ``_attn_dims``: only a ``local`` kind has a window."""
    return AttnDims(d_model=cfg.d_model, n_heads=cfg.n_heads,
                    n_kv_heads=cfg.n_kv_heads, head_dim=cfg.hd,
                    rope_theta=cfg.rope_theta, attn_softcap=cfg.attn_softcap,
                    window=cfg.window if kind == "local" else None,
                    quant_kv=cfg.quant_kv)


def mla_dims(cfg: ArchConfig) -> MLADims:
    m = cfg.mla
    return MLADims(d_model=cfg.d_model, n_heads=cfg.n_heads, q_lora=m.q_lora,
                   kv_lora=m.kv_lora, qk_nope=m.qk_nope, qk_rope=m.qk_rope,
                   v_head=m.v_head, rope_theta=cfg.rope_theta)


def _is_mla(cfg: ArchConfig, kind: str) -> bool:
    return cfg.mla is not None and kind in ("global", "global_dense")


def _is_moe(cfg: ArchConfig, kind: str) -> bool:
    return cfg.moe is not None and kind != "global_dense"


def model_dtype(cfg: ArchConfig):
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def layer_init(cfg: ArchConfig, kind: str, dtype, gen: torch.Generator) -> dict:
    zeros = dict(dtype=dtype, device=gen.device)
    if kind == "mamba":
        return {"norm": torch.zeros((cfg.d_model,), **zeros),
                "ssm": ssm_init(cfg.ssm, dtype, gen)}
    attn = (mla_init(mla_dims(cfg), dtype, gen) if _is_mla(cfg, kind)
            else gqa_init(attn_dims(cfg, kind), dtype, gen))
    if _is_moe(cfg, kind):
        ffn = moe_init(cfg.d_model, cfg.moe, dtype, gen)
    else:
        d_ff = cfg.moe.d_ff_dense if cfg.moe and kind == "global_dense" else cfg.d_ff
        ffn = mlp_init(cfg.d_model, d_ff or cfg.d_ff, dtype, gen)
    return {"attn_norm": torch.zeros((cfg.d_model,), **zeros), "attn": attn,
            "ffn_norm": torch.zeros((cfg.d_model,), **zeros), "ffn": ffn}


def lm_init(gen: torch.Generator, cfg: ArchConfig) -> dict:
    """Random weights on ``gen``'s device, from the reference's
    distributions: U(+-sqrt(3/d_in)) projections, N(0, 0.02) embedding,
    zero norms.  The numbers differ from JAX's draws."""
    _check_supported(cfg)
    dtype = model_dtype(cfg)
    params = {"embed": embed_init(cfg.vocab, cfg.d_model, dtype, gen),
              "final_norm": torch.zeros((cfg.d_model,), dtype=dtype, device=gen.device),
              "head": [layer_init(cfg, kind, dtype, gen) for kind in cfg.head],
              "tail": [layer_init(cfg, kind, dtype, gen) for kind in cfg.tail],
              "blocks": [layer_init(cfg, kind, dtype, gen) if kind != "shared" else {}
                         for _ in range(cfg.n_blocks) for kind in cfg.pattern]}
    if "shared" in cfg.head + cfg.pattern + cfg.tail:
        params["shared_block"] = layer_init(cfg, "global", dtype, gen)
    return params


def layer_cache(cfg: ArchConfig, kind: str, batch: int, max_len: int, device) -> dict:
    """A layer's cache; a ``shared`` occurrence's is a ``global`` layer's."""
    if kind == "mamba":
        return ssm_init_cache(cfg.ssm, batch, model_dtype(cfg), device)
    if kind == "shared":
        kind = "global"
    if _is_mla(cfg, kind):
        return mla_init_cache(mla_dims(cfg), batch, max_len, model_dtype(cfg), device)
    return init_cache(attn_dims(cfg, kind), batch, max_len, model_dtype(cfg), device)


def lm_init_caches(cfg: ArchConfig, batch: int, max_len: int, device) -> dict:
    """{'head': (one cache per head layer,), 'tail': (...), 'blocks': (one
    stacked cache per pattern kind,)}, block leaves (n_blocks, batch, ...):
    the reference's layout."""
    def stacked(kind):
        c = layer_cache(cfg, kind, batch, max_len, device)
        return {k: v.expand(cfg.n_blocks, *v.shape).contiguous() for k, v in c.items()}
    return {"head": tuple(layer_cache(cfg, k, batch, max_len, device) for k in cfg.head),
            "tail": tuple(layer_cache(cfg, k, batch, max_len, device) for k in cfg.tail),
            "blocks": tuple(stacked(k) for k in cfg.pattern)}


def _apply_ffn(p_ffn, cfg: ArchConfig, kind: str, h, mode: str, norm, seq_lens=None):
    """The FFN of rms_norm(h, *norm).  ``seq_lens`` (B,) marks the valid
    prefix of right-padded prefill rows: pad tokens are masked out of MoE
    routing, so they claim no expert capacity."""
    if not _is_moe(cfg, kind):
        return mlp_apply(p_ffn, h, norm=norm)
    xn = rms_norm(h, *norm)
    B, S, d = xn.shape
    mask = None
    if seq_lens is not None:
        mask = (torch.arange(S, device=h.device)[None] < seq_lens[:, None]).reshape(B * S)
    fn = moe_ffn_tokens if mode == "prefill" else moe_ffn_dense_masked
    y, _ = fn(p_ffn, xn.reshape(B * S, d), cfg.moe, token_mask=mask)
    y = y.reshape(B, S, d)
    if cfg.moe.n_shared:
        y = y + mlp_apply(p_ffn["shared"], xn)
    if cfg.moe.dense_residual:
        y = y + mlp_apply(p_ffn["dense"], xn)
    return y


def layer_apply(p, cfg: ArchConfig, kind: str, h, positions, *, mode: str, cache,
                seq_lens=None, chunked: bool = False):
    """One layer on h (B, S, d), its cache updated in place."""
    eps = cfg.norm_eps
    if kind == "mamba":
        return h + ssm_apply(p["ssm"], cfg.ssm, h, mode=mode, cache=cache,
                             seq_lens=seq_lens, norm=(p["norm"], eps))
    # each norm runs inside the prologue that reads its output (one K1
    # launch) wherever that input feeds one PDQ group
    if _is_mla(cfg, kind):
        a, _ = mla_apply(p["attn"], mla_dims(cfg), h, positions, mode=mode, cache=cache,
                         seq_lens=seq_lens, norm=(p["attn_norm"], eps), chunked=chunked)
    else:
        a, _ = gqa_apply(p["attn"], attn_dims(cfg, kind), h, positions, mode=mode,
                         cache=cache, seq_lens=seq_lens, norm=(p["attn_norm"], eps),
                         chunked=chunked)
    h = h + a
    return h + _apply_ffn(p["ffn"], cfg, kind, h, mode, (p["ffn_norm"], eps),
                          seq_lens if mode == "prefill" else None)


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
    h = embed_tokens(params, cfg, tokens)
    kw = dict(mode=mode, seq_lens=seq_lens, chunked=chunked)
    for i, kind in enumerate(cfg.head):
        h = layer_apply(params["head"][i], cfg, kind, h, positions,
                        cache=caches["head"][i], **kw)
    P = len(cfg.pattern)
    for i in range(cfg.n_blocks):
        for j, kind in enumerate(cfg.pattern):
            cache = {k: v[i] for k, v in caches["blocks"][j].items()}
            if kind == "shared":
                p, kind = params["shared_block"], "global"
            else:
                p = params["blocks"][i * P + j]
            h = layer_apply(p, cfg, kind, h, positions, cache=cache, **kw)
    for i, kind in enumerate(cfg.tail):
        h = layer_apply(params["tail"][i], cfg, kind, h, positions,
                        cache=caches["tail"][i], **kw)
    return rms_norm(h, params["final_norm"], cfg.norm_eps), caches


def lm_logits(params, cfg: ArchConfig, h):
    logits = h @ params["embed"]["embedding"].T.to(h.dtype)
    return softcap(logits.float(), cfg.logit_softcap)
