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

An encoder-decoder (``family="encdec"``, seamless) also holds
``params["enc_blocks"]``, one ``global`` layer dict per encoder layer, and
``params["enc_norm"]``: a prefill runs the encoder (cache-free,
bidirectional, RoPE on) over the stub frames, and every decoder layer
cross-attends its output after self-attention - at prefill through
``cross_memory``, whose K/V the layer stores as its ``cross_k`` /
``cross_v`` cache leaves, at decode from those leaves.  A vision config
(phi-3-vision) prepends the stub patch embeddings to the embedded text.

Train mode (``mode="train"``, ``caches=None``) runs the same layers
cache-free and writes nothing: MLA expanded as at prefill, the SSD block
from a zero conv tail and state, the MoE FFN through its capacity buckets
(expert-parallel over a train mesh's model group under a ``DistContext``)
with its load-balance losses summed, an encoder-decoder's cross blocks
over the encoder's output; autograd differentiates the plain torch ops,
and ``cfg.remat`` picks what the backward recomputes of each pattern
block: nothing (``none``), all of it (``full``), or all but the outputs the
reference names ``attn_out`` and ``moe_out`` (``save_heavy``).
"""
from __future__ import annotations

import dataclasses

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.distributed import collectives as coll

from .attention import (AttnDims, MLADims, cross_apply, cross_init, cross_memory,
                        gqa_apply, gqa_init, init_cache, mla_apply, mla_init,
                        mla_init_cache)
from .config import ArchConfig
from .context import get_context, seq_split
from .layers import embed_apply, embed_init, mlp_apply, mlp_init, rms_norm, softcap
from .moe import moe_ffn_dense_masked, moe_ffn_tokens, moe_init
from .ssm import ssm_apply, ssm_init, ssm_init_cache

KINDS = ("global", "global_dense", "local", "mamba", "shared")


def _check_supported(cfg: ArchConfig) -> None:
    kinds = set(cfg.head) | set(cfg.pattern) | set(cfg.tail)
    if not kinds <= set(KINDS):
        raise ValueError(f"{cfg.name}: unknown layer kinds {sorted(kinds - set(KINDS))}; "
                         f"the port runs {KINDS}")


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
    p = {"attn_norm": torch.zeros((cfg.d_model,), **zeros), "attn": attn,
         "ffn_norm": torch.zeros((cfg.d_model,), **zeros), "ffn": ffn}
    if cfg.family == "encdec":
        p["cross_norm"] = torch.zeros((cfg.d_model,), **zeros)
        p["cross"] = cross_init(attn_dims(cfg), dtype, gen)
    return p


def dataclass_enc(cfg: ArchConfig) -> ArchConfig:
    """Encoder layers: plain bidirectional attention + dense FFN."""
    return dataclasses.replace(cfg, family="lm", moe=None, mla=None)


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
    if cfg.family == "encdec":
        ecfg = dataclass_enc(cfg)
        params["enc_blocks"] = [layer_init(ecfg, "global", dtype, gen)
                                for _ in range(cfg.enc_layers)]
        params["enc_norm"] = torch.zeros((cfg.d_model,), dtype=dtype, device=gen.device)
    return params


def layer_cache(cfg: ArchConfig, kind: str, batch: int, max_len: int, device,
                mem_len: int = 0) -> dict:
    """A layer's cache; a ``shared`` occurrence's is a ``global`` layer's.
    An encoder-decoder's layer adds ``cross_k`` / ``cross_v``, (batch,
    max(mem_len, 1), Hkv, Dh) in the model dtype."""
    if kind == "mamba":
        return ssm_init_cache(cfg.ssm, batch, model_dtype(cfg), device)
    if kind == "shared":
        kind = "global"
    if _is_mla(cfg, kind):
        return mla_init_cache(mla_dims(cfg), batch, max_len, model_dtype(cfg), device)
    c = init_cache(attn_dims(cfg, kind), batch, max_len, model_dtype(cfg), device)
    if cfg.family == "encdec":
        shape = (batch, max(mem_len, 1), cfg.n_kv_heads, cfg.hd)
        c["cross_k"] = torch.zeros(shape, dtype=model_dtype(cfg), device=device)
        c["cross_v"] = torch.zeros(shape, dtype=model_dtype(cfg), device=device)
    return c


def lm_init_caches(cfg: ArchConfig, batch: int, max_len: int, device,
                   mem_len: int = 0) -> dict:
    """{'head': (one cache per head layer,), 'tail': (...), 'blocks': (one
    stacked cache per pattern kind,)}, block leaves (n_blocks, batch, ...):
    the reference's layout."""
    def one(kind):
        return layer_cache(cfg, kind, batch, max_len, device, mem_len)

    def stacked(kind):
        return {k: v.expand(cfg.n_blocks, *v.shape).contiguous()
                for k, v in one(kind).items()}
    return {"head": tuple(one(k) for k in cfg.head),
            "tail": tuple(one(k) for k in cfg.tail),
            "blocks": tuple(stacked(k) for k in cfg.pattern)}


def _apply_ffn(p_ffn, cfg: ArchConfig, kind: str, h, mode: str, norm, seq_lens=None,
               named=None):
    """(the FFN of rms_norm(h, *norm), aux): aux is the MoE router's
    load-balance loss (f32, 0-dim), 0.0 for a dense FFN.  ``seq_lens`` (B,)
    marks the valid prefix of right-padded prefill rows: pad tokens are
    masked out of MoE routing, so they claim no expert capacity.  Train
    and prefill route through the capacity buckets, decode dense-masked.

    Under a ``DistContext`` whose ``seq`` is set (one rank of a sequence-
    parallel prefill, its rows' block of the sequence): the routed FFN runs
    expert-parallel over the reference's token groups (``_routed_split``).
    Under another ``DistContext`` (one rank of a train mesh, holding its
    data rows and its E / M experts): train and prefill split the rank's B S
    tokens into M contiguous blocks over the model group - the reference's
    tokens over ('data', 'model') - route block m expert-parallel, and
    gather the outputs back; aux is the mean over every rank of its
    block's aux, whose backward hands each rank 1 / M of the grad (the
    train step sums the router's grads over the model group and every
    grad's over the data group / D).  Decode runs the local experts over
    the rank's tokens, summed over the model group, aux the data group's
    mean.

    ``named`` (a save_heavy segment's ``_Named``) takes the routed experts'
    output, the reference's ``moe_out``."""
    if not _is_moe(cfg, kind):
        return mlp_apply(p_ffn, h, norm=norm), 0.0
    xn = rms_norm(h, *norm)
    B, S, d = xn.shape

    def routed():
        mask = None
        if seq_lens is not None:
            mask = (torch.arange(S, device=h.device)[None] < seq_lens[:, None]).reshape(B * S)
        ctx = get_context()
        x2 = xn.reshape(B * S, d)
        if ctx is None:
            fn = moe_ffn_tokens if mode in ("train", "prefill") else moe_ffn_dense_masked
            return fn(p_ffn, x2, cfg.moe, token_mask=mask)
        g = ctx.groups
        if g is None:
            raise ValueError("a DistContext needs its mesh's groups: "
                             "train_step.dist_context_for(mesh)")
        M = coll.size(g.model)
        if ctx.seq is not None and mode == "prefill":
            if mask is not None:
                raise ValueError("a sequence-parallel prefill takes unpadded rows")
            return _routed_split(p_ffn, cfg, xn, ctx.seq, g.model), 0.0
        if mode in ("train", "prefill"):
            xt = coll.split_rows(x2, g.model)
            mt = None if mask is None else mask.view(M, -1)[coll.index(g.model)]
            y, aux = moe_ffn_tokens(p_ffn, xt, cfg.moe, group=g.model, token_mask=mt)
            return coll.gather_rows(y, g.model), coll.mean_over(aux, g.world, 1.0 / M)
        y, aux = moe_ffn_dense_masked(p_ffn, x2, cfg.moe, group=g.model, token_mask=mask)
        return y, coll.mean_over(aux, g.data, 1.0)

    y, aux = routed() if named is None else named(routed)
    y = y.reshape(B, S, d)
    if cfg.moe.n_shared:
        y = y + mlp_apply(p_ffn["shared"], xn)
    if cfg.moe.dense_residual:
        y = y + mlp_apply(p_ffn["dense"], xn)
    return y, aux


def _routed_split(p_ffn, cfg: ArchConfig, xn, split, group):
    """The routed FFN of a sequence-parallel prefill's rank, on its block
    xn (Bl, s, d) of Bl rows.  The reference routes the flattened (B S)
    tokens under ``P(token_axes)``: its capacity groups are the M
    contiguous pieces of a replica's flattened rows, so in units of s
    tokens ("flat block" b M + m is row b's block m) group j holds flat
    blocks [j Bl, (j + 1) Bl) - the rank's own blocks only when Bl is 1.
    So the rank sends each of its blocks to its group's rank and receives
    its group's, in flat order (one all-to-all of unequal chunks), runs the
    expert-parallel FFN over them, and sends the outputs back; with one row
    a replica nothing moves."""
    Bl, s, d = xn.shape
    M, m = split.parts, split.index
    x2 = xn.reshape(Bl * s, d)
    if Bl == 1 or M == 1:
        return moe_ffn_tokens(p_ffn, x2, cfg.moe, group=group)[0].reshape(Bl, s, d)
    dest = [(b * M + m) // Bl for b in range(Bl)]            # nondecreasing in b
    mine = range(m * Bl, (m + 1) * Bl)                        # this rank's group
    got = sorted(mine, key=lambda f: (f % M, f))              # received: by source
    send = [dest.count(j) * s for j in range(M)]
    recv = [sum(f % M == j for f in mine) * s for j in range(M)]
    xr = coll.all_to_all_split(x2, send, recv, group).view(Bl, s, d)
    xg = xr[[got.index(f) for f in mine]].reshape(Bl * s, d)
    y = moe_ffn_tokens(p_ffn, xg, cfg.moe, group=group)[0].view(Bl, s, d)
    back = y[[f - m * Bl for f in got]].reshape(Bl * s, d)
    return coll.all_to_all_split(back, recv, send, group).view(Bl, s, d)


def _land_cross(cache, mem_kv):
    """A decoder layer's ``cross_k`` / ``cross_v`` from the encoder memory's
    K/V: whole, or under a sequence-parallel prefill this rank's region of
    each (its head block)."""
    split = seq_split()
    for name, kv in zip(("cross_k", "cross_v"), mem_kv):
        dst = cache[name]
        src = kv if split is None else kv[split.region(dst)[0]]
        if src.shape != dst.shape:
            raise ValueError(f"encoder memory K/V {tuple(src.shape)}, cache leaf "
                             f"{tuple(dst.shape)}: build the caches with mem_len = the "
                             f"frames' length")
        dst.copy_(src)


def layer_apply(p, cfg: ArchConfig, kind: str, h, positions, *, mode: str, cache,
                memory=None, causal: bool = True, seq_lens=None, chunked: bool = False,
                named=None):
    """One layer on h (B, S, d): (h, aux), its cache updated in place
    (``mode='train'``: no cache - a train step's layer, or an encoder's).
    An encoder-decoder's layer cross-attends ``memory`` (the encoder's
    output) in train mode and at prefill, and its ``cross_k`` / ``cross_v``
    leaves at decode.  ``named`` (train mode's save_heavy, ``_Named``)
    takes the attention output, the reference's ``attn_out``, and the MoE
    FFN's ``moe_out``."""
    eps = cfg.norm_eps
    if kind == "mamba":
        return h + ssm_apply(p["ssm"], cfg.ssm, h, mode=mode, cache=cache,
                             seq_lens=seq_lens, norm=(p["norm"], eps)), 0.0
    # each norm runs inside the prologue that reads its output (one K1
    # launch) wherever that input feeds one PDQ group
    def attend():
        if _is_mla(cfg, kind):
            return mla_apply(p["attn"], mla_dims(cfg), h, positions, mode=mode, cache=cache,
                             seq_lens=seq_lens, norm=(p["attn_norm"], eps),
                             chunked=chunked)[0]
        return gqa_apply(p["attn"], attn_dims(cfg, kind), h, positions, mode=mode,
                         cache=cache, causal=causal, seq_lens=seq_lens,
                         norm=(p["attn_norm"], eps), chunked=chunked)[0]

    a = attend() if named is None else named(attend)
    h = h + a
    if cfg.family == "encdec":
        dims = attn_dims(cfg)
        if mode == "train":
            mem_kv = cross_memory(p["cross"], dims, memory)
        elif mode == "prefill":
            mem_kv = cross_memory(p["cross"], dims, memory)
            _land_cross(cache, mem_kv)
        else:
            mem_kv = (cache["cross_k"], cache["cross_v"])
        h = h + cross_apply(p["cross"], dims, h, mem_kv, norm=(p["cross_norm"], eps))
    f, aux = _apply_ffn(p["ffn"], cfg, kind, h, mode, (p["ffn_norm"], eps),
                        seq_lens if mode == "prefill" else None, named)
    return h + f, aux


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


def _encoder_apply(params, cfg: ArchConfig, frames):
    """The bidirectional encoder over stub frame embeddings (B, Sm, d):
    cache-free ``global`` layers at positions arange(Sm), then
    ``enc_norm``."""
    ecfg = dataclass_enc(cfg)
    B, Sm, _ = frames.shape
    positions = torch.arange(Sm, device=frames.device)[None].expand(B, Sm)
    h = frames
    for p in params["enc_blocks"]:
        h, _ = layer_apply(p, ecfg, "global", h, positions, mode="train", cache=None,
                           causal=False)
    return rms_norm(h, params["enc_norm"], cfg.norm_eps)


REMATS = ("none", "full", "save_heavy")


def _remat(cfg: ArchConfig, mode: str) -> str:
    """What train mode recomputes of each pattern block in the backward."""
    if cfg.remat not in REMATS:
        raise ValueError(f"remat={cfg.remat!r}: one of {REMATS}")
    return cfg.remat if mode == "train" else "none"


class _Stop(Exception):
    """A save_heavy segment's end: ``value`` is its named output."""

    def __init__(self, value):
        super().__init__("save_heavy segment end")
        self.value = value


class _Named:
    """The named points (``attn_out``, ``moe_out``) of one save_heavy
    segment of a pattern block, in layer order: the first ``len(given)``
    take the values earlier segments computed, the next one is computed
    and ends the segment (``_Stop``).  A ``moe_out`` point computes
    (y, aux) and takes (y, 0.0): its aux is summed from the segment that
    computed it."""

    def __init__(self, given):
        self.given, self.k = given, 0

    def __call__(self, compute):
        if self.k == len(self.given):
            raise _Stop(compute())
        self.k += 1
        return self.given[self.k - 1]


def _segment(block, i, h, moe, *values):
    """One checkpointed segment of pattern block i from its input ``h`` and
    the named values before it (``moe[k]`` marks a ``moe_out``): the next
    named value, as ("attn", a) or ("moe", y, aux), or ("end", h, aux)."""
    given = [(v, 0.0) if m else v for v, m in zip(values, moe)]
    try:
        return ("end", *block(i, h, _Named(given)))
    except _Stop as stop:
        v = stop.value
        return ("moe", *v) if isinstance(v, tuple) else ("attn", v)


def _save_heavy(block, i, h):
    """Pattern block i under the reference's save_heavy policy
    (``jax.checkpoint`` with ``save_only_these_names("moe_out",
    "attn_out")``): the backward keeps the block's input and each named
    output, and recomputes everything else.  The block runs as a chain of
    non-reentrant checkpoints, one a named point and one to the end; each
    takes the block input and the named values before it as its inputs,
    so those are what autograd keeps, and each recomputes only its own
    stretch.  A block of several layers recomputes, in each segment, the
    unnamed ops of its earlier layers from those inputs, in the forward
    too: the carry between layers is never kept.  Returns (h, aux)."""
    values, moe, aux = [], [], 0.0
    while True:
        out = checkpoint(_segment, block, i, h, moe, *values, use_reentrant=False)
        if out[0] == "end":
            return out[1], aux + out[2]
        values.append(out[1])
        moe = [*moe, out[0] == "moe"]
        if out[0] == "moe":
            aux = aux + out[2]


def lm_apply(params, cfg: ArchConfig, *, tokens, positions, mode: str,
             caches=None, frames=None, patches=None, seq_lens=None, chunked: bool = False):
    """Returns (h_final, caches, aux_sum); serving ``caches`` are updated in
    place, and train mode takes and returns ``caches=None``.  ``aux_sum``
    is the MoE layers' load-balance loss summed in train mode (a 0-dim f32
    tensor, or 0.0 for a dense model) and 0.0 when serving, where nothing
    reads it.  ``patches`` (B, P, d): stub embeddings prepended to the
    embedded text (a vision config); ``frames`` (B, Sm, d): the encoder's
    input (an encoder-decoder's train step or prefill).  ``seq_lens`` (B,)
    marks the valid prefix of right-padded prefill rows, in full-sequence
    positions (patches included); ``chunked`` marks a chunked-prefill
    continuation (``positions`` are absolute and attention also reads the
    rows the caches already hold).

    With ``cfg.remat == "full"`` a train step runs each of the ``n_blocks``
    pattern blocks under ``torch.utils.checkpoint`` (non-reentrant), as the
    reference checkpoints its scan body: only the blocks' inputs are kept
    for the backward, which recomputes each block's activations.  With
    ``"save_heavy"`` the backward also keeps each layer's attention output
    and routed experts' output (``_save_heavy``)."""
    dtype = model_dtype(cfg)
    train = mode == "train"
    if train != (caches is None):
        raise ValueError(f"mode {mode!r} {'takes no' if train else 'needs'} caches")
    h = embed_tokens(params, cfg, tokens)
    if patches is not None:
        h = torch.cat([patches.to(dtype), h], dim=1)
    memory = None
    if cfg.family == "encdec" and mode != "decode":
        if frames is None:
            raise ValueError(f"{cfg.name}: an encoder-decoder's {mode} needs frames")
        memory = _encoder_apply(params, cfg, frames.to(dtype))
    kw = dict(mode=mode, memory=memory, seq_lens=seq_lens, chunked=chunked)
    aux_total = 0.0

    def layer(p, kind, h, cache):
        nonlocal aux_total
        h, aux = layer_apply(p, cfg, kind, h, positions, cache=cache, **kw)
        if train:
            aux_total = aux_total + aux
        return h

    for i, kind in enumerate(cfg.head):
        h = layer(params["head"][i], kind, h, None if train else caches["head"][i])
    P = len(cfg.pattern)

    def block(i, h, named=None):
        """Pattern block i: (h, its aux)."""
        aux = 0.0
        for j, kind in enumerate(cfg.pattern):
            cache = None if train else {k: v[i] for k, v in caches["blocks"][j].items()}
            if kind == "shared":
                p, kind = params["shared_block"], "global"
            else:
                p = params["blocks"][i * P + j]
            h, a = layer_apply(p, cfg, kind, h, positions, cache=cache, named=named, **kw)
            aux = aux + a
        return h, aux

    remat = _remat(cfg, mode)
    for i in range(cfg.n_blocks):
        if remat == "full":
            h, aux = checkpoint(block, i, h, use_reentrant=False)
        elif remat == "save_heavy":
            h, aux = _save_heavy(block, i, h)
        else:
            h, aux = block(i, h)
        if train:
            aux_total = aux_total + aux
    for i, kind in enumerate(cfg.tail):
        h = layer(params["tail"][i], kind, h, None if train else caches["tail"][i])
    return rms_norm(h, params["final_norm"], cfg.norm_eps), caches, aux_total


def lm_logits(params, cfg: ArchConfig, h):
    logits = h @ params["embed"]["embedding"].T.to(h.dtype)
    return softcap(logits.float(), cfg.logit_softcap)
