"""GQA attention with an fp KV cache (port of the GQA half of
``repro/models/attention.py``).

The reference's attention here is plain jnp, not Pallas, so this port is
plain torch: a masked-softmax transcription of ``chunked_attention`` (same
chunking, ``NEG`` fill and position masks) and of ``decode_attention``.
Caches are dicts of tensors updated IN PLACE (the reference threads new
pytrees): ``{'k', 'v': (B, S, Hkv, Dh), 'pos': (B, S), 'len': (B,)}``.
The int8 KV cache and its flash-decode kernels come with the next slice.
"""
from __future__ import annotations

import dataclasses

import torch

from .layers import apply_rope, dense_init, softcap
from .linops import lin, lin_grouped

NEG = -2.0e30


@dataclasses.dataclass(frozen=True)
class AttnDims:
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    rope_theta: float = 10_000.0
    attn_softcap: float | None = None
    window: int | None = None          # sliding window (local attention)
    quant_kv: str = "none"             # only 'none' in this slice


def chunked_attention(q, k, v, q_pos, k_pos, *, causal: bool = True,
                      window: int | None = None,
                      attn_softcap: float | None = None,
                      q_chunk: int = 512, kv_chunk: int = 1024):
    """Online-softmax attention over (q_chunk x kv_chunk) score tiles.

    q (B, Sq, H, Dh), k/v (B, Sk, Hkv, Dh), q_pos (B, Sq), k_pos (B, Sk);
    returns (B, Sq, H, Dv) in q's dtype.
    """
    B, Sq, H, Dh = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    Dv = v.shape[-1]
    G = H // Hkv
    q_chunk, kv_chunk = min(q_chunk, Sq), min(kv_chunk, Sk)
    nq, nk = Sq // q_chunk, Sk // kv_chunk
    qs = q * torch.tensor(Dh ** -0.5, dtype=q.dtype)      # scale in q.dtype
    outs = []
    for i in range(nq):
        qi = qs[:, i * q_chunk:(i + 1) * q_chunk]               # (B, qc, H, Dh)
        qi = qi.reshape(B, q_chunk, Hkv, G, Dh).permute(0, 2, 3, 1, 4).float()
        qpi = q_pos[:, i * q_chunk:(i + 1) * q_chunk]
        m = torch.full((B, Hkv, G, q_chunk), NEG, device=q.device)
        l = torch.zeros((B, Hkv, G, q_chunk), device=q.device)
        acc = torch.zeros((B, Hkv, G, q_chunk, Dv), device=q.device)
        for j in range(nk):
            sl = slice(j * kv_chunk, (j + 1) * kv_chunk)
            kj = k[:, sl].permute(0, 2, 1, 3).float()           # (B, Hkv, kc, Dh)
            vj = v[:, sl].permute(0, 2, 1, 3)
            s = torch.einsum("bhgqd,bhkd->bhgqk", qi, kj)
            s = softcap(s, attn_softcap)
            rel = qpi[:, None, None, :, None] - k_pos[:, sl][:, None, None, None, :]
            msk = torch.ones_like(rel, dtype=torch.bool)
            if causal:
                msk &= rel >= 0
            if window is not None:
                msk &= rel < window
            s = torch.where(msk, s, NEG)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            p = torch.where(msk, p, 0.0)
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bhgqk,bhkd->bhgqd", p.to(vj.dtype).float(), vj.float())
            m = m_new
        o = acc / torch.clamp_min(l, 1e-30)[..., None]
        outs.append(o.reshape(B, H, q_chunk, Dv).transpose(1, 2))
    return torch.cat(outs, dim=1).to(q.dtype)


def decode_attention(q, k, v, q_pos, k_pos, *, window: int | None = None,
                     attn_softcap: float | None = None):
    """One query token: q (B, H, Dh); k/v (B, S, Hkv, Dh); q_pos (B,);
    k_pos (B, S) with -1 for empty slots."""
    B, H, Dh = q.shape
    Hkv = k.shape[2]
    G = H // Hkv
    qg = (q.reshape(B, Hkv, G, Dh) * torch.tensor(Dh ** -0.5, dtype=q.dtype)).float()
    s = torch.einsum("bhgd,bshd->bhgs", qg, k.float())
    s = softcap(s, attn_softcap)
    rel = q_pos[:, None] - k_pos                           # (B, S)
    ok = (rel >= 0) & (k_pos >= 0)
    if window is not None:
        ok &= rel < window
    s = torch.where(ok[:, None, None, :], s, NEG)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgs,bshd->bhgd", p.to(v.dtype).float(), v.float())
    return o.reshape(B, H, Dh).to(q.dtype)


def gqa_init(dims: AttnDims, dtype, gen):
    d, H, Hkv, Dh = dims.d_model, dims.n_heads, dims.n_kv_heads, dims.head_dim
    return {
        "wq": dense_init(d, H * Dh, dtype, gen),
        "wk": dense_init(d, Hkv * Dh, dtype, gen),
        "wv": dense_init(d, Hkv * Dh, dtype, gen),
        "wo": dense_init(H * Dh, d, dtype, gen),
    }


def init_cache(dims: AttnDims, batch: int, max_len: int, dtype, device) -> dict:
    if dims.quant_kv != "none":
        raise NotImplementedError(
            "the int8 KV cache is ROADMAP.md Queue 1 slice 2 (int8-KV decode)")
    Hkv, Dh = dims.n_kv_heads, dims.head_dim
    S = min(max_len, dims.window) if dims.window else max_len
    return {
        "pos": torch.full((batch, S), -1, dtype=torch.int32, device=device),
        "len": torch.zeros((batch,), dtype=torch.int32, device=device),
        "k": torch.zeros((batch, S, Hkv, Dh), dtype=dtype, device=device),
        "v": torch.zeros((batch, S, Hkv, Dh), dtype=dtype, device=device),
    }


def _cache_write(cache, k_new, v_new, positions):
    """Write S_new tokens at ring positions (pos % W), in place."""
    B = positions.shape[0]
    W = cache["pos"].shape[1]
    slots = (positions % W).long()
    bidx = torch.arange(B, device=positions.device)[:, None]
    cache["k"][bidx, slots] = k_new.to(cache["k"].dtype)
    cache["v"][bidx, slots] = v_new.to(cache["v"].dtype)
    cache["pos"][bidx, slots] = positions.to(torch.int32)
    cache["len"].copy_(torch.maximum(cache["len"], positions[:, -1] + 1))
    return cache


def _clamp_padded(vals, positions, seq_lens):
    """Redirect right-pad entries of a prefill write onto the row's LAST
    REAL token (values and positions), so duplicate writes carry identical
    data and pad tokens never reach the cache."""
    B, S = positions.shape
    idx = torch.arange(S, device=positions.device)[None, :]
    valid = idx < seq_lens[:, None]
    last = torch.clamp_min(seq_lens - 1, 0).long()
    bidx = torch.arange(B, device=positions.device)
    out = []
    for v in vals:
        v_last = v[bidx, last][:, None]
        mask = valid.reshape(valid.shape + (1,) * (v.dim() - 2))
        out.append(torch.where(mask, v, v_last))
    pos = torch.where(valid, positions, positions[bidx, last][:, None])
    return out, pos


def gqa_apply(p, dims: AttnDims, x, positions, *, mode: str, cache=None,
              causal: bool = True, seq_lens=None):
    """mode 'prefill' (S tokens, optional right-padding ``seq_lens``) or
    'decode' (S == 1); returns (y (B, S, d), cache)."""
    B, S, _ = x.shape
    H, Hkv, Dh = dims.n_heads, dims.n_kv_heads, dims.head_dim
    # Q/K/V read the same normed input: quantized params run ONE prologue +
    # ONE wide W8A8 matmul for the triple (linops.lin_grouped)
    q, k, v = lin_grouped(x, (p["wq"], p["wk"], p["wv"]))
    q = apply_rope(q.reshape(B, S, H, Dh), positions, dims.rope_theta)
    k = apply_rope(k.reshape(B, S, Hkv, Dh), positions, dims.rope_theta)
    v = v.reshape(B, S, Hkv, Dh)
    if cache is None:
        raise ValueError("serving attention needs a cache")
    if mode == "prefill":
        if seq_lens is None:
            _cache_write(cache, k, v, positions)
        else:
            (kc, vc), pos_c = _clamp_padded((k, v), positions, seq_lens)
            _cache_write(cache, kc, vc, pos_c)
        o = chunked_attention(q, k, v, positions, positions, causal=causal,
                              window=dims.window, attn_softcap=dims.attn_softcap)
        return lin(o.reshape(B, S, H * Dh), p["wo"]), cache
    if mode != "decode":
        raise ValueError(f"mode {mode!r}: the port serves 'prefill'/'decode'")
    _cache_write(cache, k, v, positions)
    o = decode_attention(q[:, 0], cache["k"], cache["v"], positions[:, 0],
                         cache["pos"], window=dims.window,
                         attn_softcap=dims.attn_softcap)
    return lin(o.reshape(B, 1, H * Dh), p["wo"]), cache
