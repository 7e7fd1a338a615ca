"""GQA attention with an fp or int8 KV cache, DeepSeek's MLA and the
encoder-decoder's cross-attention (port of ``repro/models/attention.py``).

The reference's fp attention is plain jnp, not Pallas, so this port is
plain torch: a masked-softmax transcription of ``chunked_attention`` (same
chunking, ``NEG`` fill and position masks) and of ``decode_attention``.
Caches are dicts of tensors updated IN PLACE (the reference threads new
pytrees): ``{'k', 'v': (B, S, Hkv, Dh), 'pos': (B, S), 'len': (B,)}``.

With ``quant_kv='dynamic'`` the cache is int8 in KERNEL layout, ``{'k',
'v': (B, Hkv, Sp, Dh) int8, 'k_scale', 'v_scale': (B, Hkv, Sp) f32, 'pos',
'len'}`` with Sp = S rounded up to a multiple of 128; each new token is
quantized per (token, head) as it is written, prefill still attends its
fresh fp k/v, and decode attends the cache through the flash-decode
kernels (``ops.decode_attend_i8kv``).  ``gqa_apply``'s ``mode='train'`` is
the cache-free pass an encoder runs (bidirectional with ``causal=False``).

Cross-attention (``cross_*``) attends, without RoPE and over every memory
position, the K/V that ``cross_memory`` projects once from the encoder's
output; a decoder layer keeps them as its ``cross_k`` / ``cross_v`` cache
leaves, in the model dtype whatever the KV cache's.

MLA keeps the compressed stream in its cache, ``{'ckv': (B, S, kv_lora),
'krope': (B, S, qk_rope), 'pos', 'len'}`` in the model dtype; prefill
expands per-head k/v from it (a chunk continuation re-expands the whole
buffer) and decode attends in the compressed space (the absorbed form).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels import ops
from repro_torch.kernels.ref import true_div

from .layers import apply_rope, dense_init, rms_norm, softcap
from .linops import dense_weight, is_quantized, is_segment_view, lin, lin_grouped

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
    quant_kv: str = "none"             # 'none' | 'dynamic' (int8 KV cache)


def chunked_attention(q, k, v, q_pos, k_pos, *, causal: bool = True,
                      window: int | None = None,
                      attn_softcap: float | None = None,
                      q_chunk: int = 512, kv_chunk: int = 1024):
    """Online-softmax attention over (q_chunk x kv_chunk) score tiles.

    q (B, Sq, H, Dh), k/v (B, Sk, Hkv, Dh), q_pos (B, Sq), k_pos (B, Sk);
    returns (B, Sq, H, Dv) in q's dtype.  Where the reference needs Sq and
    Sk to be multiples of their chunks, the port also takes a shorter last
    chunk (an engine's capacity bucket, max_len - 1 tokens, past 512): the
    chunks before it, and so every result at lengths the reference takes,
    are the same.
    """
    B, Sq, H, Dh = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    Dv = v.shape[-1]
    G = H // Hkv
    q_chunk, kv_chunk = min(q_chunk, Sq), min(kv_chunk, Sk)
    qs = q * torch.tensor(Dh ** -0.5, dtype=q.dtype)      # scale in q.dtype
    outs = []
    for i0 in range(0, Sq, q_chunk):
        qc = min(q_chunk, Sq - i0)
        qi = qs[:, i0:i0 + qc]                                  # (B, qc, H, Dh)
        qi = qi.reshape(B, qc, Hkv, G, Dh).permute(0, 2, 3, 1, 4).float()
        qpi = q_pos[:, i0:i0 + qc]
        m = torch.full((B, Hkv, G, qc), NEG, device=q.device)
        l = torch.zeros((B, Hkv, G, qc), device=q.device)
        acc = torch.zeros((B, Hkv, G, qc, Dv), device=q.device)
        for j0 in range(0, Sk, kv_chunk):
            sl = slice(j0, j0 + kv_chunk)
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
        outs.append(o.reshape(B, H, qc, Dv).transpose(1, 2))
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
    if dims.quant_kv not in ("none", "dynamic"):
        raise ValueError(f"quant_kv must be 'none' or 'dynamic', got {dims.quant_kv!r}")
    Hkv, Dh = dims.n_kv_heads, dims.head_dim
    S = min(max_len, dims.window) if dims.window else max_len
    cache = {
        "pos": torch.full((batch, S), -1, dtype=torch.int32, device=device),
        "len": torch.zeros((batch,), dtype=torch.int32, device=device),
    }
    if dims.quant_kv == "none":
        cache["k"] = torch.zeros((batch, S, Hkv, Dh), dtype=dtype, device=device)
        cache["v"] = torch.zeros((batch, S, Hkv, Dh), dtype=dtype, device=device)
        return cache
    # kernel layout; the padded tail is never written (slots index the
    # logical S) and always masked (positions >= len)
    Sp = S + (-S) % 128
    for name in ("k", "v"):
        cache[name] = torch.zeros((batch, Hkv, Sp, Dh), dtype=torch.int8, device=device)
        cache[f"{name}_scale"] = torch.ones((batch, Hkv, Sp), dtype=torch.float32,
                                            device=device)
    return cache


def _quant_kv_token(k_new, v_new):
    """Symmetric per-(token, head) int8 quantization of new KV entries
    (B, S, Hkv, Dh): scale = max(amax, 1e-6) / 127, codes rounded half to
    even and clipped to +-127.  Returns (kq, ks, vq, vs), scales (B, S,
    Hkv)."""
    def q(t):
        scale = true_div(torch.clamp_min(t.abs().amax(-1), 1e-6), 127.0)
        tq = torch.round(t / scale[..., None]).clamp(-127, 127).to(torch.int8)
        return tq, scale
    kq, ks = q(k_new.float())
    vq, vs = q(v_new.float())
    return kq, ks, vq, vs


def _cache_write(cache, k_new, v_new, positions):
    """Write S_new tokens at ring positions (pos % W), in place; an int8
    cache quantizes them first."""
    B = positions.shape[0]
    W = cache["pos"].shape[1]              # logical length (int8 caches pad S)
    slots = (positions % W).long()
    bidx = torch.arange(B, device=positions.device)[:, None]
    if "k_scale" in cache:
        kq, ks, vq, vs = _quant_kv_token(k_new, v_new)
        # (B, Hkv, Sp, ...)[bidx, :, slots]: the advanced (B, S_new) dims
        # come first, as in numpy and jnp, so (B, S_new, Hkv, Dh) lands
        # without a transpose
        cache["k"][bidx, :, slots] = kq
        cache["v"][bidx, :, slots] = vq
        cache["k_scale"][bidx, :, slots] = ks
        cache["v_scale"][bidx, :, slots] = vs
    else:
        cache["k"][bidx, slots] = k_new.to(cache["k"].dtype)
        cache["v"][bidx, slots] = v_new.to(cache["v"].dtype)
    cache["pos"][bidx, slots] = positions.to(torch.int32)
    # written by the elementwise kernel itself: a copy_ of the 4-byte-a-row
    # result is a memcpy node in a captured graph, which the driver runs
    # either as a kernel or on the copy engine (a stall between kernels)
    torch.maximum(cache["len"], (positions[:, -1] + 1).to(torch.int32), out=cache["len"])
    return cache


def _clamp_padded(vals, positions, seq_lens, ring: int | None = None):
    """Redirect the entries of a prefill write that must not land onto the
    row's LAST REAL token (values and positions), so that duplicate writes
    carry identical data: right-pad entries (index >= seq_lens), and with a
    ``ring`` of W slots every real entry but the row's last W, whose slot
    (pos % W) a later real entry of the same write takes.  The winner of
    each slot is then explicit - the scatter order of duplicate indices,
    which CUDA leaves open, cannot matter - and the cache equals the
    reference's, whose CPU scatter lets the last write win, bit for bit."""
    B, S = positions.shape
    idx = torch.arange(S, device=positions.device)[None, :]
    valid = idx < seq_lens[:, None]
    if ring is not None and S > ring:
        valid &= idx >= seq_lens[:, None] - ring
    last = torch.clamp_min(seq_lens - 1, 0).long()
    bidx = torch.arange(B, device=positions.device)
    out = []
    for v in vals:
        v_last = v[bidx, last][:, None]
        mask = valid.reshape(valid.shape + (1,) * (v.dim() - 2))
        out.append(torch.where(mask, v, v_last))
    pos = torch.where(valid, positions, positions[bidx, last][:, None])
    return out, pos


def _prefill_write(cache, k, v, positions, seq_lens):
    """A prefill's cache write: right-pad entries (``seq_lens``) and, when
    the write is longer than the cache's ring, the real entries a later
    one overwrites are redirected first (``_clamp_padded``)."""
    B, S = positions.shape
    W = cache["pos"].shape[1]
    if seq_lens is None and S > W:
        seq_lens = torch.full((B,), S, dtype=torch.int32, device=positions.device)
    if seq_lens is None:
        return _cache_write(cache, k, v, positions)
    (kc, vc), pos_c = _clamp_padded((k, v), positions, seq_lens, ring=W)
    return _cache_write(cache, kc, vc, pos_c)


def _cache_kv_float(cache, dtype):
    """The cache's k/v in the logical (B, S, Hkv, Dh) layout, dequantized
    to ``dtype`` when the cache is int8."""
    if "k_scale" not in cache:
        return cache["k"], cache["v"]
    S = cache["pos"].shape[1]
    out = []
    for name in ("k", "v"):
        t = cache[name].float() * cache[f"{name}_scale"][..., None]
        out.append(t.transpose(1, 2)[:, :S].to(dtype))
    return tuple(out)


def _valid_k_pos(cache_pos):
    """Cache slot positions with empty slots (-1) pushed beyond every real
    query position, so that the causal mask of ``chunked_attention`` (which
    has no validity mask of its own) excludes them: rel = q_pos - 2^30 < 0."""
    return torch.where(cache_pos >= 0, cache_pos, 2 ** 30)


def gqa_apply(p, dims: AttnDims, x, positions, *, mode: str, cache=None,
              causal: bool = True, seq_lens=None, norm=None, chunked: bool = False):
    """mode 'train' (cache-free), 'prefill' (S tokens, optional
    right-padding ``seq_lens``) or 'decode' (S == 1); returns (y (B, S, d),
    cache).  ``norm = (w, eps)``:
    attend over rms_norm(x, w, eps).  ``chunked``: a chunked-prefill
    continuation, whose cache rows already hold the earlier chunks."""
    B, S, _ = x.shape
    H, Hkv, Dh = dims.n_heads, dims.n_kv_heads, dims.head_dim
    # Q/K/V read the same normed input: quantized params run ONE prologue
    # (norm and intervals included) + ONE wide W8A8 matmul for the triple
    # (linops.lin_grouped)
    q, k, v = lin_grouped(x, (p["wq"], p["wk"], p["wv"]), norm=norm)
    q = apply_rope(q.reshape(B, S, H, Dh), positions, dims.rope_theta)
    k = apply_rope(k.reshape(B, S, Hkv, Dh), positions, dims.rope_theta)
    v = v.reshape(B, S, Hkv, Dh)
    if mode == "train":        # cache-free (an encoder's layers)
        o = chunked_attention(q, k, v, positions, positions, causal=causal,
                              window=dims.window, attn_softcap=dims.attn_softcap)
        return lin(o.reshape(B, S, H * Dh), p["wo"]), None
    if cache is None:
        raise ValueError("serving attention needs a cache")
    if mode == "prefill" and chunked:
        # the reference's continuation: attend the cache as it stands
        # BEFORE the write (the landed prefix; empty slots pushed out of
        # causal range) concatenated with the chunk's own k/v, and only
        # then write the chunk.  The order matters for a local layer, whose
        # ring holds exactly the last W positions: writing first would
        # evict keys still inside earlier in-chunk queries' windows.  An
        # int8 cache contributes its dequantized prefix (what decode would
        # read), as the reference documents.
        if seq_lens is None:
            raise ValueError("a chunked-prefill continuation needs seq_lens")
        kf, vf = _cache_kv_float(cache, x.dtype)
        k_all = torch.cat([kf, k.to(kf.dtype)], dim=1)
        v_all = torch.cat([vf, v.to(vf.dtype)], dim=1)
        pos_all = torch.cat([_valid_k_pos(cache["pos"]), positions.to(torch.int32)],
                            dim=1)
        o = chunked_attention(q, k_all, v_all, positions, pos_all, causal=causal,
                              window=dims.window, attn_softcap=dims.attn_softcap,
                              q_chunk=S, kv_chunk=k_all.shape[1])
        _prefill_write(cache, k, v, positions, seq_lens)
        return lin(o.reshape(B, S, H * Dh), p["wo"]), cache
    if mode == "prefill":
        _prefill_write(cache, k, v, positions, seq_lens)
        o = chunked_attention(q, k, v, positions, positions, causal=causal,
                              window=dims.window, attn_softcap=dims.attn_softcap)
        return lin(o.reshape(B, S, H * Dh), p["wo"]), cache
    if mode != "decode":
        raise ValueError(f"mode {mode!r}: the port serves 'train'/'prefill'/'decode'")
    _cache_write(cache, k, v, positions)
    q1 = q[:, 0]
    if "k_scale" in cache and dims.attn_softcap is None and dims.window is None:
        kv = (q1.float(), cache["k"], cache["v"], cache["k_scale"],
              cache["v_scale"], cache["len"])
        if is_quantized(p["wo"]) and not is_segment_view(p["wo"]):
            # the attend kernel's output stage also runs wo's prologue, so
            # the quantized wo is one W8A8 launch
            o, o_q, s_x, s1, s2 = ops.decode_attend_i8kv(
                *kv, wo_prologue=True, pro_dtype=x.dtype)
            y = ops.pdq_dense_from_prologue(
                o.reshape(B, 1, H * Dh), o_q.reshape(B, 1, H * Dh),
                s_x.reshape(B, 1, 1), s1.reshape(B, 1, 1), s2.reshape(B, 1, 1),
                p["wo"], out_dtype=x.dtype)
            return y, cache
        o = ops.decode_attend_i8kv(*kv).to(x.dtype)
    else:
        kf, vf = _cache_kv_float(cache, x.dtype)
        o = decode_attention(q1, kf, vf, positions[:, 0], cache["pos"],
                             window=dims.window, attn_softcap=dims.attn_softcap)
    return lin(o.reshape(B, 1, H * Dh), p["wo"]), cache


# ---------------------------------------------------------------------------
# Cross-attention (encoder-decoder): no RoPE, bidirectional over the memory
# ---------------------------------------------------------------------------


def cross_init(dims: AttnDims, dtype, gen):
    return gqa_init(dims, dtype, gen)


def cross_memory(p, dims: AttnDims, memory):
    """The cross-attention K/V of the encoder's output (B, Sm, d), each
    (B, Sm, Hkv, Dh): wk and wv read the same memory, so a grouped record
    runs ONE prologue and ONE matmul for the pair (wq reads the decoder
    stream: ``linops.CROSS_SIBLING_SETS``)."""
    B, Sm, _ = memory.shape
    k, v = lin_grouped(memory, (p["wk"], p["wv"]))
    return (k.reshape(B, Sm, dims.n_kv_heads, dims.head_dim),
            v.reshape(B, Sm, dims.n_kv_heads, dims.head_dim))


def cross_apply(p, dims: AttnDims, x, memory_kv, norm=None):
    """x (B, Sq, d) attends every position of ``memory_kv`` = (k, v), each
    (B, Sm, Hkv, Dh); ``norm = (w, eps)``: the queries read rms_norm(x, w,
    eps), the norm inside wq's prologue."""
    B, Sq, _ = x.shape
    H, Dh = dims.n_heads, dims.head_dim
    q = lin(x, p["wq"], norm=norm).reshape(B, Sq, H, Dh)
    k, v = memory_kv
    Sm = k.shape[1]
    qpos = torch.arange(Sq, device=x.device)[None].expand(B, Sq)
    kpos = torch.arange(Sm, device=x.device)[None].expand(B, Sm)
    o = chunked_attention(q, k, v, qpos, kpos, causal=False)
    return lin(o.reshape(B, Sq, H * Dh), p["wo"])


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2): low-rank q/kv with a compressed KV cache
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MLADims:
    d_model: int
    n_heads: int
    q_lora: int
    kv_lora: int
    qk_nope: int
    qk_rope: int
    v_head: int
    rope_theta: float = 10_000.0


def mla_init(m: MLADims, dtype, gen) -> dict:
    H = m.n_heads
    zeros = dict(dtype=dtype, device=gen.device)
    return {
        "wq_a": dense_init(m.d_model, m.q_lora, dtype, gen),
        "q_norm": torch.zeros((m.q_lora,), **zeros),
        "wq_b": dense_init(m.q_lora, H * (m.qk_nope + m.qk_rope), dtype, gen),
        "wkv_a": dense_init(m.d_model, m.kv_lora + m.qk_rope, dtype, gen),
        "kv_norm": torch.zeros((m.kv_lora,), **zeros),
        "wk_b": dense_init(m.kv_lora, H * m.qk_nope, dtype, gen),
        "wv_b": dense_init(m.kv_lora, H * m.v_head, dtype, gen),
        "wo": dense_init(H * m.v_head, m.d_model, dtype, gen),
    }


def mla_init_cache(m: MLADims, batch: int, max_len: int, dtype, device) -> dict:
    return {
        "ckv": torch.zeros((batch, max_len, m.kv_lora), dtype=dtype, device=device),
        "krope": torch.zeros((batch, max_len, m.qk_rope), dtype=dtype, device=device),
        "pos": torch.full((batch, max_len), -1, dtype=torch.int32, device=device),
        "len": torch.zeros((batch,), dtype=torch.int32, device=device),
    }


def _mla_qkv(p, m: MLADims, x, positions, norm=None):
    """(q_nope, q_rope, ckv, krope) of x; ``norm = (w, eps)``: of
    rms_norm(x, w, eps).  The two input-side projections share x: ONE
    grouped prologue (the attention norm inside it) and ONE matmul for a
    grouped record; ``wq_b``'s prologue applies ``q_norm`` in its launch."""
    B, S, _ = x.shape
    H = m.n_heads
    qa, kv = lin_grouped(x, (p["wq_a"], p["wkv_a"]), norm=norm)
    q = lin(qa, p["wq_b"], norm=(p["q_norm"], 1e-6))
    q = q.reshape(B, S, H, m.qk_nope + m.qk_rope)
    q_nope, q_rope = q[..., :m.qk_nope], q[..., m.qk_nope:]
    q_rope = apply_rope(q_rope, positions, m.rope_theta)
    ckv = rms_norm(kv[..., :m.kv_lora], p["kv_norm"])
    krope = apply_rope(kv[..., None, m.kv_lora:], positions, m.rope_theta)[..., 0, :]
    return q_nope, q_rope, ckv, krope


def _mla_write(cache, ckv, krope, positions):
    """Write S_new tokens' compressed entries at their positions, in place
    (duplicate positions carry identical data: ``_clamp_padded``)."""
    B = positions.shape[0]
    bidx = torch.arange(B, device=positions.device)[:, None]
    pos = positions.long()
    cache["ckv"][bidx, pos] = ckv.to(cache["ckv"].dtype)
    cache["krope"][bidx, pos] = krope.to(cache["krope"].dtype)
    cache["pos"][bidx, pos] = positions.to(torch.int32)
    torch.maximum(cache["len"], (positions[:, -1] + 1).to(torch.int32), out=cache["len"])
    return cache


def _expanded(p, m: MLADims, ckv, krope):
    """Per-head k (B, S, H, qk_nope + qk_rope) and v (B, S, H, v_head) of a
    compressed stream: ``wk_b`` / ``wv_b`` expand ckv, krope is shared by
    every head."""
    B, S, _ = ckv.shape
    H = m.n_heads
    k_nope = lin(ckv, p["wk_b"]).reshape(B, S, H, m.qk_nope)
    v = lin(ckv, p["wv_b"]).reshape(B, S, H, m.v_head)
    k = torch.cat([k_nope, krope[:, :, None].expand(B, S, H, m.qk_rope)], -1)
    return k, v


def _promoted(a, b):
    """a and b in their promoted dtype (JAX's einsum promotes bf16 x f32
    to f32; torch's refuses mixed operands)."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt), b.to(dt)


def mla_apply(p, m: MLADims, x, positions, *, mode: str, cache=None, seq_lens=None,
              norm=None, chunked: bool = False):
    """mode 'prefill' (expanded; ``chunked``: a continuation against the
    whole buffer) or 'decode' (absorbed); returns (y (B, S, d), cache),
    the cache updated in place.  ``norm = (w, eps)``: attend over
    rms_norm(x, w, eps)."""
    B, S, _ = x.shape
    H = m.n_heads
    if cache is None:
        raise ValueError("serving attention needs a cache")
    q_nope, q_rope, ckv, krope = _mla_qkv(p, m, x, positions, norm)
    q = torch.cat([q_nope, q_rope], -1)
    if mode == "prefill" and chunked:
        # the reference's continuation: land the chunk's compressed stream,
        # then re-expand the WHOLE buffer through wk_b / wv_b - it holds the
        # values an unchunked prefill computed, so the per-head k/v match
        # that path's (the absorbed form would associate the products
        # differently) - and attend it, empty slots out of causal range
        if seq_lens is None:
            raise ValueError("a chunked-prefill continuation needs seq_lens")
        (ckv_c, krope_c), pos_c = _clamp_padded((ckv, krope), positions, seq_lens)
        _mla_write(cache, ckv_c, krope_c, pos_c)
        Sb = cache["ckv"].shape[1]
        k, v = _expanded(p, m, cache["ckv"], cache["krope"])
        o = chunked_attention(q, k, v, positions, _valid_k_pos(cache["pos"]),
                              causal=True, q_chunk=S, kv_chunk=Sb)
        return lin(o.reshape(B, S, H * m.v_head), p["wo"]), cache
    if mode == "prefill":
        k, v = _expanded(p, m, ckv, krope)
        o = chunked_attention(q, k, v, positions, positions, causal=True)
        y = lin(o.reshape(B, S, H * m.v_head), p["wo"])
        pos_c = positions
        if seq_lens is not None:    # bucketed prefill: no pad entries land
            (ckv, krope), pos_c = _clamp_padded((ckv, krope), positions, seq_lens)
        _mla_write(cache, ckv, krope, pos_c)
        return y, cache
    if mode != "decode":
        raise ValueError(f"mode {mode!r}: the port serves 'prefill'/'decode'")
    # decode (absorbed): attention runs in the compressed space; a
    # quantized wk_b / wv_b is read as its f32 values q * scale, as the
    # reference reads it
    _mla_write(cache, ckv, krope, positions)
    r = m.kv_lora
    wk_b = dense_weight(p["wk_b"]).reshape(r, H, m.qk_nope)
    q_eff = torch.einsum("bhn,rhn->bhr", *_promoted(q_nope[:, 0], wk_b))   # (B, H, r)
    ckv_f = cache["ckv"].float()
    scale = (m.qk_nope + m.qk_rope) ** -0.5
    s = (torch.einsum("bhr,bsr->bhs", q_eff.float(), ckv_f)
         + torch.einsum("bhr,bsr->bhs", q_rope[:, 0].float(),
                        cache["krope"].float())) * scale
    ok = (cache["pos"] <= positions[:, :1]) & (cache["pos"] >= 0)
    s = torch.where(ok[:, None, :], s, NEG)
    prob = torch.softmax(s, dim=-1)
    ctx = torch.einsum("bhs,bsr->bhr", prob.to(cache["ckv"].dtype).float(), ckv_f)
    wv_b = dense_weight(p["wv_b"]).reshape(r, H, m.v_head)
    o = torch.einsum("bhr,rhv->bhv", *_promoted(ctx.to(x.dtype), wv_b))
    # the reference hands a quantized wv_b's f32 o to wo and so turns the
    # residual stream f32 in a bf16 model; the port rounds o to the model
    # dtype, as the prefill's (and an fp wv_b's) o is (equal in f32 models)
    return lin(o.to(x.dtype).reshape(B, 1, H * m.v_head), p["wo"]), cache
