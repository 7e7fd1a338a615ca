"""Plain reference of a decoder-only LM as the port runs stablelm-1.6b, the
weights the benchmark makes for it, and the counts of one decode step.

The model (the port's ``global`` layers; departures from the published
StableLM 2 are listed in the configuration's file): tokens embed through
``embedding`` (vocab, d); each of ``n_layers`` layers adds to the residual

    attn(rms_norm(h, attn_norm))   q, k, v = x wq, x wk, x wv; RoPE over
                                   the whole head on q and k (the two
                                   halves rotated as pairs); causal softmax
                                   attention, scale head_dim ** -0.5; wo
    mlp(rms_norm(h, ffn_norm))     (silu(x w_gate) * (x w_up)) w_down

then ``rms_norm(h, final_norm)`` and logits against the tied embedding.
``rms_norm`` scales by (1 + w).  Everything runs in IEEE float32 over the
whole sequence, without a cache.

``forward(..., bits=4)`` is the lower-precision control: every projection
W4A4 (weights per output column, activations per row) and K/V rounded to
4 bits per (token, head) after RoPE, where the configuration states int8
for both.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .common import (dtype_of, fake_quant, generator, ieee_f32, lin, normal, rms_norm,
                     stacked_uniform)

PROJ = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


def _shapes(m: dict) -> dict[str, tuple[int, int]]:
    d, H, Hkv, Dh, F_ = m["d_model"], m["n_heads"], m["n_kv_heads"], m["head_dim"], m["d_ff"]
    return {"wq": (d, H * Dh), "wk": (d, Hkv * Dh), "wv": (d, Hkv * Dh), "wo": (H * Dh, d),
            "w_gate": (d, F_), "w_up": (d, F_), "w_down": (F_, d)}


def make_weights(m: dict, seed: int, device) -> dict:
    """The weights of ``m`` from ``seed``, in the layout the port's
    ``build_model(cfg).init`` returns: each projection U(+-sqrt(3 / d_in)),
    the embedding N(0, 0.02), norms zero; one draw a projection kind for
    all layers."""
    gen, dt, L, d = generator(seed, device), dtype_of(m), m["n_layers"], m["d_model"]
    embedding = normal(gen, (m["vocab"], d), 0.02, dt)
    proj = {k: stacked_uniform(gen, L, *s, dt) for k, s in _shapes(m).items()}

    def zeros():
        return torch.zeros((d,), dtype=dt, device=device)

    blocks = [{"attn_norm": zeros(),
               "attn": {k: proj[k][i] for k in ("wq", "wk", "wv", "wo")},
               "ffn_norm": zeros(),
               "ffn": {k: proj[k][i] for k in ("w_gate", "w_up", "w_down")}}
              for i in range(L)]
    return {"embed": {"embedding": embedding}, "final_norm": zeros(),
            "head": [], "tail": [], "blocks": blocks}


def _rope(x, theta: float):
    """x (S, heads, Dh) rotated at positions 0 .. S - 1."""
    S, _, Dh = x.shape
    freqs = 1.0 / theta ** (torch.arange(0, Dh, 2, dtype=torch.float32, device=x.device) / Dh)
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] * freqs
    sin, cos = torch.sin(ang)[:, None], torch.cos(ang)[:, None]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _attend(q, k, v):
    """Causal softmax attention of q (S, H, Dh) over k, v (S, Hkv, Dh)."""
    S, H, Dh = q.shape
    g = H // k.shape[1]
    k, v = k.repeat_interleave(g, dim=1), v.repeat_interleave(g, dim=1)
    s = torch.einsum("qhd,khd->hqk", q, k) * Dh ** -0.5
    mask = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
    p = torch.softmax(s.masked_fill(~mask, float("-inf")), dim=-1)
    return torch.einsum("hqk,khd->qhd", p, v)


@torch.no_grad()
def forward(w: dict, m: dict, tokens, bits: int | None = None):
    """Logits (S, vocab) float32 at every position of ``tokens`` (S,)."""
    eps, H, Hkv, Dh = m["norm_eps"], m["n_heads"], m["n_kv_heads"], m["head_dim"]
    S = tokens.shape[0]
    with ieee_f32():
        emb = w["embed"]["embedding"]
        h = emb[tokens].float()
        for p in w["blocks"]:
            a = p["attn"]
            x = rms_norm(h, p["attn_norm"], eps)
            q = _rope(lin(x, a["wq"], bits).view(S, H, Dh), m["rope_theta"])
            k = _rope(lin(x, a["wk"], bits).view(S, Hkv, Dh), m["rope_theta"])
            v = lin(x, a["wv"], bits).view(S, Hkv, Dh)
            if bits:
                k, v = fake_quant(k, bits, -1), fake_quant(v, bits, -1)
            h = h + lin(_attend(q, k, v).reshape(S, H * Dh), a["wo"], bits)
            f = p["ffn"]
            x = rms_norm(h, p["ffn_norm"], eps)
            h = h + lin(F.silu(lin(x, f["w_gate"], bits)) * lin(x, f["w_up"], bits),
                        f["w_down"], bits)
        h = rms_norm(h, w["final_norm"], eps)
        return h @ emb.float().T


# ----------------------------------------------------------------- counts
def proj_params(m: dict) -> int:
    """Parameters of the int8 projections of every layer."""
    return m["n_layers"] * sum(a * b for a, b in _shapes(m).values())


def kv_token_bytes(m: dict) -> int:
    """Bytes of one position of the int8 cache over every layer: K and V
    codes and their float32 scales a (token, head)."""
    return m["n_layers"] * m["n_kv_heads"] * (2 * m["head_dim"] + 2 * 4)


def decode_bytes(m: dict, rows: int, live: int) -> int:
    """The least bytes one decode step over ``rows`` live rows moves, whose
    caches hold ``live`` positions in all once the step's token is written:
    every weight read once (int8 projections, the embedding as the tied
    head, the norms), the live K/V and scales read once, the new token's
    K/V and scales and position written once."""
    esize = 2 if m["dtype"] == "bfloat16" else 4
    d = m["d_model"]
    weights = proj_params(m) + (m["vocab"] * d + (2 * m["n_layers"] + 1) * d) * esize
    write = rows * (kv_token_bytes(m) + 4 * m["n_layers"])
    return weights + live * kv_token_bytes(m) + write


def decode_ops(m: dict, rows: int, live: int) -> tuple[int, int]:
    """(int8 operations, other floating-point operations) of one decode
    step: the projections at 2 an int8 multiply-add; attention's QK and PV
    over the live positions and the head's logits."""
    int8 = 2 * proj_params(m) * rows
    attn = 4 * m["n_heads"] * m["head_dim"] * live * m["n_layers"]
    head = 2 * m["vocab"] * m["d_model"] * rows
    return int8, attn + head
