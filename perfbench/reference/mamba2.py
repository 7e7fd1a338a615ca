"""Plain reference of an attention-free Mamba-2 LM as the port runs
mamba2-2.7b (arXiv:2405.21060), the weights the benchmark makes for it, and
the counts of one decode step.

Each of ``n_layers`` layers adds to the residual the SSD block of
``rms_norm(h, norm)``:

    z | xBC | dt = x in_proj                 (d_inner, d_inner + 2 N, H)
    dt = softplus(dt + dt_bias); A = -exp(A_log)
    xBC = silu(causal depthwise conv(xBC, conv_w) + conv_b)
    x | B | C = xBC                          (H heads of P, one group of N)
    h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t^T,   y_t = h_t C_t + D x_t
    out = rms_norm(y * silu(z), ssm.norm) out_proj

then ``rms_norm(h, final_norm)`` and logits against the tied embedding.
The recurrence runs here by chunks of ``CHUNK`` positions: within a chunk
the decays exp(cumsum) weigh every (t, s <= t) pair, between chunks the
state carries.  Everything is IEEE float32 over the whole sequence from a
zero state and a zero conv window.

``forward(..., bits=4)`` is the lower-precision control: ``in_proj`` and
``out_proj`` W4A4 (weights per output column, activations per row), where
the configuration states int8.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .common import dtype_of, generator, ieee_f32, lin, normal, rms_norm, stacked_uniform

CHUNK = 256


def _dims(m: dict) -> dict[str, int]:
    s = m["ssm"]
    di = s["expand"] * m["d_model"]
    N, P = s["d_state"], s["head_dim"]
    H = di // P
    return {"di": di, "N": N, "P": P, "H": H, "K": s["d_conv"], "C": di + 2 * N,
            "in": 2 * di + 2 * N + H}


def make_weights(m: dict, seed: int, device) -> dict:
    """The weights of ``m`` from ``seed``, in the layout the port's
    ``build_model(cfg).init`` returns: projections U(+-sqrt(3 / d_in)),
    ``conv_w`` N(0, 0.1^2), the embedding N(0, 0.02), A_log
    log(linspace(1, 16, H)), D ones, dt_bias, conv_b and norms zero; one
    draw a kind for all layers."""
    gen, dt, L, d = generator(seed, device), dtype_of(m), m["n_layers"], m["d_model"]
    k = _dims(m)
    embedding = normal(gen, (m["vocab"], d), 0.02, dt)
    in_proj = stacked_uniform(gen, L, d, k["in"], dt)
    out_proj = stacked_uniform(gen, L, k["di"], d, dt)
    conv_w = normal(gen, (L, k["K"], k["C"]), 0.1, dt).unbind(0)
    f32 = dict(dtype=torch.float32, device=device)
    A_log = torch.log(torch.linspace(1.0, 16.0, k["H"], **f32))

    def zeros(n, dtype=dt):
        return torch.zeros((n,), dtype=dtype, device=device)

    blocks = [{"norm": zeros(d),
               "ssm": {"in_proj": in_proj[i], "conv_w": conv_w[i], "conv_b": zeros(k["C"]),
                       "A_log": A_log.clone(), "D": torch.ones((k["H"],), **f32),
                       "dt_bias": zeros(k["H"], torch.float32), "norm": zeros(k["di"]),
                       "out_proj": out_proj[i]}}
              for i in range(L)]
    return {"embed": {"embedding": embedding}, "final_norm": zeros(d),
            "head": [], "tail": [], "blocks": blocks}


def _ssd(x, dt, A, B, C):
    """y (S, H, P) of the recurrence over x (S, H, P), dt (S, H), A (H,),
    B and C (S, N), from a zero state."""
    S, H, P = x.shape
    state = torch.zeros((H, P, B.shape[1]), dtype=torch.float32, device=x.device)
    ys = []
    for c0 in range(0, S, CHUNK):
        xc, dtc, Bc, Cc = x[c0:c0 + CHUNK], dt[c0:c0 + CHUNK], B[c0:c0 + CHUNK], C[c0:c0 + CHUNK]
        T = xc.shape[0]
        cs = torch.cumsum(dtc * A, dim=0)                          # (T, H)
        seg = cs[:, None, :] - cs[None, :, :]                      # (t, s, H)
        causal = torch.ones((T, T), dtype=torch.bool, device=x.device).tril()[..., None]
        decay = torch.exp(torch.where(causal, seg, -math.inf))
        w = decay * (Cc @ Bc.T)[..., None] * dtc[None]             # (t, s, H)
        y = torch.einsum("tsh,shp->thp", w, xc)
        y = y + torch.einsum("tn,hpn->thp", Cc, state) * torch.exp(cs)[..., None]
        tail = torch.exp(cs[-1][None] - cs) * dtc                   # (s, H)
        state = (state * torch.exp(cs[-1])[:, None, None]
                 + torch.einsum("sh,shp,sn->hpn", tail, xc, Bc))
        ys.append(y)
    return torch.cat(ys)


@torch.no_grad()
def forward(w: dict, m: dict, tokens, bits: int | None = None):
    """Logits (S, vocab) float32 at every position of ``tokens`` (S,)."""
    k, eps = _dims(m), m["norm_eps"]
    di, N, P, H, K = k["di"], k["N"], k["P"], k["H"], k["K"]
    S = tokens.shape[0]
    with ieee_f32():
        emb = w["embed"]["embedding"]
        h = emb[tokens].float()
        for p in w["blocks"]:
            s = p["ssm"]
            zxbcdt = lin(rms_norm(h, p["norm"], eps), s["in_proj"], bits)
            z, xBC, dt = zxbcdt[:, :di], zxbcdt[:, di:di + k["C"]], zxbcdt[:, di + k["C"]:]
            dt = F.softplus(dt + s["dt_bias"])
            conv = F.conv1d(F.pad(xBC.T[None], (K - 1, 0)),
                            s["conv_w"].float().T[:, None], groups=k["C"])[0].T
            xBC = F.silu(conv + s["conv_b"].float())
            x = xBC[:, :di].reshape(S, H, P)
            y = _ssd(x, dt, -torch.exp(s["A_log"].float()), xBC[:, di:di + N], xBC[:, di + N:])
            y = (y + s["D"].float()[:, None] * x).reshape(S, di)
            h = h + lin(rms_norm(y * F.silu(z), s["norm"], 1e-6), s["out_proj"], bits)
        h = rms_norm(h, w["final_norm"], eps)
        return h @ emb.float().T


# ----------------------------------------------------------------- counts
def proj_params(m: dict) -> int:
    """Parameters of the int8 projections (in_proj, out_proj) of every
    layer."""
    k = _dims(m)
    return m["n_layers"] * (m["d_model"] * k["in"] + k["di"] * m["d_model"])


def decode_bytes(m: dict, rows: int, live: int) -> int:
    """The least bytes one decode step over ``rows`` live rows moves (the
    state does not grow with ``live``): every weight read once (int8
    projections, the embedding as the tied head, conv weights, norms and
    the per-head vectors), each row's float32 SSD state and conv window
    read once and written once."""
    k = _dims(m)
    esize = 2 if m["dtype"] == "bfloat16" else 4
    L, d = m["n_layers"], m["d_model"]
    per_layer = (k["K"] * k["C"] + k["C"] + k["di"] + d) * esize + 3 * k["H"] * 4
    weights = proj_params(m) + m["vocab"] * d * esize + L * per_layer + d * esize
    state = L * (k["H"] * k["P"] * k["N"] * 4 + (k["K"] - 1) * k["C"] * esize)
    return weights + 2 * rows * state


def decode_ops(m: dict, rows: int, live: int) -> tuple[int, int]:
    """(int8 operations, other floating-point operations) of one decode
    step: the projections at 2 an int8 multiply-add; the state's decay,
    update and read-out (5 a state element), the conv and the head."""
    k = _dims(m)
    int8 = 2 * proj_params(m) * rows
    ssd = m["n_layers"] * rows * (5 * k["H"] * k["P"] * k["N"] + 2 * k["K"] * k["C"])
    head = 2 * m["vocab"] * m["d_model"] * rows
    return int8, ssd + head
