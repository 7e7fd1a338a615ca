"""Mamba2 (SSD - state-space duality) block, arXiv:2405.21060 (port of
``repro/models/ssm.py``).

Chunked prefill (the "SSD minimal" formulation: an intra-chunk
attention-like term plus an inter-chunk state recurrence, here a loop over
the chunks where the reference runs ``lax.scan``) and a single-step
recurrent update for decode.  The recurrent state and the conv window are
the only cache - O(H * P * N) per sequence whatever the context length.

Layout: x (B, L, d_model) -> in_proj -> [z | xBC | dt] with d_inner =
expand * d_model, H = d_inner / head_dim heads and one group of B/C
(n_groups = 1).  ``in_proj`` and ``out_proj`` go through ``linops.lin``:
with PDQ records they run the prologue (K1) and the W8A8 matmul (K2), the
layer's input RMSNorm inside ``in_proj``'s prologue and the gated RMSNorm
inside ``out_proj``'s.  The scan, the conv and the decode update are plain
torch, as the reference's are plain ``jnp``; their contractions are
batched matmuls in IEEE f32 (``_ieee_f32``), in an order whose
intermediates stay at (B, n_chunks, H, chunk, chunk).

Under a sequence-parallel prefill (``context.SeqSplit``) each rank scans
its block of the sequence from a zero state; the ranks all-gather each
block's final state and total decay ((B, H, P, N) and (B, H) f32, one
collective) and the last d_conv - 1 conv inputs (the next block's left
context); rank r folds the earlier blocks into its initial state h0 and
adds h0's term, C_t exp(cumsum dt A) h0, to its y - the SSD's own
inter-chunk step, a block a step.  Every rank folds every block, so each
lands its head block of the whole sequence's final state and its channel
block of the last block's conv tail.

Caches are updated IN PLACE (the port's ``lm_apply`` passes views of the
stacked pool, and a captured decode graph replays fixed addresses): the
conv window and the state are written with ``copy_`` / in-place ops.  Train
mode has no cache and writes nothing; autograd differentiates the plain
torch ops, and a recomputed forward (``remat``) enters ``_ieee_f32`` again.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math

import torch
import torch.nn.functional as F

from repro_torch.distributed import collectives as coll

from .context import seq_split
from .layers import dense_init, draw_kw
from .linops import lin


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_model: int
    d_state: int = 128
    head_dim: int = 64
    expand: int = 2
    d_conv: int = 4
    chunk: int = 256

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def n_heads(self) -> int:
        return self.d_inner // self.head_dim

    @property
    def conv_dim(self) -> int:
        return self.d_inner + 2 * self.d_state


# the gated RMSNorm's epsilon: the reference calls rms_norm with its default
GATE_EPS = 1e-6


@contextlib.contextmanager
def _ieee_f32():
    """f32 matmuls without TF32 inside, the caller's setting restored after:
    the reference's f32 einsums, whatever ``allow_tf32`` says."""
    m = torch.backends.cuda.matmul
    saved = m.allow_tf32
    m.allow_tf32 = False
    try:
        yield
    finally:
        m.allow_tf32 = saved


def ssm_init(cfg: SSMConfig, dtype, gen: torch.Generator) -> dict:
    """Random SSD params on ``gen``'s device from the reference's
    distributions (U(+-sqrt(3/d_in)) projections, conv_w 0.1 * N(0, 1), A
    from log(linspace(1, 16)), D ones, dt_bias zeros, zero norm); the
    numbers differ from JAX's draws."""
    dev = gen.device
    d_in_proj = 2 * cfg.d_inner + 2 * cfg.d_state + cfg.n_heads
    in_proj = dense_init(cfg.d_model, d_in_proj, dtype, gen)
    conv_w = torch.randn((cfg.d_conv, cfg.conv_dim), dtype=torch.float32,
                         **draw_kw(gen))
    f32 = dict(dtype=torch.float32, device=dev)
    return {
        "in_proj": in_proj,
        "conv_w": (0.1 * conv_w).to(dtype),
        "conv_b": torch.zeros((cfg.conv_dim,), dtype=dtype, device=dev),
        "A_log": torch.log(torch.linspace(1.0, 16.0, cfg.n_heads, **f32)),
        "D": torch.ones((cfg.n_heads,), **f32),
        "dt_bias": torch.zeros((cfg.n_heads,), **f32),
        "norm": torch.zeros((cfg.d_inner,), dtype=dtype, device=dev),
        "out_proj": dense_init(cfg.d_inner, cfg.d_model, dtype, gen),
    }


def ssm_init_cache(cfg: SSMConfig, batch: int, dtype, device) -> dict:
    """{'conv': (B, d_conv - 1, conv_dim) model dtype, 'state': (B, H, P, N)
    f32}, zeros.  Neither grows with max_len, so both stay flat slot rows
    in a paged pool."""
    return {
        "conv": torch.zeros((batch, cfg.d_conv - 1, cfg.conv_dim), dtype=dtype,
                            device=device),
        "state": torch.zeros((batch, cfg.n_heads, cfg.head_dim, cfg.d_state),
                             dtype=torch.float32, device=device),
    }


def _split_proj(cfg: SSMConfig, zxbcdt: torch.Tensor):
    di, ds = cfg.d_inner, cfg.d_state
    return (zxbcdt[..., :di], zxbcdt[..., di:2 * di + 2 * ds],
            zxbcdt[..., 2 * di + 2 * ds:])


def _causal_conv(xBC, w, b, prev):
    """Depthwise causal conv over (B, L, C), kernel w (K, C), in xBC's
    dtype; ``prev`` (B, K - 1, C) is the left context (a fresh cache's zeros
    make it plain zero padding)."""
    K, L = w.shape[0], xBC.shape[1]
    pad = torch.cat([prev.to(xBC.dtype), xBC], dim=1)
    out = pad[:, :L] * w[0]
    for i in range(1, K):
        out = out + pad[:, i:i + L] * w[i]
    return F.silu(out + b)


def _segsum(x: torch.Tensor) -> torch.Tensor:
    """(..., T) -> (..., T, T) lower-triangular pairwise cumulative sums,
    -inf above the diagonal."""
    T = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    d = cs[..., :, None] - cs[..., None, :]
    mask = torch.ones((T, T), dtype=torch.bool, device=x.device).tril()
    return torch.where(mask, d, -math.inf)


def ssd_scan(x, dt, A, Bm, Cm, chunk: int, init_state=None):
    """Chunked SSD.  x (B, L, H, P), dt (B, L, H), A (H,) (negative), Bm/Cm
    (B, L, N), all f32.  Returns y (B, L, H, P) in x's dtype and the final
    state (B, H, P, N) f32.

    The reference's four einsums as batched matmuls, each in an order
    whose largest intermediate is (B, nc, H, c, c): y_diag =
    (scores * Lmat) @ (dt * x); states = (x * decay * dt)^T @ B; y_off =
    (C @ prev_states^T) * decay_in."""
    Bsz, L, H, P = x.shape
    N = Bm.shape[-1]
    chunk = min(chunk, L)
    pad = (-L) % chunk
    if pad:
        # zero-pad is exact: dt = 0 => decay 1 and a zero state update
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, pad))
    Lp = L + pad
    nc = Lp // chunk
    xc = x.reshape(Bsz, nc, chunk, H, P)
    dtc = dt.reshape(Bsz, nc, chunk, H)
    Bc = Bm.reshape(Bsz, nc, chunk, N)
    Cc = Cm.reshape(Bsz, nc, chunk, N)

    dA = dtc * A                                               # (B, nc, c, H)
    dA_cs = torch.cumsum(dA, dim=2)
    with _ieee_f32():
        # intra-chunk ("diagonal") term
        Lmat = torch.exp(_segsum(dA.permute(0, 1, 3, 2)))      # (B, nc, H, c, c)
        scores = Cc @ Bc.transpose(-1, -2)                     # (B, nc, c, c)
        xdt = (xc * dtc[..., None]).permute(0, 1, 3, 2, 4)     # (B, nc, H, c, P)
        y = (scores[:, :, None] * Lmat) @ xdt                  # (B, nc, H, c, P)
        del Lmat

        # chunk summary states
        decay_states = torch.exp(dA_cs[:, :, -1:] - dA_cs)     # (B, nc, c, H)
        xs = (xc * (decay_states * dtc)[..., None]).permute(0, 1, 3, 4, 2)
        states = xs @ Bc[:, :, None]                           # (B, nc, H, P, N)

        # inter-chunk recurrence
        chunk_decay = torch.exp(dA_cs[:, :, -1])               # (B, nc, H)
        prev = (torch.zeros((Bsz, H, P, N), dtype=torch.float32, device=x.device)
                if init_state is None else init_state.float())
        prevs = []
        for z in range(nc):
            prevs.append(prev)
            prev = prev * chunk_decay[:, z, :, None, None] + states[:, z]
        prev_states = torch.stack(prevs, dim=1)                # (B, nc, H, P, N)

        decay_in = torch.exp(dA_cs).permute(0, 1, 3, 2)[..., None]   # (B, nc, H, c, 1)
        y = y + (Cc[:, :, None] @ prev_states.transpose(-1, -2)) * decay_in
    y = y.permute(0, 1, 3, 2, 4).reshape(Bsz, Lp, H, P)[:, :L]
    return y.to(x.dtype), prev


def ssm_apply(p, cfg: SSMConfig, x, *, mode: str, cache, seq_lens=None, norm=None):
    """The SSD block on x (B, L, d_model), or with ``norm = (w, eps)`` on
    rms_norm(x, w, eps) (inside ``in_proj``'s prologue); returns y (B, L,
    d_model).  ``mode`` 'decode' takes L == 1; 'prefill' starts from the
    cache's conv tail and state (zeros on a fresh row; the landed ones of
    the earlier chunks in a chunked continuation) and writes the new conv
    window and state into ``cache`` in place; 'train' takes no cache
    (``cache=None``): a zero conv tail and a zero initial state, as the
    reference's prefill without a cache, and nothing is written.

    ``seq_lens`` (B,) marks right-padded prefill rows: a pad's dt is exactly
    0 (``torch.where``), so the recurrence skips it (decay exp(0) = 1, zero
    update), and the conv tail is gathered at each row's true end (index
    ``seq_lens + arange(d_conv - 1)`` into ``[cache.conv | xBC]``: a dummy
    row with seq_lens 0 keeps its cache's own tail)."""
    B, L, _ = x.shape
    H, P, N, K = cfg.n_heads, cfg.head_dim, cfg.d_state, cfg.d_conv
    di = cfg.d_inner
    z, xBC, dt = _split_proj(cfg, lin(x, p["in_proj"], norm=norm))
    dt = F.softplus(dt.float() + p["dt_bias"])                 # (B, L, H)
    A = -torch.exp(p["A_log"])                                 # (H,)
    if mode not in ("prefill", "decode", "train"):
        raise ValueError(f"mode must be 'train', 'prefill' or 'decode', got {mode!r}")
    if (cache is None) != (mode == "train"):
        raise ValueError(f"mode {mode!r} {'takes no' if mode == 'train' else 'needs a'} cache")
    split = seq_split() if mode == "prefill" else None
    if split is not None:
        if seq_lens is not None:
            raise ValueError("a sequence-parallel prefill takes unpadded rows")
        y = _split_scan(p, cfg, xBC, dt, A, cache, split)
        return lin(y * F.silu(z), p["out_proj"], norm=(p["norm"], GATE_EPS))
    prev = (cache["conv"] if cache is not None else
            torch.zeros((B, K - 1, xBC.shape[-1]), dtype=xBC.dtype, device=x.device))
    window = torch.cat([prev, xBC], dim=1)                     # (B, K - 1 + L, C)

    if mode == "decode":
        if L != 1:
            raise ValueError(f"decode takes one token a row, got {L}")
        conv_out = F.silu((window.float() * p["conv_w"].float()).sum(1)
                          + p["conv_b"].float())               # (B, C)
        cache["conv"].copy_(window[:, 1:])
        xc = conv_out[:, :di].reshape(B, H, P)
        Bm, Cm = conv_out[:, di:di + N], conv_out[:, di + N:]
        dt1 = dt[:, 0]                                         # (B, H)
        state = cache["state"]
        state.mul_(torch.exp(dt1 * A)[..., None, None])
        state.add_((dt1[..., None] * xc)[..., None] * Bm[:, None, None, :])
        with _ieee_f32():
            y = (state @ Cm[:, None, :, None])[..., 0]         # (B, H, P)
        y = y + p["D"][None, :, None] * xc
        y = y.reshape(B, 1, di).to(x.dtype)
    else:
        conv_out = _causal_conv(xBC, p["conv_w"], p["conv_b"], prev)
        xc = conv_out[..., :di].reshape(B, L, H, P).float()
        Bm = conv_out[..., di:di + N].float()
        Cm = conv_out[..., di + N:].float()
        if seq_lens is not None:
            valid = torch.arange(L, device=x.device)[None, :] < seq_lens[:, None]
            dt = torch.where(valid[..., None], dt, 0.0)
        y, final = ssd_scan(xc, dt, A, Bm, Cm, cfg.chunk,
                            cache["state"] if cache is not None else None)
        y = y + p["D"][None, None, :, None] * xc
        y = y.reshape(B, L, di).to(x.dtype)
        if cache is not None:
            if seq_lens is None:
                tail = window[:, -(K - 1):]
            else:
                # the last K - 1 real inputs start at window index seq_len
                idx = seq_lens.long()[:, None] + torch.arange(K - 1, device=x.device)[None]
                tail = window[torch.arange(B, device=x.device)[:, None], idx]
            cache["conv"].copy_(tail)
            cache["state"].copy_(final)
    return lin(y * F.silu(z), p["out_proj"], norm=(p["norm"], GATE_EPS))


def _split_scan(p, cfg: SSMConfig, xBC, dt, A, cache, split):
    """One rank's SSD over its block (B, L, .) of a sequence-parallel
    prefill (see the module docstring); lands its region of ``state`` and
    ``conv``.  Returns y (B, L, d_inner) in xBC's dtype."""
    B, L, _ = xBC.shape
    H, P, N, K = cfg.n_heads, cfg.head_dim, cfg.d_state, cfg.d_conv
    di, r = cfg.d_inner, split.index
    if L < K - 1:
        raise ValueError(f"a block of {L} tokens is shorter than the conv's context {K - 1}")
    dA = dt * A                                                # (B, L, H)
    tails = coll.all_gather_blocks([xBC[:, L - (K - 1):].contiguous()], split.group)[0]
    tails = tails.to(xBC.device)                               # (parts, B, K - 1, C)
    prev = tails[r - 1] if r else torch.zeros_like(tails[0])
    conv_out = _causal_conv(xBC, p["conv_w"], p["conv_b"], prev)
    xc = conv_out[..., :di].reshape(B, L, H, P).float()
    Bm = conv_out[..., di:di + N].float()
    Cm = conv_out[..., di + N:].float()
    y, final = ssd_scan(xc, dt, A, Bm, Cm, cfg.chunk)
    with _ieee_f32():
        finals, decays = coll.all_gather_blocks(
            [final, torch.exp(dA.sum(1))], split.group)        # (parts, B, H, P, N), (parts, B, H)
        finals, decays = finals.to(xBC.device), decays.to(xBC.device)
        state = torch.zeros((B, H, P, N), dtype=torch.float32, device=xBC.device)
        for j in range(split.parts):
            if j == r:
                # h0's term: C_t . h0, decayed by exp(cumsum dt A) to t
                decay_in = torch.exp(torch.cumsum(dA, dim=1)).permute(0, 2, 1)[..., None]
                y0 = (Cm[:, None] @ state.transpose(-1, -2)) * decay_in   # (B, H, L, P)
                y = y + y0.permute(0, 2, 1, 3).to(y.dtype)
            state = state * decays[j][..., None, None] + finals[j]
    y = y + p["D"][None, None, :, None] * xc
    st, _ = split.region(cache["state"])
    cv, _ = split.region(cache["conv"])
    cache["state"].copy_(state[st])
    cache["conv"].copy_(tails[-1][cv].to(cache["conv"].dtype))
    return y.reshape(B, L, di).to(xBC.dtype)
