"""AdamW with optionally int8-quantized moment states (port of
``repro/optim/adamw.py``).

The int8 states are the PDQ idea applied to optimizer memory: per-block
symmetric scales for the first moment and the second, blocks of 64 along
each leaf's LAST axis (padded there), so 8 bytes a param of f32 moments
become 2 bytes of codes plus a scale per 64.  Every update computes in
float32 and casts the new param back to its own dtype.

Trees are the port's param trees (``repro_torch.tree``).  The reference
stacks each pattern kind's block params - and an encoder-decoder's
``enc_blocks`` - along a leading layer axis, where the port keeps one dict a
layer; weight decay goes to every leaf that is a matrix IN THE REFERENCE'S
LAYOUT (``ndim >= 2`` there), so a leaf under ``blocks`` or ``enc_blocks``
counts one axis more than it has here: a scanned block's norm weights and
a mamba layer's ``A_log`` / ``dt_bias`` / ``D`` are decayed, the head and
tail layers', ``shared_block``'s and ``final_norm`` are not.  The int8
blocking along the last axis is the same in both layouts (a stacked (n, d)
leaf blocks each row as the port's (d,) leaf does); a 0-dim leaf would not
be, and no registered config has one.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch
import torch.nn.functional as F

from repro_torch import tree as tr
from repro_torch.kernels.ref import true_div

# int8-state block size along the last axis (the reference's)
_BLOCK = 64

# top-level param sections the reference stacks along a leading layer axis
STACKED = ("blocks", "enc_blocks")


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    quant_state: bool = False       # int8 m/v (for very large models)


class OptState(NamedTuple):
    step: torch.Tensor              # 0-dim int32
    m: Any
    v: Any
    m_scale: Any = None             # only for quant_state
    v_scale: Any = None


def _blocks(x: torch.Tensor):
    """(..., D) -> (..., G, _BLOCK): last-axis blocking, padding the last
    axis only."""
    if x.dim() == 0:
        x = x.reshape(1)
    pad = (-x.shape[-1]) % _BLOCK
    if pad:
        x = F.pad(x, (0, pad))
    return x.reshape(*x.shape[:-1], -1, _BLOCK), pad


def _q8(x: torch.Tensor):
    """Per-block symmetric int8 encode -> (codes, f32 scales); codes round
    half to even and divide by the scale tensor, as the reference's."""
    b, _ = _blocks(x)
    amax = torch.clamp_min(b.abs().amax(-1, keepdim=True), 1e-12)
    scale = true_div(amax, 127.0)
    q = torch.round(b / scale).clamp(-127, 127).to(torch.int8)
    return q, scale.float()


def _dq8(q: torch.Tensor, scale: torch.Tensor, shape) -> torch.Tensor:
    full = q.float() * scale
    full = full.reshape(*full.shape[:-2], -1)     # unblock the last axis
    shape = tuple(shape)
    if shape == ():
        return full.reshape(-1)[0]
    return full[..., :shape[-1]].reshape(shape)


def init(params, cfg: AdamWConfig) -> OptState:
    leaf = tr.leaves(params)[0]
    step = torch.zeros((), dtype=torch.int32, device=leaf.device)

    def zeros32(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    if not cfg.quant_state:
        return OptState(step=step, m=tr.tree_map(zeros32, params),
                        v=tr.tree_map(zeros32, params))

    def blocked(p, width, dtype):
        """A meta leaf's codes (width 64) or scales (width 1), shapes only."""
        lead = tuple(p.shape[:-1]) if p.dim() else ()
        n = p.shape[-1] if p.dim() else 1
        return torch.empty((*lead, -(-n // _BLOCK), width), dtype=dtype, device="meta")

    def zq(p):
        return blocked(p, _BLOCK, torch.int8) if p.is_meta else _q8(zeros32(p))[0]

    def zs(p):
        return blocked(p, 1, torch.float32) if p.is_meta else _q8(zeros32(p))[1]

    return OptState(step=step, m=tr.tree_map(zq, params), v=tr.tree_map(zq, params),
                    m_scale=tr.tree_map(zs, params), v_scale=tr.tree_map(zs, params))


def global_norm(tree) -> torch.Tensor:
    sq = [torch.sum(torch.square(leaf.float())) for leaf in tr.leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(sq)))


def decayed(path: tuple, p: torch.Tensor) -> bool:
    """Whether AdamW decays the leaf at ``path``: a matrix in the
    reference's layout, where the ``STACKED`` sections carry a layer axis."""
    return p.dim() + (bool(path) and path[0] in STACKED) >= 2


class Scalars(NamedTuple):
    """One update's step-wide values: the new step count, the global-norm
    clip factor, the learning rate and the bias corrections."""
    step: torch.Tensor
    clip: torch.Tensor
    lr: torch.Tensor
    b1c: torch.Tensor
    b2c: torch.Tensor


def scalars(state: OptState, cfg: AdamWConfig, lr_scale, gnorm) -> Scalars:
    clip = torch.clamp_max(torch.full_like(gnorm, cfg.grad_clip)
                           / torch.clamp_min(gnorm, 1e-9), 1.0)
    step = state.step + 1
    stepf = step.float()
    b1c = 1.0 - torch.pow(torch.full_like(stepf, cfg.b1), stepf)
    b2c = 1.0 - torch.pow(torch.full_like(stepf, cfg.b2), stepf)
    lr = torch.as_tensor(lr_scale, dtype=torch.float32, device=gnorm.device) * cfg.lr
    return Scalars(step, clip, lr, b1c, b2c)


@torch.no_grad()
def update_leaf(path, p, g, m, v, ms, vs, cfg: AdamWConfig, sc: Scalars):
    """One leaf's update: (new p, m, v) with f32 moments, (new p, m codes,
    m scales, v codes, v scales) with int8 ones.  Elementwise but for the
    int8 moments, whose blocks run along the last axis: p, g and the
    moments cover one region of the leaf, and an int8 region holds whole
    blocks."""
    g = g.float() * sc.clip
    if cfg.quant_state:
        m_f, v_f = _dq8(m, ms, p.shape), _dq8(v, vs, p.shape)
    else:
        m_f, v_f = m, v
    m_f = cfg.b1 * m_f + (1 - cfg.b1) * g
    v_f = cfg.b2 * v_f + (1 - cfg.b2) * torch.square(g)
    delta = (m_f / sc.b1c) / (torch.sqrt(v_f / sc.b2c) + cfg.eps)
    if decayed(path, p):
        delta = delta + cfg.weight_decay * p.float()
    new_p = (p.float() - sc.lr * delta).to(p.dtype)
    if cfg.quant_state:
        return (new_p, *_q8(m_f), *_q8(v_f))
    return new_p, m_f, v_f


def assemble(params, results: dict, step, quant: bool):
    """(new params, new OptState) from ``update_leaf``'s results by path."""
    def pick(i):
        return tr.map_with_path(lambda path, _: results[path][i], params)
    if quant:       # (p, m codes, m scales, v codes, v scales)
        return pick(0), OptState(step, pick(1), pick(3), pick(2), pick(4))
    return pick(0), OptState(step, pick(1), pick(2), None, None)


@torch.no_grad()
def apply_updates(params, grads, state: OptState, cfg: AdamWConfig, lr_scale=1.0):
    """Returns (new_params, new_state).  Gradients are f32-cast and clipped
    by their global norm; weight decay goes to the ``decayed`` leaves."""
    sc = scalars(state, cfg, lr_scale, global_norm(grads))
    results = {}

    def run(path, p, g, m, v, ms=None, vs=None):
        results[path] = update_leaf(path, p, g, m, v, ms, vs, cfg, sc)

    trees = ((state.m, state.v, state.m_scale, state.v_scale) if cfg.quant_state
             else (state.m, state.v))
    tr.map_with_path(run, params, grads, *trees)
    return assemble(params, results, sc.step, cfg.quant_state)


def first_step_bound(params, grads_a, grads_b, cfg: AdamWConfig, lr_scale=1.0,
                     slack: float = 1e-5):
    """How far two first steps (zero moments) from the same ``params`` may
    part, leaf by leaf, when they were given two grads that differ in their
    last bits (those of two devices).  Such a step moves each param by
    lr (g' / (|g'| + eps) + decay), g' the grad after the global-norm clip,
    and for any a, b: |a / (|a| + e) - b / (|b| + e)| <= min(2, 2 |a - b| /
    (max(|a|, |b|) + e)), so where |g'| is near eps a tiny grad difference
    may move a param by up to 2 lr.  ``slack`` * (lr + |p|) covers the
    float32 rounding of the two steps.  Float64 tensors on the CPU."""
    def clipped(grads):
        g = tr.tree_map(lambda x: x.detach().double().cpu(), grads)
        norm = float(torch.sqrt(sum(torch.sum(x * x) for x in tr.leaves(g))))
        clip = min(1.0, cfg.grad_clip / max(norm, 1e-9))
        return tr.tree_map(lambda x: x * clip, g)

    lr = float(lr_scale) * cfg.lr

    def bound(p, a, b):
        far = torch.clamp_max(2 * (a - b).abs() / (torch.maximum(a.abs(), b.abs()) + cfg.eps),
                              2.0)
        return lr * far + slack * (lr + p.detach().double().cpu().abs())

    return tr.tree_map(bound, params, clipped(grads_a), clipped(grads_b))
