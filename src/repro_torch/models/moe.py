"""Mixture-of-Experts FFN (port of ``repro/models/moe.py``).

  * ``moe_ffn_tokens`` (train, prefill): route, pack each assignment into
    its expert's capacity bucket (E, C, d) - overflow drops - run the
    stacked SwiGLU experts over the buckets, gather each assignment's
    output back and weight it by its gate.
  * ``moe_ffn_dense_masked`` (decode): every expert runs over every token
    and the gates mask the sum.  It holds no host read and no
    data-dependent shape, so a captured decode graph replays it.

Expert parallelism (``group=``, the expert axis's process group; the
reference's ``axis_name``): the rank's expert stacks hold its E / M
experts, those of ids [m E/M, (m+1) E/M) on the group's rank m.
``moe_ffn_tokens`` routes the rank's own tokens - C comes from their count
- and one ``all_to_all`` lands the (E, C, d) buckets as (E / M, M C, d),
each local expert's slots from every rank in source order; the local
stack runs over them and the reverse ``all_to_all`` brings each rank its
tokens' outputs for the combine.  ``moe_ffn_dense_masked`` runs the local
experts over every token and sums the ranks' outputs.  Without a group
every expert is local (one device).

The expert products are plain batched matmuls (``torch.bmm``), as the
reference's are plain einsums outside any Pallas kernel; the experts stay
in the model dtype (``linops.quantize_param_tree`` quantizes 2-D leaves
only, as the reference's does).

JAX's out-of-range indexing is made explicit.  A masked (pad) token's
assignments carry the sentinel expert id E; the reference's scatter drops
them (``mode="drop"``) and its gather reads a clamped row that a zero gate
then cancels.  Here such an assignment gets the capacity slot C (invalid),
its bucket write goes to a dump row past the buckets, and its gathered
output is zero: every real token's result is the reference's.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.distributed import collectives as coll

from .layers import dense_init, mlp_init


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared: int = 0               # shared experts applied to all tokens
    dense_residual: bool = False    # Arctic: dense FFN in parallel with MoE
    d_ff_dense: int = 0             # width of shared/dense-residual FFN
    capacity_factor: float = 1.25
    router_scale: float = 1.0       # gate multiplier (deepseek routed_scaling)


def _stacked_init(E: int, d_in: int, d_out: int, dtype, gen) -> torch.Tensor:
    """(E, d_in, d_out) expert weights drawn expert by expert into one
    tensor (the reference's ``vmap(dense_init)``), so that a draw never
    holds more than one expert's f32 temporaries (arctic's stack is 26.8
    GB of bf16)."""
    out = torch.empty((E, d_in, d_out), dtype=dtype, device=gen.device)
    if out.is_meta:             # shapes only (``layers.MetaGenerator``)
        return out
    for e in range(E):
        out[e] = dense_init(d_in, d_out, dtype, gen)
    return out


def moe_init(d_model: int, cfg: MoEConfig, dtype, gen) -> dict:
    E, ff = cfg.n_experts, cfg.d_ff_expert
    p = {
        "router": dense_init(d_model, E, torch.float32, gen),
        "we_gate": _stacked_init(E, d_model, ff, dtype, gen),
        "we_up": _stacked_init(E, d_model, ff, dtype, gen),
        "we_down": _stacked_init(E, ff, d_model, dtype, gen),
    }
    if cfg.n_shared:
        p["shared"] = mlp_init(d_model, cfg.d_ff_dense or ff * cfg.n_shared, dtype, gen)
    if cfg.dense_residual:
        p["dense"] = mlp_init(d_model, cfg.d_ff_dense or ff, dtype, gen)
    return p


def route(x, wr, cfg: MoEConfig, token_mask=None):
    """x (T, d) -> gates (T, k) f32, ids (T, k) int64, aux load-balance loss.

    The router's product and softmax run in f32 (IEEE on the card: the
    engine never enables TF32 for matmuls).  ``token_mask`` (T,) bool marks
    REAL tokens; a masked token's gates are 0 and its ids the sentinel E,
    so it claims no capacity slot and matches no expert."""
    E = wr.shape[1]
    probs = torch.softmax(x.float() @ wr, dim=-1)
    gates, ids = torch.topk(probs, cfg.top_k, dim=-1)
    gates = gates / torch.clamp_min(gates.sum(-1, keepdim=True), 1e-9)
    gates = gates * cfg.router_scale
    if token_mask is not None:
        gates = torch.where(token_mask[:, None], gates, 0.0)
        ids = torch.where(token_mask[:, None], ids, E)
    # switch-style aux: E * sum_e f_e * p_e (a sentinel id counts nowhere)
    experts = torch.arange(E, device=x.device)
    density = (ids[:, :1] == experts).float().mean(0)
    aux = E * (density * probs.mean(0)).sum()
    return gates, ids, aux


def _bucket(x, flat_ids, E: int, C: int):
    """Scatter assignments x (N, d) into (E, C, d) capacity buckets in
    order; an assignment past its expert's C slots drops.  Returns the
    buffer and each assignment's (slot, valid); a sentinel id (E) gets slot
    C, so it is never valid."""
    N, d = x.shape
    oh = (flat_ids[:, None] == torch.arange(E, device=x.device)).to(torch.int32)
    pos = torch.cumsum(oh, 0, dtype=torch.int32) - oh      # earlier same-id count
    real = flat_ids < E
    slot = pos.gather(1, torch.where(real, flat_ids, 0)[:, None])[:, 0]
    slot = torch.where(real, slot, C)
    valid = slot < C
    # dropped and sentinel assignments land on one dump row past the buckets
    dest = torch.where(valid, flat_ids * C + slot, E * C)
    buf = x.new_zeros((E * C + 1, d))
    buf.index_copy_(0, dest, x)
    return buf[:E * C].view(E, C, d), slot, valid


def _expert_ffn(p, h):
    """h (E, C, d) through the stacked SwiGLU experts."""
    g = torch.bmm(h, p["we_gate"])
    u = torch.bmm(h, p["we_up"])
    return torch.bmm(F.silu(g) * u, p["we_down"])


def moe_ffn_tokens(p, x, cfg: MoEConfig, *, group=None, token_mask=None):
    """The capacity-bucketed MoE over tokens x (T, d): (y (T, d), aux).
    C = max(1, int(T k cf / E + 0.999)) comes from the launch's T (this
    rank's, under a group), padded rows included, as the reference's
    does."""
    T, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    n = coll.size(group)
    gates, ids, aux = route(x, p["router"], cfg, token_mask)
    flat_ids = ids.reshape(-1)                              # (T*k,)
    xk = x.repeat_interleave(k, dim=0)                      # (T*k, d)
    C = max(1, int(T * k * cfg.capacity_factor / E + 0.999))
    buf, slot, valid = _bucket(xk, flat_ids, E, C)
    if n > 1:
        E_loc = E // n
        # (E, C, d) -> every rank's slots of the local experts, in source
        # order: (E_loc, n C, d)
        recv = coll.all_to_all_rows(buf, group).view(n, E_loc, C, d)
        out = _expert_ffn(p, recv.transpose(0, 1).reshape(E_loc, n * C, d))
        back = out.view(E_loc, n, C, d).transpose(0, 1).reshape(E, C, d)
        buf = coll.all_to_all_rows(back, group)             # (E, C, d): my tokens
        buf_out = buf.reshape(E * C, d)
    else:
        buf_out = _expert_ffn(p, buf).reshape(E * C, d)
    # combine: each valid assignment's expert output, weighted by its gate
    y_k = buf_out[torch.where(valid, flat_ids * C + slot, 0)]
    y_k = torch.where(valid[:, None], y_k, 0.0)
    y = (y_k * gates.reshape(-1, 1).to(y_k.dtype)).reshape(T, k, d).sum(1)
    return y, aux


def moe_ffn_dense_masked(p, x, cfg: MoEConfig, *, group=None, token_mask=None):
    """Decode-path MoE: every (local) expert over every token x (T, d),
    masked by the gates, summed over the group: (y (T, d), aux)."""
    E = cfg.n_experts
    n = coll.size(group)
    E_loc = E // n
    gates, ids, aux = route(x, p["router"], cfg, token_mask)
    out = _expert_ffn(p, x[None].expand(E_loc, *x.shape))   # (E_loc, T, d)
    eids = coll.index(group) * E_loc + torch.arange(E_loc, device=x.device)
    sel = ids[None] == eids[:, None, None]                  # (E_loc, T, k)
    w = (sel * gates[None]).sum(-1)                         # (E_loc, T)
    y = torch.einsum("et,etd->td", w.to(out.dtype), out)
    if n > 1:
        y = coll.all_reduce(y, group)
    return y, aux
