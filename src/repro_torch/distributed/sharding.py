"""Sharding rules and the serving layout over a mesh (port of
``repro/distributed/sharding.py``).

Training (one process a mesh entry, ``train/train_step.py``): a param's
path picks a right-aligned partition spec, ``P``, one entry a dim - an axis
name, a tuple of axis names, or None (whole).

  * TP: the "wide" dim of every projection goes over 'model' (heads, ffn,
    vocab, experts).
  * FSDP/ZeRO-3: the other matrix dim goes over 'data'; optimizer states
    inherit the param specs.
  * EP: expert-stacked (E, ., .) tensors put E over 'model'.
  * Vectors (norms, biases, A_log...) stay whole.
  * A dim that its axis does not divide stays whole (vocab 50280 over 16).

The rules match a path's suffix, so a leaf of the port's per-layer tree
(``blocks/<layer>/attn/wq``, (d, n)) gets the reference's spec of its
stacked leaf (``blocks/<kind>/attn/wq``, (n_blocks, d, n)) less the leading
layer entry, which is always None.  ``batch_spec`` puts batch rows over the
data axes; ``cache_spec`` lays out decode caches.  ``block`` gives the
index range of a rank's block of a leaf: the entries of a dim's axes split
it evenly, the first axis of a tuple outermost, as jax's ``NamedSharding``
does for a device at those mesh coordinates.

``gather_whole`` joins a rank's blocks back into whole leaves, one
all-gather over the world a dtype: the sharded train step's params, and a
sequence-parallel prefill's weights a pattern block at a time.

Serving: ``process_replicas`` says which process hosts which replica.  The
sharded engine keeps one whole pool tree per replica rather than a view
into one global pool - K4-K7 and the decode graph need whole, fixed leaves
- so the reference's ``serve_pool_specs``, ``pool_shardings`` and
``make_global``, which lay out and place one global pool of jax arrays,
have no counterpart, nor has ``named`` (a jax ``NamedSharding`` tree).
"""
from __future__ import annotations

import re
from typing import Any

import numpy as np
import torch

from repro_torch import tree as tr
from repro_torch.distributed import collectives as coll


class P:
    """A partition spec: ``P(None, 'data', ('data', 'model'))``, one entry
    a dim.  It iterates and indexes as the tuple of its entries and equals
    any sequence of them; a tree (``repro_torch.tree``) holds it as a
    leaf."""
    __slots__ = ("entries",)

    def __init__(self, *entries):
        self.entries = tuple(entries)

    def __iter__(self):
        return iter(self.entries)

    def __len__(self) -> int:
        return len(self.entries)

    def __getitem__(self, i):
        return self.entries[i]

    def __eq__(self, other) -> bool:
        try:
            return self.entries == tuple(other)
        except TypeError:
            return NotImplemented

    def __hash__(self) -> int:
        return hash(self.entries)

    def __repr__(self) -> str:
        return f"P{self.entries!r}"


# (regex on the param path, right-aligned spec entries)
_RULES: list[tuple[str, tuple]] = [
    (r"embed/embedding$", ("model", "data")),
    # expert stacks (E, d_in, d_out): EP over model + FSDP over data
    (r"we_gate$", ("model", "data", None)),
    (r"we_up$", ("model", "data", None)),
    (r"we_down$", ("model", None, "data")),
    (r"router$", (None, None)),
    # column-parallel (d_model -> wide); grouped records live under
    # <sibling>/group/ and keep the column-parallel layout
    (r"(wq|wk|wv|wq_b|w_gate|w_up|in_proj)(/group)?(/q)?$", ("data", "model")),
    # row-parallel (wide -> d_model)
    (r"(wo|w_down|out_proj|wk_b|wv_b)(/q)?$", ("model", "data")),
    # low-rank down-projections: small output, shard input dim only
    (r"(wq_a|wkv_a)(/group)?(/q)?$", ("data", None)),
    # quantized-record auxiliaries: per-output-channel vectors
    (r"(wq|wk|wv|wq_b|w_gate|w_up|in_proj)(/group)?/scale$", ("model",)),
    (r"(wq|wk|wv|wq_b|w_gate|w_up|in_proj)(/group)?/colsum$", (None, "model")),
    (r"(wo|w_down|out_proj|wk_b|wv_b)/scale$", ("data",)),
    (r"(wo|w_down|out_proj|wk_b|wv_b)/colsum$", (None, "data")),
    (r"conv_w$", (None, "model")),
    (r"conv_b$", ("model",)),
]


def axis_size(mesh, entry) -> int:
    """How many blocks a spec entry makes: the product of its axes' sizes."""
    if entry is None:
        return 1
    if isinstance(entry, (tuple, list)):
        return int(np.prod([mesh.shape[a] for a in entry]))
    return int(mesh.shape[entry])


def spec_for_param(path: str, leaf, mesh=None) -> P:
    ndim = len(leaf.shape)
    if ndim == 0:
        return P()
    for pat, entries in _RULES:
        if re.search(pat, path):
            entries = tuple(entries)
            if len(entries) > ndim:       # e.g. scalar 'scale' on tiny layers
                entries = entries[-ndim:]
            full = [None] * (ndim - len(entries)) + list(entries)
            if mesh is not None:
                # drop axes the dim doesn't divide (e.g. vocab 50280 % 16)
                for i, e in enumerate(full):
                    if e is not None and leaf.shape[i] % axis_size(mesh, e) != 0:
                        full[i] = None
            return P(*full)
    return P(*((None,) * ndim))           # vectors & unknowns stay whole


def param_specs(params, mesh=None) -> Any:
    return tr.map_with_path(lambda path, v: spec_for_param(tr.path_str(path), v, mesh),
                            params)


def dp_axes(mesh) -> tuple[str, ...]:
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))


def batch_spec(mesh, batch_tree, seq_over_model: bool = False) -> Any:
    """Every batch leaf's leading (batch) dim over the DP axes where they
    divide it; with seq_over_model, dim 1 (sequence) over 'model' too."""
    dp = dp_axes(mesh)
    dp_size = axis_size(mesh, dp)
    model_size = mesh.shape["model"]

    def one(leaf):
        shape = leaf.shape
        if len(shape) == 0:
            return P()
        entries = [None] * len(shape)
        if shape[0] % dp_size == 0:
            entries[0] = dp
        if seq_over_model and len(shape) >= 2 and shape[1] % model_size == 0:
            entries[1] = "model"
        return P(*entries)

    return tr.tree_map(one, batch_tree)


# core rank of each cache leaf (batch-leading); scan-stacked block caches
# carry extra leading dims, which stay whole (right-aligned rules)
_CORE_RANK = {"k": 4, "v": 4, "k_scale": 3, "v_scale": 3, "ckv": 3, "krope": 3,
              "state": 4, "conv": 3, "cross_k": 4, "cross_v": 4, "pos": 2, "len": 1}


def _is_int8(leaf) -> bool:
    return str(leaf.dtype) in ("torch.int8", "int8")


def cache_spec(mesh, caches, batch: int, seq_over_model: bool = False) -> Any:
    """Decode caches: DP on batch when it divides, else context-parallel on
    the sequence dim; KV-head / state dims over 'model' when divisible."""
    dp = dp_axes(mesh)
    dp_size = axis_size(mesh, dp)
    model_size = mesh.shape["model"]
    data_size = mesh.shape["data"]

    def one(path, leaf):
        name = path[-1]
        nd = len(leaf.shape)
        if nd == 0 or name not in _CORE_RANK:
            return P(*((None,) * nd))
        core = _CORE_RANK[name]
        lead = nd - core
        shape = leaf.shape[lead:]
        e: list = [None] * core
        batch_sharded = shape[0] % dp_size == 0 and shape[0] > 1
        if batch_sharded:
            e[0] = dp
        seq_ok = (not batch_sharded) and core >= 2 and shape[1] % data_size == 0
        sp_ok = seq_over_model and core >= 2 and shape[1] % model_size == 0
        if name in ("k", "v", "k_scale", "v_scale"):
            # int8 KV caches (and their scales) are stored in kernel layout
            # (B, Hkv, S[, Dh]); fp caches stay logical (B, S, Hkv[, Dh])
            kernel_layout = name in ("k_scale", "v_scale") or _is_int8(leaf)
            head_ax, seq_ax = (1, 2) if kernel_layout else (2, 1)
            seq_ok = (not batch_sharded) and shape[seq_ax] % data_size == 0
            sp_ok = seq_over_model and shape[seq_ax] % model_size == 0
            if sp_ok:
                e[seq_ax] = "model"           # sequence-parallel prefill
            elif shape[head_ax] % model_size == 0:
                e[head_ax] = "model"
            if seq_ok:
                e[seq_ax] = "data"            # context parallel
        elif name in ("ckv", "krope", "pos"):
            if sp_ok:
                e[1] = "model"
            elif seq_ok:
                e[1] = "data"
        elif name == "state":
            if shape[1] % model_size == 0:
                e[1] = "model"
        elif name in ("conv", "cross_k", "cross_v"):
            if shape[2] % model_size == 0:
                e[2] = "model"
        return P(*(((None,) * lead) + tuple(e)))

    return tr.map_with_path(one, caches)


def block(spec, shape, mesh, coords: dict[str, int]) -> tuple[slice, ...]:
    """The index range of the block of a ``shape`` leaf laid out by
    ``spec`` that the entry at mesh ``coords`` ({axis: index}) holds."""
    out = []
    for i, n in enumerate(shape):
        e = spec[i] if i < len(spec) else None
        if e is None:
            out.append(slice(0, n))
            continue
        axes = e if isinstance(e, (tuple, list)) else (e,)
        k, idx = 1, 0
        for a in axes:                    # the first axis outermost
            idx = idx * mesh.shape[a] + coords[a]
            k *= mesh.shape[a]
        if n % k:
            raise ValueError(f"dim {i} of {tuple(shape)} does not divide over {e} ({k})")
        out.append(slice(idx * (n // k), (idx + 1) * (n // k)))
    return tuple(out)


def _axes(entry) -> tuple:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


def _is_k_major(t) -> bool:
    """A 2-D view whose storage runs down its columns (``ops.k_major``)."""
    return (t.dim() == 2 and min(t.shape) > 1 and t.stride(0) == 1
            and t.stride(1) == t.shape[0])


def _assemble(x, spec, keep, mesh, coords, device):
    """A leaf's work tensor on ``device`` from every entry's block ``x``
    ((D * M, *block), entry (d, m) at d * M + m): each dim's blocks joined
    in its axes' order (the first outermost, as ``block`` lays them out),
    an axis the leaf does not split at its first entry, and an axis that
    ``keep`` holds local (an expert stack's E under expert parallelism) at
    this rank's own entry.  Blocks staged on the host go to the device
    whole, and the device arranges them."""
    D, M = int(mesh.shape["data"]), int(mesh.shape["model"])
    x = x.view(D, M, *x.shape[1:])
    split = [_axes(e) for e in spec]
    kept = set()
    for k, e in enumerate(keep):
        if _axes(e) and _axes(e) != split[k]:
            raise ValueError(f"work spec {keep} keeps part of {spec}'s dim {k}")
        kept.update(_axes(e))
    mesh_axes = ["data", "model"]
    for a in ("model", "data"):          # drop an axis: the last index first
        if a in kept or not any(a in s for s in split):
            x = x.select(mesh_axes.index(a), coords[a] if a in kept else 0)
            mesh_axes.remove(a)
    split = [tuple(a for a in s if a in mesh_axes) for s in split]
    nm = len(mesh_axes)
    order = [i for k, s in enumerate(split) for i in [*map(mesh_axes.index, s), nm + k]]
    shape = [x.shape[nm + k] * int(np.prod([mesh.shape[a] for a in s]))
             for k, s in enumerate(split)]
    x = x.to(device).permute(order)
    out = torch.empty(shape, dtype=x.dtype, device=device)
    out.view(x.shape).copy_(x)
    return out


def world_order(mesh) -> list[int] | None:
    """The world group's index of entry (d, m), listed at d * M + m (a
    group lists its ranks in order); None where that is the mesh's own
    order."""
    ranks = sorted(int(r) for r in mesh.processes.flat)
    D, M = mesh.processes.shape
    order = [ranks.index(int(mesh.processes[d, m])) for d in range(D) for m in range(M)]
    return None if order == sorted(order) else order


def gather_whole(blocks, specs, keeps, mesh, groups) -> list:
    """Every tensor of ``blocks`` - this rank's block of a leaf laid out by
    the matching ``specs`` entry - joined from the mesh's blocks on its
    device, whole but for the axes its ``keeps`` entry holds local (this
    rank's own block of them): one all-gather over ``groups.world`` a
    dtype.  A K-major block (a quantized record's ``q``) is gathered as
    its (N, K) storage and comes back K-major."""
    order = world_order(mesh)
    items = []
    for t, spec, keep in zip(blocks, specs, keeps):
        if _is_k_major(t):
            t, spec, keep = t.t(), P(*reversed(tuple(spec))), P(*reversed(tuple(keep)))
            items.append((t, spec, keep, True))
        else:
            items.append((t, spec, keep, False))
    out: list = [None] * len(items)
    for dtype in sorted({t.dtype for t, *_ in items}, key=str):
        idx = [i for i, it in enumerate(items) if it[0].dtype == dtype]
        parts = coll.all_gather_blocks([items[i][0] for i in idx], groups.world)
        for x, i in zip(parts, idx):
            t, spec, keep, kmajor = items[i]
            if order is not None:
                x = x[order]
            w = _assemble(x, spec, keep, mesh, groups.coords, t.device)
            out[i] = w.t() if kmajor else w
        del parts
    return out


def process_replicas(mesh) -> dict[int, list[int]]:
    """{process index: [replica, ...]} in replica order: replica r is mesh
    row r, hosted by the process of its first entry."""
    out: dict[int, list[int]] = {}
    for r in range(mesh.processes.shape[0]):
        out.setdefault(int(mesh.processes[r, 0]), []).append(r)
    return out


__all__ = ["P", "axis_size", "batch_spec", "block", "cache_spec", "dp_axes", "gather_whole",
           "param_specs", "process_replicas", "spec_for_param", "world_order"]
