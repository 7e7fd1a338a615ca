"""Switchable linear ops: fp matmul or PDQ-int8 (W8A8) execution (port of
``repro/models/linops.py``).

``lin(x, w)`` runs ``x @ w`` for an fp weight and the fused PDQ pipeline
for a quantized record: one prologue prices the output interval from the
input moments BEFORE the matmul (paper Sec. 4), and one W8A8 matmul applies
it in its epilogue.  Projections that read the same input (Q/K/V, gate/up)
share one prologue and one wide matmul through ``lin_grouped`` over a
grouped record; each sibling key keeps its place in the param tree as a
segment view ``{"group": <shared record>, "seg": SegRef(i)}``.

Records keep the reference's logical layouts - ``q`` (K, N) int8,
``scale`` (N,), ``colsum`` (1, N) int32 - so the tests compare them with
JAX's directly.  ``q`` is stored K-major (``ops.k_major``: a view
``q_nk.t()`` of a contiguous (N, K) tensor), the layout the W8A8 kernels'
tensor cores read; tensor code reads it as any (K, N) tensor.
"""
from __future__ import annotations

import dataclasses
import itertools

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.kernels.ref import rms_norm, true_div

# grouped segments pad their N extent to this boundary so every
# (row, 128-column block) epilogue cell belongs to exactly one segment
LANE = 128

_GROUP_IDS = itertools.count()


def quantize_weight(w: torch.Tensor, alpha: float = 6.0, beta: float = 6.0) -> dict:
    """Deploy-time: per-output-channel symmetric int8 weight record with the
    Gaussian weight stats the PDQ surrogate needs (Eqs. 8-9).  The mean and
    variance are taken in float64 and rounded once to float32."""
    w32 = w.float()
    amax = w32.abs().amax(0).clamp_min(1e-8)
    scale = true_div(amax, 127.0)
    q = torch.round(w32 / scale[None, :]).clamp(-127, 127).to(torch.int8)
    w64 = w32.double()
    f32 = dict(dtype=torch.float32, device=w.device)
    return {
        "q": ops.k_major(q),
        "scale": scale,
        "colsum": q.sum(0, keepdim=True, dtype=torch.int32),
        "mu_w": w64.mean().float(),
        "var_w": w64.var(unbiased=False).float(),
        "alpha": torch.tensor(alpha, **f32),
        "beta": torch.tensor(beta, **f32),
    }


@dataclasses.dataclass(frozen=True)
class GroupSegs:
    """Layout of a grouped weight record: original per-projection N extents
    (``sizes``), their LANE-rounded extents in the concatenation
    (``padded``), the sibling names, and a unique id that keeps two layers'
    groups apart."""
    sizes: tuple[int, ...]
    padded: tuple[int, ...]
    names: tuple[str, ...] = ()
    gid: int = -1

    @property
    def offsets(self) -> tuple[int, ...]:
        return tuple(itertools.accumulate((0,) + self.padded[:-1]))

    @property
    def total(self) -> int:
        return sum(self.padded)


@dataclasses.dataclass(frozen=True)
class SegRef:
    """Segment index carried by a grouped-record view."""
    index: int


def group_quantize_weights(ws, alpha: float = 6.0, beta: float = 6.0,
                           names: tuple[str, ...] = ()) -> dict:
    """Deploy-time: concatenate sibling weights (same K) along N into ONE
    quantized record with per-segment surrogate stats.  Each segment is
    padded to LANE columns (padding channels get scale 1, colsum 0 and
    zero codes); ``mu_w``/``var_w``/``alpha``/``beta`` become (n_seg,)."""
    ws = list(ws)
    if len(ws) < 2:
        raise ValueError("a group needs at least two projections")
    K = ws[0].shape[0]
    if not all(w.dim() == 2 and w.shape[0] == K for w in ws):
        raise ValueError(f"grouped projections must share the input dim: "
                         f"{[tuple(w.shape) for w in ws]}")
    recs = [quantize_weight(w, alpha, beta) for w in ws]
    sizes = tuple(w.shape[1] for w in ws)
    padded = tuple(n + (-n) % LANE for n in sizes)
    pads = [p - n for n, p in zip(sizes, padded)]
    return {
        "q": ops.k_major(torch.cat([F.pad(r["q"], (0, p))
                                    for r, p in zip(recs, pads)], 1)),
        "scale": torch.cat([F.pad(r["scale"], (0, p), value=1.0)
                            for r, p in zip(recs, pads)]),
        "colsum": torch.cat([F.pad(r["colsum"], (0, p))
                             for r, p in zip(recs, pads)], 1),
        **{k: torch.stack([r[k] for r in recs])
           for k in ("mu_w", "var_w", "alpha", "beta")},
        "segs": GroupSegs(sizes=sizes, padded=padded, names=tuple(names),
                          gid=next(_GROUP_IDS)),
    }


def group_segment_view(grec: dict, index: int) -> dict:
    """A param-tree leaf standing in for segment ``index`` of ``grec``; it
    shares the record's tensors, so weight memory is not duplicated."""
    if not 0 <= index < len(grec["segs"].sizes):
        raise IndexError(index)
    return {"group": grec, "seg": SegRef(index)}


def segment_record(view: dict) -> dict:
    """A per-projection record sliced out of a segment view; its ``q`` is a
    K-major view of the group's storage (rows [off, off + n) of the (N, K)
    array), not a copy."""
    g, i = view["group"], view["seg"].index
    off, n = g["segs"].offsets[i], g["segs"].sizes[i]
    return {
        "q": g["q"].t()[off:off + n].t(),
        "scale": g["scale"][off:off + n],
        "colsum": g["colsum"][:, off:off + n],
        **{k: g[k][i] for k in ("mu_w", "var_w", "alpha", "beta")},
    }


def is_quantized(w) -> bool:
    return isinstance(w, dict) and ("q" in w or "group" in w)


def is_segment_view(w) -> bool:
    return isinstance(w, dict) and "group" in w


def lin(x: torch.Tensor, w, norm=None) -> torch.Tensor:
    """y = x @ w, fp or PDQ-int8 depending on the weight leaf; with ``norm
    = (w, eps)`` of rms_norm(x, w, eps), applied inside the prologue's
    launch for a quantized record and in plain torch first otherwise.

    Under ``ops.tp_shard`` an fp weight the row split (``tp_place``) runs
    each shard's block of columns on its device (the reference's ``lin``,
    ``models/linops.py:210-224``) and the blocks join in shard order.  A
    narrower GEMM may sum in another order and move float ulps, which greedy
    parity absorbs; a PDQ record's split (``kernels/ops.py``) is the
    bit-exact one."""
    if not is_quantized(w):
        x = x if norm is None else rms_norm(x, *norm)
        y = ops.tp_matmul(x, w)
        return x @ w if y is None else y
    if is_segment_view(w):
        w = segment_record(w)
    return ops.pdq_dense(x, w, out="fp", out_dtype=x.dtype, norm=norm)


# weights the model also reads whole, outside ``lin``: MLA's absorbed
# decode (``dense_weight``).  A TP row keeps them whole on its home.
READ_WHOLE = ("wk_b", "wv_b")


def tp_place(params, devices, *, copies: bool | None = None):
    """A replica's params over its mesh row ``devices`` (entry 0 the home,
    where the replica's program runs): (home tree, blocks).

    Every weight ``lin`` reads whose columns divide over the row (a grouped
    record's 128-column blocks, a record's or an fp weight's columns; not
    ``READ_WHOLE``) gets one block of columns a shard on the shard's device:
    a record's ``q`` (K-major), ``scale`` and ``colsum``, an fp weight's
    columns.  ``blocks`` maps id(the home tree's leaf) to (leaf, [block of
    shard j]) - what ``ops.TPRow`` takes.  Every other leaf, and a record's
    surrogate stats, go to the home.

    Where every entry is the home (one card repeated, or the CPU) a block
    is a view of the whole leaf, which the home keeps.  Otherwise
    (``copies``, which a test may force on the CPU) each block is a copy of
    its own and the home keeps no whole copy of a split weight: its leaf
    holds meta tensors of the whole's shape in their place, so that
    anything reading it whole raises.  The row's split weights then sum to
    one copy over its devices."""
    devs = [torch.device(d) for d in devices]
    home, T = devs[0], len(devs)
    if copies is None:
        copies = any(d != home for d in devs)
    blocks, memo = {}, {}

    def splits(name, units) -> bool:
        return T > 1 and name not in READ_WHOLE and units % T == 0

    def whole(t):
        """The home's leaf of a split weight."""
        if copies:
            return torch.empty_strided(t.shape, t.stride(), dtype=t.dtype, device="meta")
        return t.to(home)

    def block(t, j, k_major=False):
        """Shard j's columns of t (N columns) on its device: a view of the
        home's whole, or a copy of its own."""
        n = t.shape[-1] // T
        c = slice(j * n, (j + 1) * n)
        src = t.t()[c] if k_major else t[..., c]
        if copies:
            src = src.to(devs[j], copy=True)
        return src.t() if k_major else src

    def place(node, name):
        if id(node) in memo:
            return memo[id(node)]
        if isinstance(node, dict) and "q" in node:
            N = node["q"].shape[-1]
            if splits(name, N // LANE if "segs" in node else N):
                out = {k: whole(v) if k in ("q", "scale", "colsum") else place(v, k)
                       for k, v in node.items()}
                src = node if copies else out
                blocks[id(out)] = (out, [
                    {"q": block(src["q"], j, k_major=True), "scale": block(src["scale"], j),
                     "colsum": block(src["colsum"], j)} for j in range(T)])
            else:
                out = {k: place(v, k) for k, v in node.items()}
        elif isinstance(node, dict):
            out = {k: place(v, k) for k, v in node.items()}
        elif isinstance(node, (list, tuple)) and not hasattr(node, "_fields"):
            out = type(node)(place(v, name) for v in node)
        elif torch.is_tensor(node) and _default_pred(name, node) and splits(name, node.shape[1]):
            out = whole(node)
            src = node if copies else out
            blocks[id(out)] = (out, [block(src, j) for j in range(T)])
        elif torch.is_tensor(node):
            out = node.to(home)
        else:
            out = node
        memo[id(node)] = out
        return out

    return place(params, ""), blocks


def dense_weight(w) -> torch.Tensor:
    """An fp weight as it is, a quantized record dequantized to its f32 (K,
    N) values, ``q * scale`` (the reference's absorbed MLA decode reads its
    records so)."""
    if not is_quantized(w):
        return w
    if is_segment_view(w):
        w = segment_record(w)
    return w["q"].float() * w["scale"][None, :]


def _common_group(ws) -> dict | None:
    """The shared group record iff ``ws`` are views of ONE group, in
    segment order, covering every segment; else None."""
    if not ws or not all(is_segment_view(w) for w in ws):
        return None
    g = ws[0]["group"]
    if len(g["segs"].sizes) != len(ws):
        return None
    if any(w["group"] is not g or w["seg"].index != i for i, w in enumerate(ws)):
        return None
    return g


def lin_grouped(x: torch.Tensor, ws, norm=None) -> tuple:
    """(x @ w1, x @ w2, ...) for projections sharing the input x: ONE
    prologue + ONE wide W8A8 matmul when every member is a view of one
    grouped record, else per-projection ``lin``.  ``norm = (w, eps)``: the
    shared input is rms_norm(x, w, eps), applied inside the prologue's
    launch for a group and in plain torch first otherwise."""
    ws = tuple(ws)
    grec = _common_group(ws)
    if grec is not None:
        return ops.pdq_dense_grouped(x, grec, out="fp", out_dtype=x.dtype, norm=norm)
    if norm is not None:
        x = rms_norm(x, *norm)
    return tuple(lin(x, w) for w in ws)


# same-input sibling sets that share one prologue: Q/K/V off the attention
# norm, gate/up off the ffn norm, MLA's two input-side projections.  A
# cross-attention block (a dict keyed exactly ``cross``) is the exception:
# its wk/wv read the encoder memory while wq reads the decoder stream, so
# only the (wk, wv) pair shares an input
GROUP_SIBLING_SETS = (("wq", "wk", "wv"), ("w_gate", "w_up"), ("wq_a", "wkv_a"))
CROSS_SIBLING_SETS = (("wk", "wv"),)


def _default_pred(name: str, leaf) -> bool:
    return (torch.is_tensor(leaf) and leaf.dim() == 2
            and leaf.is_floating_point()
            and (name.startswith("w") or name.endswith("_proj")))


def quantize_param_tree(params, alpha: float = 6.0, beta: float = 6.0):
    """Replace every 2-D float weight leaf named ``w*`` / ``*_proj`` with a
    quantized record; known sibling sets become one grouped record with a
    segment view per sibling.

    The port keeps one param dict per layer in ``params["blocks"]``, so
    every layer is quantized - the records equal what
    ``jax.vmap(repro.models.linops.quantize_param_tree)`` makes for each
    layer of the reference's stacked blocks (the reference's own
    ``quantize_param_tree`` skips the 3-D stacks; ROADMAP.md Queue 3).
    zamba2's ``shared_block`` is quantized like a layer, as the reference
    quantizes its 2-D top-level leaves; a mamba layer's ``in_proj`` and
    ``out_proj`` are records, its ``conv_w`` (2-D, but not a ``w*`` /
    ``*_proj`` name), ``A_log``, ``D``, ``dt_bias`` and norms stay fp.  An
    encoder-decoder's ``enc_blocks`` are layers like ``blocks``; a decoder
    layer's ``cross`` block groups (wk, wv) alone (``CROSS_SIBLING_SETS``).
    """
    def rec(node, name):
        if isinstance(node, dict):
            out, done = {}, set()
            for names in CROSS_SIBLING_SETS if name == "cross" else GROUP_SIBLING_SETS:
                if not all(n in node and _default_pred(n, node[n]) for n in names):
                    continue
                leaves = [node[n] for n in names]
                if len({leaf.shape[0] for leaf in leaves}) != 1:
                    continue
                grec = group_quantize_weights(leaves, alpha, beta, names=names)
                for i, n in enumerate(names):
                    out[n] = group_segment_view(grec, i)
                done.update(names)
            for k, v in node.items():
                if k not in done:
                    out[k] = rec(v, k)
            return out
        if isinstance(node, (list, tuple)):
            return type(node)(rec(v, name) for v in node)
        if _default_pred(name, node):
            return quantize_weight(node, alpha, beta)
        return node

    return rec(params, "")
