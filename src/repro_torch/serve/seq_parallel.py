"""Sequence-parallel prefill over a (data, model) mesh: the reference's opt
prefill (``repro/launch/dryrun.py:101-166``: tokens and KV cache sharded
over 'model', parallel-q attention).

The reference jits ``bundle.prefill`` once under GSPMD with the params laid
out by ``param_specs``, the batch by ``batch_spec(..., seq_over_model=True)``
and the caches by ``cache_spec(..., seq_over_model=True)``, and returns the
logits replicated (``out_shardings=P()``).  Here each mesh entry is one
process (``launch/mesh.make_host_mesh``: NCCL over distinct cards, gloo
where ranks share a card or the CPU) that runs its own part, ``SeqPrefill``:

  * its replica's rows are its data block of the batch, as a serving mesh
    splits them; its tokens are block r = [r S / M, (r + 1) S / M) of each
    row's whole sequence of S (patches first, then text, as ``lm_apply``
    builds it), r its index in the model group of M; an encoder-decoder's
    frames are whole on every rank (the encoder is cache-free);
  * every layer runs ``bundle.prefill_split`` - ``lm_apply``'s one path -
    on that block under a ``DistContext`` whose ``seq`` names the split:
    attention gathers the layer's fp K/V (MLA its latents) over the model
    group, the SSD carries its state across the blocks, the routed FFN
    regroups its tokens into the reference's capacity groups
    (``models/attention.py``, ``models/ssm.py``, ``models/transformer.py``);
  * it lands its block of every cache leaf, the block that
    ``distributed/sharding.cache_spec(mesh, caches, B, seq_over_model=True)``
    gives its coordinates;
  * it returns the logits of each row's last token, every row of the batch
    on every rank, as the reference's do.

The weights stay in their ``param_specs`` blocks over the whole mesh (the
reference's ``params_sh``): each pattern block's layers are gathered whole
over the world when the first of them runs and freed when the next block
is gathered (``_Blockwise``), so a rank holds its blocks, the embedding and
the final norm whole, and one pattern block whole; the routed experts stay
in their expert-parallel blocks over 'model' (E / M experts a rank).  A
quantized record's ``q``, stored K-major, is cut as its (N, K) storage on
the axes the rules give its logical (K, N) (``shd.gather_whole``).

``S % M`` must be 0.  ``place_params``, ``place_batch`` and ``init_caches``
put a whole param tree, a whole batch and a fresh pool into a rank's
blocks (the tests', the card runs' and the dry run's set-up).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch import tree as tr
from repro_torch.distributed import collectives as coll
from repro_torch.distributed import sharding as shd
from repro_torch.models import context as mctx
from repro_torch.models.transformer import lm_init_caches

_EXPERTS = ("we_gate", "we_up", "we_down")
# each cache leaf's init element (every other leaf starts at zero)
_CACHE_FILL = {"pos": -1, "k_scale": 1.0, "v_scale": 1.0}


@dataclasses.dataclass
class ParamBlocks:
    """A rank's blocks of a param tree: ``tree`` has the whole tree's
    structure (a grouped record's segment views share one record, as in
    the whole tree) with each tensor leaf its block; ``layout`` maps
    id(block) to (its ``param_specs`` spec, the spec of what the rank
    works on: whole, or its expert block)."""
    tree: Any
    layout: dict


class _Blockwise:
    """A list of layers read whole ``size`` layers (one pattern block) at a
    time: reading layer k gathers its block, after dropping the block held
    before."""

    def __init__(self, layers, size: int, gather):
        self.layers, self.size, self.gather = layers, size, gather
        self._b, self._cur = None, None

    def __len__(self) -> int:
        return len(self.layers)

    def __getitem__(self, k: int):
        b = k // self.size
        if b != self._b:
            self._b, self._cur = None, None
            self._cur = self.gather(self.layers[b * self.size:(b + 1) * self.size])
            self._b = b
        return self._cur[k - b * self.size]

    def __iter__(self):
        return (self[k] for k in range(len(self)))


class SeqPrefill:
    """The sequence-parallel prefill of ``rows`` sequences of ``seq``
    positions (patches included) into a pool of ``max_len`` (default
    ``seq``) positions and ``mem_len`` encoder rows, over ``mesh``, for
    this process's entry (see the module docstring).  Building it is
    collective on the mesh's first use (``launch/mesh.mesh_groups``)."""

    def __init__(self, bundle, mesh, rows: int, seq: int, *, max_len: int | None = None,
                 mem_len: int = 0):
        from repro_torch.launch.mesh import mesh_groups
        from repro_torch.models.api import _patch_count
        self.bundle, self.cfg, self.mesh = bundle, bundle.cfg, mesh
        self.M = int(mesh.shape["model"])
        if seq % self.M:
            raise ValueError(f"a sequence-parallel prefill splits the sequence evenly: "
                             f"{seq} positions do not split over {self.M} model ranks")
        self.rows = rows
        max_len = seq if max_len is None else max_len
        if max_len < seq:
            raise ValueError(f"max_len {max_len} < the sequence's {seq} positions")
        self.patches = _patch_count(self.cfg)
        if seq <= self.patches:
            raise ValueError(f"{seq} positions leave no text after {self.patches} patches")
        self.groups = mesh_groups(mesh)
        if self.groups is None:
            raise ValueError("this process holds no entry of the mesh")
        self.coords = self.groups.coords
        self.ep = self.cfg.moe is not None and self.M > 1
        d, dt = self.cfg.d_model, torch.float32
        meta = {"tokens": torch.empty((rows, seq - self.patches), dtype=torch.int32,
                                      device="meta")}
        if self.patches:
            meta["patches"] = torch.empty((rows, self.patches, d), dtype=dt, device="meta")
        if self.cfg.family == "encdec":
            meta["frames"] = torch.empty((rows, mem_len, d), dtype=dt, device="meta")
        self.batch_specs = shd.batch_spec(mesh, meta, seq_over_model=True)
        self.batch_shapes = {k: tuple(v.shape) for k, v in meta.items()}
        self.template = lm_init_caches(self.cfg, rows, max_len, "meta", mem_len)
        self.cache_specs = shd.cache_spec(mesh, self.template, rows, seq_over_model=True)
        rb = shd.block(self.batch_specs["tokens"], self.batch_shapes["tokens"], mesh,
                       self.coords)[0]
        self.row_block = (rb.start, rb.stop)
        self.local_rows = rb.stop - rb.start
        self.split = mctx.SeqSplit(self.groups.model, self.coords["model"], self.M, seq)

    # ---------------------------------------------------------- placement
    def _region(self, spec, shape):
        return shd.block(spec, shape, self.mesh, self.coords)

    def place_params(self, params) -> ParamBlocks:
        """This rank's blocks of a whole param tree, on the bundle's
        device (copies: the whole tree can go)."""
        memo, layout = {}, {}
        dev = self.bundle.device

        def rec(node, path):
            if id(node) in memo:
                return memo[id(node)]
            if isinstance(node, dict):
                out = {k: rec(v, path + (str(k),)) for k, v in node.items()}
            elif isinstance(node, (list, tuple)) and not hasattr(node, "_fields"):
                out = type(node)(rec(v, path + (str(i),)) for i, v in enumerate(node))
            elif torch.is_tensor(node):
                spec = shd.spec_for_param(tr.path_str(path), node, self.mesh)
                keep = shd.P(*([None] * node.dim()))
                if self.ep and path[-1] in _EXPERTS:
                    if spec[0] != "model":
                        raise ValueError(f"{tr.path_str(path)}: {node.shape[0]} experts do "
                                         f"not split over {self.M} model ranks")
                    keep = shd.P("model", None, None)
                sl = self._region(spec, node.shape)
                if shd._is_k_major(node):
                    out = node.t()[sl[1], sl[0]].to(dev, copy=True).contiguous().t()
                else:
                    out = node[sl].to(dev, copy=True).contiguous()
                layout[id(out)] = (spec, keep)
            else:
                out = node
            memo[id(node)] = out
            return out

        return ParamBlocks(rec(params, ()), layout)

    def place_batch(self, batch) -> dict:
        """This rank's block of a whole batch (``tokens`` (rows, seq - P),
        a vision config's ``patches``, an encoder-decoder's ``frames``), on
        the bundle's device."""
        out = {}
        for k, v in batch.items():
            t = v if torch.is_tensor(v) else torch.as_tensor(v)
            if tuple(t.shape) != self.batch_shapes[k]:
                raise ValueError(f"batch leaf {k!r}: {tuple(t.shape)}, the prefill's is "
                                 f"{self.batch_shapes[k]}")
            out[k] = t[self._region(self.batch_specs[k], t.shape)].to(self.bundle.device,
                                                                     copy=True)
        return out

    def init_caches(self):
        """A fresh pool's blocks for this rank, each leaf its init element."""
        dev = self.bundle.device

        def one(path, leaf, spec):
            shape = [s.stop - s.start for s in self._region(spec, leaf.shape)]
            return torch.full(shape, _CACHE_FILL.get(path[-1], 0), dtype=leaf.dtype,
                              device=dev)
        return tr.map_with_path(one, self.template, self.cache_specs)

    # ------------------------------------------------------------ running
    def _regions(self, caches) -> dict:
        """``SeqSplit.regions`` of this rank's cache blocks: each leaf's
        block, checked against ``cache_spec``'s, its rows as the rank's
        own."""
        regions = {}

        def one(path, blk, leaf, spec):
            sl = list(self._region(spec, leaf.shape))
            shape = tuple(s.stop - s.start for s in sl)
            if tuple(blk.shape) != shape:
                raise ValueError(f"cache block {tr.path_str(path)}: {tuple(blk.shape)}, "
                                 f"this rank's block is {shape}")
            ba = 1 if path[0] == "blocks" else 0
            if (sl[ba].start, sl[ba].stop) != self.row_block:
                raise ValueError(f"cache block {tr.path_str(path)} holds rows {sl[ba]}, "
                                 f"the batch's block rows {self.row_block}")
            sl[ba] = slice(0, self.local_rows)
            regions[blk.untyped_storage()._cdata] = (tuple(sl), tuple(leaf.shape))
        tr.map_with_path(one, caches, self.template, self.cache_specs)
        return regions

    def _gather(self, sub, layout):
        """``sub`` (a subtree of the rank's blocks) with every split leaf
        whole (an expert stack its expert block), one all-gather over the
        world a dtype; shared nodes stay shared."""
        found: dict = {}

        def walk(node):
            if isinstance(node, dict):
                for v in node.values():
                    walk(v)
            elif isinstance(node, (list, tuple)) and not hasattr(node, "_fields"):
                for v in node:
                    walk(v)
            elif torch.is_tensor(node) and any(e is not None for e in layout[id(node)][0]):
                found[id(node)] = node
        walk(sub)
        keys = list(found)
        whole = shd.gather_whole([found[k] for k in keys], [layout[k][0] for k in keys],
                                 [layout[k][1] for k in keys], self.mesh, self.groups)
        got = dict(zip(keys, whole))
        memo: dict = {}

        def rebuild(node):
            if id(node) in memo:
                return memo[id(node)]
            if isinstance(node, dict):
                out = {k: rebuild(v) for k, v in node.items()}
            elif isinstance(node, (list, tuple)) and not hasattr(node, "_fields"):
                out = type(node)(rebuild(v) for v in node)
            else:
                out = got.get(id(node), node)
            memo[id(node)] = out
            return out
        return rebuild(sub)

    def _work(self, params: ParamBlocks) -> dict:
        """The param tree the model reads: the layer lists a pattern block
        at a time, everything else whole from the start."""
        def gather(sub):
            return self._gather(sub, params.layout)
        out = {}
        for k, v in params.tree.items():
            if k in ("head", "tail", "enc_blocks"):
                out[k] = _Blockwise(v, 1, gather)
            elif k == "blocks":
                out[k] = _Blockwise(v, len(self.cfg.pattern), gather)
            else:
                out[k] = gather(v)
        return out

    def _rank_batch(self, batch) -> dict:
        """The block's inputs from this rank's block of the batch: the text
        and patch rows of its block of the sequence (gathered over the model
        group first where the batch's split is not the sequence's), and
        every frame."""
        g, s = self.groups, self.split
        a, b = s.start, s.start + s.size
        P_ = self.patches

        def whole(k):
            t = batch[k]
            return coll.all_gather(t, g.model, dim=1) if self.batch_specs[k][1] == "model" \
                else t

        out = {}
        if P_ == 0 and self.batch_specs["tokens"][1] == "model":
            out["tokens"] = batch["tokens"]
        else:
            out["tokens"] = whole("tokens")[:, max(a - P_, 0):max(b - P_, 0)]
        if P_:
            out["patches"] = whole("patches")[:, min(a, P_):min(b, P_)]
        if "frames" in batch:
            out["frames"] = whole("frames")
        return out

    @torch.no_grad()
    def __call__(self, params: ParamBlocks, batch, caches):
        """Prefill this rank's block into its cache blocks ``caches`` (in
        place); returns the logits (rows, vocab) of every row's last token,
        alike on every rank."""
        g = self.groups
        dp = shd.dp_axes(self.mesh)
        split = dataclasses.replace(self.split, regions=self._regions(caches))
        ctx = mctx.DistContext(mesh=self.mesh, token_axes=dp + ("model",), expert_axis="model",
                               data_axes=dp, model_axis="model", groups=g, seq=split)
        work = self._work(params)
        with mctx.use_context(ctx):
            logits, _ = self.bundle.prefill_split(work, self._rank_batch(batch), caches)
        del work
        if self.local_rows != self.rows:        # rows over 'data': every replica's
            logits = coll.all_gather(logits, g.data)
        return logits


__all__ = ["ParamBlocks", "SeqPrefill"]
