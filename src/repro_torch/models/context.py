"""Distribution context for model code (port of ``repro/models/context.py``).

Two independent contexts exist, as in the reference.  Model functions read
an ambient ``DistContext`` set by a launcher (``launch/train.py``, from
``train_step.dist_context_for(mesh)``); with none set every layer runs its
local path.  A set context runs the MoE FFN expert-parallel over the
mesh's 'model' axis, through ``groups`` (``launch/mesh.MeshGroups``: this
rank's coordinates and its world, data and model groups).  The serving TP
context is ``kernels/ops.tp_shard``, which the sharded serve engine sets
around each replica's launches; it runs with ``DistContext`` unset, so MoE
stays replica-local.

A context whose ``seq`` is a ``SeqSplit`` runs one rank of a
sequence-parallel prefill (``serve/seq_parallel.py``, the reference's opt
prefill): the rank holds the block ``[start, start + size)`` of each of its
rows' whole sequence, and each layer's prefill reads the split - attention
gathers K/V over the model group, the SSD carries its state from the
earlier blocks, the routed FFN regroups its tokens - and lands its own
region of every cache leaf (``SeqSplit.region``).

The reference's ``shard_map`` has no counterpart: it runs a body on every
device's block of its inputs, and here every rank is one process that
already runs the body on its own block.  ``moe_param_specs`` names the
blocks: the routed experts' E axis over the expert axis, the router whole.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any

from repro_torch.distributed.sharding import P


@dataclasses.dataclass(frozen=True)
class SeqSplit:
    """One rank's share of a sequence-parallel prefill: block ``index`` of
    ``parts`` equal blocks of a ``length``-long sequence, over ``group``
    (the model group; None for one rank).  ``regions`` maps a cache
    block's storage (``untyped_storage()._cdata``: a stacked leaf and each
    layer's view of it share one) to (its region of the whole leaf, one
    slice a dim - the rows as the rank's own, whole -, the whole leaf's
    shape)."""
    group: Any
    index: int
    parts: int
    length: int
    regions: dict = dataclasses.field(default_factory=dict, compare=False)

    @property
    def size(self) -> int:
        return self.length // self.parts

    @property
    def start(self) -> int:
        return self.index * self.size

    def region(self, t) -> tuple[tuple[slice, ...], tuple[int, ...]]:
        """(slices, whole shape) of cache block ``t``'s last ``t.dim()``
        dims: a layer's view of a stacked leaf drops its leading dims."""
        sl, shape = self.regions[t.untyped_storage()._cdata]
        n = t.dim()
        return sl[len(sl) - n:], shape[len(shape) - n:]


@dataclasses.dataclass(frozen=True)
class DistContext:
    mesh: Any                          # the device mesh
    token_axes: tuple[str, ...]        # mesh axes sharding flattened tokens for MoE
    expert_axis: str                   # mesh axis experts are sharded over ('model')
    data_axes: tuple[str, ...] = ("data",)
    model_axis: str = "model"
    groups: Any = None                 # launch/mesh.MeshGroups of this rank
    seq: SeqSplit | None = None        # a sequence-parallel prefill's split


_CTX: DistContext | None = None


def set_context(ctx: DistContext | None) -> None:
    global _CTX
    _CTX = ctx


def get_context() -> DistContext | None:
    return _CTX


def seq_split() -> SeqSplit | None:
    """The ambient sequence-parallel prefill's split, or None."""
    return None if _CTX is None else _CTX.seq


@contextlib.contextmanager
def use_context(ctx: DistContext | None):
    global _CTX
    prev = _CTX
    _CTX = ctx
    try:
        yield
    finally:
        _CTX = prev


def moe_param_specs(p) -> Any:
    """The routed-MoE param subtree's blocks under the context: each
    rank's expert stacks hold its own E / M experts."""
    return {
        "router": P(None, None),
        "we_gate": P(_CTX.expert_axis, None, None),
        "we_up": P(_CTX.expert_axis, None, None),
        "we_down": P(_CTX.expert_axis, None, None),
    }
