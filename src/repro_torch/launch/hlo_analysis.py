"""Per-rank costs of a step: matmul FLOPs and collective bytes (port of
``repro/launch/hlo_analysis.py``).

The reference re-derives a compiled program's costs from its partitioned
HLO text, scaling each while-loop body by its trip count.  PyTorch has no
HLO: this module reads the op trace instead, counting as the program runs
(under the dry run's ``FakeTensorMode``, ``launch/dryrun.py``, or on real
tensors), with two counters:

  * ``DotCounter``, a dispatch mode over the matmul aten ops (``mm``,
    ``bmm``, ``addmm``, ``baddbmm``, ``_int_mm``, ``mv``, ``dot``: what
    ``matmul``, ``linear`` and ``einsum`` lower to), 2 M N K FLOPs a
    product.  Autograd's backward ops pass through it too, and so does the
    forward that a checkpointed (remat) segment recomputes.
  * ``collective_counter``, a tap at the entry points of
    ``distributed/collectives.py``, by kind and by group, with the
    reference's byte model (all-reduce 2x its shape; all-gather its whole
    result; all-to-all its result).  The real mesh step's bytes go through
    the same entry points.

Python loops run every layer and every chunk one by one, so there is no
loop trip to scale: every count is already the whole step's.  Everything
is per rank (the program traced is one rank's).
"""
from __future__ import annotations

import contextlib
import dataclasses

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.distributed import collectives as coll

_aten = torch.ops.aten
# op -> index of its first matrix operand (M x K); the output gives M N
_DOTS = {_aten.mm.default: 0, _aten.bmm.default: 0, _aten._int_mm.default: 0,
         _aten.mv.default: 0, _aten.dot.default: 0, _aten.addmm.default: 1,
         _aten.baddbmm.default: 1}


@dataclasses.dataclass
class Costs:
    dot_flops: float = 0.0
    collective_bytes: dict = dataclasses.field(default_factory=dict)   # kind -> bytes
    group_bytes: dict = dataclasses.field(default_factory=dict)        # group -> kind -> bytes

    @property
    def total_collective_bytes(self) -> float:
        return float(sum(self.collective_bytes.values()))


class DotCounter(TorchDispatchMode):
    """Adds 2 M N K a matrix product run inside to ``costs.dot_flops``
    (K is the first matrix operand's last dim; M N the output's size)."""

    def __init__(self, costs: Costs | None = None):
        super().__init__()
        self.costs = Costs() if costs is None else costs

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        at = _DOTS.get(func)
        if at is not None:
            self.costs.dot_flops += 2.0 * out.numel() * args[at].shape[-1]
        return out


@contextlib.contextmanager
def collective_counter(groups=None, costs: Costs | None = None):
    """Count every collective of ``distributed/collectives`` run inside
    into a ``Costs`` (yielded): bytes by kind, and by group, a group named
    by ``groups``' field that holds it (a ``launch/mesh.MeshGroups``:
    ``world``, ``data``, ``model``), else ``other``."""
    costs = Costs() if costs is None else costs
    names = {} if groups is None else {
        id(getattr(groups, a)): a for a in ("world", "data", "model")
        if getattr(groups, a) is not None}

    def tap(kind, group, nbytes):
        costs.collective_bytes[kind] = costs.collective_bytes.get(kind, 0) + nbytes
        per = costs.group_bytes.setdefault(names.get(id(group), "other"), {})
        per[kind] = per.get(kind, 0) + nbytes

    coll.TAPS.append(tap)
    try:
        yield costs
    finally:
        coll.TAPS.remove(tap)


__all__ = ["Costs", "DotCounter", "collective_counter"]
