"""Distribution context for model code (port of ``repro/models/context.py``).

Two independent contexts exist, as in the reference.  Model functions read
an ambient ``DistContext`` set by a launcher or a train-step builder; with
none set every layer runs its local path.  A set context asks for expert
parallelism over a mesh, which waits for ROADMAP.md Queue 1 item 8b: the
MoE FFN refuses it with ``not_ported``.  The serving TP context is
``kernels/ops.tp_shard``, which the sharded serve engine sets around each
replica's launches; it runs with ``DistContext`` unset, so MoE stays
replica-local.  The reference's ``shard_map`` and ``moe_param_specs``
belong to item 8b.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any


def not_ported(what: str, item: str) -> NotImplementedError:
    """The error of a feature the port has not reached yet, naming its
    ROADMAP.md item."""
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP.md Queue 1, item {item})")


@dataclasses.dataclass(frozen=True)
class DistContext:
    mesh: Any                          # the device mesh
    token_axes: tuple[str, ...]        # mesh axes sharding flattened tokens for MoE
    expert_axis: str                   # mesh axis experts are sharded over ('model')
    data_axes: tuple[str, ...] = ("data",)
    model_axis: str = "model"


_CTX: DistContext | None = None


def set_context(ctx: DistContext | None) -> None:
    global _CTX
    _CTX = ctx


def get_context() -> DistContext | None:
    return _CTX


@contextlib.contextmanager
def use_context(ctx: DistContext | None):
    global _CTX
    prev = _CTX
    _CTX = ctx
    try:
        yield
    finally:
        _CTX = prev
