"""Distribution context for model code (port of ``repro/models/context.py``,
as far as one device needs it).

Model functions read an ambient ``DistContext`` set by a launcher or a
train-step builder; with none set (one device: every run the port makes
today) every layer runs its local path.  A set context asks for expert
parallelism over a mesh, which is ROADMAP.md Queue 1 item 8: the MoE FFN
refuses it with ``not_ported``.  The reference's ``shard_map``,
``moe_param_specs`` and ``tp_shard`` re-export belong to that item.
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
