"""Serving layout over a mesh (port of ``repro/distributed/sharding.py``,
its serving part).

``process_replicas`` says which process hosts which replica.  The sharded
engine keeps one whole pool tree per replica rather than a view into one
global pool - K4-K7 and the decode graph need whole, fixed leaves - so the
reference's ``serve_pool_specs``, ``pool_shardings`` and ``make_global``,
which lay out and place one global pool of jax arrays, have no
counterpart.  ``_RULES``, ``param_specs``, ``batch_spec``, ``cache_spec``
and ``dp_axes`` are training rules (ROADMAP.md Queue 1, item 8b).
"""
from __future__ import annotations


def process_replicas(mesh) -> dict[int, list[int]]:
    """{process index: [replica, ...]} in replica order: replica r is mesh
    row r, hosted by the process of its first entry."""
    out: dict[int, list[int]] = {}
    for r in range(mesh.processes.shape[0]):
        out.setdefault(int(mesh.processes[r, 0]), []).append(r)
    return out


__all__ = ["process_replicas"]
