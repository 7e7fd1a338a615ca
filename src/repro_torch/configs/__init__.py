"""Architecture registry: ``get_config('<arch-id>')``.

Only the families the port runs are registered; the others join with their
slice (ROADMAP.md Queue 1, item 8).
"""
from __future__ import annotations

import importlib

_MODULES = {
    "stablelm-1.6b": "stablelm_1p6b",
}

ALL_ARCHS = tuple(_MODULES)


def get_config(name: str):
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")
    return mod.CONFIG.validate()


def reduced_config(name: str, **overrides):
    from repro_torch.models.config import reduced
    return reduced(get_config(name), **overrides)
