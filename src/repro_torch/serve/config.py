"""``ServeConfig`` + ``build_engine`` (port of ``repro/serve/config.py``).

One declarative record of a serving deployment; ``build_engine`` resolves
it to the single-device ``ServeEngine`` on ``device`` (the card unless the
caller asks for the CPU).  Options whose engines are not ported yet raise
``NotImplementedError`` naming their ROADMAP.md item.
"""
from __future__ import annotations

import dataclasses
from typing import Any

from .core import DEFAULT_BUCKETS


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Declarative description of one serving deployment."""

    # ---- model selection (used only when build_engine gets no cfg/params)
    arch: str = "stablelm-1.6b"
    reduced: bool = True            # reduced_config() vs full get_config()
    int8_kv: bool = False           # int8 KV cache (quant_kv='dynamic')

    # ---- engine knobs
    slots: int = 4
    max_len: int = 256
    quantize_weights: bool = False  # PDQ int8 weights in every layer
    temperature: float = 0.0
    seed: int | None = None         # sampling seed (None -> 0)
    buckets: tuple[int, ...] = DEFAULT_BUCKETS
    batch_prefill: bool = True
    chunked_prefill: bool = False
    decode_steps: int = 1
    fault: Any = None               # FaultInjector (tests only)
    pdq_fallback: bool = False
    mesh: Any = None                # multi-GPU serving (Queue 1 item 8)
    snapshot_path: str | None = None

    # ---- paged KV pool (Queue 1 item 3)
    paged: bool = False
    spill: bool = False

    # ---- telemetry (serve/telemetry.py)
    telemetry: bool = True
    trace: bool = False

    # ---- placement
    device: str = "cuda"


def resolve_model(config: ServeConfig):
    """(cfg, params) for ``config``'s model selection fields: random
    weights from a generator seeded 0 on ``config.device``."""
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.models import build_model

    cfg = (reduced_config(config.arch) if config.reduced
           else get_config(config.arch))
    if config.int8_kv:
        cfg = dataclasses.replace(cfg, quant_kv="dynamic")
    return cfg, build_model(cfg, config.device).init(0)


def build_engine(config: ServeConfig, *, cfg=None, params=None):
    """Construct the engine ``config`` describes; ``cfg``/``params``
    override the model selection fields when given (both or neither).
    ``int8_kv`` sets ``quant_kv='dynamic'`` on a given ``cfg`` too (the
    reference reads it only when it resolves the model itself)."""
    from repro_torch.models import resolve_device

    from .engine import ServeEngine, not_ported

    resolve_device(config.device)
    if config.mesh is not None:
        raise not_ported("multi-GPU serving", "8")
    if (cfg is None) != (params is None):
        raise ValueError("pass both cfg and params, or neither")
    if cfg is None:
        cfg, params = resolve_model(config)
    elif config.int8_kv:
        cfg = dataclasses.replace(cfg, quant_kv="dynamic")
    eng = ServeEngine(
        cfg, params, slots=config.slots, max_len=config.max_len,
        quantize_weights=config.quantize_weights,
        temperature=config.temperature, seed=config.seed,
        buckets=config.buckets, batch_prefill=config.batch_prefill,
        chunked_prefill=config.chunked_prefill,
        decode_steps=config.decode_steps, fault=config.fault,
        pdq_fallback=config.pdq_fallback, paged=config.paged,
        spill=config.spill, telemetry=config.telemetry, trace=config.trace,
        device=config.device)
    if config.snapshot_path:
        eng.snapshot_path = config.snapshot_path
    return eng
