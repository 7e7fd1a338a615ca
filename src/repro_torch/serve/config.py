"""``ServeConfig`` + ``build_engine`` (port of ``repro/serve/config.py``).

One declarative record of a serving deployment; ``build_engine`` resolves
it to the right engine class, on ``device`` (the card unless the caller
asks for the CPU):

  * no ``mesh``                   -> ``ServeEngine`` (single device)
  * ``mesh``                      -> ``ShardedServeEngine``
  * ``mesh`` + ``multihost=True`` -> ``MultiHostServeEngine`` (the caller
    must already have joined the ``torch.distributed`` group,
    ``launch.mesh.init_distributed``)

A mesh's entries must all be of ``device``'s type.  ``ServeConfig.validate``
raises ``ValueError`` on the reference's inconsistent combinations.
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
    mesh: Any = None                # a launch.mesh Mesh -> sharded
    slots_per_replica: int | None = None   # mesh engines (default: slots)
    multihost: bool = False         # mesh + torch.distributed -> MultiHost
    launch_timeout: float | None = None    # multihost collective watchdog
    snapshot_path: str | None = None

    # ---- paged KV pool
    paged: bool = False
    page_size: int = 64
    pool_pages: int | None = None   # physical pages (None: parity + dump page)
    prefix_sharing: bool = True
    spill: bool = False             # host spill + warm restore

    # ---- telemetry (serve/telemetry.py)
    telemetry: bool = True
    trace: bool = False

    # ---- placement
    device: str = "cuda"

    def validate(self) -> "ServeConfig":
        if self.multihost and self.mesh is None:
            raise ValueError("multihost=True needs a mesh")
        if self.mesh is not None and self.spill:
            raise ValueError("host spill is single-device only")
        if self.paged and not self.batch_prefill:
            raise ValueError("the paged pool needs batch_prefill=True")
        return self


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

    config.validate()
    device = resolve_device(config.device)
    if config.mesh is not None:
        # a mesh is never moved to another device type quietly
        kinds = {d.type for d in config.mesh.devices.flat}
        if kinds != {device.type}:
            raise ValueError(f"the mesh's devices are {sorted(kinds)}, the config's "
                             f"device is {device.type!r}")
    if (cfg is None) != (params is None):
        raise ValueError("pass both cfg and params, or neither")
    if cfg is None:
        cfg, params = resolve_model(config)
    elif config.int8_kv:
        cfg = dataclasses.replace(cfg, quant_kv="dynamic")
    common = dict(max_len=config.max_len, quantize_weights=config.quantize_weights,
                  temperature=config.temperature, seed=config.seed,
                  buckets=config.buckets, chunked_prefill=config.chunked_prefill,
                  decode_steps=config.decode_steps, fault=config.fault,
                  pdq_fallback=config.pdq_fallback, paged=config.paged,
                  page_size=config.page_size, pool_pages=config.pool_pages,
                  prefix_sharing=config.prefix_sharing, telemetry=config.telemetry,
                  trace=config.trace)
    if config.mesh is None:
        from .engine import ServeEngine
        eng = ServeEngine(cfg, params, slots=config.slots,
                          batch_prefill=config.batch_prefill, spill=config.spill,
                          device=config.device, **common)
    else:
        spr = (config.slots_per_replica if config.slots_per_replica is not None
               else config.slots)
        if config.multihost:
            from .multihost import MultiHostServeEngine
            eng = MultiHostServeEngine(cfg, params, mesh=config.mesh, slots_per_replica=spr,
                                       launch_timeout=config.launch_timeout,
                                       snapshot_path=config.snapshot_path, **common)
        else:
            from .sharded import ShardedServeEngine
            eng = ShardedServeEngine(cfg, params, mesh=config.mesh,
                                     slots_per_replica=spr, **common)
    if config.snapshot_path and not config.multihost:
        eng.snapshot_path = config.snapshot_path
    return eng
