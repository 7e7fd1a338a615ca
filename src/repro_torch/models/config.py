"""Architecture configuration schema (port of ``repro/models/config.py``).

The port carries the fields its slice runs: a decoder-only GQA LM whose
layers are ``n_blocks`` repeats of ``pattern`` (the reference scans the
stacked blocks; the port loops over a per-layer list).  The MoE, MLA, SSM,
encoder-decoder and frontend fields arrive with the model families that
use them (ROADMAP.md Queue 1).
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    family: str = "lm"
    head_dim: int | None = None
    head: tuple[str, ...] = ()
    pattern: tuple[str, ...] = ("global",)
    tail: tuple[str, ...] = ()
    window: int | None = None
    attn_softcap: float | None = None
    logit_softcap: float | None = None
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-6
    embed_scale: bool = False              # gemma: embeddings * sqrt(d_model)
    dtype: str = "bfloat16"
    quant_kv: str = "none"                 # 'none' | 'dynamic' (int8 KV cache)

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def n_blocks(self) -> int:
        n = self.n_layers - len(self.head) - len(self.tail)
        if n % len(self.pattern):
            raise ValueError(
                f"{self.name}: {n} layers not divisible by pattern {self.pattern}")
        return n // len(self.pattern)

    def validate(self) -> "ArchConfig":
        _ = self.n_blocks
        return self


def reduced(cfg: ArchConfig, **overrides) -> ArchConfig:
    """Smoke-test variant: same family/topology, tiny dims (the reference's
    ``reduced`` restricted to the fields above)."""
    base = dict(
        n_layers=len(cfg.head) + 2 * len(cfg.pattern) + len(cfg.tail),
        d_model=64,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2),
        d_ff=128,
        vocab=512,
        head_dim=16,
        window=min(cfg.window, 16) if cfg.window else None,
        dtype="float32",
    )
    base.update(overrides)
    return dataclasses.replace(cfg, **base).validate()
