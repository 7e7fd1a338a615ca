"""Architecture configuration schema (port of ``repro/models/config.py``).

The port carries the fields its families run: a decoder-only LM whose
layers are ``head`` (unrolled) + ``n_blocks`` repeats of ``pattern`` +
``tail``, each kind ``global`` (full attention, GQA or MLA; MoE FFN if
``moe``), ``global_dense`` (``global`` with a dense FFN always: DeepSeek's
layer 0), ``local`` (sliding-window attention over a ring of ``window``
positions), ``mamba`` (a Mamba2 SSD block, ``ssm``) or ``shared`` (zamba2's
shared block: one ``global`` layer's params reused at every occurrence,
each occurrence with its own KV cache), with gemma's softcaps and
embedding scale (the reference scans the stacked blocks; the port loops
over a per-layer list).  ``remat`` and ``loss_chunk`` shape train mode: a
block's activations recomputed in the backward (``"full"``) or kept, and
the positions of each chunk of the chunked cross-entropy.  ``family="encdec"`` adds ``enc_layers``
bidirectional encoder layers over stub frame embeddings and a
cross-attention block in every decoder layer; ``frontend="vision"``
prepends ``frontend_tokens`` stub patch embeddings to the text.
"""
from __future__ import annotations

import dataclasses

from .moe import MoEConfig
from .ssm import SSMConfig


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    q_lora: int
    kv_lora: int
    qk_nope: int = 128
    qk_rope: int = 64
    v_head: int = 128


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
    moe: MoEConfig | None = None
    mla: MLAConfig | None = None
    ssm: SSMConfig | None = None
    enc_layers: int = 0
    frontend: str | None = None            # 'audio' | 'vision' (stub embeddings)
    frontend_tokens: int = 0
    embed_scale: bool = False              # gemma: embeddings * sqrt(d_model)
    dtype: str = "bfloat16"
    remat: str = "full"                    # 'full' | 'save_heavy' | 'none' (train mode's block remat)
    long_context: bool = False             # may run the long_500k shape (launch/dryrun.py)
    quant_kv: str = "none"                 # 'none' | 'dynamic' (int8 KV cache)
    loss_chunk: int = 512                  # train loss: positions a logits chunk

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
        enc_layers=min(cfg.enc_layers, 2),
        frontend_tokens=min(cfg.frontend_tokens, 8),
        window=min(cfg.window, 16) if cfg.window else None,
        remat="none",
        loss_chunk=16,
        dtype="float32",
    )
    if cfg.moe:
        base["moe"] = dataclasses.replace(
            cfg.moe, n_experts=8, top_k=min(cfg.moe.top_k, 2), d_ff_expert=32,
            d_ff_dense=64 if (cfg.moe.n_shared or cfg.moe.dense_residual) else 0,
            capacity_factor=8.0)  # avoid capacity drops in tiny smoke tests
    if cfg.mla:
        base["mla"] = MLAConfig(q_lora=32, kv_lora=32, qk_nope=16, qk_rope=8, v_head=16)
    if cfg.ssm:
        base["ssm"] = SSMConfig(d_model=64, d_state=16, head_dim=16, expand=2,
                                d_conv=4, chunk=16)
    base.update(overrides)
    return dataclasses.replace(cfg, **base).validate()
