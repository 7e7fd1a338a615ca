"""Public model API (port of the serving half of ``repro/models/api.py``).

``build_model(cfg, device)`` returns a bundle of step functions on one
device.  Unlike the reference's pure functions they update the caches they
are given IN PLACE and return them: the serving pool is landed into and
decoded over without copies.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.kernels import ops as kernel_ops

from .config import ArchConfig
from .transformer import lm_apply, lm_init, lm_init_caches, lm_logits


def resolve_device(device) -> torch.device:
    """The entry points' device policy: CUDA unless the caller asks for the
    CPU, and an error - not a silent CPU run - when CUDA is absent."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run "
                           "the port's plain versions on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    return dev


@dataclasses.dataclass(frozen=True)
class ModelBundle:
    cfg: ArchConfig
    device: torch.device
    init: Callable[..., Any]
    init_caches: Callable[..., Any]
    prefill: Callable[..., Any]
    prefill_many: Callable[..., Any]
    decode_step: Callable[..., Any]
    cache_scatter: Callable[..., Any]


def build_model(cfg: ArchConfig, device="cuda") -> ModelBundle:
    cfg = cfg.validate()
    dev = resolve_device(device)

    def init(seed: int = 0):
        """Random params from a seeded ``torch.Generator`` on the device."""
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        return lm_init(gen, cfg)

    def init_caches(batch: int, max_len: int):
        return lm_init_caches(cfg, batch, max_len, dev)

    def _positions(B, L):
        return torch.arange(L, dtype=torch.int32, device=dev)[None].expand(B, L)

    @torch.no_grad()
    def prefill(params, batch, caches):
        """Unpadded prefill: logits (B, vocab) of each row's last token."""
        tokens = batch["tokens"]
        h, caches = lm_apply(params, cfg, tokens=tokens,
                             positions=_positions(*tokens.shape),
                             mode="prefill", caches=caches)
        return lm_logits(params, cfg, h[:, -1]), caches

    @torch.no_grad()
    def prefill_many(params, batch, caches, seq_lens):
        """Batched bucketed prefill over right-padded prompts: row b holds
        seq_lens[b] real tokens then padding to the bucket length L
        (seq_lens == 0 marks a dummy row).  Pad entries never reach the
        cache (attention._clamp_padded).  ``caches`` must be a fresh pool
        (``init_caches``); returns (logits (B, vocab) of each row's LAST
        REAL token, caches) - land the rows with ``cache_scatter``."""
        tokens = batch["tokens"]
        B, L = tokens.shape
        sl = seq_lens.to(torch.int32)
        h, caches = lm_apply(params, cfg, tokens=tokens,
                             positions=_positions(B, L), mode="prefill",
                             caches=caches, seq_lens=sl)
        last = torch.clamp_min(sl - 1, 0).long()
        h_last = h[torch.arange(B, device=dev), last]
        return lm_logits(params, cfg, h_last), caches

    @torch.no_grad()
    def decode_step(params, caches, tokens, positions):
        """tokens, positions: (B, 1) int32.  Returns (logits (B, vocab),
        caches)."""
        h, caches = lm_apply(params, cfg, tokens=tokens, positions=positions,
                             mode="decode", caches=caches)
        return lm_logits(params, cfg, h[:, -1]), caches

    def cache_scatter(caches, sub, src_map):
        """Pool slot s takes sub batch row src_map[s]; -1 keeps the slot.
        One kernel launch per cache leaf, in place on ``caches``."""
        scat = kernel_ops.cache_scatter_rows
        for c, s in zip(caches["blocks"], sub["blocks"]):
            for name in c:
                scat(c[name], s[name], src_map, batch_axis=1)
        return caches

    return ModelBundle(cfg=cfg, device=dev, init=init, init_caches=init_caches,
                       prefill=prefill, prefill_many=prefill_many,
                       decode_step=decode_step, cache_scatter=cache_scatter)
