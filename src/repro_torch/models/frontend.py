"""Modality frontend stubs (port of ``repro/models/frontend.py``).

The vision and audio configs specify the transformer backbone only: their
towers' outputs arrive as precomputed embeddings.  These helpers make such
embeddings for real (smoke, example) runs, drawn from an explicit
``torch.Generator`` on its own device; the numbers differ from JAX's draws,
so tests hand both frameworks the same numpy arrays instead.
"""
from __future__ import annotations

import torch

from .transformer import model_dtype

# the stub frames an encoder-decoder engine serves with (its ``mem_len``,
# as the reference's engine sets it)
N_FRAMES = 8


def _stub(gen: torch.Generator, shape, dtype) -> torch.Tensor:
    return (0.02 * torch.randn(shape, generator=gen, device=gen.device)).to(dtype)


def stub_patch_embeddings(gen: torch.Generator, batch: int, n_tokens: int, d_model: int,
                          dtype=torch.bfloat16) -> torch.Tensor:
    """Stands in for a CLIP-style vision tower's output (phi-3-vision):
    (batch, n_tokens, d_model), 0.02 * N(0, 1) in ``dtype``."""
    return _stub(gen, (batch, n_tokens, d_model), dtype)


def stub_frame_embeddings(gen: torch.Generator, batch: int, n_frames: int, d_model: int,
                          dtype=torch.bfloat16) -> torch.Tensor:
    """Stands in for a speech feature encoder's output (seamless-m4t):
    (batch, n_frames, d_model), 0.02 * N(0, 1) in ``dtype``."""
    return _stub(gen, (batch, n_frames, d_model), dtype)


def stub_extras(cfg, gen: torch.Generator, batch: int = 1) -> dict | None:
    """A run's prefill extras for ``cfg``'s stub frontend, in the model
    dtype on ``gen``'s device: ``cfg.frontend_tokens`` patch embeddings
    (vision) or N_FRAMES frame embeddings (an encoder-decoder); None for a
    text-only config."""
    if cfg.frontend == "vision":
        return {"patches": stub_patch_embeddings(gen, batch, cfg.frontend_tokens,
                                                 cfg.d_model, model_dtype(cfg))}
    if cfg.family == "encdec":
        return {"frames": stub_frame_embeddings(gen, batch, N_FRAMES, cfg.d_model,
                                                model_dtype(cfg))}
    return None
