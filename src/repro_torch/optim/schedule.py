"""Learning-rate schedules, pure functions of the step (port of
``repro/optim/schedule.py``): a 0-dim float32 tensor on the step's device,
computed in float32 as the reference's ``jnp`` does."""
from __future__ import annotations

import math

import torch

from repro_torch.kernels.ref import true_div


def _f32(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def warmup_cosine(step, *, warmup: int = 100, total: int = 10_000,
                  min_frac: float = 0.1):
    step = _f32(step)
    warm = torch.clamp_max(true_div(step, float(max(warmup, 1))), 1.0)
    prog = torch.clamp(true_div(step - warmup, float(max(total - warmup, 1))), 0.0, 1.0)
    cos = min_frac + (1 - min_frac) * 0.5 * (1 + torch.cos(math.pi * prog))
    return warm * cos


def constant(step, *, value: float = 1.0):
    return torch.full((), value, dtype=torch.float32, device=torch.as_tensor(step).device)
