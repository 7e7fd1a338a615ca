"""Asymmetric coverage intervals I(alpha, beta) and their calibration (Eq. 13):
port of ``repro/core/interval.py``.

The quantization range of a pre-activation tensor is taken to be

    I(alpha, beta) = [mu_y - alpha * sigma_y,  mu_y + beta * sigma_y]

with (mu_y, sigma_y) predicted by the surrogate (surrogate.py) per input.
(alpha, beta) are tuned once on a calibration set so that a target fraction
of the observed pre-activations falls inside I, then frozen (paper Sec. 4.1).

Calibration here uses the direct quantile method: with normalized deviations
u = (y - mu)/sigma pooled over the calibration set,

    alpha = -quantile(u, (1 - coverage)/2)
    beta  =  quantile(u, 1 - (1 - coverage)/2)

which is the smallest interval of the I(alpha,beta) family achieving the
coverage target on the calibration data - equivalent to (and cheaper than)
the paper's grid search over (alpha, beta).  The fitting is the reference's
numpy (float64, linear interpolation); it returns f32 tensors on the CPU.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .affine import QParams, qparams_from_range
from .surrogate import Moments

_SIGMA_FLOOR = 1e-8


class IntervalParams(NamedTuple):
    """Per-layer frozen (alpha, beta); 0-dim or (channels,) tensors."""

    alpha: torch.Tensor
    beta: torch.Tensor


def interval(moments: Moments, ip: IntervalParams) -> tuple[torch.Tensor, torch.Tensor]:
    """I(alpha, beta) bounds from predicted moments."""
    sigma = moments.std.clamp(min=_SIGMA_FLOOR)
    return moments.mean - ip.alpha * sigma, moments.mean + ip.beta * sigma


def qparams_from_interval(moments: Moments, ip: IntervalParams, bits: int = 8) -> QParams:
    """PDQ quantization parameters: Eq. (3) applied to I(alpha, beta).

    The scale tracks the *predicted dispersion* of this input's
    pre-activations; the zero-point tracks their predicted mean.
    """
    lo, hi = interval(moments, ip)
    return qparams_from_range(lo, hi, bits)


def coverage(y: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """Empirical coverage P(y in I) (Eq. 13).

    ``lo``/``hi`` must be broadcastable against y (per-example or
    per-example-per-channel intervals).
    """
    inside = (y >= lo) & (y <= hi)
    return inside.float().mean()


def _f32(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, np.float32))


def calibrate_alpha_beta(
    deviations: np.ndarray,
    target_coverage: float = 0.9995,
    channel_axis: int | None = None,
) -> IntervalParams:
    """Fit (alpha, beta) from pooled normalized deviations u = (y - mu)/sigma.

    ``deviations`` is the pooled array over the calibration set.  With
    ``channel_axis`` set, a per-channel (alpha, beta) pair is fit (all other
    axes pooled); otherwise a single scalar pair.
    """
    u = np.asarray(deviations, np.float64)
    tail = (1.0 - target_coverage) / 2.0
    if channel_axis is not None:
        u = np.moveaxis(u, channel_axis, -1).reshape(-1, u.shape[channel_axis])
        lo_q = np.quantile(u, tail, axis=0)
        hi_q = np.quantile(u, 1.0 - tail, axis=0)
    else:
        lo_q = np.quantile(u, tail)
        hi_q = np.quantile(u, 1.0 - tail)
    # alpha scales the *downward* extent; never collapse below a tiny margin.
    alpha = np.maximum(-lo_q, 1e-3)
    beta = np.maximum(hi_q, 1e-3)
    return IntervalParams(alpha=_f32(alpha), beta=_f32(beta))


def grid_search_alpha_beta(
    deviations: np.ndarray,
    target_coverage: float = 0.9995,
    grid: np.ndarray | None = None,
) -> IntervalParams:
    """Paper-literal grid search over symmetric-step (alpha, beta) values.

    Kept for fidelity / ablation; `calibrate_alpha_beta` is the default.
    Picks the narrowest interval whose empirical coverage >= target.
    """
    u = np.asarray(deviations, np.float64).ravel()
    if grid is None:
        grid = np.linspace(0.5, 12.0, 47)
    best = (np.inf, grid[-1], grid[-1])
    for a in grid:
        for b in grid:
            cov = np.mean((u >= -a) & (u <= b))
            if cov >= target_coverage and (a + b) < best[0]:
                best = (a + b, a, b)
    _, a, b = best
    return IntervalParams(alpha=_f32(a), beta=_f32(b))
