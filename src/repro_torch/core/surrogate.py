"""Probabilistic surrogate of layer pre-activation moments (paper Sec. 4.1):
port of ``repro/core/surrogate.py``.

The surrogate assumes weights are i.i.d. Gaussian, W_ij ~ N(mu_W, sigma_W^2)
(per-tensor) or per output channel (per-channel).  Then for y = W x:

    E[y_j]   = mu_W[j]      * sum_i x_i        (Eq. 8)
    Var[y_j] = sigma_W[j]^2 * sum_i x_i^2      (Eq. 9)

so a single O(d) pass over the *input* prices the whole output's dynamic
range - the output never needs to be materialized at higher precision.

For convolutions, per-output-position estimates come from windowed sums of x
and x^2 (Eqs. 10-11).  The reference convolves the channel-summed input with
a ones kernel; here the same sums are exact f32 sum-pools
(``avg_pool2d(..., divisor_override=1)`` over the SAME-padded input), which
no cuDNN TF32 setting can reach.  Per-position / per-token estimates are
aggregated into per-tensor or per-channel statistics with the law of total
variance (Eq. 12; see DESIGN.md for the typo reconciliation):

    E[y]   = mean_pos E[y_pos]
    Var[y] = mean_pos Var[y_pos] + mean_pos (E[y_pos] - E[y])^2

The ``gamma`` *sampling stride* subsamples positions entering the estimate -
quadratic cost reduction for conv feature maps, linear for token sequences.

Layout is the reference's at every boundary: NHWC inputs, HWIO weights,
channels last.  Variances are population variances (ddof 0, as ``jnp.var``).
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F


class Moments(NamedTuple):
    """Predicted output moments. Shapes:

    per-tensor:  mean/var are (batch,)            - one interval per example
    per-channel: mean/var are (batch, channels)   - one interval per channel
    """

    mean: torch.Tensor
    var: torch.Tensor

    @property
    def std(self) -> torch.Tensor:
        return torch.sqrt(self.var.clamp(min=0.0))


class WeightStats(NamedTuple):
    """Offline per-layer weight statistics (computed once at deploy time)."""

    mu: torch.Tensor   # () per-tensor or (out_channels,) per-channel
    var: torch.Tensor  # same shape
    fan_in: int


def weight_stats(w: torch.Tensor, reduce_axes: tuple[int, ...],
                 per_channel: bool) -> WeightStats:
    """Gaussian fit of the weights. ``reduce_axes`` are the fan-in axes.

    For a linear layer with w of shape (d, h), reduce_axes=(0,) keeps the
    output-channel axis.  per_channel=False additionally pools channels.
    """
    axes = tuple(range(w.ndim)) if not per_channel else tuple(reduce_axes)
    mu = w.mean(dim=axes)
    var = w.var(dim=axes, correction=0)
    fan_in = 1
    for a in reduce_axes:
        fan_in *= w.shape[a]
    return WeightStats(mu=mu, var=var, fan_in=int(fan_in))


def _aggregate(mean_pos: torch.Tensor, var_pos: torch.Tensor,
               axes: tuple[int, ...]) -> Moments:
    """Law-of-total-variance aggregation over position axes (Eq. 12)."""
    mean = mean_pos.mean(dim=axes, keepdim=True)
    var = var_pos.mean(dim=axes) + ((mean_pos - mean) ** 2).mean(dim=axes)
    return Moments(mean=mean.squeeze(axes), var=var)


# ---------------------------------------------------------------------------
# Linear / token-stack layers (Eqs. 8-9)
# ---------------------------------------------------------------------------


def linear_moments(
    x: torch.Tensor,
    ws: WeightStats,
    per_channel: bool,
    gamma: int = 1,
) -> Moments:
    """Surrogate moments of y = x @ W for x of shape (batch, ..., d).

    Any axes between batch and the feature axis are "positions" (tokens,
    pixels); ``gamma`` subsamples them with a stride.  Cost: O(d) per sampled
    position, independent of the output width h - this is the paper's
    headline complexity result.
    """
    if x.ndim > 2 and gamma > 1:
        x = x[:, ::gamma]
    s1 = x.sum(-1)                            # (batch, pos...)
    s2 = x.square().sum(-1)                   # (batch, pos...)
    pos_axes = tuple(range(1, s1.ndim))
    if per_channel:
        mean_pos = s1[..., None] * ws.mu      # (batch, pos..., h)
        var_pos = s2[..., None] * ws.var
    else:
        mean_pos = s1 * ws.mu                 # scalar weight stats
        var_pos = s2 * ws.var
    if pos_axes:
        return _aggregate(mean_pos, var_pos, pos_axes)
    return Moments(mean=mean_pos, var=var_pos)


# ---------------------------------------------------------------------------
# Convolutions (Eqs. 10-11), NHWC layout
# ---------------------------------------------------------------------------


def same_pad(n: int, k: int, s: int) -> tuple[int, int]:
    """XLA's SAME padding of one spatial axis: (low, high) such that the
    output has ceil(n / s) positions; the odd element goes high.  With a
    stride past the window the total can come out negative: it is 0."""
    out = -(-n // s)
    total = max((out - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def pad2d(x: torch.Tensor, kernel_hw, strides, padding: str) -> torch.Tensor:
    """Zero-pad an NCHW tensor as ``lax.conv_general_dilated`` would for
    ``padding`` ('SAME' or 'VALID') before a window op with no padding."""
    if padding == "VALID":
        return x
    if padding != "SAME":
        raise ValueError(f"padding must be 'SAME' or 'VALID', got {padding!r}")
    (ht, hb), (wl, wr) = (same_pad(x.shape[2], kernel_hw[0], strides[0]),
                          same_pad(x.shape[3], kernel_hw[1], strides[1]))
    return F.pad(x, (wl, wr, ht, hb)) if ht or hb or wl or wr else x


def _window_sums(x: torch.Tensor, kernel_hw, strides, padding) -> torch.Tensor:
    """Per-channel window sums of an NCHW tensor: an exact f32 sum-pool."""
    return F.avg_pool2d(pad2d(x, kernel_hw, strides, padding), tuple(kernel_hw),
                        tuple(strides), divisor_override=1)


def conv_window_sums(
    x: torch.Tensor,
    kernel_hw: tuple[int, int],
    stride: tuple[int, int],
    padding: str,
    gamma: int = 1,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Windowed sums S1 = sum_window x and S2 = sum_window x^2, NHWC input.

    Channel-independent: we first pool channels, then sum each window.
    ``gamma`` multiplies the stride (the paper's sampling stride: positions
    sampled drop as gamma^-2).
    """
    strides = (stride[0] * gamma, stride[1] * gamma)
    xs = torch.stack([x.sum(-1), x.square().sum(-1)], 1)     # (N, 2, H, W)
    s = _window_sums(xs, kernel_hw, strides, padding)
    return s[:, 0], s[:, 1]                                  # (N, H', W')


def conv_moments(
    x: torch.Tensor,
    ws: WeightStats,
    kernel_hw: tuple[int, int],
    stride: tuple[int, int],
    padding: str,
    per_channel: bool,
    gamma: int = 1,
) -> Moments:
    """Surrogate moments for conv pre-activations (Eqs. 10-12)."""
    s1, s2 = conv_window_sums(x, kernel_hw, stride, padding, gamma)  # (N, H', W')
    if per_channel:
        mean_pos = s1[..., None] * ws.mu   # (N, H', W', C_out)
        var_pos = s2[..., None] * ws.var
    else:
        mean_pos = s1 * ws.mu
        var_pos = s2 * ws.var
    return _aggregate(mean_pos, var_pos, (1, 2))


def empirical_moments(y: torch.Tensor, per_channel: bool) -> Moments:
    """Ground-truth moments of an observed pre-activation tensor.

    Used by tests / calibration to validate the surrogate: y has shape
    (batch, pos..., channels).
    """
    axes = tuple(range(1, y.ndim - 1 if per_channel else y.ndim))
    return Moments(mean=y.mean(dim=axes), var=y.var(dim=axes, correction=0))


def depthwise_conv_moments(
    x: torch.Tensor,
    ws: WeightStats,
    kernel_hw: tuple[int, int],
    stride: tuple[int, int],
    padding: str,
    per_channel: bool,
    gamma: int = 1,
) -> Moments:
    """Surrogate moments for DEPTHWISE conv: output channel v sees only
    input channel v, so windowed sums are computed per channel (p=1 in
    Eqs. 10-11)."""
    strides = (stride[0] * gamma, stride[1] * gamma)
    C = x.shape[-1]
    xc = x.permute(0, 3, 1, 2)                                   # (N, C, H, W)
    s = _window_sums(torch.cat([xc, xc.square()], 1), kernel_hw, strides, padding)
    s1 = s[:, :C].permute(0, 2, 3, 1)                            # (N, H', W', C)
    s2 = s[:, C:].permute(0, 2, 3, 1)
    mean_pos = s1 * ws.mu          # (N, H', W', C) * () or (C,)
    var_pos = s2 * ws.var
    if per_channel:
        return _aggregate(mean_pos, var_pos, (1, 2))
    return _aggregate(mean_pos, var_pos, (1, 2, 3))
