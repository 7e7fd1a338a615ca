"""Quantized layer execution: static / dynamic / PDQ output quantization
(port of ``repro/core/qlinear.py``).

Weights and pre-activations are fake-quantized in float (the reference's
emulation path, used for all its accuracy experiments; it has no integer
route here either, and ``QuantPolicy.integer_path`` is read by neither).

Layout is the reference's at every public boundary: NHWC inputs and
outputs, HWIO conv kernels, (d, h) dense weights, per-channel axes last,
tapes and moments of shape (B,) or (B, C).  Only ``F.conv2d`` sees NCHW /
OIHW, with XLA's SAME padding made explicit (``surrogate.pad2d``).  The
convolutions run in IEEE f32 on cuDNN's deterministic algorithms whatever
the caller's cuDNN settings (``fp32_convs``).

Layer calibration state is a plain dict of tensors per layer name:

    {'static_lo','static_hi'  : calibrated output range     (static mode)
     'alpha','beta'           : calibrated interval params  (pdq mode)}
"""
from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

from . import affine, interval, surrogate
from .policy import QuantPolicy

Tape = dict[str, Any]


def fp32_convs():
    """cuDNN without TF32 and on its deterministic algorithms, the caller's
    other cuDNN settings kept: the reference's f32 convolutions, whatever
    ``torch.backends.cudnn.allow_tf32`` says (PyTorch's default allows TF32
    for convolutions), and the same bits from run to run.  By default cuDNN
    may pick a backward algorithm that sums in a run-dependent order: two
    trainings in one process then part in every conv kernel's gradient
    (~1e-8 after one step, ~0.1 in the weights after 250 steps; NVIDIA H100
    80GB HBM3, ``tools/torch_cnn_determinism.py``)."""
    c = torch.backends.cudnn
    return c.flags(enabled=c.enabled, benchmark=c.benchmark, deterministic=True,
                   allow_tf32=False)


def _example_range(y: torch.Tensor, per_channel: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-example (and optionally per-channel, last axis) range, keepdims."""
    axes = tuple(range(1, y.ndim - 1 if per_channel else y.ndim))
    if not axes:                      # (B, C) per channel: each element alone
        return y, y
    return torch.amin(y, dim=axes, keepdim=True), torch.amax(y, dim=axes, keepdim=True)


def _broadcast_qp(qp: affine.QParams, y_ndim: int, per_channel: bool) -> affine.QParams:
    """Reshape per-example (B,) / per-example-channel (B, C) params so they
    broadcast against y of shape (B, pos..., C)."""
    def fix(a):
        if a.ndim == 0:
            return a
        if per_channel and a.ndim == 2:      # (B, C)
            shape = (a.shape[0],) + (1,) * (y_ndim - 2) + (a.shape[1],)
        else:                                 # (B,)
            shape = (a.shape[0],) + (1,) * (y_ndim - 1)
        return a.reshape(shape)

    return affine.QParams(fix(qp.scale), fix(qp.zero_point), qp.bits)


def bias_adjust(m: surrogate.Moments, b: torch.Tensor | None,
                per_channel: bool) -> surrogate.Moments:
    """Fold the bias into the predicted moments (E[y+b] = E[y] + b)."""
    if b is None:
        return m
    if per_channel:
        return surrogate.Moments(mean=m.mean + b, var=m.var)
    return surrogate.Moments(mean=m.mean + b.mean(), var=m.var + b.var(correction=0))


def quantize_weights(w: torch.Tensor, policy: QuantPolicy, channel_axis: int) -> torch.Tensor:
    """Deploy-time weight fake-quantization (all modes quantize weights)."""
    qp = affine.weight_qparams(w, bits=policy.bits,
                               channel_axis=channel_axis if policy.per_channel else None)
    return affine.fake_quant(w, qp)


def output_quantize(
    y: torch.Tensor,
    policy: QuantPolicy,
    state: dict[str, torch.Tensor] | None,
    moments: surrogate.Moments | None,
) -> torch.Tensor:
    """Apply the mode-dependent output (pre-activation) quantization."""
    if policy.mode == "none" or policy.mode == "observe":
        return y
    if policy.mode == "dynamic":
        # Requires the fully materialized y: the O(b'·h) overhead baseline.
        lo, hi = _example_range(y, policy.per_channel)
        qp = affine.qparams_from_range(lo, hi, policy.bits)
        return affine.fake_quant(y, qp)
    if policy.mode == "static":
        qp = affine.qparams_from_range(state["static_lo"], state["static_hi"], policy.bits)
        return affine.fake_quant(y, qp)
    if policy.mode == "pdq":
        ip = interval.IntervalParams(alpha=state["alpha"], beta=state["beta"])
        qp = interval.qparams_from_interval(moments, ip, policy.bits)
        return affine.fake_quant(y, _broadcast_qp(qp, y.ndim, policy.per_channel))
    raise ValueError(f"unknown mode {policy.mode}")


# ---------------------------------------------------------------------------
# Dense
# ---------------------------------------------------------------------------


def dense(
    x: torch.Tensor,
    w: torch.Tensor,                   # (d, h)
    b: torch.Tensor | None,
    *,
    name: str,
    policy: QuantPolicy,
    state: dict[str, Any] | None = None,
    tape: Tape | None = None,
) -> torch.Tensor:
    """Quantized dense pre-activation y = x @ w + b, x: (B, ..., d)."""
    if policy.mode == "none":
        y = x @ w
        return y + b if b is not None else y

    wq = quantize_weights(w, policy, channel_axis=1)
    y = x @ wq
    if b is not None:
        y = y + b

    moments = None
    if policy.mode in ("pdq", "observe"):
        ws = surrogate.weight_stats(wq, reduce_axes=(0,), per_channel=policy.per_channel)
        moments = surrogate.linear_moments(x, ws, policy.per_channel, policy.gamma)
        moments = bias_adjust(moments, b, policy.per_channel)

    if tape is not None:
        tape[name] = {"kind": "dense", "y": y, "moments": moments}
    return output_quantize(y, policy, state.get(name) if state else None, moments)


# ---------------------------------------------------------------------------
# Conv (NHWC x HWIO -> NHWC)
# ---------------------------------------------------------------------------


def conv2d(
    x: torch.Tensor,                   # (N, H, W, C_in)
    k: torch.Tensor,                   # (kh, kw, C_in / groups, C_out)
    b: torch.Tensor | None,
    *,
    stride: tuple[int, int] = (1, 1),
    padding: str = "SAME",
    feature_group_count: int = 1,
    name: str,
    policy: QuantPolicy,
    state: dict[str, Any] | None = None,
    tape: Tape | None = None,
) -> torch.Tensor:
    """Quantized conv pre-activation."""
    x_nchw = surrogate.pad2d(x.permute(0, 3, 1, 2), k.shape[:2], stride, padding)

    def do_conv(kk):
        with fp32_convs():
            y = F.conv2d(x_nchw, kk.permute(3, 2, 0, 1), stride=tuple(stride),
                         groups=feature_group_count)
        y = y.permute(0, 2, 3, 1)
        return y + b if b is not None else y

    if policy.mode == "none":
        return do_conv(k)

    kq = quantize_weights(k, policy, channel_axis=3)
    y = do_conv(kq)

    moments = None
    if policy.mode in ("pdq", "observe"):
        ws = surrogate.weight_stats(kq, reduce_axes=(0, 1, 2), per_channel=policy.per_channel)
        if feature_group_count > 1 and feature_group_count == x.shape[-1]:
            # Depthwise: each output channel sees only its own input channel,
            # so the windowed sums must stay channel-separate (Eq. 10-11 with
            # p=1 per channel).
            moments = surrogate.depthwise_conv_moments(
                x, ws, k.shape[:2], stride, padding, policy.per_channel,
                policy.gamma)
        else:
            if feature_group_count > 1:
                frac = k.shape[2] / x.shape[-1]
                ws = surrogate.WeightStats(mu=ws.mu * frac, var=ws.var * frac,
                                           fan_in=ws.fan_in)
            moments = surrogate.conv_moments(x, ws, k.shape[:2], stride,
                                             padding, policy.per_channel,
                                             policy.gamma)
        moments = bias_adjust(moments, b, policy.per_channel)

    if tape is not None:
        tape[name] = {"kind": "conv", "y": y, "moments": moments}
    return output_quantize(y, policy, state.get(name) if state else None, moments)


def quantize_input(
    x: torch.Tensor,
    *,
    name: str = "input",
    policy: QuantPolicy,
    state: dict[str, Any] | None = None,
    tape: Tape | None = None,
) -> torch.Tensor:
    """Model-input quantizer (static range; all modes share it)."""
    if policy.mode == "none":
        return x
    if tape is not None:
        tape[name] = {"kind": "input", "y": x, "moments": None}
    if policy.mode == "observe" or state is None or name not in state:
        return x
    qp = affine.qparams_from_range(state[name]["static_lo"], state[name]["static_hi"],
                                   policy.bits)
    return affine.fake_quant(x, qp)
