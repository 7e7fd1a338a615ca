"""Uniform affine quantization primitives (paper Eqs. 1-4): port of
``repro/core/affine.py``.

Convention note: the paper's Eq. (3) computes ``z = -round(m/s) - 2^{b-1}``
(a *signed*-grid zero point, matching the CMSIS-NN ``_s8`` kernels the paper
wraps) while Eq. (1) clamps to the unsigned range ``[0, 2^b - 1]``.  The two
are inconsistent as written; we follow the signed-grid convention throughout
(grid ``[-2^{b-1}, 2^{b-1} - 1]``), which makes Q(m) = -2^{b-1} and
Q(M) = 2^{b-1} - 1 exact.  Symmetric quantization is the special case z = 0.

Rounding is half to even (``torch.round``, as ``jnp.round``), and every
division is IEEE division: a division by a Python number goes through
``kernels.ref.true_div`` (PyTorch's CUDA division by a number multiplies by
its reciprocal).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels.ref import true_div

_EPS = 1e-12


class QParams(NamedTuple):
    """Affine quantization parameters.

    ``scale`` / ``zero_point`` (int32) are either 0-dim (per-tensor) or
    broadcastable against the tensor being quantized (per-channel).
    """

    scale: torch.Tensor
    zero_point: torch.Tensor
    bits: int = 8

    @property
    def qmin(self) -> int:
        return -(2 ** (self.bits - 1))

    @property
    def qmax(self) -> int:
        return 2 ** (self.bits - 1) - 1


def storage_dtype(bits: int):
    return torch.int8 if bits <= 8 else torch.int32


def qparams_from_range(m: torch.Tensor, M: torch.Tensor, bits: int = 8) -> QParams:
    """Paper Eq. (3): scale / zero-point from an observed [m, M] range."""
    m = m.clamp(max=0.0)  # range must include 0 so that 0 is exactly representable
    M = M.clamp(min=0.0)
    scale = true_div(M - m, 2**bits - 1).clamp(min=_EPS)
    zero_point = (-torch.round(m / scale) - 2 ** (bits - 1)).to(torch.int32)
    return QParams(scale=scale, zero_point=zero_point, bits=bits)


def symmetric_qparams_from_amax(amax: torch.Tensor, bits: int = 8) -> QParams:
    """Symmetric special case: z = 0, scale from the absolute max."""
    scale = true_div(amax.clamp(min=_EPS), 2 ** (bits - 1) - 1)
    return QParams(scale=scale, zero_point=torch.zeros_like(scale, dtype=torch.int32),
                   bits=bits)


def quantize(x: torch.Tensor, qp: QParams) -> torch.Tensor:
    """Paper Eq. (1): clamp(round(x / s) + z, qmin, qmax)."""
    q = torch.round(x / qp.scale) + qp.zero_point
    return q.clamp(qp.qmin, qp.qmax).to(storage_dtype(qp.bits))


def dequantize(q: torch.Tensor, qp: QParams, dtype=torch.float32) -> torch.Tensor:
    """Paper Eq. (4): x ~= s * (q - z)."""
    return (q.to(torch.int32) - qp.zero_point).to(dtype) * qp.scale.to(dtype)


def fake_quant(x: torch.Tensor, qp: QParams) -> torch.Tensor:
    """Quantize-dequantize roundtrip (simulated integer inference)."""
    return dequantize(quantize(x, qp), qp, dtype=x.dtype)


def _reduce_axes(ndim: int, channel_axis: int | None):
    if channel_axis is None:
        return tuple(range(ndim))
    channel_axis = channel_axis % ndim
    return tuple(a for a in range(ndim) if a != channel_axis)


def range_of(x: torch.Tensor, channel_axis: int | None = None
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """(min, max) per-tensor (channel_axis=None) or per-channel (keepdims)."""
    axes = _reduce_axes(x.ndim, channel_axis)
    keep = channel_axis is not None
    return torch.amin(x, dim=axes, keepdim=keep), torch.amax(x, dim=axes, keepdim=keep)


def dynamic_qparams(x: torch.Tensor, bits: int = 8,
                    channel_axis: int | None = None) -> QParams:
    """Dynamic quantization parameters: measure the range of ``x`` on the fly.

    This is the paper's "dynamic" baseline - it requires ``x`` to be fully
    materialized before its range is known (the O(b' * h) memory overhead the
    paper's method removes).
    """
    m, M = range_of(x, channel_axis)
    return qparams_from_range(m, M, bits)


def weight_qparams(w: torch.Tensor, bits: int = 8,
                   channel_axis: int | None = None) -> QParams:
    """Weights are always quantized offline (both paper baselines and ours)."""
    return dynamic_qparams(w, bits=bits, channel_axis=channel_axis)
