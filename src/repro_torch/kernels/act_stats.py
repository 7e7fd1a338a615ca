"""Input-moment reduction (kernel K8): port of ``repro/kernels/act_stats.py``.

One pass over the activation rows gives ``s1 = sum x`` and ``s2 = sum
x^2`` per row (paper Eqs. 8-9), the whole cost of the PDQ surrogate for a
linear layer when the projection is not fused with its prologue.  The CUDA
kernel is ``csrc/act_stats.cu``; its note says what bounds it and how it is
laid out.  The plain version is ``ref.act_stats_ref``.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build, ref

COUNT = _build.OpCount()
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIG = {"act_stats": [_P, _I, _P, _P, _L, _L, _L, _L, _I, _P]}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_ROWS = 2 ** 31 - 1                 # the kernel's grid x extent

act_stats_plain = ref.act_stats_ref


def row_layout(x: torch.Tensor):
    """How the kernel addresses the rows of x (M, K) or (B, T, K), whose
    last axis is contiguous: (rows, inner, outer_stride, inner_stride, K),
    row r starting (r // inner) * outer_stride + (r % inner) * inner_stride
    elements past x's first element."""
    if x.dim() not in (2, 3) or (x.shape[-1] > 1 and x.stride(-1) != 1):
        raise ValueError(f"act_stats takes (M, K) or (B, T, K) with a contiguous "
                         f"last axis, got {tuple(x.shape)} strides {x.stride()}")
    x3 = x if x.dim() == 3 else x[None]
    outer, inner, K = x3.shape
    return outer * inner, max(inner, 1), x3.stride(0), x3.stride(1), K


def act_stats_cuda(x: torch.Tensor):
    """Launch the kernel on x (M, K) or (B, T, K), f32/bf16, whose last
    axis is contiguous; the rows are read where they lie (a strided view
    such as ``x[:, ::gamma, :]`` needs no copy).  Returns (s1, s2), each
    shaped ``x.shape[:-1]``, f32."""
    _build.require_cuda(x)
    if x.dtype not in _DTYPES:
        raise ValueError(f"act_stats takes float32/bfloat16, not {x.dtype}")
    rows, inner, outer_stride, inner_stride, K = row_layout(x)
    if rows > MAX_ROWS:
        raise ValueError(f"act_stats: {rows} rows exceed the grid ({MAX_ROWS})")
    s1, s2 = (torch.empty(x.shape[:-1], dtype=torch.float32, device=x.device)
              for _ in range(2))
    lib = _build.library("act_stats", _SIG)
    COUNT.launches += 1
    _build.check(lib.act_stats(
        x.data_ptr(), _DTYPES[x.dtype], s1.data_ptr(), s2.data_ptr(), rows, inner,
        outer_stride, inner_stride, K, _build.stream_ptr(x.device)), "act_stats")
    return s1, s2


def act_stats(x: torch.Tensor):
    """(s1, s2) of x's rows: the plain version for a CPU tensor, the CUDA
    kernel otherwise."""
    if x.device.type == "cpu":
        return act_stats_plain(x)
    return act_stats_cuda(x)
