"""Fused PDQ prologue (kernel K1): port of ``repro/kernels/pdq_prologue.py``.

ONE read of the activation rows produces everything the W8A8 matmul needs
before it runs: ``x_q`` (per-row symmetric int8), ``s_x`` (amax / 127),
``s1 = sum x`` and ``s2 = sum x^2`` (paper Eqs. 8-9).  The CUDA kernel is
``csrc/pdq_prologue.cu``; its note says what bounds it and how it is laid
out.  The plain version is ``ref.pdq_prologue_ref``.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build, ref

COUNT = _build.OpCount()
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIG = {"pdq_prologue": [_P, _I, _P, _P, _P, _P, _L, _I, _P]}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

pdq_prologue_plain = ref.pdq_prologue_ref


def pdq_prologue_cuda(x: torch.Tensor):
    """Launch the kernel on x (M, K) f32/bf16 on the card."""
    _build.require_cuda(x)
    if x.dim() != 2 or x.dtype not in _DTYPES:
        raise ValueError(f"pdq_prologue takes (M, K) float32/bfloat16, got "
                         f"{tuple(x.shape)} {x.dtype}")
    x = x.contiguous()
    M, K = x.shape
    x_q = torch.empty((M, K), dtype=torch.int8, device=x.device)
    s_x, s1, s2 = (torch.empty((M, 1), dtype=torch.float32, device=x.device)
                   for _ in range(3))
    lib = _build.library("pdq_prologue", _SIG)
    COUNT.launches += 1
    _build.check(lib.pdq_prologue(
        x.data_ptr(), _DTYPES[x.dtype], x_q.data_ptr(), s_x.data_ptr(),
        s1.data_ptr(), s2.data_ptr(), M, K, _build.stream_ptr(x.device)),
        "pdq_prologue")
    return x_q, s_x, s1, s2


def pdq_prologue(x: torch.Tensor):
    """(x_q, s_x, s1, s2) of x (M, K): the plain version for a CPU tensor,
    the CUDA kernel otherwise."""
    if x.device.type == "cpu":
        return pdq_prologue_plain(x)
    return pdq_prologue_cuda(x)
