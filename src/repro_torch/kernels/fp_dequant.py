"""The guarded PDQ projection's fp-dequant fallback, predicated on the
device: the port of the fallback branch of the reference's
``ops._guard_pdq`` (``lax.cond(ok, y, _fp_dequant_matmul(x, q, scale))``).

A guarded projection's W8A8 epilogue (kernel K2) sets the guard's
non-finite flag where it stores a NaN or an infinity.  This kernel runs
after it on every call: it reads the flag on the device and returns at
once when it is clear; when it is set it overwrites ``y`` with ``(x.f32 @
(q.f32 * scale)).to(y.dtype)`` and adds 1 to the collector's fallbacks.
Either way it leaves the flag clear for the next projection.  So no host
read decides the branch, and a captured decode graph stays one static
sequence of launches; the untaken branch costs one launch that reads a
word.  A ``torch.where`` over an always-computed fallback would
dequantize every weight on every step instead.

The flag is one int32 (2,) buffer per device (``flag_buffer``: the flag
and the kernel's ticket), zero at rest; launches on one stream run in
order, so every guarded projection shares it (a tensor-parallel shard on
a stream of its own takes its own set's, ``_build.buffer_set``).  The CUDA kernel is
``csrc/fp_dequant.cu``; the plain version is
``ref.fp_dequant_fallback_ref`` (it reads the flag on the host, so the
CPU path decides there).
"""
from __future__ import annotations

import ctypes

import torch

from . import _build, ref

COUNT = _build.OpCount()

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIG = {"fp_dequant_fallback": [_P, _I, _P, _P, _P, _I, _L, _I, _I, _P, _P, _P]}
_KINDS = {torch.float32: 0, torch.bfloat16: 1}
_FLAGS: dict = {}       # (device, buffer set) -> the guard's (2,) int32 flag, zero at rest

fp_dequant_fallback_plain = ref.fp_dequant_fallback_ref


def flag_buffer(device) -> torch.Tensor:
    """The guard's flag of ``device`` in the current buffer set: int32
    [non-finite flag, ticket], zero at rest (the fallback kernel, or its
    plain version, clears it)."""
    key = _build.buffer_key(device)
    f = _FLAGS.get(key)
    if f is None:
        f = torch.zeros((2,), dtype=torch.int32, device=key[0])
        _FLAGS[key] = f
    return f


def fp_dequant_fallback_cuda(y, x, w_q, scale, flag, tel=None):
    """Launch the predicated fallback on the current stream of the
    operands' card: y (M, N) f32/bf16 contiguous, in place (nothing is
    allocated); x (M, K) f32/bf16 contiguous; w_q the (K, N) int8 weight,
    K-major; scale (N,) f32; flag the (2,) int32 buffer; tel None or the
    int64 (3,) counters."""
    from .w8a8_matmul import is_k_major

    _build.require_cuda(y, x, w_q, scale, flag, tel)
    M, K = x.shape
    N = w_q.shape[1]
    if (tuple(w_q.shape) != (K, N) or w_q.dtype != torch.int8 or not is_k_major(w_q)
            or tuple(y.shape) != (M, N) or y.dtype not in _KINDS or not y.is_contiguous()
            or x.dtype not in _KINDS or not x.is_contiguous()
            or scale.dtype != torch.float32 or scale.numel() != N
            or not scale.is_contiguous()):
        raise ValueError(f"fp_dequant_fallback: y {tuple(y.shape)} {y.dtype}, x "
                         f"{tuple(x.shape)} {x.dtype}, w_q {tuple(w_q.shape)} {w_q.dtype} "
                         f"(K-major {is_k_major(w_q)}), scale {tuple(scale.shape)}")
    if flag.dtype != torch.int32 or flag.numel() != 2 or not flag.is_contiguous():
        raise ValueError("flag: the (2,) int32 buffer of flag_buffer()")
    if tel is not None and (tel.dtype != torch.int64 or tel.numel() != 3):
        raise ValueError("tel: an int64 (3,) tensor")
    dev = x.device
    lib = _build.library("fp_dequant", _SIG)
    COUNT.launches += 1
    code = lib.fp_dequant_fallback(
        x.data_ptr(), _KINDS[x.dtype], w_q.data_ptr(), scale.data_ptr(), y.data_ptr(),
        _KINDS[y.dtype], M, K, N, flag.data_ptr(), None if tel is None else tel.data_ptr(),
        _build.stream_ptr(dev))
    _build.check(code, "fp_dequant_fallback")
    return y


def fp_dequant_fallback(y, x, w_q, scale, flag, tel=None):
    """The fallback on its operands: plain version for CPU tensors, the
    CUDA kernel otherwise."""
    if x.device.type == "cpu":
        return fp_dequant_fallback_plain(y, x, w_q, scale, flag, tel)
    return fp_dequant_fallback_cuda(y, x, w_q, scale, flag, tel)
