"""Cache-row scatter (kernel K4): port of the slot-row scatter in
``repro/kernels/kv_cache.py:233-288``.

``dst[b] = src[src_map[b]]`` where ``src_map[b] >= 0``; other rows keep
their bits.  Unlike the functional TPU kernel, this one updates ``dst`` in
place (see ``csrc/kv_cache.cu``), so a pool is landed into without a copy.
The plain version is ``ref.cache_scatter_ref``.  The int8-KV flash-decode
attend kernels of the reference file come with the next slice.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build, ref

COUNT = _build.OpCount()
_P, _L = ctypes.c_void_p, ctypes.c_longlong
_SIG = {"cache_scatter": [_P, _P, _P, _L, _L, _P]}
MAX_ROWS = 65535                       # the kernel's grid y extent

cache_scatter_plain = ref.cache_scatter_ref


def cache_scatter_cuda(dst: torch.Tensor, src: torch.Tensor,
                       src_map: torch.Tensor) -> torch.Tensor:
    """Launch the kernel: dst (B, ...) and src (Bs, ...) of one dtype and
    row shape, both contiguous; src_map (B,) int32 in [-1, Bs)."""
    _build.require_cuda(dst, src, src_map)
    B = dst.shape[0]
    if (src.dtype != dst.dtype or src.shape[1:] != dst.shape[1:]
            or src_map.shape != (B,) or src_map.dtype != torch.int32):
        raise ValueError(
            f"cache_scatter: dst {tuple(dst.shape)} {dst.dtype}, src "
            f"{tuple(src.shape)} {src.dtype}, map {tuple(src_map.shape)} "
            f"{src_map.dtype}")
    if not (dst.is_contiguous() and src.is_contiguous()):
        raise ValueError("cache_scatter needs contiguous dst and src")
    if B > MAX_ROWS:
        raise ValueError(f"cache_scatter takes at most {MAX_ROWS} rows, got {B}")
    row_bytes = dst[0].numel() * dst.element_size() if B else 0
    d0, s0 = dst.data_ptr(), src.data_ptr()
    if d0 < s0 + src.numel() * src.element_size() and s0 < d0 + B * row_bytes:
        raise ValueError("cache_scatter: dst and src must not overlap")
    lib = _build.library("kv_cache", _SIG)
    COUNT.launches += 1
    _build.check(lib.cache_scatter(src_map.data_ptr(), d0, s0, B, row_bytes,
                                   _build.stream_ptr(dst.device)),
                 "cache_scatter")
    return dst


def cache_scatter(dst, src, src_map):
    """Row scatter into ``dst`` in place: the plain version for CPU
    tensors, the CUDA kernel otherwise."""
    if dst.device.type == "cpu":
        return cache_scatter_plain(dst, src, src_map)
    return cache_scatter_cuda(dst, src, src_map)
