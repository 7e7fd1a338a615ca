"""Kernels of the serving KV-cache pool: port of
``repro/kernels/kv_cache.py``.

K4, flash-decode attention over the int8 KV cache in kernel layout (B,
Hkv, Sp, Dh), and K5, the same with wo's PDQ prologue over each row's
flattened output (``csrc/decode_attend.cu``; plain versions
``ref.decode_attend_i8kv_ref`` / ``ref.decode_attend_i8kv_fused_ref``).

K6, the cache-row scatter: ``dst[b] = src[src_map[b]]`` where ``src_map[b]
>= 0``; other rows keep their bits.  Unlike the functional TPU kernel, this
one updates ``dst`` in place (``csrc/kv_cache.cu``), so a pool is landed
into without a copy.  The plain version is ``ref.cache_scatter_ref``.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build, ref

COUNT = _build.OpCount()               # K6
ATTEND_COUNT = _build.OpCount()        # K4
FUSED_COUNT = _build.OpCount()         # K5
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIG = {"cache_scatter": [_P, _P, _P, _L, _L, _P]}
_ATTEND_SIG = {"decode_attend_i8kv": [_P] * 7 + [_I] * 5 + [_P],
               "decode_attend_i8kv_fused": [_P] * 12 + [_I] * 6 + [_P]}
MAX_ROWS = 65535                       # the kernels' grid y extent
MAX_GROUP, MAX_HEAD_DIM = 8, 128       # the attend kernel's register/smem plan
_PRO_BF16 = {None: 0, torch.float32: 0, torch.bfloat16: 1}
_TICKETS: dict = {}                    # per device; the kernel leaves them zero

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


decode_attend_i8kv_plain = ref.decode_attend_i8kv_ref
decode_attend_i8kv_fused_plain = ref.decode_attend_i8kv_fused_ref


def _attend_check(q, k_q, v_q, k_scale, v_scale, length):
    """The attend kernels' operands: q (B, H, Dh) f32; k_q/v_q (B, Hkv,
    Sp, Dh) int8, 16-byte aligned; scales (B, Hkv, Sp) f32; length (B,)
    int32; all contiguous.  Returns (B, Hkv, G, Sp, Dh)."""
    _build.require_cuda(q, k_q, v_q, k_scale, v_scale, length)
    B, H, Dh = q.shape
    Hkv, Sp = k_q.shape[1], k_q.shape[2]
    want = [(q, (B, H, Dh), torch.float32), (k_q, (B, Hkv, Sp, Dh), torch.int8),
            (v_q, (B, Hkv, Sp, Dh), torch.int8),
            (k_scale, (B, Hkv, Sp), torch.float32),
            (v_scale, (B, Hkv, Sp), torch.float32), (length, (B,), torch.int32)]
    for t, shape, dtype in want:
        if tuple(t.shape) != shape or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"decode_attend_i8kv operand {tuple(t.shape)} {t.dtype} "
                             f"(contiguous {t.is_contiguous()}), expected "
                             f"contiguous {shape} {dtype}")
    G = H // Hkv if Hkv else 0
    if (Hkv == 0 or H % Hkv or not 1 <= G <= MAX_GROUP or Dh % 16
            or not 16 <= Dh <= MAX_HEAD_DIM or B > MAX_ROWS):
        raise ValueError(f"decode_attend_i8kv takes H = G * Hkv with G <= "
                         f"{MAX_GROUP}, Dh a multiple of 16 up to {MAX_HEAD_DIM} "
                         f"and B <= {MAX_ROWS}; got B {B}, H {H}, Hkv {Hkv}, Dh {Dh}")
    if k_q.data_ptr() % 16 or v_q.data_ptr() % 16:
        raise ValueError("decode_attend_i8kv needs 16-byte aligned k_q and v_q")
    return B, Hkv, G, Sp, Dh


def decode_attend_i8kv_cuda(q, k_q, v_q, k_scale, v_scale, length):
    """Launch K4; returns o (B, H, Dh) f32."""
    B, Hkv, G, Sp, Dh = _attend_check(q, k_q, v_q, k_scale, v_scale, length)
    o = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    lib = _build.library("decode_attend", _ATTEND_SIG)
    ATTEND_COUNT.launches += 1
    _build.check(lib.decode_attend_i8kv(
        q.data_ptr(), k_q.data_ptr(), v_q.data_ptr(), k_scale.data_ptr(),
        v_scale.data_ptr(), length.data_ptr(), o.data_ptr(), B, Hkv, G, Sp, Dh,
        _build.stream_ptr(q.device)), "decode_attend_i8kv")
    return o


def _tickets(device, B):
    """A zeroed (>= B,) int32 ticket buffer for ``device``.  K5 returns
    every ticket it draws to 0, so the buffer is zeroed once, not per
    call; launches on one stream never overlap."""
    t = _TICKETS.get(device)
    if t is None or t.numel() < B:
        t = torch.zeros((max(B, 64),), dtype=torch.int32, device=device)
        _TICKETS[device] = t
    return t


def decode_attend_i8kv_fused_cuda(q, k_q, v_q, k_scale, v_scale, length,
                                  pro_dtype=None):
    """Launch K5; returns (o (B, H, Dh) f32, o_q (B, H * Dh) int8, s_x, s1,
    s2 each (B, 1) f32).  ``pro_dtype`` (None, float32 or bfloat16) is the
    type o is rounded to before the prologue."""
    B, Hkv, G, Sp, Dh = _attend_check(q, k_q, v_q, k_scale, v_scale, length)
    if pro_dtype not in _PRO_BF16:
        raise ValueError(f"pro_dtype must be None, float32 or bfloat16, got {pro_dtype}")
    dev = q.device
    o = torch.empty(q.shape, dtype=torch.float32, device=dev)
    o_q = torch.empty((B, q.shape[1] * Dh), dtype=torch.int8, device=dev)
    s_x, s1, s2 = (torch.empty((B, 1), dtype=torch.float32, device=dev)
                   for _ in range(3))
    lib = _build.library("decode_attend", _ATTEND_SIG)
    FUSED_COUNT.launches += 1
    _build.check(lib.decode_attend_i8kv_fused(
        q.data_ptr(), k_q.data_ptr(), v_q.data_ptr(), k_scale.data_ptr(),
        v_scale.data_ptr(), length.data_ptr(), o.data_ptr(), o_q.data_ptr(),
        s_x.data_ptr(), s1.data_ptr(), s2.data_ptr(), _tickets(dev, B).data_ptr(),
        B, Hkv, G, Sp, Dh, _PRO_BF16[pro_dtype], _build.stream_ptr(dev)),
        "decode_attend_i8kv_fused")
    return o, o_q, s_x, s1, s2


def decode_attend_i8kv(q, k_q, v_q, k_scale, v_scale, length):
    """K4: the plain version for CPU tensors, the CUDA kernel otherwise."""
    if q.device.type == "cpu":
        return decode_attend_i8kv_plain(q, k_q, v_q, k_scale, v_scale, length)
    return decode_attend_i8kv_cuda(q, k_q, v_q, k_scale, v_scale, length)


def decode_attend_i8kv_fused(q, k_q, v_q, k_scale, v_scale, length, pro_dtype=None):
    """K5: the plain version for CPU tensors, the CUDA kernel otherwise."""
    fn = (decode_attend_i8kv_fused_plain if q.device.type == "cpu"
          else decode_attend_i8kv_fused_cuda)
    return fn(q, k_q, v_q, k_scale, v_scale, length, pro_dtype)
