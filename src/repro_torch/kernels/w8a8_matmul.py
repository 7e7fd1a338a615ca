"""W8A8 matmul with the PDQ epilogue (kernel K2) and its fused SwiGLU
variant (kernel K3): port of ``repro/kernels/w8a8_matmul.py``.

K2: ``y = (x_q @ w_q - z_x * colsum) * (s_x * s_w)`` with int32
accumulation, then the ``requant`` epilogue (int8 on the predicted
``(s_out, z_out)`` grid) or the ``fp_clamp`` epilogue (clip to the
predicted ``[lo, hi]`` and cast).  Epilogue operands are per row ``(M, 1)``
or per (row, 128-column block) ``(M, N/128)``.

K3: K2's fp_clamp per-block product over ``[gate | up]`` plus ``hsw =
silu(gate) * up`` and w_down's PDQ prologue of hsw, in one launch.

The CUDA kernels are ``csrc/w8a8_matmul.cu`` (its note says what bounds
them and how they are laid out); the plain versions compute the product in
float64, which is exact (``ref.w8a8_matmul_ref``).
"""
from __future__ import annotations

import ctypes

import torch

from . import _build, ref

LANE = 128                       # columns covered by one per-block operand
COUNT = _build.OpCount()         # K2
SWIGLU_COUNT = _build.OpCount()  # K3
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIG = {
    "w8a8_matmul": [_P] * 11 + [_I, _L, _I, _I, _I, _P],
    "w8a8_swiglu_matmul": [_P] * 15 + [_L, _I, _I, _P],
}
_OUT_KIND = {torch.float32: 0, torch.bfloat16: 1}


def _per_column(a, N):
    """(M, 1) stays; (M, N/128) spreads each block value over its columns."""
    return a if a.shape[1] == 1 else torch.repeat_interleave(a, LANE, dim=1)[:, :N]


def _ptr(t):
    return None if t is None else t.data_ptr()


def w8a8_matmul_plain(x_q, w_q, s_x, z_x, s_w, colsum, s_out=None, z_out=None,
                      lo=None, hi=None, *, out_dtype=torch.float32):
    """Plain version of K2 on the kernel's operands (``colsum`` is
    recomputed from ``w_q`` by the oracle)."""
    N = w_q.shape[1]
    z_x = 0 if z_x is None else z_x
    if s_out is not None:
        return ref.w8a8_matmul_ref(x_q, w_q, s_x, z_x, s_w,
                                   _per_column(s_out, N), _per_column(z_out, N))
    y = ref.w8a8_matmul_ref(x_q, w_q, s_x, z_x, s_w)
    if lo is not None:
        y = torch.minimum(torch.maximum(y, _per_column(lo, N)), _per_column(hi, N))
    return y.to(out_dtype)


def _check(x_q, w_q, s_x, z_x, s_w, colsum, epi):
    """Shapes, dtypes and layout of the operands the kernel reads (``None``
    marks one it does not read)."""
    M, K = x_q.shape
    N = w_q.shape[1]
    if z_x is not None and colsum is None:
        raise ValueError("a zero point z_x needs colsum")
    want = [(x_q, (M, K), torch.int8), (w_q, (K, N), torch.int8),
            (s_x, (M, 1), torch.float32), (z_x, (M, 1), torch.int32),
            (s_w, (1, N), torch.float32), (colsum, (1, N), torch.int32)]
    for t, shape, dtype in want + epi:
        if t is not None and (tuple(t.shape) != shape or t.dtype != dtype
                              or not t.is_contiguous()):
            raise ValueError(f"w8a8 operand {tuple(t.shape)} {t.dtype} (contiguous "
                             f"{t.is_contiguous()}), expected contiguous {shape} {dtype}")
    return M, K, N


def w8a8_matmul_cuda(x_q, w_q, s_x, z_x, s_w, colsum, s_out=None, z_out=None,
                     lo=None, hi=None, *, out_dtype=torch.float32):
    """Launch K2.  ``s_out``/``z_out`` select the requant epilogue (int8
    out), ``lo``/``hi`` the clamp of an fp out; ``z_x=None`` is a zero
    point of 0, and then ``colsum`` is not read.  Operands come contiguous,
    as ``ops.w8a8_matmul`` makes them."""
    _build.require_cuda(x_q, w_q, s_x, z_x, s_w, colsum, s_out, z_out, lo, hi)
    if (s_out is None) != (z_out is None) or (lo is None) != (hi is None):
        raise ValueError("s_out/z_out and lo/hi come in pairs")
    if s_out is not None and lo is not None:
        raise ValueError("the requant and fp clamp epilogues are exclusive")
    M, N = x_q.shape[0], w_q.shape[1]
    E = 1 if s_out is None and lo is None else (s_out if lo is None else lo).shape[1]
    if E not in (1, N // LANE) or (E > 1 and N % LANE):
        raise ValueError(f"epilogue operands (M, {E}) for N = {N}")
    epi = [(s_out, (M, E), torch.float32), (z_out, (M, E), torch.int32),
           (lo, (M, E), torch.float32), (hi, (M, E), torch.float32)]
    M, K, N = _check(x_q, w_q, s_x, z_x, s_w, colsum, epi)
    if s_out is not None:
        out, kind = torch.empty((M, N), dtype=torch.int8, device=x_q.device), 2
    elif out_dtype in _OUT_KIND:
        out = torch.empty((M, N), dtype=out_dtype, device=x_q.device)
        kind = _OUT_KIND[out_dtype]
    else:
        raise ValueError(f"w8a8_matmul emits float32/bfloat16, not {out_dtype}")
    lib = _build.library("w8a8_matmul", _SIG)
    COUNT.launches += 1
    _build.check(lib.w8a8_matmul(
        *map(_ptr, (x_q, w_q, s_x, z_x, s_w, colsum, s_out, z_out, lo, hi)),
        out.data_ptr(), kind, M, K, N, E, _build.stream_ptr(x_q.device)),
        "w8a8_matmul")
    return out


def w8a8_matmul(*args, out_dtype=torch.float32):
    """K2 on its normalized operands: plain version for CPU tensors, the
    CUDA kernel otherwise."""
    fn = w8a8_matmul_plain if args[0].device.type == "cpu" else w8a8_matmul_cuda
    return fn(*args, out_dtype=out_dtype)


def w8a8_swiglu_matmul_plain(x_q, w_q, s_x, z_x, s_w, colsum, lo, hi):
    """Plain version of K3 (``colsum`` is recomputed by the oracle)."""
    return ref.w8a8_swiglu_ref(x_q, w_q, s_x, 0 if z_x is None else z_x, s_w,
                               lo, hi)[1:]


def w8a8_swiglu_matmul_cuda(x_q, w_q, s_x, z_x, s_w, colsum, lo, hi):
    """Launch K3: w_q (K, N) holds [gate | up], P = N/2 columns each, with
    P a multiple of 128; lo/hi (M, N/128); ``z_x=None`` as in K2.  Returns
    (hsw (M, P) f32, hsw_q (M, P) int8, s_x, s1, s2 each (M, 1) f32).

    hsw is the kernel's scratch: a row's scale is known only when every
    block of the row has finished, so the last block reads hsw back to
    quantize it.  It is returned for the checks against the plain version;
    ``ops.pdq_mlp`` uses hsw_q and the three row values."""
    _build.require_cuda(x_q, w_q, s_x, z_x, s_w, colsum, lo, hi)
    M, N = x_q.shape[0], w_q.shape[1]
    if N % (2 * LANE):
        raise ValueError(f"swiglu halves must be 128-column multiples, N = {N}")
    epi = [(lo, (M, N // LANE), torch.float32), (hi, (M, N // LANE), torch.float32)]
    M, K, N = _check(x_q, w_q, s_x, z_x, s_w, colsum, epi)
    P = N // 2
    dev = x_q.device
    hsw = torch.empty((M, P), dtype=torch.float32, device=dev)
    hsw_q = torch.empty((M, P), dtype=torch.int8, device=dev)
    sx, s1, s2 = (torch.empty((M, 1), dtype=torch.float32, device=dev)
                  for _ in range(3))
    bm = 16 if M <= 16 else 64                       # the kernel's row tile
    part = torch.empty((M, -(-P // 64), 3), dtype=torch.float32, device=dev)
    tickets = torch.zeros((-(-M // bm),), dtype=torch.int32, device=dev)
    lib = _build.library("w8a8_matmul", _SIG)
    SWIGLU_COUNT.launches += 1
    _build.check(lib.w8a8_swiglu_matmul(
        *map(_ptr, (x_q, w_q, s_x, z_x, s_w, colsum, lo, hi,
                    hsw, hsw_q, sx, s1, s2, part, tickets)),
        M, K, N, _build.stream_ptr(dev)), "w8a8_swiglu_matmul")
    return hsw, hsw_q, sx, s1, s2


def w8a8_swiglu_matmul(*args):
    """K3: plain version for CPU tensors, the CUDA kernel otherwise."""
    if args[0].device.type == "cpu":
        return w8a8_swiglu_matmul_plain(*args)
    return w8a8_swiglu_matmul_cuda(*args)
