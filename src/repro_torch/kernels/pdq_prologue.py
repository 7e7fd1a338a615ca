"""Fused PDQ prologue (kernel K1): port of ``repro/kernels/pdq_prologue.py``.

ONE read of the activation rows produces everything the W8A8 matmul needs
before it runs: ``x_q`` (per-row symmetric int8), ``s_x`` (amax / 127),
``s1 = sum x`` and ``s2 = sum x^2`` (paper Eqs. 8-9).  Two more stages can
ride in the same launch, alone or together:

- ``norm = (w, eps)``: the RMSNorm in front (``ref.rms_norm``), applied to
  the row in registers and rounded to x's dtype before the prologue reads
  it; the normed row is never written (unless ``return_normed``).  Its
  mean of squares is ``ref.mean_square``, run by torch before the launch:
  the plain version's own reduction, so the normed row is the plain
  version's bit for bit (a sum in the kernel's order would round apart
  from torch's in some rows, and that moves codes downstream);
- ``interval = (wrec, blocks)``: the PDQ interval after it, priced per
  segment of the weight record from the row's own s1/s2, written as the
  int8 grid's extent (lo_g, hi_g): one column per segment, or with
  ``blocks`` (each segment's count of 128-column blocks) one per block,
  the layout the W8A8 kernels' clamp operands take.

The CUDA kernel is ``csrc/pdq_prologue.cu``; its note says what bounds it
and how it is laid out (a row too long for its registers is refused at
launch).  The plain version is ``ref.pdq_prologue_fused_ref``: the
composition the fused stages replace.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build, ref

COUNT = _build.OpCount()
# launches per mode, beside COUNT
MODES = {"prologue": 0, "norm": 0, "interval": 0, "norm+interval": 0}
MAX_SEG = 8          # segments an interval may have (csrc MAX_SEG)

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_SIG = {"pdq_prologue": [_P, _I, _P, _P, _P, _P, _L, _I, _P],
        "pdq_prologue_fused": [_P, _I, _P, _P, _F, _P, _P, _P, _P,
                               ctypes.POINTER(_I), _I, _P, _P, _P, _P, _P, _P, _P,
                               _L, _I, _P]}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_STATS = ("mu_w", "var_w", "alpha", "beta")
_NO_INTERVAL = ((None,) * 4, None, 0, 0)
# (device, ids of a record's four stats, blocks) -> its interval's launch
# arguments; bounded, and an entry holds its stats so their ids stay theirs
_INTERVALS: dict = {}
_MAX_INTERVALS = 1024

pdq_prologue_plain = ref.pdq_prologue_fused_ref


def mode_of(norm, interval) -> str:
    return {(False, False): "prologue", (True, False): "norm",
            (False, True): "interval", (True, True): "norm+interval"}[
        (norm is not None, interval is not None)]


def _interval_args(dev, wrec, blocks):
    """An interval's launch arguments: the pointers of ``wrec``'s weight
    stats, the block counts as a C array, n_seg and the columns of a row
    of lo/hi.  Checked once per record, layout and device, then cached."""
    stats = tuple(wrec[k] for k in _STATS)
    key = (dev, *map(id, stats), blocks)
    hit = _INTERVALS.get(key)
    if hit is None:
        _build.require_cuda(*stats)
        n_seg = stats[0].numel()
        blocks = blocks if blocks is not None else (1,) * n_seg
        if not (0 < n_seg <= MAX_SEG and len(blocks) == n_seg
                and all(s.numel() == n_seg and s.dtype == torch.float32
                        and s.is_contiguous() and s.device == dev for s in stats)
                and all(b > 0 for b in blocks)):
            raise ValueError(f"interval: {n_seg} segments (at most {MAX_SEG}) of "
                             f"contiguous float32 weight stats on {dev}, block "
                             f"counts {blocks}")
        if len(_INTERVALS) >= _MAX_INTERVALS:
            _INTERVALS.clear()
        hit = _INTERVALS[key] = (tuple(s.data_ptr() for s in stats),
                                 (_I * MAX_SEG)(*blocks), n_seg, sum(blocks), stats)
    return hit[:4]


def pdq_prologue_cuda(x: torch.Tensor, norm=None, interval=None, *,
                      return_normed: bool = False):
    """Launch the kernel on x (M, K) f32/bf16 on the card; the outputs as
    ``ref.pdq_prologue_fused_ref`` returns them."""
    w = None if norm is None else norm[0]
    _build.require_cuda(x, w)
    if x.dim() != 2 or x.dtype not in _DTYPES or x.shape[1] == 0:
        raise ValueError(f"pdq_prologue takes (M, K > 0) float32/bfloat16, got "
                         f"{tuple(x.shape)} {x.dtype}")
    x = x.contiguous()
    M, K = x.shape
    dev = x.device
    if w is not None:
        if w.dtype != x.dtype or w.numel() != K:
            raise ValueError(f"the norm weight must be ({K},) {x.dtype}, got "
                             f"{tuple(w.shape)} {w.dtype}")
        w = w.contiguous()
        ms = ref.mean_square(x)     # the plain norm's own reduction: its bits
    ptrs, blocks, n_seg, cols = (
        _NO_INTERVAL if interval is None else
        _interval_args(dev, interval[0], None if interval[1] is None else tuple(interval[1])))
    x_q = torch.empty((M, K), dtype=torch.int8, device=dev)
    s_x, s1, s2 = torch.empty((3, M, 1), dtype=torch.float32, device=dev).unbind(0)
    out = (x_q, s_x, s1, s2)
    lo = hi = y = None
    if n_seg:
        lo, hi = torch.empty((2, M, cols), dtype=torch.float32, device=dev).unbind(0)
        out += (lo, hi)
    if return_normed:
        y = torch.empty_like(x)
        out += (y,)
    lib = _build.library("pdq_prologue", _SIG)
    COUNT.launches += 1
    MODES[mode_of(norm, interval)] += 1
    code = lib.pdq_prologue_fused(
        x.data_ptr(), _DTYPES[x.dtype], *((None, None) if w is None else
                                          (w.data_ptr(), ms.data_ptr())),
        0.0 if norm is None else float(norm[1]), *ptrs, blocks, n_seg, x_q.data_ptr(),
        s_x.data_ptr(), s1.data_ptr(), s2.data_ptr(),
        None if lo is None else lo.data_ptr(), None if hi is None else hi.data_ptr(),
        None if y is None else y.data_ptr(), M, K, _build.stream_ptr(dev))
    _build.check(code, "pdq_prologue")
    return out


def pdq_prologue(x: torch.Tensor, norm=None, interval=None, *,
                 return_normed: bool = False):
    """K1 on x (M, K): the plain version for a CPU or a fake tensor
    (``_build.plain_here``), the CUDA kernel otherwise."""
    if _build.plain_here(x):
        return pdq_prologue_plain(x, norm, interval, return_normed)
    return pdq_prologue_cuda(x, norm, interval, return_normed=return_normed)
