"""Input-moment reduction (kernel K8): port of ``repro/kernels/act_stats.py``.

One pass over the activation rows gives ``s1 = sum x`` and ``s2 = sum
x^2`` per row (paper Eqs. 8-9), the whole cost of the PDQ surrogate for a
linear layer when the projection is not fused with its prologue.  The CUDA
kernel is ``csrc/act_stats.cu``; its note says what bounds it and how it is
laid out; ``plan`` picks its route, block, chunk and loads from the shape,
strides, alignment and the card's L2.  The plain version is
``ref.act_stats_ref``.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from . import _build, ref

COUNT = _build.OpCount()
# launches per route: 16-byte units or single elements
ROUTES = {"act_stats": {"vector": 0, "element": 0}}
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIG = {"act_stats": [_P, _I, _P, _P, _L, _L, _L, _L, _I, _I, _I, _I, _I, _P]}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_ROWS = 2 ** 31 - 1                 # one block a row: the grid's x extent
MAX_THREADS = 256                      # a block (csrc/act_stats.cu)
MAX_CHUNK = 8                          # units a thread has in flight at most

act_stats_plain = ref.act_stats_ref


@dataclasses.dataclass(frozen=True)
class Plan:
    """A launch of the kernel: ``vector`` (16-byte units, else single
    elements), ``units`` a row, ``threads`` a block (one block a row),
    ``chunk`` units a thread in flight, and ``stream`` (evict-first
    loads)."""
    vector: bool
    units: int
    threads: int
    chunk: int
    stream: bool


def _pow2(n: int) -> int:
    return 1 << max(0, n - 1).bit_length()


@functools.lru_cache(maxsize=1024)
def plan(rows: int, K: int, elem: int, aligned: bool, outer_stride: int,
         inner_stride: int, l2_bytes: int) -> Plan:
    """The launch for ``rows`` rows of K elements of ``elem`` bytes, laid
    out as ``row_layout`` says; ``aligned``: x's first element is 16-byte
    aligned; ``l2_bytes``: the card's L2.  16-byte units when the base, K
    and both strides allow every row to be read in them.  The block takes
    about two units a thread (32 to 256 threads), and ``chunk`` is the
    units a thread then has (at most 8 at once; longer rows loop), so that
    a row's loads are in flight together and no predicated load is
    wasted.  An input larger than the L2 streams (evict-first loads)."""
    vec = 16 // elem
    vector = aligned and K % vec == 0 and outer_stride % vec == 0 \
        and inner_stride % vec == 0
    units = K // vec if vector else K
    threads = min(MAX_THREADS, max(32, _pow2(-(-units // 2))))
    chunk = min(MAX_CHUNK, _pow2(-(-units // threads)))
    return Plan(vector, units, threads, chunk, vector and rows * K * elem > l2_bytes)


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
    p = plan(rows, K, x.element_size(), x.data_ptr() % 16 == 0, outer_stride,
             inner_stride, _build.l2_bytes(x.device))
    s1, s2 = (torch.empty(x.shape[:-1], dtype=torch.float32, device=x.device)
              for _ in range(2))
    lib = _build.library("act_stats", _SIG)
    COUNT.launches += 1
    ROUTES["act_stats"]["vector" if p.vector else "element"] += 1
    _build.check(lib.act_stats(
        x.data_ptr(), _DTYPES[x.dtype], s1.data_ptr(), s2.data_ptr(), rows, inner,
        outer_stride, inner_stride, K, int(p.vector), int(p.stream), p.threads, p.chunk,
        _build.stream_ptr(x.device)), "act_stats")
    return s1, s2


def act_stats(x: torch.Tensor):
    """(s1, s2) of x's rows: the plain version for a CPU or a fake tensor
    (``_build.plain_here``), the CUDA kernel otherwise."""
    if _build.plain_here(x):
        return act_stats_plain(x)
    return act_stats_cuda(x)
