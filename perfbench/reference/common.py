"""Pieces shared by the plain references: IEEE float32 matmuls, the RMSNorm
the port's models use, symmetric fake quantization for the lower-precision
control, and seeded weight draws in a few large calls.

Plain PyTorch only: nothing here imports the program.
"""
from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def ieee_f32():
    """float32 matmuls and convolutions without TF32 inside, the caller's
    settings restored after."""
    m, c = torch.backends.cuda.matmul, torch.backends.cudnn
    saved = m.allow_tf32, c.allow_tf32
    m.allow_tf32 = c.allow_tf32 = False
    try:
        yield
    finally:
        m.allow_tf32, c.allow_tf32 = saved


def rms_norm(x, w, eps: float):
    """x * rsqrt(mean(x^2) + eps) * (1 + w), in float32 (the port's models
    store the norm's weight as an offset from 1)."""
    x = x.float()
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * (1.0 + w.float())


def fake_quant(x, bits: int, dim: int):
    """Symmetric round-to-nearest quantization to ``bits`` bits along
    ``dim`` (one scale per slice across ``dim``), returned dequantized in
    float32."""
    q = 2 ** (bits - 1) - 1
    x = x.float()
    scale = torch.clamp_min(x.abs().amax(dim, keepdim=True), 1e-12) / q
    return torch.clamp(torch.round(x / scale), -q, q) * scale


def lin(x, w, bits: int | None):
    """x @ w in float32; with ``bits``, both quantized first: the weight
    per output column, the activation per row (W<bits>A<bits>)."""
    w = w.float()
    if bits:
        return fake_quant(x, bits, -1) @ fake_quant(w, bits, 0)
    return x.float() @ w


def stacked_uniform(gen, n: int, d_in: int, d_out: int, dtype):
    """n (d_in, d_out) matrices U(+-sqrt(3 / d_in)) drawn in one call, as
    views of one tensor."""
    scale = (3.0 / d_in) ** 0.5
    t = torch.empty((n, d_in, d_out), dtype=dtype, device=gen.device)
    t.uniform_(-scale, scale, generator=gen)
    return list(t.unbind(0))


def normal(gen, shape, std: float, dtype):
    t = torch.empty(shape, dtype=dtype, device=gen.device)
    return t.normal_(0.0, std, generator=gen)


def generator(seed: int, device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % 2 ** 63)
    return gen


def dtype_of(model: dict):
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[model["dtype"]]
