"""The CUDA kernels against their plain versions on the card, at ragged
shapes the full-width main path does not give them (edges masked in the
kernels, tiles of both sizes, misaligned rows).  They need an NVIDIA GPU
and skip elsewhere (the decision is taken in the fixture, at run time); on
the card:

    python -m pytest -q tests/test_torch_cuda.py

Tolerances: int8 codes, scales, int32-exact products and scattered bytes
are equal (K3's hsw scratch within rtol 1e-6, and its codes may differ by
one only where hsw does); s1/s2 within 1e-5 of the row's sum of magnitudes (another
summation order).  The int8-KV attend kernels (K4, K5): o within rtol =
atol = 2e-4 of plain (the reference's kernel test, tests/test_kernels.py:177),
on rows of length >= 1 (a row of length 0 is NaN in the plain version, as
in the reference, and exactly 0 in the kernels); K5's s_x within rtol
1e-5, its codes equal where o rounds to the same pro_dtype value under
the same s_x and never more than 1 apart.
"""
import pytest
import torch

from repro_torch.kernels import kv_cache as kv
from repro_torch.kernels import pdq_prologue as pro
from repro_torch.kernels import w8a8_matmul as mm


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: run this file on the card")
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    return g


def _sums_close(got, want, mag):
    assert bool(((got - want).abs() <= 1e-5 * mag.clamp_min(1.0)).all())


@pytest.mark.parametrize("M,K,dtype", [(1, 64, torch.float32), (3, 77, torch.float32),
                                       (17, 2048, torch.bfloat16),
                                       (70, 5632, torch.bfloat16)])
def test_pdq_prologue_kernel_matches_plain(gen, M, K, dtype):
    x = (3 * torch.randn((M, K), generator=gen, device="cuda")).to(dtype)
    k, p = pro.pdq_prologue_cuda(x), pro.pdq_prologue_plain(x)
    assert torch.equal(k[0], p[0]) and torch.equal(k[1], p[1])
    mag = x.float().abs().sum(-1, keepdim=True)
    _sums_close(k[2], p[2], mag)
    _sums_close(k[3], p[3], (x.float() ** 2).sum(-1, keepdim=True))


def _operands(gen, M, K, N, E):
    i8 = dict(dtype=torch.int8, device="cuda", generator=gen)
    x_q = torch.randint(-127, 128, (M, K), **i8)
    w_q = torch.randint(-127, 128, (K, N), **i8)
    f = lambda *s: torch.rand(s, generator=gen, device="cuda")      # noqa: E731
    s_x, s_w = 0.01 + 0.04 * f(M, 1), 0.001 + 0.01 * f(1, N)
    z_x = torch.randint(-3, 4, (M, 1), dtype=torch.int32, device="cuda", generator=gen)
    colsum = w_q.sum(0, keepdim=True, dtype=torch.int32)
    s_out = 0.5 + f(M, E)
    z_out = torch.randint(-20, 21, (M, E), dtype=torch.int32, device="cuda", generator=gen)
    lo, hi = -(1 + 20 * f(M, E)), 1 + 20 * f(M, E)
    return x_q, w_q, s_x, z_x, s_w, colsum, s_out, z_out, lo, hi


def _zero_point(ops, zero_x):
    """zero_x: the main path's z_x = 0, passed as no z_x and no colsum."""
    return ops[:3] + (None,) + ops[4:5] + (None,) + ops[6:] if zero_x else ops


@pytest.mark.parametrize("zero_x", [False, True])
@pytest.mark.parametrize("M,K,N", [(1, 64, 128), (5, 100, 70), (16, 256, 384),
                                   (17, 130, 256), (70, 64, 200)])
@pytest.mark.parametrize("mode", ["fp32", "fp_clamp_bf16", "requant"])
def test_w8a8_kernel_matches_plain(gen, M, K, N, mode, zero_x):
    E = N // 128 if N % 128 == 0 else 1
    ops = _zero_point(_operands(gen, M, K, N, E), zero_x)
    ops = {"fp32": ops[:6], "fp_clamp_bf16": ops[:6] + (None, None) + ops[8:],
           "requant": ops[:8]}[mode]
    kw = dict(out_dtype=torch.bfloat16 if mode == "fp_clamp_bf16" else torch.float32)
    assert torch.equal(mm.w8a8_matmul_cuda(*ops, **kw), mm.w8a8_matmul_plain(*ops, **kw))


@pytest.mark.parametrize("zero_x", [False, True])
@pytest.mark.parametrize("M,K,N", [(1, 64, 256), (5, 100, 512), (17, 256, 768),
                                   (70, 128, 256)])
def test_swiglu_kernel_matches_plain(gen, M, K, N, zero_x):
    ops = _zero_point(_operands(gen, M, K, N, N // 128), zero_x)
    args = ops[:6] + ops[8:]
    k, p = mm.w8a8_swiglu_matmul_cuda(*args), mm.w8a8_swiglu_matmul_plain(*args)
    same = k[0] == p[0]                                          # hsw
    assert bool(torch.isclose(k[0], p[0], rtol=1e-6, atol=0).all())
    dq = (k[1].int() - p[1].int()).abs()
    assert int(dq[same].max()) == 0 and int(dq.max()) <= 1       # hsw_q
    assert torch.equal(k[2], p[2])                               # s_x
    mag = p[0].abs().sum(-1, keepdim=True)
    _sums_close(k[3], p[3], mag)
    _sums_close(k[4], p[4], (p[0] ** 2).sum(-1, keepdim=True))


@pytest.mark.parametrize("row,dtype", [((3,), torch.int8), ((5, 16), torch.bfloat16),
                                       ((7,), torch.int32), ((4096,), torch.float32)])
def test_cache_scatter_kernel_matches_plain(gen, row, dtype):
    src = torch.randint(-100, 100, (6,) + row, generator=gen, device="cuda").to(dtype)
    dst = torch.randint(-100, 100, (9,) + row, generator=gen, device="cuda").to(dtype)
    m = torch.tensor([5, -1, 0, 2, -1, -1, 1, 4, 3], dtype=torch.int32, device="cuda")
    assert torch.equal(kv.cache_scatter_cuda(dst.clone(), src, m),
                       kv.cache_scatter_plain(dst.clone(), src, m))


def _attend_operands(gen, B, Hkv, G, Dh, Sp, lens):
    i8 = dict(dtype=torch.int8, device="cuda", generator=gen)
    f = lambda *s: torch.rand(s, generator=gen, device="cuda")      # noqa: E731
    return (torch.randn((B, Hkv * G, Dh), generator=gen, device="cuda"),
            torch.randint(-127, 128, (B, Hkv, Sp, Dh), **i8),
            torch.randint(-127, 128, (B, Hkv, Sp, Dh), **i8),
            0.01 + 0.04 * f(B, Hkv, Sp), 0.01 + 0.04 * f(B, Hkv, Sp),
            torch.tensor(lens, dtype=torch.int32, device="cuda"))


# Sp not a multiple of the kernel's 128-position tile; lengths 1, tile - 1,
# tile, tile + 1 and Sp, a row of length 0, and B up to 9
_ATTEND_CASES = [(1, 64, 130, [1, 127, 128, 129, 130, 0, 64]),
                 (4, 64, 300, [300, 1, 127, 128, 129, 0, 250, 299, 2]),
                 (1, 128, 257, [257, 128, 129, 1, 127, 0, 200, 256, 3]),
                 (4, 128, 130, [129, 130, 1, 0, 127, 128])]


@pytest.mark.parametrize("G,Dh,Sp,lens", _ATTEND_CASES)
def test_decode_attend_kernel_matches_plain(gen, G, Dh, Sp, lens):
    args = _attend_operands(gen, len(lens), 3, G, Dh, Sp, lens)
    k, p = kv.decode_attend_i8kv_cuda(*args), kv.decode_attend_i8kv_plain(*args)
    ok = args[-1] > 0
    assert bool(torch.isclose(k[ok], p[ok], rtol=2e-4, atol=2e-4).all())
    assert bool((k[~ok] == 0).all())


@pytest.mark.parametrize("pro_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("G,Dh,Sp,lens", _ATTEND_CASES)
def test_decode_attend_fused_kernel_matches_plain(gen, G, Dh, Sp, lens, pro_dtype):
    args = _attend_operands(gen, len(lens), 3, G, Dh, Sp, lens)
    for _ in range(2):          # the second launch finds the tickets reset
        k = kv.decode_attend_i8kv_fused_cuda(*args, pro_dtype)
        p = kv.decode_attend_i8kv_fused_plain(*args, pro_dtype)
        ok = args[-1] > 0
        assert bool(torch.isclose(k[0][ok], p[0][ok], rtol=2e-4, atol=2e-4).all())
        assert bool((k[0][~ok] == 0).all()) and bool((k[1][~ok] == 0).all())
        assert bool(torch.isclose(k[2][ok], p[2][ok], rtol=1e-5, atol=0).all())
        B = len(lens)
        kf, pf = (t.reshape(B, -1).to(pro_dtype) for t in (k[0], p[0]))
        same = (kf == pf) & (k[2] == p[2]) & ok[:, None]
        dq = (k[1].int() - p[1].int()).abs()
        assert int(dq[same].max()) == 0 and int(dq[ok].max()) <= 1
        mag = pf.float().abs().sum(-1, keepdim=True)
        _sums_close(k[3][ok], p[3][ok], mag[ok])
        _sums_close(k[4][ok], p[4][ok], (pf.float() ** 2).sum(-1, keepdim=True)[ok])
