"""The CUDA kernels against their plain versions on the card, at ragged
shapes the full-width main path does not give them (edges masked in the
kernels, tiles of both sizes, misaligned rows).  They need an NVIDIA GPU
and skip elsewhere (the decision is taken in the fixture, at run time); on
the card:

    python -m pytest -q tests/test_torch_cuda.py

Tolerances: int8 codes, scales, int32-exact products and scattered bytes
are equal (K3's hsw scratch within rtol 1e-6, and its codes may differ by
one only where hsw does); K2/K3's wgmma route equals the generic route
bit for bit (K3's s1/s2 aside, summed in another order) and repeats its
bits on a second launch (the split-K workspace and tickets reset); s1/s2 within 1e-5 of the row's sum of magnitudes (another
summation order).  The int8-KV attend kernels (K4, K5): o within rtol =
atol = 2e-4 of plain (the reference's kernel test, tests/test_kernels.py:177),
on rows of length >= 1 (a row of length 0 is NaN in the plain version, as
in the reference, and exactly 0 in the kernels); K5's s_x within rtol
1e-5, its codes equal where o rounds to the same pro_dtype value under
the same s_x and never more than 1 apart.  The page scatter (K7) is
bit-equal to its plain version in every direction the paged pool uses it.
The moment reduction (K8) sums like K1, within the same 1e-5, and two
launches on one input are bit-equal; quantize (K9) gives the plain
version's int8 codes exactly, .5 ties included, and dequantize (K10) its
bits exactly, f32 and bf16.
"""
import pytest
import torch

from repro_torch.kernels import act_stats as st
from repro_torch.kernels import kv_cache as kv
from repro_torch.kernels import pdq_prologue as pro
from repro_torch.kernels import quantize as qz
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
    """K2/K3 operands, w_q in the weight records' K-major layout."""
    i8 = dict(dtype=torch.int8, device="cuda", generator=gen)
    x_q = torch.randint(-127, 128, (M, K), **i8)
    w_q = mm.k_major(torch.randint(-127, 128, (K, N), **i8))
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
    _swiglu_case(mm.w8a8_swiglu_matmul_cuda(*args), mm.w8a8_swiglu_matmul_plain(*args))


# the wgmma route's edges: M across the decode (swap-AB, n = 8..64) and
# prefill (128-row tile) orientations; N ragged against the 128-column
# tile; K a multiple of 16 but not of the 128-byte stage
_WG_ROWS = (1, 5, 8, 17, 63, 64, 65, 130)
_WG_KN = [(48, 200), (144, 384), (2064, 200), (48, 384), (144, 200), (2064, 384)]


@pytest.mark.parametrize("zero_x", [False, True])
@pytest.mark.parametrize("mode", ["fp32", "fp_clamp_bf16", "requant"])
@pytest.mark.parametrize("K,N", _WG_KN)
@pytest.mark.parametrize("M", _WG_ROWS)
def test_w8a8_wgmma_route_matches_plain_and_generic(gen, M, K, N, mode, zero_x):
    E = N // 128 if N % 128 == 0 else 1
    ops = _zero_point(_operands(gen, M, K, N, E), zero_x)
    ops = {"fp32": ops[:6], "fp_clamp_bf16": ops[:6] + (None, None) + ops[8:],
           "requant": ops[:8]}[mode]
    kw = dict(out_dtype=torch.bfloat16 if mode == "fp_clamp_bf16" else torch.float32)
    assert mm.route_for(ops[0], ops[1]) == "wgmma"
    before = dict(mm.ROUTES["w8a8_matmul"])
    first = mm.w8a8_matmul_cuda(*ops, **kw)
    again = mm.w8a8_matmul_cuda(*ops, **kw)     # finds the workspace and tickets at 0
    assert mm.ROUTES["w8a8_matmul"]["wgmma"] == before["wgmma"] + 2
    assert mm.ROUTES["w8a8_matmul"]["generic"] == before["generic"]
    want = mm.w8a8_matmul_plain(*ops, **kw)
    assert torch.equal(first, want) and torch.equal(again, want)
    assert torch.equal(mm.w8a8_matmul_cuda(*ops, route="generic", **kw), want)


@pytest.mark.parametrize("M,K,N", [(8, 2048, 6144), (8, 2048, 2048), (8, 5632, 2048),
                                   (2048, 2048, 6144)])
def test_w8a8_wgmma_route_main_path_shapes(gen, M, K, N):
    """Full-width shapes: K split (up to 8 ways) at decode and the
    persistent prefill grid; bf16 out with per-128-column clamps, as path
    A."""
    ops = _zero_point(_operands(gen, M, K, N, N // 128), True)
    args = ops[:6] + (None, None) + ops[8:]
    kw = dict(out_dtype=torch.bfloat16)
    got = mm.w8a8_matmul_cuda(*args, **kw)
    assert torch.equal(got, mm.w8a8_matmul_plain(*args, **kw))
    assert torch.equal(mm.w8a8_matmul_cuda(*args, **kw), got)
    assert torch.equal(mm.w8a8_matmul_cuda(*args, route="generic", **kw), got)


def test_w8a8_route_rule_on_the_card(gen):
    """A misaligned x takes the generic route (forcing wgmma raises) and an
    N-major w is refused; the results stay the plain version's."""
    x_q, w_q, s_x, z_x, s_w, colsum, *_ = _operands(gen, 5, 64, 128, 1)
    flat = torch.randint(-127, 128, (1 + 5 * 64,), dtype=torch.int8, device="cuda",
                         generator=gen)
    x_off = flat[1:].view(5, 64)                           # 1 byte off 16
    assert mm.route_for(x_q, w_q) == "wgmma" and mm.route_for(x_off, w_q) == "generic"
    for xq in (x_q, x_off):
        want = mm.w8a8_matmul_plain(xq, w_q, s_x, z_x, s_w, colsum)
        assert torch.equal(mm.w8a8_matmul_cuda(xq, w_q, s_x, z_x, s_w, colsum), want)
    with pytest.raises(ValueError, match="wgmma route needs"):
        mm.w8a8_matmul_cuda(x_off, w_q, s_x, z_x, s_w, colsum, route="wgmma")
    with pytest.raises(ValueError, match="K-major"):
        mm.w8a8_matmul_cuda(x_q, w_q.contiguous(), s_x, z_x, s_w, colsum)


def _swiglu_case(k, p):
    same = k[0] == p[0]                                          # hsw
    assert bool(torch.isclose(k[0], p[0], rtol=1e-6, atol=0).all())
    dq = (k[1].int() - p[1].int()).abs()
    assert int(dq[same].max()) == 0 and int(dq.max()) <= 1       # hsw_q
    assert torch.equal(k[2], p[2])                               # s_x
    _sums_close(k[3], p[3], p[0].abs().sum(-1, keepdim=True))
    _sums_close(k[4], p[4], (p[0] ** 2).sum(-1, keepdim=True))


@pytest.mark.parametrize("zero_x", [False, True])
@pytest.mark.parametrize("K,N", [(48, 512), (144, 768), (2064, 256)])
@pytest.mark.parametrize("M", _WG_ROWS)
def test_swiglu_wgmma_route_matches_plain_and_generic(gen, M, K, N, zero_x):
    ops = _zero_point(_operands(gen, M, K, N, N // 128), zero_x)
    args = ops[:6] + ops[8:]
    assert mm.route_for(args[0], args[1]) == "wgmma"
    k = mm.w8a8_swiglu_matmul_cuda(*args)
    again = mm.w8a8_swiglu_matmul_cuda(*args)   # tickets and grid barrier reset
    assert all(torch.equal(u, v) for u, v in zip(k, again))
    _swiglu_case(k, mm.w8a8_swiglu_matmul_plain(*args))
    g = mm.w8a8_swiglu_matmul_cuda(*args, route="generic")
    assert all(torch.equal(u, v) for u, v in zip(k[:3], g[:3]))


@pytest.mark.parametrize("M", [8, 2048])
def test_swiglu_wgmma_route_main_path_shapes(gen, M):
    ops = _zero_point(_operands(gen, M, 2048, 11264, 88), True)
    args = ops[:6] + ops[8:]
    k = mm.w8a8_swiglu_matmul_cuda(*args)
    _swiglu_case(k, mm.w8a8_swiglu_matmul_plain(*args))
    assert all(torch.equal(u, v) for u, v in zip(k, mm.w8a8_swiglu_matmul_cuda(*args)))


@pytest.mark.parametrize("row,dtype", [((3,), torch.int8), ((5, 16), torch.bfloat16),
                                       ((7,), torch.int32), ((4096,), torch.float32)])
def test_cache_scatter_kernel_matches_plain(gen, row, dtype):
    src = torch.randint(-100, 100, (6,) + row, generator=gen, device="cuda").to(dtype)
    dst = torch.randint(-100, 100, (9,) + row, generator=gen, device="cuda").to(dtype)
    m = torch.tensor([5, -1, 0, 2, -1, -1, 1, 4, 3], dtype=torch.int32, device="cuda")
    assert torch.equal(kv.cache_scatter_cuda(dst.clone(), src, m),
                       kv.cache_scatter_plain(dst.clone(), src, m))


# (logical leaf (n, B, ...), dtype, seq_axis, page, pool pages): int8 and
# bf16 K/V, f32 scales, int32 pos; pages 16 and 64; Sp above max_len
# (n_leaf > n_pp); runs of 24 and 6 bytes (the byte path)
_PAGE_LEAVES = [((3, 4, 4, 128, 64), torch.int8, 3, 16, 13),
                ((2, 3, 4, 256, 64), torch.int8, 3, 64, 7),
                ((3, 4, 4, 128), torch.float32, 3, 16, 13),
                ((3, 4, 96), torch.int32, 2, 16, 11),
                ((2, 3, 64, 4, 16), torch.bfloat16, 2, 16, 9),
                ((2, 3, 2, 40, 3), torch.int8, 3, 8, 9),
                ((2, 3, 24, 3), torch.bfloat16, 2, 1, 30)]


def _rand_leaf(gen, shape, dtype):
    if dtype.is_floating_point:
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)
    return torch.randint(-100, 100, shape, generator=gen, device="cuda", dtype=dtype)


def _page_case(gen, shape, dtype, seq_axis, page, N):
    logical = _rand_leaf(gen, shape, dtype)
    pshape = list(shape)
    pshape[1], pshape[seq_axis] = N, page
    pool = _rand_leaf(gen, tuple(pshape), dtype)
    B, n_leaf = shape[1], shape[seq_axis] // page
    g = torch.randint(0, N, (B * n_leaf,), generator=gen, device="cuda", dtype=torch.int32)
    g[torch.rand(B * n_leaf, generator=gen, device="cuda") < 0.4] = -1
    w = torch.full((N,), -1, dtype=torch.int32, device="cuda")
    w[torch.randperm(N - 1, generator=gen, device="cuda")[:B] + 1] = torch.randint(
        0, B * n_leaf, (B,), generator=gen, device="cuda", dtype=torch.int32)
    return logical, pool, g, w


def _same_bits(a, b):
    return torch.equal(a.view(torch.uint8) if a.dtype == torch.bfloat16 else a,
                       b.view(torch.uint8) if b.dtype == torch.bfloat16 else b)


@pytest.mark.parametrize("shape,dtype,seq_axis,page,N", _PAGE_LEAVES)
def test_page_scatter_kernel_matches_plain(gen, shape, dtype, seq_axis, page, N):
    logical, pool, gmap, wmap = _page_case(gen, shape, dtype, seq_axis, page, N)
    n_pp = N // 2
    record = _rand_leaf(gen, (shape[0], n_pp) + tuple(pool.shape[2:]), dtype).cpu()
    pmap = torch.full((N,), -1, dtype=torch.int32, device="cuda")
    pmap[1:1 + n_pp] = torch.arange(n_pp, dtype=torch.int32, device="cuda").flip(0)
    cmap = torch.full((N,), -1, dtype=torch.int32, device="cuda")
    cmap[N - 2:] = torch.tensor([1, 2], dtype=torch.int32, device="cuda")
    cases = [(logical, pool, gmap, seq_axis),          # decode gather
             (pool, logical, wmap, seq_axis),          # write-back / land
             (pool, record.cuda(), pmap, None)]        # restore from a host record
    for dst, src, m, sa in cases:
        want = kv.cache_scatter_pages_plain(dst.clone(), src, m, sa, page, 1)
        got = kv.cache_scatter_pages_cuda(dst.clone(), src, m, sa, page, 1)
        assert _same_bits(got, want)
    # the COW copy: the pool onto itself, targets and sources disjoint
    want = kv.cache_scatter_pages_plain(pool.clone(), pool.clone(), cmap, None, None, 1)
    got = pool.clone()
    kv.cache_scatter_pages_cuda(got, got, cmap, None, None, 1, host_map=cmap.cpu().numpy())
    assert _same_bits(got, want)


def test_page_scatter_misaligned_base_takes_the_byte_path(gen):
    flat = torch.randint(-100, 100, (1 + 2 * 3 * 4 * 64 * 16,), generator=gen,
                         device="cuda", dtype=torch.int8)
    logical = flat[1:].view(2, 3, 4, 64, 16)            # contiguous, 1 byte off
    assert logical.data_ptr() % 16
    pool = torch.randint(-100, 100, (2, 7, 4, 16, 16), generator=gen, device="cuda",
                         dtype=torch.int8)
    m = torch.tensor([3, -1, 0, 6, -1, 2, 1, -1, 4, 5, -1, -1], dtype=torch.int32,
                     device="cuda")
    want = kv.cache_scatter_pages_plain(logical.clone(), pool, m, 3, 16, 1)
    got = kv.cache_scatter_pages_cuda(logical, pool, m, 3, 16, 1)
    assert torch.equal(got, want)


def test_page_scatter_refuses_overlap(gen):
    pool = _rand_leaf(gen, (2, 6, 2, 16, 8), torch.int8)
    bad = torch.tensor([-1, -1, 1, -1, 2, -1], dtype=torch.int32, device="cuda")
    good = torch.tensor([-1, -1, -1, -1, 1, 2], dtype=torch.int32, device="cuda")
    for m, host in ((bad, bad.cpu().numpy()), (good, None)):
        with pytest.raises(ValueError, match="overlap"):
            kv.cache_scatter_pages_cuda(pool, pool, m, None, None, 1, host_map=host)
    with pytest.raises(ValueError, match="overlap"):           # a view is not src is dst
        kv.cache_scatter_pages_cuda(pool, pool.view(pool.shape), good, None, None, 1,
                                    host_map=good.cpu().numpy())


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


def _act_stats_case(x):
    k, p = st.act_stats_cuda(x), st.act_stats_plain(x)
    again = st.act_stats_cuda(x)
    assert torch.equal(k[0], again[0]) and torch.equal(k[1], again[1])
    mag = x.float().abs().sum(-1)
    _sums_close(k[0], p[0], mag)
    _sums_close(k[1], p[1], (x.float() ** 2).sum(-1))


@pytest.mark.parametrize("M,K,dtype", [(1, 64, torch.float32), (3, 77, torch.float32),
                                       (5, 33, torch.bfloat16), (17, 2048, torch.bfloat16),
                                       (70, 5632, torch.float32), (300, 290, torch.bfloat16)])
def test_act_stats_kernel_matches_plain(gen, M, K, dtype):
    _act_stats_case((3 * torch.randn((M, K), generator=gen, device="cuda")).to(dtype))


@pytest.mark.parametrize("B,T,K,gamma,dtype", [(2, 100, 33, 4, torch.float32),
                                               (2, 100, 36, 4, torch.float32),
                                               (3, 50, 64, 3, torch.bfloat16),
                                               (8, 256, 2048, 4, torch.bfloat16)])
def test_act_stats_kernel_reads_strided_rows(gen, B, T, K, gamma, dtype):
    """The sampling stride's rows x[:, ::gamma, :], read in place."""
    x = (3 * torch.randn((B, T, K), generator=gen, device="cuda")).to(dtype)
    _act_stats_case(x[:, ::gamma, :])


def test_act_stats_kernel_misaligned_base(gen):
    flat = torch.randn((1 + 6 * 64,), generator=gen, device="cuda")
    x = flat[1:].view(6, 64)                                # 4 bytes off 16
    assert x.data_ptr() % 16
    _act_stats_case(x)


def _affine(gen, M, N, per_channel, ties):
    """Scales in [0.001, 0.3] (powers of two on every other row or channel,
    where x / s is exact), zero points in [-40, 40), and x on .5 ties of
    the grid where ``ties`` (else normal, some past the int8 range)."""
    n = N if per_channel else M
    s = 0.001 + 0.299 * torch.rand((n,), generator=gen, device="cuda")
    pow2 = 2.0 ** -torch.randint(1, 9, (n,), generator=gen, device="cuda").float()
    s = torch.where(torch.arange(n, device="cuda") % 2 == 0, pow2, s)
    z = torch.randint(-40, 40, (n,), generator=gen, device="cuda", dtype=torch.int32)
    shape = (1, N) if per_channel else (M, 1)
    s, z = s.reshape(shape).contiguous(), z.reshape(shape).contiguous()
    if ties:
        k = torch.randint(-140, 140, (M, N), generator=gen, device="cuda").float()
        x = (k + 0.5) * s
    else:
        x = 60 * torch.randn((M, N), generator=gen, device="cuda") * s
    return x, s, z


_AFFINE_SHAPES = [(1, 1), (5, 3), (64, 256), (300, 290), (2048, 2049)]


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("per_channel", [False, True])
@pytest.mark.parametrize("M,N", _AFFINE_SHAPES)
def test_quantize_kernel_matches_plain(gen, M, N, per_channel, dtype, ties):
    x, s, z = _affine(gen, M, N, per_channel, ties)
    x = x.to(dtype)
    assert torch.equal(qz.quantize_cuda(x, s, z), qz.quantize_plain(x, s, z))


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("per_channel", [False, True])
@pytest.mark.parametrize("M,N", _AFFINE_SHAPES)
def test_dequantize_kernel_matches_plain(gen, M, N, per_channel, out_dtype):
    _, s, z = _affine(gen, M, N, per_channel, False)
    q = torch.randint(-128, 128, (M, N), generator=gen, device="cuda", dtype=torch.int8)
    assert _same_bits(qz.dequantize_cuda(q, s, z, out_dtype),
                      qz.dequantize_plain(q, s, z, out_dtype))


def test_quantize_kernels_misaligned_rows(gen):
    """A base 1 byte (int8) or 4 bytes (f32) off 16 takes the element path."""
    _, s, z = _affine(gen, 6, 64, False, False)
    xf = torch.randn((1 + 6 * 64,), generator=gen, device="cuda")[1:].view(6, 64)
    assert torch.equal(qz.quantize_cuda(xf, s, z), qz.quantize_plain(xf, s, z))
    qb = torch.randint(-128, 128, (1 + 6 * 64,), generator=gen, device="cuda",
                       dtype=torch.int8)[1:].view(6, 64)
    assert torch.equal(qz.dequantize_cuda(qb, s, z), qz.dequantize_plain(qb, s, z))
