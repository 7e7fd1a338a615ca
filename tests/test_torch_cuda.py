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
summation order).  K1's fused modes: with the RMSNorm in front, the normed
row, x_q and s_x bit-equal to plain's (the kernel takes the row's mean
of squares from the plain version's own reduction); the interval's lo_g/hi_g bit-equal to the plain
interval of the kernel's own s1/s2; two launches bit-equal.  The int8-KV attend kernels (K4, K5), on both routes:
o within rtol = atol = 2e-4 of plain (the reference's kernel test,
tests/test_kernels.py:177) and the split route within the same of the
single route, on rows of length >= 1 (a row of length 0 is NaN in the
plain version, as in the reference, and exactly 0 in the kernels); K5's
s_x within rtol 1e-5, its codes equal where o rounds to the same pro_dtype
value under the same s_x and never more than 1 apart; the split route
repeats its bits on a second launch and leaves every ticket at 0.  The pool movements (K6,
K7) are bit-equal to their plain versions in every direction the pool uses
them, one launch a movement over leaves of every dtype, and the gather
writes every byte of a scratch poisoned with 0xFF.
The moment reduction (K8) sums like K1, within the same 1e-5, and two
launches on one input are bit-equal; quantize (K9) gives the plain
version's int8 codes exactly, .5 ties included, and dequantize (K10) its
bits exactly, f32 and bf16.
The decode graph (serve/decode_graph.py), on a two-layer bf16 stablelm at
d_model 256: an engine that replays its captured N-step block serves the
same streams, leaves the same pool bits and counts the same launches as
the same engine stepping eagerly; capture leaves the pool as a fresh one;
after 100 replays every ticket, the grid barrier's count and every split-K
partial are back at 0 (the barrier's generation word moved on by two
barriers a K3 launch); a replay after the kernels' workspaces grew (an
eager Sp-4096 attend and a wider W8A8) repeats its bits; and the capture
runs with Python's cycle collector off.
The SSD families: K2 at the SSD projections' full widths (ragged N of
10576 and 14576), K4/K5 at zamba2's G 1, Dh 112, Sp 512, K6 and K7 moving
zamba2-7b's f32 state and bf16 conv leaves (flat slot rows) with the
shared occurrences' K/V in one launch a movement, bit-equal to plain; and
a reduced zamba2 engine whose replayed decode graph serves the eager
engine's streams, pool bits (conv and state included) and counts.
PDQ health and the guard: NaN in an operand (a row's s_x, a weight scale,
a clamp bound) or a row of x makes exactly the plain version's outputs
non-finite, on both K2/K3 routes and in every K1 mode, and in K5's wo
prologue; the epilogues' clip hits and M x N equal the plain version's
counts (split K included) and the guard's flag is set like plain's; the
predicated fallback leaves y alone with its flag clear and computes the
fp-dequant product with it set (f32 within 1e-5; bf16 within one ulp, as
two f32 sums in another order may round to neighbouring values), clearing
it; the decode graph zeroes its counters each replay; a guarded engine
under the fault hook falls back once a projection a launch; and
ServeService's thread replays the graph to the batch run's streams.
The prefill extras' families: K5 at phi-3-vision-4.2b's Hkv 32, G 1, Dh 96,
Sp 1536 and seamless-m4t-medium's Hkv 16, Dh 64, Sp 512 with ragged lengths,
under the attend tolerances above; a reduced seamless engine (frames in
every prefill) whose replayed decode graph, reading each layer's cross K/V
from the pool, serves the eager engine's streams, pool bits (the cross
leaves included) and counts, slot rows and paged.  The CNN track's training
repeats its bits within one process (cuDNN's deterministic algorithms).
"""
import gc

import numpy as np
import pytest
import torch

from repro_torch.configs import reduced_config
from repro_torch.kernels import act_stats as st
from repro_torch.kernels import kv_cache as kv
from repro_torch.kernels import ops
from repro_torch.kernels import pdq_prologue as pro
from repro_torch.kernels import quantize as qz
from repro_torch.kernels import ref
from repro_torch.kernels import w8a8_matmul as mm
from repro_torch.models import build_model
from repro_torch.serve import Request, ServeConfig, build_engine
from repro_torch.serve import decode_graph as dg
from repro_torch.serve import engine as engine_mod


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


# K1's fused modes: the norm in front, the interval after it, per segment
# or per 128-column block
_PRO_MODES = [(False, 0), (True, 0), (False, 1), (False, 3), (True, 2), (True, 3)]


def _prologue_operands(gen, K, dtype, n_seg):
    """A nonzero norm weight (K,) and the interval's (rec, blocks): a
    single record's 0-dim stats for one segment, else (n_seg,) stats and
    128-column block counts."""
    f = lambda *s: torch.rand(s, generator=gen, device="cuda")      # noqa: E731
    w = (0.4 * f(K) - 0.2).to(dtype)
    n = () if n_seg == 1 else (n_seg,)
    rec = {"mu_w": 2e-3 * f(*n) - 1e-3, "var_w": (0.5 + f(*n)) / K,
           "alpha": torch.full(n, 6.0, device="cuda"),
           "beta": torch.full(n, 6.0, device="cuda")}
    return w, (rec, (5, 1, 2)[:n_seg] if n_seg > 1 else None)


def _prologue_modes_case(x, norm, interval):
    """K1 against plain in one mode: the (normed) row, x_q and s_x
    bit-equal; s1/s2 within 1e-5 of the row's sums; lo_g/hi_g bit-equal to
    the plain interval of the kernel's own s1/s2; a second launch (without
    the normed row) bit-equal."""
    k = pro.pdq_prologue_cuda(x, norm, interval, return_normed=True)
    p = pro.pdq_prologue_plain(x, norm, interval, return_normed=True)
    y = k[-1]
    own = pro.pdq_prologue_plain(y)
    assert torch.equal(y, x if norm is None else p[-1])
    assert torch.equal(k[0], p[0]) and torch.equal(k[1], p[1])
    _sums_close(k[2], own[2], y.float().abs().sum(-1, keepdim=True))
    _sums_close(k[3], own[3], (y.float() ** 2).sum(-1, keepdim=True))
    if interval is not None:
        rec, blocks = interval
        lo_g, hi_g = ref.grid_extent(*ref.pdq_interval(rec, k[2], k[3])[2:])
        if blocks is not None:
            lo_g, hi_g = ref.blockwise(lo_g, blocks), ref.blockwise(hi_g, blocks)
        assert torch.equal(k[4], lo_g) and torch.equal(k[5], hi_g)
    again = pro.pdq_prologue_cuda(x, norm, interval)
    assert len(again) == len(k) - 1
    assert all(torch.equal(a, b) for a, b in zip(again, k))


@pytest.mark.parametrize("norm,n_seg", _PRO_MODES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("K", [64, 77, 2048, 5632])
@pytest.mark.parametrize("M", [1, 3, 17, 70, 2048])
def test_pdq_prologue_modes_match_plain(gen, M, K, dtype, norm, n_seg):
    x = (3 * torch.randn((M, K), generator=gen, device="cuda")).to(dtype)
    w, interval = _prologue_operands(gen, K, dtype, n_seg or 1)
    _prologue_modes_case(x, (w, 1e-5) if norm else None, interval if n_seg else None)


@pytest.mark.parametrize("M", [3, 70])
def test_pdq_prologue_modes_misaligned_rows(gen, M):
    """A row base 2 bytes off 16 takes the scalar loads."""
    flat = (3 * torch.randn((1 + M * 2048,), generator=gen, device="cuda")).to(torch.bfloat16)
    x = flat[1:].view(M, 2048)
    assert x.data_ptr() % 16
    w, interval = _prologue_operands(gen, 2048, torch.bfloat16, 3)
    _prologue_modes_case(x, (w, 1e-5), interval)


# rows long enough that the kernel's plan gives a thread 1, 2, 4 or 8
# 16-byte vectors (bf16), or 2, 8, 16 or 32 elements (f32 rows of a length
# that is no multiple of 4 take the scalar path)
_LONG_ROWS = [(5, K, torch.bfloat16) for K in (2048, 16384, 32768, 65536)] + [
    (3, K, torch.float32) for K in (1027, 4099, 8195, 16387)]


@pytest.mark.parametrize("M,K,dtype", _LONG_ROWS)
def test_pdq_prologue_long_rows(gen, M, K, dtype):
    """Every layout the plan picks for a long row computes the same
    function, with and without the norm and the interval."""
    x = (3 * torch.randn((M, K), generator=gen, device="cuda")).to(dtype)
    w, interval = _prologue_operands(gen, K, dtype, 2)
    _prologue_modes_case(x, (w, 1e-5), interval)
    _prologue_modes_case(x, None, None)


@pytest.mark.parametrize("M", [8, 2048])
@pytest.mark.parametrize("K,norm", [(16384, False), (1536, True), (512, False),
                                    (7168, False)])
def test_pdq_prologue_moe_mla_rows(gen, M, K, norm):
    """deepseek-v2's and arctic's rows at decode and prefill: MLA's wo
    interval over the 16384-wide (128 heads x 128) row, wq_b's q_norm +
    interval at q_lora 1536, wk_b / wv_b's interval on ckv (kv_lora 512),
    and arctic's dense MLP over d_model 7168 (one segment each here)."""
    x = (3 * torch.randn((M, K), generator=gen, device="cuda")).to(torch.bfloat16)
    w, interval = _prologue_operands(gen, K, torch.bfloat16, 1)
    _prologue_modes_case(x, (w, 1e-6) if norm else None, interval)


def test_pdq_prologue_c_entry_is_the_plain_mode(gen):
    """The C entry ``pdq_prologue`` (the prologue alone, its signature
    unchanged) launches the fused entry's plain mode."""
    import ctypes
    x = (3 * torch.randn((17, 2048), generator=gen, device="cuda")).to(torch.bfloat16)
    want = pro.pdq_prologue_cuda(x)
    got = [torch.empty_like(t) for t in want]
    lib = pro._build.library("pdq_prologue", pro._SIG)
    stream = torch.cuda.current_stream().cuda_stream
    assert lib.pdq_prologue(x.data_ptr(), 1, *(t.data_ptr() for t in got), 17, 2048,
                            ctypes.c_void_p(stream)) == 0
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_pdq_prologue_refuses_a_row_too_long(gen):
    """A row longer than a CTA's registers hold (8 x 1024 16-byte vectors)
    is refused at launch, not computed wrong."""
    x = torch.zeros((1, 8 * 1024 * 8 + 8), dtype=torch.bfloat16, device="cuda")
    with pytest.raises(RuntimeError, match="pdq_prologue"):
        pro.pdq_prologue_cuda(x)


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


@pytest.mark.parametrize("M", [8, 2048])
@pytest.mark.parametrize("K,N", [(2560, 10576), (5120, 2560), (3584, 14576), (7168, 3584)])
def test_w8a8_ssd_projection_shapes(gen, M, K, N):
    """The SSD layers' in_proj and out_proj at full width: mamba2-2.7b's
    (2560 -> 10576, 82 column tiles and 80 columns; 5120 -> 2560) and
    zamba2-7b's (3584 -> 14576, 113 tiles and 112 columns; 7168 -> 3584),
    one record each (one clamp a row), bf16 out; both routes bit-equal to
    plain and the wgmma route to itself on a second launch."""
    ops = _zero_point(_operands(gen, M, K, N, 1), True)
    args = ops[:6] + (None, None) + ops[8:]
    kw = dict(out_dtype=torch.bfloat16)
    assert mm.route_for(args[0], args[1]) == "wgmma"
    got = mm.w8a8_matmul_cuda(*args, **kw)
    assert torch.equal(got, mm.w8a8_matmul_plain(*args, **kw))
    assert torch.equal(mm.w8a8_matmul_cuda(*args, **kw), got)
    assert torch.equal(mm.w8a8_matmul_cuda(*args, route="generic", **kw), got)


@pytest.mark.parametrize("M", [8, 2048])
def test_w8a8_grouped_mla_record(gen, M):
    """MLA's grouped (wq_a, wkv_a) record at deepseek-v2's width: 5120 ->
    1536 | 576, the second segment padded to 640 (zero codes, scale 1), so
    the epilogue's per-128-column clamps cover 12 + 5 blocks; wgmma equals
    plain and the generic route bit for bit, bf16 out."""
    from repro_torch.models.linops import group_quantize_weights
    ws = [0.02 * torch.randn((5120, n), generator=gen, device="cuda") for n in (1536, 576)]
    grec = group_quantize_weights(ws, names=("wq_a", "wkv_a"))
    assert grec["segs"].padded == (1536, 640)
    x = torch.randn((M, 5120), generator=gen, device="cuda").to(torch.bfloat16)
    blocks = tuple(p // 128 for p in grec["segs"].padded)
    x_q, s_x, _, _, lo, hi = pro.pdq_prologue_plain(x, None, (grec, blocks))
    N = grec["q"].shape[1]
    args = (x_q, grec["q"], s_x, None, grec["scale"].reshape(1, N), None, None, None,
            lo, hi)
    assert mm.route_for(x_q, grec["q"]) == "wgmma"
    kw = dict(out_dtype=torch.bfloat16)
    got = mm.w8a8_matmul_cuda(*args, **kw)
    assert torch.equal(got, mm.w8a8_matmul_plain(*args, **kw))
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


def _fill_of(gen, dtype):
    """A random 0-dim fill of ``dtype`` (CPU, as the paged pool keeps it)."""
    return _rand_leaf(gen, (1,), dtype).reshape(()).cpu()


def _offset(t, k):
    """A contiguous copy of ``t`` whose base lies ``k`` elements past an
    allocation's start (a misaligned base for the byte path)."""
    flat = torch.empty((k + t.numel(),), dtype=t.dtype, device=t.device)
    out = flat[k:].view(t.shape)
    out.copy_(t)
    return out


def _mixed_movements(gen):
    """Every leaf of _PAGE_LEAVES in one descriptor table per movement: the
    gather (each leaf with its fill; one int32 leaf with a base 4 bytes off
    16, so that its fill takes the byte path), the write-back, the restore
    and the COW copy.  Returns [(name, moves)]."""
    gathers, writebacks, restores, copies = [], [], [], []
    for i, (shape, dtype, seq_axis, page, N) in enumerate(_PAGE_LEAVES):
        logical, pool, gmap, wmap = _page_case(gen, shape, dtype, seq_axis, page, N)
        scratch = torch.empty_like(logical)
        if dtype == torch.int32:
            scratch = _offset(scratch, 1)
        gathers.append(kv.Move(scratch, pool, gmap, seq_axis, page, 1,
                               fill=_fill_of(gen, dtype)))
        writebacks.append(kv.Move(pool.clone(), logical, wmap, seq_axis, page, 1))
        n_pp = N // 2
        record = _rand_leaf(gen, (shape[0], n_pp) + tuple(pool.shape[2:]), dtype)
        pmap = torch.full((N,), -1, dtype=torch.int32, device="cuda")
        pmap[1:1 + n_pp] = torch.arange(n_pp, dtype=torch.int32, device="cuda").flip(0)
        restores.append(kv.Move(pool.clone(), record, pmap, batch_axis=1))
        cmap = torch.full((N,), -1, dtype=torch.int32, device="cuda")
        cmap[N - 2:] = torch.tensor([1, 2], dtype=torch.int32, device="cuda")
        p = pool.clone()
        copies.append(kv.Move(p, p, cmap, batch_axis=1, host_map=cmap.cpu().numpy()))
    return [("gather", gathers), ("write-back", writebacks), ("restore", restores),
            ("copy", copies)]


def _plain_of(moves):
    """The plain movement on clones of every dst (a COW leaf's src is its
    own clone)."""
    out = []
    for mv in moves:
        d = mv.dst.clone()
        out.append(mv._replace(dst=d, src=d if mv.src is mv.dst else mv.src))
    kv.cache_move_plain(out)
    return [mv.dst for mv in out]


def test_page_move_one_launch_per_movement_of_mixed_leaves(gen):
    """int8, f32, int32 and bf16 leaves, pages 1 to 64, 16-byte and byte
    paths, in one launch a movement, bit-equal to plain; the gather's
    scratch poisoned with 0xFF first, so every byte it holds was written."""
    for name, moves in _mixed_movements(gen):
        want = _plain_of(moves)
        if name == "gather":
            for mv in moves:
                mv.dst.view(torch.uint8).fill_(0xFF)
        before = kv.PAGES_COUNT.launches
        kv.cache_move_cuda(moves)
        torch.cuda.synchronize()
        assert kv.PAGES_COUNT.launches == before + 1, name
        for mv, w in zip(moves, want):
            assert _same_bits(mv.dst, w), (name, tuple(mv.dst.shape), mv.dst.dtype)


def test_page_move_ops_entry_sends_maps_and_targets(gen):
    """``ops.cache_move`` from numpy maps (one host-to-device copy, the
    in-place leaves visiting only their targets) equals plain; entries ==
    launches == 1."""
    from repro_torch.kernels import ops
    for name, moves in _mixed_movements(gen):
        host = [mv._replace(map=None, host_map=mv.map.cpu().numpy()) for mv in moves]
        want = _plain_of(moves)
        ops.reset_counts()
        ops.cache_move(host)
        torch.cuda.synchronize()
        assert ops.counts()["cache_scatter_pages"] == {"entries": 1, "launches": 1}
        for mv, w in zip(host, want):
            assert _same_bits(mv.dst, w), (name, tuple(mv.dst.shape))


def test_slot_row_landing_of_six_leaves_in_one_launch(gen):
    """K6: an int8-KV pool's six leaves (k, v, k_scale, v_scale, pos, len;
    the 4-byte len rows on the byte path) landed in one launch."""
    n, B, Hkv, Sp, Dh = 3, 5, 4, 128, 64
    shapes = {"pos": ((n, B, 96), torch.int32), "len": ((n, B), torch.int32),
              "k": ((n, B, Hkv, Sp, Dh), torch.int8), "k_scale": ((n, B, Hkv, Sp),
                                                          torch.float32),
              "v": ((n, B, Hkv, Sp, Dh), torch.int8), "v_scale": ((n, B, Hkv, Sp),
                                                          torch.float32)}
    smap = torch.tensor([3, -1, 0, -1, 1], dtype=torch.int32, device="cuda")
    moves = [kv.Move(_rand_leaf(gen, sh, dt), _rand_leaf(gen, (n, 4) + sh[2:], dt),
                     smap, batch_axis=1) for sh, dt in shapes.values()]
    want = _plain_of(moves)
    before = kv.COUNT.launches
    kv.cache_move_cuda(moves, kv.COUNT)
    torch.cuda.synchronize()
    assert kv.COUNT.launches == before + 1
    for mv, w in zip(moves, want):
        assert _same_bits(mv.dst, w), tuple(mv.dst.shape)


def test_page_move_refuses_a_fill_on_a_listed_or_in_place_leaf(gen):
    pool = _rand_leaf(gen, (2, 6, 2, 16, 8), torch.int8)
    m = torch.tensor([-1, -1, -1, -1, 1, 2], dtype=torch.int32, device="cuda")
    fill = _fill_of(gen, torch.int8)
    with pytest.raises(ValueError, match="overlap"):
        kv.cache_move_cuda([kv.Move(pool, pool, m, batch_axis=1, fill=fill,
                                    host_map=m.cpu().numpy())])
    with pytest.raises(ValueError, match="visits every row"):
        kv.cache_move_cuda([kv.Move(pool.clone(), pool, m, batch_axis=1, fill=fill,
                                    rows=torch.tensor([4, 5], dtype=torch.int32,
                                                      device="cuda"))])


def _attend_operands(gen, B, Hkv, G, Dh, Sp, lens):
    i8 = dict(dtype=torch.int8, device="cuda", generator=gen)
    f = lambda *s: torch.rand(s, generator=gen, device="cuda")      # noqa: E731
    return (torch.randn((B, Hkv * G, Dh), generator=gen, device="cuda"),
            torch.randint(-127, 128, (B, Hkv, Sp, Dh), **i8),
            torch.randint(-127, 128, (B, Hkv, Sp, Dh), **i8),
            0.01 + 0.04 * f(B, Hkv, Sp), 0.01 + 0.04 * f(B, Hkv, Sp),
            torch.tensor(lens, dtype=torch.int32, device="cuda"))


# Sp not a multiple of the 128-position tile (the single route's) and
# chunk (the split route's); lengths 1, CHUNK - 1, CHUNK, CHUNK + 1,
# multiples of CHUNK and Sp, a row of length 0, and B up to 9; Sp 4096 (the
# split route's 32 splits) with lengths up to Sp; G 8 with Dh 128, the
# largest instance; Dh 16, 48 and 96 (the P.V lane groups of 4, 16 and 32
# lanes with some idle)
_ATTEND_CASES = [(1, 64, 130, [1, 127, 128, 129, 130, 0, 64]),
                 (4, 64, 300, [300, 1, 127, 128, 129, 0, 250, 299, 2]),
                 (1, 128, 257, [257, 128, 129, 1, 127, 0, 200, 256, 3]),
                 (4, 128, 130, [129, 130, 1, 0, 127, 128]),
                 (1, 64, 512, [127, 128, 129, 256, 384, 512, 0, 1]),
                 (1, 64, 4096, [4096, 4095, 1, 0, 2049, 3000, 128, 640, 129]),
                 (8, 128, 640, [640, 0, 1, 127, 128, 129, 256, 511, 384]),
                 (8, 128, 4096, [4096, 1, 0, 3968, 255]),
                 (2, 48, 260, [260, 129, 0, 1, 128, 256, 5]),
                 (4, 16, 384, [383, 384, 0, 1, 129, 256]),
                 (1, 96, 300, [300, 128, 1, 0, 257]),
                 # the wide instance: gemma3-12b's global layers (G 2, Dh
                 # 256) at path H's Sp 2048 with lengths 1-2048, and ragged
                 # head dims past 128 (a lane holding two V words, the
                 # second idle for some lanes)
                 (2, 256, 2048, [2048, 1, 1024, 1025, 129, 1900, 0, 640]),
                 (2, 256, 130, [130, 1, 128, 129, 0]),
                 (1, 256, 300, [300, 129, 1, 257]),
                 (2, 144, 260, [260, 1, 0, 129, 200]),
                 (1, 208, 129, [129, 128, 1]),
                 # arctic-480b: 56 heads over 8 kv heads, G 7 (the first
                 # odd G, through the (8, 128) instance) at path AR's Sp 512
                 (7, 128, 512, [512, 1, 0, 127, 128, 129, 250, 511]),
                 # zamba2-7b's shared block: 32 heads over 32 kv heads of
                 # 112, G 1 at path Z's Sp 512 (the (8, 128) instance below
                 # its head dim)
                 (1, 112, 512, [512, 1, 0, 127, 128, 129, 250, 511])]


def _tickets_at_rest(device):
    """Every ticket the attend kernels drew is back at 0."""
    torch.cuda.synchronize()
    assert int(kv._tickets(device, 1).abs().sum()) == 0


def _routes_run(fn, op):
    """``fn`` twice on the split route (the second launch finds the tickets
    reset, and gives the same bits) and once on the single route, with the
    route counts checked; returns (split, single)."""
    before = dict(kv.ROUTES[op])
    k, again = fn(), fn()
    single = fn(route="single")
    assert kv.ROUTES[op] == {"split": before["split"] + 2, "single": before["single"] + 1}
    for a, b in zip(k if isinstance(k, tuple) else (k,),
                    again if isinstance(again, tuple) else (again,)):
        assert torch.equal(a, b)
    return k, single


@pytest.mark.parametrize("G,Dh,Sp,lens", _ATTEND_CASES)
def test_decode_attend_kernel_matches_plain(gen, G, Dh, Sp, lens):
    args = _attend_operands(gen, len(lens), 3, G, Dh, Sp, lens)
    k, single = _routes_run(lambda **kw: kv.decode_attend_i8kv_cuda(*args, **kw),
                            "decode_attend_i8kv")
    _tickets_at_rest(args[0].device)
    p = kv.decode_attend_i8kv_plain(*args)
    ok = args[-1] > 0
    for got in (k, single):
        assert bool(torch.isclose(got[ok], p[ok], rtol=2e-4, atol=2e-4).all())
        assert bool((got[~ok] == 0).all())
    assert bool(torch.isclose(k, single, rtol=2e-4, atol=2e-4).all())


@pytest.mark.parametrize("pro_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("G,Dh,Sp,lens", _ATTEND_CASES)
def test_decode_attend_fused_kernel_matches_plain(gen, G, Dh, Sp, lens, pro_dtype):
    _fused_case(gen, 3, G, Dh, Sp, lens, pro_dtype)


# the prefill extras' families at their full widths: phi-3-vision-4.2b (32
# kv heads of 96, G 1) at path V's Sp 1536 (1024 patches before every
# prompt), seamless-m4t-medium (16 kv heads of 64, G 1) at path S's Sp 512
_EXTRAS_ATTEND = [(32, 96, 1536, [1536, 1, 1044, 1153, 1024, 1025, 1280, 1306]),
                  (16, 64, 512, [512, 1, 250, 129, 128, 57, 300, 511])]


@pytest.mark.parametrize("Hkv,Dh,Sp,lens", _EXTRAS_ATTEND)
def test_decode_attend_fused_at_the_extras_families_shapes(gen, Hkv, Dh, Sp, lens):
    _fused_case(gen, Hkv, 1, Dh, Sp, lens, torch.bfloat16)


def _fused_case(gen, Hkv, G, Dh, Sp, lens, pro_dtype):
    """K5 on both routes against its plain version (the module note's
    tolerances)."""
    args = _attend_operands(gen, len(lens), Hkv, G, Dh, Sp, lens)
    k, single = _routes_run(
        lambda **kw: kv.decode_attend_i8kv_fused_cuda(*args, pro_dtype, **kw),
        "decode_attend_i8kv_fused")
    _tickets_at_rest(args[0].device)
    p = kv.decode_attend_i8kv_fused_plain(*args, pro_dtype)
    ok = args[-1] > 0
    B = len(lens)
    pf = p[0].reshape(B, -1).to(pro_dtype)
    for got in (k, single):
        assert bool(torch.isclose(got[0][ok], p[0][ok], rtol=2e-4, atol=2e-4).all())
        assert bool((got[0][~ok] == 0).all()) and bool((got[1][~ok] == 0).all())
        assert bool(torch.isclose(got[2][ok], p[2][ok], rtol=1e-5, atol=0).all())
        kf = got[0].reshape(B, -1).to(pro_dtype)
        same = (kf == pf) & (got[2] == p[2]) & ok[:, None]
        dq = (got[1].int() - p[1].int()).abs()
        assert int(dq[same].max()) == 0 and int(dq[ok].max()) <= 1
        _prologue_sums_close(got, p, kf, pf, ok)
    assert bool(torch.isclose(k[0], single[0], rtol=2e-4, atol=2e-4).all())


def _prologue_sums_close(got, p, kf, pf, ok):
    """K5's s1/s2 are sums of the kernel's own o rounded to pro_dtype
    (``kf``): within 1e-5 of those sums (another order), and of plain's
    within the same plus the rounded rows' own difference, as o within
    2e-4 of plain may round to a neighbouring bf16 value (0 where the row
    rounds alike)."""
    kf, pf = kf.float(), pf.float()
    for i, (own, ref) in enumerate(((kf, pf), (kf ** 2, pf ** 2)), start=3):
        mag = own.abs().sum(-1, keepdim=True)
        _sums_close(got[i][ok], own.sum(-1, keepdim=True)[ok], mag[ok])
        apart = (own - ref).abs().sum(-1, keepdim=True)
        assert bool(((got[i] - p[i]).abs() <= 1e-5 * mag.clamp_min(1.0) + apart)[ok].all())


def _act_stats_case(x):
    k, p = st.act_stats_cuda(x), st.act_stats_plain(x)
    again = st.act_stats_cuda(x)
    assert torch.equal(k[0], again[0]) and torch.equal(k[1], again[1])
    mag = x.float().abs().sum(-1)
    _sums_close(k[0], p[0], mag)
    _sums_close(k[1], p[1], (x.float() ** 2).sum(-1))


@pytest.mark.parametrize("M,K,dtype", [(1, 64, torch.float32), (3, 77, torch.float32),
                                       (5, 33, torch.bfloat16), (17, 2048, torch.bfloat16),
                                       (70, 5632, torch.float32), (300, 290, torch.bfloat16),
                                       (1, 5632, torch.float32), (1, 11264, torch.bfloat16),
                                       (2048, 11264, torch.float32),
                                       (16385, 2048, torch.bfloat16),
                                       (16385, 5632, torch.float32)])
def test_act_stats_kernel_matches_plain(gen, M, K, dtype):
    _act_stats_case((3 * torch.randn((M, K), generator=gen, device="cuda")).to(dtype))


@pytest.mark.parametrize("M,K,dtype", [(8, 2048, torch.float32), (8, 11264, torch.float32),
                                       (8, 2048, torch.bfloat16), (3, 4096, torch.bfloat16),
                                       (2048, 5632, torch.float32), (20000, 64, torch.float32),
                                       (9, 77, torch.bfloat16)])
def test_act_stats_kernel_blocks_and_chunks(gen, M, K, dtype):
    """One block a row at every block size and chunk the plan gives (32 to
    256 threads, 1 to 8 units a thread in flight, rows of several chunks),
    on the route the plan names."""
    x = (3 * torch.randn((M, K), generator=gen, device="cuda")).to(dtype)
    p = st.plan(*_plan_args(x))
    ops.reset_counts()
    _act_stats_case(x)
    assert ops.route_counts()["act_stats"]["vector" if p.vector else "element"] == 2


@pytest.mark.parametrize("M,K,dtype", [(16385, 2048, torch.float32),
                                       (33000, 2048, torch.bfloat16)])
def test_act_stats_kernel_streams_past_the_l2(gen, M, K, dtype):
    """Inputs larger than the L2 take the evict-first loads, with the same
    sums."""
    x = (3 * torch.randn((M, K), generator=gen, device="cuda")).to(dtype)
    assert st.plan(*_plan_args(x)).stream
    _act_stats_case(x)


def _plan_args(x):
    rows, _, so, si, K = st.row_layout(x)
    return (rows, K, x.element_size(), x.data_ptr() % 16 == 0, so, si,
            torch.cuda.get_device_properties(x.device).L2_cache_size)


@pytest.mark.parametrize("B,T,K,gamma,dtype", [(2, 100, 33, 4, torch.float32),
                                               (2, 100, 36, 4, torch.float32),
                                               (3, 50, 64, 3, torch.bfloat16),
                                               (8, 256, 2048, 4, torch.bfloat16),
                                               (3, 51, 64, 4, torch.float32),
                                               (2, 99, 2048, 4, torch.bfloat16),
                                               (4, 75, 5632, 3, torch.float32)])
def test_act_stats_kernel_reads_strided_rows(gen, B, T, K, gamma, dtype):
    """The sampling stride's rows x[:, ::gamma, :], read in place."""
    x = (3 * torch.randn((B, T, K), generator=gen, device="cuda")).to(dtype)
    _act_stats_case(x[:, ::gamma, :])


def test_act_stats_kernel_misaligned_base(gen):
    flat = torch.randn((1 + 6 * 64,), generator=gen, device="cuda")
    x = flat[1:].view(6, 64)                                # 4 bytes off 16
    assert x.data_ptr() % 16
    _act_stats_case(x)


@pytest.mark.parametrize("M,K,dtype", [(6, 64, torch.float32), (300, 2048, torch.bfloat16),
                                       (9, 5632, torch.float32)])
def test_act_stats_kernel_column_slice_takes_the_element_route(gen, M, K, dtype):
    """x[:, 1:] of a contiguous (M, K + 1): a base off 16 and an odd row
    stride, read element by element."""
    x = (3 * torch.randn((M, K + 1), generator=gen, device="cuda")).to(dtype)[:, 1:]
    assert x.data_ptr() % 16 and not st.plan(*_plan_args(x)).vector
    ops.reset_counts()
    _act_stats_case(x)
    assert ops.route_counts()["act_stats"] == {"vector": 0, "element": 2}


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


_AFFINE_SHAPES = [(1, 1), (5, 3), (64, 256), (300, 290), (2048, 2049), (70000, 32),
                  (65537, 33)]


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


@pytest.mark.parametrize("per_channel", [False, True])
@pytest.mark.parametrize("M,N", [(64, 256), (16384, 2048), (300, 290), (2048, 2049),
                                 (8, 12), (8, 24)])
def test_quantize_kernel_routes(gen, M, N, per_channel):
    """Each route the plan names (vector where N and the bases allow it,
    wide for f32 per row past the L2, element by element at ragged N);
    .5 ties at f32 and bf16, codes equal."""
    l2 = torch.cuda.get_device_properties("cuda").L2_cache_size
    for dtype in (torch.float32, torch.bfloat16):
        x, s, z = _affine(gen, M, N, per_channel, True)
        x = x.to(dtype)
        route = qz.plan(M, N, x.element_size(), per_channel, True, l2).route
        ops.reset_counts()
        assert torch.equal(qz.quantize_cuda(x, s, z), qz.quantize_plain(x, s, z))
        assert ops.route_counts()["quantize"][route] == 1


def test_quantize_kernel_wide_route(gen):
    """f32 per row larger than the L2: 16 columns a thread, evict-first;
    codes equal, .5 ties and values past the int8 range included."""
    M, N = 8192, 2048
    l2 = torch.cuda.get_device_properties("cuda").L2_cache_size
    assert M * N * 4 > l2 and qz.plan(M, N, 4, False, True, l2).route == "wide"
    for ties in (False, True):
        x, s, z = _affine(gen, M, N, False, ties)
        ops.reset_counts()
        assert torch.equal(qz.quantize_cuda(x, s, z), qz.quantize_plain(x, s, z))
        assert ops.route_counts()["quantize"]["wide"] == 1


def test_quantize_kernel_codes_at_the_edges(gen):
    """The fast codes against the float formula where they part: |x / s|
    near and past 2^22, huge zero points, inf and the int8 clamp; NaN
    (whose code the plain version leaves to the cast) takes the float
    formula's code, -128."""
    big = 2.0 ** 22
    vals = torch.tensor([0.5, 1.5, -0.5, -2.5, 127.5, -128.5, 300.0, -300.0, big - 0.5,
                         big - 1.5, big, big + 1, -big, 2 * big + 1, 1e30, -1e30,
                         float("inf"), float("-inf"), 1e-30, -0.0], device="cuda")
    x = vals.repeat(8, 4)[:, :64].contiguous()
    for zr in (0, 5, -(2 ** 23) + 3, 2 ** 23, 2 ** 30, -(2 ** 31)):
        s = torch.ones((8, 1), device="cuda")
        z = torch.full((8, 1), zr, dtype=torch.int32, device="cuda")
        assert torch.equal(qz.quantize_cuda(x, s, z), qz.quantize_plain(x, s, z))
    nan = torch.full((8, 64), float("nan"), device="cuda")
    s, z = torch.ones((8, 1), device="cuda"), torch.zeros((8, 1), dtype=torch.int32,
                                                          device="cuda")
    assert bool((qz.quantize_cuda(nan, s, z) == -128).all())


def test_quantize_kernels_misaligned_rows(gen):
    """A base 1 byte (int8) or 4 bytes (f32) off 16 takes the element path."""
    _, s, z = _affine(gen, 6, 64, False, False)
    xf = torch.randn((1 + 6 * 64,), generator=gen, device="cuda")[1:].view(6, 64)
    assert torch.equal(qz.quantize_cuda(xf, s, z), qz.quantize_plain(xf, s, z))
    qb = torch.randint(-128, 128, (1 + 6 * 64,), generator=gen, device="cuda",
                       dtype=torch.int8)[1:].view(6, 64)
    assert torch.equal(qz.dequantize_cuda(qb, s, z), qz.dequantize_plain(qb, s, z))


# ---------------------------------------------------------------------------
# the decode graph
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def card_model():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: run this file on the card")
    cfg = reduced_config("stablelm-1.6b", d_model=256, d_ff=512, head_dim=64,
                         vocab=1024, dtype="bfloat16", quant_kv="dynamic")
    return cfg, build_model(cfg, "cuda").init(0)


def _graph_engine(card_model, **kw):
    cfg, params = card_model
    kw = dict(dict(slots=4, max_len=128, buckets=(16, 32, 64), quantize_weights=True,
                   device="cuda"), **kw)
    return build_engine(ServeConfig(**kw), cfg=cfg, params=params)


def _graph_reqs(cfg):
    rng = np.random.default_rng(3)
    return [Request(uid=i, prompt=rng.integers(0, cfg.vocab, L).astype(np.int32),
                    max_new=20) for i, L in enumerate((5, 60, 17, 33, 9, 41))]


def _leaves(tree):
    return [v for d in tree["blocks"] for _, v in sorted(d.items())]


def _serve_card(eng):
    reqs = _graph_reqs(eng.cfg)
    ops.reset_counts()
    eng.run(reqs)
    torch.cuda.synchronize()
    assert all(r.done and r.error is None for r in reqs)
    return ({r.uid: r.generated for r in reqs}, [v.clone() for v in _leaves(eng.caches)],
            (ops.counts(), ops.route_counts(), ops.prologue_modes()))


@pytest.mark.parametrize("n,paged,temperature", [(1, False, 0.0), (4, False, 0.9),
                                                 (16, True, 0.0), (4, True, 0.9)])
def test_decode_graph_replay_equals_eager(card_model, monkeypatch, n, paged, temperature):
    kw = dict(decode_steps=n, temperature=temperature)
    if paged:
        kw.update(paged=True, page_size=16)
    eng = _graph_engine(card_model, **kw)
    fresh = (eng._paged_ops.init(eng.pool_pages) if paged
             else eng.bundle.init_caches(eng.slots, eng.max_len))
    assert all(torch.equal(a, b) for a, b in zip(_leaves(eng.caches), _leaves(fresh)))
    got = _serve_card(eng)
    assert eng.stats["graph_replays"] == eng.stats["decode_steps"] > 0
    monkeypatch.setattr(engine_mod, "_graphed", lambda device: False)
    plain = _graph_engine(card_model, **kw)
    assert plain._graph is None
    want = _serve_card(plain)
    assert got[0] == want[0]
    assert all(torch.equal(a, b) for a, b in zip(got[1], want[1]))
    assert got[2] == want[2]


def _replay_rows(eng, pos):
    B = eng.slots
    return (np.arange(B, dtype=np.int32), np.full(B, pos, np.int32),
            np.arange(B, dtype=np.int32), np.zeros(B, np.int32), np.ones(B, np.int32))


def test_decode_graph_leaves_tickets_at_zero(card_model):
    """After 100 replays every ticket and split-K partial reads 0, and K3's
    grid barrier is at rest: its count 0, its generation word moved on by
    exactly two barriers a K3 launch (the barrier waits for the word to
    change, so it never needs to return to 0)."""
    eng = _graph_engine(card_model)
    _serve_card(eng)
    (tk,) = mm._TICKETS.values()
    gen = int(tk[mm.BAR + 1])
    for _ in range(100):
        eng._graph(*_replay_rows(eng, 70))
    torch.cuda.synchronize()
    assert (int(tk[mm.BAR + 1]) - gen) % 2 ** 32 == 2 * 100 * eng.cfg.n_layers
    for t in (*kv._TICKETS.values(), tk[:mm.BAR + 1], *mm._WS.values()):
        assert not bool(t.any())


def test_decode_graph_survives_workspace_growth(card_model, gen):
    """Capture, then grow K4/K5's and K2/K3's workspaces with eager calls
    (the modules replace them), then replay: the same bits as before."""
    eng = _graph_engine(card_model)
    _serve_card(eng)
    start = [v.clone() for v in _leaves(eng.caches)]
    rows = _replay_rows(eng, 90)
    first = eng._graph(*rows)
    after = [v.clone() for v in _leaves(eng.caches)]
    for v, s0 in zip(_leaves(eng.caches), start):
        v.copy_(s0)
    old = (list(kv._WS.values()), list(mm._WS.values()))
    B, Hkv, G, Sp, Dh = 8, 8, 4, 4096, 64
    q = torch.randn((B, Hkv * G, Dh), generator=gen, device="cuda")
    k_q, v_q = (torch.randint(-127, 128, (B, Hkv, Sp, Dh), generator=gen, device="cuda",
                              dtype=torch.int8) for _ in range(2))
    sc = torch.rand((B, Hkv, Sp), generator=gen, device="cuda")
    kv.decode_attend_i8kv_cuda(q, k_q, v_q, sc, sc, torch.full((B,), Sp, dtype=torch.int32,
                                                                device="cuda"))
    # 64 rows of K 16384 split K 8 ways: a 64 x 2048 int32 workspace
    x_q = torch.randint(-127, 128, (64, 16384), generator=gen, device="cuda",
                        dtype=torch.int8)
    w_q = mm.k_major(torch.randint(-127, 128, (16384, 2048), generator=gen, device="cuda",
                                   dtype=torch.int8))
    assert mm.wgmma_plan(64, 16384, 2048, False, mm._sms(x_q.device)).splits > 1
    mm.w8a8_matmul_cuda(x_q, w_q, torch.ones((64, 1), device="cuda"), None,
                        torch.ones((1, 2048), device="cuda"), None)
    assert [list(kv._WS.values()), list(mm._WS.values())] != old
    junk = torch.full((1 << 26,), -1, dtype=torch.int32, device="cuda")   # reuse bait
    again = eng._graph(*rows)
    torch.cuda.synchronize()
    del junk
    assert np.array_equal(first[0], again[0]) and np.array_equal(first[1], again[1])
    assert all(torch.equal(a, b) for a, b in zip(_leaves(eng.caches), after))


def test_decode_graph_capture_runs_without_the_cycle_collector(card_model):
    """An engine dropped earlier lives in reference cycles; collecting it
    inside another engine's capture (its graph destroyed, its pinned buffer
    freed) invalidated that capture once in a full card run.  The collector
    is off for exactly the capture: off while the block is captured, on in
    its warm-up and after."""
    eng = _graph_engine(card_model)
    block, seen = eng._block, []

    def watched(*args):
        seen.append((torch.cuda.is_current_stream_capturing(), gc.isenabled()))
        return block(*args)

    assert gc.isenabled()
    g = dg.DecodeGraph(watched, eng.caches, eng.bundle.init_caches(4, 128), 4, "cuda")
    assert seen == [(False, True), (True, False)] and gc.isenabled()
    toks, ok, health = g(*_replay_rows(eng, 40))
    assert toks.shape == (4, 1) and bool(ok.all()) and health.shape == (3,)


# ---------------------------------------------------------------------------
# NaN travels as in the reference (max.NaN / min.NaN in the clamps and the
# row maxima), and the PDQ health the epilogues count
# ---------------------------------------------------------------------------

NAN = float("nan")


def _same_nonfinite(k, p):
    """The same elements are non-finite, at least one is, and the finite
    ones agree bit for bit."""
    kf, pf = torch.isfinite(k.float()), torch.isfinite(p.float())
    assert torch.equal(kf, pf) and not bool(kf.all())
    assert torch.equal(k[kf], p[pf])


def _poison(where, s_x, s_w, lo, hi):
    """A NaN in one row's s_x (a NaN in that row of x, through K1), one
    column's weight scale, or one row's clamp bound."""
    s_x, s_w, lo, hi = s_x.clone(), s_w.clone(), lo.clone(), hi.clone()
    {"x_row": s_x, "scale_col": s_w, "lo_row": lo, "hi_row": hi}[where][
        (0, 5) if where == "scale_col" else (3, 0)] = NAN
    return s_x, s_w, lo, hi


@pytest.mark.parametrize("where", ["x_row", "scale_col", "lo_row", "hi_row"])
@pytest.mark.parametrize("route", ["wgmma", "generic"])
@pytest.mark.parametrize("out", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M,K,N", [(8, 2048, 768), (130, 256, 384), (5, 5632, 256)])
def test_w8a8_nan_operands_give_plain_nonfinite(gen, M, K, N, out, route, where):
    x_q, w_q, s_x, _, s_w, _, _, _, lo, hi = _operands(gen, M, K, N, N // 128)
    s_x, s_w, lo, hi = _poison(where, s_x, s_w, lo, hi)
    args = (x_q, w_q, s_x, None, s_w, None, None, None, lo, hi)
    _same_nonfinite(mm.w8a8_matmul_cuda(*args, out_dtype=out, route=route),
                    mm.w8a8_matmul_plain(*args, out_dtype=out))


@pytest.mark.parametrize("where", ["x_row", "scale_col", "lo_row"])
@pytest.mark.parametrize("route", ["wgmma", "generic"])
@pytest.mark.parametrize("M", [8, 130])
def test_swiglu_nan_operands_give_plain_nonfinite(gen, M, route, where):
    x_q, w_q, s_x, _, s_w, _, _, _, lo, hi = _operands(gen, M, 256, 512, 4)
    s_x, s_w, lo, hi = _poison(where, s_x, s_w, lo, hi)
    args = (x_q, w_q, s_x, None, s_w, None, lo, hi)
    k = mm.w8a8_swiglu_matmul_cuda(*args, route=route)
    p = mm.w8a8_swiglu_matmul_plain(*args)
    for i in (0, 2, 3, 4):                  # hsw, s_x, s1, s2 (not the codes)
        assert torch.equal(torch.isfinite(k[i]), torch.isfinite(p[i])), i
    assert not bool(torch.isfinite(k[2]).all())


@pytest.mark.parametrize("norm,n_seg", _PRO_MODES)
@pytest.mark.parametrize("M,K", [(3, 77), (8, 2048), (70, 5632)])
def test_pdq_prologue_nan_row_in_every_mode(gen, M, K, norm, n_seg):
    x = (3 * torch.randn((M, K), generator=gen, device="cuda")).to(torch.bfloat16)
    x[1, K // 2] = NAN
    w, interval = _prologue_operands(gen, K, torch.bfloat16, n_seg or 1)
    args = (x, (w, 1e-5) if norm else None, interval if n_seg else None)
    k, p = pro.pdq_prologue_cuda(*args), pro.pdq_prologue_plain(*args)
    for a, b in zip(k[1:], p[1:]):          # s_x, s1, s2[, lo_g, hi_g]
        assert torch.equal(torch.isfinite(a), torch.isfinite(b))
        assert not bool(torch.isfinite(a[1]).any()) and bool(torch.isfinite(a[0]).all())
    assert torch.equal(k[0][0], p[0][0])    # the finite rows' codes


@pytest.mark.parametrize("split", [True, False])
def test_decode_attend_fused_nan_query_row(gen, split):
    q, k_q, v_q, ks, vs, length = _attend_operands(gen, 4, 4, 2, 64, 256, (1, 57, 200, 256))
    q = q.clone()
    q[2, 3, 7] = NAN
    fn = kv.decode_attend_i8kv_fused_cuda
    got = fn(q, k_q, v_q, ks, vs, length, torch.bfloat16,
             route="split" if split else "single")
    want = kv.decode_attend_i8kv_fused_plain(q, k_q, v_q, ks, vs, length, torch.bfloat16)
    # wo's prologue: a NaN in the row's o gives the row a NaN s_x, s1, s2
    # (the softmax itself keeps fmaxf: a NaN cache or query is outside the
    # contract there, so o is only required to carry the NaN somewhere)
    assert not bool(torch.isfinite(got[0][2]).all())
    for i in (2, 3, 4):
        assert torch.equal(torch.isfinite(got[i]), torch.isfinite(want[i])), i
    assert not bool(torch.isfinite(got[2][2]).any())


@pytest.mark.parametrize("split", [True, False])
def test_decode_attend_fused_nan_query_row_wide_instance(gen, split):
    """The NaN case above on the wide instance (G 2, Dh 256)."""
    q, k_q, v_q, ks, vs, length = _attend_operands(gen, 4, 2, 2, 256, 384,
                                                   (1, 129, 300, 384))
    q = q.clone()
    q[2, 1, 200] = NAN
    got = kv.decode_attend_i8kv_fused_cuda(q, k_q, v_q, ks, vs, length, torch.bfloat16,
                                           route="split" if split else "single")
    want = kv.decode_attend_i8kv_fused_plain(q, k_q, v_q, ks, vs, length, torch.bfloat16)
    assert not bool(torch.isfinite(got[0][2]).all())
    for i in (2, 3, 4):
        assert torch.equal(torch.isfinite(got[i]), torch.isfinite(want[i])), i
    assert not bool(torch.isfinite(got[2][2]).any())
    for r in (0, 1, 3):
        assert bool(torch.isclose(got[0][r], want[0][r], rtol=2e-4, atol=2e-4).all())


@pytest.mark.parametrize("G,Dh", [(1, 272), (4, 256), (3, 256), (4, 160)])
def test_decode_attend_refuses_shapes_past_the_built_plans(gen, G, Dh):
    """Dh 272, and G * Dh > 512 past Dh 128, raise before any launch, on
    both routes (``attend_limits``)."""
    args = _attend_operands(gen, 2, 2, G, Dh, 128, (1, 128))
    for route in ("split", "single"):
        with pytest.raises(ValueError, match="decode_attend_i8kv takes"):
            kv.decode_attend_i8kv_cuda(*args, route=route)
        with pytest.raises(ValueError, match="decode_attend_i8kv takes"):
            kv.decode_attend_i8kv_fused_cuda(*args, torch.bfloat16, route=route)


@pytest.mark.parametrize("G,Dh,want", [(1, 64, (1, 64)), (1, 48, (1, 64)),
                                       (2, 64, (8, 128)), (1, 80, (8, 128)),
                                       (8, 128, (8, 128)), (1, 144, (2, 256)),
                                       (2, 256, (2, 256)), (3, 256, None), (1, 272, None)])
def test_split_route_instance_is_the_library_choice(gen, G, Dh, want):
    """The split route's kernel instance, as the library chooses it
    (``kv.attend_instance``): the lean (1, 64) at G 1 up to Dh 64, the (8,
    128) one up to Dh 128, the wide (2, 256) past it, none past the plans."""
    if want is None:
        with pytest.raises(ValueError, match="no decode_attend_i8kv instance"):
            kv.attend_instance(G, Dh)
    else:
        assert kv.attend_instance(G, Dh) == want


_MANY_DTYPES = (torch.int8, torch.float32, torch.int32, torch.bfloat16)


@pytest.mark.parametrize("n_leaves", [36, 64])
def test_cache_move_of_many_leaves_in_one_launch(gen, n_leaves):
    """A movement of 36 leaves (gemma3-12b's int8-KV landing: 6 kinds of k,
    v, k_scale, v_scale, pos, len) and of 64 (MAX_LEAVES) in ONE launch:
    slot-row landings of mixed dtypes, and page gathers with fills, bit-equal
    to plain."""
    assert kv.MAX_LEAVES == 64
    smap = torch.tensor([3, -1, 0, -1, 1], dtype=torch.int32, device="cuda")
    land, gather = [], []
    for i in range(n_leaves):
        dt = _MANY_DTYPES[i % 4]
        row = ((2, 8, 16), (7,), (3, 40), (5, 16))[i % 4]
        land.append(kv.Move(_rand_leaf(gen, (2, 5) + row, dt),
                            _rand_leaf(gen, (2, 4) + row, dt), smap, batch_axis=1))
        pool = _rand_leaf(gen, (2, 6, 2, 16, 8), dt)
        gmap = torch.tensor([5, -1, 2, 1, -1, 4, 0, 3], dtype=torch.int32, device="cuda")
        gather.append(kv.Move(torch.empty((2, 2, 2, 64, 8), dtype=dt, device="cuda"),
                              pool, gmap, 3, 16, 1, fill=_fill_of(gen, dt)))
    for moves, count in ((land, kv.COUNT), (gather, kv.PAGES_COUNT)):
        want = _plain_of(moves)
        before = count.launches
        kv.cache_move_cuda(moves, count)
        torch.cuda.synchronize()
        assert count.launches == before + 1
        for mv, w in zip(moves, want):
            assert _same_bits(mv.dst, w), (tuple(mv.dst.shape), mv.dst.dtype)
    with pytest.raises(ValueError, match="1 to 64 leaves"):
        kv.cache_move_cuda(land + land[:64 - n_leaves + 1], kv.COUNT)


def _wide_clamp(gen, M, E):
    """Clamp bounds narrow enough that many outputs clip."""
    f = lambda *s: torch.rand(s, generator=gen, device="cuda")      # noqa: E731
    return -(0.5 + 3 * f(M, E)), 0.5 + 3 * f(M, E)


@pytest.mark.parametrize("route", ["wgmma", "generic"])
@pytest.mark.parametrize("M,K,N,mode", [(8, 2048, 6144, "fp_clamp_bf16"),
                                        (8, 5632, 2048, "fp32"),
                                        (130, 256, 384, "fp_clamp_bf16"),
                                        (5, 144, 200, "fp32"),
                                        (8, 2048, 2048, "requant"),
                                        (70, 128, 128, "requant")])
def test_w8a8_counts_equal_plain(gen, M, K, N, mode, route):
    """Clip hits and M x N from the epilogue (split K: counted once, in
    the merge) equal the plain version's counts; the guard's flag stays
    clear at finite outputs and is set, like plain's, by a NaN."""
    E = N // 128 if N % 128 == 0 else 1
    x_q, w_q, s_x, _, s_w, _, s_out, z_out, _, _ = _operands(gen, M, K, N, E)
    lo, hi = _wide_clamp(gen, M, E)
    if mode == "requant":             # a grid fine enough that codes saturate
        args, kw = (x_q, w_q, s_x, None, s_w, None, 0.05 * s_out, z_out), {}
    else:
        args = (x_q, w_q, s_x, None, s_w, None, None, None, lo, hi)
        kw = dict(out_dtype=torch.bfloat16 if mode == "fp_clamp_bf16" else torch.float32)
    if route == "wgmma" and (M, K) == (8, 5632):
        assert mm.wgmma_plan(M, K, N, False, mm._sms(x_q.device)).splits > 1
    tk, tp = (torch.zeros(3, dtype=torch.int64, device="cuda") for _ in range(2))
    y = mm.w8a8_matmul_cuda(*args, route=route, tel=tk, **kw)
    assert torch.equal(y, mm.w8a8_matmul_plain(*args, tel=tp, **kw))
    assert torch.equal(tk, tp) and 0 < int(tk[1]) < int(tk[2]) == M * N and int(tk[0]) == 0
    if mode == "requant":
        return
    fk, fp = (torch.zeros(2, dtype=torch.int32, device="cuda") for _ in range(2))
    mm.w8a8_matmul_cuda(*args, route=route, flag=fk, **kw)
    assert fk.tolist() == [0, 0]
    bad = (x_q, w_q, _poison("x_row", s_x, s_w, lo, hi)[0]) + args[3:]
    mm.w8a8_matmul_cuda(*bad, route=route, flag=fk, **kw)
    mm.w8a8_matmul_plain(*bad, flag=fp, **kw)
    assert fk.tolist() == fp.tolist() == [1, 0]


@pytest.mark.parametrize("route", ["wgmma", "generic"])
@pytest.mark.parametrize("M,K,N", [(8, 2048, 11264), (130, 256, 512), (5, 144, 768)])
def test_swiglu_counts_equal_plain(gen, M, K, N, route):
    """K3 counts its f32 gate and up values against their clamps, as the
    plain version (and the reference's fused kernel) does."""
    x_q, w_q, s_x, _, s_w, *_ = _operands(gen, M, K, N, N // 128)
    lo, hi = _wide_clamp(gen, M, N // 128)
    args = (x_q, w_q, s_x, None, s_w, None, lo, hi)
    tk, tp = (torch.zeros(3, dtype=torch.int64, device="cuda") for _ in range(2))
    mm.w8a8_swiglu_matmul_cuda(*args, route=route, tel=tk)
    mm.w8a8_swiglu_matmul_plain(*args, tel=tp)
    assert torch.equal(tk, tp) and 0 < int(tk[1]) < int(tk[2]) == M * N


# ---------------------------------------------------------------------------
# the predicated fp-dequant fallback
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M,K,N", [(8, 2048, 6144), (5, 100, 70), (130, 5632, 2048),
                                   (17, 33, 129)])
def test_fp_dequant_fallback_taken_and_not(gen, M, K, N, dtype):
    from repro_torch.kernels import fp_dequant as fd
    x = torch.randn((M, K), generator=gen, device="cuda").to(dtype)
    w_q = mm.k_major(torch.randint(-127, 128, (K, N), dtype=torch.int8, device="cuda",
                                   generator=gen))
    scale = 0.001 + 0.01 * torch.rand((N,), generator=gen, device="cuda")
    y0 = torch.randn((M, N), generator=gen, device="cuda").to(dtype)
    flag = torch.zeros(2, dtype=torch.int32, device="cuda")
    tel = torch.zeros(3, dtype=torch.int64, device="cuda")
    y = y0.clone()
    fd.fp_dequant_fallback_cuda(y, x, w_q, scale, flag, tel)
    assert torch.equal(y, y0) and flag.tolist() == [0, 0] and tel.tolist() == [0, 0, 0]
    flag[0] = 1
    fd.fp_dequant_fallback_cuda(y, x, w_q, scale, flag, tel)
    assert flag.tolist() == [0, 0] and tel.tolist() == [1, 0, 0]
    want = ref.fp_dequant_matmul(x, w_q, scale, torch.float32)
    # f32 products summed in another order; bf16 out: the two f32 sums may
    # round to neighbouring bf16 values, one ulp (2^-7 relative) apart
    tol = 1e-5 if dtype == torch.float32 else 2 ** -7
    assert bool(((y.float() - want).abs() <= tol * want.abs() + 1e-5 * float(
        want.abs().max())).all())
    plain = y0.clone()
    fd.fp_dequant_fallback_plain(plain, x, w_q, scale,
                                 torch.ones(2, dtype=torch.int32, device="cuda"))
    assert bool(((y.float() - plain.float()).abs() <= tol * plain.float().abs()
                 + 1e-5 * float(want.abs().max())).all())


# ---------------------------------------------------------------------------
# PDQ health inside the decode graph, the guard, and the service thread
# ---------------------------------------------------------------------------

def test_decode_graph_zeroes_its_counters_every_replay(card_model):
    """The graph zeroes its health vector at the block's start: 100
    replays of the same step give the same vector, never a running sum;
    with telemetry off it stays zeros."""
    eng = _graph_engine(card_model)
    _serve_card(eng)
    rows = _replay_rows(eng, 70)
    first = eng._graph(*rows)[2]
    assert first[0] == 0 and first[2] > 0
    for _ in range(100):
        assert eng._graph(*rows)[2].tolist() == first.tolist()
    off = _graph_engine(card_model, telemetry=False)
    assert off._graph(*_replay_rows(off, 70))[2].tolist() == [0, 0, 0]


@pytest.mark.parametrize("paged", [False, True])
def test_graph_counts_equal_eager_counts(card_model, monkeypatch, paged):
    """A serving run's pdq stats are the same whether every decode
    dispatch replays the graph or steps eagerly (the kernels count the
    same values either way)."""
    kw = dict(decode_steps=4, **(dict(paged=True, page_size=16) if paged else {}))
    eng = _graph_engine(card_model, **kw)
    _serve_card(eng)
    monkeypatch.setattr(engine_mod, "_graphed", lambda device: False)
    plain = _graph_engine(card_model, **kw)
    _serve_card(plain)
    keys = ("pdq_fallbacks", "pdq_clip_hits", "pdq_clip_total")
    assert [eng.stats[k] for k in keys] == [plain.stats[k] for k in keys]
    assert eng.stats["pdq_clip_total"] > 0


def test_guarded_engine_under_fault_falls_back_every_projection(card_model):
    """Built and run under pdq_fault (the capture reads it): every request
    completes with finite logits, the fallback kernel runs once a guarded
    projection a launch (4 a layer), each taken, and K3 never runs."""
    with ops.pdq_fault():
        eng = _graph_engine(card_model, pdq_fallback=True)
        toks, _, counts = _serve_card(eng)
    st, n = eng.stats, eng.cfg.n_layers
    launches = st["prefill_batches"] + st["decode_steps"]
    assert st["failed"] == 0 and st["pdq_fallbacks"] == 4 * n * launches
    c = counts[0]
    assert c["fp_dequant"]["launches"] == c["fp_dequant"]["entries"] == 4 * n * launches
    assert c["w8a8_swiglu_matmul"]["launches"] == 0


def test_guarded_graph_replay_equals_eager(card_model, monkeypatch):
    """pdq_fallback without a fault: the guarded graph serves the eager
    guarded engine's streams and counts, with no fallback taken."""
    eng = _graph_engine(card_model, pdq_fallback=True)
    got = _serve_card(eng)
    monkeypatch.setattr(engine_mod, "_graphed", lambda device: False)
    plain = _graph_engine(card_model, pdq_fallback=True)
    want = _serve_card(plain)
    assert got[0] == want[0] and got[2] == want[2]
    assert eng.stats["pdq_fallbacks"] == 0


def test_service_thread_replays_the_graph(card_model):
    """ServeService's loop thread binds the card and replays the graph
    captured on the main thread: the streams equal a batch run's."""
    from repro_torch.serve import ServeService
    want = _serve_card(_graph_engine(card_model))[0]
    eng = _graph_engine(card_model)
    svc = ServeService(eng, max_pending=16).start()
    streams = [svc.submit(r.prompt, max_new=r.max_new) for r in _graph_reqs(eng.cfg)]
    got = {s.uid: s.result(timeout=600)[0] for s in streams}
    svc.stop()
    assert got == want and eng.stats["graph_replays"] == eng.stats["decode_steps"] > 0


# ---------------------------------------------------------------------------
# the SSD families: landings with f32 state leaves, the decode graph
# ---------------------------------------------------------------------------

def _zamba2_cfg():
    """zamba2-7b at full width with the int8 KV cache (paths Z and ZD)."""
    import dataclasses
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config("zamba2-7b"), quant_kv="dynamic")


def _zamba2_pool(batch, max_len):
    """zamba2-7b's slot-row caches at full width (68 mamba layers' conv and
    f32 state, 13 shared occurrences' int8 K/V)."""
    from repro_torch.models.transformer import lm_init_caches
    return lm_init_caches(_zamba2_cfg(), batch, max_len, "cuda")


def _ssd_leaves(tree):
    return [v for sec in ("blocks", "tail") for d in tree[sec] for _, v in sorted(d.items())]


def test_slot_row_landing_with_ssd_state_leaves(gen):
    """K6 landing a round into zamba2-7b's pool at full width (22 leaves:
    five mamba kinds' conv and 14.7 MB a layer of f32 state, the shared
    kind's k, v, k_scale, v_scale, pos, len, three tail layers') in one
    launch, bit-equal to
    plain; the untouched slots keep their bytes."""
    pool, sub = _zamba2_pool(8, 512), _zamba2_pool(8, 512)
    moves = []
    for sec, ba in (("blocks", 1), ("tail", 0)):
        for c, s_ in zip(pool[sec], sub[sec]):
            for k in c:
                s_[k].copy_(_rand_leaf(gen, s_[k].shape, s_[k].dtype))
                c[k].copy_(_rand_leaf(gen, c[k].shape, c[k].dtype))
                moves.append(kv.Move(c[k], s_[k], batch_axis=ba, host_map=np.array(
                    [2, -1, 0, 1, -1, 3, -1, -1], np.int32)))
    assert len(moves) == 22
    assert any(mv.dst.dtype == torch.float32 and mv.dst.dim() == 5 for mv in moves)
    moves = ops.device_moves(moves)
    want = _plain_of(moves)
    before = kv.COUNT.launches
    kv.cache_move_cuda(moves, kv.COUNT)
    torch.cuda.synchronize()
    assert kv.COUNT.launches == before + 1
    for mv, w in zip(moves, want):
        assert _same_bits(mv.dst, w), tuple(mv.dst.shape)


def test_paged_movements_with_ssd_state_leaves(gen, monkeypatch):
    """K7 on zamba2-7b's paged pool at full width (int8 KV, page 64): the conv and
    state leaves classify flat and move as slot rows in the same launch as
    the shared occurrences' pages, in a landing, a spill's restore and a
    decode gather; each bit-equal to the plain version's movement."""
    cfg = _zamba2_cfg()
    b = build_model(cfg, "cuda")
    po = b.paged_cache(8, 512, 64)
    kinds = {m.kind for d in po.meta["blocks"] + po.meta["tail"] for m in d.values()}
    assert kinds == {"flat", "seq"}
    for j, kind in enumerate(cfg.pattern):
        for name, m in po.meta["blocks"][j].items():
            assert m.kind == ("seq" if kind == "shared" and name != "len" else "flat")
    N = 8 * po.n_pp + 1
    sub = b.init_caches(8, 512)
    for v in _ssd_leaves(sub):
        v.copy_(_rand_leaf(gen, v.shape, v.dtype))
    rows = np.full((N,), -1, np.int32)
    js = np.full((N,), -1, np.int32)
    rows[1:9], js[1:9] = np.repeat([0, 2], 4), np.tile(np.arange(4), 2)
    smap = np.array([0, -1, 2, -1, -1, -1, -1, -1], np.int32)
    rec_pmap = np.full((N,), -1, np.int32)
    rec_pmap[9:13] = np.arange(4)
    rsmap = np.array([-1, 0, -1, -1, -1, -1, -1, -1], np.int32)
    pt = np.full((8, po.n_pp), -1, np.int32)
    pt[0, :4], pt[2, :4], pt[1, :4] = np.arange(1, 5), np.arange(5, 9), np.arange(9, 13)

    def run():
        pool = po.init(N)
        po.land(pool, sub, smap, rows, js)
        rec = po.capture(pool, 0, np.arange(1, 5))
        po.restore(pool, rec, rec_pmap, rsmap)
        logical = po.gather(pool, pt, np.array([200, 150, 256, 0, 0, 0, 0, 0]))
        return _ssd_leaves(pool), _ssd_leaves(logical)

    before = kv.PAGES_COUNT.launches
    got = run()
    torch.cuda.synchronize()
    assert kv.PAGES_COUNT.launches == before + 3
    monkeypatch.setattr(kv, "cache_move_cuda", kv.cache_move_plain)
    want = run()
    for g, w in zip(got[0] + got[1], want[0] + want[1]):
        assert _same_bits(g, w), tuple(g.shape)


@pytest.fixture(scope="module")
def ssd_card_model():
    """zamba2-7b reduced to one pattern block and its tail (9 layers) at
    d_model 256, bf16, int8 KV; the SSM at d_inner 512 (32 heads of 16)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: run this file on the card")
    from repro_torch.models.ssm import SSMConfig
    cfg = reduced_config("zamba2-7b", n_layers=9, d_model=256, d_ff=512, head_dim=64,
                         vocab=1024, dtype="bfloat16", quant_kv="dynamic",
                         ssm=SSMConfig(d_model=256, d_state=16, head_dim=16, expand=2,
                                       d_conv=4, chunk=16))
    return cfg, build_model(cfg, "cuda").init(0)


def _serve_ssd(eng):
    reqs = _graph_reqs(eng.cfg)
    ops.reset_counts()
    eng.run(reqs)
    torch.cuda.synchronize()
    assert all(r.done and r.error is None for r in reqs)
    return ({r.uid: r.generated for r in reqs}, [v.clone() for v in _ssd_leaves(eng.caches)],
            (ops.counts(), ops.route_counts(), ops.prologue_modes()))


@pytest.mark.parametrize("n,paged", [(1, False), (4, False), (1, True), (4, True)])
def test_ssd_decode_graph_replay_equals_eager(ssd_card_model, monkeypatch, n, paged):
    """The SSD decode step writes the conv window and the state in place, so
    a replay of the captured block serves the streams of the same engine
    stepping eagerly, leaves the same pool bits (conv and state included)
    and counts the same launches; slot rows and paged (page 16)."""
    kw = dict(slots=4, max_len=128, buckets=(16, 32, 64), quantize_weights=True,
              device="cuda", decode_steps=n)
    if paged:
        kw.update(paged=True, page_size=16)
    cfg, params = ssd_card_model
    eng = build_engine(ServeConfig(**kw), cfg=cfg, params=params)
    got = _serve_ssd(eng)
    assert eng.stats["graph_replays"] == eng.stats["decode_steps"] > 0
    monkeypatch.setattr(engine_mod, "_graphed", lambda device: False)
    plain = build_engine(ServeConfig(**kw), cfg=cfg, params=params)
    assert plain._graph is None
    want = _serve_ssd(plain)
    assert got[0] == want[0]
    assert all(torch.equal(a, b) for a, b in zip(got[1], want[1]))
    assert got[2] == want[2]


@pytest.fixture(scope="module")
def encdec_card_model():
    """seamless-m4t-medium reduced (2 encoder and 2 decoder layers) at
    d_model 256, bf16, int8 KV, with 8 stub frames."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: run this file on the card")
    from repro_torch.models.frontend import stub_frame_embeddings
    cfg = reduced_config("seamless-m4t-medium", d_model=256, d_ff=512, head_dim=64,
                         vocab=1024, dtype="bfloat16", quant_kv="dynamic")
    g = torch.Generator(device="cuda")
    g.manual_seed(5)
    frames = stub_frame_embeddings(g, 1, 8, cfg.d_model)
    return cfg, build_model(cfg, "cuda").init(0), {"frames": frames}


def _cross_leaves(tree):
    return [v for d in tree["blocks"] for k, v in sorted(d.items()) if k.startswith("cross")]


@pytest.mark.parametrize("n,paged", [(1, False), (4, False), (1, True), (4, True)])
def test_encdec_decode_graph_replay_equals_eager(encdec_card_model, monkeypatch, n, paged):
    """A decoder layer reads its cross K/V from the pool's fixed addresses:
    a replay of the captured block serves the streams of the same engine
    stepping eagerly, leaves the same pool bits (the cross leaves included)
    and counts the same launches; slot rows and paged (page 16, the cross
    leaves flat slot rows)."""
    kw = dict(slots=4, max_len=128, buckets=(16, 32, 64), quantize_weights=True,
              device="cuda", decode_steps=n)
    if paged:
        kw.update(paged=True, page_size=16)
    cfg, params, extras = encdec_card_model

    def serve(eng):
        reqs = _graph_reqs(eng.cfg)
        ops.reset_counts()
        eng.run(reqs, extras=extras)
        torch.cuda.synchronize()
        assert all(r.done and r.error is None for r in reqs)
        return ({r.uid: r.generated for r in reqs}, [v.clone() for v in _leaves(eng.caches)],
                (ops.counts(), ops.route_counts(), ops.prologue_modes()))

    eng = build_engine(ServeConfig(**kw), cfg=cfg, params=params)
    if paged:
        meta = eng._paged_ops.meta["blocks"][0]
        assert meta["cross_k"].kind == meta["cross_v"].kind == "flat"
    got = serve(eng)
    assert eng.stats["graph_replays"] == eng.stats["decode_steps"] > 0
    assert any(bool(v.ne(0).any()) for v in _cross_leaves(eng.caches))
    monkeypatch.setattr(engine_mod, "_graphed", lambda device: False)
    plain = build_engine(ServeConfig(**kw), cfg=cfg, params=params)
    assert plain._graph is None
    want = serve(plain)
    assert got[0] == want[0]
    assert all(torch.equal(a, b) for a, b in zip(got[1], want[1]))
    assert got[2] == want[2]


def test_cnn_training_repeats_its_bits(gen):
    """Two trainings of the same task in one process give the same weights
    bit for bit (cuDNN's deterministic algorithms, ``qlinear.fp32_convs``):
    path G's cls_resnet at its widths, 20 steps."""
    from repro_torch.models import cnn
    cfg = cnn.CNNConfig(arch="mini_resnet", width=24, res=20, n_classes=16)
    runs = [cnn._leaves(cnn.train_cnn(cfg, steps=20, batch=32, device="cuda"))
            for _ in range(2)]
    assert all(torch.equal(a, b) for a, b in zip(*runs))
