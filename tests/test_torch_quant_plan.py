"""The launch plans of K8 (``act_stats.plan``), K9 (``quantize.plan``)
and K10 (``quantize.dequantize_plan``), which run on the CPU: pure
functions of shape, strides, alignment and the card's L2.  Each test walks
the plan the way the kernel's loops do (csrc/act_stats.cu
``act_stats_kernel``: one block a row, thread t loading units t + i *
threads, C of them at a time; csrc/quantize.cu ``quantize_kernel`` and
``dequantize_kernel``: thread g taking pair g of the row-major (row,
columns) pairs) and checks that every row, and every unit or column of it,
is visited exactly once, at ragged K and N, on gamma views and past the
old 65535-row grid; and that each route is taken only where the base, the
row length, the strides and the size allow it.  On the CPU the wrappers
take the plain versions and count no route.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import act_stats as st
from repro_torch.kernels import ops
from repro_torch.kernels import quantize as qz

L2 = 50 * 2 ** 20                     # an H100's L2


def _k8_units_visited(p):
    """How often a row's block visits each unit of the row: thread t loads
    u0 + i * threads for u0 from t by threads * chunk, i < chunk."""
    t = np.arange(p.threads)[:, None, None]
    j = np.arange(-(-p.units // (p.threads * p.chunk)) + 1)[None, :, None]
    i = np.arange(p.chunk)[None, None, :]
    u0 = t + j * p.threads * p.chunk
    u = np.broadcast_to(u0 + i * p.threads, (p.threads, j.shape[1], p.chunk))
    ok = np.broadcast_to(u0 < p.units, u.shape) & (u < p.units)
    return np.bincount(u[ok], minlength=p.units)


def _k8_plan(x, l2=L2):
    rows, inner, so, si, K = st.row_layout(x)
    return st.plan(rows, K, x.element_size(), x.data_ptr() % 16 == 0, so, si, l2)


def _row_offset(row, rows, inner, outer_stride, inner_stride):
    """csrc/act_stats.cu row_offset: no division for one outer entry."""
    if inner >= rows:
        return row * inner_stride
    return (row // inner) * outer_stride + (row % inner) * inner_stride


@pytest.mark.parametrize("shape,K,dtype,gamma", [
    ((1,), 11264, torch.float32, 1), ((16385,), 2048, torch.bfloat16, 1),
    ((8,), 2048, torch.float32, 1), ((2048,), 5632, torch.float32, 1),
    ((70001,), 36, torch.float32, 1), ((300,), 290, torch.bfloat16, 1),
    ((5,), 33, torch.float32, 1), ((3, 51), 64, torch.float32, 4),
    ((8, 256), 2048, torch.bfloat16, 4), ((2, 99), 2049, torch.bfloat16, 3),
    ((4, 75), 5632, torch.float32, 3), ((1,), 1, torch.float32, 1)])
def test_act_stats_plan_visits_every_row_and_unit_once(shape, K, dtype, gamma):
    """Ragged K, gamma views (odd inner counts), one row and 70001 rows: one
    block a row at the offset the strides give, and every unit of the row
    loaded by exactly one of its threads once."""
    x = torch.empty((*shape, K), dtype=dtype)
    if gamma > 1:
        x = x[:, ::gamma, :]
    x3 = x if x.dim() == 3 else x[None]
    rows, inner, so, si, _ = st.row_layout(x3)
    p = _k8_plan(x3)
    assert rows == x[..., 0].numel() <= st.MAX_ROWS
    assert (_k8_units_visited(p) == 1).all()
    assert p.units == (K // (16 // x.element_size()) if p.vector else K)
    outer, inner_n = x3.shape[:2]
    want = [o * so + i * si for o in range(outer) for i in range(inner_n)]
    got = [_row_offset(r, rows, inner, so, si) for r in range(rows)]
    assert got == want


@pytest.mark.parametrize("K,elem", [(1, 4), (33, 4), (64, 4), (290, 2), (2048, 4),
                                    (2048, 2), (5632, 4), (11264, 4), (11264, 2)])
def test_act_stats_plan_sizes_the_block_to_the_row(K, elem):
    """About two units a thread, 32 to 256 threads a block, and as many
    units in flight a thread as it has (at most 8): a row up to 256 x 8
    units is one round trip; longer rows loop over chunks."""
    p = st.plan(16, K, elem, True, 16 * K, K, L2)
    assert p.threads in (32, 64, 128, 256) and p.chunk in (1, 2, 4, 8)
    assert p.threads == 256 or p.units <= 2 * p.threads
    assert p.threads * p.chunk >= min(p.units, 256 * 8)
    assert p.chunk == 1 or p.threads * p.chunk // 2 < p.units
    assert (_k8_units_visited(p) == 1).all()


def test_act_stats_plan_at_path_e_shapes():
    """E's rows: 2048 f32 columns one round trip of 256 threads, two 16-byte
    loads each; 2048 bf16 columns 128 threads; w_down's 5632 columns 256
    threads of up to 8 loads.  None of E's inputs is larger than the L2;
    16384 rows of 2048 f32 (128 MiB) are, and stream."""
    assert st.plan(2048, 2048, 4, True, 0, 2048, L2) == st.Plan(True, 512, 256, 2, False)
    assert st.plan(8, 2048, 2, True, 0, 2048, L2) == st.Plan(True, 256, 128, 2, False)
    assert st.plan(2048, 5632, 4, True, 0, 5632, L2) == st.Plan(True, 1408, 256, 8, False)
    assert st.plan(512, 2048, 2, True, 256 * 2048, 4 * 2048, L2).threads == 128
    assert st.plan(16384, 2048, 4, True, 0, 2048, L2).stream


@pytest.mark.parametrize("elem,vec", [(4, 4), (2, 8)])
def test_act_stats_vector_route_only_where_every_row_allows_it(elem, vec):
    """16-byte units need an aligned base, K and both strides multiples of
    the vector; any one of them off takes the element route, which never
    streams."""
    K = 4 * vec
    assert st.plan(10, K, elem, True, 5 * K, K, L2).vector
    for args in ((False, 5 * K, K), (True, 5 * K + 1, K), (True, 5 * K, K + 1)):
        p = st.plan(10, K, elem, *args, L2)
        assert not p.vector and not p.stream
    assert not st.plan(10, K + 1, elem, True, 5 * (K + 1), K + 1, L2).vector
    assert not st.plan(10 ** 6, K + 1, elem, True, 5 * (K + 1), K + 1, 1).stream


def test_act_stats_streams_only_past_the_l2():
    """Evict-first loads only when the rows read are more bytes than the
    L2 holds."""
    rows = L2 // (2048 * 4)
    assert not st.plan(rows, 2048, 4, True, 0, 2048, L2).stream
    assert st.plan(rows + 1, 2048, 4, True, 0, 2048, L2).stream


def test_act_stats_plan_of_tensors_misaligned_base_and_gamma_view():
    """What the wrapper derives from a tensor: x[:, 1:] (4 bytes off 16,
    odd stride) takes the element route; a gamma view of aligned rows
    whose strides are multiples of the vector keeps the vector route."""
    x = torch.empty((6, 65), dtype=torch.float32)[:, 1:]
    assert x.data_ptr() % 16 and not _k8_plan(x[None]).vector
    g = torch.empty((8, 256, 2048), dtype=torch.bfloat16)[:, ::4]
    if g.data_ptr() % 16 == 0:
        assert _k8_plan(g).vector


def _k9_visits(p, M, N):
    """How often the kernel's threads write each (row, column): thread g
    takes pair g = row * units + u, columns u * columns ... + columns - 1
    below N; threads past M * units exit."""
    g = np.arange(p.grid * p.threads, dtype=np.int64)
    row, u = g // p.units, g % p.units
    live = row < M
    cols = u[live, None] * p.columns + np.arange(p.columns)[None, :]
    rows = np.broadcast_to(row[live, None], cols.shape)
    ok = cols < N
    seen = np.zeros((M, N), np.int64)
    np.add.at(seen, (rows[ok], cols[ok]), 1)
    return seen


@pytest.mark.parametrize("per_channel", [False, True])
@pytest.mark.parametrize("M,N,elem", [(1, 1, 4), (8, 2048, 4), (8, 2048, 2), (300, 290, 4),
                                      (2048, 2049, 2), (70000, 16, 4), (65537, 33, 2),
                                      (7000, 2048, 4)])
def test_quantize_plan_visits_every_element_once(M, N, elem, per_channel):
    """Past the old 65535-row grid and at ragged N (the last pair of a row
    masked): every (row, column) exactly once, on a grid of one pair a
    thread that wastes less than one block."""
    p = qz.plan(M, N, elem, per_channel, True, 1 if M == 7000 else L2)
    assert p.units * p.columns >= N > (p.units - 1) * p.columns
    assert (p.grid - 1) * p.threads < M * p.units <= p.grid * p.threads
    assert (_k9_visits(p, M, N) == 1).all()


def test_quantize_routes_only_where_every_row_allows_them():
    """The vector route (4 f32 or 8 bf16 columns a thread) needs aligned
    bases and N a multiple of its columns; the wide route (16 f32 columns)
    only f32 per row larger than the L2; the element route takes the rest."""
    assert qz.plan(64, 256, 4, False, True, L2) == qz.Plan("vector", 4, 64, 256, 16)
    assert qz.plan(64, 256, 2, True, True, L2) == qz.Plan("vector", 8, 32, 128, 16)
    assert qz.plan(64, 256, 4, False, False, L2).route == "element"
    for N, elem in ((290, 4), (2049, 2), (6, 4), (12, 2)):
        assert qz.plan(64, N, elem, False, True, L2).route == "element"
    assert qz.plan(16384, 2048, 4, False, True, L2).route == "wide"
    for args in ((16384, 2048, 2, False), (16384, 2048, 4, True), (2048, 2048, 4, False),
                 (16384, 2056, 4, False)):
        assert qz.plan(*args, True, L2).route != "wide"
    assert qz.plan(16384, 2048, 4, False, False, L2).route == "element"


@pytest.mark.parametrize("per_channel", [False, True])
@pytest.mark.parametrize("M,N,elem", [(1, 1, 4), (8, 2048, 4), (2048, 2048, 2), (300, 290, 4),
                                      (2048, 2049, 2), (70000, 32, 4), (65537, 33, 2),
                                      (16384, 2048, 4)])
def test_dequantize_plan_visits_every_element_once(M, N, elem, per_channel):
    """K10's 16 codes a thread, one (row, 16 columns) pair a thread on a
    1-D grid: past the old 65535-row grid and at ragged N, every (row,
    column) exactly once, wasting less than one block."""
    p = qz.dequantize_plan(M, N, elem, True)
    assert p.columns == 16 and p.threads == 256 and p.grid <= qz.MAX_GRID
    assert p.units * p.columns >= N > (p.units - 1) * p.columns
    assert (p.grid - 1) * p.threads < M * p.units <= p.grid * p.threads
    if M * N <= 2 ** 22:
        assert (_k10_visits(p, M, N, elem) == 1).all()


def _k10_visits(p, M, N, elem):
    """How often K10's threads write each (row, column).  Vector route:
    block b's group j of thread t starts at flat code b * 4096 +
    (j * 256 + t) * G, G = 16 / elem codes, and lies in one row; element
    route: K9's (row, 16 columns) pairs."""
    if p.route == "element":
        return _k9_visits(p, M, N)
    G = 16 // elem
    assert N % G == 0
    b = np.arange(p.grid)[:, None, None]
    j = np.arange(16 // G)[None, :, None]
    t = np.arange(p.threads)[None, None, :]
    e = (b * p.threads * 16 + (j * p.threads + t) * G).ravel()
    e = e[e < M * N]
    assert ((e % N) + G <= N).all()
    seen = np.zeros(M * N, np.int64)
    np.add.at(seen, (e[:, None] + np.arange(G)[None, :]).ravel(), 1)
    return seen.reshape(M, N)


def test_dequantize_routes_only_where_every_row_allows_them():
    """The vector route needs aligned bases and N % 16 == 0 (each row then
    starts aligned), at any size; the element route takes the rest."""
    assert qz.dequantize_plan(2048, 2048, 4, True) == qz.Plan("vector", 16, 128, 256, 1024)
    for M, elem in ((2048, 2), (16384, 4), (16384, 2), (70000, 4)):
        assert qz.dequantize_plan(M, 2048, elem, True).route == "vector"
    for N in (8, 290, 2049, 2056):
        assert qz.dequantize_plan(64, N, 4, True).route == "element"
    assert qz.dequantize_plan(2048, 2048, 4, False).route == "element"


def _multiply_shift(d):
    """csrc/act_stats.cu make_rows and csrc/quantize.cu make_divisor."""
    shift = 31
    while (1 << (shift - 31)) < d:
        shift += 1
    return -(-(1 << shift) // d), shift


@pytest.mark.parametrize("d", [1, 2, 3, 7, 13, 64, 100, 2049, 65537, 2 ** 20 + 7,
                               2 ** 30 + 1, 2 ** 31 - 1])
def test_multiply_shift_division_is_exact(d):
    """The kernels' row / inner and pair / units: (n * magic) >> shift
    equals n // d for every n < 2^31, the product within 64 bits."""
    magic, shift = _multiply_shift(d)
    rng = np.random.default_rng(d)
    near = np.arange(1, 64, dtype=np.int64)[:, None] * d + np.arange(-1, 2)[None, :]
    ns = np.concatenate([np.arange(0, 200), [2 ** 31 - 1, 2 ** 31 - 2],
                         near.ravel() % 2 ** 31, rng.integers(0, 2 ** 31, 2000)])
    assert magic * (2 ** 31 - 1) < 2 ** 64
    assert all((int(n) * magic) >> shift == int(n) // d for n in ns)


def test_cpu_tensors_take_the_plain_versions_and_count_no_route():
    g = torch.Generator().manual_seed(0)
    x = torch.randn((5, 48), generator=g)
    s = torch.full((5, 1), 0.05)
    z = torch.zeros((5, 1), dtype=torch.int32)
    ops.reset_counts()
    assert all(torch.equal(a, b) for a, b in zip(st.act_stats(x), st.act_stats_plain(x)))
    assert torch.equal(qz.quantize(x, s, z), qz.quantize_plain(x, s, z))
    rc = ops.route_counts()
    assert rc["act_stats"] == {"vector": 0, "element": 0}
    assert rc["quantize"] == {"vector": 0, "wide": 0, "element": 0}
    assert torch.equal(qz.dequantize(qz.quantize(x, s, z), s, z),
                       qz.dequantize_plain(qz.quantize_plain(x, s, z), s, z))
    assert ops.route_counts()["dequantize"] == {"vector": 0, "element": 0}
    assert ops.counts()["act_stats"]["launches"] == ops.counts()["quantize"]["launches"] == 0
