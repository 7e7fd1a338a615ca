"""The launch plan of the guard's fp-dequant fallback
(``fp_dequant.plan``, ``fp_dequant.route_for``), which runs on the CPU: a
pure function of the route, the shape and the card's SM count.  Each test
walks the plan the way csrc/fp_dequant.cu does (block b takes work items
b, b + grid, ...; item i is split i % splits of tile i // splits; tile t
is row tile t // col_tiles and column tile t % col_tiles; split s covers
k stages [s kc, (s + 1) kc) below nks) and checks that every output element
and every k stage of it is computed exactly once, that the grid stays
persistent and small whatever M is, and that the workspace and tickets a
split needs fit.  On the CPU the wrapper takes the plain version and
counts no route.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import fp_dequant as fd
from repro_torch.kernels import ops
from repro_torch.kernels import ref
from repro_torch.kernels import w8a8_matmul as mm

SMS = 132                             # an H100 SXM's SMs

# (K, N) of the guarded projections on the card paths at full width:
# stablelm-1.6b's QKV, wo, gate/up, w_down and a 2-way TP shard's QKV and
# w_down; gemma3-12b's (H) and yi-6b's QKV and w_down
PROJECTIONS = [(2048, 6144), (2048, 2048), (2048, 11264), (5632, 2048), (2048, 3072),
               (5632, 1024), (3840, 8192), (15360, 3840), (4096, 5120), (11008, 4096)]
RAGGED = [(5, 100, 70), (17, 33, 129), (1, 1, 1), (3, 7, 300), (70, 130, 65)]


def _tile_shape(p):
    """(x rows, output columns) of one tile."""
    return p.rows, fd.CT if p.route == "wgmma" else fd.FMA_BN


def _walk(p):
    """How often the launch runs each tile's epilogue and sums each k stage
    of each tile, and how often each work item is taken by a block."""
    tiles = p.row_tiles * p.col_tiles
    stages = np.zeros((tiles, p.nks), np.int64)
    done = np.zeros(tiles, np.int64)
    taken = np.zeros(p.items, np.int64)
    for b in range(p.grid):
        for item in range(b, p.items, p.grid):
            taken[item] += 1
            tile, split = divmod(item, p.splits)
            ks0 = split * p.kc
            ks1 = min(p.nks, ks0 + p.kc)
            assert ks0 < ks1, "every split has a stage"
            stages[tile, ks0:ks1] += 1
            done[tile] += split == p.splits - 1    # the merge's epilogue, once a tile
    return done, stages, taken


def _check(p, M, K, N):
    """The tiles partition the (M, N) output (the last row and column tile
    masked), and _walk finds each tile, stage and item exactly once."""
    done, stages, taken = _walk(p)
    assert (done == 1).all() and (stages == 1).all() and (taken == 1).all()
    rows, cols = _tile_shape(p)
    assert (p.row_tiles - 1) * rows < M <= p.row_tiles * rows
    assert (p.col_tiles - 1) * cols < N <= p.col_tiles * cols
    assert p.nks == max(1, -(-K // fd.KS))
    assert (p.splits - 1) * p.kc < p.nks <= p.splits * p.kc
    assert p.items == p.row_tiles * p.col_tiles * p.splits
    assert 1 <= p.grid <= min(p.items, fd.PER_SM[p.route] * SMS)
    if p.splits > 1:
        assert p.row_tiles * p.col_tiles <= fd.MAX_TICKETS
        # every thread's accumulators of every (split, tile)
        assert p.ws == p.splits * p.row_tiles * p.col_tiles * fd.THREADS * p.acc
    else:
        assert p.ws == 0


@pytest.mark.parametrize("M", [1, 4, 8, 16, 17, 64, 65, 130, 2048])
@pytest.mark.parametrize("K,N", PROJECTIONS)
@pytest.mark.parametrize("route", ["wgmma", "fma", "generic"])
def test_plan_covers_every_output_and_stage_once(route, K, N, M):
    """Every card path's projections at decode and prefill rows: each
    output element written once (by the last split of its tile), each k
    stage of a tile summed once, each work item taken by one block."""
    _check(fd.plan(route, M, K, N, SMS), M, K, N)


@pytest.mark.parametrize("M,K,N", RAGGED)
def test_plan_of_ragged_shapes(M, K, N):
    """The generic route's ragged K, M and N (and K below one stage)."""
    _check(fd.plan("generic", M, K, N, SMS), M, K, N)


@pytest.mark.parametrize("M,rows", [(1, 8), (8, 8), (9, 16), (16, 16), (17, 32), (33, 64),
                                    (64, 64), (65, 128), (2048, 128)])
def test_wgmma_orientation_and_accumulators(M, rows):
    """Decode rows swap A and B with n = M rounded up to 8, 16, 32 or 64
    (n / 2 f32 accumulators a thread); from 65 rows, 128-row tiles of x
    against 128 columns (64 a thread)."""
    p = fd.plan("wgmma", M, 2048, 6144, SMS)
    assert p.rows == rows
    assert p.acc == (rows // 2 if M <= fd.DECODE_ROWS else 64)
    assert p.row_tiles == (1 if M <= fd.DECODE_ROWS else -(-M // fd.BM))


def test_plans_at_the_main_shapes():
    """stablelm-1.6b's decode projections split K so that the weight
    spreads over most SMs (QKV 96 blocks, wo and w_down 128); gate/up's 88
    column tiles take no split (a second round of items would cost more
    than it spreads); prefill rows need no split.  The f32 route tiles 16
    x 64."""
    assert fd.plan("wgmma", 8, 2048, 6144, SMS) == fd.Plan(
        "wgmma", 8, 1, 48, 32, 16, 2, 96, 96, 4, 2 * 48 * 256 * 4)
    assert fd.plan("wgmma", 8, 5632, 2048, SMS) == fd.Plan(
        "wgmma", 8, 1, 16, 88, 11, 8, 128, 128, 4, 8 * 16 * 256 * 4)
    assert fd.plan("wgmma", 8, 2048, 2048, SMS).grid == 128
    p = fd.plan("wgmma", 8, 2048, 11264, SMS)
    assert (p.splits, p.grid, p.ws) == (1, 88, 0)
    p = fd.plan("wgmma", 2048, 2048, 6144, SMS)
    assert (p.rows, p.row_tiles, p.col_tiles, p.splits, p.items, p.grid, p.ws) == (
        128, 16, 48, 1, 768, SMS, 0)
    p = fd.plan("fma", 8, 2048, 6144, SMS)
    assert (p.rows, p.row_tiles, p.col_tiles, p.acc) == (16, 1, 96, 4)


@pytest.mark.parametrize("route", ["wgmma", "fma", "generic"])
@pytest.mark.parametrize("K,N", [(2048, 6144), (5632, 2048)])
def test_untaken_grid_does_not_grow_with_m(route, K, N):
    """The persistent grid (every block reads the flag and draws one
    ticket) is at most one block an SM on the tensor-core route, two on
    the CUDA-core routes, at 8 rows and at 2048."""
    cap = fd.PER_SM[route] * SMS
    grids = [fd.plan(route, M, K, N, SMS).grid for M in (1, 8, 64, 2048, 16384)]
    assert max(grids) <= cap
    assert fd.plan(route, 16384, K, N, SMS).grid == cap


@pytest.mark.parametrize("M,K,N", [(8, 2048, 6144), (8, 5632, 2048), (2048, 2048, 6144),
                                   (130, 5632, 2048), (5, 100, 70)])
@pytest.mark.parametrize("route", ["wgmma", "fma"])
def test_split_count_is_the_cheapest(route, M, K, N):
    """The chosen split minimizes the busiest block's stages plus the
    items' tails over every kc (ties keep fewer splits)."""
    p = fd.plan(route, M, K, N, SMS)
    tiles = p.row_tiles * p.col_tiles
    blocks = fd.PER_SM[route] * SMS

    def cost(kc):
        s = -(-p.nks // kc)
        tail = fd.SPLIT_TAIL + p.acc // 2 if s > 1 else fd.EPI_TAIL
        return -(-tiles * s // blocks) * (kc + tail)

    assert all(cost(p.kc) <= cost(kc) for kc in range(1, p.nks + 1))


def test_route_for_dtype_shape_and_address():
    """bf16 x takes the tensor cores and f32 x the fma route where TMA can
    describe both operands (K % 16 == 0, 16-byte aligned bases); any of
    them off takes the generic route.  A TP shard's K-major column slice
    keeps an aligned base."""
    w = mm.k_major(torch.zeros((64, 32), dtype=torch.int8))
    for dtype, route in ((torch.bfloat16, "wgmma"), (torch.float32, "fma")):
        x = torch.zeros((8, 64), dtype=dtype)
        assert fd.route_for(x, w) == route
        assert fd.route_for(torch.zeros((8, 65), dtype=dtype),
                            mm.k_major(torch.zeros((65, 32), dtype=torch.int8))) == "generic"
        off = torch.zeros((8 * 64 + 1,), dtype=dtype)[1:].view(8, 64)
        assert fd.route_for(off, w) == "generic"
    shard = mm.k_major(torch.zeros((64, 64), dtype=torch.int8))[:, 32:]
    assert mm.is_k_major(shard) and shard.data_ptr() % 16 == 0
    assert fd.route_for(torch.zeros((8, 64), dtype=torch.bfloat16), shard) == "wgmma"
    odd = torch.zeros((32 * 64 + 1,), dtype=torch.int8)[1:].view(32, 64).t()
    assert mm.is_k_major(odd) and odd.data_ptr() % 16
    assert fd.route_for(torch.zeros((8, 64), dtype=torch.bfloat16), odd) == "generic"


def test_plan_refuses_an_unknown_route():
    with pytest.raises(ValueError, match="route"):
        fd.plan("tiles", 8, 64, 64, SMS)


def test_cpu_tensors_take_the_plain_version_and_count_no_route():
    """On the CPU the wrapper decides on the host: taken, y is the plain
    product and one fallback is counted; no route is counted either way."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn((4, 48), generator=g).to(torch.bfloat16)
    w = mm.k_major(torch.randint(-127, 128, (48, 40), generator=g, dtype=torch.int8))
    scale = 0.01 * torch.rand((40,), generator=g)
    y = torch.zeros((4, 40), dtype=torch.bfloat16)
    flag = torch.tensor([1, 0], dtype=torch.int32)
    tel = torch.zeros(3, dtype=torch.int64)
    ops.reset_counts()
    fd.fp_dequant_fallback(y, x, w, scale, flag, tel)
    assert torch.equal(y, ref.fp_dequant_matmul(x, w, scale, torch.bfloat16))
    assert flag.tolist() == [0, 0] and tel.tolist() == [1, 0, 0]
    assert ops.route_counts()["fp_dequant"] == {"wgmma": 0, "fma": 0, "generic": 0}
    assert ops.counts()["fp_dequant"]["launches"] == 0
