"""The split route's launch plan for the int8-KV attend kernels K4 and K5
(``repro_torch/kernels/kv_cache.py`` ``attend_plan``), on the CPU: the
chunks cover the cache's sequence axis exactly, the grid comes from the
cache's shape and never from the lengths, the workspace and ticket sizes
are the documented ones, each shape takes the register plan sized for it
(the (8, 128) or the wide (2, 256) one), and shapes past
the kernels' limits raise ``ValueError`` before anything is launched.  The kernels themselves run
in tests/test_torch_cuda.py on the card.
"""
import pytest
import torch

from repro_torch.kernels import kv_cache as kv
from repro_torch.kernels import ops

torch.set_num_threads(1)

# (B, Hkv, G, Sp, Dh): chip_smoke.py's two kernel-table shapes, the path A
# cache, ragged ones around the chunk, and the wide instance's: gemma3-12b's
# global layers (path H's cache, G 2, Dh 256) and a ragged one past Dh 128
SHAPES = [(8, 32, 1, 512, 64), (8, 32, 1, 4096, 64), (8, 32, 1, 128, 64),
          (9, 3, 8, 4096, 128), (1, 1, 1, 1, 16), (3, 2, 4, 127, 48),
          (3, 2, 4, 129, 32), (2, 5, 2, 300, 80), (4, 1, 1, 0, 64),
          (8, 8, 2, 2048, 256), (3, 2, 2, 300, 144)]


@pytest.mark.parametrize("B,Hkv,G,Sp,Dh", SHAPES)
def test_chunks_cover_the_sequence_exactly(B, Hkv, G, Sp, Dh):
    plan = kv.attend_plan(B, Hkv, G, Sp, Dh)
    # block (s, h, b) owns [s * chunk, (s + 1) * chunk), the last cut at Sp
    chunks = [(s * plan.chunk, min((s + 1) * plan.chunk, Sp)) for s in range(plan.grid[0])]
    assert plan.chunk == kv.CHUNK == 128
    assert len(chunks) == plan.splits == max(1, -(-Sp // plan.chunk))
    assert chunks[0][0] == 0 and chunks[-1][1] == Sp
    for (a0, a1), (b0, b1) in zip(chunks, chunks[1:]):
        assert a1 == b0 and a0 < a1                 # no gap, no overlap
    assert all(e - s0 <= plan.chunk for s0, e in chunks)
    covered = torch.zeros(Sp, dtype=torch.int32)
    for s0, e in chunks:
        covered[s0:e] += 1
    assert bool((covered == 1).all())


@pytest.mark.parametrize("B,Hkv,G,Sp,Dh", SHAPES)
def test_grid_depends_on_the_shape_not_the_lengths(B, Hkv, G, Sp, Dh):
    """The plan takes no lengths at all: whatever they are, the grid is
    (ceil(Sp / chunk), Hkv, B), and a (b, h) has as many splits as Sp
    gives, of which the blocks past length[b] return unread."""
    plan = kv.attend_plan(B, Hkv, G, Sp, Dh)
    assert plan.grid == (max(1, -(-Sp // 128)), Hkv, B)
    assert plan == kv.attend_plan(B, Hkv, G, Sp, Dh)
    # a longer cache with the same lengths launches more blocks
    assert kv.attend_plan(B, Hkv, G, Sp + 128, Dh).grid[0] == plan.grid[0] + (Sp > 0)


@pytest.mark.parametrize("B,Hkv,G,Sp,Dh", SHAPES)
def test_workspace_and_tickets_are_as_documented(B, Hkv, G, Sp, Dh):
    plan = kv.attend_plan(B, Hkv, G, Sp, Dh)
    # a split's record: m and l per query head, then G * Dh outputs,
    # padded to a multiple of 4 f32 (16 bytes)
    assert plan.record % 4 == 0 and G * (Dh + 2) <= plan.record < G * (Dh + 2) + 4
    assert plan.workspace_bytes == B * Hkv * plan.splits * plan.record * 4
    assert plan.tickets == B * Hkv + B


def test_main_path_plan_numbers():
    """Path A's cache (B 8, Hkv 32, G 1, Dh 64, Sp 512): 4 splits, 1024
    blocks, 68-float records, 278 528 workspace bytes; the kernel-table
    long shape (Sp 4096): 32 splits, 2.2 MB."""
    a = kv.attend_plan(8, 32, 1, 512, 64)
    assert (a.splits, a.grid, a.record, a.workspace_bytes, a.tickets) == (
        4, (4, 32, 8), 68, 278528, 264)
    long = kv.attend_plan(8, 32, 1, 4096, 64)
    assert (long.splits, long.workspace_bytes) == (32, 2228224)


def test_wide_instance_plan_numbers():
    """Path H's global-layer cache (B 8, Hkv 8, G 2, Dh 256, Sp 2048): 16
    splits, 1024 blocks, 516-float records (2 x (256 + 2)), 16.9 MB of
    workspace; the built plans take (8, 128) first, then the wide (2, 256)
    one (which instance a launch takes is the library's own choice,
    ``kv.attend_instance``, held on the card in tests/test_torch_cuda.py)."""
    h = kv.attend_plan(8, 8, 2, 2048, 256)
    assert (h.splits, h.grid, h.record, h.workspace_bytes, h.tickets) == (
        16, (16, 8, 8), 516, 8 * 8 * 16 * 516 * 4, 72)
    assert kv.ATTEND_PLANS == ((8, 128), (2, 256))
    assert [kv.attend_plan_of(G, Dh) for G, Dh in ((2, 256), (8, 128), (1, 64), (1, 144))] == [
        1, 0, 0, 1]


@pytest.mark.parametrize("B,Hkv,G,Dh", [(65536, 1, 1, 64), (2, 65536, 1, 64),
                                        (2, 4, 9, 64), (2, 4, 1, 272), (2, 4, 1, 40),
                                        (2, 4, 1, 8), (2, 4, 0, 64), (2, 0, 1, 64),
                                        (2, 4, 3, 256), (2, 4, 4, 256), (2, 4, 3, 144)])
def test_over_limit_shapes_raise_value_error(B, Hkv, G, Dh):
    with pytest.raises(ValueError, match="decode_attend_i8kv takes"):
        kv.attend_plan(B, Hkv, G, 256, Dh)


def test_limits_hold_for_the_operands_too():
    """``attend_limits`` is what the wrappers' operand check applies: H not
    a multiple of Hkv, or G = H / Hkv above 8, raises."""
    with pytest.raises(ValueError, match="H = G \\* Hkv"):
        kv.attend_limits(2, 10, 4, 64)
    with pytest.raises(ValueError, match="H = G \\* Hkv"):
        kv.attend_limits(2, 36, 4, 64)
    assert kv.attend_limits(8, 32, 32, 64) == 1 and kv.attend_limits(2, 32, 4, 128) == 8
    # the wide instance: G 2 at Dh 256 (G * Dh 512), and no further
    assert kv.attend_limits(8, 16, 8, 256) == 2
    for H, Hkv, Dh in ((24, 8, 256), (16, 8, 272), (32, 8, 160)):
        with pytest.raises(ValueError, match="H = G \\* Hkv"):
            kv.attend_limits(8, H, Hkv, Dh)


def test_routes_are_counted_and_checked():
    """K4/K5 count launches per route beside K2/K3 (``ops.route_counts``);
    a route other than split or single is refused before any launch."""
    ops.reset_counts()
    rc = ops.route_counts()
    assert rc["decode_attend_i8kv"] == {"split": 0, "single": 0}
    assert rc["decode_attend_i8kv_fused"] == {"split": 0, "single": 0}
    assert rc["w8a8_matmul"] == {"wgmma": 0, "generic": 0}
    assert kv._route(None) == "split" and kv._route("single") == "single"
    with pytest.raises(ValueError, match="route must be"):
        kv._route("tiles")


def test_cpu_tensors_take_the_plain_version():
    """On the CPU the wrapper runs the plain version and launches nothing
    (no route counted)."""
    g = torch.Generator().manual_seed(0)
    B, Hkv, G, Sp, Dh = 2, 2, 2, 130, 32
    args = (torch.randn((B, Hkv * G, Dh), generator=g),
            torch.randint(-127, 128, (B, Hkv, Sp, Dh), generator=g, dtype=torch.int8),
            torch.randint(-127, 128, (B, Hkv, Sp, Dh), generator=g, dtype=torch.int8),
            0.01 + 0.04 * torch.rand((B, Hkv, Sp), generator=g),
            0.01 + 0.04 * torch.rand((B, Hkv, Sp), generator=g),
            torch.tensor([130, 7], dtype=torch.int32))
    ops.reset_counts()
    o = kv.decode_attend_i8kv(*args)
    fo = kv.decode_attend_i8kv_fused(*args, torch.bfloat16)
    assert torch.equal(o, kv.decode_attend_i8kv_plain(*args)) and torch.equal(fo[0], o)
    assert all(v == 0 for r in kv.ROUTES.values() for v in r.values())
    assert ops.counts()["decode_attend_i8kv"]["launches"] == 0
