"""Pool movements as one launch over every leaf (``ops.cache_move``, the
kernel in ``csrc/kv_cache.cu``), on the CPU, where the multi-leaf plain
version runs:

- the movement plan (``kernels.kv_cache.move_plan``) is built from shapes
  alone, on meta tensors: at the full-width paged configuration (stablelm-
  1.6b, int8 KV, 8 slots, max_len 512, page 64) the decode gather at
  position 300 writes the whole 428.2 MB logical tree and reads its 5 of
  8 valid pages, 267.6 MB, in 4 KiB runs of k/v and 256-byte runs of the
  scales and ``pos``; the write-back moves one page a slot and leaf, 53.5
  MB each way;
- the multi-leaf plain version equals the per-leaf ``ref`` composition
  (the init broadcast, then ``ref.cache_scatter_pages_ref``) on every pool
  movement: gather, write-back, paged landing, COW copy, restore and the
  slot-row landing;
- the gather writes every byte of its scratch: a scratch pre-filled with
  random bytes or with the init gives the same tree, which equals JAX's
  ``paged_cache(...).gather`` on the same pool (fp and int8 KV, max_len 64
  and 96); a paged leaf whose init is not one repeated element raises;
- one map per movement and leaf group goes to the device in one copy, and
  the census of a paged engine run is one launch a movement.

Exact throughout: the movements copy bits.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as j_reduced
from repro.models import build_model as j_build
from repro_torch.bridge import _tensor
from repro_torch.configs import get_config
from repro_torch.configs import reduced_config as t_reduced
from repro_torch.kernels import kv_cache as tkv
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.models import api as tapi
from repro_torch.models import build_model as t_build
from repro_torch.serve import Request, ServeConfig, build_engine

torch.set_num_threads(1)


def _t(a):
    return _tensor(np.asarray(a), "cpu")


def _bits(x):
    if torch.is_tensor(x):
        return x.contiguous().view(torch.uint8).numpy()
    return np.ascontiguousarray(np.asarray(x)).view(np.uint8)


def _same(a, b):
    return np.array_equal(_bits(a), _bits(b))


def _rand_tree(gen, tree):
    """A tree like ``tree`` with random bits in every leaf."""
    def one(x):
        b = torch.randint(0, 256, (x.numel() * x.element_size(),), generator=gen,
                          dtype=torch.uint8)
        return b.view(x.dtype).reshape(x.shape).clone()
    return {sec: tuple({k: one(v) for k, v in d.items()} for d in tree[sec])
            for sec in ("head", "tail", "blocks")}


# ---------------------------------------------------------------------------
# the plan, from shapes alone, at the full-width paged configuration
# ---------------------------------------------------------------------------

B, MAX_LEN, PAGE, POS = 8, 512, 64, 300


@pytest.fixture(scope="module")
def d1_ops():
    cfg = dataclasses.replace(get_config("stablelm-1.6b"), quant_kv="dynamic")
    po = t_build(cfg, "cpu").paged_cache(B, MAX_LEN, PAGE)
    n_pp = MAX_LEN // PAGE
    pool = po.init(B * n_pp + 1, device="meta")        # allocates nothing
    pt = (1 + np.arange(B * n_pp, dtype=np.int32)).reshape(B, n_pp)
    return po, pool, pt


def test_gather_plan_from_shapes_at_full_width(d1_ops):
    po, pool, pt = d1_ops
    logical, moves = po.gather_moves(pool, pt, np.full((B,), POS, np.int32))
    assert all(mv.dst.device.type == "meta" and mv.src.device.type == "meta"
               for mv in moves)
    names = [k for k, m in po.meta["blocks"][0].items() if m.kind == "seq"]
    assert sorted(names) == ["k", "k_scale", "pos", "v", "v_scale"]
    assert [mv.dst for mv in moves] == [logical["blocks"][0][k] for k in names]
    plan = dict(zip(names, tkv.move_plan(moves)))
    n, Hkv, Sp = 24, 32, 512
    # the whole logical tree is written, the 5 valid pages of 8 read
    assert sum(p.bytes_written for p in plan.values()) == 428_212_224
    assert sum(p.bytes_read for p in plan.values()) == 267_632_640
    for name in ("k", "v"):
        lay = plan[name].layout
        assert (lay.run, lay.runs, lay.pieces, lay.lanes_vec, lay.aligned) == (
            4096, Hkv, 1, 5, True)
        assert plan[name].runs == n * B * (Sp // PAGE) * Hkv == 49152
        assert plan[name].bytes_written == n * B * Hkv * Sp * 64
    for name in ("k_scale", "v_scale"):
        lay = plan[name].layout
        assert (lay.run, lay.runs, lay.lanes_vec) == (256, Hkv, 4)
        assert plan[name].runs == 49152
        assert plan[name].bytes_written == n * B * Hkv * Sp * 4
    assert (plan["pos"].layout.run, plan["pos"].runs) == (256, n * B * 8)
    assert plan["pos"].bytes_written == n * B * MAX_LEN * 4
    for p in plan.values():
        assert (p.listed, p.moved) == (B * 8, B * 5)
        assert p.bytes_read * 8 == p.bytes_written * 5


def test_writeback_plan_from_shapes_at_full_width(d1_ops):
    po, pool, pt = d1_ops
    logical, _ = po.gather_moves(pool, pt, np.full((B,), POS, np.int32))
    moves = po.writeback_moves(pool, logical, pt, np.full((B, 1), POS, np.int32))
    plan = tkv.move_plan(moves)
    assert sum(p.bytes_written for p in plan) == sum(p.bytes_read for p in plan) \
        == 53_526_528
    assert all((p.listed, p.moved) == (B, B) for p in plan)
    runs = {k: p.runs for (k, m), p in zip(
        [(k, m) for k, m in po.meta["blocks"][0].items() if m.kind == "seq"], plan)}
    assert runs == {"pos": 24 * B, "k": 24 * B * 32, "v": 24 * B * 32,
                    "k_scale": 24 * B * 32, "v_scale": 24 * B * 32}


def test_slot_row_and_flat_leaves_layout():
    """A slot row is one run of the whole row, cut into 4 KiB pieces; the
    4-byte ``len`` rows take the byte path."""
    k = torch.empty((24, 8, 32, 512, 64), dtype=torch.int8, device="meta")
    lay = tkv.leaf_layout(k, k, None, None, 1)
    assert (lay.row_bytes, lay.run, lay.runs, lay.pieces, lay.lanes_vec) == (
        2 ** 20, 2 ** 20, 1, 256, 5)
    ln = torch.empty((24, 8), dtype=torch.int32, device="meta")
    lay = tkv.leaf_layout(ln, ln, None, None, 1)
    assert (lay.row_bytes, lay.run, lay.aligned, lay.lanes_byte) == (4, 4, False, 2)
    with pytest.raises(ValueError, match="page rows"):
        tkv.leaf_layout(k, ln, None, None, 1)


# ---------------------------------------------------------------------------
# the multi-leaf plain version against the per-leaf reference
# ---------------------------------------------------------------------------

def _small(int8_kv, max_len=96, page=16, batch=3):
    cfg = t_reduced("stablelm-1.6b")
    if int8_kv:
        cfg = dataclasses.replace(cfg, quant_kv="dynamic")
    bundle = t_build(cfg, "cpu")
    return bundle, bundle.paged_cache(batch, max_len, page)


def _per_leaf(moves):
    """The per-leaf composition: each dst cloned, the init broadcast where
    the leaf has a fill, then ``ref.cache_scatter_pages_ref``."""
    out = []
    for mv in moves:
        d = mv.dst.clone()
        if mv.fill is not None:
            d.copy_(mv.fill.expand(d.shape))
        m = mv.map if mv.map is not None else torch.as_tensor(mv.host_map)
        src = d if mv.src is mv.dst else mv.src
        out.append(tref.cache_scatter_pages_ref(d, src, m, mv.seq_axis, mv.page,
                                                mv.batch_axis))
    return out


def _movement(kind, bundle, po, gen):
    """(moves, op) of one movement over random trees."""
    N, Bt = 9, 3
    pool = _rand_tree(gen, po.init(N))
    n_pp = po.n_pp
    pt = np.full((Bt, n_pp), -1, np.int32)
    pt[0, :3], pt[2, :2] = [4, 2, 7], [1, 8]
    lengths = np.array([2 * po.page + 5, 9, po.page + 1], np.int32)
    if kind == "gather":
        return po.gather_moves(pool, pt, lengths)[1], "cache_scatter_pages"
    logical = _rand_tree(gen, po.gather(pool, pt, lengths))
    if kind == "write-back":
        return (po.writeback_moves(pool, logical, pt, lengths[:, None]),
                "cache_scatter_pages")
    meta = po.meta
    if kind == "land":
        sub = _rand_tree(gen, bundle.init_caches(Bt, n_pp * po.page))
        rows, js = np.full((N,), -1, np.int32), np.zeros((N,), np.int32)
        rows[[3, 5, 6]], js[[3, 5, 6]] = [0, 0, 2], [0, 1, 0]
        slots = np.array([-1, 0, 2], np.int32)
        moves = []
        for k, m in meta["blocks"][0].items():
            d, s = pool["blocks"][0][k], sub["blocks"][0][k]
            if m.kind == "seq":
                nl = m.n_leaf
                moves.append(tkv.Move(d, s, None, m.seq_axis, po.page, 1, host_map=np.where(
                    rows >= 0, rows * nl + js, -1).astype(np.int32)))
            else:
                moves.append(tkv.Move(d, s, batch_axis=1, host_map=slots))
        return moves, "cache_scatter_pages"
    if kind == "copy":
        cmap = np.full((N,), -1, np.int32)
        cmap[[6, 8]] = [2, 4]
        return [tkv.Move(pool["blocks"][0][k], pool["blocks"][0][k], batch_axis=1,
                         host_map=cmap)
                for k, m in meta["blocks"][0].items() if m.kind == "seq"], \
            "cache_scatter_pages"
    if kind == "restore":
        rec = _rand_tree(gen, po.capture(pool, 0, [4, 2, 7]))
        pmap = np.full((N,), -1, np.int32)
        pmap[[1, 5, 3]] = [0, 1, 2]
        smap = np.array([-1, 0, -1], np.int32)
        return [tkv.Move(pool["blocks"][0][k], rec["blocks"][0][k], batch_axis=1,
                         host_map=pmap if m.kind == "seq" else smap)
                for k, m in meta["blocks"][0].items()], "cache_scatter_pages"
    # the slot-row landing: every leaf of a slot-row pool, one map
    caches = _rand_tree(gen, bundle.init_caches(Bt, 64))
    sub = _rand_tree(gen, bundle.init_caches(Bt, 64))
    smap = np.array([2, -1, 0], np.int32)
    return [tkv.Move(caches["blocks"][0][k], sub["blocks"][0][k], batch_axis=1,
                     host_map=smap) for k in caches["blocks"][0]], "cache_scatter"


@pytest.mark.parametrize("int8_kv", [False, True])
@pytest.mark.parametrize("kind", ["gather", "write-back", "land", "copy", "restore",
                                  "slot-row landing"])
def test_multi_leaf_plain_equals_per_leaf_ref(int8_kv, kind):
    bundle, po = _small(int8_kv)
    gen = torch.Generator().manual_seed(5)
    moves, op = _movement(kind, bundle, po, gen)
    leaves = po.meta["blocks"][0].values()
    assert len(moves) == sum(1 for m in leaves if kind in ("land", "restore",
                                                          "slot-row landing")
                             or m.kind == "seq")
    want = _per_leaf(moves)
    tops.reset_counts()
    tops.cache_move(moves, op)
    for mv, w in zip(moves, want):
        assert _same(mv.dst, w), (kind, tuple(mv.dst.shape))
    c = tops.counts()
    assert c[op] == {"entries": 1, "launches": 0}
    other = "cache_scatter" if op == "cache_scatter_pages" else "cache_scatter_pages"
    assert c[other]["entries"] == 0


def test_device_moves_send_each_map_once_with_its_targets():
    bundle, po = _small(True)
    gen = torch.Generator().manual_seed(6)
    moves, _ = _movement("land", bundle, po, gen)
    dev = tops.device_moves(moves)
    base = dev[0].map.untyped_storage().data_ptr()
    assert all(mv.map.untyped_storage().data_ptr() == base for mv in dev)
    for mv, d in zip(moves, dev):
        assert np.array_equal(d.map.numpy(), mv.host_map)
        assert np.array_equal(d.rows.numpy(), np.flatnonzero(mv.host_map >= 0))
    gmoves, _ = _movement("gather", bundle, po, gen)
    assert all(d.rows is None for d in tops.device_moves(gmoves))


# ---------------------------------------------------------------------------
# the gather writes every byte of its scratch, as JAX's gather does
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("int8_kv,max_len", [(False, 64), (False, 96), (True, 64),
                                             (True, 96)])
def test_gather_writes_every_byte_and_matches_jax(int8_kv, max_len):
    Bt, page, N = 3, 16, 9
    n_pp = max_len // page
    jcfg = j_reduced("stablelm-1.6b")
    if int8_kv:
        jcfg = dataclasses.replace(jcfg, quant_kv="dynamic")
    jpo = j_build(jcfg).paged_cache(Bt, max_len, 0, page)
    _, tpo = _small(int8_kv, max_len, page, Bt)
    rng = np.random.default_rng(8)

    def rand(a):
        if np.issubdtype(a.dtype, np.integer):
            return rng.integers(-100, 100, a.shape).astype(a.dtype)
        return rng.standard_normal(a.shape).astype(a.dtype)

    pool = jax.tree.map(rand, jpo.init(N))
    tpool = {sec: tuple({k: _t(v) for k, v in d.items()} for d in pool[sec])
             for sec in ("head", "tail", "blocks")}
    pt = np.full((Bt, n_pp), -1, np.int32)
    pt[0, :3], pt[2, :2] = [4, 2, 7], [1, 8]
    lengths = np.array([2 * page + 5, 9, page + 1], np.int32)
    jl = jpo.gather(pool, jnp.asarray(pt), jnp.asarray(lengths))

    gen = torch.Generator().manual_seed(9)
    trees = []
    for pre in ("random", "init"):
        logical, moves = tpo.gather_moves(tpool, pt, lengths)
        for mv in moves:
            if pre == "random":
                mv.dst.view(torch.uint8).copy_(torch.randint(
                    0, 256, mv.dst.view(torch.uint8).shape, generator=gen,
                    dtype=torch.uint8))
            else:
                mv.dst.copy_(mv.fill.expand(mv.dst.shape))
        tops.cache_move(moves)
        trees.append(logical)
    trees.append(tpo.gather(tpool, pt, lengths))
    for k, jv in jl["blocks"][0].items():
        for tree in trees:
            assert _same(tree["blocks"][0][k], jv), k


def test_fills_are_the_init_elements():
    for int8_kv, dtype in ((True, "float32"), (False, "bfloat16")):
        cfg = t_reduced("stablelm-1.6b", dtype=dtype)
        if int8_kv:
            cfg = dataclasses.replace(cfg, quant_kv="dynamic")
        meta = t_build(cfg, "cpu").paged_cache(2, 256, 16).meta["blocks"][0]
        fills = {k: m.fill for k, m in meta.items() if m.kind == "seq"}
        assert fills["pos"].item() == -1 and fills["pos"].dtype == torch.int32
        assert "len" not in fills and meta["len"].fill is None
        if int8_kv:
            assert fills["k"].item() == 0 and fills["k"].dtype == torch.int8
            assert fills["k_scale"].item() == 1.0
            assert fills["k_scale"].dtype == torch.float32
        else:
            assert fills["k"].item() == 0 and fills["k"].dtype == torch.bfloat16
        assert tkv.fill_word(fills["pos"], torch.int32) == 0xFFFFFFFF


def test_non_constant_init_on_a_paged_leaf_raises(monkeypatch):
    original = tapi.lm_init_caches

    def uneven(cfg, batch, max_len, device, mem_len=0):
        tree = original(cfg, batch, max_len, device, mem_len)
        if str(device) != "meta":
            tree["blocks"][0]["pos"][..., 0] = 7
        return tree

    monkeypatch.setattr(tapi, "lm_init_caches", uneven)
    with pytest.raises(ValueError, match="repeat one element"):
        t_build(t_reduced("stablelm-1.6b"), "cpu").paged_cache(2, 64, 16)


# ---------------------------------------------------------------------------
# one launch a movement, end to end
# ---------------------------------------------------------------------------

def test_paged_engine_census_is_one_launch_a_movement():
    """A paged run enters K7 once per round, twice per decode step (gather
    and write-back) and once per restore, and K6 never; a slot-row run
    enters K6 once per round."""
    cfg = t_reduced("stablelm-1.6b")
    params = t_build(cfg, "cpu").init(0)
    rng = np.random.default_rng(7)
    prompts = [rng.integers(1, 200, size=17).astype(np.int32) for _ in range(4)]
    for paged in (dict(paged=True, page_size=16, pool_pages=7, spill=True), {}):
        eng = build_engine(ServeConfig(slots=4, max_len=64, buckets=(8, 16, 32),
                                       device="cpu", int8_kv=True, **paged),
                           cfg=cfg, params=params)
        tops.reset_counts()
        eng.run([Request(uid=i, prompt=p, max_new=30) for i, p in enumerate(prompts)])
        st, c = eng.stats, tops.counts()
        if paged:
            assert st["spill_restores"] >= 1
            assert c["cache_scatter_pages"]["entries"] == (
                st["prefill_batches"] + 2 * st["decode_steps"] + st["spill_restores"])
            assert c["cache_scatter"]["entries"] == 0
        else:
            assert c["cache_scatter"]["entries"] == st["prefill_batches"]
            assert c["cache_scatter_pages"]["entries"] == 0
