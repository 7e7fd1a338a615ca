"""The port's paged KV pool against the JAX package's, on the same numpy
inputs and weights (everything on the CPU: the JAX side takes its jnp
oracles there, the port the plain version of the page scatter).

- Page-row ops: ``to_page_rows`` / ``from_page_rows`` and
  ``cache_scatter_pages`` (both sides page rows, as the reference calls
  it, and one side a logical leaf, as the port calls it) are bit-equal to
  ``repro.kernels.ops``: int8 kernel-layout K/V, f32 scales, int32 ``pos``,
  bf16 and f32 fp-layout K, batch axis 0 and 1, -1 entries, pages 16 and
  64.  ``kernels.kv_cache.page_side``, the strides the CUDA kernel reads,
  is held against ``to_page_rows`` by emulating the kernel's addressing.
- ``paged_cache(...).meta`` equals JAX's leaf for leaf (int8 leaves stay
  flat at max_len 64, page at 96 and 128), and each of the seven pool ops
  is bit-equal to JAX's on the same pool and maps; the COW copy runs with
  ``src is dst``, and a map whose page is both a target and a source
  raises.
- The paged engine against the JAX paged engine (fp and PDQ weights, fp
  and int8 KV, max_len 64 and 128, page 16; a shared prompt prefix, and a
  small pool with host spill): greedy streams as in
  tests/test_torch_engine.py (equal, or JAX's top-2 margin below the
  logits tolerance), scheduler stats equal, and every prefill land map and
  decode page table equal.
- Within the port, paged serving equals slot-row serving exactly, greedy
  and at temperature 0.9, and the reference's prefix-share, preempt and
  spill scenarios (tests/test_serve_paged.py) are token-exact.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as j_reduced
from repro.kernels import ops as jops
from repro.models import build_model as j_build
from repro.models.linops import quantize_param_tree as j_quantize
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JServeEngine
from repro_torch.bridge import _tensor, params_from_numpy
from repro_torch.configs import reduced_config as t_reduced
from repro_torch.kernels import kv_cache as tkv
from repro_torch.kernels import ops as tops
from repro_torch.models import build_model as t_build
from repro_torch.serve import Request, ServeConfig, build_engine

torch.set_num_threads(1)

TOL = {"fp": 1e-5, "pdq": 1e-3}          # tests/test_torch_model.py
SKIP_STATS = {"prefill_compiles", "chunk_compiles", "decode_compiles",
              "straggler_flags", "prefill_straggler_flags"}


def _t(a):
    return _tensor(np.asarray(a), "cpu")


def _bits(x):
    """Bit pattern of a torch tensor or JAX/numpy array, as numpy."""
    if torch.is_tensor(x):
        return (x.view(torch.int16) if x.dtype == torch.bfloat16 else x).numpy()
    a = np.asarray(x)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def _same(a, b):
    ba, bb = _bits(a), _bits(b)
    return ba.shape == bb.shape and ba.dtype == bb.dtype and np.array_equal(ba, bb)


def _rand(rng, shape, dtype):
    dtype = np.dtype(dtype)
    if dtype.kind in "iu":
        return rng.integers(-100, 100, shape).astype(dtype)
    return rng.standard_normal(shape).astype(dtype)


# ---------------------------------------------------------------------------
# page-row ops
# ---------------------------------------------------------------------------

# (logical leaf shape, dtype, seq_axis, batch_axis, page)
LEAVES = [
    ((2, 3, 2, 128, 16), np.int8, 3, 1, 16),             # int8 K, kernel layout
    ((2, 3, 2, 128), np.float32, 3, 1, 16),              # its f32 scales
    ((2, 3, 64), np.int32, 2, 1, 16),                    # pos
    ((2, 3, 64, 2, 16), jnp.bfloat16, 2, 1, 16),         # fp-layout K, bf16
    ((3, 64, 2, 16), np.float32, 1, 0, 16),              # fp K, batch axis 0
    ((2, 2, 4, 256, 64), np.int8, 3, 1, 64),             # page 64
]


def _maps(rng, B, n_leaf, N):
    """A gather map (logical page rows <- pool pages) with -1 entries and a
    write-back map (pool pages <- logical page rows, page 0 repeated)."""
    g = rng.integers(0, N, B * n_leaf).astype(np.int32)
    g[rng.random(B * n_leaf) < 0.4] = -1
    w = np.full((N,), -1, np.int32)
    tgt = rng.permutation(np.arange(1, N))[:B]
    w[tgt] = rng.integers(0, B * n_leaf, B)
    return g, w


@pytest.mark.parametrize("shape,dtype,seq_axis,ba,page", LEAVES)
def test_page_rows_and_scatter_match_jax(shape, dtype, seq_axis, ba, page):
    rng = np.random.default_rng(0)
    x = _rand(rng, shape, dtype)
    jr = jops.to_page_rows(jnp.asarray(x), seq_axis, page, batch_axis=ba)
    tr = tops.to_page_rows(_t(x), seq_axis, page, batch_axis=ba)
    assert _same(tr, jr)
    assert _same(tops.from_page_rows(tr, shape, seq_axis, page, batch_axis=ba), x)

    B, n_leaf, N = shape[ba], shape[seq_axis] // page, 7
    pshape = list(shape)
    pshape[ba], pshape[seq_axis] = N, page
    pool = _rand(rng, tuple(pshape), dtype)
    gmap, wmap = _maps(rng, B, n_leaf, N)

    # gather: a logical leaf takes pool pages
    jg = jops.from_page_rows(
        jops.cache_scatter_pages(jr, jnp.asarray(pool), jnp.asarray(gmap), batch_axis=ba),
        shape, seq_axis, page, batch_axis=ba)
    tg = tops.cache_scatter_pages(_t(x), _t(pool), gmap, batch_axis=ba,
                                  seq_axis=seq_axis, page=page)
    assert _same(tg, jg)
    # write-back: pool pages take logical page rows
    jw = jops.cache_scatter_pages(jnp.asarray(pool), jr, jnp.asarray(wmap), batch_axis=ba)
    tw = tops.cache_scatter_pages(_t(pool), _t(x), wmap, batch_axis=ba,
                                  seq_axis=seq_axis, page=page)
    assert _same(tw, jw)
    # the reference's own call: both sides page rows already
    tw2 = tops.cache_scatter_pages(_t(pool), tr, wmap, batch_axis=ba)
    assert _same(tw2, jw)


def _emulate(dst, src, page_map, seq_axis, page, ba):
    """The CUDA kernel's addressing, byte by byte, from ``page_side``."""
    n, rows, row_bytes, ds = tkv.page_side(dst, seq_axis, page, ba)
    _, rows_s, row_bytes_s, ss = tkv.page_side(src, seq_axis, page, ba)
    assert row_bytes == row_bytes_s
    out = dst.contiguous().view(torch.uint8).reshape(-1).clone()
    sb = src.contiguous().view(torch.uint8).reshape(-1)
    o = torch.arange(row_bytes)

    def addr(side, r):
        outer, pstride, cstride, rpo, cb = side
        return (r // rpo) * outer + (r % rpo) * pstride + (o // cb) * cstride + o % cb

    for z in range(n):
        for p in range(rows):
            if page_map[p] >= 0:
                out[addr(ds, z * rows + p)] = sb[addr(ss, z * rows_s + int(page_map[p]))]
    return out.view(dst.dtype).reshape(dst.shape)


@pytest.mark.parametrize("shape,dtype,seq_axis,ba,page", LEAVES)
def test_page_side_addresses_the_page_rows(shape, dtype, seq_axis, ba, page):
    """The strides K7 reads place every page row where ``to_page_rows``
    puts it, on both sides of a gather and a write-back."""
    rng = np.random.default_rng(1)
    x = _t(_rand(rng, shape, dtype))
    B, n_leaf, N = shape[ba], shape[seq_axis] // page, 5
    pshape = list(shape)
    pshape[ba], pshape[seq_axis] = N, page
    pool = _t(_rand(rng, tuple(pshape), dtype))
    gmap, wmap = _maps(rng, B, n_leaf, N)
    for dst, src, m in ((x, pool, gmap), (pool, x, wmap)):
        want = tkv.cache_scatter_pages_plain(dst.clone(), src, torch.as_tensor(m),
                                             seq_axis, page, ba)
        assert _same(_emulate(dst, src, m, seq_axis, page, ba), want)


def test_in_place_copy_needs_disjoint_targets_and_sources():
    pool = _t(_rand(np.random.default_rng(2), (2, 6, 2, 16, 8), np.int8))
    again = pool.clone()
    want = pool.clone()
    want[:, 4], want[:, 5] = pool[:, 1], pool[:, 2]
    cmap = np.array([-1, -1, -1, -1, 1, 2], np.int32)
    got = tops.cache_scatter_pages(pool, pool, cmap, batch_axis=1)
    assert got is pool and _same(got, want)
    tops.cache_scatter_pages(again, again, torch.as_tensor(cmap), batch_axis=1,
                             host_map=cmap)          # a device map and its host copy
    assert _same(again, want)
    for bad in ([-1, -1, 1, -1, 2, -1],       # page 2 is written and read
                [-1, 3, -1, 1, -1, -1]):      # pages 1 and 3 swap
        with pytest.raises(ValueError, match="both a target and a source"):
            tops.cache_scatter_pages(pool, pool, np.array(bad, np.int32), batch_axis=1)
    with pytest.raises(ValueError, match="overlap"):          # no host map
        tops.cache_scatter_pages(pool, pool, torch.as_tensor(cmap), batch_axis=1)
    with pytest.raises(ValueError, match="overlap"):          # a view, not src is dst
        tops.cache_scatter_pages(pool, pool.view(pool.shape), cmap, batch_axis=1)
    with pytest.raises(ValueError, match="must lie in"):
        tops.cache_scatter_pages(pool, pool.clone(), np.full((6,), 6, np.int32),
                                 batch_axis=1)


# ---------------------------------------------------------------------------
# paged_cache: classification and the seven pool ops
# ---------------------------------------------------------------------------

def _cfgs(int8_kv, dtype="float32"):
    jcfg, tcfg = j_reduced("stablelm-1.6b", dtype=dtype), t_reduced("stablelm-1.6b",
                                                                    dtype=dtype)
    if int8_kv:
        jcfg = dataclasses.replace(jcfg, quant_kv="dynamic")
        tcfg = dataclasses.replace(tcfg, quant_kv="dynamic")
    return jcfg, tcfg


def _pairs(jtree, ttree):
    """(name, JAX leaf, port leaf) over the single-kind cache tree."""
    assert jtree["head"] == () and jtree["tail"] == () and ttree["head"] == ()
    (jb,), (tb,) = jtree["blocks"], ttree["blocks"]
    assert sorted(jb) == sorted(tb)
    return [(k, jb[k], tb[k]) for k in sorted(jb)]


def _assert_tree_same(jtree, ttree):
    for name, j, t in _pairs(jtree, ttree):
        assert _same(t, j), name


@pytest.mark.parametrize("int8_kv", [False, True])
@pytest.mark.parametrize("max_len", [64, 96, 128])
def test_meta_matches_jax(int8_kv, max_len):
    jcfg, tcfg = _cfgs(int8_kv)
    jm = j_build(jcfg).paged_cache(3, max_len, 0, 16).meta
    tm = t_build(tcfg, "cpu").paged_cache(3, max_len, 16).meta
    for name, j, t in _pairs(jm, tm):
        assert (t.kind, t.seq_axis, t.n_leaf, t.shape) == (
            j.kind, j.seq_axis, j.n_leaf, tuple(j.shape)), name
    kinds = {name: t.kind for name, _, t in _pairs(jm, tm)}
    assert kinds["pos"] == "seq" and kinds["len"] == "flat"
    if int8_kv:   # Sp = S rounded up to 128 grows with max_len only past 128
        assert kinds["k"] == ("flat" if max_len == 64 else "seq")
        assert tm["blocks"][0]["k_scale"].n_leaf == (0 if max_len == 64 else 8)


def _random_pool(rng, jpo, n_pages):
    return jax.tree.map(lambda a: _rand(rng, a.shape, a.dtype), jpo.init(n_pages))


def _to_port(tree):
    return {sec: tuple({k: _t(v) for k, v in d.items()} for d in tree[sec])
            for sec in ("head", "tail", "blocks")}


def _clone(tree):
    return {sec: tuple({k: v.clone() for k, v in d.items()} for d in tree[sec])
            for sec in ("head", "tail", "blocks")}


@pytest.mark.parametrize("int8_kv,max_len", [(False, 64), (True, 64), (True, 96),
                                             (True, 128)])
def test_pool_ops_match_jax(int8_kv, max_len):
    B, page, N = 3, 16, 9
    n_pp = max_len // page
    jcfg, tcfg = _cfgs(int8_kv)
    jpo = j_build(jcfg).paged_cache(B, max_len, 0, page)
    tpo = t_build(tcfg, "cpu").paged_cache(B, max_len, page)
    rng = np.random.default_rng(3)

    _assert_tree_same(jpo.init(N), tpo.init(N))

    pool = _random_pool(rng, jpo, N)
    pt = np.full((B, n_pp), -1, np.int32)
    pt[0, :3] = [4, 2, 7]
    pt[2, :2] = [1, 8]                     # row 1 is a free slot
    lengths = np.array([2 * page + 5, 9, page + 1], np.int32)

    # gather
    jl = jpo.gather(pool, jnp.asarray(pt), jnp.asarray(lengths))
    tl = tpo.gather(_to_port(pool), pt, lengths)
    _assert_tree_same(jl, tl)

    # write-back of a changed logical tree (the free slot goes to page 0)
    logical = jax.tree.map(lambda a: _rand(rng, a.shape, a.dtype), jl)
    positions = lengths[:, None]
    tpool = _to_port(pool)
    tpo.writeback(tpool, _to_port(logical), pt, positions)
    _assert_tree_same(jpo.writeback(pool, logical, jnp.asarray(pt),
                                    jnp.asarray(positions)), tpool)

    # land a prefill batch: rows 0 and 2 of the scratch into fresh pages
    sub = jax.tree.map(lambda a: _rand(rng, a.shape, a.dtype),
                       j_build(jcfg).init_caches(B, max_len))
    src_map = np.array([-1, 0, 2], np.int32)
    land_rows = np.full((N,), -1, np.int32)
    land_js = np.zeros((N,), np.int32)
    land_rows[[3, 5, 6]], land_js[[3, 5, 6]] = [0, 0, 2], [0, 1, 0]
    tpool = _to_port(pool)
    tpo.land(tpool, _to_port(sub), src_map, land_rows, land_js)
    _assert_tree_same(jpo.land(pool, sub, jnp.asarray(src_map),
                               jnp.asarray(land_rows), jnp.asarray(land_js)), tpool)

    # COW copy, pool onto itself
    cmap = np.full((N,), -1, np.int32)
    cmap[[6, 8]] = [2, 4]
    tpool = _to_port(pool)
    tpo.copy(tpool, cmap)
    _assert_tree_same(jpo.copy(pool, jnp.asarray(cmap)), tpool)
    cmap[4] = 6
    with pytest.raises(ValueError, match="both a target and a source"):
        tpo.copy(tpool, cmap)

    # capture one slot's pages, restore them into other pages of a pool
    ids = [4, 2, 7]
    jrec = jpo.capture(pool, 0, ids)
    trec = tpo.capture(_to_port(pool), 0, ids)
    _assert_tree_same(jrec, trec)
    pmap = np.full((N,), -1, np.int32)
    pmap[[1, 5, 3]] = [0, 1, 2]
    smap = np.array([-1, 0, -1], np.int32)
    other = _random_pool(rng, jpo, N)
    tpool = _to_port(other)
    tpo.restore(tpool, trec, pmap, smap)
    _assert_tree_same(jpo.restore(other, jrec, jnp.asarray(pmap), jnp.asarray(smap)),
                      tpool)


def test_bf16_pool_survives_capture_and_restore():
    """A bf16 pool's pages and flat rows go to host memory and back bit for
    bit (the spill record is CPU tensors, never numpy of a bf16 leaf)."""
    tcfg = t_reduced("stablelm-1.6b", dtype="bfloat16")
    po = t_build(tcfg, "cpu").paged_cache(2, 64, 16)
    rng = np.random.default_rng(4)
    pool = po.init(7)
    for d in pool["blocks"]:
        for k, v in d.items():
            v.copy_(_t(_rand(rng, tuple(v.shape), np.float32)).to(v.dtype))
    assert pool["blocks"][0]["k"].dtype == torch.bfloat16
    rec = po.capture(pool, 1, [3, 5])
    assert all(v.device.type == "cpu" for v in rec["blocks"][0].values())
    back = _clone(pool)
    for v in back["blocks"][0].values():
        v.zero_()
    pmap = np.array([-1, 0, -1, -1, 1, -1, -1], np.int32)     # pages 3, 5 -> 1, 4
    po.restore(back, rec, pmap, np.array([-1, 0], np.int32))
    for k, v in pool["blocks"][0].items():
        m = po.meta["blocks"][0][k]
        if m.kind == "seq":
            assert _same(back["blocks"][0][k][:, [1, 4]], v[:, [3, 5]]), k
        else:
            assert _same(back["blocks"][0][k][:, 1], v[:, 1]), k


# ---------------------------------------------------------------------------
# the paged engine against the JAX paged engine
# ---------------------------------------------------------------------------

LENS = (3, 40, 17, 9, 33, 25)             # tests/test_torch_engine.py


@pytest.fixture(scope="module")
def weights():
    jcfg = j_reduced("stablelm-1.6b")
    jp = j_build(jcfg).init(jax.random.PRNGKey(0))
    return jcfg, jp, params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")


def _prompts():
    """The engine test's prompts, requests 0 and 1 behind one shared
    33-token prefix (two full pages of 16)."""
    rng = np.random.default_rng(0)
    ps = [rng.integers(0, 512, size=n).astype(np.int32) for n in LENS]
    prefix = rng.integers(0, 512, size=33).astype(np.int32)
    ps[0] = np.concatenate([prefix, ps[0]])
    ps[1] = np.concatenate([prefix, ps[1][:20]])
    return ps


def _margin_ok(jcfg, jparams, prompt, generated, i, tol):
    """JAX's top-2 logit margin for token i of a stream is below tol."""
    seq = np.concatenate([prompt, np.asarray(generated[:i], np.int32)])[None]
    b = j_build(jcfg)
    logits, _ = b.prefill(jparams, {"tokens": jnp.asarray(seq)},
                          b.init_caches(1, seq.shape[1] + 1))
    top2 = np.sort(np.asarray(logits[0]))[-2:]
    return top2[1] - top2[0] < tol


def _record_plans(eng):
    """Keep every prefill plan's land map and decode plan's page tables."""
    seen = []
    pre, dec = eng._exec_prefill, eng._exec_decode

    def exec_prefill(plan, extras):
        seen.append(("land", plan.land_rows.copy(), plan.land_js.copy()))
        return pre(plan, extras)

    def exec_decode(plan):
        seen.append(("decode", plan.page_tables.copy()))
        return dec(plan)

    eng._exec_prefill, eng._exec_decode = exec_prefill, exec_decode
    return seen


# the last two: a pool small enough that decode growth preempts, with spill
@pytest.mark.parametrize("kind,int8_kv,max_len,pool_pages,max_new", [
    ("fp", False, 64, None, 8), ("fp", True, 64, None, 8), ("fp", False, 128, None, 8),
    ("fp", True, 128, None, 8), ("pdq", False, 64, None, 8), ("pdq", True, 128, None, 8),
    ("fp", True, 128, 9, 40), ("pdq", False, 64, 6, 16)])
def test_paged_engine_matches_jax_paged_engine(weights, kind, int8_kv, max_len,
                                               pool_pages, max_new):
    jcfg, jp, tp = weights
    if int8_kv:
        jcfg = dataclasses.replace(jcfg, quant_kv="dynamic")
    jparams = jp if kind == "fp" else dict(jp, blocks=jax.vmap(j_quantize)(jp["blocks"]))
    paged = dict(paged=True, page_size=16, pool_pages=pool_pages,
                 spill=pool_pages is not None)
    jeng = JServeEngine(jcfg, jparams, slots=2, max_len=max_len, telemetry=False, **paged)
    jseen = _record_plans(jeng)
    jreqs = [JRequest(uid=i, prompt=p, max_new=max_new) for i, p in enumerate(_prompts())]
    jeng.run(jreqs)

    teng = build_engine(ServeConfig(slots=2, max_len=max_len, device="cpu",
                                    quantize_weights=kind == "pdq", int8_kv=int8_kv,
                                    **paged),
                        cfg=t_reduced("stablelm-1.6b"), params=tp)
    tseen = _record_plans(teng)
    treqs = [Request(uid=i, prompt=p, max_new=max_new) for i, p in enumerate(_prompts())]
    teng.run(treqs)

    for jr, tr in zip(jreqs, treqs):
        assert tr.done and tr.error is None and tr.finish_reason == "complete"
        if tr.generated != jr.generated:
            i = next(k for k, (a, b) in enumerate(zip(tr.generated, jr.generated))
                     if a != b)
            assert _margin_ok(jcfg, jparams, jr.prompt, jr.generated, i, TOL[kind]), (
                tr.uid, i, tr.generated, jr.generated)
    tstats = {k: v for k, v in teng.stats.items() if k not in SKIP_STATS}
    jstats = {k: v for k, v in jeng.stats.items() if k not in SKIP_STATS}
    assert tstats == jstats
    assert len(tseen) == len(jseen)
    for t, j in zip(tseen, jseen):
        assert t[0] == j[0] and all(np.array_equal(a, b) for a, b in zip(t[1:], j[1:]))
    assert teng.stats["prefix_hits"] >= 1 and teng.stats["prefix_shared_pages"] >= 2
    if pool_pages is not None:
        assert teng.stats["preemptions"] >= 1
        assert teng.stats["spills"] == teng.stats["preemptions"]
        assert teng.stats["spill_restores"] >= 1
        assert not [e for e in teng.failures.events if e["kind"] == "spill"]


# ---------------------------------------------------------------------------
# within the port: paged == slot-row, and the reference's scenarios
# ---------------------------------------------------------------------------

MIXED_LENS = [3, 5, 8, 9, 12, 16, 17, 23, 30, 4, 11, 27]   # test_serve_paged.py


@pytest.fixture(scope="module")
def model():
    tcfg = t_reduced("stablelm-1.6b")
    return tcfg, t_build(tcfg, "cpu").init(0)


def _outputs(reqs):
    return {r.uid: (tuple(r.generated), r.finish_reason, r.error) for r in reqs}


def _serve(model, reqs, **kw):
    cfg, params = model
    kw = dict(dict(slots=4, max_len=64, buckets=(8, 16, 32), device="cpu"), **kw)
    eng = build_engine(ServeConfig(**kw), cfg=cfg, params=params)
    eng.run(reqs)
    assert all(r.done for r in reqs)
    return eng, _outputs(reqs)


def _mixed(cfg, max_new=4):
    rng = np.random.default_rng(0)
    return [Request(uid=i, prompt=rng.integers(0, cfg.vocab, L).astype(np.int32),
                    max_new=max_new) for i, L in enumerate(MIXED_LENS)]


@pytest.mark.parametrize("int8_kv,max_len", [(False, 64), (True, 128)])
@pytest.mark.parametrize("temperature", [0.0, 0.9])
def test_paged_equals_slot_row(model, temperature, int8_kv, max_len):
    kw = dict(temperature=temperature, int8_kv=int8_kv, max_len=max_len,
              quantize_weights=True)
    _, want = _serve(model, _mixed(model[0]), **kw)
    eng, got = _serve(model, _mixed(model[0]), paged=True, page_size=16, **kw)
    assert got == want
    assert eng.stats["pages_total"] == 4 * (max_len // 16)


def test_prefix_share_hit_is_bit_exact(model):
    """tests/test_serve_paged.py: a request arriving while an earlier one
    with the same prompt holds its pages shares the full prompt pages and
    still produces the unshared stream."""
    rng = np.random.default_rng(3)
    prompt = rng.integers(1, 200, size=20).astype(np.int32)

    def mk():
        reqs = [Request(uid=100, prompt=prompt.copy(), max_new=16)]
        r2 = np.random.default_rng(5)
        for i in range(3):
            reqs.append(Request(uid=101 + i,
                                prompt=r2.integers(1, 200, size=5).astype(np.int32),
                                max_new=2))
        reqs.append(Request(uid=104, prompt=prompt.copy(), max_new=8))
        return reqs

    _, want = _serve(model, mk())
    eng, got = _serve(model, mk(), paged=True, page_size=16)
    assert got == want
    assert eng.stats["prefix_hits"] > 0 and eng.stats["prefix_shared_pages"] > 0
    assert eng.stats["cow_copies"] == 0


def test_engine_page_copy_hook_copies_every_paged_leaf(model):
    """The scheduler's COW arm (``_exec_page_copy``), which no stream here
    trips (only full prompt pages are shared): page dst takes page src in
    every paged leaf, and nothing else moves."""
    eng, _ = _serve(model, _mixed(model[0])[:3], paged=True, page_size=16,
                    int8_kv=True, max_len=128)
    blocks = eng.caches["blocks"][0]
    for v in blocks.values():
        v.copy_(torch.randint(-100, 100, v.shape).to(v.dtype))
    before = {k: v.clone() for k, v in blocks.items()}
    eng._exec_page_copy(0, [(3, 7), (4, 9)])
    for k, v in blocks.items():
        want = before[k].clone()
        if eng._paged_ops.meta["blocks"][0][k].kind == "seq":
            want[:, [7, 9]] = before[k][:, [3, 4]]
        assert _same(v, want), k


def _grow_reqs():
    # 17-token prompts claim 2 pages; max_new=30 forces a 3rd page
    # mid-decode, colliding in a 6-usable-page pool with 3 live rows
    rng = np.random.default_rng(7)
    return [Request(uid=50 + i, prompt=rng.integers(1, 200, size=17).astype(np.int32),
                    max_new=30) for i in range(4)]


@pytest.mark.parametrize("spill", [False, True])
def test_preempt_is_token_exact(model, spill):
    """tests/test_serve_paged.py's preempt-and-requeue and spill warm-resume
    scenarios: pool pressure evicts the youngest request; it regenerates
    (no spill) or resumes from host memory (spill) token-exactly."""
    _, want = _serve(model, _grow_reqs())
    eng, got = _serve(model, _grow_reqs(), paged=True, page_size=16, pool_pages=7,
                      spill=spill)
    assert got == want
    st = eng.stats
    assert st["preemptions"] > 0
    assert st["spills"] == (st["preemptions"] if spill else 0)
    assert (st["spill_restores"] > 0) == spill
    assert not [e for e in eng.failures.events if e["kind"] == "spill"]
