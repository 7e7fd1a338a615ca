"""The port's guarded PDQ fallback and PDQ health counters
(``repro_torch.kernels.ops``: ``pdq_guard``, ``pdq_telemetry``,
``pdq_fault``; ``kernels/fp_dequant.py``; the engines' health vector)
against the JAX package's on the same numpy inputs and weights, on the CPU.

- The guard passes finite results through bit for bit.
- Under ``pdq_fault`` the result is the fallback: equal to the port's own
  ``_fp_dequant_matmul`` exactly, to JAX's poisoned projection within
  rtol = atol = 1e-5 (float32 products summed in another order).
- The collector's [fallbacks, clip_hits, clip_total] equal JAX's exactly
  for ``pdq_dense`` (fp and int8), ``pdq_dense_from_prologue``,
  ``pdq_dense_grouped`` (fp and int8) and the guarded ``pdq_mlp``.  The
  records are quantized with alpha = beta = 1 (the records' 6 gives no
  clip hits on random weights), so that the counts are not all 0.
- NaN in one row of x, in one weight scale and in one row's clamp bound
  give the same non-finite rows and columns of y as JAX (unguarded, and
  guarded for the NaN row).
- The model's (3,) vector over one prefill and two decode steps equals
  JAX's: the reference run under ``jax.disable_jit()`` (its collector
  otherwise leaks a tracer out of the scanned blocks; ROADMAP.md Queue 3)
  with ``vmap(quantize_param_tree)`` blocks, every record's alpha and beta
  scaled by 0.25, unguarded and guarded.
- A guarded, poisoned JAX engine (telemetry off) and the port's give the
  same greedy streams, and the port's counts one fallback for each guarded
  projection of each launch.
- An engine's pdq stats are the sum of its launches' vectors (each rode
  the launch's token copy), at N = 1 and 4, slot rows and paged.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as j_reduced
from repro.kernels import ops as jops
from repro.models import build_model as j_build
from repro.models import linops as jlin
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JServeEngine
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import reduced_config as t_reduced
from repro_torch.kernels import ops as tops
from repro_torch.models import build_model as t_build
from repro_torch.models import linops as tlin
from repro_torch.serve import Request, ServeConfig, build_engine

torch.set_num_threads(1)

ALPHA = 1.0          # record alpha = beta for the op-level counts
SCALE = 0.25         # the model's records' alpha and beta scaled by this
RTOL = ATOL = 1e-5


def _w(shape, seed, scale=0.1):
    return (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _records(alpha=ALPHA):
    """One plain record (96 -> 200), one grouped (96 -> 64 | 32 | 130) and
    an MLP pair (gate/up 96 -> 2 x 128, w_down 128 -> 96), each side built
    by its own package from the same numpy weights."""
    w = _w((96, 200), 1)
    ws = [_w((96, n), 2 + i) for i, n in enumerate((64, 32, 130))]
    gu = [_w((96, 128), 5), _w((96, 128), 6)]
    wd = _w((128, 96), 7)
    t = lambda a: torch.from_numpy(a)                       # noqa: E731
    j = jnp.asarray
    return {
        "torch": dict(rec=tlin.quantize_weight(t(w), alpha, alpha),
                      grec=tlin.group_quantize_weights([t(a) for a in ws], alpha, alpha),
                      gu=tlin.group_quantize_weights([t(a) for a in gu], alpha, alpha),
                      down=tlin.quantize_weight(t(wd), alpha, alpha)),
        "jax": dict(rec=jlin.quantize_weight(j(w), alpha, alpha),
                    grec=jlin.group_quantize_weights([j(a) for a in ws], alpha, alpha),
                    gu=jlin.group_quantize_weights([j(a) for a in gu], alpha, alpha),
                    down=jlin.quantize_weight(j(wd), alpha, alpha)),
    }


def _run(pkg, op, x, r):
    """One op of ``pkg`` (tops or jops) on x with the records ``r``; the fp
    result as numpy (f32), the int8 ones as their codes."""
    if op == "dense_fp":
        y = pkg.pdq_dense(x, r["rec"], out="fp")
    elif op == "dense_int8":
        y = pkg.pdq_dense(x, r["rec"], out="int8")[0]
    elif op == "from_prologue":
        y = pkg.pdq_dense_from_prologue(x, *pkg.pdq_prologue(x), r["rec"])
    elif op == "grouped_fp":
        y = pkg.pdq_dense_grouped(x, r["grec"], out="fp")
    elif op == "grouped_int8":
        y = pkg.pdq_dense_grouped(x, r["grec"], out="int8")[0]
    elif op == "mlp":
        y = pkg.pdq_mlp(x, r["gu"], r["down"])
    else:
        raise ValueError(op)
    ys = y if isinstance(y, tuple) else (y,)
    return np.concatenate([np.asarray(a) for a in ys], axis=-1)


def _both(op, x, *, guard=False, fault=False, collect=True, records=None):
    """(port result, JAX result, port summary, JAX summary) of ``op``."""
    recs = records or _records()
    out = {}
    for name, pkg, xin in (("torch", tops, torch.from_numpy(x)),
                           ("jax", jops, jnp.asarray(x))):
        with pkg.pdq_guard(guard), pkg.pdq_telemetry(collect) as col:
            if fault:
                with pkg.pdq_fault():
                    y = _run(pkg, op, xin, recs[name])
            else:
                y = _run(pkg, op, xin, recs[name])
            out[name] = (y, np.asarray(col.summary()))
    return out["torch"][0], out["jax"][0], out["torch"][1], out["jax"][1]


# ---------------------------------------------------------------------------
# the guard
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("op", ["dense_fp", "from_prologue", "grouped_fp"])
def test_guard_passes_finite_results_through(op):
    x = _x((4, 96))
    r = _records()["torch"]
    fast = _run(tops, op, torch.from_numpy(x), r)
    with tops.pdq_guard():
        guarded = _run(tops, op, torch.from_numpy(x), r)
    np.testing.assert_array_equal(guarded, fast)


@pytest.mark.parametrize("op", ["dense_fp", "from_prologue", "grouped_fp", "mlp"])
def test_fault_routes_to_fp_dequant_fallback(op):
    x = _x((5, 96))
    ty, jy, tsum, jsum = _both(op, x, guard=True, fault=True)
    assert np.isfinite(ty).all()
    np.testing.assert_allclose(ty, jy, rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(tsum, jsum)
    assert tsum[0] == (2 if op == "mlp" else 1)      # one fallback a projection
    if op == "mlp":
        return
    r = _records()["torch"]
    rec = r["grec"] if op == "grouped_fp" else r["rec"]
    want = tops._fp_dequant_matmul(torch.from_numpy(x), rec["q"], rec["scale"],
                                   torch.float32).numpy()
    if op == "grouped_fp":
        segs = rec["segs"]
        want = np.concatenate([want[:, o:o + n] for o, n in zip(segs.offsets, segs.sizes)],
                              axis=-1)
    np.testing.assert_array_equal(ty, want)


def test_fallback_resets_the_flag_and_counts_only_when_taken():
    """The plain fallback on its operands: a clear flag leaves y and the
    counters alone; a set flag overwrites y, counts one fallback and is
    cleared."""
    from repro_torch.kernels import fp_dequant as fd
    r = _records()["torch"]["rec"]
    x = torch.from_numpy(_x((3, 96)))
    y = torch.full((3, 200), 7.0)
    flag = torch.zeros((2,), dtype=torch.int32)
    tel = torch.zeros((3,), dtype=torch.int64)
    fd.fp_dequant_fallback(y, x, r["q"], r["scale"], flag, tel)
    assert bool((y == 7.0).all()) and tel.tolist() == [0, 0, 0]
    flag[0] = 1
    fd.fp_dequant_fallback(y, x, r["q"], r["scale"], flag, tel)
    torch.testing.assert_close(y, tops._fp_dequant_matmul(x, r["q"], r["scale"],
                                                          torch.float32), rtol=0, atol=0)
    assert tel.tolist() == [1, 0, 0] and flag.tolist() == [0, 0]


# ---------------------------------------------------------------------------
# the collector
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("op,guard", [("dense_fp", False), ("dense_int8", False),
                                      ("from_prologue", False), ("grouped_fp", False),
                                      ("grouped_int8", False), ("dense_fp", True),
                                      ("grouped_fp", True), ("mlp", True)])
def test_collector_counts_equal_jax(op, guard):
    x = _x((6, 96), seed=3)
    ty, jy, tsum, jsum = _both(op, x, guard=guard)
    np.testing.assert_array_equal(tsum, jsum)
    assert tsum[0] == 0 and 0 < tsum[1] < tsum[2]       # clipping provoked
    if op.endswith("int8"):
        np.testing.assert_array_equal(ty, jy)


def test_collector_disabled_is_constant_zeros():
    x = torch.from_numpy(_x((2, 96)))
    r = _records()["torch"]["rec"]
    with tops.pdq_telemetry(enable=False) as col:
        tops.pdq_dense(x, r)
    assert col.summary().tolist() == [0.0, 0.0, 0.0]
    assert col.summary().shape == (tops.PDQ_TEL_WIDTH,)


def test_collector_adds_into_given_counters():
    """An engine passes its own counters: each projection adds into them,
    over any number of collectors."""
    x = torch.from_numpy(_x((2, 96)))
    r = _records()["torch"]["rec"]
    tel = torch.zeros((3,), dtype=torch.int64)
    for _ in range(3):
        with tops.pdq_telemetry(counters=tel):
            tops.pdq_dense(x, r)
    with tops.pdq_telemetry() as col:
        tops.pdq_dense(x, r)
    assert tel.tolist() == (3 * col.counters).tolist() and tel[2] == 3 * 2 * 200


# ---------------------------------------------------------------------------
# NaN travels as in the reference
# ---------------------------------------------------------------------------


def _nan_records(where):
    recs = _records()
    if where == "scale_col":
        t = recs["torch"]["rec"]
        t["scale"] = t["scale"].clone()
        t["scale"][17] = float("nan")
        recs["jax"]["rec"] = dict(recs["jax"]["rec"],
                                  scale=recs["jax"]["rec"]["scale"].at[17].set(jnp.nan))
    return recs


@pytest.mark.parametrize("where,guard", [("x_row", False), ("scale_col", False),
                                         ("x_row", True), ("scale_col", True)])
def test_nan_input_gives_the_same_non_finite_outputs(where, guard):
    x = _x((5, 96), seed=4)
    if where == "x_row":
        x[1, 7] = np.nan
    ty, jy, tsum, jsum = _both("dense_fp", x, guard=guard, records=_nan_records(where))
    np.testing.assert_array_equal(np.isfinite(ty), np.isfinite(jy))
    assert not np.isfinite(ty).all()
    np.testing.assert_array_equal(tsum, jsum)
    fin = np.isfinite(jy)
    np.testing.assert_allclose(ty[fin], jy[fin], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("bound", ["lo", "hi"])
def test_nan_bound_gives_the_same_non_finite_rows(bound):
    rng = np.random.default_rng(5)
    x_q = rng.integers(-127, 128, (5, 96)).astype(np.int8)
    lo = np.full((5, 1), -0.5, np.float32)
    hi = np.full((5, 1), 0.5, np.float32)
    (lo if bound == "lo" else hi)[2] = np.nan
    r = _records()
    ty = tops.w8a8_matmul(torch.from_numpy(x_q), r["torch"]["rec"]["q"], torch.ones((5, 1)),
                          0, r["torch"]["rec"]["scale"],
                          fp_range=(torch.from_numpy(lo), torch.from_numpy(hi))).numpy()
    jy = np.asarray(jops.w8a8_matmul(jnp.asarray(x_q), r["jax"]["rec"]["q"],
                                     jnp.ones((5, 1)), 0, r["jax"]["rec"]["scale"],
                                     fp_range=(jnp.asarray(lo), jnp.asarray(hi))))
    np.testing.assert_array_equal(np.isfinite(ty), np.isfinite(jy))
    assert not np.isfinite(ty[2]).any() and np.isfinite(np.delete(ty, 2, 0)).all()


# ---------------------------------------------------------------------------
# the model's health vector against JAX's
# ---------------------------------------------------------------------------


def _scaled_jax(tree, f):
    """The JAX param tree with every record's alpha and beta times f."""
    if isinstance(tree, dict):
        out = {k: _scaled_jax(v, f) for k, v in tree.items()}
        if "alpha" in tree:
            out["alpha"], out["beta"] = tree["alpha"] * f, tree["beta"] * f
        return out
    if isinstance(tree, (list, tuple)):
        return type(tree)(_scaled_jax(v, f) for v in tree)
    return tree


def _scale_torch(tree, f, seen=None):
    """Every record's alpha and beta of the port's tree times f, in place
    (a group record shared by its segment views once)."""
    seen = set() if seen is None else seen
    if isinstance(tree, dict):
        if "alpha" in tree and id(tree) not in seen:
            seen.add(id(tree))
            tree["alpha"].mul_(f)
            tree["beta"].mul_(f)
        for v in tree.values():
            _scale_torch(v, f, seen)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _scale_torch(v, f, seen)


@pytest.fixture(scope="module")
def model():
    jcfg, tcfg = j_reduced("stablelm-1.6b"), t_reduced("stablelm-1.6b")
    jb, tb = j_build(jcfg), t_build(tcfg, "cpu")
    jp = jb.init(jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    jq = _scaled_jax(dict(jp, blocks=jax.vmap(jlin.quantize_param_tree)(jp["blocks"])),
                     SCALE)
    tq = tlin.quantize_param_tree(tp)
    _scale_torch(tq, SCALE)
    return jcfg, jb, jp, jq, tcfg, tb, tp, tq


@pytest.mark.parametrize("guard", [False, True])
def test_model_health_vector_equals_jax(model, guard):
    """One prefill of 2 rows x 9 tokens and two greedy decode steps: the
    summed (3,) vector of each side.  8 PDQ projections a layer and step
    (QKV, wo, gate/up, w_down) are counted."""
    jcfg, jb, _, jq, tcfg, tb, _, tq = model
    tokens = np.random.default_rng(0).integers(0, jcfg.vocab, (2, 9)).astype(np.int32)
    lens = np.array([9, 6], np.int32)
    sums = {}
    with jax.disable_jit(), jops.pdq_guard(guard):
        total = np.zeros(3, np.float32)
        with jops.pdq_telemetry() as col:
            jl, jc = jb.prefill_many(jq, {"tokens": jnp.asarray(tokens)},
                                     jb.init_caches(2, 16), jnp.asarray(lens))
            total += np.asarray(col.summary())
        pos = lens.copy()
        for _ in range(2):
            tok = np.array(jnp.argmax(jl, -1), np.int32)[:, None]
            with jops.pdq_telemetry() as col:
                jl, jc = jb.decode_step(jq, jc, jnp.asarray(tok),
                                        jnp.asarray(pos[:, None]))
                total += np.asarray(col.summary())
            pos += 1
        sums["jax"] = total
    with tops.pdq_guard(guard):
        tel = torch.zeros((3,), dtype=torch.int64)
        with tops.pdq_telemetry(counters=tel):
            tl, tc = tb.prefill_many(tq, {"tokens": torch.from_numpy(tokens)},
                                     tb.init_caches(2, 16), torch.from_numpy(lens))
        pos = lens.copy()
        for _ in range(2):
            tok = tl.argmax(-1).to(torch.int32)[:, None]
            with tops.pdq_telemetry(counters=tel):
                tl, tc = tb.decode_step(tq, tc, tok, torch.from_numpy(pos[:, None]))
            pos += 1
        sums["torch"] = tel.numpy()
    np.testing.assert_array_equal(sums["torch"], sums["jax"])
    # every row of every projection counted: the outputs' widths, padded
    # segments included (QKV 384, wo 64, gate/up 256, w_down 64)
    layer = tq["blocks"][0]
    per_row = sum(r["q"].shape[1] for r in (layer["attn"]["wq"]["group"], layer["attn"]["wo"],
                                            layer["ffn"]["w_gate"]["group"],
                                            layer["ffn"]["w_down"]))
    assert sums["torch"][2] == tcfg.n_layers * per_row * (2 * 9 + 2 * 2)
    assert sums["torch"][0] == 0 and sums["torch"][1] > 0


# ---------------------------------------------------------------------------
# engines
# ---------------------------------------------------------------------------


def _prompts(vocab, lens=(3, 17, 9, 12)):
    rng = np.random.default_rng(0)
    return [rng.integers(0, vocab, size=n).astype(np.int32) for n in lens]


def test_guarded_poisoned_engine_matches_jax(model):
    """Every guarded projection poisoned on both sides: the fallback carries
    the computation, every request completes, and the greedy streams are
    equal (at a difference, JAX's top-2 margin below 1e-3).  The port
    counts one fallback per guarded projection per launch: 4 a layer."""
    jcfg, jb, jp, _, tcfg, _, tp, _ = model
    jparams = dict(jp, blocks=jax.vmap(jlin.quantize_param_tree)(jp["blocks"]))
    jeng = JServeEngine(jcfg, jparams, slots=2, max_len=64, telemetry=False,
                        pdq_fallback=True)
    jreqs = [JRequest(uid=i, prompt=p, max_new=5) for i, p in enumerate(_prompts(512))]
    with jops.pdq_fault():
        jeng.run(jreqs)
    teng = build_engine(ServeConfig(slots=2, max_len=64, device="cpu",
                                    quantize_weights=True, pdq_fallback=True),
                        cfg=tcfg, params=tp)
    treqs = [Request(uid=i, prompt=p, max_new=5) for i, p in enumerate(_prompts(512))]
    with tops.pdq_fault():
        teng.run(treqs)
    assert all(r.done and r.error is None for r in jreqs + treqs)
    for jr, tr in zip(jreqs, treqs):
        if tr.generated != jr.generated:
            i = next(k for k, (a, b) in enumerate(zip(tr.generated, jr.generated))
                     if a != b)
            seq = np.concatenate([jr.prompt, np.asarray(jr.generated[:i], np.int32)])[None]
            logits, _ = jb.prefill(jparams, {"tokens": jnp.asarray(seq)},
                                   jb.init_caches(1, seq.shape[1] + 1))
            top2 = np.sort(np.asarray(logits[0]))[-2:]
            assert top2[1] - top2[0] < 1e-3, (tr.uid, i, tr.generated, jr.generated)
    st = teng.stats
    assert st["failed"] == 0 and jeng.stats["failed"] == 0
    launches = st["prefill_batches"] + st["decode_steps"]
    assert st["pdq_fallbacks"] == 4 * tcfg.n_layers * launches
    assert st["pdq_clip_total"] > 0


def _health_engine(model, **kw):
    tcfg, tp = model[4], model[6]
    eng = build_engine(ServeConfig(slots=4, max_len=64, buckets=(8, 16, 32), device="cpu",
                                   quantize_weights=True, int8_kv=True, **kw),
                       cfg=tcfg, params=tp)
    _scale_torch(eng.params, SCALE)
    seen = []
    observe = eng._observe_pdq

    def spy(health):
        seen.append(np.asarray(health, np.int64).copy())
        observe(health)

    eng._observe_pdq = spy
    reqs = [Request(uid=i, prompt=p, max_new=6)
            for i, p in enumerate(_prompts(tcfg.vocab, (3, 17, 9, 12, 30, 5)))]
    eng.run(reqs)
    assert all(r.done and r.error is None for r in reqs)
    return eng, seen


@pytest.mark.parametrize("n", [1, 4])
def test_engine_stats_are_the_sum_of_launch_vectors(model, n):
    """Each launch's vector rode its token copy into ``_observe_pdq``; the
    stats hold their sum.  Slot rows and paged run the same launches on the
    same rows, so their vectors are equal, launch for launch."""
    got = {}
    for paged in (False, True):
        kw = dict(decode_steps=n)
        if paged:
            kw.update(paged=True, page_size=16)
        eng, seen = _health_engine(model, **kw)
        st = eng.stats
        assert len(seen) == st["prefill_batches"] + st["decode_steps"]
        total = np.sum(seen, axis=0)
        assert [st["pdq_fallbacks"], st["pdq_clip_hits"], st["pdq_clip_total"]] == \
            total.tolist()
        assert total[0] == 0 and 0 < total[1] < total[2]
        got[paged] = seen
    assert [v.tolist() for v in got[False]] == [v.tolist() for v in got[True]]


def test_engine_telemetry_off_reports_zeros(model):
    eng, seen = _health_engine(model, telemetry=False)
    assert all(v.tolist() == [0, 0, 0] for v in seen)
    assert eng.stats["pdq_clip_total"] == 0


def test_decode_scan_sums_its_steps_into_the_counters(model):
    """N-step block: the counters hold the block's sum, the same as N
    single-step blocks on the same state."""
    from repro_torch.serve.engine import decode_scan, sample
    tcfg, tb, tq = model[4], model[5], model[7]
    step = lambda c, t, p: tb.decode_step(tq, c, t, p)        # noqa: E731
    samp = lambda lg, u, s: sample(lg, u, s, temperature=0.0, seed=0)  # noqa: E731
    rows = (torch.tensor([[5], [9]], dtype=torch.int32), torch.tensor([[3], [4]], dtype=torch.int32),
            torch.tensor([0, 1], dtype=torch.int32), torch.zeros(2, dtype=torch.int32),
            torch.tensor([3, 3], dtype=torch.int32))
    tel4 = torch.zeros(3, dtype=torch.int64)
    toks4, _ = decode_scan(step, samp, 3)(tb.init_caches(2, 16), *rows, tel4)
    tel1 = torch.zeros(3, dtype=torch.int64)
    caches, (tok, pos, uids, steps, n_steps) = tb.init_caches(2, 16), rows
    one = decode_scan(step, samp, 1)
    for t in range(3):
        toks1, _ = one(caches, tok, pos, uids, steps + t, n_steps - t, tel1)
        assert toks1[:, 0].tolist() == toks4[:, t].tolist()
        tok, pos = toks1[:, :1], pos + 1
    assert tel1.tolist() == tel4.tolist() and tel4[2] > 0


def test_pdq_fallback_builds_a_guarded_engine(model):
    """``ServeConfig(pdq_fallback=True)`` builds the guarded engine."""
    eng = build_engine(ServeConfig(device="cpu", slots=2, max_len=32, pdq_fallback=True,
                                   quantize_weights=True), cfg=model[4], params=model[6])
    assert eng.pdq_fallback
