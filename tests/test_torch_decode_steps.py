"""N-step decode (``decode_steps=N``) in the port, against the JAX engine
and against the port's own N = 1, on the reduced stablelm-1.6b (the JAX
engine's weights bridged through numpy; everything on the CPU, where the
port runs its decode block eagerly).

- The port at N in {4, 16} against the JAX engine at the same N: greedy,
  fp and PDQ weights (the JAX side on ``vmap(quantize_param_tree)`` blocks,
  telemetry off), fp and int8 KV, slot rows and paged; streams equal, or
  different only where JAX's top-2 margin is below the logits tolerance
  (tests/test_torch_engine.py), and stats equal apart from the JAX-only
  compile counters and wall-clock straggler flags.
- At temperature 0.9 the port at N gives its own N = 1 streams exactly.
- Dispatch accounting (tests/test_serve_decode_steps.py): 1/N dispatches
  per token, a partial tail block, the cache-headroom cap; preempt and
  requeue token-exact at N = 4 on a small paged pool.
- The page window write-back equals JAX's ``writeback(..., n_steps,
  max_steps)`` bit for bit on the same pool, with blocks that cross page
  boundaries.
- The sampler: a pure function of (seed, uid, step, logits), independent
  of the row and the batch; greedy is ``argmax``.
- The graph dispatch's bookkeeping (``serve/decode_graph.py``) with the
  capture replaced by a CPU stand-in that reruns the block: the same
  streams and kernel counts as the eager engine, one replay a dispatch, and
  a pool left as a fresh one by warm-up and capture.  The capture itself
  runs on the card (tests/test_torch_cuda.py).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as j_reduced
from repro.models import build_model as j_build
from repro.models.linops import quantize_param_tree as j_quantize
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JServeEngine
from repro_torch.bridge import _tensor, params_from_numpy
from repro_torch.configs import reduced_config as t_reduced
from repro_torch.kernels import ops as tops
from repro_torch.models import build_model as t_build
from repro_torch.serve import Request, ServeConfig, build_engine
from repro_torch.serve import decode_graph as dg
from repro_torch.serve import engine as teng_mod

torch.set_num_threads(1)

TOL = {"fp": 1e-5, "pdq": 1e-3}          # tests/test_torch_model.py
SKIP_STATS = {"prefill_compiles", "chunk_compiles", "decode_compiles",
              "straggler_flags", "prefill_straggler_flags", "graph_replays"}
LENS = (3, 40, 17, 9, 33, 25)             # tests/test_torch_engine.py
MIXED_LENS = [3, 5, 8, 9, 12, 16, 17, 23, 30, 4, 11, 27]   # test_serve_decode_steps.py


@pytest.fixture(scope="module")
def weights():
    jcfg = j_reduced("stablelm-1.6b")
    jp = j_build(jcfg).init(jax.random.PRNGKey(0))
    return jcfg, jp, params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")


def _prompts():
    rng = np.random.default_rng(0)
    return [rng.integers(0, 512, size=n).astype(np.int32) for n in LENS]


def _margin_ok(jcfg, jparams, prompt, generated, i, tol):
    """JAX's top-2 logit margin for token i of a stream is below tol."""
    seq = np.concatenate([prompt, np.asarray(generated[:i], np.int32)])[None]
    b = j_build(jcfg)
    logits, _ = b.prefill(jparams, {"tokens": jnp.asarray(seq)},
                          b.init_caches(1, seq.shape[1] + 1))
    top2 = np.sort(np.asarray(logits[0]))[-2:]
    return top2[1] - top2[0] < tol


# (N, weights, int8 KV, paged): each value of each axis beside both of
# every other axis's
@pytest.mark.parametrize("n,kind,int8_kv,paged", [
    (4, "fp", False, False), (16, "fp", True, False), (4, "pdq", True, False),
    (16, "pdq", False, False), (4, "fp", True, True), (16, "fp", False, True),
    (4, "pdq", False, True), (16, "pdq", True, True)])
def test_nstep_engine_matches_jax_engine(weights, n, kind, int8_kv, paged):
    jcfg, jp, tp = weights
    if int8_kv:
        jcfg = dataclasses.replace(jcfg, quant_kv="dynamic")
    jparams = jp if kind == "fp" else dict(jp, blocks=jax.vmap(j_quantize)(jp["blocks"]))
    kw = dict(paged=True, page_size=16) if paged else {}
    jeng = JServeEngine(jcfg, jparams, slots=2, max_len=64, telemetry=False,
                        decode_steps=n, **kw)
    jreqs = [JRequest(uid=i, prompt=p, max_new=12) for i, p in enumerate(_prompts())]
    jeng.run(jreqs)

    teng = build_engine(ServeConfig(slots=2, max_len=64, device="cpu", decode_steps=n,
                                    quantize_weights=kind == "pdq", int8_kv=int8_kv,
                                    telemetry=False, **kw),
                        cfg=t_reduced("stablelm-1.6b"), params=tp)
    treqs = [Request(uid=i, prompt=p, max_new=12) for i, p in enumerate(_prompts())]
    tops.reset_counts()
    teng.run(treqs)

    for jr, tr in zip(jreqs, treqs):
        assert tr.done and tr.error is None and len(tr.generated) == 12
        if tr.generated != jr.generated:
            i = next(k for k, (a, b) in enumerate(zip(tr.generated, jr.generated))
                     if a != b)
            assert _margin_ok(jcfg, jparams, jr.prompt, jr.generated, i, TOL[kind]), (
                tr.uid, i, tr.generated, jr.generated)
    tstats = {k: v for k, v in teng.stats.items() if k not in SKIP_STATS}
    jstats = {k: v for k, v in jeng.stats.items() if k not in SKIP_STATS}
    assert tstats == jstats
    # every row runs every step of a block: the model's kernels count N a
    # dispatch; a paged dispatch gathers and writes back once each
    c = {k: v["entries"] for k, v in tops.counts().items()}
    n_pre, n_dec = teng.stats["prefill_batches"], teng.stats["decode_steps"]
    assert n_dec < teng.stats["decode_tokens"]
    if kind == "pdq":
        assert c["w8a8_swiglu_matmul"] == teng.cfg.n_layers * (n_pre + n * n_dec)
    assert c["cache_scatter_pages"] == ((n_pre + 2 * n_dec) if paged else 0)


def _mixed(cfg, max_new=6, lens=MIXED_LENS):
    rng = np.random.default_rng(0)
    return [Request(uid=i, prompt=rng.integers(0, cfg.vocab, L).astype(np.int32),
                    max_new=max_new) for i, L in enumerate(lens)]


@pytest.fixture(scope="module")
def model():
    tcfg = t_reduced("stablelm-1.6b")
    return tcfg, t_build(tcfg, "cpu").init(0)


def _serve(model, reqs, **kw):
    cfg, params = model
    kw = dict(dict(slots=4, max_len=64, buckets=(8, 16, 32), device="cpu"), **kw)
    eng = build_engine(ServeConfig(**kw), cfg=cfg, params=params)
    eng.run(reqs)
    assert all(r.done for r in reqs)
    return eng, {r.uid: (tuple(r.generated), r.finish_reason, r.error) for r in reqs}


@pytest.mark.parametrize("n,paged,int8_kv", [(4, False, False), (16, False, True),
                                             (4, True, True), (16, True, False)])
def test_nstep_at_temperature_equals_single_step(model, n, paged, int8_kv):
    kw = dict(temperature=0.9, seed=5, int8_kv=int8_kv, quantize_weights=True)
    if paged:
        kw.update(paged=True, page_size=16)
    _, want = _serve(model, _mixed(model[0]), **kw)
    eng, got = _serve(model, _mixed(model[0]), decode_steps=n, **kw)
    assert got == want
    assert len({v[0] for v in got.values()}) > 1


# ---------------------------------------------------------------------------
# dispatch accounting (tests/test_serve_decode_steps.py)
# ---------------------------------------------------------------------------

def test_dispatches_per_token_is_one_over_n(model):
    """Solo row, max_new=33: prefill emits token 0, decode the other 32; at
    N=4 exactly 8 full-block dispatches."""
    eng, out = _serve(model, _mixed(model[0], 33, [5]), decode_steps=4)
    assert eng.stats["decode_steps"] == 8 and eng.stats["decode_tokens"] == 32
    eng1, out1 = _serve(model, _mixed(model[0], 33, [5]))
    assert eng1.stats["decode_steps"] == 32 and out == out1


def test_non_divisible_budget_runs_partial_tail_block(model):
    """max_new=6 -> 5 decode tokens: a block of 4, then a 1-step tail."""
    eng, out = _serve(model, _mixed(model[0], 6, [5]), decode_steps=4)
    assert eng.stats["decode_steps"] == 2 and eng.stats["decode_tokens"] == 5
    assert out == _serve(model, _mixed(model[0], 6, [5]))[1]


@pytest.mark.parametrize("paged", [False, True])
def test_cache_headroom_caps_block_budget(model, paged):
    """A row near max_len gets its block budget capped by the cache
    headroom (last writable position max_len - 2) and completes early,
    token-exact."""
    def run(**kw):
        if paged:
            kw.update(paged=True, page_size=8)
        reqs = _mixed(model[0], 30, [30, 5])
        _serve(model, reqs, max_len=40, **kw)
        assert len(reqs[0].generated) < 30     # the cache, not max_new
        return {r.uid: tuple(r.generated) for r in reqs}

    assert run(decode_steps=4) == run()


def _grow_reqs():
    # 17-token prompts claim 2 pages; max_new=30 forces a 3rd page
    # mid-decode, colliding in a 6-usable-page pool with 3 live rows
    rng = np.random.default_rng(7)
    return [Request(uid=50 + i, prompt=rng.integers(1, 200, size=17).astype(np.int32),
                    max_new=30) for i in range(4)]


def test_preempt_and_requeue_token_exact_at_n4(model):
    """Whole N-step page windows pre-allocated under pool pressure: the
    preempted rows regenerate exactly ((uid, step) sampling)."""
    _, want = _serve(model, _grow_reqs(), temperature=0.9)
    eng, got = _serve(model, _grow_reqs(), temperature=0.9, paged=True, page_size=16,
                      pool_pages=7, decode_steps=4)
    assert got == want
    assert eng.stats["preemptions"] > 0


# ---------------------------------------------------------------------------
# the page window write-back against JAX's
# ---------------------------------------------------------------------------

def _bits(x):
    if torch.is_tensor(x):
        return (x.view(torch.int16) if x.dtype == torch.bfloat16 else x).numpy()
    a = np.asarray(x)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def _rand(rng, shape, dtype):
    dtype = np.dtype(dtype)
    if dtype.kind in "iu":
        return rng.integers(-100, 100, shape).astype(dtype)
    return rng.standard_normal(shape).astype(dtype)


def _port_tree(tree):
    return {sec: tuple({k: _tensor(np.asarray(v), "cpu") for k, v in d.items()}
                       for d in tree[sec]) for sec in ("head", "tail", "blocks")}


# (int8 KV, max_len, max_steps, positions, n_steps); page 16, 4 slots, slot
# 3 free; blocks that stay in a page, end on its last position, cross one
# boundary, and (max_steps 33) cross two
WINDOWS = [
    (False, 64, 4, [5, 14, 30, 0], [4, 3, 2, 0]),
    (False, 64, 16, [5, 14, 31, 0], [16, 16, 1, 0]),
    (True, 128, 16, [16, 47, 100, 0], [16, 2, 16, 0]),
    (True, 128, 33, [15, 20, 60, 0], [33, 12, 1, 0]),
    (False, 64, 1, [5, 16, 40, 0], None),
]


@pytest.mark.parametrize("int8_kv,max_len,max_steps,positions,n_steps", WINDOWS)
def test_window_writeback_matches_jax(int8_kv, max_len, max_steps, positions, n_steps):
    B, page = 4, 16
    jcfg, tcfg = j_reduced("stablelm-1.6b"), t_reduced("stablelm-1.6b")
    if int8_kv:
        jcfg = dataclasses.replace(jcfg, quant_kv="dynamic")
        tcfg = dataclasses.replace(tcfg, quant_kv="dynamic")
    jpo = j_build(jcfg).paged_cache(B, max_len, 0, page)
    tpo = t_build(tcfg, "cpu").paged_cache(B, max_len, page)
    rng = np.random.default_rng(11)
    n_pp = max_len // page
    N = 3 * n_pp + 2
    pool = jax.tree.map(lambda a: _rand(rng, a.shape, a.dtype), jpo.init(N))
    pt = np.full((B, n_pp), -1, np.int32)
    pt[:3] = rng.permutation(np.arange(1, N))[:3 * n_pp].reshape(3, n_pp)
    pt[2, n_pp // 2:] = -1                # row 2 owns only its first pages
    pos = np.asarray(positions, np.int32)[:, None]
    logical = jax.tree.map(lambda a: _rand(rng, a.shape, a.dtype),
                           j_build(jcfg).init_caches(B, max_len))
    if n_steps is None:
        want = jpo.writeback(pool, logical, jnp.asarray(pt), jnp.asarray(pos))
        kw = {}
    else:
        ns = np.asarray(n_steps, np.int32)
        want = jpo.writeback(pool, logical, jnp.asarray(pt), jnp.asarray(pos),
                             n_steps=jnp.asarray(ns), max_steps=max_steps)
        kw = dict(n_steps=ns, max_steps=max_steps)
    got = _port_tree(pool)
    tpo.writeback(got, _port_tree(logical), pt, pos, **kw)
    for k, j in want["blocks"][0].items():
        assert np.array_equal(_bits(got["blocks"][0][k]), _bits(j)), k


def test_gather_into_a_kept_scratch_matches_a_fresh_gather():
    """``gather(..., out=scratch)`` writes the kept tree's paged leaves
    (every byte, init fill included) and returns it; a wrong-shaped
    ``out`` raises."""
    tcfg = dataclasses.replace(t_reduced("stablelm-1.6b"), quant_kv="dynamic")
    po = t_build(tcfg, "cpu").paged_cache(3, 128, 16)
    pool = po.init(9)
    rng = np.random.default_rng(2)
    for v in pool["blocks"][0].values():
        v.copy_(torch.as_tensor(_rand(rng, tuple(v.shape), np.int32)).to(v.dtype))
    pt = np.full((3, 8), -1, np.int32)
    pt[0, :3], pt[2, :2] = [4, 2, 7], [1, 8]
    lengths = np.array([40, 0, 20], np.int32)
    fresh = po.gather(pool, pt, lengths)
    scratch, _ = po.gather_moves(pool, np.full((3, 8), -1, np.int32), np.zeros(3))
    for k, m in po.meta["blocks"][0].items():
        if m.kind == "seq":
            scratch["blocks"][0][k].fill_(7)
    got = po.gather(pool, pt, lengths, out=scratch)
    assert got["blocks"][0]["k"] is scratch["blocks"][0]["k"]
    for k, v in fresh["blocks"][0].items():
        assert torch.equal(got["blocks"][0][k], v), k
    bad = dict(scratch["blocks"][0], pos=scratch["blocks"][0]["pos"][:, :2])
    with pytest.raises(ValueError, match="gather out leaf"):
        po.gather(pool, pt, lengths, out=dict(scratch, blocks=(bad,)))


# ---------------------------------------------------------------------------
# the sampler
# ---------------------------------------------------------------------------

def _logits(B=5, V=257, seed=0):
    return torch.as_tensor(np.random.default_rng(seed).standard_normal((B, V)),
                           dtype=torch.float32)


def test_sampler_depends_only_on_seed_uid_step():
    logits = _logits()
    logits[2] = logits[0]
    uids = torch.tensor([3, 9, 3, 1, 9], dtype=torch.int32)
    steps = torch.tensor([0, 4, 0, 7, 5], dtype=torch.int32)
    a, ok = teng_mod.sample(logits, uids, steps, temperature=0.9, seed=1)
    b, _ = teng_mod.sample(logits, uids, steps, temperature=0.9, seed=1)
    assert torch.equal(a, b) and a.dtype == torch.int32 and bool(ok.all())
    assert a[0] == a[2]                   # same (uid, step, logits)
    draws = {tuple(teng_mod.sample(logits, uids, steps, temperature=0.9,
                                   seed=s)[0].tolist()) for s in range(6)}
    assert len(draws) > 1                 # the seed moves the draw
    other, _ = teng_mod.sample(logits, uids, steps + 1, temperature=0.9, seed=1)
    assert not torch.equal(a, other)      # so does the step


def test_sampler_is_independent_of_row_and_batch():
    logits = _logits(B=6)
    uids = torch.arange(6, dtype=torch.int32) * 7
    steps = torch.arange(6, dtype=torch.int32)
    full, _ = teng_mod.sample(logits, uids, steps, temperature=0.7, seed=3)
    perm = torch.tensor([4, 0, 5, 2])
    part, _ = teng_mod.sample(logits[perm], uids[perm], steps[perm], temperature=0.7,
                              seed=3)
    assert torch.equal(part, full[perm])
    for i in range(6):
        one, _ = teng_mod.sample(logits[i:i + 1], uids[i:i + 1], steps[i:i + 1],
                                 temperature=0.7, seed=3)
        assert one.item() == full[i].item()


def test_sampler_follows_the_distribution():
    """Over many (uid, step) draws of one row of logits, each token's share
    is within 0.02 of its softmax probability at the temperature."""
    V, n = 8, 20000
    lg = torch.tensor([[2.0, 1.0, 0.5, 0.0, -0.5, -1.0, 1.5, 0.2]])
    toks, _ = teng_mod.sample(lg.expand(n, V), torch.arange(n, dtype=torch.int32),
                              torch.zeros(n, dtype=torch.int32), temperature=0.8, seed=0)
    share = torch.bincount(toks.long(), minlength=V).float() / n
    assert float((share - torch.softmax(lg[0] / 0.8, -1)).abs().max()) < 0.02


def test_greedy_is_argmax_and_flags_non_finite_rows():
    logits = _logits()
    logits[1, 3] = float("nan")
    logits[2, :] = 0.0                    # a tie: the first index
    toks, ok = teng_mod.sample(logits, torch.zeros(5, dtype=torch.int32),
                               torch.zeros(5, dtype=torch.int32), temperature=0.0, seed=0)
    assert toks.dtype == torch.int32
    assert torch.equal(toks[[0, 2, 3, 4]].long(), logits[[0, 2, 3, 4]].argmax(-1))
    assert toks[2] == 0
    assert ok.tolist() == [True, False, True, True, True]


# ---------------------------------------------------------------------------
# the graph dispatch's bookkeeping, the capture replaced by a CPU stand-in
# ---------------------------------------------------------------------------

def _clone_tree(tree):
    return {sec: tuple({k: v.clone() for k, v in d.items()} for d in tree[sec])
            for sec in ("head", "tail", "blocks")}


class _Rerun:
    """A stand-in for a CUDA graph: ``replay()`` reruns the block on the
    captured tree into the captured output, leaving the counts alone, as a
    replay does."""

    def __init__(self, body, caches, out):
        self.body, self.caches, self.out = body, caches, out

    def replay(self):
        saved = tops.count_state()
        self.out.copy_(self.body(self.caches))
        tops.set_counts(saved)


def _stand_in_capture(body, caches, device):
    # a capture runs nothing: count on a copy, so the tree is untouched
    out = body(_clone_tree(caches))
    return _Rerun(body, caches, out), out, 0.0, 0


@pytest.fixture
def graphed(monkeypatch):
    monkeypatch.setattr(teng_mod, "_graphed", lambda device: True)
    monkeypatch.setattr(dg, "_warm_up", lambda body, caches, device: body(caches))
    monkeypatch.setattr(dg, "_capture", _stand_in_capture)


def _pool_equals_fresh(eng):
    fresh = (eng._paged_ops.init(eng.pool_pages) if eng.paged
             else eng.bundle.init_caches(eng.slots, eng.max_len))
    return all(torch.equal(eng.caches["blocks"][0][k], v)
               for k, v in fresh["blocks"][0].items())


@pytest.mark.parametrize("n,paged", [(1, False), (4, True), (16, False)])
def test_graph_dispatch_matches_eager(model, n, paged, graphed, monkeypatch):
    kw = dict(decode_steps=n, int8_kv=True, quantize_weights=True, temperature=0.9)
    if paged:
        kw.update(paged=True, page_size=16)
    cfg, params = model
    eng = build_engine(ServeConfig(slots=4, max_len=64, buckets=(8, 16, 32),
                                   device="cpu", **kw), cfg=cfg, params=params)
    assert eng._graph is not None and _pool_equals_fresh(eng)
    reqs = _mixed(cfg)
    tops.reset_counts()
    eng.run(reqs)
    got_counts, got_modes, got_routes = (tops.counts(), tops.prologue_modes(),
                                         tops.route_counts())
    assert eng.stats["graph_replays"] == eng.stats["decode_steps"]

    monkeypatch.setattr(teng_mod, "_graphed", lambda device: False)
    tops.reset_counts()
    want_eng, want = _serve(model, _mixed(cfg), **kw)
    assert want_eng._graph is None and "graph_replays" not in want_eng.stats
    assert {r.uid: (tuple(r.generated), r.finish_reason, r.error) for r in reqs} == want
    assert (got_counts, got_modes, got_routes) == (
        tops.counts(), tops.prologue_modes(), tops.route_counts())
    # what one replay adds: N steps of the model, no pool movement
    tops.reset_counts()
    tops.add_counts(eng._graph.delta)
    delta = tops.counts()
    assert delta["w8a8_swiglu_matmul"]["entries"] == n * cfg.n_layers
    assert delta["cache_scatter_pages"] == {"entries": 0, "launches": 0}


def test_count_state_round_trips():
    tops.reset_counts()
    s0 = tops.count_state()
    tops.COUNTS["w8a8_matmul"].entries += 3
    tops.add_counts([1] * len(s0))
    assert tops.counts()["w8a8_matmul"]["entries"] == 4
    assert tops.prologue_modes()["norm"] == 1
    tops.set_counts(s0)
    assert tops.count_state() == s0 and not any(s0)
