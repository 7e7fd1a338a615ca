"""Chunked prefill in the port against the JAX package's, on the same numpy
weights (everything on the CPU): prompts longer than the largest bucket run
as a first chunk through ``prefill_many`` and continuations through
``prefill_chunk`` (attending the landed prefix, dequantized with an int8
cache, plus the chunk's own k/v, then writing the chunk), then one landing.

- ``prefill_chunk`` itself: a 40-token prompt in chunks of 16 on reduced
  stablelm-1.6b, gemma2-2b and gemma3-12b (local layers' ring of 16: every
  continuation wraps it), fp and int8 KV: logits and caches against JAX's
  ``prefill_chunk`` (int8 codes within one step at a tie, as in
  tests/test_torch_families.py), and the last chunk's logits against an
  unchunked prefill of the whole prompt (fp cache).
- The reference's ``test_chunked_prefill_matches_unchunked``
  (tests/test_serve_sched.py): buckets (8, 16), max_len 64, prompts of 3,
  20, 40, 12 and 33 tokens; the port's chunked streams equal the port's
  unchunked ones (the capacity bucket) and JAX's chunked ones, 3 chunked
  requests, at least 3 continuation launches, for stablelm, gemma2 and
  gemma3.
- The reference's co-batching, extras-rejection and capacity cases, a paged
  pool with chunks (equal to slot rows), and int8 KV against JAX's chunked
  engine with PDQ weights (streams, or JAX's top-2 margin below the PDQ
  tolerance, and stats).
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
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import reduced_config as t_reduced
from repro_torch.kernels import ops as tops
from repro_torch.models import build_model as t_build
from repro_torch.serve import Request, ServeConfig, build_engine

torch.set_num_threads(1)

ARCHS = ("stablelm-1.6b", "gemma2-2b", "gemma3-12b")
TOL = {"fp": 1e-5, "pdq": 1e-3}          # tests/test_torch_model.py
SKIP_STATS = {"prefill_compiles", "chunk_compiles", "decode_compiles",
              "straggler_flags", "prefill_straggler_flags"}
LENS = [3, 20, 40, 12, 33]               # 20, 40 and 33 exceed the 16 bucket
_W: dict = {}


def _weights(arch, int8_kv=False):
    """(jcfg, tcfg, JAX params, port params) of the reduced ``arch``."""
    key = (arch, int8_kv)
    if key not in _W:
        jcfg, tcfg = j_reduced(arch), t_reduced(arch)
        if int8_kv:
            jcfg = dataclasses.replace(jcfg, quant_kv="dynamic")
            tcfg = dataclasses.replace(tcfg, quant_kv="dynamic")
        jp = j_build(jcfg).init(jax.random.PRNGKey(0))
        _W[key] = (jcfg, tcfg, jp, params_from_numpy(jax.tree.map(np.asarray, jp),
                                                    device="cpu"))
    return _W[key]


def _prompts(vocab, lens, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=n).astype(np.int32) for n in lens]


def _serve(tcfg, tp, lens, max_new=5, **kw):
    kw = dict(dict(slots=2, max_len=64, buckets=(8, 16), device="cpu"), **kw)
    eng = build_engine(ServeConfig(**kw), cfg=tcfg, params=tp)
    reqs = [Request(uid=i, prompt=p, max_new=max_new)
            for i, p in enumerate(_prompts(tcfg.vocab, lens))]
    eng.run(reqs)
    assert all(r.done and r.error is None for r in reqs), [r.error for r in reqs]
    return eng, [tuple(r.generated) for r in reqs]


@pytest.mark.parametrize("int8_kv", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_chunk_matches_jax(arch, int8_kv):
    """Prompts of 40 and 35 tokens in three chunks of 16 (the last ragged),
    each launch's logits and the caches after the last against JAX's."""
    jcfg, tcfg, jp, tp = _weights(arch, int8_kv)
    jb, tb = j_build(jcfg), t_build(tcfg, "cpu")
    tol = TOL["pdq" if int8_kv else "fp"]          # an int8 KV code at a tie
    B, C, max_len = 2, 16, 64
    prompt = _prompts(tcfg.vocab, [40, 35], seed=3)
    lens = np.array([len(p) for p in prompt])
    jc, tc = jb.init_caches(B, max_len), tb.init_caches(B, max_len)
    for start in range(0, 48, C):
        n = np.clip(lens - start, 0, C).astype(np.int32)
        tokens = np.zeros((B, C), np.int32)
        for b in range(B):
            tokens[b, :n[b]] = prompt[b][start:start + n[b]]
        if start == 0:
            jl, jc = jb.prefill_many(jp, {"tokens": jnp.asarray(tokens)}, jc,
                                     jnp.asarray(n))
            tl, tc = tb.prefill_many(tp, {"tokens": torch.from_numpy(tokens)}, tc,
                                     torch.from_numpy(n))
        else:
            st = np.full((B,), start, np.int32)
            jl, jc = jb.prefill_chunk(jp, {"tokens": jnp.asarray(tokens)}, jc,
                                      jnp.asarray(n), jnp.asarray(st))
            tl, tc = tb.prefill_chunk(tp, {"tokens": torch.from_numpy(tokens)}, tc,
                                      torch.from_numpy(n), torch.from_numpy(st))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=tol,
                                   err_msg=f"chunk at {start}")
    for jd, td in zip(jc["blocks"], tc["blocks"]):
        for name in jd:
            a, b = np.asarray(jd[name]), td[name].numpy()
            if a.dtype == np.int8:
                d = np.abs(a.astype(np.int32) - b)
                assert d.max() <= 1 and (d > 0).mean() <= 1e-3, name
            elif a.dtype.kind in "iu":
                np.testing.assert_array_equal(b, a, err_msg=name)
            else:
                np.testing.assert_allclose(b, a, rtol=1e-5, atol=tol, err_msg=name)
    if not int8_kv:
        # with an fp cache the last chunk's logits are an unchunked
        # prefill's: the appended cache slots add exactly-zero terms
        whole, _ = tb.prefill(tp, {"tokens": torch.from_numpy(prompt[0][None])},
                              tb.init_caches(1, max_len))
        np.testing.assert_allclose(tl.numpy()[:1], whole.numpy(), rtol=0,
                                   atol=TOL["fp"])


@pytest.mark.parametrize("arch", ARCHS)
def test_chunked_prefill_matches_unchunked(arch):
    """The reference's test on the port, and held against JAX's chunked
    engine: streams equal, 3 chunked requests, >= 3 continuation
    launches, no capacity-sized bucket."""
    jcfg, tcfg, jp, tp = _weights(arch)
    whole, want = _serve(tcfg, tp, LENS)
    assert whole.buckets[-1] == 63        # the capacity bucket admits unchunked
    eng, got = _serve(tcfg, tp, LENS, chunked_prefill=True)
    assert eng.buckets == (8, 16)         # no capacity-sized bucket
    assert got == want
    assert eng.stats["chunked_requests"] == 3
    assert eng.stats["chunk_batches"] >= 3

    jeng = JServeEngine(jcfg, jp, slots=2, max_len=64, buckets=(8, 16),
                        chunked_prefill=True)
    jreqs = [JRequest(uid=i, prompt=p, max_new=5)
             for i, p in enumerate(_prompts(tcfg.vocab, LENS))]
    jeng.run(jreqs)
    assert [tuple(r.generated) for r in jreqs] == got
    tstats = {k: v for k, v in eng.stats.items() if k not in SKIP_STATS}
    assert tstats == {k: v for k, v in jeng.stats.items() if k not in SKIP_STATS}


def test_chunked_cobatch_shares_one_launch_sequence():
    """Prompts with equal chunk counts ride ONE plan: one first-chunk
    launch and one shared continuation, tokens equal to unchunked serving;
    mixed chunk counts do not co-batch (the reference's test)."""
    _, tcfg, _, tp = _weights("gemma3-12b")
    lens = [20, 28, 26]                   # ceil(L / 16) == 2 for each
    _, want = _serve(tcfg, tp, lens, slots=4)
    eng, got = _serve(tcfg, tp, lens, slots=4, chunked_prefill=True)
    assert got == want
    assert eng.stats["chunked_requests"] == 3
    assert eng.stats["prefill_batches"] == 1 and eng.stats["chunk_batches"] == 1
    assert eng.stats["replica_occupancy"] == [0]
    eng2, _ = _serve(tcfg, tp, [20, 40], max_new=4, slots=4, chunked_prefill=True)
    assert eng2.stats["prefill_batches"] == 2


def test_chunked_extras_rejected_without_leaking_the_slot():
    """Chunked prefill is text-only: extras beside a prompt that needs
    chunking raise at run()/submit() entry, with no slot leaked and nothing
    dequeued; the engine then serves normally (the reference's test)."""
    _, tcfg, _, tp = _weights("stablelm-1.6b")
    eng = build_engine(ServeConfig(slots=2, max_len=64, buckets=(8,), device="cpu",
                                   chunked_prefill=True), cfg=tcfg, params=tp)
    extras = {"patches": np.zeros((1, 2, 4), np.float32)}
    short, oversized = (Request(uid=i, prompt=p, max_new=4)
                        for i, p in enumerate(_prompts(tcfg.vocab, [5, 20])))
    with pytest.raises(NotImplementedError, match="text-only"):
        eng.run([short, oversized], extras=extras)
    assert eng._free_total() == 2 and eng.stats["replica_occupancy"] == [0]
    assert not eng.pending
    with pytest.raises(NotImplementedError, match="text-only"):
        eng.submit(oversized, extras=extras)
    assert eng._free_total() == 2
    eng.run([short, oversized])
    assert short.done and oversized.done


def test_chunked_prefill_rejects_beyond_capacity():
    """Chunking lifts the bucket limit, not the cache capacity (the
    reference's test)."""
    _, tcfg, _, tp = _weights("stablelm-1.6b")
    eng = build_engine(ServeConfig(slots=2, max_len=32, buckets=(8,), device="cpu",
                                   chunked_prefill=True), cfg=tcfg, params=tp)
    ok, bad = (Request(uid=i, prompt=p, max_new=4)
               for i, p in enumerate(_prompts(tcfg.vocab, [20, 32])))
    with pytest.raises(ValueError, match="exceeds the cache capacity"):
        eng.run([ok, bad])
    assert not eng.pending
    eng.run([ok])
    assert ok.done


@pytest.mark.parametrize("int8_kv", [False, True])
@pytest.mark.parametrize("arch", ["stablelm-1.6b", "gemma3-12b"])
def test_paged_chunked_equals_slot_rows(arch, int8_kv):
    """A paged pool (page 16) with chunks: the streams of the slot-row
    chunked engine, the chunked rows landed page-wise once; request 3 (36
    tokens) shares the first 16-token page of request 2 (40 tokens), both
    in one chunk plan of the second round."""
    _, tcfg, _, tp = _weights(arch, int8_kv)
    lens = [3, 20, 40, 36, 12, 33]
    prompts = _prompts(tcfg.vocab, lens)
    prompts[3][:16] = prompts[2][:16]

    def run(**kw):
        eng = build_engine(ServeConfig(slots=2, max_len=64, buckets=(8, 16),
                                       device="cpu", chunked_prefill=True,
                                       int8_kv=int8_kv, **kw), cfg=tcfg, params=tp)
        reqs = [Request(uid=i, prompt=p, max_new=5) for i, p in enumerate(prompts)]
        tops.reset_counts()
        eng.run(reqs)
        assert all(r.done and r.error is None for r in reqs)
        return eng, [tuple(r.generated) for r in reqs], tops.counts()

    _, want, _ = run()
    eng, got, counts = run(paged=True, page_size=16)
    assert got == want
    assert eng.stats["chunked_requests"] == 4
    assert eng.stats["prefix_hits"] >= 1
    # every round lands with one K7 launch, each decode dispatch gathers
    # and writes back with one each
    st = eng.stats
    assert counts["cache_scatter_pages"]["entries"] == (
        st["prefill_batches"] + 2 * st["decode_steps"])


@pytest.mark.parametrize("arch", ARCHS)
def test_int8_kv_chunked_matches_jax_chunked_engine(arch):
    """int8 KV and PDQ weights: the port's chunked engine against JAX's
    (its continuations attend the dequantized prefix in both): greedy
    streams (or JAX's top-2 margin below the PDQ tolerance) and stats."""
    jcfg, tcfg, jp, tp = _weights(arch, True)
    jparams = dict(jp, blocks=jax.vmap(j_quantize)(jp["blocks"]))
    jeng = JServeEngine(jcfg, jparams, slots=2, max_len=64, buckets=(8, 16),
                        chunked_prefill=True, telemetry=False)
    jreqs = [JRequest(uid=i, prompt=p, max_new=5)
             for i, p in enumerate(_prompts(tcfg.vocab, LENS))]
    jeng.run(jreqs)
    eng, got = _serve(tcfg, tp, LENS, chunked_prefill=True, int8_kv=True,
                      quantize_weights=True, telemetry=False)
    for jr, g in zip(jreqs, got):
        if tuple(jr.generated) != g:
            i = next(k for k, (a, b) in enumerate(zip(g, jr.generated)) if a != b)
            seq = np.concatenate([jr.prompt, np.asarray(jr.generated[:i], np.int32)])
            jb = j_build(jcfg)
            logits, _ = jb.prefill(jparams, {"tokens": jnp.asarray(seq[None])},
                                   jb.init_caches(1, seq.size + 1))
            top2 = np.sort(np.asarray(logits[0]))[-2:]
            assert top2[1] - top2[0] < TOL["pdq"], (jr.uid, i, g, jr.generated)
    tstats = {k: v for k, v in eng.stats.items() if k not in SKIP_STATS}
    assert tstats == {k: v for k, v in jeng.stats.items() if k not in SKIP_STATS}


@pytest.mark.parametrize("window", [None, 16])
def test_chunked_attention_takes_a_ragged_last_chunk(window):
    """An unchunked engine's capacity bucket (max_len - 1 tokens) is no
    multiple of the 512 / 1024 chunks: the port's chunked_attention takes a
    shorter last chunk, equal to one whole tile within f32 summation order,
    and at multiples of the chunks equal to JAX's."""
    from repro.models import attention as jatt
    from repro_torch.models import attention as tatt
    rng = np.random.default_rng(5)
    B, S, H, Hkv, Dh = 2, 47, 4, 2, 16
    q, k, v = (rng.standard_normal((B, S, n, Dh)).astype(np.float32)
               for n in (H, Hkv, Hkv))
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    t = [torch.from_numpy(a) for a in (q, k, v, pos)]
    ragged = tatt.chunked_attention(*t, t[3], window=window, q_chunk=16, kv_chunk=8)
    whole = tatt.chunked_attention(*t, t[3], window=window, q_chunk=S, kv_chunk=S)
    np.testing.assert_allclose(ragged.numpy(), whole.numpy(), rtol=1e-5, atol=1e-6)
    j = jatt.chunked_attention(*(jnp.asarray(a[:, :32]) for a in (q, k, v, pos)),
                               jnp.asarray(pos[:, :32]), window=window, q_chunk=16,
                               kv_chunk=8)
    t32 = tatt.chunked_attention(*(x[:, :32] for x in t), t[3][:, :32], window=window,
                                 q_chunk=16, kv_chunk=8)
    np.testing.assert_allclose(t32.numpy(), np.asarray(j), rtol=1e-5, atol=1e-6)
