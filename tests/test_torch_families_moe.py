"""The port's ServeEngine on the MoE families against
repro.serve.ServeEngine: reduced deepseek-v2-236b (MLA, a ``global_dense``
head layer, then MoE layers with shared experts) and reduced arctic-480b
(GQA, MoE with a dense residual MLP), d_model 64, float32, 8 experts top-2
(capacity factor 8.0), on the same numpy weights.

Weights fp, or PDQ: JAX on ``dict(params, head=quantize_param_tree(
params["head"]), blocks=vmap(quantize_param_tree)(params["blocks"]))``
(the reference's own engine leaves the stacked blocks fp, ROADMAP.md Queue
3) with telemetry off; the port with ``quantize_weights=True``, telemetry
off.  In both the expert stacks stay fp (3-D leaves) and (wq_a, wkv_a) is
one grouped record.  Arctic also with the int8 KV cache.  2 slots, max_len
64, 6 requests of 3-40 prompt tokens and 8 new ones; unchunked (the
default buckets) and chunked (buckets (8, 16): four prompts split, the
first chunk through ``prefill_many``, the rest through ``prefill_chunk``).

The port runs with slot rows and paged (page 16: every MLA leaf of the
head layer and the blocks pages but ``len``; arctic's int8 K/V stay flat
below max_len 128, as on every int8 pool), at 1 and 4 decode steps a
dispatch.  Greedy streams are identical (at a difference, JAX's top-2
margin for that token must be below the PDQ logits tolerance of
tests/test_torch_model.py; none differed here); with slot rows and one
step a dispatch the scheduler's stats are equal too.

Last, the reference's pad invariance under tight capacity
(tests/test_serve_sched.py:445-470) on the port: capacity factor 1.0, a
bucketed ``prefill_many`` whose pad tail holds zeros or junk gives the same
logits and caches bit for bit, and its logits equal JAX's within 1e-5.
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
from repro_torch.models import build_model as t_build
from repro_torch.serve import Request, ServeConfig, build_engine

torch.set_num_threads(1)

TOL = 1e-3                                # tests/test_torch_model.py, PDQ
SKIP_STATS = {"prefill_compiles", "chunk_compiles", "decode_compiles",
              "straggler_flags", "prefill_straggler_flags"}
LENS = (3, 30, 12, 25, 9, 40)
CHUNK_BUCKETS = (8, 16)
_WEIGHTS: dict = {}
_RUNS: dict = {}


def _prompts(vocab):
    rng = np.random.default_rng(0)
    return [rng.integers(0, vocab, size=n).astype(np.int32) for n in LENS]


def _weights(arch):
    """(JAX fp params, port fp params) of the reduced ``arch``, once."""
    if arch not in _WEIGHTS:
        jp = j_build(j_reduced(arch)).init(jax.random.PRNGKey(0))
        _WEIGHTS[arch] = (jp, params_from_numpy(jax.tree.map(np.asarray, jp),
                                                device="cpu"))
    return _WEIGHTS[arch]


def _jax_run(arch, int8_kv, pdq, chunked):
    """(jcfg, JAX params, JAX requests, JAX stats) of one reference run."""
    key = (arch, int8_kv, pdq, chunked)
    if key not in _RUNS:
        jcfg = j_reduced(arch)
        if int8_kv:
            jcfg = dataclasses.replace(jcfg, quant_kv="dynamic")
        jp, _ = _weights(arch)
        if pdq:
            jp = dict(jp, head=j_quantize(jp["head"]),
                      blocks=jax.vmap(j_quantize)(jp["blocks"]))
        extra = dict(buckets=CHUNK_BUCKETS, chunked_prefill=True) if chunked else {}
        jeng = JServeEngine(jcfg, jp, slots=2, max_len=64, telemetry=False, **extra)
        jreqs = [JRequest(uid=i, prompt=p, max_new=8)
                 for i, p in enumerate(_prompts(jcfg.vocab))]
        jeng.run(jreqs)
        _RUNS[key] = (jcfg, jp, jreqs, dict(jeng.stats))
    return _RUNS[key]


def _margin_ok(jcfg, jparams, prompt, generated, i, tol):
    """JAX's top-2 logit margin for token i of a stream is below tol."""
    seq = np.concatenate([prompt, np.asarray(generated[:i], np.int32)])[None]
    b = j_build(jcfg)
    logits, _ = b.prefill(jparams, {"tokens": jnp.asarray(seq)},
                          b.init_caches(1, seq.shape[1] + 1))
    top2 = np.sort(np.asarray(logits[0]))[-2:]
    return top2[1] - top2[0] < tol


CASES = ([("deepseek-v2-236b", False, pdq, chunked)
          for pdq in (False, True) for chunked in (False, True)]
         + [("arctic-480b", True, pdq, chunked)
            for pdq in (False, True) for chunked in (False, True)]
         + [("arctic-480b", False, pdq, False) for pdq in (False, True)])


@pytest.mark.parametrize("steps", [1, 4])
@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("arch,int8_kv,pdq,chunked", CASES)
def test_engine_streams_match_jax_engine(arch, int8_kv, pdq, chunked, paged, steps):
    jcfg, jparams, jreqs, jstats = _jax_run(arch, int8_kv, pdq, chunked)
    _, tp = _weights(arch)
    extra = dict(paged=True, page_size=16) if paged else {}
    if chunked:
        extra.update(buckets=CHUNK_BUCKETS, chunked_prefill=True)
    teng = build_engine(ServeConfig(slots=2, max_len=64, device="cpu",
                                    quantize_weights=pdq, int8_kv=int8_kv,
                                    decode_steps=steps, telemetry=False, **extra),
                        cfg=t_reduced(arch), params=tp)
    treqs = [Request(uid=i, prompt=p, max_new=8)
             for i, p in enumerate(_prompts(jcfg.vocab))]
    teng.run(treqs)
    for jr, tr in zip(jreqs, treqs):
        assert tr.done and tr.error is None and len(tr.generated) == 8
        if tr.generated != jr.generated:
            i = next(k for k, (a, b) in enumerate(zip(tr.generated, jr.generated))
                     if a != b)
            assert _margin_ok(jcfg, jparams, jr.prompt, jr.generated, i, TOL), (
                tr.uid, i, tr.generated, jr.generated)
    if chunked:
        assert teng.stats["chunked_requests"] == sum(n > CHUNK_BUCKETS[-1] for n in LENS)
    if not paged and steps == 1:
        tstats = {k: v for k, v in teng.stats.items() if k not in SKIP_STATS}
        assert tstats == {k: v for k, v in jstats.items() if k not in SKIP_STATS}
    if paged and teng.cfg.mla is not None:
        meta = teng._paged_ops.meta
        assert len(meta["head"]) == len(teng.cfg.head)
        for layer in meta["head"] + meta["blocks"]:
            for name, m in layer.items():
                assert m.kind == ("flat" if name == "len" else "seq"), name


def test_cache_scatter_lands_head_layers():
    """A round's landing (one K6 launch over every leaf) carries the head
    layer's MLA cache as well as the blocks': deepseek's layer 0 decodes
    against what its prefill wrote, not against zeros."""
    _, tp = _weights("deepseek-v2-236b")
    b = t_build(t_reduced("deepseek-v2-236b"), "cpu")
    sub, pool = b.init_caches(2, 32), b.init_caches(3, 32)
    tokens = torch.as_tensor(np.random.default_rng(1).integers(0, 512, (2, 16)),
                             dtype=torch.int32)
    b.prefill_many(tp, {"tokens": tokens}, sub, torch.tensor([16, 7], dtype=torch.int32))
    b.cache_scatter(pool, sub, np.array([1, -1, 0], np.int32))
    for sec in ("head", "blocks"):
        for c, s in zip(pool[sec], sub[sec]):
            ba = 1 if sec == "blocks" else 0
            for name in c:
                got, src = c[name].movedim(ba, 0), s[name].movedim(ba, 0)
                assert torch.equal(got[0], src[1]) and torch.equal(got[2], src[0]), (sec, name)
                fresh = b.init_caches(1, 32)[sec][0][name].movedim(ba, 0)[0]
                assert torch.equal(got[1], fresh), (sec, name)
    assert int(pool["head"][0]["len"][2]) == 16


def test_moe_bucketed_prefill_pad_invariant_under_tight_capacity():
    """tests/test_serve_sched.py:445-470 on the port: with capacity factor
    1.0 a pad token that claimed a capacity slot would change real rows;
    masked out of routing, junk in the pad tail changes nothing - logits
    and every cache leaf bit-identical - and the logits equal JAX's."""
    jcfg = j_reduced("deepseek-v2-236b")
    jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(jcfg.moe, capacity_factor=1.0))
    tcfg = t_reduced("deepseek-v2-236b")
    tcfg = dataclasses.replace(tcfg, moe=dataclasses.replace(tcfg.moe, capacity_factor=1.0))
    jp, tp = _weights("deepseek-v2-236b")
    jm, tm = j_build(jcfg), t_build(tcfg, "cpu")
    rng = np.random.default_rng(2)
    lens = [4, 7]
    Bn, L = 2, 16
    prompts = [rng.integers(0, jcfg.vocab, s).astype(np.int32) for s in lens]
    outs = []
    for fill in (0, 1):
        toks = (np.zeros((Bn, L), np.int32) if fill == 0
                else rng.integers(0, jcfg.vocab, (Bn, L)).astype(np.int32))
        for i, p in enumerate(prompts):
            toks[i, :len(p)] = p
        lg, caches = tm.prefill_many(tp, {"tokens": torch.from_numpy(toks)},
                                     tm.init_caches(Bn, 32),
                                     torch.tensor(lens, dtype=torch.int32))
        outs.append((lg, caches, toks))
    assert torch.equal(outs[0][0], outs[1][0])
    for sec in ("head", "blocks"):
        for a, b in zip(outs[0][1][sec], outs[1][1][sec]):
            for name in a:
                assert torch.equal(a[name], b[name]), (sec, name)
    jl, _ = jm.prefill_many(jp, {"tokens": jnp.asarray(outs[1][2])}, jm.init_caches(Bn, 32, 0),
                            jnp.asarray(lens, jnp.int32))
    np.testing.assert_allclose(outs[1][0].numpy(), np.asarray(jl), rtol=0, atol=1e-5)
