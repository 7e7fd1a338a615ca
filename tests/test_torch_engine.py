"""The port's ServeEngine against repro.serve.ServeEngine on one request
trace: 6 requests, prompts of 3-40 tokens, max_new 8, 2 or 4 slots (so
admissions queue), reduced stablelm-1.6b on the same bridged weights.

fp weights on both sides; and PDQ: the port with quantize_weights=True
(every layer quantized) against the JAX engine serving the
vmap(quantize_param_tree) params with telemetry off (with it on, the
reference leaks a tracer out of its scan; ROADMAP.md Queue 3).  Each with
an fp KV cache and with the int8 one (``int8_kv=True``; the JAX side's
config gets ``quant_kv='dynamic'``).

Greedy streams are identical (at a difference, JAX's top-2 margin for that
token must be below the logits tolerance of tests/test_torch_model.py),
and the scheduler's stats are equal, apart from the JAX-only compile
counters and the wall-clock straggler flags.
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
from repro_torch.serve import Request, ServeConfig, build_engine

torch.set_num_threads(1)

TOL = {"fp": 1e-5, "pdq": 1e-3}
SKIP_STATS = {"prefill_compiles", "chunk_compiles", "decode_compiles",
              "straggler_flags", "prefill_straggler_flags"}
LENS = (3, 40, 17, 9, 33, 25)


@pytest.fixture(scope="module")
def weights():
    jcfg = j_reduced("stablelm-1.6b")
    jp = j_build(jcfg).init(jax.random.PRNGKey(0))
    return jcfg, jp, params_from_numpy(jax.tree.map(np.asarray, jp))


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


@pytest.mark.parametrize("int8_kv", [False, True])
@pytest.mark.parametrize("slots", [2, 4])
@pytest.mark.parametrize("kind", ["fp", "pdq"])
def test_engine_matches_jax_engine(weights, kind, slots, int8_kv):
    jcfg, jp, tp = weights
    if int8_kv:
        jcfg = dataclasses.replace(jcfg, quant_kv="dynamic")
    jparams = jp if kind == "fp" else dict(jp, blocks=jax.vmap(j_quantize)(jp["blocks"]))
    jeng = JServeEngine(jcfg, jparams, slots=slots, max_len=64, telemetry=False)
    jreqs = [JRequest(uid=i, prompt=p, max_new=8) for i, p in enumerate(_prompts())]
    jeng.run(jreqs)

    teng = build_engine(ServeConfig(slots=slots, max_len=64, device="cpu",
                                    quantize_weights=kind == "pdq", int8_kv=int8_kv),
                        cfg=t_reduced("stablelm-1.6b"), params=tp)
    treqs = [Request(uid=i, prompt=p, max_new=8) for i, p in enumerate(_prompts())]
    tops.reset_counts()
    teng.run(treqs)

    for jr, tr in zip(jreqs, treqs):
        assert tr.done and tr.error is None and len(tr.generated) == 8
        if tr.generated != jr.generated:
            i = next(k for k, (a, b) in enumerate(zip(tr.generated, jr.generated))
                     if a != b)
            assert _margin_ok(jcfg, jparams, jr.prompt, jr.generated, i, TOL[kind]), (
                tr.uid, i, tr.generated, jr.generated)
    tstats = {k: v for k, v in teng.stats.items() if k not in SKIP_STATS}
    jstats = {k: v for k, v in jeng.stats.items() if k not in SKIP_STATS}
    assert tstats == jstats
    # every admission round lands its cache leaves with one scatter each:
    # k, v, pos, len, and with int8 KV k_scale and v_scale
    c = {k: v["entries"] for k, v in tops.counts().items()}
    n_pre, n_dec = teng.stats["prefill_batches"], teng.stats["decode_steps"]
    assert c["cache_scatter"] == (6 if int8_kv else 4) * n_pre
    n = teng.cfg.n_layers
    attend = "decode_attend_i8kv_fused" if kind == "pdq" else "decode_attend_i8kv"
    assert c[attend] == (n * n_dec if int8_kv else 0)
    if kind == "pdq":
        assert c["w8a8_swiglu_matmul"] == n * (n_pre + n_dec)
        # decode runs wo's prologue inside the fused attend with int8 KV
        assert c["pdq_prologue"] == n * (3 * n_pre + (2 if int8_kv else 3) * n_dec)


def test_build_engine_needs_cuda_by_default():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_engine(ServeConfig())


@pytest.mark.parametrize("field,value", [
    ("paged", True), ("chunked_prefill", True), ("decode_steps", 4),
    ("pdq_fallback", True), ("spill", True), ("mesh", object()),
    ("batch_prefill", False)])
def test_unported_options_name_their_roadmap_item(weights, field, value):
    cfg = ServeConfig(device="cpu", slots=2, max_len=32, **{field: value})
    with pytest.raises(NotImplementedError, match="ROADMAP.md Queue 1, item"):
        build_engine(cfg, cfg=t_reduced("stablelm-1.6b"), params=weights[2])


def test_temperature_streams_depend_only_on_seed_uid_step(weights):
    """Temperature sampling draws per (seed, uid, step): a request's stream
    is the same whether it runs alone or beside others."""
    tp = weights[2]
    prompts = _prompts()

    def run(uids, slots):
        eng = build_engine(ServeConfig(slots=slots, max_len=64, device="cpu",
                                       temperature=0.8, seed=3),
                           cfg=t_reduced("stablelm-1.6b"), params=tp)
        reqs = [Request(uid=u, prompt=prompts[u], max_new=6) for u in uids]
        eng.run(reqs)
        return {r.uid: r.generated for r in reqs}

    together = run(range(4), 4)
    alone = run([2], 1)
    assert together[2] == alone[2]
    assert len({tuple(v) for v in together.values()}) > 1
