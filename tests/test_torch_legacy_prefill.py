"""The per-request prefill baseline (``ServeConfig(batch_prefill=False)``,
``--legacy-prefill``) against the reference's legacy engine
(``repro.serve.ServeEngine(batch_prefill=False, telemetry=False)``) on
reduced stablelm-1.6b, the same bridged weights, on the CPU: fp and PDQ
weights (the JAX side serves ``vmap(quantize_param_tree)`` blocks, as
``tests/test_torch_engine.py`` does), fp and int8 KV caches.

Greedy streams are identical (at a difference, JAX's top-2 margin for
that token must be below the logits tolerance of
tests/test_torch_model.py, fp 1e-5 / PDQ 1e-3), and the scheduler's stats
are equal, apart from the JAX-only compile counters and the wall-clock
straggler flags.  Each request prefills alone at its exact length and
lands with one K6 launch; two requests of different lengths served back
to back on ONE slot pin that each starts from a fresh cache row (the
port's prefill writes its cache in place).
"""
import dataclasses
import io
from contextlib import redirect_stdout

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
    return jcfg, jp, params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")


def _prompts(lens=LENS):
    rng = np.random.default_rng(0)
    return [rng.integers(0, 512, size=n).astype(np.int32) for n in lens]


def _margin_ok(jcfg, jparams, prompt, generated, i, tol):
    seq = np.concatenate([prompt, np.asarray(generated[:i], np.int32)])[None]
    b = j_build(jcfg)
    logits, _ = b.prefill(jparams, {"tokens": jnp.asarray(seq)},
                          b.init_caches(1, seq.shape[1] + 1))
    top2 = np.sort(np.asarray(logits[0]))[-2:]
    return top2[1] - top2[0] < tol


def _both(weights, kind, int8_kv, slots, lens, max_new=8):
    jcfg, jp, tp = weights
    if int8_kv:
        jcfg = dataclasses.replace(jcfg, quant_kv="dynamic")
    jparams = jp if kind == "fp" else dict(jp, blocks=jax.vmap(j_quantize)(jp["blocks"]))
    jeng = JServeEngine(jcfg, jparams, slots=slots, max_len=64, telemetry=False,
                        batch_prefill=False)
    jreqs = [JRequest(uid=i, prompt=p, max_new=max_new) for i, p in enumerate(_prompts(lens))]
    jeng.run(jreqs)
    teng = build_engine(ServeConfig(slots=slots, max_len=64, device="cpu",
                                    quantize_weights=kind == "pdq", int8_kv=int8_kv,
                                    telemetry=False, batch_prefill=False),
                        cfg=t_reduced("stablelm-1.6b"), params=tp)
    treqs = [Request(uid=i, prompt=p, max_new=max_new) for i, p in enumerate(_prompts(lens))]
    tops.reset_counts()
    teng.run(treqs)
    for jr, tr in zip(jreqs, treqs):
        assert tr.done and tr.error is None and len(tr.generated) == max_new
        if tr.generated != jr.generated:
            i = next(k for k, (a, b) in enumerate(zip(tr.generated, jr.generated)) if a != b)
            assert _margin_ok(jcfg, jparams, jr.prompt, jr.generated, i, TOL[kind]), (
                tr.uid, i, tr.generated, jr.generated)
    tstats = {k: v for k, v in teng.stats.items() if k not in SKIP_STATS}
    jstats = {k: v for k, v in jeng.stats.items() if k not in SKIP_STATS}
    assert tstats == jstats
    return teng, treqs


@pytest.mark.parametrize("int8_kv", [False, True])
@pytest.mark.parametrize("kind", ["fp", "pdq"])
def test_legacy_engine_matches_jax_legacy_engine(weights, kind, int8_kv):
    teng, treqs = _both(weights, kind, int8_kv, slots=2, lens=LENS)
    st = teng.stats
    assert st["prefill_batches"] == st["prefill_requests"] == len(LENS)
    assert st["prefill_padded_tokens"] == st["prefill_tokens"] == sum(LENS)
    # one K6 landing a request; each request's prefill enters K1 three
    # times a layer with PDQ (QKV, wo, gate/up), at its exact length
    c = {k: v["entries"] for k, v in tops.counts().items()}
    assert c["cache_scatter"] == len(LENS)
    if kind == "pdq":
        n, n_dec = teng.cfg.n_layers, st["decode_steps"]
        assert c["pdq_prologue"] == n * (3 * len(LENS) + (2 if int8_kv else 3) * n_dec)


@pytest.mark.parametrize("int8_kv", [False, True])
def test_one_slot_back_to_back_starts_from_a_fresh_row(weights, int8_kv):
    """Two requests of different lengths (the longer first) through ONE
    slot: the second prefills from a fresh cache row, so its stream equals
    the reference's (a kept row would carry the first request's K/V, pos
    and len into it)."""
    _both(weights, "pdq", int8_kv, slots=1, lens=(30, 7), max_new=6)


def test_legacy_prefill_through_the_launcher():
    from repro_torch.launch import serve as launch
    args = ["--reduced", "--device", "cpu", "--int8", "--int8-kv", "--requests", "4",
            "--max-new", "4", "--prompt-len", "20", "--slots", "2", "--no-telemetry"]
    outs = {}
    for tag, extra in (("legacy", ["--legacy-prefill"]), ("bucketed", [])):
        buf = io.StringIO()
        with redirect_stdout(buf):
            launch.main(args + extra)
        outs[tag] = buf.getvalue()
    assert "prefill=legacy" in outs["legacy"] and "prefill=bucketed" in outs["bucketed"]
    streams = {t: [ln for ln in o.splitlines() if ln.strip().startswith("req ")]
               for t, o in outs.items()}
    assert streams["legacy"] and streams["legacy"] == streams["bucketed"]
    for bad in (["--paged"], ["--chunked-prefill"]):
        with pytest.raises(SystemExit, match="bucketed prefill"):
            launch.main(args + ["--legacy-prefill"] + bad)
