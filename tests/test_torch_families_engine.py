"""The port's ServeEngine on the local/global and llama-style decoders
against repro.serve.ServeEngine: reduced gemma2-2b, gemma3-12b and yi-6b
(tests/test_torch_families.py) with PDQ weights (JAX: ``vmap(
quantize_param_tree)`` over each kind's stack, telemetry off, ROADMAP.md
Queue 3; the port: ``quantize_weights=True``, telemetry off), fp and int8
KV, 2 slots, max_len 64, 6 requests of 3-40 prompt tokens and 8 new ones.
Prompts longer than the 16-position window fill the local layers' ring past
its end in one (unchunked) prefill, and decode crosses the window.

The port runs with slot rows and paged (page 16: the local layers' ring
leaves stay flat rows, ``pos`` of the global layers pages), at 1 and at 4
decode steps a dispatch.  Greedy streams are identical (at a difference,
JAX's top-2 margin for that token must be below the PDQ logits tolerance
of tests/test_torch_model.py); with slot rows and one step a dispatch the
scheduler's stats are equal too (apart from the JAX-only compile counters
and the wall-clock straggler flags).
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
from repro_torch.serve import Request, ServeConfig, build_engine

torch.set_num_threads(1)

TOL = 1e-3                                # tests/test_torch_model.py, PDQ
SKIP_STATS = {"prefill_compiles", "chunk_compiles", "decode_compiles",
              "straggler_flags", "prefill_straggler_flags"}
LENS = (3, 30, 12, 25, 9, 40)
_RUNS: dict = {}


def _prompts(vocab):
    rng = np.random.default_rng(0)
    return [rng.integers(0, vocab, size=n).astype(np.int32) for n in LENS]


def _jax_run(arch, int8_kv):
    """(jcfg, JAX PDQ params, port fp params, JAX requests, JAX stats),
    once per (arch, int8_kv) for the module."""
    key = (arch, int8_kv)
    if key not in _RUNS:
        jcfg = j_reduced(arch)
        if int8_kv:
            jcfg = dataclasses.replace(jcfg, quant_kv="dynamic")
        jp = j_build(jcfg).init(jax.random.PRNGKey(0))
        tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
        jparams = dict(jp, blocks=jax.vmap(j_quantize)(jp["blocks"]))
        jeng = JServeEngine(jcfg, jparams, slots=2, max_len=64, telemetry=False)
        jreqs = [JRequest(uid=i, prompt=p, max_new=8)
                 for i, p in enumerate(_prompts(jcfg.vocab))]
        jeng.run(jreqs)
        _RUNS[key] = (jcfg, jparams, tp, jreqs, dict(jeng.stats))
    return _RUNS[key]


def _margin_ok(jcfg, jparams, prompt, generated, i, tol):
    """JAX's top-2 logit margin for token i of a stream is below tol."""
    seq = np.concatenate([prompt, np.asarray(generated[:i], np.int32)])[None]
    b = j_build(jcfg)
    logits, _ = b.prefill(jparams, {"tokens": jnp.asarray(seq)},
                          b.init_caches(1, seq.shape[1] + 1))
    top2 = np.sort(np.asarray(logits[0]))[-2:]
    return top2[1] - top2[0] < tol


@pytest.mark.parametrize("steps", [1, 4])
@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("int8_kv", [False, True])
@pytest.mark.parametrize("arch", ["gemma2-2b", "gemma3-12b", "yi-6b"])
def test_engine_streams_match_jax_engine(arch, int8_kv, paged, steps):
    jcfg, jparams, tp, jreqs, jstats = _jax_run(arch, int8_kv)
    extra = dict(paged=True, page_size=16) if paged else {}
    teng = build_engine(ServeConfig(slots=2, max_len=64, device="cpu",
                                    quantize_weights=True, int8_kv=int8_kv,
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
    if not paged and steps == 1:
        tstats = {k: v for k, v in teng.stats.items() if k not in SKIP_STATS}
        assert tstats == {k: v for k, v in jstats.items() if k not in SKIP_STATS}
    if paged:
        # the ring leaves are flat slot rows beside the paged global leaves
        meta = teng._paged_ops.meta["blocks"]
        for kind, m in zip(teng.cfg.pattern, meta):
            assert m["pos"].kind == ("flat" if kind == "local" else "seq"), kind
