"""The port's ServeEngine on the SSD families against
repro.serve.ServeEngine, on the same numpy weights (the reduced mamba2-2.7b
and zamba2-7b at ``n_layers`` 9 of tests/test_torch_families_ssm.py), 2
slots, max_len 64, 6 requests of 3-40 prompt tokens.

Greedy streams equal the JAX engine's (both with ``telemetry=False``): fp
and PDQ weights with slot rows (stats equal too), PDQ at 4 decode steps a
dispatch (streams against JAX's one-step run), PDQ with chunked prefill
(buckets (8, 16): the first chunk through ``prefill_many``, the rest
through ``prefill_chunk``, each continuing from the conv tail and SSD state
the earlier chunks wrote), and zamba2 PDQ paged (page 16) with a pool of 6
pages, small enough that decode growth preempts and spills, against the
JAX paged engine on the same pool: stats equal, the SSD's conv and state
leaves flat slot rows and only the shared occurrence's attention leaves
paged (``len`` flat), ``spills == preemptions`` and no ``spill`` failure.
A stream may part from JAX's only where JAX's top-2 margin is below the
PDQ tolerance (none did here).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import build_model as j_build
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JServeEngine
from repro_torch.serve import Request, ServeConfig, build_engine
from tests.test_torch_families_ssm import ARCHS, TOL, _models

torch.set_num_threads(1)

SKIP_STATS = {"prefill_compiles", "chunk_compiles", "decode_compiles",
              "straggler_flags", "prefill_straggler_flags"}
LENS = (3, 30, 12, 25, 9, 40)
CHUNK_BUCKETS = (8, 16)
_RUNS: dict = {}


def _prompts(vocab):
    rng = np.random.default_rng(0)
    return [rng.integers(0, vocab, size=n).astype(np.int32) for n in LENS]


def _margin_ok(jcfg, jparams, prompt, generated, i, tol):
    """JAX's top-2 logit margin for token i of a stream is below tol."""
    seq = np.concatenate([prompt, np.asarray(generated[:i], np.int32)])[None]
    b = j_build(jcfg)
    logits, _ = b.prefill(jparams, {"tokens": jnp.asarray(seq)},
                          b.init_caches(1, seq.shape[1] + 1))
    top2 = np.sort(np.asarray(logits[0]))[-2:]
    return top2[1] - top2[0] < tol


def _jax_run(arch, kind, extra):
    """(JAX requests, JAX stats) of one reference engine run, once."""
    key = (arch, kind, tuple(sorted(extra.items())))
    if key not in _RUNS:
        jcfg, _, w = _models(arch)
        jeng = JServeEngine(jcfg, w[kind][0], slots=2, max_len=64, telemetry=False,
                            **extra)
        jreqs = [JRequest(uid=i, prompt=p, max_new=MAX_NEW[extra.get("pool_pages")])
                 for i, p in enumerate(_prompts(jcfg.vocab))]
        jeng.run(jreqs)
        _RUNS[key] = (jreqs, dict(jeng.stats))
    return _RUNS[key]


PREEMPT_POOL = 6                 # 5 usable 16-token pages for 2 slots of 64
MAX_NEW = {None: 8, PREEMPT_POOL: 16}
CHUNKED = dict(buckets=CHUNK_BUCKETS, chunked_prefill=True)
PAGED = dict(paged=True, page_size=16, pool_pages=PREEMPT_POOL, spill=True)
ENGINE_CASES = ([(arch, kind, {}, 1) for arch in ARCHS for kind in ("fp", "pdq")]
                + [(arch, "pdq", {}, 4) for arch in ARCHS]
                + [(arch, "pdq", CHUNKED, 1) for arch in ARCHS]
                + [("zamba2-7b", "pdq", PAGED, 1)])


@pytest.mark.parametrize("arch,kind,extra,steps", ENGINE_CASES)
def test_engine_streams_match_jax_engine(arch, kind, extra, steps):
    jcfg, tcfg, w = _models(arch)
    jreqs, jstats = _jax_run(arch, kind, extra)
    teng = build_engine(ServeConfig(slots=2, max_len=64, device="cpu",
                                    quantize_weights=kind == "pdq", decode_steps=steps,
                                    telemetry=False, **extra),
                        cfg=tcfg, params=w["fp"][1])
    treqs = [Request(uid=i, prompt=p, max_new=jr.max_new)
             for i, (p, jr) in enumerate(zip(_prompts(jcfg.vocab), jreqs))]
    teng.run(treqs)
    for jr, tr in zip(jreqs, treqs):
        assert tr.done and tr.error is None and len(tr.generated) == jr.max_new
        if tr.generated != jr.generated:
            i = next(k for k, (a, b) in enumerate(zip(tr.generated, jr.generated))
                     if a != b)
            assert _margin_ok(jcfg, w[kind][0], jr.prompt, jr.generated, i, TOL["pdq"]), (
                tr.uid, i, tr.generated, jr.generated)
    if steps == 1:
        tstats = {k: v for k, v in teng.stats.items() if k not in SKIP_STATS}
        assert tstats == {k: v for k, v in jstats.items() if k not in SKIP_STATS}
    if extra.get("chunked_prefill"):
        assert teng.stats["chunked_requests"] == sum(n > CHUNK_BUCKETS[-1] for n in LENS)
    if extra.get("paged"):
        meta = teng._paged_ops.meta
        for j, kind_ in enumerate(tcfg.pattern):
            for name, m in meta["blocks"][j].items():
                paged_leaf = kind_ == "shared" and name != "len"
                assert m.kind == ("seq" if paged_leaf else "flat"), (kind_, name)
        assert teng.stats["preemptions"] >= 1
        assert teng.stats["spills"] == teng.stats["preemptions"]
        assert not [e for e in teng.failures.events if e["kind"] == "spill"]
