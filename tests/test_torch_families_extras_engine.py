"""The port's ServeEngine on the prefill-extras families against
repro.serve.ServeEngine, on the same numpy weights and extras (the reduced
phi-3-vision-4.2b and seamless-m4t-medium of
tests/test_torch_families_extras.py), 2 slots, max_len 64, 6 requests of
3-40 prompt tokens, 8 new tokens each, one run's extras shared by every
request (8 patches or 8 frames, seeded numpy).

Greedy streams equal the JAX engine's (both with ``telemetry=False``): fp
and PDQ weights with slot rows, PDQ paged (page 16; the cross K/V leaves
flat slot rows beside the pages), each with stats equal too, and PDQ at 4
decode steps a dispatch, slot rows and paged (streams against JAX's
one-step run).  A stream may part from JAX's only where JAX's top-2 margin
is below the PDQ tolerance (none did here).  With extras prefix sharing is
off (``prefix_hits == 0`` though two prompts share 16 tokens), and a prompt
past the largest bucket with ``chunked_prefill=True`` and extras is
refused at ``run`` as the reference refuses it.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import build_model as j_build
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JServeEngine
from repro_torch.serve import Request, ServeConfig, build_engine
from tests.test_torch_families_extras import ARCHS, TOL, _models, extras_of

torch.set_num_threads(1)

SKIP_STATS = {"prefill_compiles", "chunk_compiles", "decode_compiles",
              "straggler_flags", "prefill_straggler_flags"}
LENS = (3, 30, 12, 25, 9, 40)
MAX_NEW = 8
PAGED = dict(paged=True, page_size=16)
_RUNS: dict = {}


def _prompts(vocab):
    """LENS prompts; the 25- and 40-token ones begin with the same 16
    tokens (a full page each, which a text-only run would share)."""
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, vocab, size=n).astype(np.int32) for n in LENS]
    prompts[3][:16] = prompts[5][:16]
    return prompts


def _extras(cfg):
    return extras_of(cfg, 1, seed=3)


def _margin_ok(jcfg, jparams, prompt, generated, i, tol, extras):
    """JAX's top-2 logit margin for token i of a stream is below tol."""
    seq = np.concatenate([prompt, np.asarray(generated[:i], np.int32)])[None]
    b = j_build(jcfg)
    mem = 8 if jcfg.family == "encdec" else 0
    logits, _ = b.prefill(jparams, {"tokens": jnp.asarray(seq),
                                    **{k: jnp.asarray(v) for k, v in extras.items()}},
                          b.init_caches(1, seq.shape[1] + 1 + jcfg.frontend_tokens, mem))
    top2 = np.sort(np.asarray(logits[0]))[-2:]
    return top2[1] - top2[0] < tol


def _jax_run(arch, kind, paged):
    """(JAX requests, JAX stats) of one reference engine run, once."""
    key = (arch, kind, paged)
    if key not in _RUNS:
        jcfg, _, w = _models(arch)
        jeng = JServeEngine(jcfg, w[kind][0], slots=2, max_len=64, telemetry=False,
                            **(PAGED if paged else {}))
        jreqs = [JRequest(uid=i, prompt=p, max_new=MAX_NEW)
                 for i, p in enumerate(_prompts(jcfg.vocab))]
        jeng.run(jreqs, extras=_extras(jcfg))
        _RUNS[key] = (jreqs, dict(jeng.stats))
    return _RUNS[key]


ENGINE_CASES = ([(arch, kind, False, 1) for arch in ARCHS for kind in ("fp", "pdq")]
                + [(arch, "pdq", True, 1) for arch in ARCHS]
                + [(arch, "pdq", paged, 4) for arch in ARCHS for paged in (False, True)])


@pytest.mark.parametrize("arch,kind,paged,steps", ENGINE_CASES)
def test_engine_streams_match_jax_engine(arch, kind, paged, steps):
    jcfg, tcfg, w = _models(arch)
    jreqs, jstats = _jax_run(arch, kind, paged and steps == 1)
    teng = build_engine(ServeConfig(slots=2, max_len=64, device="cpu",
                                    quantize_weights=kind == "pdq", decode_steps=steps,
                                    telemetry=False, **(PAGED if paged else {})),
                        cfg=tcfg, params=w["fp"][1])
    treqs = [Request(uid=i, prompt=p, max_new=MAX_NEW)
             for i, p in enumerate(_prompts(jcfg.vocab))]
    teng.run(treqs, extras=_extras(tcfg))
    for jr, tr in zip(jreqs, treqs):
        assert tr.done and tr.error is None and len(tr.generated) == MAX_NEW
        if tr.generated != jr.generated:
            i = next(k for k, (a, b) in enumerate(zip(tr.generated, jr.generated))
                     if a != b)
            assert _margin_ok(jcfg, w[kind][0], jr.prompt, jr.generated, i, TOL["pdq"],
                              _extras(jcfg)), (tr.uid, i, tr.generated, jr.generated)
    if steps == 1:
        tstats = {k: v for k, v in teng.stats.items() if k not in SKIP_STATS}
        assert tstats == {k: v for k, v in jstats.items() if k not in SKIP_STATS}
    if paged:
        meta = teng._paged_ops.meta["blocks"][0]
        for name in ("cross_k", "cross_v"):
            assert (name in meta) == (tcfg.family == "encdec")
            assert name not in meta or meta[name].kind == "flat"
        assert teng.stats["prefix_hits"] == 0
    assert teng.patch_tokens == (tcfg.frontend_tokens if tcfg.frontend == "vision" else 0)
    assert teng.mem_len == (8 if tcfg.family == "encdec" else 0)


@pytest.mark.parametrize("arch", ARCHS)
def test_chunked_prefill_with_extras_is_refused(arch):
    """A prompt longer than the largest bucket would be chunked, and
    chunked prefill is text-only: ``run`` refuses it with extras, as the
    reference's does, before anything is admitted."""
    jcfg, tcfg, w = _models(arch)
    prompt = np.arange(40, dtype=np.int32) % jcfg.vocab
    jeng = JServeEngine(jcfg, w["fp"][0], slots=2, max_len=64, telemetry=False,
                        buckets=(8, 16), chunked_prefill=True)
    with pytest.raises(NotImplementedError, match="text-only") as jerr:
        jeng.run([JRequest(uid=0, prompt=prompt, max_new=4)], extras=_extras(jcfg))
    teng = build_engine(ServeConfig(slots=2, max_len=64, device="cpu", telemetry=False,
                                    buckets=(8, 16), chunked_prefill=True),
                        cfg=tcfg, params=w["fp"][1])
    with pytest.raises(NotImplementedError, match="text-only") as terr:
        teng.run([Request(uid=0, prompt=prompt, max_new=4)], extras=_extras(tcfg))
    assert str(terr.value) == str(jerr.value)
    assert teng.stats["prefill_batches"] == 0


def test_prefix_sharing_is_off_with_patches():
    """Patches shift every position and a run's extras change cache content:
    a vision engine turns prefix sharing off (``patch_tokens > 0``), as the
    reference's does, so the shared 16-token page of two prompts is not
    shared even when prefix sharing is asked for."""
    jcfg, tcfg, w = _models("phi-3-vision-4.2b")
    teng = build_engine(ServeConfig(slots=2, max_len=64, device="cpu", telemetry=False,
                                    prefix_sharing=True, **PAGED),
                        cfg=tcfg, params=w["fp"][1])
    assert teng.prefix_sharing is False
    treqs = [Request(uid=i, prompt=p, max_new=2)
             for i, p in enumerate(_prompts(jcfg.vocab))]
    teng.run(treqs, extras=_extras(tcfg))
    assert all(r.done and r.error is None for r in treqs)
    assert teng.stats["prefix_hits"] == 0
