"""The port's prefill-extras families against the JAX package's, on the
same numpy weights and extras (everything on the CPU): reduced
phi-3-vision-4.2b (2 layers, 8 stub patches prepended to the text) and
reduced seamless-m4t-medium (2 encoder + 2 decoder layers, 8 stub frames),
each d_model 64, float32 (``reduced_config``).

- The configs agree with the reference's field for field, the new
  ``enc_layers`` and ``frontend_tokens`` included, and ``reduced`` cuts
  them as the reference's does (at most 2 and 8).
- ``models/frontend.py``'s stubs: shape, dtype, device and scale (0.02 x
  N(0, 1)), and ``stub_extras`` per family; the draws are torch's, so the
  tests below hand both frameworks the same numpy extras instead.
- ``prefill_many`` over ragged rows and a dummy row (whose patches are
  masked too), then 6 greedy decode steps teacher-forced on JAX's tokens:
  logits and every cache leaf (the cross K/V included) within
  tests/test_torch_model.py's 1e-5 (fp) and 1e-3 (PDQ records, against
  ``jax.vmap(quantize_param_tree)`` over ``blocks`` and ``enc_blocks``),
  integer leaves exactly; the same for one unpadded ``prefill``.
- ``prefill_chunk`` refuses both families, as the reference's does.

The engines against the JAX engine: tests/test_torch_families_extras_engine.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get
from repro.configs import reduced_config as j_reduced
from repro.models import build_model as j_build
from repro.models.linops import quantize_param_tree as j_quantize
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config as t_get
from repro_torch.configs import reduced_config as t_reduced
from repro_torch.models import build_model as t_build
from repro_torch.models import frontend
from repro_torch.models.linops import quantize_param_tree as t_quantize

torch.set_num_threads(1)

ARCHS = ("phi-3-vision-4.2b", "seamless-m4t-medium")
TOL = {"fp": 1e-5, "pdq": 1e-3}          # tests/test_torch_model.py
MEM_LEN = 8                              # the engine's frames (serve/engine.py)
_MODELS: dict = {}


def _models(arch):
    """(jcfg, tcfg, {'fp': (jp, tp), 'pdq': (jq, tq)}) of the reduced
    ``arch`` on one set of JAX weights, once per module."""
    if arch not in _MODELS:
        jcfg, tcfg = j_reduced(arch), t_reduced(arch)
        jp = j_build(jcfg).init(jax.random.PRNGKey(0))
        tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
        jq = dict(j_quantize(jp), blocks=jax.vmap(j_quantize)(jp["blocks"]))
        if "enc_blocks" in jp:
            jq["enc_blocks"] = jax.vmap(j_quantize)(jp["enc_blocks"])
        _MODELS[arch] = (jcfg, tcfg, {"fp": (jp, tp), "pdq": (jq, t_quantize(tp))})
    return _MODELS[arch]


def extras_of(cfg, batch, seed=5):
    """The family's extras as seeded numpy arrays: patches or frames."""
    rng = np.random.default_rng(seed)
    if cfg.frontend == "vision":
        return {"patches": (0.01 * rng.standard_normal(
            (batch, cfg.frontend_tokens, cfg.d_model))).astype(np.float32)}
    return {"frames": (0.01 * rng.standard_normal(
        (batch, MEM_LEN, cfg.d_model))).astype(np.float32)}


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_agree_with_the_reference(arch):
    for j, t in ((j_get(arch), t_get(arch)), (j_reduced(arch), t_reduced(arch))):
        for f in ("n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff", "vocab", "hd",
                  "n_blocks", "head", "pattern", "tail", "window", "rope_theta",
                  "norm_eps", "embed_scale", "dtype", "family", "frontend",
                  "enc_layers", "frontend_tokens", "quant_kv"):
            assert getattr(j, f) == getattr(t, f), (arch, f)
    assert t_reduced(arch).enc_layers == min(t_get(arch).enc_layers, 2)
    assert t_reduced(arch).frontend_tokens == min(t_get(arch).frontend_tokens, 8)


@pytest.mark.parametrize("fn,n", [(frontend.stub_patch_embeddings, 1024),
                                  (frontend.stub_frame_embeddings, 8)])
def test_frontend_stubs(fn, n):
    g = torch.Generator()
    g.manual_seed(0)
    x = fn(g, 2, n, 256)
    assert tuple(x.shape) == (2, n, 256) and x.dtype == torch.bfloat16
    assert x.device.type == "cpu"
    assert 0.018 < float(x.float().std()) < 0.022
    g.manual_seed(0)
    assert torch.equal(fn(g, 2, n, 256, torch.float32).to(torch.bfloat16), x)


@pytest.mark.parametrize("arch,key,n", [("phi-3-vision-4.2b", "patches", 1024),
                                        ("seamless-m4t-medium", "frames", 8),
                                        ("stablelm-1.6b", None, 0)])
def test_stub_extras_of_a_config(arch, key, n):
    """``stub_extras``: the config's patches or the engine's frames, in the
    model dtype; None for a text-only config."""
    cfg = t_get(arch)
    ex = frontend.stub_extras(cfg, torch.Generator().manual_seed(0), batch=2)
    if key is None:
        assert ex is None
        return
    assert list(ex) == [key] and tuple(ex[key].shape) == (2, n, cfg.d_model)
    assert ex[key].dtype == torch.bfloat16


def _leaves(caches):
    return [(f"kind {j} {k}", d[k]) for j, d in enumerate(caches["blocks"])
            for k in sorted(d)]


def _caches_close(jc, tc, kind):
    jleaves = jax.tree.leaves({"blocks": jc["blocks"]})
    tleaves = _leaves(tc)
    assert len(jleaves) == len(tleaves)
    for a, (name, b) in zip(jleaves, tleaves):
        a, b = np.asarray(a), b.numpy()
        assert a.shape == b.shape and a.dtype == b.dtype, name
        if a.dtype.kind in "iu":
            np.testing.assert_array_equal(b, a, err_msg=name)
        else:
            np.testing.assert_allclose(b, a, rtol=0, atol=TOL[kind], err_msg=name)


@pytest.mark.parametrize("kind", ["fp", "pdq"])
@pytest.mark.parametrize("arch", ARCHS)
def test_model_matches_the_reference(arch, kind):
    """A bucketed prefill with the extras (ragged rows, a dummy row) then
    greedy decode steps teacher-forced on JAX's tokens: logits and every
    cache leaf."""
    jcfg, tcfg, w = _models(arch)
    jp, tp = w[kind]
    jb, tb = j_build(jcfg), t_build(tcfg, "cpu")
    P = tcfg.frontend_tokens if tcfg.frontend == "vision" else 0
    mem = MEM_LEN if tcfg.family == "encdec" else 0
    rng = np.random.default_rng(1)
    B, L = 3, 24
    toks = rng.integers(0, jcfg.vocab, size=(B, L)).astype(np.int32)
    sl = np.array([24, 9, 0], np.int32)
    ex = extras_of(tcfg, B)
    jc, tc = jb.init_caches(B, 64, mem), tb.init_caches(B, 64, mem)
    jl, jc = jb.prefill_many(jp, {"tokens": jnp.asarray(toks),
                                  **{k: jnp.asarray(v) for k, v in ex.items()}},
                             jc, jnp.asarray(sl))
    tl, tc = tb.prefill_many(tp, {"tokens": torch.from_numpy(toks),
                                  **{k: torch.from_numpy(v) for k, v in ex.items()}},
                             tc, torch.from_numpy(sl))
    for step in range(7):
        np.testing.assert_allclose(tl.numpy()[:2], np.asarray(jl)[:2], rtol=0,
                                   atol=TOL[kind], err_msg=f"step {step}")
        nxt = np.asarray(jl).argmax(-1).astype(np.int32)[:, None]
        if step == 6:
            break
        pos = (sl[:, None] + P + step).astype(np.int32)
        jl, jc = jb.decode_step(jp, jc, jnp.asarray(nxt), jnp.asarray(pos))
        tl, tc = tb.decode_step(tp, tc, torch.from_numpy(nxt), torch.from_numpy(pos))
    _caches_close(jc, tc, kind)


@pytest.mark.parametrize("arch", ARCHS)
def test_unpadded_prefill_matches_the_reference(arch):
    jcfg, tcfg, w = _models(arch)
    jp, tp = w["fp"]
    jb, tb = j_build(jcfg), t_build(tcfg, "cpu")
    mem = MEM_LEN if tcfg.family == "encdec" else 0
    toks = np.random.default_rng(2).integers(0, jcfg.vocab, size=(2, 11)).astype(np.int32)
    ex = extras_of(tcfg, 2, seed=6)
    jl, jc = jb.prefill(jp, {"tokens": jnp.asarray(toks),
                             **{k: jnp.asarray(v) for k, v in ex.items()}},
                        jb.init_caches(2, 32, mem))
    tl, tc = tb.prefill(tp, {"tokens": torch.from_numpy(toks),
                             **{k: torch.from_numpy(v) for k, v in ex.items()}},
                        tb.init_caches(2, 32, mem))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=TOL["fp"])
    _caches_close(jc, tc, "fp")


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_chunk_refuses_the_extras_families(arch):
    jcfg, tcfg, w = _models(arch)
    tb = t_build(tcfg, "cpu")
    one = torch.ones((1,), dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="text-only"):
        tb.prefill_chunk(w["fp"][1], {"tokens": torch.zeros((1, 4), dtype=torch.int32)},
                         tb.init_caches(1, 32), one, one)
    with pytest.raises(NotImplementedError, match="text-only"):
        jb = j_build(jcfg)
        jb.prefill_chunk(w["fp"][0], {"tokens": jnp.zeros((1, 4), jnp.int32)},
                         jb.init_caches(1, 32), jnp.ones((1,), jnp.int32),
                         jnp.ones((1,), jnp.int32))


def test_encdec_prefill_needs_matching_frames():
    """The cross leaves hold ``mem_len`` rows: frames of another length
    are refused before anything lands (the reference would hand back a
    cache of another shape)."""
    _, tcfg, w = _models("seamless-m4t-medium")
    tb = t_build(tcfg, "cpu")
    batch = {"tokens": torch.zeros((1, 4), dtype=torch.int32),
             "frames": torch.zeros((1, 5, tcfg.d_model))}
    with pytest.raises(ValueError, match="mem_len"):
        tb.prefill(w["fp"][1], batch, tb.init_caches(1, 32, MEM_LEN))
    with pytest.raises(ValueError, match="needs frames"):
        tb.prefill(w["fp"][1], {"tokens": batch["tokens"]}, tb.init_caches(1, 32, MEM_LEN))
