"""The port's model (repro_torch.models.build_model) against the JAX
package's on the same weights: reduced stablelm-1.6b (2 layers, d_model
64, 4 heads / 2 kv heads, d_ff 128, vocab 512, float32), weights from
``build_model(cfg).init(PRNGKey(0))`` bridged through numpy.

Both fp params and PDQ params run (JAX: ``vmap(quantize_param_tree)`` over
the stacked blocks; port: ``quantize_param_tree``, every layer).

Tolerances on float32 logits (|logits| < 1 here; the measured differences
are below 5e-7): fp 1e-5 absolute, for the matmul summation order; PDQ
1e-3 absolute, because an int8 code can flip at a .5 tie when an upstream
activation moves by an ulp, which moves a projection output by one step
of its grid.  Greedy tokens are identical, or JAX's top-2 margin at the
differing step is below the logits tolerance.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as j_reduced
from repro.models import build_model as j_build
from repro.models.linops import quantize_param_tree as j_quantize
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import reduced_config as t_reduced
from repro_torch.kernels import ops as tops
from repro_torch.models import build_model as t_build
from repro_torch.models.linops import quantize_param_tree as t_quantize

torch.set_num_threads(1)

TOL = {"fp": 1e-5, "pdq": 1e-3}


@pytest.fixture(scope="module")
def models():
    jcfg, tcfg = j_reduced("stablelm-1.6b"), t_reduced("stablelm-1.6b")
    jb, tb = j_build(jcfg), t_build(tcfg, "cpu")
    jp = jb.init(jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return {
        "cfg": (jcfg, tcfg), "bundle": (jb, tb),
        "fp": (jp, tp),
        "pdq": (dict(jp, blocks=jax.vmap(j_quantize)(jp["blocks"])), t_quantize(tp)),
    }


def test_reduced_configs_agree():
    jcfg, tcfg = j_reduced("stablelm-1.6b"), t_reduced("stablelm-1.6b")
    for f in ("n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff", "vocab",
              "hd", "n_blocks", "pattern", "rope_theta", "norm_eps", "dtype"):
        assert getattr(jcfg, f) == getattr(tcfg, f), f


def _check_step(jl, tl, tol, what):
    jl, tl = np.asarray(jl), tl.numpy()
    assert np.all(np.isfinite(tl))
    np.testing.assert_allclose(tl, jl, rtol=0, atol=tol, err_msg=what)
    for b in range(jl.shape[0]):
        if int(np.argmax(tl[b])) != int(np.argmax(jl[b])):
            top2 = np.sort(jl[b])[-2:]
            assert top2[1] - top2[0] < tol, (what, b, top2)


@pytest.mark.parametrize("kind", ["fp", "pdq"])
def test_prefill_many_and_decode_match_jax(models, kind):
    """Ragged prompts in one bucket through prefill_many, then 16 greedy
    decode steps teacher-forced on JAX's tokens; the caches' positions and
    lengths are equal, the logits within the tolerance."""
    (jb, tb), (jp, tp) = models["bundle"], models[kind]
    tol = TOL[kind]
    B, L, max_len = 3, 16, 40
    seq_lens = np.array([16, 9, 4], np.int32)
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, 512, (B, L)).astype(np.int32)
    tokens[np.arange(L)[None, :] >= seq_lens[:, None]] = 0
    jl, jc = jb.prefill_many(jp, {"tokens": jnp.asarray(tokens)},
                             jb.init_caches(B, max_len), jnp.asarray(seq_lens))
    tl, tc = tb.prefill_many(tp, {"tokens": torch.from_numpy(tokens)},
                             tb.init_caches(B, max_len), torch.from_numpy(seq_lens))
    _check_step(jl, tl, tol, "prefill")
    for leaf in ("pos", "len"):
        np.testing.assert_array_equal(tc["blocks"][0][leaf].numpy(),
                                      np.asarray(jc["blocks"][0][leaf]))
    np.testing.assert_allclose(tc["blocks"][0]["k"].numpy(),
                               np.asarray(jc["blocks"][0]["k"]), atol=tol)
    pos = seq_lens.copy()
    jstep = jax.jit(jb.decode_step)
    for step in range(16):
        tok = np.array(jnp.argmax(jl, -1), np.int32)[:, None]
        p = pos[:, None].astype(np.int32)
        jl, jc = jstep(jp, jc, jnp.asarray(tok), jnp.asarray(p))
        tl, tc = tb.decode_step(tp, tc, torch.from_numpy(tok), torch.from_numpy(p))
        _check_step(jl, tl, tol, f"decode step {step}")
        pos += 1


@pytest.mark.parametrize("kind", ["fp", "pdq"])
def test_greedy_continuation_matches_jax(models, kind):
    """A 16-token greedy continuation of one prompt, each side feeding its
    own tokens back: identical streams (or, at the first difference, JAX's
    top-2 margin below the logits tolerance)."""
    (jb, tb), (jp, tp) = models["bundle"], models[kind]
    tol = TOL[kind]
    prompt = np.random.default_rng(1).integers(0, 512, (1, 11)).astype(np.int32)
    L = prompt.shape[1]
    one = np.array([L], np.int32)
    jl, jc = jb.prefill_many(jp, {"tokens": jnp.asarray(prompt)},
                             jb.init_caches(1, 32), jnp.asarray(one))
    tl, tc = tb.prefill_many(tp, {"tokens": torch.from_numpy(prompt)},
                             tb.init_caches(1, 32), torch.from_numpy(one))
    jstep = jax.jit(jb.decode_step)
    for i in range(16):
        jt, tt = int(jnp.argmax(jl[0])), int(tl[0].argmax())
        if jt != tt:
            top2 = np.sort(np.asarray(jl[0]))[-2:]
            assert top2[1] - top2[0] < tol, (i, jt, tt, top2)
            return
        p = np.array([[L + i]], np.int32)
        jl, jc = jstep(jp, jc, jnp.asarray([[jt]], jnp.int32), jnp.asarray(p))
        tl, tc = tb.decode_step(tp, tc, torch.tensor([[tt]], dtype=torch.int32),
                                torch.from_numpy(p))


@pytest.mark.parametrize("kind", ["fp", "pdq"])
def test_unpadded_prefill_matches_jax(models, kind):
    (jb, tb), (jp, tp) = models["bundle"], models[kind]
    tokens = np.random.default_rng(3).integers(0, 512, (2, 7)).astype(np.int32)
    jl, jc = jb.prefill(jp, {"tokens": jnp.asarray(tokens)}, jb.init_caches(2, 16))
    tl, tc = tb.prefill(tp, {"tokens": torch.from_numpy(tokens)}, tb.init_caches(2, 16))
    _check_step(jl, tl, TOL[kind], "prefill")
    np.testing.assert_array_equal(tc["blocks"][0]["len"].numpy(),
                                  np.asarray(jc["blocks"][0]["len"]))


def test_op_counts_per_decode_step_and_admission(models):
    """7 kernel-op entries per layer per decode step (prologue 3, W8A8 3,
    SwiGLU 1) and 1 cache_scatter entry per landing (its 4 leaves k, v,
    pos, len in one launch)."""
    tcfg = models["cfg"][1]
    tb, tp = models["bundle"][1], models["pdq"][1]
    caches = tb.init_caches(4, 16)
    tops.reset_counts()
    tb.decode_step(tp, caches, torch.zeros((4, 1), dtype=torch.int32),
                   torch.zeros((4, 1), dtype=torch.int32))
    n = tcfg.n_layers
    c = {k: v["entries"] for k, v in tops.counts().items()}
    assert c == {"pdq_prologue": 3 * n, "w8a8_matmul": 3 * n,
                 "w8a8_swiglu_matmul": n, "decode_attend_i8kv": 0,
                 "decode_attend_i8kv_fused": 0, "cache_scatter": 0,
                 "cache_scatter_pages": 0, "act_stats": 0, "quantize": 0,
                 "dequantize": 0, "fp_dequant": 0}
    tops.reset_counts()
    tb.cache_scatter(caches, tb.init_caches(4, 16), np.array([1, -1, 0, -1], np.int32))
    assert tops.counts()["cache_scatter"]["entries"] == 1


def test_cache_scatter_lands_rows_like_jax(models):
    jb, tb = models["bundle"]
    rng = np.random.default_rng(2)
    pool = jax.tree.map(lambda a: jnp.asarray(rng.integers(-5, 5, a.shape), a.dtype),
                        jb.init_caches(4, 8))
    sub = jax.tree.map(lambda a: jnp.asarray(rng.integers(-5, 5, a.shape), a.dtype),
                       jb.init_caches(4, 8))
    src_map = np.array([2, -1, 0, -1], np.int32)
    want = jb.cache_scatter(pool, sub, jnp.asarray(src_map))
    to_t = lambda c: {"head": (), "tail": (), "blocks": tuple(    # noqa: E731
        {k: torch.from_numpy(np.array(v)) for k, v in blk.items()} for blk in c["blocks"])}
    got = tb.cache_scatter(to_t(pool), to_t(sub), src_map)
    for k, v in got["blocks"][0].items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(want["blocks"][0][k]), err_msg=k)


def test_build_model_needs_cuda_unless_cpu_is_asked():
    cfg = t_reduced("stablelm-1.6b")
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        t_build(cfg)
    assert t_build(cfg, "cpu").device.type == "cpu"
