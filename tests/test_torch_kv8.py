"""The port's int8 KV cache against the JAX package's, on the same numpy
inputs and weights (everything on the CPU: the JAX side takes its jnp
oracles there, the port its plain versions).

- ``ops.decode_attend_i8kv``, plain and with wo's fused prologue (pro_dtype
  float32 and bfloat16), ragged lengths, Sp not a multiple of 256.  ``o``
  within 1e-5 (summation order); the prologue as the reference's own test
  (tests/test_kernels.py:495-502): s_x rtol 1e-5, s1/s2 rtol = atol = 1e-4,
  codes within 1.
- ``_quant_kv_token`` and the quantized ``_cache_write`` at prefill (with
  the right-pad clamp) and at decode: int8 codes, scales, ``pos`` and
  ``len`` exactly equal.  This pins torch's indexing rule for
  ``cache[bidx, :, slots]`` (advanced dims first, as numpy and jnp).
- reduced stablelm-1.6b with ``quant_kv='dynamic'``, fp and PDQ weights:
  prefill_many + decode logits within the tolerances of
  tests/test_torch_model.py; with an attention softcap, where decode
  attends the dequantized cache without the attend kernels.
- a reused slot never attends its previous occupant (the reference's
  tests/test_serve_sched.py:255 case), and the decode step's op entries.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as j_reduced
from repro.kernels import ops as jops
from repro.models import attention as jatt
from repro.models import build_model as j_build
from repro.models.linops import quantize_param_tree as j_quantize
from repro_torch.bridge import _tensor, params_from_numpy
from repro_torch.configs import reduced_config as t_reduced
from repro_torch.kernels import ops as tops
from repro_torch.models import attention as tatt
from repro_torch.models import build_model as t_build
from repro_torch.models.linops import quantize_param_tree as t_quantize
from repro_torch.serve import Request, ServeConfig, build_engine

torch.set_num_threads(1)

TOL = {"fp": 1e-5, "pdq": 1e-3}          # tests/test_torch_model.py


def _t(a):
    return _tensor(np.asarray(a), "cpu")


def _attend_inputs(B, Hkv, G, Dh, S, lens, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Hkv * G, Dh)).astype(np.float32),
            rng.integers(-127, 128, (B, Hkv, S, Dh)).astype(np.int8),
            rng.integers(-127, 128, (B, Hkv, S, Dh)).astype(np.int8),
            rng.uniform(0.01, 0.05, (B, Hkv, S)).astype(np.float32),
            rng.uniform(0.01, 0.05, (B, Hkv, S)).astype(np.float32),
            np.asarray(lens, np.int32))


@pytest.mark.parametrize("S,lens", [(200, [200, 57, 1, 129]), (384, [129, 384, 255, 2])])
@pytest.mark.parametrize("form", ["plain", "fused_f32", "fused_bf16"])
def test_decode_attend_matches_jax(S, lens, form):
    args = _attend_inputs(4, 2, 2, 64, S, lens)
    if form == "plain":
        jo = jops.decode_attend_i8kv(*map(jnp.asarray, args))
        to = tops.decode_attend_i8kv(*map(_t, args))
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=0, atol=1e-5)
        return
    jdt, tdt = {"fused_f32": (jnp.float32, torch.float32),
                "fused_bf16": (jnp.bfloat16, torch.bfloat16)}[form]
    jout = jops.decode_attend_i8kv(*map(jnp.asarray, args), wo_prologue=True,
                                   pro_dtype=jdt)
    tout = tops.decode_attend_i8kv(*map(_t, args), wo_prologue=True, pro_dtype=tdt)
    jo, jq, jsx, js1, js2 = (np.asarray(a) for a in jout)
    to, tq, tsx, ts1, ts2 = (a.numpy() for a in tout)
    assert tq.shape == (4, 2 * 2 * 64) and tq.dtype == np.int8
    assert all(a.shape == (4, 1) and a.dtype == np.float32 for a in (tsx, ts1, ts2))
    np.testing.assert_allclose(to, jo, rtol=0, atol=1e-5)
    np.testing.assert_allclose(tsx, jsx, rtol=1e-5)
    np.testing.assert_allclose(ts1, js1, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(ts2, js2, rtol=1e-4, atol=1e-4)
    assert np.abs(tq.astype(np.int32) - jq.astype(np.int32)).max() <= 1


def test_length_zero_row_is_nan_like_jax():
    """A slot that was never filled: the softmax over an all -inf row is
    NaN in the reference's plain path, and the port's plain version keeps
    it so (the kernels write 0 there; the engine never reads such rows)."""
    args = _attend_inputs(2, 2, 2, 64, 128, [0, 5])
    jo = np.asarray(jops.decode_attend_i8kv(*map(jnp.asarray, args)))
    to = tops.decode_attend_i8kv(*map(_t, args)).numpy()
    assert np.isnan(jo[0]).all() and np.isnan(to[0]).all()
    np.testing.assert_allclose(to[1], jo[1], rtol=0, atol=1e-5)


def _kv(B, S, Hkv, Dh, seed):
    rng = np.random.default_rng(seed)
    # scaled so that many values land on .5 ties of their code grid
    return [(3 * rng.standard_normal((B, S, Hkv, Dh))).astype(np.float32)
            for _ in range(2)]


def test_quant_kv_token_matches_jax_exactly():
    k, v = _kv(3, 5, 2, 16, 0)
    k[0, 0, 0] = 0.0                                      # amax below the 1e-6 floor
    j = jatt._quant_kv_token(jnp.asarray(k), jnp.asarray(v))
    t = tatt._quant_kv_token(_t(k), _t(v))
    for a, b in zip(j, t):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


@pytest.mark.parametrize("mode", ["prefill", "decode"])
def test_int8_cache_write_matches_jax_exactly(mode):
    """Prefill of right-padded rows (pad entries clamped onto the last real
    token) into a fresh int8 cache, or one decode token into a filled one:
    every leaf equal."""
    dims_kw = dict(d_model=64, n_heads=4, n_kv_heads=2, head_dim=16, quant_kv="dynamic")
    B, max_len, L = 3, 40, 12
    jc = jatt.init_cache(jatt.AttnDims(**dims_kw), B, max_len, jnp.float32)
    tc = tatt.init_cache(tatt.AttnDims(**dims_kw), B, max_len, torch.float32, "cpu")
    assert tuple(tc["k"].shape) == (B, 2, 128, 16) and tuple(tc["k_scale"].shape) == (B, 2, 128)
    assert bool((tc["k_scale"] == 1).all()) and tc["k"].dtype == torch.int8
    seq_lens = np.array([12, 7, 1], np.int32)
    k, v = _kv(B, L, 2, 16, 1)
    pos = np.broadcast_to(np.arange(L, dtype=np.int32), (B, L)).copy()
    (jk, jv), jpos = jatt._clamp_padded((jnp.asarray(k), jnp.asarray(v)),
                                        jnp.asarray(pos), jnp.asarray(seq_lens))
    jc = jatt._cache_write(jc, jk, jv, jpos, "dynamic")
    (tk, tv), tpos = tatt._clamp_padded((_t(k), _t(v)), _t(pos), _t(seq_lens))
    tatt._cache_write(tc, tk, tv, tpos)
    if mode == "decode":
        k, v = _kv(B, 1, 2, 16, 2)
        pos = seq_lens[:, None].copy()
        jc = jatt._cache_write(jc, jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos),
                               "dynamic")
        tatt._cache_write(tc, _t(k), _t(v), _t(pos))
    assert set(tc) == set(jc) == {"k", "v", "k_scale", "v_scale", "pos", "len"}
    for name in jc:
        np.testing.assert_array_equal(tc[name].numpy(), np.asarray(jc[name]), err_msg=name)


@pytest.fixture(scope="module")
def models():
    jcfg = dataclasses.replace(j_reduced("stablelm-1.6b"), quant_kv="dynamic")
    tcfg = dataclasses.replace(t_reduced("stablelm-1.6b"), quant_kv="dynamic")
    jb, tb = j_build(jcfg), t_build(tcfg, "cpu")
    jp = jb.init(jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return {"bundle": (jb, tb), "cfg": tcfg, "fp": (jp, tp),
            "pdq": (dict(jp, blocks=jax.vmap(j_quantize)(jp["blocks"])), t_quantize(tp))}


def _check_step(jl, tl, tol, what):
    jl, tl = np.asarray(jl), tl.numpy()
    assert np.all(np.isfinite(tl))
    np.testing.assert_allclose(tl, jl, rtol=0, atol=tol, err_msg=what)


@pytest.mark.parametrize("kind", ["fp", "pdq"])
def test_int8_kv_prefill_many_and_decode_match_jax(models, kind):
    """Ragged prompts in one bucket, then 12 decode steps teacher-forced on
    JAX's greedy tokens: logits within the tolerance, pos/len equal."""
    (jb, tb), (jp, tp) = models["bundle"], models[kind]
    B, L, max_len = 3, 16, 40
    seq_lens = np.array([16, 9, 4], np.int32)
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, 512, (B, L)).astype(np.int32)
    tokens[np.arange(L)[None, :] >= seq_lens[:, None]] = 0
    jl, jc = jb.prefill_many(jp, {"tokens": jnp.asarray(tokens)},
                             jb.init_caches(B, max_len), jnp.asarray(seq_lens))
    tl, tc = tb.prefill_many(tp, {"tokens": torch.from_numpy(tokens)},
                             tb.init_caches(B, max_len), torch.from_numpy(seq_lens))
    _check_step(jl, tl, TOL[kind], "prefill")
    jstep = jax.jit(jb.decode_step)
    pos = seq_lens.copy()
    for step in range(12):
        tok = np.array(jnp.argmax(jl, -1), np.int32)[:, None]
        p = pos[:, None].astype(np.int32)
        jl, jc = jstep(jp, jc, jnp.asarray(tok), jnp.asarray(p))
        tl, tc = tb.decode_step(tp, tc, torch.from_numpy(tok), torch.from_numpy(p))
        _check_step(jl, tl, TOL[kind], f"decode step {step}")
        pos += 1
    for leaf in ("pos", "len"):
        np.testing.assert_array_equal(tc["blocks"][0][leaf].numpy(),
                                      np.asarray(jc["blocks"][0][leaf]))


def test_int8_kv_softcap_decodes_the_dequantized_cache_like_jax():
    """With an attention softcap the attend kernels do not apply: decode
    dequantizes the int8 cache and runs the plain softcapped attention,
    in both packages."""
    jcfg = dataclasses.replace(j_reduced("stablelm-1.6b"), quant_kv="dynamic",
                               attn_softcap=2.0)
    tcfg = dataclasses.replace(t_reduced("stablelm-1.6b"), quant_kv="dynamic",
                               attn_softcap=2.0)
    jb, tb = j_build(jcfg), t_build(tcfg, "cpu")
    jp = jb.init(jax.random.PRNGKey(1))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    tokens = np.random.default_rng(4).integers(0, 512, (2, 9)).astype(np.int32)
    lens = np.array([9, 6], np.int32)
    jl, jc = jb.prefill_many(jp, {"tokens": jnp.asarray(tokens)}, jb.init_caches(2, 24),
                             jnp.asarray(lens))
    tl, tc = tb.prefill_many(tp, {"tokens": torch.from_numpy(tokens)},
                             tb.init_caches(2, 24), torch.from_numpy(lens))
    tops.reset_counts()
    for step in range(4):
        tok = np.array(jnp.argmax(jl, -1), np.int32)[:, None]
        p = (lens + step)[:, None].astype(np.int32)
        jl, jc = jb.decode_step(jp, jc, jnp.asarray(tok), jnp.asarray(p))
        tl, tc = tb.decode_step(tp, tc, torch.from_numpy(tok), torch.from_numpy(p))
        _check_step(jl, tl, TOL["fp"], f"decode step {step}")
    c = tops.counts()
    assert c["decode_attend_i8kv"]["entries"] == c["decode_attend_i8kv_fused"]["entries"] == 0


@pytest.mark.parametrize("kind", ["fp", "pdq"])
def test_int8_kv_decode_op_entries(models, kind):
    """Per layer and decode step: with PDQ weights the fused attend once
    and the prologue twice (7 kernels: prologue 2, W8A8 3, SwiGLU 1, fused
    attend 1); with fp weights the plain attend once and nothing else."""
    tb, tp = models["bundle"][1], models[kind][1]
    n = models["cfg"].n_layers
    caches = tb.init_caches(4, 16)
    tops.reset_counts()
    tb.decode_step(tp, caches, torch.zeros((4, 1), dtype=torch.int32),
                   torch.zeros((4, 1), dtype=torch.int32))
    c = {k: v["entries"] for k, v in tops.counts().items()}
    want = dict.fromkeys(c, 0)
    if kind == "pdq":
        want.update(pdq_prologue=2 * n, w8a8_matmul=3 * n, w8a8_swiglu_matmul=n,
                    decode_attend_i8kv_fused=n)
    else:
        want.update(decode_attend_i8kv=n)
    assert c == want


def test_int8_kv_slot_reuse_does_not_attend_stale_tokens(models):
    """A shorter request reusing a longer one's slot gives exactly the
    tokens of a fresh engine: landing writes whole rows, ``len`` and the
    scales included, so the decode kernel's length mask never reaches the
    previous occupant's positions."""
    cfg, tp = models["cfg"], models["fp"][1]
    rng = np.random.default_rng(9)
    long_p, short_p = (rng.integers(0, cfg.vocab, n).astype(np.int32) for n in (20, 4))

    def run(prompts):
        eng = build_engine(ServeConfig(device="cpu", slots=1, max_len=64,
                                       buckets=(8, 32), int8_kv=True), cfg=cfg, params=tp)
        reqs = [Request(uid=i, prompt=p, max_new=6) for i, p in enumerate(prompts)]
        eng.run(reqs)
        return reqs[-1].generated

    assert run([long_p, short_p]) == run([short_p])
