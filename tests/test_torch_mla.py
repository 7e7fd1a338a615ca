"""The port's MLA (``repro_torch/models/attention.py`` ``mla_apply``)
against the JAX package's (``repro/models/attention.py:439-574``) on the
same numpy weights and inputs, on the CPU: reduced deepseek-v2-236b's dims
(d_model 64, 4 heads, q_lora 32, kv_lora 32, qk_nope 16, qk_rope 8, v_head
16), float32, two rows and a 32-position cache.

One sequence per weight kind (fp, and PDQ records: JAX's
``quantize_param_tree`` of the layer and the port's, both grouping (wq_a,
wkv_a) into one record):

  1. the expanded prefill over right-padded rows (a 16-token bucket, real
     lengths 16 and 9), pads never landing in the cache;
  2. a chunked continuation of 8 tokens (5 real in row 1) at the rows'
     frontiers, which re-expands the whole cached ``ckv`` through wk_b /
     wv_b and attends the buffer;
  3. three absorbed decode steps in the compressed space (a quantized wk_b
     / wv_b read as q * scale in f32).

The port takes the un-normed x and the attention norm (its prologue
applies it); JAX takes rms_norm(x).  At every stage: each real token's
output within tests/test_torch_model.py's tolerances (fp 1e-5, PDQ 1e-3),
the ``ckv`` / ``krope`` leaves within the same, ``pos`` and ``len``
exactly equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as j_reduced
from repro.models import attention as jatt
from repro.models import transformer as jtr
from repro.models.layers import rms_norm as j_rms_norm
from repro.models.linops import quantize_param_tree as j_quantize
from repro_torch.bridge import _tensor
from repro_torch.configs import reduced_config as t_reduced
from repro_torch.models import attention as tatt
from repro_torch.models import transformer as ttr
from repro_torch.models.linops import quantize_param_tree as t_quantize

torch.set_num_threads(1)

ARCH = "deepseek-v2-236b"
TOL = {"fp": 1e-5, "pdq": 1e-3}          # tests/test_torch_model.py
B, S_MAX = 2, 32
PRE_LENS, CHUNK_LENS = (16, 9), (8, 5)
N_DECODE = 3


def _t(tree):
    if isinstance(tree, dict):
        return {k: _t(v) for k, v in tree.items()}
    return _tensor(np.asarray(tree), "cpu")


def _check(ty, jy, lens, tol, what):
    jy = np.asarray(jy)
    for b, n in enumerate(lens):
        np.testing.assert_allclose(ty.numpy()[b, :n], jy[b, :n], rtol=0, atol=tol,
                                   err_msg=f"{what} row {b}")


def _check_cache(tc, jc, tol, what):
    assert sorted(tc) == sorted(jc) == ["ckv", "krope", "len", "pos"]
    for name in ("pos", "len"):
        np.testing.assert_array_equal(tc[name].numpy(), np.asarray(jc[name]),
                                      err_msg=f"{what} {name}")
    for name in ("ckv", "krope"):
        np.testing.assert_allclose(tc[name].numpy(), np.asarray(jc[name]), rtol=0,
                                   atol=tol, err_msg=f"{what} {name}")


def test_dims_and_cache_agree_with_the_reference():
    jm, tm = jtr._mla_dims(j_reduced(ARCH)), ttr.mla_dims(t_reduced(ARCH))
    assert jm == jm.__class__(**vars(tm))
    jc = jatt.mla_init_cache(jm, B, S_MAX, jnp.float32)
    tc = tatt.mla_init_cache(tm, B, S_MAX, torch.float32, "cpu")
    for name in jc:
        np.testing.assert_array_equal(tc[name].numpy(), np.asarray(jc[name]))
        assert tc[name].numpy().dtype == np.asarray(jc[name]).dtype, name


@pytest.mark.parametrize("weights", ["fp", "pdq"])
def test_mla_prefill_chunk_and_absorbed_decode_match_jax(weights):
    jcfg, tcfg = j_reduced(ARCH), t_reduced(ARCH)
    jm, tm = jtr._mla_dims(jcfg), ttr.mla_dims(tcfg)
    jp = jatt.mla_init(jax.random.PRNGKey(7), jm, jnp.float32)
    rng = np.random.default_rng(8)
    # nonzero norm weights, so that every norm is exercised
    for name in ("q_norm", "kv_norm"):
        jp[name] = jnp.asarray(0.3 * rng.standard_normal(jp[name].shape), jnp.float32)
    tp = _t(jp)
    if weights == "pdq":
        jp, tp = j_quantize(jp), t_quantize(tp)
        assert tp["wq_a"]["group"] is tp["wkv_a"]["group"]
        assert jp["wq_a"]["group"]["segs"].sizes == tp["wq_a"]["group"]["segs"].sizes
    tol = TOL[weights]
    w = (0.2 * rng.standard_normal(64)).astype(np.float32)
    norm = (torch.from_numpy(w), tcfg.norm_eps)

    def j_x(x):
        return j_rms_norm(jnp.asarray(x), jnp.asarray(w), jcfg.norm_eps)

    jc = jatt.mla_init_cache(jm, B, S_MAX, jnp.float32)
    tc = tatt.mla_init_cache(tm, B, S_MAX, torch.float32, "cpu")

    # 1. bucketed prefill
    L = max(PRE_LENS)
    x = rng.standard_normal((B, L, 64)).astype(np.float32)
    pos = np.broadcast_to(np.arange(L, dtype=np.int32), (B, L))
    lens = np.asarray(PRE_LENS, np.int32)
    jy, jc = jatt.mla_apply(jp, jm, j_x(x), jnp.asarray(pos), mode="prefill", cache=jc,
                            seq_lens=jnp.asarray(lens))
    ty, tc = tatt.mla_apply(tp, tm, torch.from_numpy(x), torch.from_numpy(pos.copy()),
                            mode="prefill", cache=tc, seq_lens=torch.from_numpy(lens),
                            norm=norm)
    _check(ty, jy, PRE_LENS, tol, "prefill")
    _check_cache(tc, jc, tol, "prefill")

    # 2. a chunked continuation at each row's frontier
    Lc = max(CHUNK_LENS)
    x = rng.standard_normal((B, Lc, 64)).astype(np.float32)
    pos = (lens[:, None] + np.arange(Lc, dtype=np.int32)[None]).astype(np.int32)
    clens = np.asarray(CHUNK_LENS, np.int32)
    jy, jc = jatt.mla_apply(jp, jm, j_x(x), jnp.asarray(pos), mode="prefill", cache=jc,
                            seq_lens=jnp.asarray(clens), chunked=True)
    ty, tc = tatt.mla_apply(tp, tm, torch.from_numpy(x), torch.from_numpy(pos),
                            mode="prefill", cache=tc, seq_lens=torch.from_numpy(clens),
                            norm=norm, chunked=True)
    _check(ty, jy, CHUNK_LENS, tol, "chunk")
    _check_cache(tc, jc, tol, "chunk")

    # 3. absorbed decode steps
    front = lens + clens
    for step in range(N_DECODE):
        x = rng.standard_normal((B, 1, 64)).astype(np.float32)
        pos = (front + step)[:, None].astype(np.int32)
        jy, jc = jatt.mla_apply(jp, jm, j_x(x), jnp.asarray(pos), mode="decode", cache=jc)
        ty, tc = tatt.mla_apply(tp, tm, torch.from_numpy(x), torch.from_numpy(pos),
                                mode="decode", cache=tc, norm=norm)
        _check(ty, jy, (1, 1), tol, f"decode {step}")
        _check_cache(tc, jc, tol, f"decode {step}")
