"""The port's encoder-decoder parts against the JAX package's, on the same
numpy weights and inputs (everything on the CPU): reduced
seamless-m4t-medium (2 encoder and 2 decoder layers, d_model 64, 4 heads
over 2 kv heads of 16, float32; ``reduced_config``).

- ``cross_memory`` / ``cross_apply`` on decoder layer 0's cross block and
  ``_encoder_apply`` (the cache-free bidirectional ``global`` layers, then
  ``enc_norm``) on seeded numpy memories and frames: fp within
  tests/test_torch_model.py's 1e-5, PDQ records within its 1e-3.  The
  cross block's norm weight is a seeded nonzero vector (the init's zeros
  would hide a norm applied twice or not at all).
- ``quantize_param_tree`` on a decoder layer: its ``cross`` block groups
  (wk, wv) alone, in that order, wq and wo stay single records, the
  self-attention keeps its (wq, wk, wv) group; every record equals
  ``jax.vmap(quantize_param_tree)``'s over the reference's stacked blocks
  and enc_blocks (tests/test_torch_linops.py's ``_rec_equal``).
- ``init_caches(..., mem_len)``: the cross leaves (B, max(mem_len, 1),
  Hkv, Dh) in the model dtype beside the self-attention's leaves, fp and
  int8 KV, equal in shape and dtype to the reference's; ``paged_cache``
  classifies them flat (they do not grow with max_len), leaf for leaf as
  the reference's ``meta``.
- ``params_from_numpy``: ``enc_blocks`` split per encoder layer,
  ``enc_norm``, and each decoder layer's ``cross`` / ``cross_norm``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as j_reduced
from repro.models import attention as j_att
from repro.models import build_model as j_build
from repro.models import transformer as j_tr
from repro.models.layers import rms_norm as j_rms_norm
from repro.models.linops import quantize_param_tree as j_quantize
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import reduced_config as t_reduced
from repro_torch.models import attention as t_att
from repro_torch.models import build_model as t_build
from repro_torch.models import transformer as t_tr
from repro_torch.models.linops import is_quantized, is_segment_view
from repro_torch.models.linops import quantize_param_tree as t_quantize
from tests.test_torch_linops import _rec_equal

torch.set_num_threads(1)

ARCH = "seamless-m4t-medium"
TOL = {"fp": 1e-5, "pdq": 1e-3}          # tests/test_torch_model.py
_MODELS: dict = {}


def _models():
    """(jcfg, tcfg, {'fp': (jp, tp), 'pdq': (jq, tq)}), once per module."""
    if not _MODELS:
        jcfg, tcfg = j_reduced(ARCH), t_reduced(ARCH)
        jp = j_build(jcfg).init(jax.random.PRNGKey(0))
        tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
        jq = dict(j_quantize(jp), blocks=jax.vmap(j_quantize)(jp["blocks"]),
                  enc_blocks=jax.vmap(j_quantize)(jp["enc_blocks"]))
        _MODELS.update(cfg=(jcfg, tcfg), w={"fp": (jp, tp), "pdq": (jq, t_quantize(tp))})
    return (*_MODELS["cfg"], _MODELS["w"])


def _layer(tree, i):
    """Layer ``i`` of a stacked reference block tree."""
    return jax.tree.map(lambda a: a[i], tree)


def _np(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


@pytest.mark.parametrize("kind", ["fp", "pdq"])
def test_cross_memory_and_apply_match_the_reference(kind):
    jcfg, tcfg, w = _models()
    jp, tp = w[kind]
    jc, tc = _layer(jp["blocks"][0], 0)["cross"], tp["blocks"][0]["cross"]
    jdims, tdims = j_tr._attn_dims(jcfg, "global"), t_tr.attn_dims(tcfg)
    B, Sq, Sm, d = 2, 5, 8, tcfg.d_model
    memory, x, nw = _np((B, Sm, d), 1), _np((B, Sq, d), 2), _np((d,), 3, 0.3)
    jk, jv = j_att.cross_memory(jc, jdims, jnp.asarray(memory))
    tk, tv = t_att.cross_memory(tc, tdims, torch.from_numpy(memory))
    assert tuple(tk.shape) == (B, Sm, tcfg.n_kv_heads, tcfg.hd)
    for a, b in ((jk, tk), (jv, tv)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0, atol=TOL[kind])
    jy = j_att.cross_apply(jc, jdims, j_rms_norm(jnp.asarray(x), jnp.asarray(nw),
                                                 tcfg.norm_eps), (jk, jv))
    ty = t_att.cross_apply(tc, tdims, torch.from_numpy(x), (tk, tv),
                           norm=(torch.from_numpy(nw), tcfg.norm_eps))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=0, atol=TOL[kind])


@pytest.mark.parametrize("kind", ["fp", "pdq"])
def test_encoder_matches_the_reference(kind):
    jcfg, tcfg, w = _models()
    jp, tp = w[kind]
    frames = _np((2, 8, tcfg.d_model), 4, 0.5)
    jh = j_tr._encoder_apply(jp, jcfg, jnp.asarray(frames))
    th = t_tr._encoder_apply(tp, tcfg, torch.from_numpy(frames))
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=0, atol=TOL[kind])


def test_cross_block_records_equal_the_reference():
    jcfg, tcfg, w = _models()
    jq, tq = w["pdq"]
    n = tcfg.n_blocks
    assert len(tq["blocks"]) == n
    for i in range(n):
        t, j = tq["blocks"][i], _layer(jq["blocks"][0], i)
        cross = t["cross"]
        assert is_segment_view(cross["wk"]) and is_segment_view(cross["wv"])
        grec = cross["wk"]["group"]
        assert grec is cross["wv"]["group"] and grec["segs"].names == ("wk", "wv")
        assert is_quantized(cross["wq"]) and not is_segment_view(cross["wq"])
        assert not is_segment_view(cross["wo"])
        _rec_equal(grec, j["cross"]["wk"]["group"])
        for name in ("wq", "wo"):
            _rec_equal(cross[name], j["cross"][name])
        assert t["attn"]["wq"]["group"]["segs"].names == ("wq", "wk", "wv")
        assert not is_quantized(t["cross_norm"])
    for i, t in enumerate(tq["enc_blocks"]):
        j = _layer(jq["enc_blocks"], i)
        assert "cross" not in t
        _rec_equal(t["attn"]["wq"]["group"], j["attn"]["wq"]["group"])
        _rec_equal(t["ffn"]["w_gate"]["group"], j["ffn"]["w_gate"]["group"])
        _rec_equal(t["ffn"]["w_down"], j["ffn"]["w_down"])


@pytest.mark.parametrize("int8_kv", [False, True])
@pytest.mark.parametrize("mem_len", [0, 8])
def test_cache_leaves_match_the_reference(int8_kv, mem_len):
    jcfg, tcfg, _ = _models()
    if int8_kv:
        jcfg = dataclasses.replace(jcfg, quant_kv="dynamic")
        tcfg = dataclasses.replace(tcfg, quant_kv="dynamic")
    jc = j_build(jcfg).init_caches(3, 64, mem_len)
    tc = t_build(tcfg, "cpu").init_caches(3, 64, mem_len)
    jd, td = jc["blocks"][0], tc["blocks"][0]
    assert sorted(jd) == sorted(td)
    for k in jd:
        assert tuple(td[k].shape) == jd[k].shape, k
        assert str(td[k].dtype).split(".")[-1] == str(jd[k].dtype), k
    assert tuple(td["cross_k"].shape) == (tcfg.n_blocks, 3, max(mem_len, 1),
                                          tcfg.n_kv_heads, tcfg.hd)
    assert td["cross_k"].dtype == torch.float32        # the model dtype, int8 KV or not


@pytest.mark.parametrize("int8_kv", [False, True])
@pytest.mark.parametrize("max_len", [64, 128])
def test_paged_meta_keeps_the_cross_leaves_flat(int8_kv, max_len):
    jcfg, tcfg, _ = _models()
    if int8_kv:
        jcfg = dataclasses.replace(jcfg, quant_kv="dynamic")
        tcfg = dataclasses.replace(tcfg, quant_kv="dynamic")
    jm = j_build(jcfg).paged_cache(3, max_len, 8, 16).meta["blocks"][0]
    tm = t_build(tcfg, "cpu").paged_cache(3, max_len, 16, mem_len=8).meta["blocks"][0]
    assert sorted(jm) == sorted(tm)
    for name in jm:
        j, t = jm[name], tm[name]
        assert (t.kind, t.seq_axis, t.n_leaf, t.shape) == (
            j.kind, j.seq_axis, j.n_leaf, tuple(j.shape)), name
    assert tm["cross_k"].kind == tm["cross_v"].kind == "flat"
    assert tm["pos"].kind == "seq"


def test_bridge_carries_the_encoder_and_the_cross_blocks():
    jcfg, tcfg, w = _models()
    jp, tp = w["fp"]
    assert len(tp["enc_blocks"]) == tcfg.enc_layers == 2
    for i, layer in enumerate(tp["enc_blocks"]):
        np.testing.assert_array_equal(layer["attn"]["wq"].numpy(),
                                      np.asarray(jp["enc_blocks"]["attn"]["wq"][i]))
        np.testing.assert_array_equal(layer["ffn"]["w_down"].numpy(),
                                      np.asarray(jp["enc_blocks"]["ffn"]["w_down"][i]))
    np.testing.assert_array_equal(tp["enc_norm"].numpy(), np.asarray(jp["enc_norm"]))
    for i, layer in enumerate(tp["blocks"]):
        for name in ("wq", "wk", "wv", "wo"):
            np.testing.assert_array_equal(
                layer["cross"][name].numpy(), np.asarray(jp["blocks"][0]["cross"][name][i]))
        np.testing.assert_array_equal(layer["cross_norm"].numpy(),
                                      np.asarray(jp["blocks"][0]["cross_norm"][i]))
