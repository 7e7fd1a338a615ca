"""The port's SSD families against the JAX package's, on the same numpy
weights (everything on the CPU): reduced mamba2-2.7b (2 mamba layers) and
reduced zamba2-7b cut to one pattern block and its tail (``n_layers`` 9:
5 mamba layers, one ``shared`` occurrence of the shared attention + MLP
block, 3 tail mamba layers), each d_model 64, SSM of d_inner 128 (8 heads
of 16), state 16, chunks of 16, float32 (``reduced_config``).

- The configs agree with the reference's field for field, the SSM's
  included, and ``get_config`` registers both.
- The bridge: ``params["blocks"]`` holds the mamba layers' nested ``ssm``
  dicts per block and an empty dict at each ``shared`` position;
  ``shared_block`` maps one to one.
- ``quantize_param_tree``: every layer's ``in_proj`` / ``out_proj`` and the
  shared block's grouped QKV, wo, gate/up and w_down equal the records of
  ``dict(quantize_param_tree(params), blocks=vmap(quantize_param_tree)
  (params["blocks"]))`` (tests/test_torch_linops.py's ``_rec_equal``: q,
  colsum and scale exactly); ``conv_w``, ``A_log``, ``D``, ``dt_bias`` and
  the norms stay fp.
- ``prefill_many`` over ragged rows and a dummy row, then 6 greedy decode
  steps teacher-forced on JAX's tokens.  With fp weights the logits and
  every cache leaf (conv, state; the shared occurrence's k, v, pos, len)
  within tests/test_torch_model.py's 1e-5, integer leaves exactly.  With
  PDQ records an activation code can land on the other side of a .5 tie
  when its input moves by an ulp (the SSD's contractions sum in another
  order than JAX's einsums): measured once here, one code of the fifth
  mamba layer's ``in_proj`` input in zamba2's 40-token row (inputs 7.2e-7
  apart), which the recurrence carries to every later token of the row and
  moves its prefill logits by 6.6e-3.  So PDQ logits are held within
  ``FLIP_TOL`` (tests/test_torch_families.py's bound for one such flip),
  and the PDQ caches on their integer leaves exactly.

The engines against the JAX engine: tests/test_torch_families_ssm_engine.py.
"""
import dataclasses

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
from repro_torch.models.linops import is_quantized
from repro_torch.models.linops import quantize_param_tree as t_quantize
from tests.test_torch_linops import _rec_equal

torch.set_num_threads(1)

ARCHS = {"mamba2-2.7b": {}, "zamba2-7b": dict(n_layers=9)}
TOL = {"fp": 1e-5, "pdq": 1e-3}          # tests/test_torch_model.py
FLIP_TOL = 2e-2                          # PDQ logits after one code flip (above)
_MODELS: dict = {}


def _models(arch):
    """(jcfg, tcfg, {'fp': (jp, tp), 'pdq': (jp, tp)}) of the reduced
    ``arch`` on one set of JAX weights, once per module."""
    if arch not in _MODELS:
        jcfg, tcfg = j_reduced(arch, **ARCHS[arch]), t_reduced(arch, **ARCHS[arch])
        jp = j_build(jcfg).init(jax.random.PRNGKey(0))
        tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
        jq = dict(j_quantize(jp), blocks=jax.vmap(j_quantize)(jp["blocks"]))
        _MODELS[arch] = (jcfg, tcfg, {"fp": (jp, tp), "pdq": (jq, t_quantize(tp))})
    return _MODELS[arch]


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_agree_with_the_reference(arch):
    for j, t in ((j_get(arch), t_get(arch)), (j_reduced(arch), t_reduced(arch))):
        for f in ("n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff", "vocab", "hd",
                  "n_blocks", "head", "pattern", "tail", "window", "rope_theta",
                  "norm_eps", "embed_scale", "dtype", "family", "frontend"):
            assert getattr(j, f) == getattr(t, f), (arch, f)
        assert dataclasses.asdict(j.ssm) == dataclasses.asdict(t.ssm), arch
        for f in ("d_inner", "n_heads", "conv_dim"):
            assert getattr(j.ssm, f) == getattr(t.ssm, f), (arch, f)


@pytest.mark.parametrize("arch", ARCHS)
def test_bridge_carries_mamba_and_shared_layers(arch):
    jcfg, tcfg, w = _models(arch)
    jp, tp = w["fp"]
    P, n = len(tcfg.pattern), tcfg.n_blocks
    assert len(tp["blocks"]) == P * n
    for i in range(n):
        for j, kind in enumerate(tcfg.pattern):
            layer = tp["blocks"][i * P + j]
            if kind == "shared":
                assert layer == {}
                continue
            for name in ("in_proj", "conv_w", "A_log", "out_proj"):
                np.testing.assert_array_equal(
                    layer["ssm"][name].numpy(), np.asarray(jp["blocks"][j]["ssm"][name][i]))
    assert ("shared_block" in tp) == ("shared" in tcfg.pattern)
    if "shared_block" in tp:
        np.testing.assert_array_equal(tp["shared_block"]["attn"]["wq"].numpy(),
                                      np.asarray(jp["shared_block"]["attn"]["wq"]))
    assert len(tp["tail"]) == len(tcfg.tail)


@pytest.mark.parametrize("arch", ARCHS)
def test_quantized_records_equal_the_reference(arch):
    jcfg, tcfg, w = _models(arch)
    jq, tq = w["pdq"]
    P = len(tcfg.pattern)
    layers = [(tq["blocks"][i * P + j], jax.tree.map(lambda a, i=i: a[i], jq["blocks"][j]))
              for i in range(tcfg.n_blocks) for j, k in enumerate(tcfg.pattern)
              if k == "mamba"]
    layers += list(zip(tq["tail"], jq["tail"]))
    for t, j in layers:
        for name in ("in_proj", "out_proj"):
            _rec_equal(t["ssm"][name], j["ssm"][name])
        for name in ("conv_w", "conv_b", "A_log", "D", "dt_bias", "norm"):
            assert not is_quantized(t["ssm"][name]), name
        assert not is_quantized(t["norm"])
    if "shared_block" in tq:
        t, j = tq["shared_block"], jq["shared_block"]
        for part, names in (("attn", ("wq", "wk", "wv")), ("ffn", ("w_gate", "w_up"))):
            _rec_equal(t[part][names[0]]["group"], j[part][names[0]]["group"])
        _rec_equal(t["attn"]["wo"], j["attn"]["wo"])
        _rec_equal(t["ffn"]["w_down"], j["ffn"]["w_down"])


def _leaves(caches):
    """(name, leaf) of every block cache, in kind order."""
    return [(f"kind {j} {k}", d[k]) for j, d in enumerate(caches["blocks"])
            for k in sorted(d)] + [(f"tail {i} {k}", d[k])
                                   for i, d in enumerate(caches["tail"]) for k in sorted(d)]


@pytest.mark.parametrize("kind", ["fp", "pdq"])
@pytest.mark.parametrize("arch", ARCHS)
def test_model_matches_the_reference(arch, kind):
    """A bucketed prefill (ragged rows, a dummy row) then greedy decode
    steps teacher-forced on JAX's tokens: logits and every cache leaf."""
    jcfg, tcfg, w = _models(arch)
    jp, tp = w[kind]
    jb, tb = j_build(jcfg), t_build(tcfg, "cpu")
    rng = np.random.default_rng(1)
    B, L = 3, 40
    toks = rng.integers(0, jcfg.vocab, size=(B, L)).astype(np.int32)
    sl = np.array([40, 17, 0], np.int32)
    jc, tc = jb.init_caches(B, 64), tb.init_caches(B, 64)
    jl, jc = jb.prefill_many(jp, {"tokens": jnp.asarray(toks)}, jc, jnp.asarray(sl))
    tl, tc = tb.prefill_many(tp, {"tokens": torch.from_numpy(toks)}, tc,
                             torch.from_numpy(sl))
    tol = TOL["fp"] if kind == "fp" else FLIP_TOL
    for step in range(7):
        np.testing.assert_allclose(tl.numpy()[:2], np.asarray(jl)[:2], rtol=0, atol=tol,
                                   err_msg=f"step {step}")
        nxt = np.asarray(jl).argmax(-1).astype(np.int32)[:, None]
        if step == 6:
            break
        pos = (sl[:, None] + step).astype(np.int32)
        jl, jc = jb.decode_step(jp, jc, jnp.asarray(nxt), jnp.asarray(pos))
        tl, tc = tb.decode_step(tp, tc, torch.from_numpy(nxt), torch.from_numpy(pos))
    jleaves = jax.tree.leaves({"blocks": jc["blocks"], "tail": jc["tail"]})
    tleaves = _leaves(tc)
    assert len(jleaves) == len(tleaves)
    for a, (name, b) in zip(jleaves, tleaves):
        a, b = np.asarray(a), b.numpy()
        assert a.shape == b.shape and a.dtype == b.dtype, name
        if a.dtype.kind in "iu":
            np.testing.assert_array_equal(b, a, err_msg=name)
        elif kind == "fp":
            np.testing.assert_allclose(b, a, rtol=1e-5, atol=tol, err_msg=name)
