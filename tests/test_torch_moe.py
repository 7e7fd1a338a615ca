"""The port's mixture-of-experts FFN (``repro_torch/models/moe.py``) against
the JAX package's (``repro/models/moe.py``, single device) on the same
numpy inputs and weights, on the CPU: the MoE configs of reduced
deepseek-v2-236b (8 experts, top-2, 2 shared experts as one MLP of 64,
router_scale 16) and arctic-480b (8 experts, top-2, a dense residual MLP of
64), d_model 64, float32.

- ``route``: gates within 1e-5 (tests/test_torch_model.py's fp tolerance),
  ids equal, aux within 1e-5; with a token mask the masked tokens' gates
  are 0 and their ids the sentinel E in both.  Where an id differs, the
  reference's top-k margin at that token (the k-th probability less the
  (k+1)-th) must be below ``TIE_EPS``: two f32 softmaxes summed in other
  orders can order a near-tie either way.  None differed here.
- ``_bucket`` at capacity factor 1.0, where assignments drop: the buffer,
  each real assignment's slot and its validity exactly equal.  A sentinel
  assignment (a masked token's) lands nowhere in either; the port gives it
  the invalid slot C where JAX's out-of-range gather gives INT32_MIN
  (documented in the module).
- ``moe_ffn_tokens`` (capacity factors 1.0 and the reduced config's 8.0)
  and ``moe_ffn_dense_masked``, with and without a token mask: y within
  1e-5, aux within 1e-5; masked tokens' rows are 0 in the port.
- The layer's FFN (``transformer._apply_ffn``: router, experts and the
  shared / dense MLP on one rms_norm(h)), at prefill (bucketed rows, pads
  masked) and at decode, with fp weights (1e-5) and PDQ records on the MLP
  (1e-3, tests/test_torch_model.py's PDQ tolerance; JAX on its
  ``quantize_param_tree`` of the same layer).  deepseek's router_scale 16
  puts these outputs at |y| up to ~30, where an f32 ulp is 2e-6, so the
  layer's tolerance is relative as well as absolute (rtol = atol: 1.1e-5
  measured at |y| 15, 5.8e-7 relative).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as j_reduced
from repro.models import moe as jmoe
from repro.models import transformer as jtr
from repro.models.layers import rms_norm as j_rms_norm
from repro.models.linops import quantize_param_tree as j_quantize
from repro_torch.bridge import _tensor
from repro_torch.configs import reduced_config as t_reduced
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as ttr
from repro_torch.models.linops import quantize_param_tree as t_quantize

torch.set_num_threads(1)

ARCHS = ("deepseek-v2-236b", "arctic-480b")
TOL = {"fp": 1e-5, "pdq": 1e-3}          # tests/test_torch_model.py
TIE_EPS = 1e-6                           # a top-k near-tie the two may order apart
T = 24


def _t(tree):
    if isinstance(tree, dict):
        return {k: _t(v) for k, v in tree.items()}
    return _tensor(np.asarray(tree), "cpu")


def _moe(arch, cf=None):
    """(JAX MoEConfig, port MoEConfig, JAX params, port params) of the
    reduced ``arch``, the capacity factor ``cf`` if given."""
    jc, tc = j_reduced(arch).moe, t_reduced(arch).moe
    if cf is not None:
        jc, tc = (dataclasses.replace(c, capacity_factor=cf) for c in (jc, tc))
    jp = jmoe.moe_init(jax.random.PRNGKey(3), 64, jc, jnp.float32)
    return jc, tc, jp, _t(jp)


def _x(seed=0, n=T, d=64):
    return np.random.default_rng(seed).standard_normal((n, d)).astype(np.float32)


def _mask(n=T):
    m = np.ones(n, bool)
    m[5:9] = False
    m[-3:] = False
    return m


def _ids_agree(jprobs, jids, tids, k):
    """ids equal, or where a token's differ the reference's top-k margin
    there is below TIE_EPS."""
    jids, tids = np.asarray(jids), tids.numpy()
    for t in np.nonzero((jids != tids).any(-1))[0]:
        p = np.sort(jprobs[t])[::-1]
        assert p[k - 1] - p[k] < TIE_EPS, (t, jids[t], tids[t], p[:k + 1])


def test_configs_agree_with_the_reference():
    from repro.configs import get_config as j_get
    from repro_torch.configs import get_config as t_get
    for arch in ARCHS:
        for j, t in ((j_get(arch), t_get(arch)), (j_reduced(arch), t_reduced(arch))):
            assert dataclasses.asdict(j.moe) == dataclasses.asdict(t.moe), arch
            assert (j.mla is None) == (t.mla is None), arch
            if j.mla is not None:
                assert dataclasses.asdict(j.mla) == dataclasses.asdict(t.mla), arch
            for f in ("n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff", "vocab",
                      "hd", "head", "pattern", "tail", "n_blocks", "rope_theta",
                      "norm_eps", "dtype"):
                assert getattr(j, f) == getattr(t, f), (arch, f)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_route_matches_jax(arch, masked):
    jc, tc, jp, tp = _moe(arch)
    x = _x(1)
    m = _mask() if masked else None
    jg, ji, ja = jmoe.route(jnp.asarray(x), jp["router"], jc,
                            None if m is None else jnp.asarray(m))
    tg, ti, ta = tmoe.route(torch.from_numpy(x), tp["router"], tc,
                            None if m is None else torch.from_numpy(m))
    jprobs = np.asarray(jax.nn.softmax(jnp.asarray(x) @ jp["router"], axis=-1))
    _ids_agree(jprobs, ji, ti, jc.top_k)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=0, atol=TOL["fp"])
    np.testing.assert_allclose(float(ta), float(ja), rtol=0, atol=TOL["fp"])
    if m is not None:
        assert (ti.numpy()[~m] == jc.n_experts).all() and (tg.numpy()[~m] == 0).all()


@pytest.mark.parametrize("sentinels", [False, True])
def test_bucket_matches_jax_with_drops(sentinels):
    """Capacity factor 1.0: C = ceil(N / E) slots an expert, so a skewed
    id draw overflows some experts and their later assignments drop."""
    E, N, d = 8, 48, 16
    rng = np.random.default_rng(4)
    ids = rng.choice(E, size=N, p=np.array([4, 2, 1, 1, 1, 1, 1, 1]) / 12).astype(np.int32)
    if sentinels:
        ids[rng.choice(N, size=9, replace=False)] = E
    x = rng.standard_normal((N, d)).astype(np.float32)
    C = max(1, int(N * 1.0 / E + 0.999))
    jbuf, jslot, jvalid = jmoe._bucket(jnp.asarray(x), jnp.asarray(ids), E, C)
    tbuf, tslot, tvalid = tmoe._bucket(torch.from_numpy(x), torch.from_numpy(ids).long(),
                                       E, C)
    np.testing.assert_array_equal(tbuf.numpy(), np.asarray(jbuf))
    real = ids < E
    assert (~np.asarray(jvalid)[real]).sum() > 0            # something dropped
    np.testing.assert_array_equal(tslot.numpy()[real], np.asarray(jslot)[real])
    np.testing.assert_array_equal(tvalid.numpy()[real], np.asarray(jvalid)[real])
    assert not tvalid.numpy()[~real].any() and (tslot.numpy()[~real] == C).all()


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("fn", ["moe_ffn_tokens", "moe_ffn_dense_masked"])
@pytest.mark.parametrize("cf", [1.0, None])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_ffn_matches_jax(arch, cf, fn, masked):
    jc, tc, jp, tp = _moe(arch, cf)
    routed = ("router", "we_gate", "we_up", "we_down")
    x = _x(2)
    m = _mask() if masked else None
    jy, ja = getattr(jmoe, fn)({k: jp[k] for k in routed}, jnp.asarray(x), jc,
                               token_mask=None if m is None else jnp.asarray(m))
    ty, ta = getattr(tmoe, fn)({k: tp[k] for k in routed}, torch.from_numpy(x), tc,
                               token_mask=None if m is None else torch.from_numpy(m))
    keep = slice(None) if m is None else m
    np.testing.assert_allclose(ty.numpy()[keep], np.asarray(jy)[keep], rtol=0,
                               atol=TOL["fp"])
    np.testing.assert_allclose(float(ta), float(ja), rtol=0, atol=TOL["fp"])
    if m is not None:
        assert (ty.numpy()[~m] == 0).all()


@pytest.mark.parametrize("weights", ["fp", "pdq"])
@pytest.mark.parametrize("mode", ["prefill", "decode"])
@pytest.mark.parametrize("arch", ARCHS)
def test_layer_ffn_with_shared_or_dense_mlp(arch, mode, weights):
    """``_apply_ffn`` of a MoE layer: deepseek's shared experts and
    arctic's dense residual MLP beside the routed experts, all on one
    rms_norm(h); the port normalizes itself (``norm``), JAX takes the
    normed h.  Prefill rows are right-padded (seq_lens) and the pads
    masked out of routing; the pads' rows are not compared."""
    jcfg, tcfg = j_reduced(arch), t_reduced(arch)
    jl = jtr.layer_init(jax.random.PRNGKey(5), jcfg, "global", jnp.float32)
    jffn = jl["ffn"]
    assert ("shared" in jffn) == (arch == "deepseek-v2-236b")
    assert ("dense" in jffn) == (arch == "arctic-480b")
    tffn = _t(jffn)
    if weights == "pdq":
        jffn, tffn = j_quantize(jffn), t_quantize(tffn)
    rng = np.random.default_rng(6)
    B, S = (3, 8) if mode == "prefill" else (3, 1)
    h = rng.standard_normal((B, S, 64)).astype(np.float32)
    w = (0.2 * rng.standard_normal(64)).astype(np.float32)
    lens = np.array([8, 3, 5], np.int32) if mode == "prefill" else None
    jy, _ = jtr._apply_ffn(jffn, jcfg, "global", j_rms_norm(jnp.asarray(h), jnp.asarray(w),
                                                            jcfg.norm_eps),
                           mode, seq_lens=None if lens is None else jnp.asarray(lens))
    ty, _ = ttr._apply_ffn(tffn, tcfg, "global", torch.from_numpy(h), mode,
                           (torch.from_numpy(w), tcfg.norm_eps),
                           None if lens is None else torch.from_numpy(lens))
    jy = np.asarray(jy)
    for b in range(B):
        n = S if lens is None else lens[b]
        np.testing.assert_allclose(ty.numpy()[b, :n], jy[b, :n], rtol=TOL[weights],
                                   atol=TOL[weights], err_msg=f"row {b}")
