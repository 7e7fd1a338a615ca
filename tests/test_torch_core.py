"""The port's PDQ core library (``repro_torch.core``: affine, surrogate,
interval, policy) against the JAX package's ``repro.core``, on the same
numpy inputs made from a seed (qlinear and calibrate:
``tests/test_torch_qlinear.py``).

Tolerances:
- affine: codes (int8 / int32 storage, zero points) exactly equal and every
  float (scales, dequantized values) equal, at bits 4/8/16, per tensor and
  per channel; the port divides by the grid size with IEEE division
  (``kernels.ref.true_div``) as XLA does.
- surrogate: rtol 1e-5 (atol 1e-6 of the largest magnitude, for sums that
  cancel to near 0; a predicted mean also within 1e-5 of the predicted
  std, ``close_moments``): the window sums are f32 sum-pools where the
  reference convolves with a ones kernel, and every reduction sums in
  another order.
- interval: bit-equal (the fitting is numpy in both; ``interval`` and
  ``coverage`` are the same f32 operations).
- policy: every resolved policy's fields equal.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
from repro.core import affine as jaff
from repro.core import interval as jint
from repro.core import policy as jpol
from repro.core import surrogate as jsur
from repro_torch import core as tcore
from repro_torch.core import affine as taff
from repro_torch.core import interval as tint
from repro_torch.core import policy as tpol
from repro_torch.core import surrogate as tsur

torch.set_num_threads(1)

MODES = ("none", "observe", "dynamic", "static", "pdq")
RTOL = 1e-5


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(a):
    return a.detach().numpy() if torch.is_tensor(a) else np.asarray(a)


def close(a, b, rtol=RTOL):
    a, b = _np(a), _np(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    scale = float(np.abs(b).max()) if b.size else 0.0
    np.testing.assert_allclose(a, b, rtol=rtol, atol=1e-6 * scale)


def close_moments(t, j, rtol=RTOL):
    """Predicted moments: var within ``rtol``; the mean within ``rtol`` of
    the predicted std as well, the scale its interval is priced in (a mean
    of zero-mean weights cancels to ~1e-4 of their scale, and its f32 sum
    keeps fewer significant digits than the std's)."""
    close(t.var, j.var, rtol)
    a, b = _np(t.mean), _np(j.mean)
    np.testing.assert_allclose(a, b, rtol=rtol,
                               atol=rtol * float(np.sqrt(np.abs(_np(j.var)).max())))


def equal(a, b):
    a, b = _np(a), _np(b)
    assert a.shape == b.shape and a.dtype == b.dtype, (a.shape, b.shape, a.dtype, b.dtype)
    np.testing.assert_array_equal(a, b)


# ------------------------------------------------------------------ affine


@pytest.mark.parametrize("per_channel", [False, True])
@pytest.mark.parametrize("bits", [4, 8, 16])
def test_affine_matches_jax(bits, per_channel):
    rng = np.random.default_rng(bits)
    x = (rng.standard_normal((6, 5, 7)) * 3 + 0.5).astype(np.float32)
    x[0, 0, :] = 0.0                            # a channel range of one point
    axis = 2 if per_channel else None
    jqp = jaff.dynamic_qparams(jnp.asarray(x), bits=bits, channel_axis=axis)
    tqp = taff.dynamic_qparams(_t(x), bits=bits, channel_axis=axis)
    assert tqp.bits == jqp.bits and (tqp.qmin, tqp.qmax) == (jqp.qmin, jqp.qmax)
    equal(tqp.scale, jqp.scale)
    equal(tqp.zero_point, jqp.zero_point)
    jq, tq = jaff.quantize(jnp.asarray(x), jqp), taff.quantize(_t(x), tqp)
    equal(tq, jq)
    equal(taff.dequantize(tq, tqp), jaff.dequantize(jq, jqp))
    equal(taff.fake_quant(_t(x), tqp), jaff.fake_quant(jnp.asarray(x), jqp))
    for a, b in zip(taff.range_of(_t(x), axis), jaff.range_of(jnp.asarray(x), axis)):
        equal(a, b)
    w = jaff.weight_qparams(jnp.asarray(x), bits=bits, channel_axis=axis)
    equal(taff.weight_qparams(_t(x), bits=bits, channel_axis=axis).scale, w.scale)
    amax = np.abs(x).max(axis=(0, 1)).astype(np.float32)
    js = jaff.symmetric_qparams_from_amax(jnp.asarray(amax), bits)
    ts = taff.symmetric_qparams_from_amax(_t(amax), bits)
    equal(ts.scale, js.scale)
    equal(ts.zero_point, js.zero_point)


# ------------------------------------------------------------------ surrogate


@pytest.mark.parametrize("per_channel", [False, True])
def test_weight_stats_and_empirical_moments(per_channel):
    rng = np.random.default_rng(1)
    k = (0.2 * rng.standard_normal((3, 3, 4, 5)) + 0.03).astype(np.float32)
    jw = jsur.weight_stats(jnp.asarray(k), (0, 1, 2), per_channel)
    tw = tsur.weight_stats(_t(k), (0, 1, 2), per_channel)
    assert tw.fan_in == jw.fan_in == 36
    close(tw.mu, jw.mu)
    close(tw.var, jw.var)
    y = rng.standard_normal((3, 6, 6, 5)).astype(np.float32) + 1.0
    je, te = jsur.empirical_moments(jnp.asarray(y), per_channel), tsur.empirical_moments(
        _t(y), per_channel)
    close(te.mean, je.mean)
    close(te.var, je.var)
    close(te.std, je.std)


@pytest.mark.parametrize("per_channel", [False, True])
@pytest.mark.parametrize("gamma", [1, 2])
@pytest.mark.parametrize("shape", [(5, 16), (3, 7, 16), (2, 4, 5, 16)])
def test_linear_moments_matches_jax(shape, gamma, per_channel):
    rng = np.random.default_rng(len(shape) * 10 + gamma)
    x = (rng.standard_normal(shape) + 0.2).astype(np.float32)
    w = (0.1 * rng.standard_normal((16, 9)) + 0.01).astype(np.float32)
    jm = jsur.linear_moments(jnp.asarray(x), jsur.weight_stats(jnp.asarray(w), (0,), per_channel),
                             per_channel, gamma)
    tm = tsur.linear_moments(_t(x), tsur.weight_stats(_t(w), (0,), per_channel),
                             per_channel, gamma)
    close(tm.mean, jm.mean)
    close(tm.var, jm.var)


@pytest.mark.parametrize("res", [12, 13])
@pytest.mark.parametrize("gamma", [1, 2, 4])
@pytest.mark.parametrize("stride", [1, 2])
def test_conv_surrogates_match_jax(stride, gamma, res):
    """conv_window_sums, conv_moments and depthwise_conv_moments under SAME
    (and VALID) padding; at an odd resolution and gamma > 1 the SAME pad is
    uneven or clamped to 0."""
    rng = np.random.default_rng(100 * stride + 10 * gamma + res)
    x = (rng.standard_normal((2, res, res, 6)) + 0.3).astype(np.float32)
    k = (0.2 * rng.standard_normal((3, 3, 6, 4)) + 0.02).astype(np.float32)
    kd = (0.2 * rng.standard_normal((3, 3, 1, 6)) + 0.02).astype(np.float32)
    st = (stride, stride)
    for padding in ("SAME", "VALID"):
        js = jsur.conv_window_sums(jnp.asarray(x), (3, 3), st, padding, gamma)
        ts = tsur.conv_window_sums(_t(x), (3, 3), st, padding, gamma)
        close(ts[0], js[0])
        close(ts[1], js[1])
        for pc in (False, True):
            jm = jsur.conv_moments(jnp.asarray(x), jsur.weight_stats(jnp.asarray(k), (0, 1, 2), pc),
                                   (3, 3), st, padding, pc, gamma)
            tm = tsur.conv_moments(_t(x), tsur.weight_stats(_t(k), (0, 1, 2), pc),
                                   (3, 3), st, padding, pc, gamma)
            close(tm.mean, jm.mean)
            close(tm.var, jm.var)
            jd = jsur.depthwise_conv_moments(
                jnp.asarray(x), jsur.weight_stats(jnp.asarray(kd), (0, 1, 2), pc),
                (3, 3), st, padding, pc, gamma)
            td = tsur.depthwise_conv_moments(
                _t(x), tsur.weight_stats(_t(kd), (0, 1, 2), pc), (3, 3), st, padding, pc, gamma)
            close(td.mean, jd.mean)
            close(td.var, jd.var)


@pytest.mark.parametrize("n,k,s", [(20, 3, 2), (20, 3, 4), (13, 3, 2), (12, 1, 2),
                                   (13, 3, 8), (7, 5, 1), (1, 3, 2)])
def test_same_pad_is_xla_rule(n, k, s):
    """An all-ones window sum under the port's SAME pad counts the real
    positions that XLA's SAME conv covers."""
    x = np.ones((1, n, n, 1), np.float32)
    js, _ = jsur.conv_window_sums(jnp.asarray(x), (k, k), (s, s), "SAME")
    ts, _ = tsur.conv_window_sums(_t(x), (k, k), (s, s), "SAME")
    equal(ts, js)
    lo, hi = tsur.same_pad(n, k, s)
    assert lo + hi == max((-(-n // s) - 1) * s + k - n, 0) and hi - lo in (0, 1)


def test_pad2d_rejects_unknown_padding():
    with pytest.raises(ValueError):
        tsur.pad2d(torch.zeros(1, 1, 4, 4), (3, 3), (1, 1), "CIRCULAR")


# ------------------------------------------------------------------ interval


@pytest.mark.parametrize("per_channel", [False, True])
def test_interval_matches_jax(per_channel):
    rng = np.random.default_rng(7)
    u = rng.standard_normal((4000, 5)) * np.array([1, 2, 0.5, 3, 1]) + 0.1
    axis = 1 if per_channel else None
    jip = jint.calibrate_alpha_beta(u, 0.999, channel_axis=axis)
    tip = tint.calibrate_alpha_beta(u, 0.999, channel_axis=axis)
    equal(tip.alpha, jip.alpha)
    equal(tip.beta, jip.beta)
    jg = jint.grid_search_alpha_beta(u[:, 0], 0.99)
    tg = tint.grid_search_alpha_beta(u[:, 0], 0.99)
    equal(tg.alpha, jg.alpha)
    equal(tg.beta, jg.beta)
    shape = (6, 5) if per_channel else (6,)
    mean = rng.standard_normal(shape).astype(np.float32)
    var = np.abs(rng.standard_normal(shape)).astype(np.float32)
    var[0] = 0.0                                  # the sigma floor
    jm, tm = jsur.Moments(jnp.asarray(mean), jnp.asarray(var)), tsur.Moments(_t(mean), _t(var))
    for a, b in zip(tint.interval(tm, tip), jint.interval(jm, jip)):
        equal(a, b)
    jqp = jint.qparams_from_interval(jm, jip)
    tqp = tint.qparams_from_interval(tm, tip)
    equal(tqp.scale, jqp.scale)
    equal(tqp.zero_point, jqp.zero_point)
    y = rng.standard_normal((6, 3, 5) if per_channel else (6, 3)).astype(np.float32)
    lo, hi = jint.interval(jm, jip)
    lo, hi = np.asarray(lo), np.asarray(hi)
    lo, hi = (lo[:, None], hi[:, None])
    equal(tint.coverage(_t(y), _t(lo), _t(hi)),
          jint.coverage(jnp.asarray(y), jnp.asarray(lo), jnp.asarray(hi)))


# ------------------------------------------------------------------ policy


def test_policy_resolve_matches_jax():
    def spec(pol):
        return pol.QuantSpec(
            default=pol.QuantPolicy(mode="pdq", gamma=2),
            overrides=(("^fc", pol.QuantPolicy(mode="static", per_channel=False)),
                       ("ir[0-9]/dw", pol.QuantPolicy(mode="dynamic", bits=6)),
                       ("dw", pol.QuantPolicy(mode="static"))),
            skip=("^stem$", "head"))

    js, ts = spec(jpol), spec(tpol)
    for name in ("stem", "stem2", "fc", "fc_b", "ir1/dw", "x/dw", "head", "b1a", "input"):
        for jj, tt in ((js, ts), (jpol.as_observe(js), tpol.as_observe(ts)),
                       (jpol.FP32, tpol.FP32)):
            assert (dataclasses.asdict(tt.resolve(name))
                    == dataclasses.asdict(jj.resolve(name))), name
    kw = dict(per_channel=False, gamma=4, skip=("a",))
    for mode in MODES:
        assert (dataclasses.asdict(tpol.spec_for_mode(mode, **kw))
                == dataclasses.asdict(jpol.spec_for_mode(mode, **kw)))
    assert tcore.__all__ == jcore.__all__
