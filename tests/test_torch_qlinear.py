"""The port's quantized layers and calibration loop
(``repro_torch.core.qlinear``, ``repro_torch.core.calibrate``) against the
JAX package's, on the same numpy inputs made from a seed.

Tolerances:
- fp (``none``) and ``observe`` outputs, tapes and moments within rtol 1e-5
  (atol 1e-6 of the largest magnitude): the convolutions and the moment
  sums reduce in another order than XLA's.
- quantized modes (dynamic, static, pdq) on the reference's own grid:
  every code within one step and >= 99.9% of codes equal (a sum in another
  order moves a pre-activation at a .5 tie to the neighbouring code).
- ``run_calibration``: every ``qstate`` entry within 1e-5 relative; the
  calibrated two-layer model under every mode within 2% of its largest
  |output| (one code flipped at a tie in the first layer moves the second
  layer's input by one step of its grid).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import affine as jaff
from repro.core import interval as jint
from repro.core import policy as jpol
from repro.core import qlinear as jql
from repro.core import run_calibration as jcalibrate
from repro.core import surrogate as jsur
from repro_torch import core as tcore
from repro_torch.core import policy as tpol
from repro_torch.core import qlinear as tql
from repro_torch.core import surrogate as tsur
from tests.test_torch_core import MODES, _np, _t, close, equal

torch.set_num_threads(1)


# ------------------------------------------------------------------ qlinear


def _ref_step(mode, per_channel, y_pre, moments, state, bits=8):
    """The reference's grid step for a quantized output (its own scale)."""
    pol = jpol.QuantPolicy(mode=mode, per_channel=per_channel, bits=bits)
    if mode == "dynamic":
        lo, hi = jql._example_range(y_pre, per_channel)
        return jaff.qparams_from_range(lo, hi, bits).scale
    if mode == "static":
        return jaff.qparams_from_range(state["static_lo"], state["static_hi"], bits).scale
    ip = jint.IntervalParams(state["alpha"], state["beta"])
    qp = jql._broadcast_qp(jint.qparams_from_interval(moments, ip, bits), y_pre.ndim,
                           pol.per_channel)
    return qp.scale


def check_quantized(t_out, j_out, step):
    """Both outputs on the reference's grid: codes within one step, >= 99.9%
    equal."""
    step = np.asarray(step)
    jc = np.round(np.asarray(j_out) / step)
    tc = np.round(_np(t_out) / step)
    diff = np.abs(jc - tc)
    assert diff.max() <= 1, diff.max()
    assert (diff == 0).mean() >= 0.999, (diff == 0).mean()


def _state(rng, name, y_shape, per_channel, with_interval=True):
    c = y_shape[-1] if per_channel else None
    shape = (c,) if c else ()
    lo = (-np.abs(rng.standard_normal(shape)) * 2).astype(np.float32)
    hi = (np.abs(rng.standard_normal(shape)) * 2).astype(np.float32)
    st = {"static_lo": lo, "static_hi": hi}
    if with_interval:
        st["alpha"] = (3 + rng.random(shape)).astype(np.float32)
        st["beta"] = (3 + rng.random(shape)).astype(np.float32)
    return ({name: {k: jnp.asarray(v) for k, v in st.items()}},
            {name: {k: _t(v) for k, v in st.items()}})


def _compare_layer(mode, per_channel, run_j, run_t, y_shape, seed):
    rng = np.random.default_rng(seed)
    js, ts = _state(rng, "L", y_shape, per_channel)
    jpol_, tpol_ = (jpol.QuantPolicy(mode=mode, per_channel=per_channel),
                    tpol.QuantPolicy(mode=mode, per_channel=per_channel))
    jtape, ttape = {}, {}
    j_out = run_j(jpol_, js, jtape)
    t_out = run_t(tpol_, ts, ttape)
    if mode == "none":
        assert not jtape and not ttape
        close(t_out, j_out)
        return
    assert ttape["L"]["kind"] == jtape["L"]["kind"]
    close(ttape["L"]["y"], jtape["L"]["y"])
    jm, tm = jtape["L"]["moments"], ttape["L"]["moments"]
    assert (jm is None) == (tm is None)
    if jm is not None:
        close(tm.mean, jm.mean)
        close(tm.var, jm.var)
    if mode == "observe":
        close(t_out, j_out)
    else:
        check_quantized(t_out, j_out, _ref_step(mode, per_channel, jtape["L"]["y"], jm, js["L"]))


@pytest.mark.parametrize("per_channel", [False, True])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("case", ["rows", "positions", "bias"])
def test_dense_matches_jax(case, mode, per_channel):
    rng = np.random.default_rng(3)
    shape = {"rows": (64, 24), "positions": (4, 16, 24), "bias": (64, 24)}[case]
    x = (rng.standard_normal(shape) + 0.1).astype(np.float32)
    w = (0.2 * rng.standard_normal((24, 12)) + 0.01).astype(np.float32)
    b = (0.3 * rng.standard_normal(12)).astype(np.float32) if case == "bias" else None
    jb = None if b is None else jnp.asarray(b)
    tb = None if b is None else _t(b)
    _compare_layer(
        mode, per_channel,
        lambda pol, st, tape: jql.dense(jnp.asarray(x), jnp.asarray(w), jb, name="L",
                                        policy=pol, state=st, tape=tape),
        lambda pol, st, tape: tql.dense(_t(x), _t(w), tb, name="L", policy=pol, state=st,
                                        tape=tape),
        shape[:-1] + (12,), 11)


CONV_CASES = {
    # name: (res, c_in, kernel (kh, kw, c_in / groups, c_out), stride, groups, bias)
    "3x3": (12, 6, (3, 3, 6, 8), 1, 1, False),
    "3x3_s2_odd": (13, 6, (3, 3, 6, 8), 2, 1, True),
    "1x1": (12, 6, (1, 1, 6, 10), 1, 1, False),
    "depthwise_s2": (13, 8, (3, 3, 1, 8), 2, 8, False),
    "grouped": (12, 8, (3, 3, 4, 6), 1, 2, True),
}


@pytest.mark.parametrize("per_channel", [False, True])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("case", list(CONV_CASES))
def test_conv2d_matches_jax(case, mode, per_channel):
    res, cin, kshape, stride, groups, bias = CONV_CASES[case]
    rng = np.random.default_rng(5)
    x = (rng.standard_normal((3, res, res, cin)) + 0.2).astype(np.float32)
    k = (0.3 * rng.standard_normal(kshape) + 0.02).astype(np.float32)
    b = (0.3 * rng.standard_normal(kshape[-1])).astype(np.float32) if bias else None
    jb = None if b is None else jnp.asarray(b)
    tb = None if b is None else _t(b)
    out = -(-res // stride)
    kw = dict(stride=(stride, stride), padding="SAME", feature_group_count=groups, name="L")
    _compare_layer(
        mode, per_channel,
        lambda pol, st, tape: jql.conv2d(jnp.asarray(x), jnp.asarray(k), jb, policy=pol,
                                         state=st, tape=tape, **kw),
        lambda pol, st, tape: tql.conv2d(_t(x), _t(k), tb, policy=pol, state=st, tape=tape,
                                         **kw),
        (3, out, out, kshape[-1]), 13)


@pytest.mark.parametrize("mode", MODES)
def test_quantize_input_matches_jax(mode):
    rng = np.random.default_rng(9)
    x = rng.random((3, 5, 5, 3)).astype(np.float32)
    st = {"static_lo": np.float32(0.1), "static_hi": np.float32(0.8)}
    jst = {"input": {k: jnp.asarray(v) for k, v in st.items()}}
    tst = {"input": {k: _t(v) for k, v in st.items()}}
    for jstate, tstate in ((jst, tst), (None, None), ({}, {})):
        jtape, ttape = {}, {}
        jp, tp = jpol.QuantPolicy(mode=mode), tpol.QuantPolicy(mode=mode)
        j_out = jql.quantize_input(jnp.asarray(x), policy=jp, state=jstate, tape=jtape)
        t_out = tql.quantize_input(_t(x), policy=tp, state=tstate, tape=ttape)
        equal(t_out, j_out)
        assert list(ttape) == list(jtape)
        if jtape:
            assert ttape["input"]["kind"] == "input" and ttape["input"]["moments"] is None
            equal(ttape["input"]["y"], jtape["input"]["y"])


def test_bias_adjust_and_output_quantize_reject_unknown_mode():
    rng = np.random.default_rng(2)
    m = rng.standard_normal((4,)).astype(np.float32)
    v = np.abs(rng.standard_normal((4,))).astype(np.float32)
    b = rng.standard_normal((7,)).astype(np.float32)
    jm = jql.bias_adjust(jsur.Moments(jnp.asarray(m), jnp.asarray(v)), jnp.asarray(b), False)
    tm = tql.bias_adjust(tsur.Moments(_t(m), _t(v)), _t(b), False)
    close(tm.mean, jm.mean)
    close(tm.var, jm.var)
    with pytest.raises(ValueError):
        tql.output_quantize(_t(m), tpol.QuantPolicy(mode="int4"), {}, None)


# ------------------------------------------------------------------ calibrate


def _j_apply(params, batch, *, spec, qstate, tape=None):
    k, w, b = params
    h = jql.quantize_input(batch, policy=spec.resolve("input"), state=qstate, tape=tape)
    h = jax.nn.relu(jql.conv2d(h, k, None, stride=(2, 2), name="conv",
                               policy=spec.resolve("conv"), state=qstate, tape=tape))
    return jql.dense(h, w, b, name="fc", policy=spec.resolve("fc"), state=qstate, tape=tape)


def _t_apply(params, batch, *, spec, qstate, tape=None):
    k, w, b = params
    h = tql.quantize_input(batch, policy=spec.resolve("input"), state=qstate, tape=tape)
    h = torch.relu(tql.conv2d(h, k, None, stride=(2, 2), name="conv",
                              policy=spec.resolve("conv"), state=qstate, tape=tape))
    return tql.dense(h, w, b, name="fc", policy=spec.resolve("fc"), state=qstate, tape=tape)


@pytest.mark.parametrize("gamma", [1, 2])
@pytest.mark.parametrize("per_channel", [False, True])
def test_calibrate_matches_jax(per_channel, gamma):
    """run_calibration on the same weights and batches: every entry of the
    state within 1e-5 relative, on the device the model ran on; then every
    mode on that state."""
    rng = np.random.default_rng(21)
    params = [(0.3 * rng.standard_normal((3, 3, 3, 8)) + 0.02).astype(np.float32),
              (0.2 * rng.standard_normal((8, 5))).astype(np.float32),
              (0.1 * rng.standard_normal(5)).astype(np.float32)]
    batches = [rng.random((4, 9, 9, 3)).astype(np.float32) for _ in range(3)]
    skip = ("^fc$",) if gamma == 2 else ()
    jspec = jpol.spec_for_mode("pdq", per_channel=per_channel, gamma=gamma, skip=skip)
    tspec = tpol.spec_for_mode("pdq", per_channel=per_channel, gamma=gamma, skip=skip)
    jq = jcalibrate(_j_apply, [jnp.asarray(p) for p in params],
                    [jnp.asarray(b) for b in batches], jspec)
    tq = tcore.run_calibration(_t_apply, [_t(p) for p in params], [_t(b) for b in batches],
                               tspec)
    assert sorted(tq) == sorted(jq)
    for name in jq:
        assert sorted(tq[name]) == sorted(jq[name]), name
        for key in jq[name]:
            assert tq[name][key].device.type == "cpu"
            close(tq[name][key], jq[name][key])
    x = rng.random((6, 9, 9, 3)).astype(np.float32)
    for mode in MODES:
        js = jpol.spec_for_mode(mode, per_channel=per_channel, gamma=gamma, skip=skip)
        ts = tpol.spec_for_mode(mode, per_channel=per_channel, gamma=gamma, skip=skip)
        a = _j_apply([jnp.asarray(p) for p in params], jnp.asarray(x), spec=js, qstate=jq)
        b = _t_apply([_t(p) for p in params], _t(x), spec=ts, qstate=tq)
        np.testing.assert_allclose(_np(b), np.asarray(a), rtol=0,
                                   atol=0.02 * float(np.abs(np.asarray(a)).max()))
