"""The port's Mini-ResNet (``repro_torch.models.cnn.cnn_apply``) and its
calibration (``repro_torch.core.run_calibration``) against the JAX
package's, at width 8 and res 12 and 13, with the reference's weights
carried across (``bridge.cnn_params_from_numpy``).  The helpers here serve
the other two archs' files too (``tests/test_torch_cnn_mobilenet.py``,
``tests/test_torch_cnn_seg.py``): one file an arch, so that the workers
share the reference's eager calibrations.

The odd res takes the stride-2 layers through XLA's uneven SAME padding and
the segmentation decoder through a nearest resize from 7 to 13.

Tolerances:
- ``none`` and ``observe`` logits, tapes and moments within rtol 1e-5
  (atol 1e-6 of the largest |logit|; a predicted mean also within 1e-5 of
  the predicted std, ``test_torch_core.close_moments``): convolutions and
  sums reduce in another order.
- dynamic / static / pdq logits, on the reference's calibrated state,
  within 2% of the largest |logit|: a pre-activation at a .5 tie can take
  the neighbouring code, which moves every later layer's input by one step
  of that layer's grid (measured up to 0.7%).
- ``run_calibration`` on the same weights and batch: every ``qstate`` entry
  within 1e-5 relative.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import run_calibration as jcalibrate
from repro.core import spec_for_mode as jspec
from repro.models import cnn as jc
from repro_torch.bridge import cnn_params_from_numpy
from repro_torch.core import run_calibration as tcalibrate
from repro_torch.core import spec_for_mode as tspec
from repro_torch.models import cnn as tc
from tests.test_torch_core import close, close_moments

torch.set_num_threads(1)

RESES = (12, 13)
MODES = ("none", "observe", "dynamic", "static", "pdq")
QUANT_TOL = 0.02
ARCH = "mini_resnet"


def _apply_fn(mod, cfg):
    def apply_fn(params, batch, *, spec, qstate, tape=None):
        return mod.cnn_apply(params, batch, cfg=cfg, spec=spec, qstate=qstate, tape=tape)
    return apply_fn


def _jax_apply_fn(cfg):
    """The reference's ``cnn_apply`` under ``jax.jit`` (one compile a spec,
    as the reference's benchmarks run it), its tape returned as an output:
    the same apply signature as ``_apply_fn``."""
    kinds = {}

    @functools.partial(jax.jit, static_argnames="spec")
    def run(params, batch, qstate, spec):
        tape = {}
        out = jc.cnn_apply(params, batch, cfg=cfg, spec=spec, qstate=qstate, tape=tape)
        kinds.update((k, v["kind"]) for k, v in tape.items())   # at trace time
        return out, {k: (v["y"], v["moments"]) for k, v in tape.items()}

    def apply_fn(params, batch, *, spec, qstate, tape=None):
        out, t = run(params, batch, qstate or {}, spec)
        if tape is not None:
            tape.update((k, {"kind": kinds[k], "y": y, "moments": m})
                        for k, (y, m) in t.items())
        return out
    return apply_fn


def build_nets(arch, seed):
    """Per res: configs, the reference's weights on both sides, four eval
    images, and both sides' calibration state (four calibration images)
    per granularity."""
    out = {}
    for res in RESES:
        jcfg = jc.CNNConfig(arch=arch, width=8, res=res, n_classes=6)
        tcfg = tc.CNNConfig(arch=arch, width=8, res=res, n_classes=6)
        jp = jc.cnn_init(jax.random.PRNGKey(seed), jcfg)
        tp = cnn_params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
        calib, _ = jc.make_gratings(5, 4, res=res, n_classes=6, noise=0.45)
        imgs, _ = jc.make_gratings(77, 4, res=res, n_classes=6, noise=0.45)
        qstates = {}
        for pc in (False, True):
            jq = jcalibrate(_jax_apply_fn(jcfg), jp, [jnp.asarray(calib)],
                            jspec("pdq", per_channel=pc))
            tq = tcalibrate(_apply_fn(tc, tcfg), tp, [torch.from_numpy(calib)],
                            tspec("pdq", per_channel=pc))
            qstates[pc] = (jq, tq)
        out[res] = dict(arch=arch, jcfg=jcfg, tcfg=tcfg, jp=jp, tp=tp, imgs=imgs,
                        qstates=qstates, japply=_jax_apply_fn(jcfg))
    return out


def check_calibrate(n, per_channel):
    jq, tq = n["qstates"][per_channel]
    assert sorted(tq) == sorted(jq)
    for name in jq:
        assert sorted(tq[name]) == sorted(jq[name]), name
        for key in jq[name]:
            close(tq[name][key], jq[name][key])


def check_apply(n, per_channel, mode):
    """The port's logits and tape against the reference's, both on the
    reference's calibrated state."""
    jq = n["qstates"][per_channel][0]
    tq = {k: {kk: torch.from_numpy(np.array(vv)) for kk, vv in v.items()}
          for k, v in jq.items()}
    jtape, ttape = {}, {}
    a = np.asarray(n["japply"](n["jp"], jnp.asarray(n["imgs"]),
                               spec=jspec(mode, per_channel=per_channel), qstate=jq,
                               tape=jtape))
    b = tc.cnn_apply(n["tp"], torch.from_numpy(n["imgs"]), cfg=n["tcfg"],
                     spec=tspec(mode, per_channel=per_channel), qstate=tq, tape=ttape).numpy()
    res = n["jcfg"].res
    assert b.shape == a.shape == ((4, res, res, 6) if n["arch"] == "mini_seg" else (4, 6))
    assert sorted(ttape) == sorted(jtape)
    if mode in ("none", "observe"):
        close(b, a)
        for name, rec in jtape.items():
            assert ttape[name]["kind"] == rec["kind"]
            close(ttape[name]["y"], rec["y"])
            assert (ttape[name]["moments"] is None) == (rec["moments"] is None)
            if rec["moments"] is not None:
                close_moments(ttape[name]["moments"], rec["moments"])
    else:
        np.testing.assert_allclose(b, a, rtol=0, atol=QUANT_TOL * float(np.abs(a).max()))


@pytest.fixture(scope="module")
def nets():
    return build_nets(ARCH, 0)


@pytest.mark.parametrize("per_channel", [False, True])
@pytest.mark.parametrize("res", RESES)
def test_calibrate_matches_jax(nets, res, per_channel):
    check_calibrate(nets[res], per_channel)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("per_channel", [False, True])
@pytest.mark.parametrize("res", RESES)
def test_cnn_apply_matches_jax(nets, res, per_channel, mode):
    check_apply(nets[res], per_channel, mode)
