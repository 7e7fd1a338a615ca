"""The port's examples (``examples/torch_*.py``) run on the CPU at small
sizes (``--device cpu``; every one defaults to the card), each against
its JAX twin where the two compute the same thing:

  * torch_quickstart: its static, dynamic and PDQ relative errors equal
    those of ``examples/quickstart.py``'s ``model`` on the same numpy
    params and inputs, within 1e-5 relative;
  * torch_serve_lm: on reduced yi-6b's reference weights (through
    ``bridge.params_from_numpy``) its fp engine's greedy streams equal the
    reference ServeEngine's on the same prompts, slots and max_len;
  * torch_train_lm and torch_quantize_cnn: the loss falls (the train
    example's history; the CNN example's fp32 eval loss before and after
    training), and the CNN example prints every mode's accuracy.
"""
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import reduced_config as j_reduced
from repro.core import run_calibration as j_calibrate
from repro.core import spec_for_mode as j_spec
from repro.models import build_model as j_build
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JServeEngine
from repro_torch.bridge import params_from_numpy

torch.set_num_threads(1)

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"


def _load(name):
    spec = importlib.util.spec_from_file_location(f"_example_{name}", EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_torch_quickstart_matches_the_jax_quickstart(capsys):
    ex, jex = _load("torch_quickstart"), _load("quickstart")
    rng = np.random.default_rng(0)
    params = (0.1 * rng.standard_normal((256, 512)).astype(np.float32),
              0.1 * rng.standard_normal((512, 64)).astype(np.float32))
    calib = [rng.standard_normal((8, 256)).astype(np.float32) for _ in range(2)]
    x = 5.0 * rng.standard_normal((32, 256)).astype(np.float32)

    jp = tuple(jnp.asarray(p) for p in params)
    spec = j_spec("pdq", per_channel=True)
    qstate = j_calibrate(jex.model, jp, [jnp.asarray(c) for c in calib], spec)
    ref = jex.model(jp, jnp.asarray(x), spec=j_spec("none"), qstate={})
    want = {m: float(jnp.abs(jex.model(jp, jnp.asarray(x), spec=j_spec(m, per_channel=True),
                                       qstate=qstate) - ref).mean() / jnp.abs(ref).mean())
            for m in ("static", "dynamic", "pdq")}
    got = ex.rel_errors(tuple(torch.from_numpy(p) for p in params),
                        [torch.from_numpy(c) for c in calib], torch.from_numpy(x))
    assert list(got) == list(want)
    np.testing.assert_allclose(list(got.values()), list(want.values()), rtol=1e-5)
    errs = ex.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert all(f"{m:8s} rel-err under 5x input shift: {e:.4f}" in out for m, e in errs.items())


def test_torch_serve_lm_fp_streams_equal_the_reference_engine(capsys):
    ex = _load("torch_serve_lm")
    jcfg = j_reduced("yi-6b")
    jp = j_build(jcfg).init(jax.random.PRNGKey(0))
    got = ex.main(["--device", "cpu"],
                  params=params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu"))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, jcfg.vocab, 8) for _ in range(6)]
    reqs = [JRequest(uid=i, prompt=p, max_new=12) for i, p in enumerate(prompts)]
    JServeEngine(jcfg, jp, slots=3, max_len=64).run(reqs)
    assert got["fp"] == [tuple(int(t) for t in r.generated) for r in reqs]
    assert all(len(s) == 12 for s in got["pdq-int8"])
    out = capsys.readouterr().out
    assert "fp       : 72 tokens" in out and "pdq-int8 : 72 tokens" in out


def test_torch_train_lm_loss_falls(tmp_path, capsys):
    ex = _load("torch_train_lm")
    out = ex.main(["--device", "cpu", "--steps", "8", "--batch", "2", "--seq", "16",
                   "--log-every", "2", "--ckpt-dir", str(tmp_path)])
    losses = [r["loss"] for r in out["history"]]
    assert len(losses) == 4 and losses[-1] < losses[0]
    assert "gpt-20m: loss" in capsys.readouterr().out


def test_torch_quantize_cnn_loss_falls(capsys):
    ex = _load("torch_quantize_cnn")
    out = ex.main(["--device", "cpu", "--steps", "20", "--batch", "16", "--eval", "32"])
    before, after = out["loss"]
    assert after < before
    text = capsys.readouterr().out
    for domain in ("in-domain", "corrupted"):
        for mode in ("none", "static", "dynamic", "pdq"):
            assert 0.0 <= out[(domain, mode)] <= 1.0
            assert f"  {mode:8s} top-1 = {out[(domain, mode)]:.4f}" in text
