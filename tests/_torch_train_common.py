"""Shared helpers of the train-mode tests: the same reduced config, numpy
params and ``SyntheticLM`` batch through the JAX reference's
``train_loss`` / ``jax.value_and_grad`` and the port's
``train_step.loss_and_grads``.

Tolerances (float32 on the CPU): the loss (xent + 0.01 aux) and the aux
within 1e-5 relative; every grad leaf within 1e-4 relative and 1e-4 of the
leaf's largest |grad| absolute (measured: <= 1.4e-5 of it, the SSD's
A_log the largest).
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import reduced_config as j_reduced
from repro.data.pipeline import DataConfig, SyntheticLM
from repro.models import build_model as j_build

from repro_torch.bridge import params_from_numpy, params_to_numpy
from repro_torch.configs import reduced_config as t_reduced
from repro_torch.models import build_model as t_build
from repro_torch.train.train_step import loss_and_grads

LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4
B, S = 2, 40


def batch_for(cfg, step=0, batch=B, seq=S):
    """A SyntheticLM batch, with seeded stub patches / frames where the
    config needs them (numpy)."""
    d = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=seq, batch=batch)).batch_at(step)
    rng = np.random.default_rng(step + 1)
    if cfg.frontend == "vision":
        d["patches"] = (0.02 * rng.standard_normal((batch, cfg.frontend_tokens, cfg.d_model))
                        ).astype(np.float32)
    if cfg.family == "encdec":
        d["frames"] = (0.02 * rng.standard_normal((batch, 8, cfg.d_model))).astype(np.float32)
    return d


def both(arch, **overrides):
    """(jcfg, tcfg, jbundle, tbundle, reference params as numpy)."""
    jc, tc = j_reduced(arch, **overrides), t_reduced(arch, **overrides)
    jb, tb = j_build(jc), t_build(tc, "cpu")
    p = jax.tree.map(np.asarray, jb.init(jax.random.PRNGKey(0)))
    return jc, tc, jb, tb, p


def check_loss_and_grads(arch, **overrides):
    jc, tc, jb, tb, p = both(arch, **overrides)
    d = batch_for(jc)
    (jl, jm), jg = jax.value_and_grad(jb.train_loss, has_aux=True)(
        jax.tree.map(jnp.asarray, p), {k: jnp.asarray(v) for k, v in d.items()})
    tl, tm, tg = loss_and_grads(tb, params_from_numpy(p, "cpu"),
                                {k: torch.from_numpy(v) for k, v in d.items()})
    np.testing.assert_allclose(float(tl), float(jl), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(tm["aux"]), float(jm["aux"]), rtol=LOSS_RTOL, atol=1e-7)
    np.testing.assert_allclose(float(tm["xent"]), float(jm["xent"]), rtol=LOSS_RTOL)
    got = params_to_numpy(tg, tc)
    want = jax.tree.map(np.asarray, jg)
    assert jax.tree.structure(got) == jax.tree.structure(want)

    def close(path, a, b):
        np.testing.assert_allclose(a, b, rtol=GRAD_TOL, atol=GRAD_TOL * np.abs(b).max(),
                                   err_msg=jax.tree_util.keystr(path))
    jax.tree_util.tree_map_with_path(close, got, want)
    return float(tl)
