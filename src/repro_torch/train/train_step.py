"""The train step (port of ``repro/train/train_step.py``, one device).

``build_train_step(bundle, opt_cfg)`` returns ``step(state, batch) ->
(state, metrics)``: eager torch and autograd over ``bundle.train_loss``,
then AdamW (``optim/adamw.py``).  The state is ``{"params", "opt"}``; the
batch comes in as numpy arrays (``tokens``, ``labels``, and a vision
config's ``patches`` or an encoder-decoder's ``frames``) and goes to the
bundle's device.  With ``microbatch`` the batch splits along its rows and
the microbatches' grads accumulate in float32 and are divided by their
count, as the reference's scan does.  The step is functional: it returns
new params and a new optimizer state and leaves the old ones as they were.

A ``mesh`` - the reference's sharded step over a device mesh - is ROADMAP.md
Queue 1 item 8b, and refuses.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from repro_torch import tree as tr
from repro_torch.kernels.ref import true_div
from repro_torch.models.context import not_ported
from repro_torch.models.layers import MetaGenerator
from repro_torch.models.transformer import lm_init
from repro_torch.optim import adamw, schedule


def make_state(bundle, opt_cfg: adamw.AdamWConfig, seed: int = 0):
    params = bundle.init(seed)
    return {"params": params, "opt": adamw.init(params, opt_cfg)}


def abstract_state(bundle, opt_cfg: adamw.AdamWConfig):
    """The state's shapes and dtypes on the ``meta`` device, allocating
    nothing (a checkpoint's restore template)."""
    params = lm_init(MetaGenerator(), bundle.cfg)
    return {"params": params, "opt": adamw.init(params, opt_cfg)}


def loss_and_grads(bundle, params, batch):
    """(loss, metrics, grads): the grads of ``bundle.train_loss`` with
    respect to every param leaf, in the param's dtype (zeros for a leaf the
    batch does not reach, as ``jax.grad`` gives)."""
    xs = tr.tree_map(lambda p: p.detach().requires_grad_(True), params)
    leaves = tr.leaves(xs)
    loss, metrics = bundle.train_loss(xs, batch)
    gs = torch.autograd.grad(loss, leaves, allow_unused=True)
    gs = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, gs)]
    metrics = {k: v.detach() for k, v in metrics.items()}
    return loss.detach(), metrics, tr.unflatten_like(params, gs)


def to_device(batch, device) -> dict:
    """A batch of numpy arrays (or tensors) as tensors on ``device``."""
    return {k: torch.as_tensor(np.asarray(v) if not torch.is_tensor(v) else v).to(device)
            for k, v in batch.items()}


def build_train_step(bundle, opt_cfg: adamw.AdamWConfig, mesh=None, *,
                     lr_schedule: Callable | None = None, microbatch: int | None = None):
    """Returns ``step_fn(state, batch) -> (state, metrics)`` with ``loss``,
    ``xent``, ``aux``, ``grad_norm`` and ``lr_scale`` (0-dim device
    tensors) in the metrics.  The schedule defaults to the reference's
    ``warmup_cosine``."""
    if mesh is not None:
        raise not_ported("the sharded train step (mesh=...)", "8b")
    sched = lr_schedule or (lambda s: schedule.warmup_cosine(s))

    def step_fn(state, batch):
        batch = to_device(batch, bundle.device)
        params = state["params"]
        if microbatch and microbatch > 1:
            acc = tr.tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                    device=p.device), params)
            losses, metricss = [], []
            for k in range(microbatch):
                sub = {n: x.reshape(microbatch, x.shape[0] // microbatch, *x.shape[1:])[k]
                       for n, x in batch.items()}
                loss, metrics, grads = loss_and_grads(bundle, params, sub)
                acc = tr.tree_map(lambda a, g: a + g, acc, grads)
                losses.append(loss)
                metricss.append(metrics)
            grads = tr.tree_map(lambda g: true_div(g, float(microbatch)), acc)
            loss = torch.stack(losses).mean()
            metrics = {k: torch.stack([m[k] for m in metricss]).mean() for k in metricss[0]}
        else:
            loss, metrics, grads = loss_and_grads(bundle, params, batch)
        lr_scale = sched(state["opt"].step)
        new_params, new_opt = adamw.apply_updates(params, grads, state["opt"], opt_cfg,
                                                  lr_scale)
        metrics = dict(metrics, loss=loss, grad_norm=adamw.global_norm(grads),
                       lr_scale=lr_scale)
        return {"params": new_params, "opt": new_opt}, metrics

    return step_fn
