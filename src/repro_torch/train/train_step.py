"""The train step (port of ``repro/train/train_step.py``).

``build_train_step(bundle, opt_cfg)`` returns ``step(state, batch) ->
(state, metrics)``: eager torch and autograd over ``bundle.train_loss``,
then AdamW (``optim/adamw.py``).  The state is ``{"params", "opt"}``; the
batch comes in as numpy arrays (``tokens``, ``labels``, and a vision
config's ``patches`` or an encoder-decoder's ``frames``) and goes to the
bundle's device.  With ``microbatch`` the batch splits along its rows and
the microbatches' grads accumulate in float32 and are divided by their
count, as the reference's scan does.  The step is functional: it returns
new params and a new optimizer state and leaves the old ones as they were.

With a ``mesh`` (``launch/mesh.make_host_mesh``: one process an entry) the
step is the reference's sharded step, computed per rank.  The reference
jits one program under GSPMD with the state laid out by ``state_specs``;
here each rank holds the block of every state leaf that ``state_specs``
gives its coordinates (``make_state(..., mesh=)``, ``distributed/fault.
reshard_state``) and runs:

  1. every param leaf gathered whole from the ranks' blocks (one
     all-gather over the mesh a dtype); under expert parallelism the
     routed experts' stacks stay this rank's E / M experts;
  2. loss and grads on the rank's rows of the (global) batch - rows go
     over the data axis (``batch_spec``), so the model ranks of one data
     index run the same dense compute;
  3. the grads summed over the data group and divided by D (the loss is a
     mean over equal row blocks); the router's grads are summed over the
     model group first, since each model rank routed only its own token
     block (``models/transformer._apply_ffn``);
  4. the global norm over the whole grads (the expert stacks' squares
     summed over the model group), and AdamW on the rank's blocks.  An
     int8 moment's block runs along the last axis: where the rank's codes
     cover another range of it than its param block, the rank updates the
     range its codes cover (gathering the codes of the whole last axis
     where its block of them would split one of its param's), and takes its
     param block from that.

A config with routed experts trains over a mesh of more than one entry
only under ``dist_context_for(mesh)`` (the launcher sets it): without it
the reference routes the global batch as one block, which no rank holds.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from repro_torch import tree as tr
from repro_torch.distributed import collectives as coll
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.fault import reshard_state
from repro_torch.kernels.ref import true_div
from repro_torch.models import context as mctx
from repro_torch.models.layers import MetaGenerator
from repro_torch.models.transformer import lm_init
from repro_torch.optim import adamw, schedule

_EXPERTS = ("we_gate", "we_up", "we_down")   # routed expert stacks (E, ., .)


def make_state(bundle, opt_cfg: adamw.AdamWConfig, seed: int = 0, mesh=None):
    """The state from ``bundle.init(seed)``; over a ``mesh``, this rank's
    blocks of it (the whole params are made and dropped; f32 moments are
    made as blocks)."""
    params = bundle.init(seed)
    if mesh is None:
        return {"params": params, "opt": adamw.init(params, opt_cfg)}
    specs = state_specs(abstract_state(bundle, opt_cfg), mesh)
    blocks = reshard_state(params, mesh, specs["params"])
    if not opt_cfg.quant_state:
        return {"params": blocks, "opt": adamw.init(blocks, opt_cfg)}
    # int8 moments: a leaf's codes block may cover another range than its
    # param block, so each leaf's zero codes are made whole and cut
    whole = {}

    def one(path, p):
        whole[path] = adamw.init({"x": p}, opt_cfg)
    tr.map_with_path(one, params)
    del params
    opt = specs["opt"]

    def side(name):
        def cut(path, spec):
            t = getattr(whole[path], name)["x"]
            return reshard_state(t, mesh, spec)
        return tr.map_with_path(cut, getattr(opt, name))
    step = reshard_state(next(iter(whole.values())).step, mesh, opt.step)
    return {"params": blocks, "opt": adamw.OptState(step, side("m"), side("v"),
                                                    side("m_scale"), side("v_scale"))}


def abstract_state(bundle, opt_cfg: adamw.AdamWConfig):
    """The state's shapes and dtypes on the ``meta`` device, allocating
    nothing (a checkpoint's restore template)."""
    params = lm_init(MetaGenerator(), bundle.cfg)
    return {"params": params, "opt": adamw.init(params, opt_cfg)}


def state_specs(state, mesh):
    """Partition specs of the train state: params by rule; f32 moments
    inherit the param specs; an int8 moment's codes (..., G, 64) and scales
    (..., G, 1) keep the param's leading entries and move its last dim's
    axis onto the block-group dim G where it divides G, else leave G
    whole."""
    pspecs = shd.param_specs(state["params"], mesh)

    def q8_spec(pspec, leaf):
        entries = list(pspec)
        last = entries[-1] if entries else None
        entries = entries[:-1]
        G = leaf.shape[-2] if leaf.dim() >= 2 else 1
        if last is not None and G % shd.axis_size(mesh, last) == 0:
            entries = entries + [last, None]
        entries += [None] * (leaf.dim() - len(entries))
        return shd.P(*entries[:leaf.dim()])

    opt = state["opt"]
    if opt.m_scale is None:
        mspec = vspec = pspecs
        ms_spec = vs_spec = None
    else:
        mspec = tr.tree_map(q8_spec, pspecs, opt.m)
        vspec = tr.tree_map(q8_spec, pspecs, opt.v)
        ms_spec = tr.tree_map(q8_spec, pspecs, opt.m_scale)
        vs_spec = tr.tree_map(q8_spec, pspecs, opt.v_scale)
    return {"params": pspecs, "opt": adamw.OptState(step=shd.P(), m=mspec, v=vspec,
                                                    m_scale=ms_spec, v_scale=vs_spec)}


def dist_context_for(mesh) -> mctx.DistContext:
    """The MoE expert-parallel context of ``mesh``, with this rank's groups
    (collective on the mesh's first use: ``launch/mesh.mesh_groups``)."""
    from repro_torch.launch.mesh import mesh_groups
    dp = shd.dp_axes(mesh)
    return mctx.DistContext(mesh=mesh, token_axes=dp + ("model",), expert_axis="model",
                            data_axes=dp, model_axis="model", groups=mesh_groups(mesh))


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
    ``warmup_cosine``.  Over a ``mesh`` the state is this rank's blocks,
    the batch the global one, and the metrics the global step's (every
    rank gets the same)."""
    sched = lr_schedule or (lambda s: schedule.warmup_cosine(s))
    if mesh is not None:
        return _MeshStep(bundle, opt_cfg, mesh, sched, microbatch)

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


class _MeshStep:
    """The sharded step of one rank (see the module docstring)."""

    def __init__(self, bundle, opt_cfg, mesh, sched, microbatch):
        from repro_torch.launch.mesh import mesh_groups
        self.bundle, self.opt_cfg, self.mesh = bundle, opt_cfg, mesh
        self.sched, self.microbatch = sched, microbatch or 1
        self.g = mesh_groups(mesh)
        if self.g is None:
            raise ValueError("this process holds no entry of the mesh")
        self.D, self.M = int(mesh.shape["data"]), int(mesh.shape["model"])
        abstract = abstract_state(bundle, opt_cfg)
        self.specs = state_specs(abstract, mesh)
        self.shapes = {p: tuple(x.shape) for p, x in tr.leaves_with_path(abstract["params"])}
        if opt_cfg.quant_state:         # an int8 moment's codes, by its param's path
            self.qshapes = {p: tuple(x.shape) for p, x in tr.leaves_with_path(abstract["opt"].m)}
        self.pspec = dict(tr.leaves_with_path(self.specs["params"]))
        self.moe = bundle.cfg.moe is not None

    # ---------------------------------------------------------------- layout
    def _local_experts(self, path, ep: bool) -> bool:
        return ep and self.M > 1 and path[-1] in _EXPERTS

    def _work_spec(self, path, ep: bool):
        """What the step holds of a param: whole, but an expert stack's E
        axis under expert parallelism (``moe_param_specs``)."""
        spec = self.pspec[path]
        if self._local_experts(path, ep):
            if spec[0] != "model":
                raise ValueError(f"{tr.path_str(path)}: {self.shapes[path][0]} experts do not "
                                 f"split over {self.M} model ranks")
            return mctx.moe_param_specs(None)[path[-1]]
        return shd.P(*([None] * len(spec)))

    def _region(self, spec, path):
        return shd.block(spec, self.shapes[path], self.mesh, self.g.coords)

    @staticmethod
    def _rel(region, within):
        """``region`` (global slices) as slices of a tensor covering
        ``within``."""
        return tuple(slice(r.start - w.start, r.stop - w.start) for r, w in zip(region, within))

    def _gather_params(self, blocks, ep):
        """The work tensors: every leaf joined from the ranks' blocks (one
        all-gather over the mesh a dtype, ``shd.gather_whole``)."""
        paths = [p for p, _ in tr.leaves_with_path(blocks)]
        local = dict(tr.leaves_with_path(blocks))
        work = shd.gather_whole([local[p] for p in paths], [self.pspec[p] for p in paths],
                                [self._work_spec(p, ep) for p in paths], self.mesh, self.g)
        return tr.unflatten_like(blocks, work)

    def _reduce_grads(self, grads, ep):
        """Sum over the data group (the router's over the model group
        first), divided by D; in place."""
        gs = list(tr.leaves_with_path(grads))
        if ep and self.M > 1:
            coll.all_reduce_([g for p, g in gs if p[-1] == "router"], self.g.model)
        for dtype in sorted({g.dtype for _, g in gs}, key=str):
            group = [g for _, g in gs if g.dtype == dtype]
            coll.all_reduce_(group, self.g.data)
            for g in group:
                g.copy_(true_div(g, float(self.D)))
        return grads

    def _global_norm(self, grads, ep):
        sq = []
        local = []
        for p, g in tr.leaves_with_path(grads):
            sq.append(torch.sum(torch.square(g.float())))
            if self._local_experts(p, ep):
                local.append(len(sq) - 1)
        sq = torch.stack(sq)
        if local:
            idx = torch.tensor(local, device=sq.device)
            sq = sq.index_put((idx,), coll.all_reduce(sq[idx], self.g.model))
        return torch.sqrt(torch.sum(sq))

    # ------------------------------------------------------------- the step
    def _rows(self, batch, k):
        """This rank's rows of microbatch k of the global batch."""
        out = {}
        for name, x in batch.items():
            x = x if torch.is_tensor(x) else torch.as_tensor(np.asarray(x))
            B = x.shape[0]
            if B % (self.microbatch * self.D):
                raise ValueError(f"batch leaf {name!r}: {B} rows do not split into "
                                 f"{self.microbatch} microbatches over {self.D} data ranks")
            sub = x.reshape(self.microbatch, B // self.microbatch, *x.shape[1:])[k]
            n = sub.shape[0] // self.D
            d = self.g.coords["data"]
            out[name] = sub[d * n:(d + 1) * n].to(self.bundle.device)
        return out

    def _update(self, work_p, grads, opt, sc, ep):
        """AdamW on this rank's blocks."""
        cfg = self.opt_cfg
        results = {}
        wp = dict(tr.leaves_with_path(work_p))
        wg = dict(tr.leaves_with_path(grads))
        ospec = self.specs["opt"]
        sides = ("m", "v", "m_scale", "v_scale") if cfg.quant_state else ("m", "v")
        mine = {s: dict(tr.leaves_with_path(getattr(opt, s))) for s in sides}
        specs = {s: dict(tr.leaves_with_path(getattr(ospec, s))) for s in sides}
        for path in wp:
            within = self._region(self._work_spec(path, ep), path)
            rp = self._region(self.pspec[path], path)
            if not cfg.quant_state:
                rel = self._rel(rp, within)
                results[path] = adamw.update_leaf(path, wp[path][rel], wg[path][rel],
                                                  mine["m"][path], mine["v"][path], None, None,
                                                  cfg, sc)
                continue
            results[path] = self._update_q8(path, wp[path], wg[path], within, rp,
                                            {s: mine[s][path] for s in sides},
                                            specs["m"][path], sc)
        return adamw.assemble(work_p, results, sc.step, cfg.quant_state)

    def _update_q8(self, path, p, g, within, rp, mom, qspec, sc):
        """One leaf with int8 moments: the update over the range of the
        leaf that this rank's codes cover (whole blocks of the last axis)."""
        D = self.shapes[path][-1]
        codes = shd.block(qspec, self.qshapes[path], self.mesh, self.g.coords)
        lead, keep = tuple(rp[:-1]), None
        if qspec[-2] is None:           # the codes hold the whole last axis
            rm = lead + (slice(0, D),)
        elif (rp[-1].stop - rp[-1].start) % adamw._BLOCK:
            # the codes' blocks split the params' (on every rank alike):
            # take the whole last axis's codes from the G axis's group,
            # update it, keep ours
            grp = self.g.data if qspec[-2] == "data" else self.g.model
            mom = {s: coll.all_gather(x, grp, dim=x.dim() - 2) for s, x in mom.items()}
            rm, keep = lead + (slice(0, D),), codes[-2]
        else:                           # the codes' blocks are the params'
            rm = lead + (slice(codes[-2].start * adamw._BLOCK,
                               min(codes[-2].stop * adamw._BLOCK, D)),)
        rel = self._rel(rm, within)
        new = adamw.update_leaf(path, p[rel], g[rel], mom["m"], mom["v"], mom["m_scale"],
                                mom["v_scale"], self.opt_cfg, sc)
        moments = [x if keep is None else x[..., keep, :] for x in new[1:]]
        return (new[0][self._rel(rp, rm)].contiguous(), *(x.contiguous() for x in moments))

    def __call__(self, state, batch):
        ctx = mctx.get_context()
        ep = ctx is not None and self.moe
        if self.moe and self.D * self.M > 1 and ctx is None:
            raise ValueError("a config with routed experts trains over a mesh under "
                             "dist_context_for(mesh): set_context(...) first")
        params = self._gather_params(state["params"], ep)
        losses, metricss, acc = [], [], None
        for k in range(self.microbatch):
            loss, metrics, grads = loss_and_grads(self.bundle, params, self._rows(batch, k))
            losses.append(loss)
            metricss.append(metrics)
            if self.microbatch == 1:
                acc = grads
            else:
                g32 = tr.tree_map(lambda x: x.float(), grads)
                acc = g32 if acc is None else tr.tree_map(lambda a, b: a + b, acc, g32)
        if self.microbatch > 1:
            acc = tr.tree_map(lambda g: true_div(g, float(self.microbatch)), acc)
        grads = self._reduce_grads(acc, ep)
        gnorm = self._global_norm(grads, ep)
        lr_scale = self.sched(state["opt"].step)
        sc = adamw.scalars(state["opt"], self.opt_cfg, lr_scale, gnorm)
        new_params, new_opt = self._update(params, grads, state["opt"], sc, ep)
        metrics = {k: torch.stack([m[k] for m in metricss]).mean() for k in metricss[0]}
        metrics["loss"] = torch.stack(losses).mean()
        for k in ("loss", "xent"):
            metrics[k] = true_div(coll.all_reduce(metrics[k], self.g.data), float(self.D))
        metrics.update(grad_norm=gnorm, lr_scale=lr_scale)
        return {"params": new_params, "opt": new_opt}, metrics
