"""Dry run: trace every (arch x shape x mesh) cell at production scale over
fake cards, allocating nothing (port of ``repro/launch/dryrun.py``).

The reference lowers and compiles each cell's step against abstract inputs
on its production mesh.  Here each cell traces rank 0's program of the
port's own engine for that shape, run eagerly under torch's
``FakeTensorMode``: every tensor has a shape, a dtype and a device - a fake
card, ``meta:<i>`` (``launch/mesh.fake_mesh``), which needs no card - and
no storage, and every hand kernel's wrapper takes its plain version, which
only carries shapes through (``kernels/_build.plain_here``).  The cells of
the CLI run in worker processes, one a core.

  * train: the sharded step of ``build_train_step(bundle, opt, mesh)`` at
    mesh entry (0, 0), on its blocks of the state (``state_specs``), over a
    fake process group whose world is the mesh's (the groups of
    ``launch/mesh.mesh_groups``, the context of ``dist_context_for``); on a
    mesh of one entry, the one-card step.  The batch is the shape's global
    one, on the host, as the trainer hands it over.
  * prefill / decode: ``bundle.prefill`` / ``bundle.decode_step`` of data
    replica 0 on its share of the shape's batch (at least one row) over
    its mesh row, every weight's column blocks placed on the row's fake
    cards by ``models/linops.tp_place`` and run inside ``ops.tp_shard``, as
    ``serve/sharded.ShardedServeEngine`` runs a replica.
  * ``--variant opt``: as in the reference, the train step under remat
    ``save_heavy``, decode on PDQ-int8 weights (``quantize_param_tree``)
    with the int8 KV cache (an attention config's), and prefill sequence-
    parallel (``serve/seq_parallel.SeqPrefill``): mesh entry (0, 0)'s
    program over a fake process group of the mesh's world, on its
    ``param_specs`` blocks of the weights, its ``batch_spec(...,
    seq_over_model=True)`` block of the batch and its ``cache_spec(...,
    seq_over_model=True)`` blocks of a fresh pool.

Each cell writes one record, ``build/dryrun/<arch>__<shape>__<mesh>[__opt]
.json`` at the repository's root, with the reference's keys where they
mean the same thing, all per rank (rank 0's card, ``meta:0``):

  * ``flops`` and ``scaled_dot_flops``: the matmul FLOPs
    (``launch/hlo_analysis.DotCounter``; nothing else is counted, and no
    loop needs scaling); ``collectives`` (bytes by kind and ``total``),
    ``scaled_collectives``, ``scaled_collective_total`` and
    ``collectives_by_group`` (``hlo_analysis.collective_counter``);
  * ``memory``: ``argument_bytes``, the distinct storages of the step's
    inputs on the card; ``output_bytes``, those of its outputs that are no
    input's; ``temp_bytes``, the peak less both;
  * ``peak_bytes``: the peak of the storages alive on the card over the
    step, its inputs included (``_Account``: each storage's own bytes, not
    rounded to the caching allocator's blocks), and ``fits``:
    ``peak_bytes`` within ``card_bytes``, the card's memory
    (``torch.cuda.get_device_properties(0)`` where a card is present, else
    ``H100_80GB_BYTES``);
  * ``kernels``: each hand kernel's entries (``ops.counts()``) in the step;
  * ``trace_s``: the cell's seconds, set-up included (in place of the
    reference's ``lower_s`` / ``compile_s``).

A cell that raises is recorded ``failed`` with its traceback's tail.

Usage (no card needed):
  python -m repro_torch.launch.dryrun --arch yi-6b --shape decode_32k [--multi-pod]
  python -m repro_torch.launch.dryrun --all --both-meshes [--variant opt] [--skip-done]
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import os
import time
import traceback
import weakref
from pathlib import Path

import torch
from torch.overrides import TorchFunctionMode
from torch.utils._device import _device_constructors

from repro_torch import tree as tr
from repro_torch.configs import ALL_ARCHS, get_config
from repro_torch.kernels import ops
from repro_torch.launch import hlo_analysis
from repro_torch.launch.mesh import fake_mesh, make_production_mesh, mesh_groups, mesh_info
from repro_torch.models import build_model
from repro_torch.models import context as mctx
from repro_torch.models.api import SHAPES, ShapeSpec
from repro_torch.models.layers import MetaGenerator
from repro_torch.models.linops import quantize_param_tree, tp_place
from repro_torch.models.transformer import lm_init, lm_init_caches
from repro_torch.optim import AdamWConfig, adamw

ART_DIR = Path(__file__).resolve().parents[3] / "build" / "dryrun"
_FACTORIES = _device_constructors()

# int8 optimizer moment states for the configs whose fp32 Adam would not fit
# a card on a single pod (the reference's DESIGN.md Sec. 5)
QUANT_OPT_STATE = {"arctic-480b", "deepseek-v2-236b"}

# an NVIDIA H100 80GB HBM3's memory where the process has no card to ask: what
# torch's total_memory gives a process on such a card (85017493504 bytes, 81079
# MiB; nvidia-smi's memory.total reads 81559 MiB, 480 MiB of which no process gets)
H100_80GB_BYTES = 85017493504


def card_bytes() -> int:
    if torch.cuda.is_available():
        return int(torch.cuda.get_device_properties(0).total_memory)
    return H100_80GB_BYTES


def skip_reason(cfg, shape_name: str) -> str | None:
    if shape_name == "long_500k" and not cfg.long_context:
        return ("pure full-attention arch: long_500k needs sub-quadratic "
                "attention (DESIGN.md Arch-applicability)")
    return None


class _FakeGen(MetaGenerator):
    """A param tree's inits drawn on ``device`` under the dry run's
    ``FakeTensorMode``: shapes and dtypes only."""

    def __init__(self, device):
        self.device = torch.device(device)


@contextlib.contextmanager
def fake_world(n: int):
    """A fake process group of ``n`` ranks, this process rank 0, inside
    (none for one rank).  ``fake_pg`` is internal to torch: only the dry run
    imports it."""
    import torch.distributed as dist
    if n == 1:
        yield
        return
    if dist.is_initialized():
        raise RuntimeError("the dry run makes its own fake process group; this process "
                           "already has a process group")
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    try:
        yield
    finally:
        dist.destroy_process_group()


class _OnCard(TorchFunctionMode):
    """Factories asked for a fake card make their tensor on the host and
    move it there: some torch versions drop a ``meta`` device's index in a
    factory under ``FakeTensorMode`` (``torch.as_tensor(0, device="meta:0")``
    landing on ``meta``), and a fake card is an indexed ``meta`` device."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        dev = kwargs.get("device")
        if (dev is not None and func in _FACTORIES
                and (d := torch.device(dev)).type == "meta" and d.index is not None):
            return func(*args, **{k: v for k, v in kwargs.items() if k != "device"}).to(d)
        return func(*args, **kwargs)


def _storages(tree, device) -> dict:
    """{storage key: bytes} of the distinct storages of ``tree``'s tensors
    on ``device``."""
    out = {}
    for t in tr.leaves(tree):
        if torch.is_tensor(t) and t.device == device:
            st = t.untyped_storage()
            out[st._cdata] = st.nbytes()
    return out


@dataclasses.dataclass
class Trace:
    """What ``lower_cell`` read off one cell's step."""
    costs: hlo_analysis.Costs
    argument_bytes: int
    output_bytes: int
    peak_bytes: int
    kernels: dict
    rows: int            # the batch rows rank 0's step runs


class _Account(hlo_analysis.DotCounter):
    """The trace's one dispatch mode: ``DotCounter``'s matmul FLOPs, and the
    bytes of the storages alive on each device and their peak.  A storage
    counts once, from the op that made it (``tracked``, the step's inputs,
    from the start) until it is freed.  (torch's ``MemTracker`` counts the
    same peaks, exactly, and doubled a trace's time as a second mode.)"""

    def __init__(self, costs, tracked):
        super().__init__(costs)
        self.live: dict = {}
        self.peak: dict = {}
        self._seen: set = set()
        for t in tracked:
            self._track(t)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = super().__torch_dispatch__(func, types, args, kwargs)
        for t in (out,) if isinstance(out, torch.Tensor) else (
                out if isinstance(out, (tuple, list)) else ()):
            if isinstance(t, torch.Tensor):
                self._track(t)
        return out

    def _track(self, t):
        st = t.untyped_storage()
        key = st._cdata
        if key in self._seen:
            return
        n, dev = st.nbytes(), t.device
        self._seen.add(key)
        weakref.finalize(st, self._free, key, dev, n)
        self.live[dev] = self.live.get(dev, 0) + n
        self.peak[dev] = max(self.peak.get(dev, 0), self.live[dev])

    def _free(self, key, dev, n):
        self._seen.discard(key)
        self.live[dev] -= n


def _trace(run, args, device, groups=None) -> tuple:
    """Run ``run()`` under the counters, the storages of ``args`` counted
    from the start: (outputs, costs, peak bytes on ``device``, {kernel:
    entries}).  The kernel counts are put back as they were."""
    before = ops.count_state()
    ops.reset_counts()
    gc.collect()
    costs = hlo_analysis.Costs()
    try:
        with hlo_analysis.collective_counter(groups, costs), _Account(
                costs, [t for t in tr.leaves(args) if torch.is_tensor(t)]) as acc:
            out = run()
        entries = {k: v["entries"] for k, v in ops.counts().items() if v["entries"]}
    finally:
        ops.set_counts(before)
    return out, costs, acc.peak.get(device, 0), entries


def _fake_like(t, device):
    return torch.empty(t.shape, dtype=t.dtype, device=device)


def _train(cfg, sp, mesh, variant, arch) -> Trace:
    from repro_torch.distributed.fault import reshard_state
    from repro_torch.train.train_step import (abstract_state, build_train_step,
                                              dist_context_for, state_specs)
    if variant == "opt":
        cfg = dataclasses.replace(cfg, remat="save_heavy")
    dev = mesh.devices[0, 0]
    one = mesh.devices.size == 1
    opt = AdamWConfig(quant_state=arch in QUANT_OPT_STATE)
    bundle = build_model(cfg, dev)
    params = lm_init(_FakeGen("cpu"), bundle.cfg)
    whole = {"params": params, "opt": adamw.init(params, opt)}
    if one:
        state = tr.tree_map(lambda t: t.to(dev), whole)
    else:
        state = reshard_state(whole, mesh, state_specs(abstract_state(bundle, opt), mesh))
    del whole, params
    batch = {k: _fake_like(v, "cpu") for k, v in bundle.input_specs(sp).items()}
    step = build_train_step(bundle, opt, None if one else mesh)
    ctx = None if one else dist_context_for(mesh)
    with mctx.use_context(ctx):
        out, costs, peak, entries = _trace(lambda: step(state, batch), state, dev,
                                           None if one else mesh_groups(mesh))
    args = _storages(state, dev)
    outs = {k: v for k, v in _storages(out, dev).items() if k not in args}
    D = int(mesh.shape["data"])
    return Trace(costs, sum(args.values()), sum(outs.values()), peak, entries,
                 sp.batch // D)


def _seq_prefill(cfg, sp, mesh, pdq: bool = False) -> Trace:
    """The opt prefill: entry (0, 0)'s part of the sequence-parallel
    prefill of the shape's batch over the whole mesh; ``pdq``: on PDQ-int8
    weights (a card run's, ``chip_smoke.py``'s SP) where the reference's
    cell has fp ones."""
    from repro_torch.launch.mesh import mesh_groups
    from repro_torch.serve.seq_parallel import SeqPrefill
    dev = mesh.devices[0, 0]
    bundle = build_model(cfg, dev)
    specs = bundle.input_specs(sp)
    mem_len = specs["frames"].shape[1] if "frames" in specs else 0
    prog = SeqPrefill(bundle, mesh, sp.batch, sp.seq, mem_len=mem_len)
    params = lm_init(_FakeGen("cpu"), cfg)
    params = prog.place_params(quantize_param_tree(params) if pdq else params)
    batch = prog.place_batch({k: _fake_like(v, "cpu") for k, v in specs.items()})
    caches = prog.init_caches()
    args_tree = (params.tree, batch, caches)
    out, costs, peak, entries = _trace(lambda: prog(params, batch, caches), args_tree, dev,
                                       mesh_groups(mesh))
    args = _storages(args_tree, dev)
    outs = {k: v for k, v in _storages(out, dev).items() if k not in args}
    return Trace(costs, sum(args.values()), sum(outs.values()), peak, entries,
                 prog.local_rows)


def _serve(cfg, sp, mesh, variant) -> Trace:
    if variant == "opt" and sp.kind == "decode" and cfg.ssm is None:
        cfg = dataclasses.replace(cfg, quant_kv="dynamic")
    row = list(mesh.devices[0])
    home = row[0]
    B = max(1, sp.batch // int(mesh.shape["data"]))
    params = lm_init(_FakeGen("cpu"), cfg)
    if variant == "opt" and sp.kind == "decode":
        params = quantize_param_tree(params)
    placed, blocks = tp_place(params, row)
    del params
    bundle = build_model(cfg, home)
    tp = ops.TPRow(row, blocks)
    specs = bundle.input_specs(ShapeSpec(sp.name, sp.kind, sp.seq, B))
    if sp.kind == "decode":
        caches = tr.tree_map(lambda t: _fake_like(t, home), specs.pop("caches"))
        tok, pos = _fake_like(specs["tokens"], home), _fake_like(specs["positions"], home)
        inputs = (caches, tok, pos)

        def run():
            with ops.tp_shard(tp):
                return bundle.decode_step(placed, caches, tok, pos)
    else:
        mem_len = specs["frames"].shape[1] if "frames" in specs else 0
        caches = tr.tree_map(lambda t: _fake_like(t, home),
                             lm_init_caches(cfg, B, sp.seq, "meta", mem_len))
        batch = {k: _fake_like(v, home) for k, v in specs.items()}
        inputs = (batch, caches)

        def run():
            with ops.tp_shard(tp):
                return bundle.prefill(placed, batch, caches)
    args_tree = (placed, [b for _, bs in blocks.values() for b in bs], inputs)
    out, costs, peak, entries = _trace(run, args_tree, home)
    args = _storages(args_tree, home)
    outs = {k: v for k, v in _storages(out, home).items() if k not in args}
    return Trace(costs, sum(args.values()), sum(outs.values()), peak, entries, B)


def lower_cell(arch: str, shape, mesh, variant: str = "baseline", cfg=None,
               pdq: bool = False) -> Trace:
    """Trace one cell's step (the port's counterpart of lowering it): rank
    0's program on ``mesh`` (a ``launch/mesh.fake_mesh``) at ``shape`` (a
    ``SHAPES`` name or a ``ShapeSpec``), under ``FakeTensorMode`` and a fake
    process group of the mesh's world.  ``cfg``: the arch's config unless
    given (a test's reduced one); ``pdq``: the opt prefill on PDQ-int8
    weights."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    cfg = get_config(arch) if cfg is None else cfg
    sp = SHAPES[shape] if isinstance(shape, str) else shape
    with fake_world(mesh.devices.size), FakeTensorMode(), _OnCard():
        if sp.kind == "train":
            return _train(cfg, sp, mesh, variant, arch)
        if sp.kind == "prefill" and variant == "opt":
            return _seq_prefill(cfg, sp, mesh, pdq)
        return _serve(cfg, sp, mesh, variant)


def mesh_name(multi_pod: bool, mesh=None) -> str:
    if mesh is not None:
        return f"{mesh[0]}x{mesh[1]}"
    return "pod2x16x16" if multi_pod else "pod16x16"


def run_cell(arch: str, shape, multi_pod: bool = False, variant: str = "baseline", *,
             mesh: tuple[int, int] | None = None, cfg=None, pdq: bool = False) -> dict:
    """One cell's record.  ``shape``: a ``SHAPES`` name or a ``ShapeSpec``;
    ``mesh``: (data, model) of a fake mesh in place of the production one;
    ``cfg``: in place of the arch's own config; ``pdq``: see ``lower_cell``."""
    sp = SHAPES[shape] if isinstance(shape, str) else shape
    cfg = get_config(arch) if cfg is None else cfg
    rec: dict = {"arch": arch, "shape": sp.name, "mesh": mesh_name(multi_pod, mesh),
                 "variant": variant}
    reason = skip_reason(cfg, sp.name)
    if reason:
        rec.update(status="skipped", reason=reason)
        return rec
    t0 = time.perf_counter()
    m = fake_mesh(*mesh) if mesh is not None else make_production_mesh(multi_pod=multi_pod)
    t = lower_cell(arch, sp, m, variant, cfg, pdq)
    trace_s = time.perf_counter() - t0
    coll = {k: float(v) for k, v in t.costs.collective_bytes.items()}
    card = card_bytes()
    rec.update(
        status="ok", mesh_info=mesh_info(m), seq=sp.seq, batch=sp.batch, rows=t.rows,
        trace_s=trace_s,
        flops=t.costs.dot_flops, scaled_dot_flops=t.costs.dot_flops,
        collectives={**coll, "total": sum(coll.values())},
        scaled_collectives=coll, scaled_collective_total=sum(coll.values()),
        collectives_by_group=t.costs.group_bytes,
        memory={"argument_bytes": t.argument_bytes, "output_bytes": t.output_bytes,
                "temp_bytes": max(0, t.peak_bytes - t.argument_bytes - t.output_bytes)},
        peak_bytes=t.peak_bytes, card_bytes=card, fits=t.peak_bytes <= card,
        kernels=t.kernels)
    return rec


def _run(arch: str, shape: str, multi_pod: bool, variant: str, path: str) -> dict:
    """One cell of ``main``, its record written to ``path``; a cell that
    raises is recorded ``failed``."""
    try:
        rec = run_cell(arch, shape, multi_pod, variant)
    except Exception as e:
        rec = {"arch": arch, "shape": shape, "mesh": mesh_name(multi_pod), "variant": variant,
               "status": "failed", "error": f"{type(e).__name__}: {e}",
               "traceback": traceback.format_exc()[-4000:]}
    Path(path).write_text(json.dumps(rec, indent=1))
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list(ALL_ARCHS))
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--skip-done", action="store_true")
    ap.add_argument("--variant", default="baseline", choices=["baseline", "opt"])
    args = ap.parse_args(argv)

    ART_DIR.mkdir(parents=True, exist_ok=True)
    archs = list(ALL_ARCHS) if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    suffix = "" if args.variant == "baseline" else f"__{args.variant}"
    cells = []
    for a in archs:
        for s in shapes:
            for mp in meshes:
                path = ART_DIR / f"{a}__{s}__{mesh_name(mp)}{suffix}.json"
                if (args.skip_done and path.exists() and json.loads(path.read_text())
                        .get("status") in ("ok", "skipped")):
                    print(f"[cached ] {a} {s} {mesh_name(mp)}")
                    continue
                cells.append((a, s, mp, args.variant, str(path)))
    # a trace is one core's Python: the cells run in worker processes, one a
    # core (spawned: a forked child would share the parent's torch state),
    # the prefill cells (the longest) first
    cells.sort(key=lambda c: SHAPES[c[1]].kind != "prefill")
    n_ok = n_skip = n_fail = 0
    import concurrent.futures as cf
    import multiprocessing as mp_
    workers = max(1, min(len(cells), os.cpu_count() or 1))
    with cf.ProcessPoolExecutor(workers, mp_context=mp_.get_context("spawn")) as pool:
        for rec in pool.map(_run, *zip(*cells)) if cells else ():
            tag = rec["status"]
            n_ok += tag == "ok"
            n_skip += tag == "skipped"
            n_fail += tag == "failed"
            extra = ""
            if tag == "ok":
                extra = (f"flops={rec['flops']:.3e} coll={rec['collectives']['total']:.3e}B "
                         f"peak={rec['peak_bytes'] / 2**30:.2f}GiB fits={rec['fits']} "
                         f"trace={rec['trace_s']:.1f}s")
            elif tag == "failed":
                extra = rec["error"][:200]
            print(f"[{tag:7s}] {rec['arch']} {rec['shape']} {rec['mesh']} {extra}", flush=True)
    print(f"done: {n_ok} ok, {n_skip} skipped, {n_fail} failed")
    return 0 if n_fail == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
