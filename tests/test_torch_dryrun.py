"""The port's dry run (``launch/dryrun.py``, ``launch/hlo_analysis.py``,
``bundle.input_specs``, the production mesh) against the reference's and
against the port's own real steps, on the CPU.

  (a) ``skip_reason`` equals ``repro.launch.dryrun.skip_reason`` for every
      arch x shape;
  (b) ``input_specs`` gives the reference's ``bundle.input_specs`` shapes
      and dtypes (``tokens``, ``labels``, ``patches``, ``frames``,
      ``positions``) and its total cache bytes, for every arch x shape;
  (c) on reduced stablelm-1.6b and deepseek-v2-236b (MoE, MLA) at batch 2,
      seq 64 on a 1x1 mesh, the dot FLOPs of prefill, decode and the train
      step against ``repro.launch.hlo_analysis.analyze`` of the reference's
      compiled step (lowered under a 1x1 ``jax.sharding.Mesh``).  Bound: 1%
      for the forward steps, 3% for the train step; measured: equal, with
      no gap (both count every product of the same program, the
      reference's loop bodies scaled by their trips);
  (d) ``argument_bytes`` equals the bytes of the same inputs materialized
      on the CPU exactly: the train state at 1x1, a decode step's params,
      caches and tokens, and (in (f)) rank 0's blocks of the state on 2x2;
  (e) the opt decode's ``kernels`` census (PDQ-int8 weights, int8 KV)
      equals the entries a real CPU decode step counts (``ops.counts()``),
      alone and over a TP row of two;
  (f) on a 2x2 fake mesh, the train step's collective bytes by kind and by
      group equal, exactly, what ``hlo_analysis.collective_counter`` reads
      around the real step over a 2x2 mesh of four gloo processes (reduced
      stablelm-1.6b, and reduced deepseek-v2 with its experts over
      ``model`` and, as the dry run gives it, int8 moments);
      The opt prefill's cell on the same 2x2 fake mesh (reduced
      stablelm-1.6b and deepseek-v2, 4 rows of 64 positions: 2 rows a
      replica, 16 positions a rank) records ``ok``, and its collective
      bytes by kind and by group, its ``scaled_dot_flops`` and its
      argument bytes equal exactly what rank 0 counts around the real
      sequence-parallel prefill (``serve/seq_parallel.SeqPrefill``) of the
      same cell over the same four gloo processes;
  (g) one full-size cell, yi-6b ``decode_32k`` on the 16x16 production
      mesh, traces ``ok`` without allocating its inputs (the process's peak
      resident memory stays far below them);
  (h) each kernel selector sends a real CPU tensor and a fake one to the
      plain version, and a non-fake CUDA tensor to the CUDA wrapper, whose
      device check (or launch) is reached - it raises here.
"""
import dataclasses
import importlib
import json
import os
import resource
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import ALL_ARCHS, get_config, reduced_config
from repro_torch.kernels import ops
from repro_torch.launch import dryrun, hlo_analysis
from repro_torch.launch.mesh import make_production_mesh, mesh_info
from repro_torch.models import build_model
from repro_torch.models.api import SHAPES, ShapeSpec

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, S = 2, 64
FWD_RTOL, TRAIN_RTOL = 0.01, 0.03
TM_ARCHS = ("stablelm-1.6b", "deepseek-v2-236b")
TM_BATCH, TM_SEQ = 4, 32
SP_BATCH, SP_SEQ = 4, 64
CELLS = [(a, s) for a in ALL_ARCHS for s in SHAPES]


def _ref_dryrun():
    """The reference's dry-run module, imported without leaving its forced
    512-device XLA flag behind for this process's later jax users."""
    had = os.environ.get("XLA_FLAGS")
    try:
        return importlib.import_module("repro.launch.dryrun")
    finally:
        if had is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = had


def _storage_bytes(tensors) -> int:
    seen = {}
    for t in tensors:
        st = t.untyped_storage()
        seen[st.data_ptr()] = st.nbytes()
    return sum(seen.values())


# ----------------------------------------------------------------------- (a)
@pytest.mark.parametrize("arch,shape", CELLS)
def test_skip_reason_is_the_reference(arch, shape):
    from repro.configs import get_config as j_config
    want = _ref_dryrun().skip_reason(j_config(arch), shape)
    assert dryrun.skip_reason(get_config(arch), shape) == want


# ----------------------------------------------------------------------- (b)
def _nbytes(shape, dtype) -> int:
    return int(np.prod(shape)) * np.dtype(dtype).itemsize


@pytest.mark.parametrize("arch,shape", CELLS)
def test_input_specs_are_the_reference(arch, shape):
    import jax
    from repro.configs import get_config as j_config
    from repro.models import build_model as j_build
    want = j_build(j_config(arch)).input_specs(shape)
    got = build_model(get_config(arch), "cpu").input_specs(shape)
    caches = got.pop("caches", None)
    want_caches = want.pop("caches", None)
    assert sorted(got) == sorted(want)
    for k, v in got.items():
        assert v.device.type == "meta"
        assert tuple(v.shape) == tuple(want[k].shape), k
        assert str(v.dtype).removeprefix("torch.") == str(want[k].dtype), k
    assert (caches is None) == (want_caches is None)
    if caches is not None:
        from repro_torch import tree as tr
        got_b = sum(t.numel() * t.element_size() for t in tr.leaves(caches))
        assert all(t.device.type == "meta" for t in tr.leaves(caches))
        want_b = sum(_nbytes(x.shape, x.dtype) for x in jax.tree.leaves(want_caches))
        assert got_b == want_b


# ----------------------------------------------------------------------- (c)
@pytest.fixture(scope="module")
def ref_flops():
    """{(arch, kind): the reference's dot FLOPs} at batch B, seq S."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from repro.configs import reduced_config as j_reduced
    from repro.launch.hlo_analysis import analyze
    from repro.models import build_model as j_build
    from repro.optim import AdamWConfig as JOpt
    from repro.optim import schedule as jsched
    from repro.train.train_step import abstract_state, make_step_fn
    sds = jax.ShapeDtypeStruct
    out = {}
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    for arch in TM_ARCHS:
        jb = j_build(j_reduced(arch))
        tok = sds((B, S), jnp.int32)
        one = sds((B, 1), jnp.int32)
        with mesh:
            params = jax.eval_shape(jb.init, jax.random.PRNGKey(0))
            caches = jax.eval_shape(lambda: jb.init_caches(B, S, 0))
            opt = JOpt()
            step = make_step_fn(jb, opt, lambda s: jsched.warmup_cosine(s))
            lowered = {
                "prefill": jax.jit(jb.prefill).lower(params, {"tokens": tok}, caches),
                "decode": jax.jit(jb.decode_step).lower(params, caches, one, one),
                "train": jax.jit(step).lower(abstract_state(jb, opt),
                                             {"tokens": tok, "labels": tok})}
            for kind, lo in lowered.items():
                out[arch, kind] = analyze(lo.compile().as_text()).dot_flops
    return out


@pytest.mark.parametrize("kind", ["prefill", "decode", "train"])
@pytest.mark.parametrize("arch", TM_ARCHS)
def test_dot_flops_match_the_reference_hlo(ref_flops, arch, kind):
    rec = dryrun.run_cell(arch, ShapeSpec(kind, kind, S, B), mesh=(1, 1),
                          cfg=reduced_config(arch))
    assert rec["status"] == "ok"
    want = ref_flops[arch, kind]
    assert want > 0
    assert rec["flops"] == rec["scaled_dot_flops"]
    tol = TRAIN_RTOL if kind == "train" else FWD_RTOL
    assert abs(rec["flops"] - want) <= tol * want, (rec["flops"], want)


# ----------------------------------------------------------------------- (d)
def test_train_argument_bytes_are_the_materialized_state():
    from repro_torch import tree as tr
    from repro_torch.optim import AdamWConfig
    from repro_torch.train.train_step import make_state
    cfg = reduced_config("stablelm-1.6b")
    rec = dryrun.run_cell("stablelm-1.6b", ShapeSpec("t", "train", S, B), mesh=(1, 1), cfg=cfg)
    st = make_state(build_model(cfg, "cpu"), AdamWConfig(), 0)
    assert rec["memory"]["argument_bytes"] == _storage_bytes(tr.leaves(st))
    assert rec["peak_bytes"] >= rec["memory"]["argument_bytes"] + rec["memory"]["output_bytes"]
    assert rec["fits"] and rec["card_bytes"] == dryrun.card_bytes()


def test_decode_argument_bytes_are_the_materialized_inputs():
    from repro_torch import tree as tr
    cfg = reduced_config("stablelm-1.6b")
    rec = dryrun.run_cell("stablelm-1.6b", ShapeSpec("d", "decode", S, B), mesh=(1, 1), cfg=cfg)
    b = build_model(cfg, "cpu")
    tok = torch.zeros((B, 1), dtype=torch.int32)
    inputs = [*tr.leaves(b.init(0)), *tr.leaves(b.init_caches(B, S)), tok, tok.clone()]
    assert rec["memory"]["argument_bytes"] == _storage_bytes(inputs)
    assert rec["rows"] == B and rec["kernels"] == {}


# ----------------------------------------------------------------------- (e)
@pytest.mark.parametrize("T", [1, 2])
def test_opt_decode_census_is_a_real_decode_steps(T):
    from repro_torch.models.linops import quantize_param_tree, tp_place
    cfg = reduced_config("stablelm-1.6b")
    rec = dryrun.run_cell("stablelm-1.6b", ShapeSpec("d", "decode", S, B), variant="opt",
                          mesh=(1, T), cfg=cfg)
    b = build_model(dataclasses.replace(cfg, quant_kv="dynamic"), "cpu")
    devs = ["cpu"] * T
    placed, blocks = tp_place(quantize_param_tree(b.init(0)), devs)
    caches = b.init_caches(B, S)
    tok = torch.zeros((B, 1), dtype=torch.int32)
    pos = torch.full((B, 1), 5, dtype=torch.int32)
    ops.reset_counts()
    with ops.tp_shard(ops.TPRow(devs, blocks)):
        b.decode_step(placed, caches, tok, pos)
    want = {k: v["entries"] for k, v in ops.counts().items() if v["entries"]}
    assert want and rec["kernels"] == want


# ----------------------------------------------------------------------- (f)
RANK = """
import json, sys
import numpy as np, torch
torch.set_num_threads(1)
import torch.distributed as dist
from repro_torch import tree as tr
from repro_torch.configs import reduced_config
from repro_torch.launch import hlo_analysis
from repro_torch.launch.mesh import init_distributed, make_host_mesh
from repro_torch.models import build_model
from repro_torch.models import context as mctx
from repro_torch.optim import AdamWConfig
from repro_torch.serve.seq_parallel import SeqPrefill
from repro_torch.train.train_step import build_train_step, dist_context_for, make_state
rank, port, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
archs, B, S = json.loads(sys.argv[4]), int(sys.argv[5]), int(sys.argv[6])
quant = json.loads(sys.argv[7])
SB, SS = int(sys.argv[8]), int(sys.argv[9])
init_distributed(f"127.0.0.1:{port}", 4, rank, timeout=120)
res = {}
for arch in archs:
    mesh = make_host_mesh(2, 2, ["cpu"] * 4)
    ctx = dist_context_for(mesh)
    mctx.set_context(ctx)
    b = build_model(reduced_config(arch), "cpu")
    opt = AdamWConfig(quant_state=arch in quant)
    st = make_state(b, opt, 0, mesh)
    step = build_train_step(b, opt, mesh)
    rng = np.random.default_rng(0)
    batch = {k: rng.integers(0, b.cfg.vocab, (B, S), dtype=np.int32)
             for k in ("tokens", "labels")}
    with hlo_analysis.collective_counter(ctx.groups) as c:
        step(st, batch)
    mctx.set_context(None)
    seen = {t.untyped_storage().data_ptr(): t.untyped_storage().nbytes() for t in tr.leaves(st)}
    res[arch] = dict(bytes=c.collective_bytes, groups=c.group_bytes,
                     state_bytes=sum(seen.values()))
    # the opt prefill's cell: the sequence-parallel prefill of SB x SS
    prog = SeqPrefill(b, mesh, SB, SS)
    params = prog.place_params(b.init(0))
    batch = prog.place_batch({"tokens": torch.as_tensor(
        rng.integers(0, b.cfg.vocab, (SB, SS), dtype=np.int32))})
    caches = prog.init_caches()
    with hlo_analysis.collective_counter(prog.groups) as c, hlo_analysis.DotCounter() as dots:
        prog(params, batch, caches)
    args = (params.tree, batch, caches)
    seen = {t.untyped_storage().data_ptr(): t.untyped_storage().nbytes() for t in tr.leaves(args)}
    res[arch + " prefill"] = dict(bytes=c.collective_bytes, groups=c.group_bytes,
                                  flops=dots.costs.dot_flops, arg_bytes=sum(seen.values()))
if rank == 0:
    json.dump(res, open(out, "w"))
dist.destroy_process_group()
"""


@pytest.fixture(scope="module")
def real_mesh_step(tmp_path_factory):
    """Rank 0's collective bytes and state bytes of one real train step
    over a 2x2 mesh of four gloo processes on the CPU."""
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = str(s.getsockname()[1])
    out = tmp_path_factory.mktemp("dryrun_mesh") / "rank0.json"
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    procs = [subprocess.Popen([sys.executable, "-c", RANK, str(r), port, str(out),
                               json.dumps(TM_ARCHS), str(TM_BATCH), str(TM_SEQ),
                               json.dumps(sorted(dryrun.QUANT_OPT_STATE)), str(SP_BATCH),
                               str(SP_SEQ)],
                              env=env, cwd=ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for r in range(4)]
    try:
        outs = [p.communicate(timeout=240) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for r, (p, (_, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r}: {err[-3000:]}"
    return json.loads(out.read_text())


@pytest.mark.parametrize("arch", TM_ARCHS)
def test_mesh_collective_bytes_are_the_real_steps(real_mesh_step, arch):
    rec = dryrun.run_cell(arch, ShapeSpec("t", "train", TM_SEQ, TM_BATCH), mesh=(2, 2),
                          cfg=reduced_config(arch))
    real = real_mesh_step[arch]
    assert rec["status"] == "ok" and rec["mesh_info"]["n_devices"] == 4
    assert rec["scaled_collectives"] == {k: float(v) for k, v in real["bytes"].items()}
    assert rec["collectives_by_group"] == real["groups"]
    assert rec["collectives"]["total"] == sum(real["bytes"].values()) > 0
    assert rec["memory"]["argument_bytes"] == real["state_bytes"]
    if arch == "deepseek-v2-236b":          # its experts' tokens over 'model'
        assert real["groups"]["model"]["all-to-all"] > 0


@pytest.mark.parametrize("arch", TM_ARCHS)
def test_opt_prefill_cell_is_the_real_seq_parallel_prefill(real_mesh_step, arch):
    rec = dryrun.run_cell(arch, ShapeSpec("p", "prefill", SP_SEQ, SP_BATCH), variant="opt",
                          mesh=(2, 2), cfg=reduced_config(arch))
    real = real_mesh_step[arch + " prefill"]
    assert rec["status"] == "ok" and rec["rows"] == SP_BATCH // 2
    assert rec["scaled_collectives"] == {k: float(v) for k, v in real["bytes"].items()}
    assert rec["collectives_by_group"] == real["groups"]
    assert rec["scaled_dot_flops"] == real["flops"] > 0
    assert rec["memory"]["argument_bytes"] == real["arg_bytes"]
    assert real["groups"]["model"]["all-gather"] > 0       # the layers' K/V
    if arch == "deepseek-v2-236b":      # the routed FFN's token groups and experts
        assert real["groups"]["model"]["all-to-all"] > 0


# ----------------------------------------------------------------------- (g)
def test_full_size_cell_allocates_nothing():
    before = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    rec = dryrun.run_cell("yi-6b", "decode_32k")
    grown = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024 - before
    assert rec["status"] == "ok" and rec["mesh"] == "pod16x16"
    assert rec["mesh_info"] == {"axis_names": ["data", "model"], "shape": [16, 16],
                                "n_devices": 256}
    assert rec["rows"] == SHAPES["decode_32k"].batch // 16
    # the replica's bf16 KV cache alone: 8 rows x 32768 x 32 layers x 2 x 4 x 128
    assert rec["memory"]["argument_bytes"] > 16 * 2**30
    assert grown < 2**30, grown
    assert rec["flops"] > 0 and rec["collectives"]["total"] == 0


def test_production_meshes():
    one, two = make_production_mesh(), make_production_mesh(multi_pod=True)
    assert one.devices.shape == (16, 16) and two.devices.shape == (32, 16)
    assert {d.type for d in two.devices.flat} == {"meta"}
    assert len(set(two.devices[0])) == 16 and (two.processes.flat == np.arange(512)).all()
    assert mesh_info(two) == {"axis_names": ["pod", "data", "model"], "shape": [2, 16, 16],
                              "n_devices": 512}


# ----------------------------------------------------------------------- (h)
class _Card(torch.Tensor):
    """A non-fake tensor on a CUDA device, with no data."""

    @staticmethod
    def __new__(cls, shape, dtype):
        return torch.Tensor._make_wrapper_subclass(cls, shape, dtype=dtype, device="cuda")

    @classmethod
    def __torch_dispatch__(cls, func, types, args=(), kwargs=None):
        raise RuntimeError(f"{func} on a data-less card tensor")


def _selectors():
    """(name, module, plain function name, args builder(make)) of every
    kernel selector; ``make(shape, dtype)`` makes one operand."""
    from repro_torch.kernels import act_stats, fp_dequant, kv_cache, pdq_prologue
    from repro_torch.kernels import quantize, w8a8_matmul
    f32, i8, i32 = torch.float32, torch.int8, torch.int32

    def mm(make):
        return (make((4, 32), i8), make((32, 16), i8), make((4, 1), f32), None,
                make((1, 16), f32), None, None, None, None, None)

    def move(make):
        return ([kv_cache.Move(make((4, 8), f32), make((4, 8), f32), make((4,), i32))],)

    return [
        ("act_stats", act_stats, "act_stats", lambda m: (m((1, 4, 32), f32),)),
        ("quantize", quantize, "quantize",
         lambda m: (m((4, 32), f32), m((4, 1), f32), m((4, 1), i32))),
        ("dequantize", quantize, "dequantize",
         lambda m: (m((4, 32), i8), m((4, 1), f32), m((4, 1), i32))),
        ("pdq_prologue", pdq_prologue, "pdq_prologue", lambda m: (m((4, 32), f32),)),
        ("w8a8_matmul", w8a8_matmul, "w8a8_matmul", mm),
        ("w8a8_swiglu_matmul", w8a8_matmul, "w8a8_swiglu_matmul",
         lambda m: (m((4, 32), i8), m((32, 256), i8), m((4, 1), f32), None,
                    m((1, 256), f32), None, m((4, 2), f32), m((4, 2), f32))),
        ("fp_dequant", fp_dequant, "fp_dequant_fallback",
         lambda m: (m((4, 16), f32), m((4, 32), f32), m((32, 16), i8), m((16,), f32),
                    m((1,), i32))),
        ("cache_move", kv_cache, "cache_move", move),
        ("cache_scatter", kv_cache, "cache_scatter",
         lambda m: (m((4, 8), f32), m((4, 8), f32), m((4,), i32))),
        ("cache_scatter_pages", kv_cache, "cache_scatter_pages",
         lambda m: (m((4, 8), f32), m((4, 8), f32), m((4,), i32))),
        ("decode_attend_i8kv", kv_cache, "decode_attend_i8kv",
         lambda m: (m((2, 4, 64), f32), m((2, 2, 128, 64), i8), m((2, 2, 128, 64), i8),
                    m((2, 2, 128), f32), m((2, 2, 128), f32), m((2,), i32))),
        ("decode_attend_i8kv_fused", kv_cache, "decode_attend_i8kv_fused",
         lambda m: (m((2, 4, 64), f32), m((2, 2, 128, 64), i8), m((2, 2, 128, 64), i8),
                    m((2, 2, 128), f32), m((2, 2, 128), f32), m((2,), i32))),
    ]


class _Reached(Exception):
    pass


@pytest.mark.parametrize("name,module,fn,build", _selectors(), ids=lambda x: x
                         if isinstance(x, str) else "")
def test_selector_takes_plain_for_cpu_and_fake_and_cuda_for_a_card(monkeypatch, name, module,
                                                                    fn, build):
    from torch._subclasses.fake_tensor import (DataDependentOutputException,
                                               DynamicOutputShapeException, FakeTensorMode)

    from repro_torch.kernels import _build
    taken = []

    def reached(*a, **k):
        raise _Reached

    monkeypatch.setattr(_build, "require_cuda", reached)
    monkeypatch.setattr(_build, "library", reached)
    plain = {n: getattr(module, n) for n in dir(module)
             if n.endswith("_plain") or n.endswith("_ref")}
    for n, f in plain.items():
        monkeypatch.setattr(module, n, lambda *a, _f=f, **k: taken.append(_f) or _f(*a, **k))
    if name.startswith("cache_"):
        # the movement launches once its operands are all on one card
        # (device check included); these carry no data to check
        monkeypatch.setattr(module, "cache_move_cuda", lambda *a, **k: reached())

    def cpu(shape, dtype):
        return torch.zeros(shape, dtype=dtype)

    getattr(module, fn)(*build(cpu))
    assert taken, f"{name}: a CPU tensor did not take the plain version"
    taken.clear()
    with FakeTensorMode():
        args = build(lambda s, d: torch.empty(s, dtype=d, device="meta:1"))
        try:
            got = getattr(module, fn)(*args)
        except (DataDependentOutputException, DynamicOutputShapeException):
            # the scatters' plain versions find their rows with nonzero,
            # which no fake tensor can size; the dry run's steps move no
            # cache rows
            got = None
    if name == "fp_dequant":
        # a fake flag has no value: the selector traces the plain
        # version's branch not taken, y as it was
        assert got is args[0] and not taken
    else:
        assert taken, f"{name}: a fake tensor did not take the plain version"
    taken.clear()
    with pytest.raises(_Reached):
        getattr(module, fn)(*build(_Card))
    assert not taken, f"{name}: a CUDA tensor took the plain version"
