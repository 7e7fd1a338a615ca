"""The port's sharded train step against the reference's, over a
('data', 'model') mesh.

The reference runs its own sharded step (``build_train_step(bundle, opt,
mesh)`` under ``set_context(dist_context_for(mesh))``) in one subprocess
with 8 forced host devices, on a mesh it builds itself,
``Mesh(np.array(jax.devices()[:D * M]).reshape(D, M), ("data", "model"))``
(``launch/mesh.make_host_mesh`` uses ``jax.make_mesh``, whose Explicit axes
stop the step; ROADMAP Queue 3).  The port runs the same cases in one spawn
of 8 gloo processes on the CPU, one a mesh entry (a 2x2 case uses ranks
0-3).  Both start from the same numpy params (the reference's init) and
take two steps of ``SyntheticLM`` batches at a constant schedule (the
default ``warmup_cosine`` gives lr 0 at step 0).

Cases: reduced stablelm-1.6b over 2x2 (f32 moments), reduced
deepseek-v2 over 2x2 (f32 moments) and 4x2 (int8 moments), expert-parallel
(8 experts, 4 or 2 a model rank).  Checked:
  * loss, xent, aux and grad_norm of both steps within 1e-5 relative;
  * the params and moments after both steps: within 1e-5 (rtol = atol) at
    all but 1 in 1000 of the state's float elements; with f32 moments every element
    within 2 lr a step; int8 codes at most one apart, in at most 1 in 1000
    codes (as ``test_torch_train_model`` holds the one-device step).  The
    two frameworks' grads differ in their last bits (sums in another
    order), and AdamW's update g / (|g| + eps) turns such a difference into
    up to 2 lr where |g| is near eps (``adamw.first_step_bound``); with int8
    moments a last-bit difference at a .5 tie moves a code by one, and a
    v code that becomes 0 makes the next update m / eps, so a handful of
    params part by more (measured: 4e-5 at most with f32 moments, 0.043
    with int8, in 1-20 elements a leaf; codes one apart in at most 7e-4 of
    a leaf's, fewer of all);
  * every rank's block of every state leaf has the shape of that device's
    ``addressable_shards`` in the reference;
  * elastic restart: the stablelm 2x2 run's state, written by
    ``gather_state`` + ``CheckpointManager`` as whole arrays, restores over
    2x1 and on one process and loads in the reference's ``load_pytree``;
    the next step agrees within 1e-5 on all three.
"""
import json
import os
import pickle
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest

from repro.configs import reduced_config as j_reduced
from repro.models import build_model as j_build

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 240
RTOL = 1e-5
OUTLIERS = 1e-3         # share of a float leaf's elements past RTOL
CODES_APART = 1e-3      # share of int8 moment codes one apart
LR = 1e-3
WORLD = 8
# (name, arch, D, M, int8 moments)
CASES = [("s22", "stablelm-1.6b", 2, 2, False), ("d22", "deepseek-v2-236b", 2, 2, False),
         ("d42q", "deepseek-v2-236b", 4, 2, True)]
SEQ, BATCH, STEPS = 32, 8, 2

REF = """
import json, pickle, sys
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import Mesh
from repro.configs import reduced_config
from repro.data.pipeline import DataConfig, SyntheticLM
from repro.models import build_model
from repro.models import context as mctx
from repro.optim import AdamWConfig, adamw, schedule
from repro.train.train_step import build_train_step, dist_context_for
wdir, cases = sys.argv[1], json.loads(sys.argv[2])
for name, arch, D, M, quant in cases:
    mesh = Mesh(np.array(jax.devices()[:D * M]).reshape(D, M), ("data", "model"))
    mctx.set_context(dist_context_for(mesh))
    cfg = reduced_config(arch)
    opt = AdamWConfig(lr=%(lr)g, quant_state=quant)
    step, sh = build_train_step(build_model(cfg), opt, mesh, lr_schedule=schedule.constant,
                                donate=False)
    p = pickle.load(open(f"{wdir}/p0_{arch}.pkl", "rb"))
    st = jax.device_put({"params": p, "opt": adamw.init(p, opt)}, sh)
    shards = [[list(s.data.shape) for s in sorted(x.addressable_shards,
                                                  key=lambda s: s.device.id)]
              for x in jax.tree.leaves(st)]
    src = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=%(seq)d, batch=%(batch)d))
    ms = []
    for i in range(%(steps)d):
        st, m = step(st, {k: jnp.asarray(v) for k, v in src.batch_at(i).items()})
        ms.append({k: float(v) for k, v in m.items()})
    mctx.set_context(None)
    pickle.dump(dict(metrics=ms, state=jax.tree.map(np.asarray, st), shards=shards),
                open(f"{wdir}/ref_{name}.pkl", "wb"))
    print(name, flush=True)
""" % dict(seq=SEQ, batch=BATCH, steps=STEPS, lr=LR)

RANK = """
import json, os, pickle, sys
import numpy as np, torch
torch.set_num_threads(1)
import torch.distributed as dist
from repro_torch import bridge, tree as tr
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import reduced_config
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.distributed import collectives as coll
from repro_torch.distributed.fault import gather_state, reshard_state
from repro_torch.launch.mesh import init_distributed, make_host_mesh, mesh_coords
from repro_torch.models import build_model
from repro_torch.models import context as mctx
from repro_torch.optim import AdamWConfig, adamw, schedule
from repro_torch.train.train_step import abstract_state, build_train_step, dist_context_for
rank, port, wdir = int(sys.argv[1]), sys.argv[2], sys.argv[3]
cases = json.loads(sys.argv[4])
init_distributed(f"127.0.0.1:{port}", %(world)d, rank, timeout=%(timeout)d)


def to_ref(state, cfg):
    return {"params": bridge.params_to_numpy(state["params"], cfg),
            "opt": bridge.opt_state_to_numpy(state["opt"], cfg)}


def run(mesh, b, opt, st, batches):
    step = build_train_step(b, opt, mesh, lr_schedule=schedule.constant)
    ms = []
    for x in batches:
        st, m = step(st, x)
        ms.append({k: float(v) for k, v in m.items()})
    return st, ms, step


for name, arch, D, M, quant in cases:
    mesh = make_host_mesh(D, M, ["cpu"] * (D * M))
    ctx = dist_context_for(mesh)            # collective: every rank
    if mesh_coords(mesh) is None:
        if name == "s22":                   # the elastic 2x1 mesh's groups
            dist_context_for(make_host_mesh(2, 1, ["cpu"] * 2))
        continue
    mctx.set_context(ctx)
    cfg = reduced_config(arch)
    b = build_model(cfg, "cpu")
    opt = AdamWConfig(lr=%(lr)g, quant_state=quant)
    p0 = bridge.params_from_numpy(pickle.load(open(f"{wdir}/p0_{arch}.pkl", "rb")), "cpu")
    step = build_train_step(b, opt, mesh, lr_schedule=schedule.constant)
    st = reshard_state({"params": p0, "opt": adamw.init(p0, opt)}, mesh, step.specs)
    blocks = [list(np.shape(x)) for x in tr.leaves(to_ref(st, cfg))]
    src = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=%(seq)d, batch=%(batch)d))
    st, ms, step = run(mesh, b, opt, st, [src.batch_at(i) for i in range(%(steps)d)])
    whole = gather_state(st, mesh, step.specs)
    allblocks = [None] * (D * M)
    dist.all_gather_object(allblocks, blocks, group=step.g.world)
    if rank == 0:
        pickle.dump(dict(metrics=ms, state=to_ref(whole, cfg), blocks=allblocks),
                    open(f"{wdir}/port_{name}.pkl", "wb"))
    if name != "s22":
        mctx.set_context(None)
        continue
    # elastic restart: the whole state written at step 2, restored over
    # 2x1 and on one process; every run takes step 3
    ck = f"{wdir}/ckpt"
    if rank == 0:
        CheckpointManager(ck).save(%(steps)d, whole, {"mesh": "2x2"}, block=True)
    coll.barrier(step.g.world)
    nxt = [src.batch_at(%(steps)d)]
    st, m22, step = run(mesh, b, opt, st, nxt)
    w22 = gather_state(st, mesh, step.specs)
    mctx.set_context(None)
    out = {}
    if rank == 0:
        out["2x2"] = dict(metrics=m22, state=to_ref(w22, cfg))
    if rank < 2:
        m21 = make_host_mesh(2, 1, ["cpu"] * 2)
        mctx.set_context(dist_context_for(m21))
        tree, meta = CheckpointManager(ck).restore(abstract_state(b, opt))
        s21 = build_train_step(b, opt, m21, lr_schedule=schedule.constant)
        st21, mm, s21 = run(m21, b, opt, reshard_state(tree, m21, s21.specs), nxt)
        w21 = gather_state(st21, m21, s21.specs)
        mctx.set_context(None)
        if rank == 0:
            out["2x1"] = dict(metrics=mm, state=to_ref(w21, cfg), meta=meta)
            st1, m1, _ = run(None, b, opt, tree, nxt)
            out["1"] = dict(metrics=m1, state=to_ref(st1, cfg))
            pickle.dump(out, open(f"{wdir}/elastic.pkl", "wb"))
    else:
        dist_context_for(make_host_mesh(2, 1, ["cpu"] * 2))
dist.destroy_process_group()
print("done", rank, flush=True)
""" % dict(world=WORLD, timeout=TIMEOUT, seq=SEQ, batch=BATCH, steps=STEPS, lr=LR)


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    wdir = tmp_path_factory.mktemp("train_mesh")
    for arch in sorted({c[1] for c in CASES}):
        p = jax.tree.map(np.asarray, j_build(j_reduced(arch)).init(jax.random.PRNGKey(0)))
        with open(wdir / f"p0_{arch}.pkl", "wb") as f:
            pickle.dump(p, f)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"--xla_force_host_platform_device_count={WORLD}")
    cases = json.dumps(CASES)
    ref = subprocess.Popen([sys.executable, "-c", textwrap.dedent(REF), str(wdir), cases],
                           env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                           text=True)
    port = str(_free_port())
    tenv = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    ranks = [subprocess.Popen([sys.executable, "-c", RANK, str(r), port, str(wdir), cases],
                              env=tenv, cwd=ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for r in range(WORLD)]
    try:
        outs = [p.communicate(timeout=TIMEOUT) for p in ranks]
        rout = ref.communicate(timeout=TIMEOUT)
    finally:
        for p in ranks + [ref]:
            p.kill()
    for r, (p, (_, err)) in enumerate(zip(ranks, outs)):
        assert p.returncode == 0, f"rank {r}: {err[-3000:]}"
    assert ref.returncode == 0, rout[1][-3000:]

    def load(name):
        with open(wdir / name, "rb") as f:
            return pickle.load(f)
    return {"ref": {c[0]: load(f"ref_{c[0]}.pkl") for c in CASES},
            "port": {c[0]: load(f"port_{c[0]}.pkl") for c in CASES},
            "elastic": load("elastic.pkl"), "ckpt": wdir / "ckpt"}


def _close_state(got, want, quant):
    """The two states leaf by leaf (see the module docstring): floats
    within RTOL (rtol = atol) at all but OUTLIERS of the state's float
    elements, and with f32 moments every element within 2 lr a step; int8
    codes at most one apart, in at most CODES_APART of all codes."""
    gl = jax.tree_util.tree_flatten_with_path(got)[0]
    wl = jax.tree.leaves(want)
    assert len(gl) == len(wl)
    apart = total = over = floats = 0
    for (path, a), b in zip(gl, wl):
        key = jax.tree_util.keystr(path)
        b = np.asarray(b)
        assert a.shape == b.shape, key
        if a.dtype == np.int8 or b.dtype == np.int8:
            d = np.abs(a.astype(np.int32) - b.astype(np.int32))
            assert d.max() <= 1, key
            apart, total = apart + int(d.sum()), total + d.size
            continue
        d = np.abs(a.astype(np.float64) - b.astype(np.float64))
        over += int((d > RTOL * (1 + np.abs(b))).sum())
        floats += d.size
        if not quant:
            assert d.max() <= 2 * LR * STEPS, f"{key}: {d.max()}"
    assert over <= OUTLIERS * floats, f"{over} of {floats} elements past {RTOL}"
    assert apart <= CODES_APART * max(total, 1), f"{apart} of {total} codes apart"


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_sharded_step_matches_the_reference(runs, case):
    name, quant = case[0], case[4]
    got, want = runs["port"][name], runs["ref"][name]
    for s, (a, b) in enumerate(zip(got["metrics"], want["metrics"])):
        for k in ("loss", "xent", "aux", "grad_norm", "lr_scale"):
            np.testing.assert_allclose(a[k], b[k], rtol=RTOL, atol=1e-7,
                                       err_msg=f"step {s + 1} {k}")
    _close_state(got["state"], want["state"], quant)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_rank_blocks_are_the_reference_shards(runs, case):
    """Rank r's block of every state leaf (in the reference's layout: a
    pattern kind's layers stacked) has device r's shard shape."""
    name, D, M = case[0], case[2], case[3]
    want = runs["ref"][name]["shards"]
    got = runs["port"][name]["blocks"]
    assert len(got) == D * M
    for r in range(D * M):
        assert [w[r] for w in want] == got[r], f"rank {r}"


def test_elastic_restart_over_other_meshes(runs):
    el = runs["elastic"]
    assert el["2x1"]["meta"]["step"] == STEPS and el["2x1"]["meta"]["mesh"] == "2x2"
    base = el["2x2"]
    for other in ("2x1", "1"):
        for k in ("loss", "xent", "grad_norm"):
            np.testing.assert_allclose(el[other]["metrics"][0][k], base["metrics"][0][k],
                                       rtol=RTOL, err_msg=f"{other} {k}")
        _close_state(el[other]["state"], base["state"], False)


def test_checkpoint_loads_in_the_reference(runs):
    """The 2x2 run's checkpoint is the reference's format: its
    ``load_pytree`` restores it (same names, same digest) into the port's
    whole state."""
    from repro.checkpoint.io import load_pytree as j_load
    from repro.optim.adamw import OptState as JOpt

    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.configs import reduced_config
    from repro_torch.models import build_model
    from repro_torch.optim import AdamWConfig
    from repro_torch.train.train_step import abstract_state
    tb = build_model(reduced_config("stablelm-1.6b"), "cpu")
    mine, meta = CheckpointManager(str(runs["ckpt"])).restore(
        abstract_state(tb, AdamWConfig()))
    template = {"params": jax.tree.map(lambda t: np.zeros(t.shape, np.float32),
                                       _np_tree(mine["params"])),
                "opt": JOpt(*(jax.tree.map(lambda t: np.zeros(t.shape, np.float32),
                                           _np_tree(getattr(mine["opt"], f)))
                              if f != "step" else np.zeros((), np.int32)
                              for f in mine["opt"]._fields))}
    got, jmeta = j_load(template, os.path.join(str(runs["ckpt"]), f"step_{STEPS}"))
    assert jmeta["step"] == STEPS == meta["step"]
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(_np_tree(mine))):
        np.testing.assert_array_equal(np.asarray(a), b)


def _np_tree(t):
    """A port tree (tensors in dicts, lists and NamedTuples) as numpy, its
    None leaves kept out."""
    import torch
    if torch.is_tensor(t):
        return t.float().numpy() if t.is_floating_point() else t.numpy()
    if isinstance(t, dict):
        return {k: _np_tree(v) for k, v in t.items()}
    if isinstance(t, tuple) and hasattr(t, "_fields"):
        return type(t)(*(_np_tree(v) if v is not None else None for v in t))
    if isinstance(t, (list, tuple)):
        return type(t)(_np_tree(v) for v in t)
    return t
