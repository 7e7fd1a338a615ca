"""The port's sequence-parallel prefill (``serve/seq_parallel.SeqPrefill``)
against the reference's opt prefill, over ('data', 'model') meshes.

The reference runs its own (``repro/launch/dryrun.py:101-166``):
``jax.jit(bundle.prefill)`` with the params laid out by ``param_specs``,
the batch by ``batch_spec(..., seq_over_model=True)`` and the caches by
``cache_spec(..., seq_over_model=True)``, under
``use_context(dist_context_for(mesh))``, executed in one subprocess over 8
forced host devices on a ``jax.sharding.Mesh`` of the first D * M
(``launch/mesh.make_host_mesh`` builds Explicit axes that stop sharded
programs on jax 0.9; ROADMAP Queue 3).  The port runs the same cases in one
spawn of 4 gloo processes on the CPU, one a mesh entry (a 1x2 case uses
ranks 0-1), from the same numpy weights (the reference's init) and inputs.

Cases (reduced configs, 64 positions): stablelm-1.6b over 1x2 and, with
the int8 KV cache, over 2x2 (2 rows a replica); gemma2-2b over 1x4 (its
16-slot rings split 4 slots a rank, the prefill past the window) and over
1x2 with a 9-slot window (W % M != 0: each rank lands its head block of
every slot); deepseek-v2-236b over 2x2 (MLA; MoE with 4 experts a model
rank and a capacity factor of 0.5, which binds: 2 rows a replica, so the
routed FFN regroups its tokens into the reference's capacity groups);
zamba2-7b over 1x4 (the SSD's state carried over four blocks, the conv's
left context from the block before; its shared attention block);
phi-3-vision-4.2b over 1x4 (8 patches in rank 0's block) and
seamless-m4t-medium over 1x2 (the encoder over 8 frames, cross K/V head
blocks).  Checked:
  * every rank's logits (every row's last token) and every cache leaf,
    joined from the ranks' blocks, against the reference's: float leaves
    and logits within the families' one-device bound (rtol = atol = 1e-5,
    ``tests/test_torch_families.py:142``,
    ``tests/test_torch_families_extras.py:166``, ``tests/test_torch_mla.py:85``),
    int8 codes at most one apart in at most 1 in 1000 (``CODE_FLIPS``),
    ``pos`` and ``len`` equal;
  * the same against the port's one-process ``bundle.prefill`` of the same
    rows, tighter: floats within 1e-6 (measured: 1.5e-7 at most), codes and
    integers equal - but deepseek-v2's, whose binding capacity groups are
    the reference's, not one process's; and over 2x2 with PDQ-int8 weights
    and the int8 KV cache (stablelm), which the reference's
    ``quantize_param_tree`` does not give its stacked blocks;
  * each rank's block of every cache leaf has the shape of the matching
    device's shard in the reference (``addressable_shards``);
  * a sequence that does not split evenly over the model ranks is refused.
"""
import dataclasses
import json
import os
import pickle
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as j_reduced
from repro.models import build_model as j_build

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 240
WORLD = 4
RTOL = ATOL = 1e-5          # the families' one-device prefill bound
ONE_ATOL = 1e-6             # against the port's one-process prefill
CODE_FLIPS = 1e-3
CAPACITY = 0.5              # deepseek-v2's capacity factor here: it binds
S, MEM = 64, 8
# (name, arch, D, M, rows, config overrides, PDQ-int8 weights: the port alone)
CASES = [("s12", "stablelm-1.6b", 1, 2, 2, {}, False),
         ("s22k", "stablelm-1.6b", 2, 2, 4, {"quant_kv": "dynamic"}, False),
         ("s22q", "stablelm-1.6b", 2, 2, 4, {"quant_kv": "dynamic"}, True),
         ("g14", "gemma2-2b", 1, 4, 2, {}, False),
         ("g12w", "gemma2-2b", 1, 2, 2, {"window": 9}, False),
         ("d22", "deepseek-v2-236b", 2, 2, 4, {"capacity_factor": CAPACITY}, False),
         ("z14", "zamba2-7b", 1, 4, 2, {}, False),
         ("v14", "phi-3-vision-4.2b", 1, 4, 2, {}, False),
         ("a12", "seamless-m4t-medium", 1, 2, 2, {}, False)]
REF_CASES = [c for c in CASES if not c[6]]

CONFIG = """
import dataclasses
def config(reduced_config, arch, ov):
    ov = dict(ov)
    cap = ov.pop("capacity_factor", None)
    cfg = reduced_config(arch, **ov)
    if cap is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=cap))
    return cfg
"""

REF = CONFIG + """
import json, pickle, sys
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from repro.configs import reduced_config
from repro.distributed import sharding as shd
from repro.models import build_model
from repro.models import context as mctx
from repro.train.train_step import dist_context_for
wdir, cases = sys.argv[1], json.loads(sys.argv[2])


def path_str(p):
    return "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in p)


for name, arch, D, M, B, ov, _ in cases:
    mesh = Mesh(np.array(jax.devices()[:D * M]).reshape(D, M), ("data", "model"))
    cfg = config(reduced_config, arch, ov)
    bundle = build_model(cfg)
    inp = pickle.load(open(f"{wdir}/in_{name}.pkl", "rb"))
    params = jax.tree.map(jnp.asarray, inp["params"])
    batch = {k: jnp.asarray(v) for k, v in inp["batch"].items()}
    caches = bundle.init_caches(B, %(S)d, inp["mem"])
    named = lambda t: jax.tree.map(lambda s: NamedSharding(mesh, s), t,
                                   is_leaf=lambda x: isinstance(x, P))
    csh = named(shd.cache_spec(mesh, caches, B, seq_over_model=True))
    with mctx.use_context(dist_context_for(mesh)):
        fn = jax.jit(bundle.prefill,
                     in_shardings=(named(shd.param_specs(params, mesh)),
                                   named(shd.batch_spec(mesh, batch, seq_over_model=True)),
                                   csh),
                     out_shardings=(NamedSharding(mesh, P()), csh))
        logits, caches = fn(params, batch, caches)
    leaves = jax.tree_util.tree_flatten_with_path(caches)[0]
    pickle.dump(dict(
        logits=np.asarray(logits),
        caches={path_str(p): np.asarray(x) for p, x in leaves},
        shards={path_str(p): [list(s.data.shape) for s in sorted(
            x.addressable_shards, key=lambda s: s.device.id)] for p, x in leaves}),
        open(f"{wdir}/ref_{name}.pkl", "wb"))
    print(name, flush=True)
""" % dict(S=S)

RANK = CONFIG + """
import json, pickle, sys
import numpy as np, torch
torch.set_num_threads(1)
import torch.distributed as dist
from repro_torch import bridge, tree as tr
from repro_torch.configs import reduced_config
from repro_torch.launch.mesh import init_distributed, make_host_mesh, mesh_groups
from repro_torch.models import build_model
from repro_torch.models.linops import quantize_param_tree
from repro_torch.serve.seq_parallel import SeqPrefill
rank, port, wdir = int(sys.argv[1]), sys.argv[2], sys.argv[3]
cases = json.loads(sys.argv[4])
init_distributed(f"127.0.0.1:{port}", %(world)d, rank, timeout=%(timeout)d)


def np_of(t):
    return t.float().numpy() if t.is_floating_point() else t.numpy()


for name, arch, D, M, B, ov, quant in cases:
    mesh = make_host_mesh(D, M, ["cpu"] * (D * M))
    g = mesh_groups(mesh)                       # collective: every rank
    if g is None:
        continue
    cfg = config(reduced_config, arch, ov)
    b = build_model(cfg, "cpu")
    inp = pickle.load(open(f"{wdir}/in_{name}.pkl", "rb"))
    params = bridge.params_from_numpy(inp["params"], "cpu")
    if quant:
        params = quantize_param_tree(params)
    batch = {k: torch.from_numpy(v) for k, v in inp["batch"].items()}
    prog = SeqPrefill(b, mesh, B, %(S)d, mem_len=inp["mem"])
    blocks = prog.place_params(params)
    caches = prog.init_caches()
    logits = prog(blocks, prog.place_batch(batch), caches)
    mine = dict(logits=logits.numpy(),
                blocks={tr.path_str(p): np_of(x) for p, x in tr.leaves_with_path(caches)},
                regions={tr.path_str(p): [(s.start, s.stop) for s in prog._region(spec, x.shape)]
                         for (p, x), spec in zip(tr.leaves_with_path(prog.template),
                                                 tr.leaves(prog.cache_specs))})
    every = [None] * (D * M)
    dist.all_gather_object(every, mine, group=g.world)
    if rank == 0:
        one_c = b.init_caches(B, %(S)d, inp["mem"])
        one_l, _ = b.prefill(params, batch, one_c)
        pickle.dump(dict(ranks=every, one_logits=one_l.numpy(),
                         one_caches={tr.path_str(p): np_of(x)
                                     for p, x in tr.leaves_with_path(one_c)}),
                    open(f"{wdir}/port_{name}.pkl", "wb"))
dist.destroy_process_group()
print("done", rank, flush=True)
""" % dict(world=WORLD, timeout=TIMEOUT, S=S)


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _inputs(cfg, B, seed):
    rng = np.random.default_rng(seed)
    P = cfg.frontend_tokens if cfg.frontend == "vision" else 0
    batch = {"tokens": rng.integers(0, cfg.vocab, (B, S - P)).astype(np.int32)}
    if P:
        batch["patches"] = (0.02 * rng.standard_normal((B, P, cfg.d_model))).astype(np.float32)
    mem = MEM if cfg.family == "encdec" else 0
    if mem:
        batch["frames"] = (0.02 * rng.standard_normal((B, mem, cfg.d_model))).astype(np.float32)
    return batch, mem


def _j_config(arch, ov):
    ov = dict(ov)
    cap = ov.pop("capacity_factor", None)
    cfg = j_reduced(arch, **ov)
    if cap is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=cap))
    return cfg


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    wdir = tmp_path_factory.mktemp("seq_prefill")
    for i, (name, arch, D, M, B, ov, _) in enumerate(CASES):
        cfg = _j_config(arch, ov)
        params = jax.tree.map(np.asarray, j_build(cfg).init(jax.random.PRNGKey(i)))
        batch, mem = _inputs(cfg, B, i)
        with open(wdir / f"in_{name}.pkl", "wb") as f:
            pickle.dump(dict(params=params, batch=batch, mem=mem), f)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    ref = subprocess.Popen([sys.executable, "-c", textwrap.dedent(REF), str(wdir),
                            json.dumps(REF_CASES)], env=env, cwd=ROOT,
                           stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    port = str(_free_port())
    tenv = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    ranks = [subprocess.Popen([sys.executable, "-c", RANK, str(r), port, str(wdir),
                               json.dumps(CASES)], env=tenv, cwd=ROOT,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(WORLD)]
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
    return {"ref": {c[0]: load(f"ref_{c[0]}.pkl") for c in REF_CASES},
            "port": {c[0]: load(f"port_{c[0]}.pkl") for c in CASES}}


def _joined(port):
    """Every cache leaf whole, from the ranks' blocks and regions; a region
    that several ranks hold must agree between them exactly, and every
    element must be held."""
    out = {}
    for path in port["ranks"][0]["blocks"]:
        regions = [r["regions"][path] for r in port["ranks"]]
        shape = tuple(max(reg[k][1] for reg in regions) for k in range(len(regions[0])))
        whole = np.zeros(shape, port["ranks"][0]["blocks"][path].dtype)
        held = np.zeros(shape, bool)
        for r, reg in zip(port["ranks"], regions):
            sl = tuple(slice(a, b) for a, b in reg)
            blk = r["blocks"][path]
            assert (whole[sl][held[sl]] == blk[held[sl]]).all(), f"{path}: ranks disagree"
            whole[sl], held[sl] = blk, True
        assert held.all(), f"{path}: not every element held"
        out[path] = whole
    return out


def _close(got, want, what, atol, rtol, code_flips):
    """Logits or a cache leaf: int8 codes at most one apart in at most
    ``code_flips`` of them, other integers equal, floats within the
    bound."""
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if want.dtype == np.int8:
        d = np.abs(got.astype(np.int32) - want.astype(np.int32))
        assert d.max() <= (1 if code_flips else 0) and (d > 0).mean() <= code_flips, (
            what, int(d.max()), float((d > 0).mean()))
    elif want.dtype.kind in "iu":
        np.testing.assert_array_equal(got, want, err_msg=what)
    else:
        np.testing.assert_allclose(got, want.astype(np.float32), rtol=rtol, atol=atol,
                                   err_msg=what)


def _check(port, want_logits, want_caches, atol, rtol, code_flips):
    for r, rank in enumerate(port["ranks"]):
        _close(rank["logits"], want_logits, f"rank {r} logits", atol, rtol, 0.0)
    got = _joined(port)
    assert sorted(got) == sorted(want_caches)
    for path, x in got.items():
        _close(x, want_caches[path], path, atol, rtol, code_flips)


@pytest.mark.parametrize("case", REF_CASES, ids=[c[0] for c in REF_CASES])
def test_seq_prefill_matches_the_reference(runs, case):
    ref = runs["ref"][case[0]]
    _check(runs["port"][case[0]], ref["logits"], ref["caches"], ATOL, RTOL, CODE_FLIPS)


ONE_CASES = [c for c in CASES if c[0] != "d22"]


@pytest.mark.parametrize("case", ONE_CASES, ids=[c[0] for c in ONE_CASES])
def test_seq_prefill_matches_one_process(runs, case):
    port = runs["port"][case[0]]
    _check(port, port["one_logits"], port["one_caches"], ONE_ATOL, 0.0, 0.0)


def test_binding_capacity_parts_from_one_process(runs):
    """deepseek-v2's capacity binds: the reference's groups (a replica's
    rows in M pieces) drop other tokens than one process's one group."""
    port = runs["port"]["d22"]
    assert np.abs(port["ranks"][0]["logits"] - port["one_logits"]).max() > 1e-3


@pytest.mark.parametrize("case", REF_CASES, ids=[c[0] for c in REF_CASES])
def test_rank_blocks_are_the_reference_shards(runs, case):
    name, D, M = case[0], case[2], case[3]
    shards = runs["ref"][name]["shards"]
    ranks = runs["port"][name]["ranks"]
    assert sorted(shards) == sorted(ranks[0]["blocks"])
    for path, per_device in shards.items():
        assert len(per_device) == D * M
        for r in range(D * M):
            assert list(ranks[r]["blocks"][path].shape) == per_device[r], (path, r)


def test_uneven_split_is_refused():
    from repro_torch.configs import reduced_config
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import build_model
    from repro_torch.serve.seq_parallel import SeqPrefill
    b = build_model(reduced_config("stablelm-1.6b"), "cpu")
    with pytest.raises(ValueError, match="do not split over 2 model ranks"):
        SeqPrefill(b, make_host_mesh(1, 2, ["cpu"] * 2), 2, 63)
