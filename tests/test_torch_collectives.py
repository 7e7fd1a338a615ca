"""The port's expert parallelism and compressed all-reduce against the
reference's, over 8 gloo processes on the CPU (one spawn) and 8 forced
host devices (one JAX subprocess).

  * Expert parallelism: the reference's ``moe_ffn_tokens(axis_name=
    'model')`` under ``shard_map`` over a (2, 4) ('data', 'model') mesh of
    ``Mesh(np.array(jax.devices()).reshape(2, 4), ...)``, tokens over
    ('data', 'model'), aux ``pmean``ed over both, as
    ``models/transformer._apply_ffn`` runs it; the port's rank (d, m) takes
    data row d's tokens and runs ``_apply_ffn``'s composition
    (``split_rows`` over the model group, ``moe_ffn_tokens(group=)``,
    ``gather_rows``, ``mean_over``).  Reduced deepseek-v2 (router scale 16)
    and arctic experts, 8 of them, 2 a model rank, top 2, 64 tokens, at the
    configs' capacity factor (8.0: nothing drops) and at 0.5 (C = 2 a
    rank's 8 tokens: most assignments drop).  Routing (every expert id) and
    drops (every assignment's slot validity) exact; outputs and aux within
    1e-5; and the grads of L = sum(y w) / D + 0.01 aux within the
    train-mode tests' tolerance (1e-4 relative and 1e-4 of the leaf's
    largest |grad|; deepseek's router scale 16 makes its router grads ~75)
    of ``jax.grad`` through the reference's ``shard_map``: the router, the
    expert stacks (each rank's E / M block) and the tokens.  The port's
    come through the collectives' backward rules, each rank taking the
    grads of sum(y_d w_d) + 0.01 aux over its data row d and reducing them
    as the train step does: every param's summed over the data group and
    divided by D, the router's summed over the model group first, a
    token's divided by D.
  * ``compressed_psum`` over 4 ranks (``jax.pmap`` over 4 devices there):
    codes exact, output and error feedback within 1e-6.
  * ``moe_ffn_dense_masked(group=)``, the decode form, over the model
    group: the reference's dense-masked ``shard_map`` body's output.
"""
import json
import os
import pickle
import subprocess
import sys
import textwrap

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 240
WORLD = 8
D, M = 2, 4
T = 64
CASES = [("deepseek-v2-236b", None), ("deepseek-v2-236b", 0.5), ("arctic-480b", None),
         ("arctic-480b", 0.5)]
PSUM_N = 3 * 1024 + 17
TOL = 1e-5
GRAD_TOL = 1e-4         # tests/_torch_train_common.py's, of the leaf's largest |grad|

REF = """
import dataclasses, json, pickle, sys
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from repro.configs import reduced_config
from repro.distributed.collectives import compressed_psum, quantize_grad
from repro.models import moe as jmoe
from repro.models.context import shard_map
wdir, cases = sys.argv[1], json.loads(sys.argv[2])
D, M, T = %(D)d, %(M)d, %(T)d
mesh = Mesh(np.array(jax.devices()).reshape(D, M), ("data", "model"))
ax = ("data", "model")
spec = {"router": P(None, None), "we_gate": P("model", None, None),
        "we_up": P("model", None, None), "we_down": P("model", None, None)}
out = {}
for arch, cf in cases:
    cfg = reduced_config(arch).moe
    if cf is not None:
        cfg = dataclasses.replace(cfg, capacity_factor=cf)
    d = reduced_config(arch).d_model
    p = jmoe.moe_init(jax.random.PRNGKey(1), d, cfg, jnp.float32)
    rp = {k: p[k] for k in spec}
    rng = np.random.default_rng(2)
    x = rng.standard_normal((T, d)).astype(np.float32)
    w = rng.standard_normal((T, d)).astype(np.float32)

    def body(rp, xt):
        y, aux = jmoe.moe_ffn_tokens(rp, xt, cfg, axis_name="model",
                                     token_mask=jnp.ones((xt.shape[0],), bool))
        gates, ids, _ = jmoe.route(xt, rp["router"], cfg, jnp.ones((xt.shape[0],), bool))
        C = max(1, int(xt.shape[0] * cfg.top_k * cfg.capacity_factor / cfg.n_experts + 0.999))
        _, slot, valid = jmoe._bucket(jnp.repeat(xt, cfg.top_k, axis=0), ids.reshape(-1),
                                      cfg.n_experts, C)
        return y, jax.lax.pmean(aux, ax), ids, valid.reshape(ids.shape)

    f = shard_map(body, mesh=mesh, in_specs=(spec, P(ax, None)),
                  out_specs=(P(ax, None), P(), P(ax, None), P(ax, None)), check_vma=False)

    def loss(rp, x):
        y, aux, _, _ = f(rp, x)
        return jnp.sum(y * w) / D + 0.01 * aux

    y, aux, ids, valid = jax.jit(f)(rp, jnp.asarray(x))
    grads = jax.jit(jax.grad(loss, argnums=(0, 1)))(rp, jnp.asarray(x))

    def dense_body(rp, xt):
        y, aux = jmoe.moe_ffn_dense_masked(rp, xt, cfg, axis_name="model")
        return y, jax.lax.pmean(aux, ("data",))

    g = shard_map(dense_body, mesh=mesh, in_specs=(spec, P("data", None)),
                  out_specs=(P("data", None), P()), check_vma=False)
    yd, auxd = jax.jit(g)(rp, jnp.asarray(x))
    out[f"{arch}|{cf}"] = dict(
        params={k: np.asarray(v) for k, v in rp.items()}, x=x, w=w, y=np.asarray(y),
        aux=float(aux), ids=np.asarray(ids), valid=np.asarray(valid),
        grads={k: np.asarray(v) for k, v in grads[0].items()}, gx=np.asarray(grads[1]),
        y_dense=np.asarray(yd), aux_dense=float(auxd))
# compressed_psum over 4 devices
rng = np.random.default_rng(3)
g = (0.01 * rng.standard_normal((4, %(N)d))).astype(np.float32)
e = (0.001 * rng.standard_normal((4, %(N)d))).astype(np.float32)
o, err = jax.pmap(lambda a, b: compressed_psum(a, "dp", b), axis_name="dp",
                  devices=jax.devices()[:4])(jnp.asarray(g), jnp.asarray(e))
codes = np.stack([np.asarray(quantize_grad(jnp.asarray(g[r] + e[r]))[0]) for r in range(4)])
out["psum"] = dict(g=g, e=e, out=np.asarray(o), err=np.asarray(err), codes=codes)
pickle.dump(out, open(f"{wdir}/ref.pkl", "wb"))
""" % dict(D=D, M=M, T=T, N=PSUM_N)

RANK = """
import dataclasses, json, pickle, sys, time
import numpy as np, torch
torch.set_num_threads(1)
import torch.distributed as dist
from repro_torch.configs import reduced_config
from repro_torch.distributed import collectives as coll
from repro_torch.launch.mesh import init_distributed, make_host_mesh, mesh_groups
from repro_torch.models import moe as tmoe
rank, port, wdir = int(sys.argv[1]), sys.argv[2], sys.argv[3]
cases = json.loads(sys.argv[4])
D, M, T = %(D)d, %(M)d, %(T)d
init_distributed(f"127.0.0.1:{port}", %(world)d, rank, timeout=%(timeout)d)
while True:
    try:
        ref = pickle.load(open(f"{wdir}/ref.pkl", "rb"))
        break
    except (FileNotFoundError, EOFError, pickle.UnpicklingError):
        time.sleep(0.5)
g = mesh_groups(make_host_mesh(D, M, ["cpu"] * (D * M)))
d, m = g.coords["data"], g.coords["model"]
E_loc = 8 // M
res = {}
for arch, cf in cases:
    cfg = reduced_config(arch).moe
    if cf is not None:
        cfg = dataclasses.replace(cfg, capacity_factor=cf)
    r = ref[f"{arch}|{cf}"]
    rp = {k: torch.from_numpy(v).clone() for k, v in r["params"].items()}
    for k in ("we_gate", "we_up", "we_down"):
        rp[k] = rp[k][m * E_loc:(m + 1) * E_loc].contiguous()
    rp = {k: v.requires_grad_(True) for k, v in rp.items()}
    rows = T // D
    x = torch.from_numpy(r["x"][d * rows:(d + 1) * rows]).clone().requires_grad_(True)
    w = torch.from_numpy(r["w"][d * rows:(d + 1) * rows])
    seen = []
    route = tmoe.route

    def traced(xx, wr, c, token_mask=None):
        gates, ids, aux = route(xx, wr, c, token_mask)
        seen.append(ids.detach())
        return gates, ids, aux
    tmoe.route = traced
    xt = coll.split_rows(x, g.model)
    y, aux = tmoe.moe_ffn_tokens(rp, xt, cfg, group=g.model)
    tmoe.route = route
    y = coll.gather_rows(y, g.model)
    aux = coll.mean_over(aux, g.world, 1.0 / M)
    # the rank's objective as the train step assembles it: every param's
    # grad summed over the data group / D (the router's over the model
    # group first); a token's grad is its data row's, / D
    loss = torch.sum(y * w) + 0.01 * aux
    grads = torch.autograd.grad(loss, [rp["router"], rp["we_gate"], rp["we_up"],
                                       rp["we_down"], x])
    grads = [gr.contiguous() for gr in grads]
    coll.all_reduce_([grads[0]], g.model)
    coll.all_reduce_(grads[:4], g.data)
    grads = [gr / D for gr in grads]
    ids = seen[0]
    C = max(1, int(xt.shape[0] * cfg.top_k * cfg.capacity_factor / cfg.n_experts + 0.999))
    _, _, valid = tmoe._bucket(xt.detach().repeat_interleave(cfg.top_k, 0), ids.reshape(-1),
                               cfg.n_experts, C)
    with torch.no_grad():
        yd, auxd = tmoe.moe_ffn_dense_masked({k: v.detach() for k, v in rp.items()},
                                             x.detach(), cfg, group=g.model)
        auxd = coll.mean_over(auxd, g.data, 1.0)
    res[f"{arch}|{cf}"] = dict(y=y.detach().numpy(), aux=float(aux), ids=ids.numpy(),
                               valid=valid.reshape(ids.shape).numpy(),
                               grads=[gr.numpy() for gr in grads], y_dense=yd.numpy(),
                               aux_dense=float(auxd))
psum_group = dist.new_group([0, 1, 2, 3])
if rank < 4:
    p = ref["psum"]
    o, err = coll.compressed_psum(torch.from_numpy(p["g"][rank]), psum_group,
                                  torch.from_numpy(p["e"][rank]))
    codes = coll.quantize_grad(torch.from_numpy(p["g"][rank] + p["e"][rank]))[0]
    res["psum"] = dict(out=o.numpy(), err=err.numpy(), codes=codes.numpy())
pickle.dump(res, open(f"{wdir}/port_{rank}.pkl", "wb"))
dist.destroy_process_group()
""" % dict(D=D, M=M, T=T, world=WORLD, timeout=TIMEOUT)


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    wdir = tmp_path_factory.mktemp("collectives")
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
        rout = ref.communicate(timeout=TIMEOUT)
        outs = [p.communicate(timeout=TIMEOUT) for p in ranks]
    finally:
        for p in ranks + [ref]:
            p.kill()
    assert ref.returncode == 0, rout[1][-3000:]
    for r, (p, (_, err)) in enumerate(zip(ranks, outs)):
        assert p.returncode == 0, f"rank {r}: {err[-3000:]}"

    def load(name):
        with open(wdir / name, "rb") as f:
            return pickle.load(f)
    return load("ref.pkl"), [load(f"port_{r}.pkl") for r in range(WORLD)]


@pytest.mark.parametrize("arch,cf", CASES, ids=[f"{a.split('-')[0]}-cf{c}" for a, c in CASES])
def test_expert_parallel_moe_matches_the_reference(runs, arch, cf):
    ref, port = runs
    r = ref[f"{arch}|{cf}"]
    rows, blk = T // D, T // (D * M)
    E_loc = 8 // M
    for rank, res in enumerate(port):
        d, m = divmod(rank, M)
        got = res[f"{arch}|{cf}"]
        lo = (d * M + m) * blk
        np.testing.assert_array_equal(got["ids"], r["ids"][lo:lo + blk], err_msg=f"rank {rank}")
        np.testing.assert_array_equal(got["valid"], r["valid"][lo:lo + blk])
        np.testing.assert_allclose(got["y"], r["y"][d * rows:(d + 1) * rows], rtol=TOL, atol=TOL)
        np.testing.assert_allclose(got["aux"], r["aux"], rtol=TOL)
        gr, gg, gu, gd, gx = got["grads"]
        for k, v, want in (("router", gr, r["grads"]["router"]),
                           ("we_gate", gg, r["grads"]["we_gate"][m * E_loc:(m + 1) * E_loc]),
                           ("we_up", gu, r["grads"]["we_up"][m * E_loc:(m + 1) * E_loc]),
                           ("we_down", gd, r["grads"]["we_down"][m * E_loc:(m + 1) * E_loc]),
                           ("x", gx, r["gx"][d * rows:(d + 1) * rows])):
            np.testing.assert_allclose(v, want, rtol=GRAD_TOL,
                                       atol=GRAD_TOL * np.abs(r["grads"]["router"] if k == "router"
                                                              else want).max(),
                                       err_msg=f"rank {rank} {k}")
        np.testing.assert_allclose(got["y_dense"], r["y_dense"][d * rows:(d + 1) * rows],
                                   rtol=TOL, atol=TOL)
        np.testing.assert_allclose(got["aux_dense"], r["aux_dense"], rtol=TOL)
    if cf is not None:          # the tight case drops, and the port drops the same
        assert not r["valid"].all()


def test_compressed_psum_matches_the_reference(runs):
    ref, port = runs
    p = ref["psum"]
    for rank in range(4):
        got = port[rank]["psum"]
        np.testing.assert_array_equal(got["codes"], p["codes"][rank])
        np.testing.assert_allclose(got["out"], p["out"][rank], rtol=0, atol=1e-6)
        np.testing.assert_allclose(got["err"], p["err"][rank], rtol=0, atol=1e-6)
    want = p["g"].sum(0) + p["e"].sum(0)
    rel = np.linalg.norm(port[0]["psum"]["out"] - want) / np.linalg.norm(want)
    assert rel < 0.05, rel
