"""The port's training substrates against the JAX package's, on the CPU:
the data pipeline (``repro_torch/data/pipeline.py``), the schedules and
AdamW (``optim/``), the checkpoint format (``checkpoint/``) and
MODEL_FLOPS (``launch/model_flops.py``).

Tolerances:
- batches, int8 moment codes, checkpoint digests and FLOP counts: exact;
- ``warmup_cosine``: 1e-6 relative (float32 ``cos`` and ``pow`` may round
  one ulp apart between XLA and torch);
- AdamW after one and three updates on a reduced model (stablelm, zamba2,
  seamless) from the same params and grads: params and f32 moments within
  1e-5 (relative and absolute; the global norm sums the leaves in another
  order); the int8 states' scales within 1e-5 and their codes equal while
  the clip is inactive, else at most one apart in at most 1 in 1000.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.io import load_pytree as j_load
from repro.checkpoint.io import save_pytree as j_save
from repro.configs import ALL_ARCHS
from repro.configs import get_config as j_get
from repro.configs import reduced_config as j_reduced
from repro.data import pipeline as jpipe
from repro.launch import model_flops as jflops
from repro.models import SHAPES as J_SHAPES
from repro.models import build_model as j_build
from repro.optim import adamw as jadamw
from repro.optim import schedule as jsched

from repro_torch import bridge
from repro_torch import tree as ttree
from repro_torch.checkpoint import CheckpointManager
from repro_torch.checkpoint.io import load_pytree, save_pytree
from repro_torch.configs import get_config as t_get
from repro_torch.configs import reduced_config as t_reduced
from repro_torch.data import pipeline as tpipe
from repro_torch.launch import model_flops as tflops
from repro_torch.models.api import SHAPES as T_SHAPES
from repro_torch.models.layers import MetaGenerator
from repro_torch.models.transformer import lm_init
from repro_torch.optim import adamw as tadamw
from repro_torch.optim import schedule as tsched

TOL = 1e-5


# ------------------------------------------------------------------- data
@pytest.mark.parametrize("seed,shard,num_shards", [(0, 0, 1), (7, 1, 4), (3, 3, 4)])
def test_synthetic_batches_equal_the_reference(seed, shard, num_shards):
    kw = dict(vocab=500, seq_len=24, batch=3, seed=seed, shard_id=shard,
              num_shards=num_shards)
    j, t = jpipe.SyntheticLM(jpipe.DataConfig(**kw)), tpipe.SyntheticLM(tpipe.DataConfig(**kw))
    for step in (0, 1, 19):
        jb, tb = j.batch_at(step), t.batch_at(step)
        assert jb.keys() == tb.keys()
        for k in jb:
            assert tb[k].dtype == jb[k].dtype
            np.testing.assert_array_equal(tb[k], jb[k])


@pytest.mark.parametrize("dtype", [np.uint16, np.uint32])
def test_file_tokens_equal_the_reference(tmp_path, dtype):
    path = os.path.join(tmp_path, "toks.bin")
    np.random.default_rng(0).integers(0, 60000, 9000).astype(dtype).tofile(path)
    kw = dict(vocab=700, seq_len=32, batch=4, kind="file", path=path, seed=2,
              shard_id=1, num_shards=2)
    j = jpipe.FileTokens(jpipe.DataConfig(**kw), dtype=dtype)
    t = tpipe.FileTokens(tpipe.DataConfig(**kw), dtype=dtype)
    for step in (0, 5):
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(t.batch_at(step)[k], j.batch_at(step)[k])
    assert isinstance(tpipe.make_source(tpipe.DataConfig(**kw)), tpipe.FileTokens)


def test_prefetcher_yields_the_steps_in_order():
    cfg = tpipe.DataConfig(vocab=300, seq_len=8, batch=2, prefetch=2)
    pf = tpipe.Prefetcher(cfg, start_step=4)
    src = jpipe.SyntheticLM(jpipe.DataConfig(vocab=300, seq_len=8, batch=2))
    try:
        for want, (step, batch) in zip(range(4, 7), pf):
            assert step == want
            np.testing.assert_array_equal(batch["tokens"], src.batch_at(step)["tokens"])
    finally:
        pf.close()


# -------------------------------------------------------------- schedules
@pytest.mark.parametrize("kw", [{}, dict(warmup=10, total=50, min_frac=0.2),
                                dict(warmup=0, total=1)])
def test_warmup_cosine_matches_the_reference(kw):
    for step in (0, 1, 5, 9, 10, 19, 37, 50, 99, 100, 101, 5000, 9999, 20000):
        want = float(jsched.warmup_cosine(jnp.int32(step), **kw))
        got = tsched.warmup_cosine(torch.tensor(step, dtype=torch.int32), **kw)
        assert got.dtype == torch.float32 and got.dim() == 0
        np.testing.assert_allclose(float(got), want, rtol=1e-6, atol=1e-7)
    assert float(tsched.constant(3, value=0.5)) == float(jsched.constant(3, value=0.5))


# ---------------------------------------------------------- int8 moments
@pytest.mark.parametrize("shape", [(1000,), (3, 64), (5, 7, 130), (64,), ()])
def test_q8_codes_and_scales_equal_the_reference(shape):
    rng = np.random.default_rng(len(shape))
    x = np.asarray(rng.standard_normal(shape) * 0.1, dtype=np.float32)
    if x.ndim:
        # exact .5 ties against the block's scale (amax 1.27 -> scale 0.01)
        flat = x.reshape(-1)
        flat[:4] = [1.27, 0.025, -0.035, 0.005]
    jq, js = jadamw._q8(jnp.asarray(x))
    tq, ts = tadamw._q8(torch.from_numpy(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    back = tadamw._dq8(tq, ts, shape)
    np.testing.assert_array_equal(back.numpy(), np.asarray(jadamw._dq8(jq, js, shape)))
    assert tuple(back.shape) == shape


# ------------------------------------------------------------------ AdamW
_MODELS = {}


def _model(arch):
    """(reference cfg, port cfg, reference params as numpy, three seeded
    N(0, 1) grad trees in the params' tree)."""
    if arch not in _MODELS:
        jc, tc = j_reduced(arch), t_reduced(arch)
        p = jax.tree.map(np.asarray, j_build(jc).init(jax.random.PRNGKey(0)))
        rng = np.random.default_rng(3)
        gs = [jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(a.dtype), p)
              for _ in range(3)]
        _MODELS[arch] = jc, tc, p, gs
    return _MODELS[arch]


def _close(got, want):
    jax.tree.map(lambda a, b: np.testing.assert_allclose(a, np.asarray(b), rtol=TOL, atol=TOL),
                 got, want)


@pytest.mark.parametrize("grad_scale", [1e-5, 0.05])
@pytest.mark.parametrize("quant_state", [False, True])
@pytest.mark.parametrize("arch", ["stablelm-1.6b", "zamba2-7b", "seamless-m4t-medium"])
def test_apply_updates_match_the_reference(arch, quant_state, grad_scale):
    """One and three updates from the same params, grads and state: the
    port's params and state, back in the reference's layout
    (``bridge.params_to_numpy`` / ``opt_state_to_numpy``), equal JAX's
    within TOL; the state crosses over through ``opt_state_from_numpy``
    after the first update.  At grad_scale 1e-5 the global norm stays
    under ``grad_clip`` (clip exactly 1), so the int8 codes must be equal;
    at 0.05 the clip factor comes from a norm summed in another order, and
    a code may sit one apart (at most 1 in 1000 of them), and each update
    then starts from the reference's state."""
    jc, tc, p, gs = _model(arch)
    gs = [jax.tree.map(lambda a: (grad_scale * a).astype(a.dtype), g) for g in gs]
    jcfg = jadamw.AdamWConfig(lr=1e-2, quant_state=quant_state)
    tcfg = tadamw.AdamWConfig(lr=1e-2, quant_state=quant_state)
    jp, js = jax.tree.map(jnp.asarray, p), jadamw.init(p, jcfg)
    tp = bridge.params_from_numpy(p, "cpu")
    ts = tadamw.init(tp, tcfg)
    for i, g in enumerate(gs):
        lr_scale = 0.5 + 0.25 * i
        jp, js = jadamw.apply_updates(jp, jax.tree.map(jnp.asarray, g), js, jcfg, lr_scale)
        tp, ts = tadamw.apply_updates(tp, bridge.params_from_numpy(g, "cpu"), ts, tcfg,
                                      lr_scale)
        got_p, got = bridge.params_to_numpy(tp, tc), bridge.opt_state_to_numpy(ts, tc)
        _close(got_p, jp)
        assert int(got.step) == int(js.step) == i + 1
        if not quant_state:
            _close(got.m, js.m)
            _close(got.v, js.v)
        else:
            _close(got.m_scale, js.m_scale)
            _close(got.v_scale, js.v_scale)
            for side in ("m", "v"):
                codes = [(a.astype(np.int32), np.asarray(b).astype(np.int32)) for a, b in
                         zip(jax.tree.leaves(getattr(got, side)),
                             jax.tree.leaves(getattr(js, side)))]
                diff = np.concatenate([np.abs(a - b).reshape(-1) for a, b in codes])
                if grad_scale < 1e-3:
                    assert diff.max() == 0, side
                else:
                    assert diff.max() <= 1 and diff.mean() <= 1e-3, (side, diff.mean())
        if i == 0 or (quant_state and grad_scale > 1e-3):
            # carry the reference's state across (with a code one apart,
            # each update then starts from the reference's own moments)
            ts = bridge.opt_state_from_numpy(jax.tree.map(np.asarray, js), "cpu")
            tp = bridge.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


@pytest.mark.parametrize("arch", ["stablelm-1.6b", "zamba2-7b", "seamless-m4t-medium"])
def test_decay_set_is_the_reference_layouts_matrices(arch):
    """``adamw.decayed`` picks exactly the leaves the reference decays
    (``p.ndim >= 2`` in its stacked layout): every scanned block's norms
    and SSD vectors, no head/tail/shared-block norm, no ``final_norm``."""
    jc, tc, p, _ = _model(arch)
    tp = bridge.params_from_numpy(p, "cpu")
    marks = ttree.map_with_path(lambda path, x: torch.tensor(float(tadamw.decayed(path, x))),
                                tp)
    got = bridge.params_to_numpy(marks, tc)
    want = jax.tree.map(lambda a: float(a.ndim >= 2), p)
    jax.tree.map(lambda g, w: np.testing.assert_array_equal(np.unique(g), [w]), got, want)
    names = {ttree.path_str(path) for path, x in ttree.leaves_with_path(tp)
             if tadamw.decayed(path, x) and x.dim() == 1}
    if arch == "zamba2-7b":
        assert "blocks/0/ssm/A_log" in names and "blocks/0/norm" in names
        assert not any(n.startswith(("tail/", "shared_block/")) for n in names)
    assert "final_norm" not in names


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_no_registered_config_has_a_scalar_param(arch):
    """The int8 states block a 0-dim leaf differently in the two layouts;
    no registered config has one (full size, shapes only)."""
    params = lm_init(MetaGenerator(), t_get(arch))
    assert all(x.dim() >= 1 for x in ttree.leaves(params))


# ------------------------------------------------------------- checkpoint
def test_reference_checkpoint_loads_in_the_port(tmp_path):
    """A tree of dicts and lists saved by the reference's ``save_pytree``
    loads in the port, digest verified, bf16 back as bf16."""
    rng = np.random.default_rng(0)
    tree = {"params": {"w": rng.standard_normal((3, 5)).astype(np.float32),
                       "layers": [{"g": np.arange(70, dtype=np.int8)},
                                  {"g": -np.arange(70, dtype=np.int8)}]},
            "emb": jnp.asarray(rng.standard_normal((2000, 3)), jnp.bfloat16),
            "step": np.int32(7)}
    d = os.path.join(tmp_path, "step_7")
    j_save(tree, d, extra_meta={"step": 7})
    template = {"params": {"w": torch.zeros(3, 5), "layers": [
        {"g": torch.zeros(70, dtype=torch.int8)}, {"g": torch.zeros(70, dtype=torch.int8)}]},
        "emb": torch.zeros((2000, 3), dtype=torch.bfloat16), "step": torch.zeros((), dtype=torch.int32)}
    out, meta = load_pytree(template, d)
    assert meta["step"] == 7
    np.testing.assert_array_equal(out["params"]["w"].numpy(), tree["params"]["w"])
    np.testing.assert_array_equal(out["params"]["layers"][1]["g"].numpy(),
                                  tree["params"]["layers"][1]["g"])
    assert out["emb"].dtype == torch.bfloat16
    np.testing.assert_array_equal(out["emb"].float().numpy(),
                                  np.asarray(tree["emb"], np.float32))
    assert int(out["step"]) == 7
    # and the port's save of the same tree carries the same names and digest
    save_pytree(template | {"params": {"w": torch.from_numpy(tree["params"]["w"]),
                                       "layers": out["params"]["layers"]},
                            "emb": out["emb"], "step": out["step"]},
                os.path.join(tmp_path, "port"), extra_meta={"step": 7})
    with open(os.path.join(d, "meta.json")) as f:
        jm = json.load(f)
    with open(os.path.join(tmp_path, "port", "meta.json")) as f:
        tm = json.load(f)
    assert tm["names"] == jm["names"] and tm["digest"] == jm["digest"]
    back, _ = j_load(jax.tree.map(np.asarray, tree), os.path.join(tmp_path, "port"))
    np.testing.assert_array_equal(np.asarray(back["emb"], np.float32),
                                  np.asarray(tree["emb"], np.float32))


def test_checkpoint_roundtrip_integrity_and_optstate(tmp_path):
    params = {"a": torch.arange(10, dtype=torch.float32),
              "b": {"c": torch.ones((3, 4), dtype=torch.bfloat16)}, "empty": ()}
    opt = tadamw.init(params, tadamw.AdamWConfig(quant_state=True))
    tree = {"params": params, "opt": opt}
    d = os.path.join(tmp_path, "ck")
    save_pytree(tree, d, extra_meta={"step": 3})
    with open(os.path.join(d, "meta.json")) as f:
        assert "opt/.m_scale/b/c" in json.load(f)["names"]
    meta_template = {"params": {"a": torch.empty(10, device="meta"),
                                "b": {"c": torch.empty((3, 4), dtype=torch.bfloat16,
                                                       device="meta")}, "empty": ()},
                     "opt": tadamw.init(params, tadamw.AdamWConfig(quant_state=True))}
    out, meta = load_pytree(meta_template, d)
    assert meta["step"] == 3 and isinstance(out["opt"], tadamw.OptState)
    for a, b in zip(ttree.leaves(out), ttree.leaves(tree)):
        assert a.dtype == b.dtype and a.device.type == "cpu" and torch.equal(a, b)
    with open(os.path.join(d, "meta.json")) as f:
        m = json.load(f)
    m["digest"] = "0" * 64
    with open(os.path.join(d, "meta.json"), "w") as f:
        json.dump(m, f)
    with pytest.raises(IOError):
        load_pytree(tree, d)


def test_manager_rotation_latest_and_async(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for step in (10, 20, 30):
        mgr.save(step, {"w": torch.full((4,), float(step))})
    mgr.wait()
    assert mgr.steps() == [20, 30] and mgr.latest_step() == 30
    out, meta = mgr.restore({"w": torch.zeros(4)})
    assert meta["step"] == 30 and float(out["w"][0]) == 30.0
    out, meta = mgr.restore({"w": torch.zeros(4)}, step=20)
    assert float(out["w"][0]) == 20.0
    assert CheckpointManager(str(tmp_path / "none")).restore({"w": torch.zeros(4)}) == (None,
                                                                                        None)


# ------------------------------------------------------------- MODEL_FLOPS
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_model_flops_equal_the_reference(arch):
    """``param_counts`` and ``model_flops`` for every SHAPES entry equal the
    reference's exactly (the port counts per-layer leaves of a meta-device
    init; the experts are found under each layer's path)."""
    assert {k: (v.kind, v.seq, v.batch) for k, v in T_SHAPES.items()} == \
        {k: (v.kind, v.seq, v.batch) for k, v in J_SHAPES.items()}
    jc, tc = j_get(arch), t_get(arch)
    assert tflops.param_counts(tc) == jflops.param_counts(jc)
    for shape in J_SHAPES:
        assert tflops.model_flops(tc, shape) == jflops.model_flops(jc, shape), shape
