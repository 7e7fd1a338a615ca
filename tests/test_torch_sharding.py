"""The port's training layout rules against the reference's
(``repro/distributed/sharding.py``, ``repro/train/train_step.state_specs``):
``param_specs``, ``state_specs`` (f32 and int8 moments), ``batch_spec``
(with and without sequence parallelism) and ``cache_spec`` (a batch that
the data axis divides, and batch 1: context parallel) for every registered
config, full and reduced, on 1x2, 2x1, 2x2, 4x2 and 16x16 meshes.

The rules read only ``mesh.shape`` and ``mesh.axis_names``, so a
``SimpleNamespace`` stands for each mesh on both sides, and every tree is
shapes only: the reference's from ``jax.eval_shape``, the port's on the
``meta`` device.  The port keeps one param dict a layer where the
reference stacks each pattern kind's layers (``bridge``): a port spec is
compared with the reference's for the stacked leaf less its leading layer
entry, which must be None, and every layer of a kind must carry the same
spec.  Also: ``block`` gives the index range of each device's shard of
``NamedSharding`` on a host mesh of 8 forced devices (one subprocess).
"""
import json
import os
import subprocess
import sys
import textwrap
from types import SimpleNamespace

import jax
import numpy as np
import pytest

from repro.configs import get_config as j_get
from repro.configs import reduced_config as j_reduced
from repro.distributed import sharding as jshd
from repro.models import build_model as j_build
from repro.optim import AdamWConfig as JAdamWConfig
from repro.train.train_step import abstract_state as j_abstract
from repro.train.train_step import state_specs as j_state_specs

from repro_torch import tree as tr
from repro_torch.configs import ALL_ARCHS, get_config, reduced_config
from repro_torch.distributed import sharding as tshd
from repro_torch.models.layers import MetaGenerator
from repro_torch.models.transformer import lm_init, lm_init_caches
from repro_torch.optim import AdamWConfig, adamw
from repro_torch.train.train_step import state_specs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = [(1, 2), (2, 1), (2, 2), (4, 2), (16, 16)]


def _mesh(D, M):
    return SimpleNamespace(shape={"data": D, "model": M}, axis_names=("data", "model"))


def _spec(s):
    """A spec's entries; a one-axis tuple entry as its axis, as jax's
    ``PartitionSpec`` gives it back."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e for e in s)


def _ref_layout(tree, cfg):
    """A port spec tree in the reference's layout (``bridge.params_to_
    numpy``'s mapping): each pattern kind's (and the encoder's) layers
    stacked, their common spec behind a None layer entry."""
    P = len(cfg.pattern)

    def stack(layers):
        if isinstance(layers[0], dict):
            return {k: stack([d[k] for d in layers]) for k in layers[0]}
        first = _spec(layers[0])
        assert all(_spec(x) == first for x in layers), "a kind's layers differ"
        return (None,) + first

    def plain(t):
        return tr.tree_map(_spec, t)

    out = {"embed": plain(tree["embed"]), "final_norm": plain(tree["final_norm"]),
           "head": tuple(plain(d) for d in tree["head"]),
           "tail": tuple(plain(d) for d in tree["tail"]),
           "blocks": tuple(stack(tree["blocks"][j::P]) for j in range(P))}
    if "shared_block" in tree:
        out["shared_block"] = plain(tree["shared_block"])
    if "enc_blocks" in tree:
        out["enc_blocks"] = stack(tree["enc_blocks"])
        out["enc_norm"] = plain(tree["enc_norm"])
    return out


def _flat(tree):
    """{keystr: spec tuple} of a spec tree in the reference's layout: dicts
    and tuples of layers (a tuple holding dicts, or an empty one) are
    nodes, tuples of entries leaves."""
    out = {}

    def walk(prefix, node):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(prefix + f"['{k}']", node[k])
        elif isinstance(node, tuple) and (not node or any(isinstance(x, dict) for x in node)):
            for i, x in enumerate(node):
                walk(prefix + f"[{i}]", x)
        else:
            out[prefix] = _spec(node)
    walk("", tree)
    return out


def _ref_flat(tree):
    out = {}
    for p, s in jax.tree_util.tree_flatten_with_path(
            tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]:
        out[jax.tree_util.keystr(p)] = _spec(s)
    return out


def _models(arch, full):
    jc = j_get(arch) if full else j_reduced(arch)
    tc = get_config(arch) if full else reduced_config(arch)
    return jc, tc


_ABSTRACT: dict = {}


def abstract(arch, full):
    """(ref config, port config, ref bundle, ref abstract states by
    quant_state, port meta params), made once a config."""
    if (arch, full) not in _ABSTRACT:
        jc, tc = _models(arch, full)
        jb = j_build(jc)
        jst = {q: j_abstract(jb, JAdamWConfig(quant_state=q)) for q in (False, True)}
        _ABSTRACT[arch, full] = (jc, tc, jb, jst, lm_init(MetaGenerator(), tc))
    return _ABSTRACT[arch, full]


@pytest.mark.parametrize("full", [False, True], ids=["reduced", "full"])
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_param_and_state_specs_match_the_reference(arch, full):
    jc, tc, jb, jst, tp = abstract(arch, full)
    tst = {q: {"params": tp, "opt": adamw.init(tp, AdamWConfig(quant_state=q))}
           for q in (False, True)}
    for D, M in MESHES:
        mesh = _mesh(D, M)
        want = _ref_flat(jshd.param_specs(jst[False]["params"], mesh))
        got = _flat(_ref_layout(tshd.param_specs(tp, mesh), tc))
        assert got == want, (D, M)
        for quant in (False, True):
            jspec = j_state_specs(jst[quant], mesh)
            tspec = state_specs(tst[quant], mesh)
            assert _flat(_ref_layout(tspec["params"], tc)) == _ref_flat(jspec["params"])
            for side in ("m", "v", "m_scale", "v_scale"):
                w = getattr(jspec["opt"], side)
                g = getattr(tspec["opt"], side)
                if w is None:
                    assert g is None
                    continue
                assert _flat(_ref_layout(g, tc)) == _ref_flat(w), (D, M, quant, side)
            assert tuple(tspec["opt"].step) == tuple(jspec["opt"].step) == ()


@pytest.mark.parametrize("full", [False, True], ids=["reduced", "full"])
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_batch_and_cache_specs_match_the_reference(arch, full):
    jc, tc, jb, _, _ = abstract(arch, full)
    mem = 8 if tc.family == "encdec" else 0
    for B in (8, 1):
        jcache = jax.eval_shape(lambda: jb.init_caches(B, 256, mem))
        tcache = lm_init_caches(tc, B, 256, "meta", mem)
        batch = {"tokens": np.zeros((B, 32), np.int32), "labels": np.zeros((B, 32), np.int32)}
        if tc.frontend == "vision":
            batch["patches"] = np.zeros((B, 16, 8), np.float32)
        for D, M in MESHES:
            mesh = _mesh(D, M)
            for sp in (False, True):
                w = _ref_flat(jshd.batch_spec(mesh, batch, seq_over_model=sp))
                g = {f"['{k}']": _spec(v) for k, v in
                     tshd.batch_spec(mesh, batch, seq_over_model=sp).items()}
                assert g == w, (B, D, M, sp)
                w = _ref_flat(jshd.cache_spec(mesh, jcache, B, seq_over_model=sp))
                g = _flat(tr.tree_map(tuple, tshd.cache_spec(mesh, tcache, B,
                                                             seq_over_model=sp)))
                assert g == w, (B, D, M, sp)


def test_spec_rules_of_the_reference_tests():
    """The reference's own rule cases (``tests/test_distributed.py``)."""
    assert tshd.spec_for_param("blocks/0/attn/wq", np.zeros((8, 64, 128))) \
        == (None, "data", "model")
    assert tshd.spec_for_param("blocks/0/attn/wo", np.zeros((8, 128, 64))) \
        == (None, "model", "data")
    assert tshd.spec_for_param("blocks/0/ffn/we_gate", np.zeros((8, 16, 64, 32))) \
        == (None, "model", "data", None)
    assert tshd.spec_for_param("embed/embedding", np.zeros((1024, 64))) == ("model", "data")
    assert tshd.spec_for_param("final_norm", np.zeros((64,))) == (None,)
    assert tshd.spec_for_param("embed/embedding", np.zeros((50280, 2560)),
                               _mesh(16, 16)) == (None, "data")
    caches = {"k": np.zeros((6, 8, 32, 2, 16)), "state": np.zeros((6, 8, 4, 16, 8)),
              "len": np.zeros((6, 8))}
    specs = tshd.cache_spec(_mesh(4, 2), caches, batch=8)
    assert specs["k"] == (None, ("data",), None, "model", None)
    assert specs["state"] == (None, ("data",), "model", None, None)
    # a P is one leaf of a tree, and equals the tuple of its entries
    assert tr.leaves({"a": tshd.P(None, "data")}) == [(None, "data")]
    assert hash(tshd.P("model")) == hash(("model",))


def test_blocks_are_the_named_sharding_shards():
    """``block`` at each device's coordinates of a 4x2 host mesh is that
    device's shard index under jax's ``NamedSharding``, for specs with
    single axes, a tuple of axes and whole dims."""
    cases = [((8, 12), (None, "model")), ((8, 12), ("data", "model")),
             ((16, 6), (("data", "model"), None)), ((8, 4, 6), ("model", "data", None)),
             ((4, 8), (None, ("model", "data")))]
    code = textwrap.dedent("""
        import json, sys
        import numpy as np, jax
        from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
        mesh = Mesh(np.array(jax.devices()).reshape(4, 2), ("data", "model"))
        out = []
        for shape, spec in json.loads(sys.argv[1]):
            spec = [tuple(e) if isinstance(e, list) else e for e in spec]
            idx = NamedSharding(mesh, P(*spec)).devices_indices_map(tuple(shape))
            out.append([[[s.start or 0, shape[i] if s.stop is None else s.stop]
                         for i, s in enumerate(idx[d])] for d in mesh.devices.flat])
        print(json.dumps(out))
    """)
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=os.path.join(ROOT, "src"), JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, "-c", code, json.dumps(cases)], env=env,
                         capture_output=True, text=True, timeout=120, cwd=ROOT)
    assert res.returncode == 0, res.stderr[-2000:]
    want = json.loads(res.stdout)
    mesh = _mesh(4, 2)
    for (shape, spec), w in zip(cases, want):
        for r, dev in enumerate(w):
            got = tshd.block(tshd.P(*spec), shape, mesh, {"data": r // 2, "model": r % 2})
            assert [[s.start, s.stop] for s in got] == dev, (shape, spec, r)
