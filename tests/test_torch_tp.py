"""Tensor parallelism in the port's ops (``kernels/ops.tp_shard`` over an
``ops.TPRow`` of T CPU entries, its blocks from ``linops.tp_place``)
against the port at T = 1 and against the reference's TP branch under
shard_map.

``tp_place`` gives each shard its own block of every split weight: for T
2 and 4 each block's ``q`` / ``scale`` / ``colsum`` equals the reference's
record's column block bit for bit (grouped QKV and gate/up by 128-column
blocks, wo, w_down), and the row's split weights sum to one copy.  The
projections run through the per-shard path twice: with the blocks views
of the home's whole records (entries that repeat one device) and with
``copies=True``, the placement of a row over distinct cards, where the
home keeps meta tensors in place of a split record's ``q`` / ``scale`` /
``colsum`` (so nothing may read them whole).

Under ``tp_shard`` with T shards, ``pdq_dense_from_prologue``, grouped fp
``pdq_dense_grouped``, ``pdq_mlp`` (which then takes the unfused
composition) and fp ``lin`` split their columns over the shards.  Against
T = 1 the PDQ projections are bit for bit (every column is the same full-K
int8 accumulation and epilogue), the MLP bit for bit against the unfused
composition at T = 1 and within rtol = atol = 1e-4 (the port's K3 bound)
against the fused one, and ``lin``'s narrower fp GEMMs within float
rounding.  The PDQ health totals equal T = 1's, a ragged N stays unsplit,
and the guard falls back on each shard's columns.

Against JAX: the reference runs its own TP branch (``tp_shard('model',
T)`` inside a shard_map over a (1, T) mesh of forced host devices) once, in
a subprocess, on the same numpy weights and inputs; outputs agree within
one int8 step of each row's grid (tests/test_torch_linops.py's bound).
"""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.models import linops as tlin

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
K, N, D_FF = 128, 256, 256
SEGS = (256, 128, 128)          # 4 blocks of 128 columns: splits at T 2 and 4
TS = (2, 4)


def _w(shape, seed, scale=0.1):
    return (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


def _inputs():
    x = np.random.default_rng(1).standard_normal((6, K)).astype(np.float32)
    return dict(x=x, w=_w((K, N), 2), wg=_w((K, D_FF), 3), wu=_w((K, D_FF), 4),
                wd=_w((D_FF, K), 5), **{f"s{i}": _w((K, n), 10 + i)
                                         for i, n in enumerate(SEGS)})


_REF = """
import sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import PartitionSpec as P
from repro.kernels import ops
from repro.models import linops
from repro.models.context import shard_map

d = dict(np.load(sys.argv[1]))
x = jnp.asarray(d["x"])
rec = linops.quantize_weight(jnp.asarray(d["w"]))
grec = linops.group_quantize_weights([jnp.asarray(d[f"s{i}"]) for i in range(3)])
mlp_g = linops.group_quantize_weights((jnp.asarray(d["wg"]), jnp.asarray(d["wu"])))
mlp_d = linops.quantize_weight(jnp.asarray(d["wd"]))
out = {}
for T in (1, 2, 4):
    mesh = jax.make_mesh((1, T), ("data", "model"))

    def body(x):
        with ops.tp_shard("model", T):
            x_q, s_x, s1, s2 = ops.pdq_prologue(x)
            y = ops.pdq_dense_from_prologue(x, x_q, s_x, s1, s2, rec)
            ys = ops.pdq_dense_grouped(x, grec)
            m = ops.pdq_mlp(x, mlp_g, mlp_d)
            f = linops.lin(x, jnp.asarray(d["w"]))
        return (y,) + tuple(ys) + (m, f)

    res = jax.jit(shard_map(body, mesh=mesh, in_specs=(P(),), out_specs=P(),
                            check_vma=False))(x)
    for name, a in zip(("dense", "g0", "g1", "g2", "mlp", "lin"), res):
        out[f"{name}_{T}"] = np.asarray(a)
np.savez(sys.argv[2], **out)
print("REF OK")
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The reference's TP outputs at T = 1, 2, 4 (one subprocess)."""
    td = tmp_path_factory.mktemp("tp")
    np.savez(td / "in.npz", **_inputs())
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH="src", JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", textwrap.dedent(_REF), str(td / "in.npz"),
                          str(td / "out.npz")], capture_output=True, text=True, env=env,
                         cwd=REPO, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return dict(np.load(td / "out.npz"))


@pytest.fixture(scope="module")
def port():
    d = {k: torch.from_numpy(v) for k, v in _inputs().items()}
    return dict(x=d["x"], w=d["w"], rec=tlin.quantize_weight(d["w"]),
                grec=tlin.group_quantize_weights([d[f"s{i}"] for i in range(3)]),
                mlp_g=tlin.group_quantize_weights((d["wg"], d["wu"])),
                mlp_d=tlin.quantize_weight(d["wd"]))


def _row(p, T, copies=None):
    """(the home's leaves, the TPRow) of ``p``'s weights over T CPU
    entries."""
    home, blocks = tlin.tp_place({k: p[k] for k in ("rec", "grec", "mlp_g", "mlp_d", "w")},
                                 ["cpu"] * T, copies=copies)
    return dict(p, **home), ops.TPRow(["cpu"] * T, blocks)


def _run(p, T, guard=False, copies=None):
    """Every op under tp_shard over T CPU shards: outputs, K2 entries and
    the PDQ health vector."""
    p, row = _row(p, T, copies)
    ops.reset_counts()
    with ops.tp_shard(row), ops.pdq_guard(guard), \
            ops.pdq_telemetry(counters=torch.zeros(3, dtype=torch.int64)) as col:
        x_q, s_x, s1, s2 = ops.pdq_prologue(p["x"])
        y = ops.pdq_dense_from_prologue(p["x"], x_q, s_x, s1, s2, p["rec"])
        ys = ops.pdq_dense_grouped(p["x"], p["grec"])
        m = ops.pdq_mlp(p["x"], p["mlp_g"], p["mlp_d"])
        f = tlin.lin(p["x"], p["w"])
    c = ops.counts()
    return (dict(zip(("dense", "g0", "g1", "g2", "mlp", "lin"), (y, *ys, m, f))),
            {k: v["entries"] for k, v in c.items()}, col.counters.clone())


def _within_one_step(a, b, s_out):
    err = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))
    step = np.broadcast_to(np.asarray(s_out, np.float64), err.shape)
    np.testing.assert_array_less(err, step * (1 + 1e-5) + 1e-6)


def _unfused_mlp(p):
    g, u = ops.pdq_dense_grouped(p["x"], p["mlp_g"])
    return ops.pdq_dense(torch.nn.functional.silu(g) * u, p["mlp_d"])


@pytest.mark.parametrize("copies", [False, True])
@pytest.mark.parametrize("T", TS)
def test_tp_equals_one_shard_bit_for_bit(port, T, copies):
    one, c1, tel1 = _run(port, 1)
    got, cT, telT = _run(port, T, copies=copies)
    for k in ("dense", "g0", "g1", "g2"):
        assert torch.equal(got[k], one[k]), k
    # the MLP is unfused under TP: bit for bit against the unfused
    # composition, within the K3 bound against the fused one
    assert torch.equal(got["mlp"], _unfused_mlp(port))
    np.testing.assert_allclose(got["mlp"].numpy(), one["mlp"].numpy(), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got["lin"].numpy(), one["lin"].numpy(), rtol=1e-6, atol=1e-6)
    # K2 once per shard of every split projection: dense, grouped, gate/up
    # and w_down; no K3 under TP
    assert c1["w8a8_matmul"] == 3 and c1["w8a8_swiglu_matmul"] == 1
    assert cT["w8a8_matmul"] == 4 * T and cT["w8a8_swiglu_matmul"] == 0
    # health: clip hits and outputs checked, summed over the shards; the
    # MLP's gate/up counts the same outputs whether fused or not
    assert torch.equal(telT, tel1 + _unfused_tel(port) - _fused_tel(port))


def _fused_tel(p):
    with ops.pdq_telemetry(counters=torch.zeros(3, dtype=torch.int64)) as col:
        ops.pdq_mlp(p["x"], p["mlp_g"], p["mlp_d"])
    return col.counters


def _unfused_tel(p):
    with ops.pdq_telemetry(counters=torch.zeros(3, dtype=torch.int64)) as col:
        _unfused_mlp(p)
    return col.counters


@pytest.mark.parametrize("T", TS)
def test_tp_matches_the_reference_tp_branch(port, ref, T):
    from repro.kernels import ops as jops
    from repro.models import linops as jlin
    import jax.numpy as jnp
    got, _, _ = _run(port, T)
    x = jnp.asarray(port["x"].numpy())
    _, _, s1, s2 = jops.pdq_prologue(x)
    s_dense = jops.pdq_interval(jlin.quantize_weight(jnp.asarray(port["w"].numpy())),
                                s1, s2)[2]
    _within_one_step(got["dense"].numpy(), ref[f"dense_{T}"], s_dense)
    d = _inputs()
    jg = jlin.group_quantize_weights([jnp.asarray(d[f"s{i}"]) for i in range(3)])
    s_seg = jops.pdq_interval(jg, s1, s2)[2]
    for i in range(3):
        _within_one_step(got[f"g{i}"].numpy(), ref[f"g{i}_{T}"], s_seg[..., i:i + 1])
    # the reference's own TP outputs equal its unsplit ones
    for k in ("dense", "g0", "g1", "g2", "mlp"):
        np.testing.assert_array_equal(ref[f"{k}_{T}"], ref[f"{k}_1"])
    np.testing.assert_allclose(got["mlp"].numpy(), ref[f"mlp_{T}"], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got["lin"].numpy(), ref[f"lin_{T}"], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("T", TS)
def test_ragged_columns_stay_unsplit(T):
    """N = 131 divides over neither 2 nor 4 shards: no blocks, the whole
    record on the home, one K2, T = 1's result."""
    w = torch.from_numpy(_w((K, 131), 7))
    rec = tlin.quantize_weight(w)
    x = torch.from_numpy(np.random.default_rng(8).standard_normal((5, K)).astype(np.float32))
    want = ops.pdq_dense(x, rec)
    home, blocks = tlin.tp_place({"rec": rec, "w": w}, ["cpu"] * T, copies=True)
    assert blocks == {} and home["rec"]["q"].device.type == "cpu"
    ops.reset_counts()
    with ops.tp_shard(ops.TPRow(["cpu"] * T, blocks)):
        got = ops.pdq_dense(x, home["rec"])
        f = tlin.lin(x, home["w"])
    assert torch.equal(got, want) and torch.equal(f, x @ w)
    assert ops.counts()["w8a8_matmul"]["entries"] == 1


@pytest.mark.parametrize("copies", [False, True])
@pytest.mark.parametrize("T", TS)
def test_guard_falls_back_per_shard(port, T, copies):
    """Under pdq_fault every shard's fast path is poisoned: each falls back
    on its own columns (one fallback a shard), and the result is the
    fp-dequant product of the whole record."""
    with ops.pdq_fault():
        one, c1, tel1 = _run(port, 1, guard=True)
        got, cT, telT = _run(port, T, guard=True, copies=copies)
    for k in ("dense", "g0", "g1", "g2", "mlp"):
        assert bool(torch.isfinite(got[k]).all()), k
        np.testing.assert_allclose(got[k].numpy(), one[k].numpy(), rtol=1e-5, atol=1e-5)
    # four guarded projections (dense, grouped, gate/up, w_down)
    assert c1["fp_dequant"] == 4 and cT["fp_dequant"] == 4 * T
    assert int(tel1[0]) == 4 and int(telT[0]) == 4 * T
    want = port["x"] @ tlin.dense_weight(port["rec"])
    np.testing.assert_allclose(got["dense"].numpy(), want.numpy(), rtol=1e-5, atol=1e-5)


def test_tp_shard_of_one_device_is_a_no_op():
    with ops.tp_shard(ops.TPRow(["cpu"], {})):
        assert ops.tp_ctx() is None
    row = ops.TPRow(["cpu"] * 2, {})
    with ops.tp_shard(row):
        assert ops.tp_ctx() is row and row.shards == 2
        with ops.tp_shard(None):
            assert ops.tp_ctx() is None
        assert ops.tp_ctx() is row
    assert ops.tp_ctx() is None
    # on the CPU every shard runs where the program runs: one stream
    assert row.stream_count() == 1 and row.buffer_sets == [0, 1]


# a transformer layer's projections, named as the models name them: QKV
# (GQA widths 256 + 128 + 128, four 128-column blocks), gate/up 2 x 256
LAYER = {"attn": {"wq": (K, 256), "wk": (K, 128), "wv": (K, 128), "wo": (256, K)},
         "ffn": {"w_gate": (K, D_FF), "w_up": (K, D_FF), "w_down": (D_FF, K)}}


def _layer():
    return {blk: {n: _w(shape, 20 + i) for i, (n, shape) in enumerate(ws.items())}
            for blk, ws in LAYER.items()}


@pytest.mark.parametrize("copies", [False, True])
@pytest.mark.parametrize("T", TS)
def test_per_shard_records_equal_the_reference_blocks(T, copies):
    """Each shard's block of every split record is the reference's record's
    column block bit for bit: the grouped QKV and gate/up by 128-column
    blocks, wo and w_down by columns; its q K-major.  The row's split
    weights sum to one copy of the records' q / scale / colsum, the home
    keeps them whole only where the blocks are views, and every other leaf
    (the surrogate stats, the segment layout) stays on the home."""
    import jax.numpy as jnp
    from repro.models import linops as jlin
    layer = _layer()
    jq = jlin.quantize_param_tree({b: {n: jnp.asarray(w) for n, w in d.items()}
                                   for b, d in layer.items()})
    tq = tlin.quantize_param_tree({b: {n: torch.from_numpy(w) for n, w in d.items()}
                                   for b, d in layer.items()})
    home, blocks = tlin.tp_place(tq, ["cpu"] * T, copies=copies)
    row = ops.TPRow(["cpu"] * T, blocks)
    def three(t):
        return (t["attn"]["wq"]["group"], t["attn"]["wo"], t["ffn"]["w_gate"]["group"],
                t["ffn"]["w_down"])

    recs = dict(zip(("qkv", "wo", "gate/up", "w_down"), zip(three(home), three(jq), three(tq))))
    assert len(blocks) == len(recs)
    whole = 0
    for name, (leaf, jrec, trec) in recs.items():
        split = row.split(leaf)
        assert split is not None and len(split) == T, name
        N = jrec["q"].shape[-1]
        n = N // T
        if "segs" in leaf:
            assert n % 128 == 0, name            # whole 128-column blocks a shard
        for j, b in enumerate(split):
            c = slice(j * n, (j + 1) * n)
            assert b["q"].t().is_contiguous(), name
            np.testing.assert_array_equal(b["q"].numpy(), np.asarray(jrec["q"])[:, c])
            np.testing.assert_array_equal(b["scale"].numpy(), np.asarray(jrec["scale"])[c])
            np.testing.assert_array_equal(b["colsum"].numpy(),
                                          np.asarray(jrec["colsum"])[:, c])
        for k in ("mu_w", "var_w", "alpha", "beta"):      # the port's own stats, kept
            assert torch.equal(leaf[k], trec[k]), (name, k)
        kept = leaf["q"].device.type
        assert kept == ("meta" if copies else "cpu"), name
        whole += sum(np.asarray(jrec[k]).nbytes for k in ("q", "scale", "colsum"))
    assert home["attn"]["wq"]["group"]["segs"].sizes == (256, 128, 128)
    assert row.weight_bytes() == {"cpu": whole}
