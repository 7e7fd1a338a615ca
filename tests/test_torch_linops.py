"""The port's PDQ linear layer (repro_torch/models/linops.py and the dense
ops of repro_torch/kernels/ops.py) against the JAX package on the same
numpy weights and inputs.

Tolerances: weight records' q/colsum/scale exact, mu_w/var_w rtol 1e-6
(the port takes the moments in float64, JAX in float32; mu_w, a sum that
cancels, is held to 1e-6 of the weights' spread sqrt(var_w)); dense outputs within one int8
step of each row's predicted grid (s_out), which covers an interval edge
moved by the prologue's summation order; the fused SwiGLU MLP against the
reference's unfused composition at rtol = atol = 1e-4, the bound
tests/test_kernels.py uses for the TPU kernel.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as j_reduced
from repro.kernels import ops as jops
from repro.models import build_model as j_build
from repro.models import linops as jlin
from repro_torch.bridge import params_from_numpy
from repro_torch.kernels import ops as tops
from repro_torch.models import linops as tlin

torch.set_num_threads(1)


def _w(shape, seed, scale=0.1):
    return (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


def _rec_equal(trec, jrec):
    for k in ("q", "colsum", "scale"):
        np.testing.assert_array_equal(trec[k].numpy(), np.asarray(jrec[k]), err_msg=k)
    spread = np.sqrt(np.asarray(jrec["var_w"]))
    np.testing.assert_allclose(trec["mu_w"].numpy(), np.asarray(jrec["mu_w"]),
                               rtol=1e-6, atol=1e-6 * float(spread.min()))
    for k in ("var_w", "alpha", "beta"):
        np.testing.assert_allclose(trec[k].numpy(), np.asarray(jrec[k]),
                                   rtol=1e-6, err_msg=k)


def test_quantize_weight_matches_jax():
    w = _w((96, 200), 0)
    _rec_equal(tlin.quantize_weight(torch.from_numpy(w)),
               jlin.quantize_weight(jnp.asarray(w)))


def test_group_quantize_weights_matches_jax():
    ws = [_w((64, n), i) for i, n in enumerate((64, 32, 130))]
    t = tlin.group_quantize_weights([torch.from_numpy(w) for w in ws])
    j = jlin.group_quantize_weights([jnp.asarray(w) for w in ws])
    _rec_equal(t, j)
    assert t["segs"].sizes == j["segs"].sizes
    assert t["segs"].padded == j["segs"].padded
    assert t["segs"].offsets == j["segs"].offsets


def test_quantize_param_tree_quantizes_every_layer_like_vmap():
    """The port quantizes each layer of the model; its records equal those
    jax.vmap(quantize_param_tree) makes for the reference's stacked blocks
    (the reference's own quantize_param_tree skips 3-D stacks)."""
    cfg = j_reduced("stablelm-1.6b")
    jp = j_build(cfg).init(jax.random.PRNGKey(0))
    jq = jax.vmap(jlin.quantize_param_tree)(jp["blocks"])[0]
    tq = tlin.quantize_param_tree(
        params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu"))["blocks"]
    assert len(tq) == cfg.n_layers
    for i, layer in enumerate(tq):
        pick = lambda r: jax.tree.map(lambda a: a[i], r)          # noqa: E731
        for part, names in (("attn", ("wq", "wk", "wv")), ("ffn", ("w_gate", "w_up"))):
            views = [layer[part][n] for n in names]
            assert [v["seg"].index for v in views] == [0, 1, 2][:len(names)]
            assert all(v["group"] is views[0]["group"] for v in views)
            _rec_equal(views[0]["group"], pick(jq[part][names[0]]["group"]))
        _rec_equal(layer["attn"]["wo"], pick(jq["attn"]["wo"]))
        _rec_equal(layer["ffn"]["w_down"], pick(jq["ffn"]["w_down"]))
        assert not tlin.is_quantized(layer["attn_norm"])


def _within_one_step(got, want, s_out):
    """|got - want| <= one int8 step of the row's grid (+ f32 rounding)."""
    err = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    step = np.broadcast_to(np.asarray(s_out, np.float64), err.shape)
    np.testing.assert_array_less(err, step * (1 + 1e-5) + 1e-6)


@pytest.mark.parametrize("lead", [(8,), (2, 5)])
def test_pdq_dense_matches_jax(lead):
    K, N = 128, 200
    w = _w((K, N), 1)
    x = np.random.default_rng(2).standard_normal(lead + (K,)).astype(np.float32)
    trec = tlin.quantize_weight(torch.from_numpy(w))
    jrec = jlin.quantize_weight(jnp.asarray(w))
    ty = tops.pdq_dense(torch.from_numpy(x), trec, out="fp")
    jy = jops.pdq_dense(jnp.asarray(x), jrec, out="fp")
    _, _, s1, s2 = jops.pdq_prologue(jnp.asarray(x))
    s_out = jops.pdq_interval(jrec, s1, s2)[2]
    _within_one_step(ty.numpy(), jy, s_out)
    tq, ts, tz = tops.pdq_dense(torch.from_numpy(x), trec, out="int8")
    jq, js, jz = jops.pdq_dense(jnp.asarray(x), jrec, out="int8")
    assert np.abs(tq.numpy().astype(np.int32) - np.asarray(jq, np.int32)).max() <= 1
    np.testing.assert_allclose(ts.numpy(), js, rtol=1e-5)
    assert np.abs(tz.numpy() - np.asarray(jz)).max() <= 1


def test_pdq_dense_grouped_matches_jax():
    K = 64
    ws = [_w((K, n), 10 + i) for i, n in enumerate((64, 32, 32))]
    x = np.random.default_rng(3).standard_normal((3, 7, K)).astype(np.float32)
    tg = tlin.group_quantize_weights([torch.from_numpy(w) for w in ws])
    jg = jlin.group_quantize_weights([jnp.asarray(w) for w in ws])
    tys = tops.pdq_dense_grouped(torch.from_numpy(x), tg)
    jys = jops.pdq_dense_grouped(jnp.asarray(x), jg)
    _, _, s1, s2 = jops.pdq_prologue(jnp.asarray(x))
    s_out = jops.pdq_interval(jg, s1, s2)[2]                  # (..., n_seg)
    for i, (ty, jy) in enumerate(zip(tys, jys)):
        assert ty.shape == jy.shape
        _within_one_step(ty.numpy(), jy, s_out[..., i:i + 1])
    (tq, ts, tz) = tops.pdq_dense_grouped(torch.from_numpy(x), tg, out="int8")
    (jq, js, jz) = jops.pdq_dense_grouped(jnp.asarray(x), jg, out="int8")
    for a, b in zip(tq, jq):
        assert np.abs(a.numpy().astype(np.int32) - np.asarray(b, np.int32)).max() <= 1


@pytest.mark.parametrize("shape", [(8, 1, 256, 512), (130, 64, 128)])
def test_pdq_mlp_fused_matches_jax_unfused(shape):
    """The port's fused MLP (plain K3 on the CPU) == the JAX unfused
    composition pdq_dense_grouped -> silu(g)*u -> pdq_dense."""
    *lead, d_model, d_ff = shape
    wg, wu, wd = _w((d_model, d_ff), 20), _w((d_model, d_ff), 21), _w((d_ff, d_model), 22)
    x = np.random.default_rng(4).standard_normal((*lead, d_model)).astype(np.float32)
    jg = jlin.group_quantize_weights((jnp.asarray(wg), jnp.asarray(wu)))
    jd = jlin.quantize_weight(jnp.asarray(wd))
    g, u = jops.pdq_dense_grouped(jnp.asarray(x), jg, out="fp", out_dtype=jnp.float32)
    want = jops.pdq_dense(jax.nn.silu(g) * u, jd, out="fp", out_dtype=jnp.float32)
    tg = tlin.group_quantize_weights((torch.from_numpy(wg), torch.from_numpy(wu)))
    td = tlin.quantize_weight(torch.from_numpy(wd))
    tops.reset_counts()
    y = tops.pdq_mlp(torch.from_numpy(x), tg, td, out_dtype=torch.float32)
    assert y.shape == want.shape
    np.testing.assert_allclose(y.numpy(), want, rtol=1e-4, atol=1e-4)
    c = tops.counts()
    assert (c["pdq_prologue"]["entries"], c["w8a8_swiglu_matmul"]["entries"],
            c["w8a8_matmul"]["entries"]) == (1, 1, 1)


def test_lin_and_lin_grouped_dispatch():
    K = 64
    ws = [torch.from_numpy(_w((K, 64), 30 + i)) for i in range(3)]
    x = torch.randn(4, K)
    assert torch.equal(tlin.lin(x, ws[0]), x @ ws[0])
    grec = tlin.group_quantize_weights(ws, names=("wq", "wk", "wv"))
    views = [tlin.group_segment_view(grec, i) for i in range(3)]
    grouped = tlin.lin_grouped(x, views)
    single = [tlin.lin(x, v) for v in views]          # per-segment records
    for a, b in zip(grouped, single):
        # one shared prologue prices the same per-segment interval
        assert a.shape == (4, 64) and torch.equal(a, b)
    # a set that is not one group in segment order runs per projection
    assert len(tlin.lin_grouped(x, views[::-1])) == 3
