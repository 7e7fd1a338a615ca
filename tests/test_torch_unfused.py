"""The port's ops-level quantization entry points (repro_torch/kernels/ops.py:
``act_stats``, ``quantize``, ``dequantize`` and the unfused PDQ projection
``pdq_dense_unfused``) against the JAX package's, on the same numpy inputs
and weights.  The JAX ops run their jnp oracles here (``ref``), and where
named also their Pallas kernels in interpret mode (``kernel``), as the
reference's own tests run them on the CPU.

Tolerances: int8 codes equal; dequantized values bit-equal at f32 and at
bf16 (the port follows the ops contract, ``ref.dequantize_ref``: q - z and
the scale round to bf16, one rounded product); moments at the reference's
tolerances (tests/test_kernels.py:97-108); the unfused projection's s_out
within 1e-6 relative and y within one int8 step of its row's grid (the
moments are summed in another order, which can move an interval edge and
with it a code at a tie); fused against unfused within one step, the
reference's own contract (tests/test_kernels.py:244-260).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.models import linops as jlin
from repro_torch.bridge import _tensor
from repro_torch.kernels import act_stats as tas
from repro_torch.kernels import ops as tops
from repro_torch.models import linops as tlin

torch.set_num_threads(1)

JAX_DTYPE = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _t(a):
    return _tensor(np.asarray(a), "cpu")


def _bits(a):
    """The raw bits of a numpy / JAX / torch array, bf16 as uint16."""
    if torch.is_tensor(a):
        return a.view(torch.uint16).numpy() if a.dtype == torch.bfloat16 else a.numpy()
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


@pytest.fixture
def jax_impl(request):
    """Run the JAX ops through ``request.param`` ('ref' or 'kernel')."""
    jops.set_impl(request.param)
    yield request.param
    jops.set_impl("auto")


# ---------------------------------------------------------------- act_stats


@pytest.mark.parametrize("jax_impl", ["ref", "kernel"], indirect=True)
@pytest.mark.parametrize("gamma", [1, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_act_stats_matches_jax(jax_impl, dtype, gamma):
    x = jnp.asarray(3 * np.random.default_rng(0).standard_normal((2, 100, 33)),
                    JAX_DTYPE[dtype])
    j1, j2 = jops.act_stats(x, gamma=gamma)
    t1, t2 = tops.act_stats(_t(x), gamma=gamma)
    assert tuple(t1.shape) == tuple(j1.shape) == (2, -(-100 // gamma))
    tol = dict(rtol=2e-2, atol=1e-2) if dtype == "bfloat16" else dict(rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(t1.numpy(), j1, **tol)
    np.testing.assert_allclose(t2.numpy(), j2, **tol)


def test_act_stats_ignores_gamma_on_a_2d_input():
    """The reference subsamples only the second-to-last axis of an input
    with more than two dims; a 2-D input keeps every row."""
    x = np.random.default_rng(1).standard_normal((50, 33)).astype(np.float32)
    j1, j2 = jops.act_stats(jnp.asarray(x), gamma=4)
    t1, t2 = tops.act_stats(torch.from_numpy(x), gamma=4)
    w1, w2 = tops.act_stats(torch.from_numpy(x))
    assert tuple(t1.shape) == tuple(j1.shape) == (50,)
    assert torch.equal(t1, w1) and torch.equal(t2, w2)
    np.testing.assert_allclose(t1.numpy(), j1, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(t2.numpy(), j2, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("shape,gamma", [((2, 100, 33), 4), ((3, 2, 50, 8), 3),
                                         ((7, 40), 1), ((1, 5, 16), 2)])
def test_act_stats_row_layout_addresses_the_rows(shape, gamma):
    """The strides K8 is given reach exactly the rows the op means: the
    kernel's addressing, emulated on x's storage, against the rows."""
    x = torch.arange(int(np.prod(shape)), dtype=torch.float32).reshape(shape)
    xs = x[..., ::gamma, :] if x.dim() > 2 else x
    x3 = (xs.reshape(-1, xs.shape[-2], xs.shape[-1]) if xs.dim() > 2 else xs)
    rows, inner, so, si, K = tas.row_layout(x3)
    flat = x.flatten()
    base = x3.storage_offset()
    got = torch.stack([flat[base + (r // inner) * so + (r % inner) * si:][:K]
                       for r in range(rows)])
    assert x3.untyped_storage().data_ptr() == x.untyped_storage().data_ptr()
    assert torch.equal(got, xs.reshape(-1, K))


# ----------------------------------------------------------------- quantize


def _per_row_forms(M, rng):
    s = rng.uniform(0.01, 0.3, (M, 1)).astype(np.float32)
    z = rng.integers(-40, 40, (M, 1)).astype(np.int32)
    return {"scalar": (0.05, 3), "(M,)": (s[:, 0], z[:, 0]), "(M, 1)": (s, z)}


def _per_channel_forms(N, rng):
    s = rng.uniform(0.01, 0.3, (1, N)).astype(np.float32)
    z = rng.integers(-40, 40, (1, N)).astype(np.int32)
    return {"(N,)": (s[0], z[0]), "(1, N)": (s, z)}


def _operand(a, to):
    return a if isinstance(a, (int, float)) else to(a)


@pytest.mark.parametrize("jax_impl", ["ref", "kernel"], indirect=True)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("form", ["scalar", "(M,)", "(M, 1)", "(N,)", "(1, N)"])
def test_quantize_matches_jax(jax_impl, form, dtype):
    M, N = 300, 290
    rng = np.random.default_rng(2)
    per_channel = form in ("(N,)", "(1, N)")
    forms = _per_channel_forms(N, rng) if per_channel else _per_row_forms(M, rng)
    s, z = forms[form]
    x = jnp.asarray(4 * rng.standard_normal((M, N)), JAX_DTYPE[dtype])
    jq = jops.quantize(x, _operand(s, jnp.asarray), _operand(z, jnp.asarray),
                       per_channel=per_channel)
    tq = tops.quantize(_t(x), _operand(s, _t), _operand(z, _t), per_channel=per_channel)
    assert tq.dtype == torch.int8
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))


@pytest.mark.parametrize("per_channel", [False, True])
def test_quantize_ties_round_half_to_even_like_jax(per_channel):
    """x / s lands exactly on .5 (power-of-two scales): both round half to
    even, and codes past the int8 range clamp."""
    rng = np.random.default_rng(3)
    M, N = 40, 70
    n = N if per_channel else M
    s = (2.0 ** -rng.integers(1, 9, n)).astype(np.float32)
    z = rng.integers(-40, 40, n).astype(np.int32)
    shape = (1, N) if per_channel else (M, 1)
    s, z = s.reshape(shape), z.reshape(shape)
    x = ((rng.integers(-140, 140, (M, N)) + 0.5) * s).astype(np.float32)
    jq = jops.quantize(jnp.asarray(x), jnp.asarray(s), jnp.asarray(z),
                       per_channel=per_channel)
    tq = tops.quantize(torch.from_numpy(x), torch.from_numpy(s), torch.from_numpy(z),
                       per_channel=per_channel)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    small = tops.quantize(torch.tensor([[0.5, 1.5, 2.5, -0.5, -2.5, 200.0, -200.0]]), 1.0, 0)
    assert small.tolist() == [[0, 2, 2, 0, -2, 127, -128]]


def test_quantize_takes_leading_dims():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 3, 20)).astype(np.float32)
    s = rng.uniform(0.01, 0.1, (2, 3)).astype(np.float32)
    z = rng.integers(-5, 5, (2, 3, 1)).astype(np.int32)
    jq = jops.quantize(jnp.asarray(x), jnp.asarray(s), jnp.asarray(z))
    tq = tops.quantize(torch.from_numpy(x), torch.from_numpy(s), torch.from_numpy(z))
    assert tuple(tq.shape) == (2, 3, 20)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))


# --------------------------------------------------------------- dequantize


@pytest.mark.parametrize("per_channel", [False, True])
@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("M,N", [(256, 256), (300, 290)])
def test_dequantize_matches_jax_bit_exact(M, N, out_dtype, per_channel):
    """The ops contract at bf16 (q - z and s each rounded to bf16, one
    rounded product), bit for bit; the inputs are those on which the
    reference's Pallas kernel, which rounds the f32 product once, differs
    from it in about a quarter of the elements."""
    rng = np.random.default_rng(5)
    q = rng.integers(-128, 128, (M, N)).astype(np.int8)
    shape = (1, N) if per_channel else (M, 1)
    s = rng.uniform(0.001, 0.3, shape).astype(np.float32)
    z = rng.integers(-40, 40, shape).astype(np.int32)
    jy = jops.dequantize(jnp.asarray(q), jnp.asarray(s), jnp.asarray(z),
                         per_channel=per_channel, out_dtype=JAX_DTYPE[out_dtype])
    ty = tops.dequantize(torch.from_numpy(q), torch.from_numpy(s), torch.from_numpy(z),
                         per_channel=per_channel, out_dtype=getattr(torch, out_dtype))
    assert ty.dtype == getattr(torch, out_dtype)
    np.testing.assert_array_equal(_bits(ty), _bits(jy))


@pytest.mark.parametrize("jax_impl", ["kernel"], indirect=True)
@pytest.mark.parametrize("per_channel", [False, True])
def test_dequantize_f32_matches_the_jax_kernel(jax_impl, per_channel):
    rng = np.random.default_rng(6)
    M, N = 300, 290
    q = rng.integers(-128, 128, (M, N)).astype(np.int8)
    s = rng.uniform(0.001, 0.3, N if per_channel else M).astype(np.float32)
    z = rng.integers(-40, 40, N if per_channel else M).astype(np.int32)
    jy = jops.dequantize(jnp.asarray(q), jnp.asarray(s), jnp.asarray(z),
                         per_channel=per_channel)
    ty = tops.dequantize(torch.from_numpy(q), torch.from_numpy(s), torch.from_numpy(z),
                         per_channel=per_channel)
    np.testing.assert_array_equal(_bits(ty), _bits(jy))


def test_quantize_dequantize_round_trip_on_the_grid():
    """Values on the int8 grid come back bit for bit: quantize recovers
    the codes and dequantize the values."""
    rng = np.random.default_rng(7)
    q = torch.from_numpy(rng.integers(-128, 128, (3, 4, 50)).astype(np.int8))
    s = torch.from_numpy(rng.uniform(0.01, 0.3, (3, 4, 1)).astype(np.float32))
    z = torch.from_numpy(rng.integers(-40, 40, (3, 4, 1)).astype(np.int32))
    y = tops.dequantize(q, s, z)
    assert torch.equal(tops.quantize(y, s, z), q)
    assert torch.equal(tops.dequantize(tops.quantize(y, s, z), s, z), y)


# ------------------------------------------------- the unfused PDQ projection


def _projection(M, K, N, seed=0):
    rng = np.random.default_rng(seed)
    w = (0.05 * rng.standard_normal((K, N))).astype(np.float32)
    x = rng.standard_normal((M, K)).astype(np.float32)
    return x, w, jlin.quantize_weight(jnp.asarray(w)), tlin.quantize_weight(_t(w))


def _within_one_step(got, want, s_out):
    err = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    step = np.broadcast_to(np.asarray(s_out, np.float64), err.shape)
    assert (err <= step + 1e-6).all(), float((err / step).max())


@pytest.mark.parametrize("jax_impl", ["ref", "kernel"], indirect=True)
@pytest.mark.parametrize("shape", [(6, 128, 64), (130, 257, 100)])
def test_pdq_dense_unfused_matches_jax(jax_impl, shape):
    x, _, jrec, trec = _projection(*shape)
    jy, js = jops.pdq_dense_unfused(jnp.asarray(x), jrec)
    ty, ts = tops.pdq_dense_unfused(torch.from_numpy(x), trec)
    assert ty.dtype == torch.float32 and tuple(ty.shape) == tuple(jy.shape)
    assert tuple(ts.shape) == tuple(js.shape) == (shape[0], 1)
    np.testing.assert_allclose(ts.numpy(), js, rtol=1e-6, atol=0)
    _within_one_step(ty.numpy(), jy, js)


@pytest.mark.parametrize("shape", [(6, 128, 64), (130, 257, 100)])
def test_pdq_dense_fp_matches_unfused_within_one_step(shape):
    """The fused projection (one prologue + the fp-clamp matmul) against
    the unfused one (moments, requant, dequant): within one int8 step of
    each row's grid."""
    x, _, _, trec = _projection(*shape, seed=1)
    y_fused = tops.pdq_dense(torch.from_numpy(x), trec, out="fp")
    y_unfused, s_out = tops.pdq_dense_unfused(torch.from_numpy(x), trec)
    _within_one_step(y_fused.numpy(), y_unfused.numpy(), s_out.numpy())


def test_pdq_dense_unfused_takes_leading_dims_and_bf16():
    x, _, jrec, trec = _projection(12, 64, 48, seed=2)
    x3 = x.reshape(3, 4, 64)
    jy, js = jops.pdq_dense_unfused(jnp.asarray(x3, jnp.bfloat16), jrec)
    ty, ts = tops.pdq_dense_unfused(_t(jnp.asarray(x3, jnp.bfloat16)), trec)
    assert tuple(ty.shape) == (3, 4, 48) and tuple(ts.shape) == (3, 4, 1)
    np.testing.assert_allclose(ts.numpy(), js, rtol=1e-6, atol=0)
    _within_one_step(ty.numpy(), jy, js)


def test_unfused_ops_count_entries_on_cpu_and_never_launch():
    """One unfused projection enters act_stats (K8) and the W8A8 matmul
    (K2) once each, never the prologue; quantize and dequantize enter K9
    and K10; on the CPU nothing launches."""
    x, _, _, trec = _projection(4, 64, 32, seed=3)
    tops.reset_counts()
    y, s_out = tops.pdq_dense_unfused(torch.from_numpy(x), trec)
    c = {k: v["entries"] for k, v in tops.counts().items()}
    want = dict.fromkeys(c, 0)
    want.update(act_stats=1, w8a8_matmul=1)
    assert c == want
    q = tops.quantize(y, s_out, 0)
    tops.dequantize(q, s_out, 0)
    tops.act_stats(torch.from_numpy(x).reshape(2, 2, 64), gamma=2)
    c = tops.counts()
    assert (c["act_stats"]["entries"], c["quantize"]["entries"],
            c["dequantize"]["entries"]) == (2, 1, 1)
    assert all(v["launches"] == 0 for v in c.values())
