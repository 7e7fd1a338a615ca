"""The port's plain kernel versions (repro_torch/kernels/ref.py, used by the
wrappers for CPU tensors and as the oracles the CUDA kernels are held
against on the card) against the JAX package's oracles, on the same numpy
inputs.

Tolerances: int8 codes, scales and int32 products are exact (the same IEEE
operations in the same order); s1/s2 within rtol 1e-5 (another summation
order); scatters bit-exact for every dtype.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.bridge import _tensor
from repro_torch.kernels import kv_cache as tkv
from repro_torch.kernels import ops as tops
from repro_torch.kernels import pdq_prologue as tpro
from repro_torch.kernels import ref as tref
from repro_torch.kernels import w8a8_matmul as tmm

torch.set_num_threads(1)


def _t(a):
    return _tensor(np.asarray(a), "cpu")


def _n(t):
    if t.dtype == torch.bfloat16:
        return t.view(torch.uint16).numpy()
    return t.numpy()


def _raw(a):
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def _sums_close(got, want, x):
    """s1/s2 agree to rtol 1e-5 of the row's sum of magnitudes."""
    scale = np.abs(np.asarray(x, np.float32)).sum(-1, keepdims=True)
    np.testing.assert_array_less(np.abs(np.asarray(got) - np.asarray(want)),
                                 1e-5 * np.maximum(scale, 1.0))


@pytest.mark.parametrize("shape,dtype", [((8, 256), "float32"),
                                         ((5, 2048), "bfloat16"),
                                         ((3, 77), "float32")])
def test_pdq_prologue_plain_matches_jax(shape, dtype):
    rng = np.random.default_rng(0)
    x = jnp.asarray(3 * rng.standard_normal(shape), dtype)
    jq, jsx, js1, js2 = jref.pdq_prologue_ref(x)
    tq, tsx, ts1, ts2 = tref.pdq_prologue_ref(_t(x))
    np.testing.assert_array_equal(_n(tq), np.asarray(jq))
    np.testing.assert_allclose(_n(tsx), np.asarray(jsx), rtol=1e-6)
    x32 = np.asarray(x, np.float32)
    _sums_close(_n(ts1), js1, x32)
    _sums_close(_n(ts2), js2, x32 * x32)


def test_pdq_prologue_rounds_half_to_even():
    # amax 127 makes s_x exactly 1, so x / s_x lands on .5 ties
    x = np.array([[127.0, 2.5, -3.5, 0.5, -0.5, 1.5, 126.5]], np.float32)
    tq = _n(tref.pdq_prologue_ref(torch.from_numpy(x))[0])
    jq = np.asarray(jref.pdq_prologue_ref(jnp.asarray(x))[0])
    np.testing.assert_array_equal(tq, [[127, 2, -4, 0, 0, 2, 126]])
    np.testing.assert_array_equal(tq, jq)


def _w8a8_inputs(M, K, N, seed=1):
    rng = np.random.default_rng(seed)
    return dict(
        x_q=rng.integers(-127, 128, (M, K)).astype(np.int8),
        w_q=rng.integers(-127, 128, (K, N)).astype(np.int8),
        s_x=rng.uniform(0.01, 0.05, (M, 1)).astype(np.float32),
        z_x=rng.integers(-3, 4, (M, 1)).astype(np.int32),
        s_w=rng.uniform(0.001, 0.01, (1, N)).astype(np.float32),
        s_out=rng.uniform(0.5, 2.0, (M, 1)).astype(np.float32),
        z_out=rng.integers(-20, 21, (M, 1)).astype(np.int32))


@pytest.mark.parametrize("M,K,N", [(8, 256, 384), (3, 100, 70)])
def test_w8a8_matmul_ref_matches_jax(M, K, N):
    a = _w8a8_inputs(M, K, N)
    base = [a[k] for k in ("x_q", "w_q", "s_x", "z_x", "s_w")]
    jy = jref.w8a8_matmul_ref(*map(jnp.asarray, base))
    ty = tref.w8a8_matmul_ref(*map(_t, base))
    np.testing.assert_array_equal(_n(ty), np.asarray(jy))
    jq = jref.w8a8_matmul_ref(*map(jnp.asarray, base), jnp.asarray(a["s_out"]),
                              jnp.asarray(a["z_out"]))
    tq = tref.w8a8_matmul_ref(*map(_t, base), _t(a["s_out"]), _t(a["z_out"]))
    np.testing.assert_array_equal(_n(tq), np.asarray(jq))


@pytest.mark.parametrize("per_block", [False, True])
@pytest.mark.parametrize("mode", ["fp_clamp", "requant"])
def test_w8a8_matmul_op_matches_jax(per_block, mode):
    """ops.w8a8_matmul with both epilogues and both operand layouts (the
    JAX op runs its jnp oracle here, as the JAX tests run it on the CPU)."""
    M, K, N = 6, 192, 384
    a = _w8a8_inputs(M, K, N, seed=2)
    rng = np.random.default_rng(3)
    E = N // 128 if per_block else 1
    lo = -rng.uniform(1, 5, (M, E)).astype(np.float32)
    hi = rng.uniform(1, 5, (M, E)).astype(np.float32)
    s_out = rng.uniform(0.02, 0.1, (M, E)).astype(np.float32)
    z_out = rng.integers(-10, 11, (M, E)).astype(np.int32)
    x3 = a["x_q"].reshape(2, 3, K)                       # leading batch dims
    lead = lambda v: v.reshape(2, 3, E)                   # noqa: E731
    common = (a["s_x"].reshape(2, 3, 1), a["z_x"].reshape(2, 3, 1),
              a["s_w"].reshape(N))
    if mode == "fp_clamp":
        jy = jops.w8a8_matmul(jnp.asarray(x3), jnp.asarray(a["w_q"]),
                              *map(jnp.asarray, common),
                              fp_range=(jnp.asarray(lead(lo)), jnp.asarray(lead(hi))))
        ty = tops.w8a8_matmul(_t(x3), _t(a["w_q"]), *map(_t, common),
                              fp_range=(_t(lead(lo)), _t(lead(hi))))
    else:
        jy = jops.w8a8_matmul(jnp.asarray(x3), jnp.asarray(a["w_q"]),
                              *map(jnp.asarray, common),
                              jnp.asarray(lead(s_out)), jnp.asarray(lead(z_out)))
        ty = tops.w8a8_matmul(_t(x3), _t(a["w_q"]), *map(_t, common),
                              _t(lead(s_out)), _t(lead(z_out)))
    assert ty.shape == (2, 3, N)
    np.testing.assert_array_equal(_n(ty), np.asarray(jy))


def test_swiglu_plain_matches_jax_composition():
    """The fused SwiGLU plain version == JAX's clamped matmul oracle + silu
    + prologue oracle (the TPU kernel does not trace on this JAX, so the
    composition is the reference; tolerances of tests/test_kernels.py)."""
    M, K, N = 16, 256, 512
    P = N // 2
    a = _w8a8_inputs(M, K, N, seed=4)
    rng = np.random.default_rng(5)
    lo = -rng.uniform(5, 20, (M, N // 128)).astype(np.float32)
    hi = rng.uniform(5, 20, (M, N // 128)).astype(np.float32)
    base = [a[k] for k in ("x_q", "w_q", "s_x", "z_x", "s_w")]
    y_j = jref.w8a8_matmul_ref(*map(jnp.asarray, base))
    y_j = jnp.clip(y_j, jnp.repeat(lo, 128, -1), jnp.repeat(hi, 128, -1))
    hsw_j = jax.nn.silu(y_j[:, :P]) * y_j[:, P:]
    pq, psx, ps1, ps2 = jref.pdq_prologue_ref(hsw_j)
    y, hsw, hq, sx, s1, s2 = tref.w8a8_swiglu_ref(*map(_t, base), _t(lo), _t(hi))
    np.testing.assert_array_equal(_n(y), np.asarray(y_j))
    np.testing.assert_allclose(_n(hsw), hsw_j, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_n(sx), psx, rtol=1e-5)
    np.testing.assert_allclose(_n(s1), ps1, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(_n(s2), ps2, rtol=1e-4, atol=1e-4)
    assert np.abs(_n(hq).astype(np.int32) - np.asarray(pq, np.int32)).max() <= 1


@pytest.mark.parametrize("dtype", ["int8", "int32", "bfloat16", "float32"])
@pytest.mark.parametrize("batch_axis", [0, 1])
def test_cache_scatter_matches_jax_bit_exact(dtype, batch_axis):
    rng = np.random.default_rng(6)
    lead = (3, 5) if batch_axis == 1 else (5,)
    src_lead = (3, 4) if batch_axis == 1 else (4,)
    row = (6, 2, 4)

    def make(shape):
        if dtype in ("int8", "int32"):
            return jnp.asarray(rng.integers(-100, 100, shape), dtype)
        return jnp.asarray(rng.standard_normal(shape), dtype)

    dst, src = make(lead + row), make(src_lead + row)
    src_map = np.array([2, -1, 0, 3, -1], np.int32)
    want = jops.cache_scatter_rows(dst, src, jnp.asarray(src_map),
                                   batch_axis=batch_axis)
    got = _t(dst)
    out = tops.cache_scatter_rows(got, _t(src), src_map, batch_axis=batch_axis)
    assert out is got                                   # updated in place
    np.testing.assert_array_equal(_n(got), _raw(want))


def test_cache_scatter_rejects_out_of_range_map():
    dst, src = torch.zeros(4, 3), torch.ones(2, 3)
    with pytest.raises(ValueError):
        tops.cache_scatter_rows(dst, src, np.array([0, 2, -1, -1], np.int32))


def test_ops_count_entries_on_cpu_and_never_launch():
    tops.reset_counts()
    x = torch.randn(4, 64)
    tops.pdq_prologue(x)
    tops.w8a8_matmul(torch.zeros(4, 64, dtype=torch.int8),
                     torch.zeros(64, 128, dtype=torch.int8), 1.0, 0, 1.0)
    tops.cache_scatter_rows(torch.zeros(2, 3), torch.ones(2, 3),
                            np.array([1, -1], np.int32))
    kv = (torch.randn(2, 4, 16), torch.zeros(2, 2, 128, 16, dtype=torch.int8),
          torch.zeros(2, 2, 128, 16, dtype=torch.int8), torch.ones(2, 2, 128),
          torch.ones(2, 2, 128), torch.tensor([3, 1], dtype=torch.int32))
    tops.decode_attend_i8kv(*kv)
    tops.decode_attend_i8kv(*kv, wo_prologue=True)
    tops.decode_attend_i8kv(*kv, wo_prologue=True, pro_dtype=torch.bfloat16)
    c = tops.counts()
    assert {k: v["entries"] for k, v in c.items()} == {
        "pdq_prologue": 1, "w8a8_matmul": 1, "w8a8_swiglu_matmul": 0,
        "decode_attend_i8kv": 1, "decode_attend_i8kv_fused": 2,
        "cache_scatter": 1}
    assert all(v["launches"] == 0 for v in c.values())


@pytest.mark.parametrize("call", [
    lambda x: tpro.pdq_prologue(x),
    lambda x: tkv.cache_scatter(x, x, torch.zeros(4, dtype=torch.int32)),
    lambda x: tmm.w8a8_swiglu_matmul(x, x, x, x, x, x, x, x),
    lambda x: tkv.decode_attend_i8kv(x, x, x, x, x, x),
    lambda x: tkv.decode_attend_i8kv_fused(x, x, x, x, x, x),
])
def test_non_cpu_tensor_never_takes_the_plain_version(call):
    """Only a CPU tensor takes the plain version: anything else goes to the
    CUDA launch, which refuses a tensor that is not on the card."""
    with pytest.raises(ValueError, match="CUDA"):
        call(torch.empty((4, 256), device="meta"))
