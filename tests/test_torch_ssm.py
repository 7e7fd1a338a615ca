"""The port's Mamba2 SSD block (``repro_torch/models/ssm.py``) against the
JAX package's (``repro/models/ssm.py``) on the same numpy inputs and
weights, on the CPU, float32: an SSM of d_model 32, d_inner 64 (8 heads of
8), state 16, conv 4, chunks of 8.

- ``_segsum`` and ``ssd_scan`` (one chunk, several chunks with the
  reference's zero padding of a ragged last chunk, with and without an
  initial state): y and the final state within 1e-5
  (tests/test_torch_model.py's fp tolerance), relative as well as absolute
  (rtol = atol, as tests/test_torch_moe.py's layer): the port's
  contractions are batched matmuls in another order than JAX's einsums,
  and the scan's outputs reach |y| ~6 here, where an f32 ulp is 4.8e-7
  (measured 1.05e-5 at |y| 5.5, 1.9e-6 relative).
- ``ssm_apply`` in its three modes, with the layer's input RMSNorm inside
  ``in_proj`` (``norm=``; the reference norms first): prefill from a fresh
  cache over right-padded rows and a dummy row (``seq_lens`` 0), an
  unpadded prefill, a chunked continuation (the conv left context and the
  initial state from a cache that earlier chunks wrote, some rows done:
  ``seq_lens`` 0), and decode.  y, the conv tail and the state within 1e-5
  with fp weights; with PDQ records on ``in_proj`` / ``out_proj`` (JAX on
  its ``quantize_param_tree`` of the same block) within 1e-3, the PDQ
  tolerance.  The port writes the cache in place; a dummy row's cache is
  left as it was, bit for bit.
- Pads are skipped: a padded prefill gives each row the conv tail of its
  unpadded prefill alone bit for bit, and its y rows and state within
  1e-6 (the two runs' chunk grids end apart, so a matmul may sum a chunk's
  zero terms in another order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ssm as jssm
from repro.models.layers import rms_norm as j_rms_norm
from repro.models.linops import quantize_param_tree as j_quantize
from repro_torch.bridge import _tensor
from repro_torch.models import ssm as tssm
from repro_torch.models.linops import quantize_param_tree as t_quantize

torch.set_num_threads(1)

TOL = {"fp": 1e-5, "pdq": 1e-3}          # tests/test_torch_model.py
EPS = 1e-6
J_CFG = jssm.SSMConfig(d_model=32, d_state=16, head_dim=8, expand=2, d_conv=4, chunk=8)
T_CFG = tssm.SSMConfig(d_model=32, d_state=16, head_dim=8, expand=2, d_conv=4, chunk=8)


def _t(tree):
    if isinstance(tree, dict):
        return {k: _t(v) for k, v in tree.items()}
    return _tensor(np.asarray(tree), "cpu")


def _close(a, b, tol, what):
    np.testing.assert_allclose(np.asarray(b), np.asarray(a), rtol=tol, atol=tol,
                               err_msg=what)


def _params(kind):
    """(JAX params, port params, the input norm's weight as (jax, torch))."""
    jp = jssm.ssm_init(jax.random.PRNGKey(3), J_CFG, jnp.float32)
    rng = np.random.default_rng(4)
    # a nonzero gated-norm weight, dt bias and conv bias, so every term moves
    jp = dict(jp, norm=jnp.asarray(0.2 * rng.standard_normal(64), jnp.float32),
              dt_bias=jnp.asarray(0.3 * rng.standard_normal(8), jnp.float32),
              conv_b=jnp.asarray(0.1 * rng.standard_normal(J_CFG.conv_dim), jnp.float32))
    w = (0.2 * rng.standard_normal(32)).astype(np.float32)
    tp = _t(jp)
    if kind == "pdq":
        jp, tp = j_quantize(jp), t_quantize(tp)
    return jp, tp, (jnp.asarray(w), torch.from_numpy(w))


def _x(B, L, seed):
    return np.random.default_rng(seed).standard_normal((B, L, 32)).astype(np.float32)


def _cache(B, seed=None):
    """A (JAX, port) cache pair: zeros, or a seeded nonzero conv tail and
    state (what earlier chunks landed)."""
    if seed is None:
        jc = jssm.ssm_init_cache(J_CFG, B, jnp.float32)
    else:
        rng = np.random.default_rng(seed)
        jc = {"conv": jnp.asarray(rng.standard_normal((B, 3, J_CFG.conv_dim)), jnp.float32),
              "state": jnp.asarray(0.5 * rng.standard_normal((B, 8, 8, 16)), jnp.float32)}
    return jc, _t(jc)


def test_segsum_matches_the_reference():
    x = np.random.default_rng(0).standard_normal((2, 3, 8)).astype(np.float32)
    a, b = np.asarray(jssm._segsum(jnp.asarray(x))), tssm._segsum(torch.from_numpy(x))
    assert np.array_equal(np.isinf(a), np.isinf(b.numpy()))
    _close(np.where(np.isinf(a), 0, a), torch.where(b.isinf(), 0, b), 1e-5, "segsum")


@pytest.mark.parametrize("L,init", [(8, False), (21, False), (21, True), (5, True)])
def test_ssd_scan_matches_the_reference(L, init):
    """One chunk, three chunks with a ragged last one (zero padded), with
    and without an initial state, and L below the chunk (one short chunk)."""
    rng = np.random.default_rng(L)
    B, H, P, N = 2, 8, 8, 16
    x = rng.standard_normal((B, L, H, P)).astype(np.float32)
    dt = np.abs(rng.standard_normal((B, L, H))).astype(np.float32) * 0.5
    A = -np.exp(np.log(np.linspace(1.0, 16.0, H))).astype(np.float32)
    Bm, Cm = (rng.standard_normal((B, L, N)).astype(np.float32) for _ in range(2))
    s0 = rng.standard_normal((B, H, P, N)).astype(np.float32) if init else None
    jy, jf = jssm.ssd_scan(*(jnp.asarray(a) for a in (x, dt, A, Bm, Cm)), 8,
                           None if s0 is None else jnp.asarray(s0))
    ty, tf = tssm.ssd_scan(*(torch.from_numpy(a) for a in (x, dt, A, Bm, Cm)), 8,
                           None if s0 is None else torch.from_numpy(s0))
    assert ty.shape == (B, L, H, P) and tf.shape == (B, H, P, N)
    assert ty.dtype == tf.dtype == torch.float32
    _close(jy, ty, TOL["fp"], "y")
    _close(jf, tf, TOL["fp"], "final state")


def _apply_both(kind, mode, x, seq_lens, cache_seed):
    jp, tp, (jw, tw) = _params(kind)
    B = x.shape[0]
    jc, tc = _cache(B, cache_seed)
    sl = None if seq_lens is None else np.asarray(seq_lens, np.int32)
    jy, jnc = jssm.ssm_apply(jp, J_CFG, j_rms_norm(jnp.asarray(x), jw, EPS), mode=mode,
                             cache=jc, seq_lens=None if sl is None else jnp.asarray(sl))
    before = {k: v.clone() for k, v in tc.items()}
    ty = tssm.ssm_apply(tp, T_CFG, torch.from_numpy(x), mode=mode, cache=tc,
                        seq_lens=None if sl is None else torch.from_numpy(sl),
                        norm=(tw, EPS))
    return jy, jnc, ty, tc, before


CASES = [("prefill", 21, [21, 13, 0], None),        # padded rows and a dummy row
         ("prefill", 21, None, None),               # unpadded
         ("prefill", 16, [16, 0, 7], 11),           # a chunked continuation
         ("decode", 1, None, 12)]


@pytest.mark.parametrize("kind", ["fp", "pdq"])
@pytest.mark.parametrize("mode,L,seq_lens,cache_seed", CASES)
def test_ssm_apply_matches_the_reference(kind, mode, L, seq_lens, cache_seed):
    x = _x(3, L, seed=L)
    jy, jnc, ty, tc, before = _apply_both(kind, mode, x, seq_lens, cache_seed)
    assert ty.shape == (3, L, 32) and ty.dtype == torch.float32
    rows = range(3) if seq_lens is None else [b for b in range(3) if seq_lens[b]]
    for b in rows:
        n = L if seq_lens is None else seq_lens[b]
        _close(np.asarray(jy)[b, :n], ty[b, :n], TOL[kind], f"y row {b}")
        _close(np.asarray(jnc["conv"])[b], tc["conv"][b], TOL[kind], f"conv row {b}")
        _close(np.asarray(jnc["state"])[b], tc["state"][b], TOL[kind], f"state row {b}")
    for b in set(range(3)) - set(rows):        # a dummy row keeps its cache
        assert all(torch.equal(tc[k][b], before[k][b]) for k in tc), b


def test_padded_prefill_equals_each_row_alone():
    """A right-padded bucket gives each row the conv tail of its unpadded
    prefill alone bit for bit (the tail is gathered at the row's end), and
    its y and state within 1e-6 (pads' dt is exactly 0)."""
    _, tp, (_, tw) = _params("fp")
    x = torch.from_numpy(_x(2, 21, seed=5))
    lens = [21, 9]
    tc = tssm.ssm_init_cache(T_CFG, 2, torch.float32, "cpu")
    y = tssm.ssm_apply(tp, T_CFG, x, mode="prefill", cache=tc,
                       seq_lens=torch.tensor(lens, dtype=torch.int32), norm=(tw, EPS))
    for b, n in enumerate(lens):
        c1 = tssm.ssm_init_cache(T_CFG, 1, torch.float32, "cpu")
        y1 = tssm.ssm_apply(tp, T_CFG, x[b:b + 1, :n], mode="prefill", cache=c1,
                            norm=(tw, EPS))
        _close(y1[0].numpy(), y[b, :n], 1e-6, f"y row {b}")
        assert torch.equal(c1["conv"][0], tc["conv"][b]), b
        _close(c1["state"][0].numpy(), tc["state"][b], 1e-6, f"state row {b}")


def test_decode_writes_the_cache_in_place():
    """Decode updates the given cache tensors (a captured graph replays
    their addresses) and returns nothing else that aliases them."""
    _, tp, (_, tw) = _params("fp")
    _, tc = _cache(3, 12)
    ptrs = {k: v.data_ptr() for k, v in tc.items()}
    before = {k: v.clone() for k, v in tc.items()}
    tssm.ssm_apply(tp, T_CFG, torch.from_numpy(_x(3, 1, seed=1)), mode="decode",
                   cache=tc, norm=(tw, EPS))
    assert {k: v.data_ptr() for k, v in tc.items()} == ptrs
    assert torch.equal(tc["conv"][:, :2], before["conv"][:, 1:])
    assert not torch.equal(tc["state"], before["state"])


def test_decode_refuses_more_than_one_token():
    _, tp, _ = _params("fp")
    _, tc = _cache(1)
    with pytest.raises(ValueError, match="one token"):
        tssm.ssm_apply(tp, T_CFG, torch.zeros((1, 2, 32)), mode="decode", cache=tc)
