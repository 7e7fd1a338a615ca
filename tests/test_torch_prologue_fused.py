"""K1's fused modes (repro_torch/kernels/pdq_prologue.py: the RMSNorm in
front of the prologue and the PDQ interval after it, in one launch on the
card) on the CPU, where the wrapper takes the plain version, against:

- the JAX package's chain on the same numpy inputs: ``rms_norm`` (models/
  layers.py) -> ``pdq_prologue_ref`` -> ``ops.pdq_interval`` -> the grid
  extent -> per-block repeat;
- the port's own unfused composition (rms_norm, the prologue and the
  interval each in plain torch), bit for bit: on the CPU the fused entry
  points compute exactly what it computes, from the op level up to the
  model's logits and caches.

Tolerances against JAX: x_q and s_x equal to JAX's prologue of the same
row.  With the norm in front, the normed row is within NORM_RTOL of JAX's
(one bf16 ulp; rtol 1e-6 in f32, a few ulps): the two means sum in
another order and JAX's rsqrt rounds its own way, so a normed value can
land an ulp away (in bf16, one code of 394240 moves at (70, 5632)); x_q
is then within one code and s_x within NORM_RTOL of JAX's whole chain.
s1/s2 within 1e-5 of the row's sum of magnitudes
(tests/test_torch_kernels.py); lo_g/hi_g within one step of the row's grid
(s_out), as the dense outputs in tests/test_torch_linops.py, since a
different s1/s2 can move the zero point at a tie.  Norm weights are
nonzero: the model's init makes them zeros, which would hide a wrong
(1 + w).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models.layers import rms_norm as j_rms_norm
from repro_torch.bridge import _tensor
from repro_torch.configs import reduced_config as t_reduced
from repro_torch.kernels import ops as tops
from repro_torch.kernels import pdq_prologue as tpro
from repro_torch.kernels import ref as tref
from repro_torch.models import api as tapi
from repro_torch.models import build_model as t_build
from repro_torch.models import transformer as ttr
from repro_torch.models.attention import gqa_apply
from repro_torch.models.layers import embed_apply, mlp_apply
from repro_torch.models.linops import group_quantize_weights, quantize_weight
from repro_torch.models.linops import quantize_param_tree as t_quantize

torch.set_num_threads(1)

EPS = 1e-5
SHAPES = [((3, 77), "float32"), ((8, 256), "bfloat16"), ((70, 5632), "bfloat16")]
SEG_BLOCKS = (3, 1, 2)       # 128-column blocks of each segment
NORM_RTOL = {"bfloat16": 2.0 ** -7, "float32": 1e-6}


def _n(t):
    return t.view(torch.uint16).numpy() if t.dtype == torch.bfloat16 else t.numpy()


def _inputs(shape, dtype, n_seg, seed=0):
    """h (M, K), a nonzero norm weight (K,) and the interval's weight stats:
    0-dim for one segment (a single record), (n_seg,) for a group."""
    rng = np.random.default_rng(seed)
    K = shape[-1]
    h = jnp.asarray(3 * rng.standard_normal(shape), dtype)
    w = jnp.asarray(0.2 * rng.standard_normal(K), dtype)
    n = () if n_seg == 1 else (n_seg,)
    stats = {"mu_w": 1e-3 * rng.standard_normal(n),
             "var_w": (0.5 + rng.random(n)) / K,
             "alpha": np.full(n, 6.0), "beta": np.full(n, 6.0)}
    stats = {k: np.asarray(v, np.float32) for k, v in stats.items()}
    return h, w, stats


def _jax_chain(h, w, stats, norm, blocks):
    y = j_rms_norm(h, w, EPS) if norm else h
    x_q, s_x, s1, s2 = jref.pdq_prologue_ref(y)
    if stats is None:
        return (x_q, s_x, s1, s2), None
    jrec = {k: jnp.asarray(v) for k, v in stats.items()}
    _, _, s_out, z_out = jops.pdq_interval(jrec, s1, s2)
    lo_g, hi_g = (-128.0 - z_out) * s_out, (127.0 - z_out) * s_out
    if blocks is not None:
        rep = lambda a: jnp.repeat(a, np.asarray(blocks), axis=-1,   # noqa: E731
                                   total_repeat_length=sum(blocks))
        lo_g, hi_g, s_out = rep(lo_g), rep(hi_g), rep(s_out)
    return (x_q, s_x, s1, s2, lo_g, hi_g), s_out


def _sums_close(got, want, x):
    scale = np.abs(np.asarray(x, np.float32)).sum(-1, keepdims=True)
    np.testing.assert_array_less(np.abs(np.asarray(got) - np.asarray(want)),
                                 1e-5 * np.maximum(scale, 1.0))


def _within_one_step(got, want, s_out):
    err = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    step = np.broadcast_to(np.asarray(s_out, np.float64), err.shape)
    np.testing.assert_array_less(err, step * (1 + 1e-5) + 1e-6)


_MODES = [("norm", None), ("prologue", None)] + [
    (m, n) for m in ("interval", "norm+interval") for n in (1, 2, 3)]


@pytest.mark.parametrize("mode,n_seg", _MODES)
@pytest.mark.parametrize("shape,dtype", SHAPES)
def test_fused_modes_match_jax(shape, dtype, mode, n_seg):
    norm, interval = mode.startswith("norm"), n_seg is not None
    h, w, stats = _inputs(shape, dtype, n_seg or 1)
    blocks = SEG_BLOCKS[:n_seg] if interval and n_seg > 1 else None
    want, s_out = _jax_chain(h, w, stats if interval else None, norm, blocks)
    trec = {k: torch.from_numpy(v) for k, v in stats.items()}
    got = tpro.pdq_prologue(_tensor(np.asarray(h), "cpu"),
                            (_tensor(np.asarray(w), "cpu"), EPS) if norm else None,
                            (trec, blocks) if interval else None, return_normed=True)
    assert len(got) == len(want) + 1
    y = got[-1]
    y32 = y.float().numpy()
    own = want
    if norm:
        # the normed rows near JAX's (one bf16 ulp; a few f32 ulps, JAX's
        # rsqrt rounding its own way), and the prologue of the port's own
        # row exactly JAX's prologue of that row
        rtol = NORM_RTOL[dtype]
        jy = np.asarray(j_rms_norm(h, w, EPS)).astype(np.float32)
        np.testing.assert_allclose(y32, jy, rtol=rtol, atol=0)
        own = jref.pdq_prologue_ref(jnp.asarray(_n(y).view(np.asarray(h).dtype)
                                                if dtype == "bfloat16" else y32))
        assert np.abs(_n(got[0]).astype(np.int32) - np.asarray(want[0], np.int32)).max() <= 1
        np.testing.assert_allclose(got[1].numpy(), want[1], rtol=rtol, atol=0)
    np.testing.assert_array_equal(_n(got[0]), np.asarray(own[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(own[1]))
    _sums_close(got[2].numpy(), want[2], y32)
    _sums_close(got[3].numpy(), want[3], y32 * y32)
    if interval:
        cols = sum(blocks) if blocks else 1
        assert got[4].shape == got[5].shape == (shape[0], cols)
        _within_one_step(got[4].numpy(), want[4], s_out)
        _within_one_step(got[5].numpy(), want[5], s_out)


@pytest.mark.parametrize("n_seg", [1, 2, 3])
@pytest.mark.parametrize("shape,dtype", SHAPES)
def test_fused_entry_is_the_composition_bit_for_bit(shape, dtype, n_seg):
    """K1 with norm and interval on the CPU is rms_norm, then the prologue,
    then the interval, grid extent and per-block layout, bit for bit."""
    h, w, stats = _inputs(shape, dtype, n_seg, seed=1)
    h, w = _tensor(np.asarray(h), "cpu"), _tensor(np.asarray(w), "cpu")
    rec = {k: torch.from_numpy(v) for k, v in stats.items()}
    blocks = SEG_BLOCKS[:n_seg] if n_seg > 1 else None
    got = tpro.pdq_prologue(h, (w, EPS), (rec, blocks), return_normed=True)
    y = tref.rms_norm(h, w, EPS)
    x_q, s_x, s1, s2 = tref.pdq_prologue_ref(y)
    _, _, s_out, z_out = tref.pdq_interval(rec, s1, s2)
    lo_g, hi_g = (-128.0 - z_out) * s_out, (127.0 - z_out) * s_out
    if blocks is not None:
        idx = torch.as_tensor(np.repeat(np.arange(n_seg), blocks))
        lo_g, hi_g = lo_g[:, idx], hi_g[:, idx]
    for a, b in zip(got, (x_q, s_x, s1, s2, lo_g, hi_g, y)):
        assert torch.equal(a, b)


def _w(shape, seed, scale=0.1):
    return torch.from_numpy(
        (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ops_with_norm_equal_ops_of_the_normed_input(dtype):
    """pdq_dense_grouped (fp and int8 out) and pdq_mlp with ``norm`` equal
    the same ops on rms_norm's output; pdq_dense(out='fp') equals the
    prologue, interval, grid extent and matmul composed by hand."""
    K, dff = 256, 384
    h = (3 * _w((2, 5, K), 0, 1.0)).to(dtype)
    w = _w((K,), 1, 0.2).to(dtype)
    grec = group_quantize_weights([_w((K, n), 10 + i) for i, n in enumerate((256, 64, 64))])
    gu = group_quantize_weights([_w((K, dff), 20), _w((K, dff), 21)])
    down = quantize_weight(_w((dff, K), 22))
    x = tref.rms_norm(h, w, EPS)
    for a, b in zip(tops.pdq_dense_grouped(h, grec, norm=(w, EPS), out_dtype=dtype),
                    tops.pdq_dense_grouped(x, grec, out_dtype=dtype)):
        assert torch.equal(a, b)
    (ga, sa, za), (gb, sb, zb) = (tops.pdq_dense_grouped(h, grec, out="int8", norm=(w, EPS)),
                                  tops.pdq_dense_grouped(x, grec, out="int8"))
    assert all(torch.equal(a, b) for a, b in zip(ga, gb))
    assert torch.equal(sa, sb) and torch.equal(za, zb) and sa.shape == (2, 5, 3)
    assert torch.equal(tops.pdq_mlp(h, gu, down, norm=(w, EPS), out_dtype=dtype),
                       tops.pdq_mlp(x, gu, down, out_dtype=dtype))
    rec = quantize_weight(_w((K, 200), 30))
    x_q, s_x, s1, s2 = tops.pdq_prologue(x)
    lo_g, hi_g = tops._grid_extent(*tops.pdq_interval(rec, s1, s2)[2:])
    want = tops.w8a8_matmul(x_q, rec["q"], s_x, 0, rec["scale"], colsum=rec["colsum"],
                            fp_range=(lo_g, hi_g), out_dtype=dtype)
    assert torch.equal(tops.pdq_dense(x, rec, out="fp", out_dtype=dtype), want)


def _unfused_lm_apply(params, cfg, *, tokens, positions, mode, caches, seq_lens=None):
    """transformer.lm_apply as the unfused composition: rms_norm in plain
    torch, then attention and the MLP on its output."""
    dims, eps = ttr.attn_dims(cfg), cfg.norm_eps
    h = embed_apply(params["embed"], tokens).to(ttr.model_dtype(cfg))
    stacked = caches["blocks"][0]
    for i, p in enumerate(params["blocks"]):
        cache = {k: v[i] for k, v in stacked.items()}
        a, _ = gqa_apply(p["attn"], dims, tref.rms_norm(h, p["attn_norm"], eps),
                         positions, mode=mode, cache=cache, seq_lens=seq_lens)
        h = h + a
        h = h + mlp_apply(p["ffn"], tref.rms_norm(h, p["ffn_norm"], eps))
    return tref.rms_norm(h, params["final_norm"], eps), caches, 0.0


def _serve(bundle, params, steps=3):
    """Ragged prefill of 3 rows, then ``steps`` greedy decode steps: every
    step's logits and the final caches."""
    B, L = 3, 12
    seq_lens = torch.tensor([12, 7, 3], dtype=torch.int32)
    rng = np.random.default_rng(5)
    tokens = torch.from_numpy(rng.integers(0, 512, (B, L)).astype(np.int32))
    logits, caches = bundle.prefill_many(params, {"tokens": tokens},
                                         bundle.init_caches(B, 32), seq_lens)
    out = [logits]
    pos = seq_lens.clone()[:, None]
    for _ in range(steps):
        tok = logits.argmax(-1).to(torch.int32)[:, None]
        logits, caches = bundle.decode_step(params, caches, tok, pos)
        out.append(logits)
        pos = pos + 1
    return out, caches


@pytest.mark.parametrize("dtype,quant_kv", [("float32", "none"), ("bfloat16", "dynamic")])
def test_model_with_nonzero_norms_equals_unfused_composition(monkeypatch, dtype, quant_kv):
    """Prefill and decode logits and the caches (int8 codes included) of
    the PDQ model equal the unfused composition's bit for bit, with nonzero
    attn/ffn/final norm weights."""
    cfg = t_reduced("stablelm-1.6b", dtype=dtype, quant_kv=quant_kv)
    bundle = t_build(cfg, "cpu")
    params = bundle.init(3)
    rng = np.random.default_rng(4)
    nz = lambda t: torch.from_numpy(                               # noqa: E731
        (0.3 * rng.standard_normal(t.shape)).astype(np.float32)).to(t.dtype)
    for p in params["blocks"]:
        p["attn_norm"], p["ffn_norm"] = nz(p["attn_norm"]), nz(p["ffn_norm"])
    params["final_norm"] = nz(params["final_norm"])
    params = t_quantize(params)
    fused, fc = _serve(bundle, params)
    monkeypatch.setattr(tapi, "lm_apply", _unfused_lm_apply)
    unfused, uc = _serve(bundle, params)
    for a, b in zip(fused, unfused):
        assert torch.equal(a, b)
    for k, v in fc["blocks"][0].items():
        assert torch.equal(v, uc["blocks"][0][k]), k


@pytest.mark.parametrize("quant_kv,decode_per_layer", [("none", 3), ("dynamic", 2)])
def test_prologue_entries_per_layer_unchanged(quant_kv, decode_per_layer):
    """K1 is entered 3 times a layer at prefill (QKV with its norm, wo,
    gate/up with its norm) and 3 (fp KV) or 2 (int8 KV: wo's prologue runs
    in the attend kernel) a decode step."""
    cfg = t_reduced("stablelm-1.6b", quant_kv=quant_kv)
    bundle = t_build(cfg, "cpu")
    params = t_quantize(bundle.init(0))
    caches = bundle.init_caches(2, 16)
    tops.reset_counts()
    bundle.prefill(params, {"tokens": torch.zeros((2, 5), dtype=torch.int32)}, caches)
    n = cfg.n_layers
    assert tops.counts()["pdq_prologue"] == {"entries": 3 * n, "launches": 0}
    tops.reset_counts()
    bundle.decode_step(params, caches, torch.zeros((2, 1), dtype=torch.int32),
                       torch.full((2, 1), 5, dtype=torch.int32))
    assert tops.counts()["pdq_prologue"] == {"entries": decode_per_layer * n,
                                             "launches": 0}
    assert all(v == 0 for v in tops.prologue_modes().values())


@pytest.mark.parametrize("norm,interval", [(True, False), (False, True), (True, True)])
def test_fused_modes_never_take_the_plain_version_off_the_cpu(norm, interval):
    """Only a CPU tensor takes the plain version: a tensor elsewhere goes to
    the CUDA launch, which refuses it."""
    x = torch.empty((4, 256), device="meta")
    rec = {k: torch.empty((), device="meta") for k in ("mu_w", "var_w", "alpha", "beta")}
    with pytest.raises(ValueError, match="CUDA"):
        tpro.pdq_prologue(x, (torch.empty(256, device="meta"), EPS) if norm else None,
                          (rec, None) if interval else None)


def test_mode_names():
    assert [tpro.mode_of(n, i) for n in (None, 1) for i in (None, 1)] == [
        "prologue", "interval", "norm", "norm+interval"]
    assert set(tops.prologue_modes()) == {"prologue", "norm", "interval", "norm+interval"}
