"""The port's local/global and llama-style decoders against the JAX
package's, on the same numpy weights (everything on the CPU): reduced
gemma2-2b (local + global, attention and logit softcaps, embed_scale, 4
layers), gemma3-12b (5 local : 1 global, embed_scale, 12 layers) and yi-6b
(GQA, 2 layers), each d_model 64, 4 heads / 2 kv heads of 16, window 16,
float32 (``reduced_config``).

- The configs agree with the reference's field for field.
- ``prefill_many`` over ragged rows of a 32-token bucket (two rows longer
  than the 16-position window, so the local layers' ring is written past
  its end in one prefill), then 10 greedy decode steps teacher-forced on
  JAX's tokens, with fp and int8 KV: logits within tests/test_torch_model.py's
  tolerances (fp 1e-5, PDQ 1e-3); every cache leaf of every pattern kind
  after the prefill and after the decode: ``pos``, ``len`` and int8 codes
  exactly equal, float leaves (fp K/V, int8 scales) within the tolerance.
  The int8 codes are equal but where a k or v value, an ulp apart in the
  two packages (another summation order), rounds to the neighbouring code
  at a .5 tie: measured 1 code of 24 576 in gemma3-12b's global v cache
  after the prefill with fp weights, so codes are held within one step and
  at most ``CODE_FLIPS`` of them moved; given the same k/v the codes are
  equal exactly (the ring test below).  A moved KV code moves the decode
  logits by up to 8.6e-5 here, so with the int8 cache the logits are held
  within the PDQ tolerance, whose reason is the same (a code at a tie).  With PDQ weights an activation code can land on the other side of a .5
  tie when its input moves by an ulp (the two packages sum in other
  orders): measured once in these runs, a w_down input code of gemma2-2b's
  row 2 at decode step 2, which moves that step's logits by 6.7e-3 and
  from then on writes other k/v codes into both kinds' caches.  So a PDQ
  decode step's logits are held within ``FLIP_TOL`` (one such flip, carried
  through the rest of the model and the later steps: 1.1e-2 measured at
  step 9), its tokens equal JAX's or JAX's top-2 margin is below
  ``FLIP_TOL``, and its cache after the decode is held on ``pos`` and
  ``len``; the codes are held exactly after the prefill and, with fp
  weights, after the decode.
- An unchunked prefill longer than the window writes the ring as the
  reference does, bit for bit, given the same k/v (fp32, bf16 and int8
  caches, padded and unpadded rows): each slot ends with the row's last
  write to it.  The port makes that winner explicit (``_clamp_padded``'s
  ring rule), because CUDA's scatter leaves the winner of duplicate indices
  open.
- ``embed_scale`` multiplies by sqrt(d_model) rounded to the model's dtype
  first, as ``jnp.asarray(d_model ** 0.5, dtype)`` does.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as j_reduced
from repro.models import attention as jatt
from repro.models import build_model as j_build
from repro.models.linops import quantize_param_tree as j_quantize
from repro_torch.bridge import _tensor, params_from_numpy
from repro_torch.configs import get_config as t_get
from repro_torch.configs import reduced_config as t_reduced
from repro_torch.models import attention as tatt
from repro_torch.models import build_model as t_build
from repro_torch.models.linops import quantize_param_tree as t_quantize

torch.set_num_threads(1)

ARCHS = ("gemma2-2b", "gemma3-12b", "yi-6b")
TOL = {"fp": 1e-5, "pdq": 1e-3}          # tests/test_torch_model.py
FLIP_TOL = 2e-2                          # a PDQ decode after one code flip (above)
CODE_FLIPS = 1e-3                        # int8 K/V codes one step apart (above)
_MODELS: dict = {}


def _models(arch, int8_kv):
    """(JAX bundle, port bundle, {'fp': (jp, tp), 'pdq': (jp, tp)}) of the
    reduced ``arch`` on one set of JAX weights, cached per test module."""
    key = (arch, int8_kv)
    if key not in _MODELS:
        jcfg, tcfg = j_reduced(arch), t_reduced(arch)
        if int8_kv:
            jcfg = dataclasses.replace(jcfg, quant_kv="dynamic")
            tcfg = dataclasses.replace(tcfg, quant_kv="dynamic")
        jp = j_build(jcfg).init(jax.random.PRNGKey(0))
        tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
        _MODELS[key] = (j_build(jcfg), t_build(tcfg, "cpu"), {
            "fp": (jp, tp),
            "pdq": (dict(jp, blocks=jax.vmap(j_quantize)(jp["blocks"])), t_quantize(tp))})
    return _MODELS[key]


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_agree_with_the_reference(arch):
    from repro.configs import get_config as j_get
    for j, t in ((j_get(arch), t_get(arch)), (j_reduced(arch), t_reduced(arch))):
        for f in ("n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff", "vocab", "hd",
                  "n_blocks", "pattern", "window", "attn_softcap", "logit_softcap",
                  "rope_theta", "norm_eps", "embed_scale", "dtype"):
            assert getattr(j, f) == getattr(t, f), (arch, f)


def test_bridge_splits_each_kind_per_block():
    """``params["blocks"]`` is one list in layer order: layer i * P + j is
    block i's kind j, each leaf that block's slice of kind j's stack."""
    jb, tb, w = _models("gemma3-12b", False)
    jp, tp = w["fp"]
    P, n = len(tb.cfg.pattern), tb.cfg.n_blocks
    assert len(tp["blocks"]) == P * n == tb.cfg.n_layers
    for i in range(n):
        for j in range(P):
            np.testing.assert_array_equal(
                tp["blocks"][i * P + j]["attn"]["wq"].numpy(),
                np.asarray(jp["blocks"][j]["attn"]["wq"][i]))


def _check_step(jl, tl, tol, what):
    jl, tl = np.asarray(jl), tl.numpy()
    assert np.all(np.isfinite(tl))
    np.testing.assert_allclose(tl, jl, rtol=0, atol=tol, err_msg=what)


def _check_caches(jc, tc, tol, what, names=None):
    """Every leaf (or those in ``names``) of every pattern kind: ``pos`` and
    ``len`` exactly equal, int8 codes equal but for ``CODE_FLIPS`` (each
    within one code), float leaves within ``tol``."""
    assert len(jc["blocks"]) == len(tc["blocks"])
    for j, (jd, td) in enumerate(zip(jc["blocks"], tc["blocks"])):
        assert sorted(jd) == sorted(td), (what, j)
        for name in names or jd:
            a, b = np.asarray(jd[name]), td[name].numpy()
            assert a.shape == b.shape and a.dtype == b.dtype, (what, j, name)
            if a.dtype == np.int8:
                d = np.abs(a.astype(np.int32) - b)
                assert d.max() <= 1 and (d > 0).mean() <= CODE_FLIPS, (
                    what, j, name, int(d.max()), float((d > 0).mean()))
            elif a.dtype.kind in "iu":
                np.testing.assert_array_equal(b, a, err_msg=f"{what}: kind {j} {name}")
            else:
                np.testing.assert_allclose(b, a, rtol=1e-5, atol=tol,
                                           err_msg=f"{what}: kind {j} {name}")


@pytest.mark.parametrize("int8_kv", [False, True])
@pytest.mark.parametrize("kind", ["fp", "pdq"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_logits_and_caches_match_jax(arch, kind, int8_kv):
    jb, tb, w = _models(arch, int8_kv)
    jp, tp = w[kind]
    # an int8 code, an activation's or the KV cache's, can flip at a tie
    tol = TOL["pdq" if int8_kv else kind]
    B, L, max_len = 3, 32, 48
    seq_lens = np.array([32, 21, 5], np.int32)          # two rows past the window
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, tb.cfg.vocab, (B, L)).astype(np.int32)
    tokens[np.arange(L)[None, :] >= seq_lens[:, None]] = 0
    jl, jc = jb.prefill_many(jp, {"tokens": jnp.asarray(tokens)},
                             jb.init_caches(B, max_len), jnp.asarray(seq_lens))
    tl, tc = tb.prefill_many(tp, {"tokens": torch.from_numpy(tokens)},
                             tb.init_caches(B, max_len), torch.from_numpy(seq_lens))
    _check_step(jl, tl, tol, "prefill")
    _check_caches(jc, tc, tol, "after prefill")
    jstep = jax.jit(jb.decode_step)
    pos = seq_lens.copy()
    dec_tol = tol if kind == "fp" else FLIP_TOL
    for step in range(10):
        tok = np.array(jnp.argmax(jl, -1), np.int32)[:, None]
        p = pos[:, None].astype(np.int32)
        jl, jc = jstep(jp, jc, jnp.asarray(tok), jnp.asarray(p))
        tl, tc = tb.decode_step(tp, tc, torch.from_numpy(tok), torch.from_numpy(p))
        _check_step(jl, tl, dec_tol, f"decode step {step}")
        for b in range(B):
            if int(tl[b].argmax()) != int(np.argmax(jl[b])):
                top2 = np.sort(np.asarray(jl[b]))[-2:]
                assert top2[1] - top2[0] < dec_tol, (step, b, top2)
        pos += 1
    _check_caches(jc, tc, tol, "after decode", None if kind == "fp" else ("pos", "len"))


def _bits(x):
    if torch.is_tensor(x):
        return (x.view(torch.int16) if x.dtype == torch.bfloat16 else x).numpy()
    a = np.asarray(x)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


@pytest.mark.parametrize("padded", [False, True])
@pytest.mark.parametrize("cache", ["fp32", "bf16", "int8"])
def test_unchunked_prefill_past_the_window_writes_the_reference_ring(cache, padded):
    """A 40-token prefill into a 16-slot ring (slots p % 16): positions p,
    p + 16 and p + 32 share a slot, and the cache equals the reference's
    (whose scatter lets the last write win) bit for bit; with right-padded
    rows (``seq_lens``) too, and at the model's own write path."""
    B, S, W, Hkv, Dh = 3, 40, 16, 2, 16
    rng = np.random.default_rng(2)
    k = rng.standard_normal((B, S, Hkv, Dh)).astype(np.float32)
    v = rng.standard_normal((B, S, Hkv, Dh)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    seq_lens = np.array([40, 23, 9], np.int32) if padded else None
    quant = "dynamic" if cache == "int8" else "none"
    dt = {"fp32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16),
          "int8": (jnp.float32, torch.float32)}[cache]
    dims = dict(d_model=Hkv * Dh, n_heads=Hkv, n_kv_heads=Hkv, head_dim=Dh, window=W,
                quant_kv=quant)
    jc = jatt.init_cache(jatt.AttnDims(**dims), B, 64, dt[0])
    jk, jv = jnp.asarray(k).astype(dt[0]), jnp.asarray(v).astype(dt[0])
    if padded:
        (jk, jv), jpos = jatt._clamp_padded((jk, jv), jnp.asarray(pos), jnp.asarray(seq_lens))
    else:
        jpos = jnp.asarray(pos)
    jc = jatt._cache_write(jc, jk, jv, jpos, quant)

    tc = tatt.init_cache(tatt.AttnDims(**dims), B, 64, dt[1], "cpu")
    assert tc["pos"].shape == (B, W)                       # the ring: min(64, W)
    tatt._prefill_write(tc, _tensor(np.asarray(jnp.asarray(k).astype(dt[0])), "cpu"),
                        _tensor(np.asarray(jnp.asarray(v).astype(dt[0])), "cpu"),
                        torch.from_numpy(pos),
                        None if seq_lens is None else torch.from_numpy(seq_lens))
    for name in jc:
        np.testing.assert_array_equal(_bits(tc[name]), _bits(jc[name]), err_msg=name)
    # each slot holds the row's last real position that maps to it
    n = seq_lens if padded else np.full((B,), S)
    for b in range(B):
        want = [max((p for p in range(int(n[b])) if p % W == s), default=-1) for s in range(W)]
        assert tc["pos"][b].tolist() == want


def test_ring_clamp_redirects_only_overwritten_and_pad_entries():
    """``_clamp_padded(..., ring=W)`` keeps each row's last W real entries
    and sends the others (and the pads) onto the row's last real token; at
    most W real entries, nothing but the pads moves."""
    S, W = 10, 4
    pos = torch.arange(S, dtype=torch.int32)[None].repeat(2, 1)
    vals = pos.float()[..., None]
    (out,), p = tatt._clamp_padded((vals,), pos, torch.tensor([10, 3]), ring=W)
    assert p[0].tolist() == [9] * 6 + [6, 7, 8, 9]
    assert p[1].tolist() == [0, 1, 2] + [2] * 7
    assert torch.equal(out[..., 0], p.float())
    (_,), p2 = tatt._clamp_padded((vals,), pos, torch.tensor([10, 3]))
    assert p2[0].tolist() == list(range(10))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_embed_scale_rounds_the_scalar_to_the_model_dtype(dtype):
    """gemma3-12b's sqrt(3840) = 61.97 is 62.0 in bf16: the port's embedded
    rows equal JAX's ``h * jnp.asarray(d_model ** 0.5, dtype)`` bit for
    bit."""
    from repro_torch.models.transformer import embed_tokens
    tcfg = t_reduced("gemma3-12b", d_model=3840, dtype=dtype, vocab=16)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    emb = jnp.asarray(np.random.default_rng(3).standard_normal((16, 3840)) * 0.02,
                      jnp.float32).astype(jdt)
    tokens = np.array([[3, 0, 15, 7]], np.int32)
    jh = emb[jnp.asarray(tokens)] * jnp.asarray(3840 ** 0.5, jdt)
    th = embed_tokens({"embed": {"embedding": _tensor(np.asarray(emb), "cpu")}}, tcfg,
                      torch.from_numpy(tokens))
    np.testing.assert_array_equal(_bits(th), _bits(jh))
    if dtype == "bfloat16":
        assert float(torch.tensor(3840 ** 0.5, dtype=torch.bfloat16)) == 62.0
