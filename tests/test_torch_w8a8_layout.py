"""The W8A8 weight records' K-major layout and the host-side rules of the
two kernel routes (repro_torch/kernels/w8a8_matmul.py), on the CPU, against
the JAX package where it has a counterpart.

- ``quantize_weight``, ``group_quantize_weights`` and ``segment_record``
  store ``q`` K-major (``q.t()`` contiguous; a segment is a view of its
  group, not a copy) with JAX's values exactly;
- the route rule takes ``wgmma`` at every full-width main-path shape and
  ``generic`` for K % 16 != 0, misaligned storage or an N-major weight;
- the split-K plan covers K exactly at every shape ``chip_smoke.py``
  times, and at ragged ones;
- the plain versions give the same on K-major and row-major weights, and
  the ops layer makes any other layout K-major;
- ``params_from_numpy`` defaults to the card;
- the engine's greedy streams and stats on the K-major records equal
  JAX's (reduced stablelm-1.6b, PDQ weights, int8 KV cache; a stream may
  differ only where JAX's top-2 margin is below 1e-3, as in
  tests/test_torch_engine.py).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as j_reduced
from repro.models import build_model as j_build
from repro.models import linops as jlin
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JServeEngine
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import reduced_config as t_reduced
from repro_torch.kernels import ops as tops
from repro_torch.kernels import w8a8_matmul as mm
from repro_torch.models import linops as tlin
from repro_torch.serve import Request, ServeConfig, build_engine

torch.set_num_threads(1)

SMS = 132    # the H100's SMs
# (M, K, N, swiglu) of every K2/K3 call chip_smoke.py times: QKV, wo and
# w_down at decode, QKV at prefill, gate/up at decode and prefill
MAIN_SHAPES = [(8, 2048, 6144, False), (8, 2048, 2048, False), (8, 5632, 2048, False),
               (2048, 2048, 6144, False), (8, 2048, 11264, True),
               (2048, 2048, 11264, True)]


def _w(shape, seed, scale=0.1):
    return (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


def _k_major_equal(tq, jq):
    assert mm.is_k_major(tq) and tq.t().is_contiguous()
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))


@pytest.mark.parametrize("shape", [(96, 200), (64, 128), (48, 1)])
def test_quantize_weight_is_k_major_with_jax_values(shape):
    w = _w(shape, 0)
    t, j = tlin.quantize_weight(torch.from_numpy(w)), jlin.quantize_weight(jnp.asarray(w))
    _k_major_equal(t["q"], j["q"])
    np.testing.assert_array_equal(t["colsum"].numpy(), np.asarray(j["colsum"]))


def test_group_and_segment_records_are_k_major_with_jax_values():
    ws = [_w((64, n), i) for i, n in enumerate((64, 32, 130))]
    t = tlin.group_quantize_weights([torch.from_numpy(w) for w in ws])
    j = jlin.group_quantize_weights([jnp.asarray(w) for w in ws])
    _k_major_equal(t["q"], j["q"])
    for i in range(3):
        ts = tlin.segment_record(tlin.group_segment_view(t, i))
        js = jlin.segment_record(jlin.group_segment_view(j, i))
        _k_major_equal(ts["q"], js["q"])
        # a view of the group's (N, K) storage, rows [off, off + n)
        assert ts["q"].untyped_storage().data_ptr() == t["q"].untyped_storage().data_ptr()
        assert ts["q"].storage_offset() == t["segs"].offsets[i] * 64


def test_route_rule_takes_wgmma_at_every_main_path_shape():
    """Full-width records as the model holds them: a grouped QKV and
    gate/up, wo and w_down (storage only: the rule reads shapes, strides
    and addresses), and Q's segment of the QKV group as path E uses it."""
    for M, K, N, _ in MAIN_SHAPES:
        x_q = torch.empty((M, K), dtype=torch.int8)
        w_q = torch.empty((N, K), dtype=torch.int8).t()
        assert mm.route_for(x_q, w_q) == "wgmma", (M, K, N)
    g = {"q": torch.empty((6144, 2048), dtype=torch.int8).t(),
         "scale": torch.ones(6144), "colsum": torch.zeros((1, 6144), dtype=torch.int32),
         **{k: torch.zeros(3) for k in ("mu_w", "var_w", "alpha", "beta")},
         "segs": tlin.GroupSegs(sizes=(2048,) * 3, padded=(2048,) * 3)}
    for i in range(3):
        seg = tlin.segment_record(tlin.group_segment_view(g, i))["q"]
        assert mm.route_for(torch.empty((8, 2048), dtype=torch.int8), seg) == "wgmma"


def test_route_rule_takes_generic_where_tma_cannot_serve():
    x_q = torch.empty((5, 96), dtype=torch.int8)
    w_q = torch.empty((200, 96), dtype=torch.int8).t()
    assert mm.route_for(x_q, w_q) == "wgmma"
    # K % 16 != 0
    assert mm.route_for(torch.empty((5, 100), dtype=torch.int8),
                        torch.empty((200, 100), dtype=torch.int8).t()) == "generic"
    # x or w 1 byte off a 16-byte boundary
    x_off = torch.empty((1 + 5 * 96,), dtype=torch.int8)[1:].view(5, 96)
    w_off = torch.empty((1 + 200 * 96,), dtype=torch.int8)[1:].view(200, 96).t()
    assert x_off.data_ptr() % 16 and w_off.data_ptr() % 16
    assert mm.route_for(x_off, w_q) == "generic"
    assert mm.route_for(x_q, w_off) == "generic"
    # an N-major (row-major (K, N)) weight
    assert mm.route_for(x_q, w_q.contiguous()) == "generic"


@pytest.mark.parametrize("M,K,N,swiglu", MAIN_SHAPES + [
    (1, 48, 200, False), (17, 2064, 384, False), (64, 144, 512, True),
    (65, 2064, 200, False), (130, 48, 256, True), (8, 16, 128, False)])
def test_split_k_plan_covers_k_exactly(M, K, N, swiglu):
    p = mm.wgmma_plan(M, K, N, swiglu, SMS)
    cols = N // 2 if swiglu else N
    assert p.col_tiles == -(-cols // mm.CT)
    assert p.nks * mm.KB >= K > (p.nks - 1) * mm.KB
    # split s loads pipeline stages [s kc, (s + 1) kc), the kernel's item_range
    ranges = [(s * p.kc, min(p.nks, (s + 1) * p.kc)) for s in range(p.splits)]
    assert len(ranges) == p.splits and all(a < b for a, b in ranges)
    assert [s for a, b in ranges for s in range(a, b)] == list(range(p.nks))
    assert p.swap == (M <= mm.DECODE_ROWS)
    rows = 1 if p.swap else -(-M // mm.BM)
    assert p.items == rows * p.col_tiles * p.splits
    assert 1 <= p.grid == min(p.items, SMS)
    if not p.swap:
        assert p.splits == 1
    if (M, K, N, swiglu) in MAIN_SHAPES[:3] + MAIN_SHAPES[4:5]:
        # decode: K is split, and the items fill two thirds of the SMs or
        # more, in one wave
        assert p.splits > 1 and 2 * SMS <= 3 * p.items <= 3 * SMS


def test_plain_versions_and_ops_read_any_weight_layout():
    rng = np.random.default_rng(3)
    x_q = torch.from_numpy(rng.integers(-127, 128, (5, 96)).astype(np.int8))
    w = torch.from_numpy(rng.integers(-127, 128, (96, 512)).astype(np.int8))
    s_x, s_w = torch.full((5, 1), 0.02), torch.full((1, 512), 0.003)
    lo, hi = torch.full((5, 4), -3.0), torch.full((5, 4), 3.0)
    wk = mm.k_major(w)
    assert torch.equal(wk, w) and mm.is_k_major(wk) and not mm.is_k_major(w)
    assert torch.equal(mm.w8a8_matmul_plain(x_q, wk, s_x, None, s_w, None),
                       mm.w8a8_matmul_plain(x_q, w, s_x, None, s_w, None))
    for a, b in zip(mm.w8a8_swiglu_matmul_plain(x_q, wk, s_x, None, s_w, None, lo, hi),
                    mm.w8a8_swiglu_matmul_plain(x_q, w, s_x, None, s_w, None, lo, hi)):
        assert torch.equal(a, b)
    assert torch.equal(tops.w8a8_matmul(x_q, w, s_x, 0, s_w.reshape(-1)),
                       tops.w8a8_matmul(x_q, wk, s_x, 0, s_w.reshape(-1)))


def test_params_from_numpy_defaults_to_the_card():
    tree = {"embed": {"tok": np.zeros((4, 2), np.float32)},
            "final_norm": np.ones(2, np.float32),
            "blocks": [{"attn_norm": np.ones((3, 2), np.float32)}]}
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            params_from_numpy(tree)
    p = params_from_numpy(tree, device="cpu")
    assert len(p["blocks"]) == 3 and p["final_norm"].device.type == "cpu"


def test_engine_streams_on_k_major_records_match_jax():
    jcfg = dataclasses.replace(j_reduced("stablelm-1.6b"), quant_kv="dynamic")
    jp = j_build(jcfg).init(jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, 512, size=n).astype(np.int32) for n in (5, 31, 12, 20)]
    jparams = dict(jp, blocks=jax.vmap(jlin.quantize_param_tree)(jp["blocks"]))
    jeng = JServeEngine(jcfg, jparams, slots=2, max_len=64, telemetry=False)
    jreqs = [JRequest(uid=i, prompt=p, max_new=6) for i, p in enumerate(prompts)]
    jeng.run(jreqs)
    teng = build_engine(ServeConfig(slots=2, max_len=64, device="cpu",
                                    quantize_weights=True, int8_kv=True),
                        cfg=t_reduced("stablelm-1.6b"), params=tp)
    for layer in teng.params["blocks"]:
        for rec in (layer["attn"]["wq"]["group"], layer["attn"]["wo"],
                    layer["ffn"]["w_gate"]["group"], layer["ffn"]["w_down"]):
            assert mm.is_k_major(rec["q"])
    treqs = [Request(uid=i, prompt=p, max_new=6) for i, p in enumerate(prompts)]
    teng.run(treqs)
    for jr, tr in zip(jreqs, treqs):
        assert tr.done and tr.error is None and len(tr.generated) == 6
        if tr.generated != jr.generated:
            i = next(k for k, (a, b) in enumerate(zip(tr.generated, jr.generated))
                     if a != b)
            seq = np.concatenate([jr.prompt, np.asarray(jr.generated[:i], np.int32)])[None]
            b = j_build(jcfg)
            logits, _ = b.prefill(jparams, {"tokens": jnp.asarray(seq)},
                                  b.init_caches(1, seq.shape[1] + 1))
            top2 = np.sort(np.asarray(logits[0]))[-2:]
            assert top2[1] - top2[0] < 1e-3, (tr.uid, i, tr.generated, jr.generated)
    skip = {"prefill_compiles", "chunk_compiles", "decode_compiles", "straggler_flags",
            "prefill_straggler_flags"}
    assert ({k: v for k, v in teng.stats.items() if k not in skip}
            == {k: v for k, v in jeng.stats.items() if k not in skip})
