"""The port's ServeEngine against repro.serve.ServeEngine on one request
trace: 6 requests, prompts of 3-40 tokens, max_new 8, 2 or 4 slots (so
admissions queue), reduced stablelm-1.6b on the same bridged weights.

fp weights on both sides; and PDQ: the port with quantize_weights=True
(every layer quantized) against the JAX engine serving the
vmap(quantize_param_tree) params with telemetry off (with it on, the
reference leaks a tracer out of its scan; ROADMAP.md Queue 3), and the port
with telemetry off too, so that the PDQ health stats compare like with like
(tests/test_torch_pdq_guard.py holds them on against JAX).  Each with
an fp KV cache and with the int8 one (``int8_kv=True``; the JAX side's
config gets ``quant_kv='dynamic'``).

Greedy streams are identical (at a difference, JAX's top-2 margin for that
token must be below the logits tolerance of tests/test_torch_model.py),
and the scheduler's stats are equal, apart from the JAX-only compile
counters and the wall-clock straggler flags.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as j_reduced
from repro.models import build_model as j_build
from repro.models.linops import quantize_param_tree as j_quantize
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JServeEngine
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import reduced_config as t_reduced
from repro_torch.kernels import ops as tops
from repro_torch.serve import Request, ServeConfig, build_engine

torch.set_num_threads(1)

TOL = {"fp": 1e-5, "pdq": 1e-3}
SKIP_STATS = {"prefill_compiles", "chunk_compiles", "decode_compiles",
              "straggler_flags", "prefill_straggler_flags"}
LENS = (3, 40, 17, 9, 33, 25)


@pytest.fixture(scope="module")
def weights():
    jcfg = j_reduced("stablelm-1.6b")
    jp = j_build(jcfg).init(jax.random.PRNGKey(0))
    return jcfg, jp, params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")


def _prompts():
    rng = np.random.default_rng(0)
    return [rng.integers(0, 512, size=n).astype(np.int32) for n in LENS]


def _margin_ok(jcfg, jparams, prompt, generated, i, tol):
    """JAX's top-2 logit margin for token i of a stream is below tol."""
    seq = np.concatenate([prompt, np.asarray(generated[:i], np.int32)])[None]
    b = j_build(jcfg)
    logits, _ = b.prefill(jparams, {"tokens": jnp.asarray(seq)},
                          b.init_caches(1, seq.shape[1] + 1))
    top2 = np.sort(np.asarray(logits[0]))[-2:]
    return top2[1] - top2[0] < tol


@pytest.mark.parametrize("int8_kv", [False, True])
@pytest.mark.parametrize("slots", [2, 4])
@pytest.mark.parametrize("kind", ["fp", "pdq"])
def test_engine_matches_jax_engine(weights, kind, slots, int8_kv):
    jcfg, jp, tp = weights
    if int8_kv:
        jcfg = dataclasses.replace(jcfg, quant_kv="dynamic")
    jparams = jp if kind == "fp" else dict(jp, blocks=jax.vmap(j_quantize)(jp["blocks"]))
    jeng = JServeEngine(jcfg, jparams, slots=slots, max_len=64, telemetry=False)
    jreqs = [JRequest(uid=i, prompt=p, max_new=8) for i, p in enumerate(_prompts())]
    jeng.run(jreqs)

    teng = build_engine(ServeConfig(slots=slots, max_len=64, device="cpu",
                                    quantize_weights=kind == "pdq", int8_kv=int8_kv,
                                    telemetry=False),
                        cfg=t_reduced("stablelm-1.6b"), params=tp)
    treqs = [Request(uid=i, prompt=p, max_new=8) for i, p in enumerate(_prompts())]
    tops.reset_counts()
    teng.run(treqs)

    for jr, tr in zip(jreqs, treqs):
        assert tr.done and tr.error is None and len(tr.generated) == 8
        if tr.generated != jr.generated:
            i = next(k for k, (a, b) in enumerate(zip(tr.generated, jr.generated))
                     if a != b)
            assert _margin_ok(jcfg, jparams, jr.prompt, jr.generated, i, TOL[kind]), (
                tr.uid, i, tr.generated, jr.generated)
    tstats = {k: v for k, v in teng.stats.items() if k not in SKIP_STATS}
    jstats = {k: v for k, v in jeng.stats.items() if k not in SKIP_STATS}
    assert tstats == jstats
    # every admission round lands all its cache leaves in one scatter:
    # k, v, pos, len, and with int8 KV k_scale and v_scale
    c = {k: v["entries"] for k, v in tops.counts().items()}
    n_pre, n_dec = teng.stats["prefill_batches"], teng.stats["decode_steps"]
    assert c["cache_scatter"] == n_pre
    n = teng.cfg.n_layers
    attend = "decode_attend_i8kv_fused" if kind == "pdq" else "decode_attend_i8kv"
    assert c[attend] == (n * n_dec if int8_kv else 0)
    if kind == "pdq":
        assert c["w8a8_swiglu_matmul"] == n * (n_pre + n_dec)
        # decode runs wo's prologue inside the fused attend with int8 KV
        assert c["pdq_prologue"] == n * (3 * n_pre + (2 if int8_kv else 3) * n_dec)


def test_build_engine_needs_cuda_by_default():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_engine(ServeConfig())


@pytest.mark.parametrize("field,value", [
    ("mesh", object()), ("slots_per_replica", 2), ("launch_timeout", 30.0)])
def test_unported_options_name_their_roadmap_item(weights, field, value):
    """The multi-GPU options, which named item 8 until it was ported, now
    reach their engines: a mesh builds a ``ShardedServeEngine``;
    ``slots_per_replica`` sizes its replicas; ``launch_timeout`` (with
    ``multihost``) reaches ``MultiHostServeEngine``, which without a process
    group raises a clear error."""
    from repro_torch.launch.mesh import make_serve_mesh
    from repro_torch.serve.sharded import ShardedServeEngine
    mesh = make_serve_mesh(2, 2, ["cpu"] * 4)
    kw = {"mesh": dict(mesh=mesh), "slots_per_replica": dict(mesh=mesh, slots_per_replica=value),
          "launch_timeout": dict(mesh=mesh, multihost=True, launch_timeout=value)}[field]
    cfg = ServeConfig(device="cpu", slots=2, max_len=32, **kw)
    if field == "launch_timeout":
        with pytest.raises(RuntimeError, match="init_distributed"):
            build_engine(cfg, cfg=t_reduced("stablelm-1.6b"), params=weights[2])
        return
    eng = build_engine(cfg, cfg=t_reduced("stablelm-1.6b"), params=weights[2])
    assert isinstance(eng, ShardedServeEngine)
    assert (eng.n_replicas, eng.slots_per_replica, eng.slots) == (2, 2, 4)
    assert [(r.device, r.shards) for r in eng.replicas] == [(torch.device("cpu"), 2)] * 2


def test_chunked_prefill_builds_and_serves_on_the_cpu(weights):
    """``chunked_prefill=True`` builds (it raised ``not_ported`` before it
    was ported) and serves: prompts past the largest bucket are split into
    chunks of that bucket, and every request completes."""
    eng = build_engine(ServeConfig(device="cpu", slots=2, max_len=64, buckets=(8, 16),
                                   chunked_prefill=True, quantize_weights=True),
                       cfg=t_reduced("stablelm-1.6b"), params=weights[2])
    assert eng.buckets == (8, 16)
    reqs = [Request(uid=i, prompt=p, max_new=4) for i, p in enumerate(_prompts())]
    eng.run(reqs)
    assert all(r.done and r.error is None and len(r.generated) == 4 for r in reqs)
    assert eng.stats["chunked_requests"] == sum(n > 16 for n in LENS)
    assert eng.stats["chunk_batches"] >= 2


@pytest.mark.parametrize("fields,match", [
    (dict(paged=True, batch_prefill=False), "needs batch_prefill"),
    (dict(spill=True, mesh=object()), "single-device"),
    (dict(multihost=True), "multihost=True needs a mesh")])
def test_inconsistent_configs_raise_value_error(weights, fields, match):
    """ServeConfig.validate: the reference's checks, before any engine is
    built."""
    cfg = ServeConfig(device="cpu", slots=2, max_len=32, **fields)
    with pytest.raises(ValueError, match=match):
        build_engine(cfg, cfg=t_reduced("stablelm-1.6b"), params=weights[2])


def test_multihost_with_a_mesh_names_item_8(weights):
    """``multihost=True`` beside a mesh builds the multi-process engine
    (item 8's serving half, which this test's name predates): without a
    process group it raises a clear error, and a mesh whose devices are not
    the config's device type raises before any engine is built."""
    from repro_torch.launch.mesh import Mesh
    cpu_mesh = Mesh(np.full((2, 1), torch.device("cpu"), dtype=object), np.zeros((2, 1), int))
    cfg = ServeConfig(device="cpu", slots=2, max_len=32, multihost=True, mesh=cpu_mesh)
    with pytest.raises(RuntimeError, match="torch.distributed group"):
        build_engine(cfg, cfg=t_reduced("stablelm-1.6b"), params=weights[2])
    cuda_mesh = Mesh(np.full((2, 1), torch.device("cuda", 0), dtype=object),
                     np.zeros((2, 1), int))
    with pytest.raises(ValueError, match="device is 'cpu'"):
        build_engine(ServeConfig(device="cpu", slots=2, max_len=32, mesh=cuda_mesh),
                     cfg=t_reduced("stablelm-1.6b"), params=weights[2])


def test_other_model_families_name_item_6():
    """Item 6 is done: the port's registry holds every reference config
    (seamless and phi-3-vision included), each family builds and prefills
    on the CPU at its reduced size, and no refusal names item 6 any more
    (an encoder-decoder or a frontend config builds like any other)."""
    from repro.configs import ALL_ARCHS as J_ALL
    from repro_torch.configs import ALL_ARCHS, get_config
    from repro_torch.models import build_model
    assert sorted(ALL_ARCHS) == sorted(J_ALL)
    for arch in ALL_ARCHS:
        assert get_config(arch).name == arch
        cfg = t_reduced(arch)
        b = build_model(cfg, "cpu")
        params = b.init(0)
        mem = 8 if cfg.family == "encdec" else 0
        batch = {"tokens": torch.zeros((1, 4), dtype=torch.int32)}
        if cfg.family == "encdec":
            batch["frames"] = torch.zeros((1, mem, cfg.d_model))
        if cfg.frontend == "vision":
            batch["patches"] = torch.zeros((1, cfg.frontend_tokens, cfg.d_model))
        logits, _ = b.prefill(params, batch, b.init_caches(1, 32, mem))
        assert logits.shape == (1, cfg.vocab) and bool(torch.isfinite(logits).all()), arch
    for fields in (dict(family="encdec", enc_layers=1), dict(frontend="vision")):
        cfg = dataclasses.replace(t_reduced("stablelm-1.6b"), **fields)
        build_model(cfg, "cpu").init(0)


def test_temperature_streams_depend_only_on_seed_uid_step(weights):
    """Temperature sampling draws per (seed, uid, step): a request's stream
    is the same whether it runs alone or beside others."""
    tp = weights[2]
    prompts = _prompts()

    def run(uids, slots):
        eng = build_engine(ServeConfig(slots=slots, max_len=64, device="cpu",
                                       temperature=0.8, seed=3),
                           cfg=t_reduced("stablelm-1.6b"), params=tp)
        reqs = [Request(uid=u, prompt=prompts[u], max_new=6) for u in uids]
        eng.run(reqs)
        return {r.uid: r.generated for r in reqs}

    together = run(range(4), 4)
    alone = run([2], 1)
    assert together[2] == alone[2]
    assert len({tuple(v) for v in together.values()}) > 1
