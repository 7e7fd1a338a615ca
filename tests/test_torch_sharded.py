"""The port's ShardedServeEngine against repro.serve.ShardedServeEngine, the
cases of tests/test_serve_sharded.py, on the same weights (the reduced
configs' ``PRNGKey(0)`` init, bridged) and the same ('data', 'model') mesh
shapes: the port's entries are CPU devices, the reference's forced host
devices.  The reference runs once, in one subprocess
(``XLA_FLAGS=--xla_force_host_platform_device_count=8``), with
``telemetry=False`` and its PDQ params' stacked blocks already quantized
(ROADMAP.md Queue 3's two caveats); the port with telemetry off too where
stats are compared.

Greedy streams, and every stat that the reference also keeps (all but its
compile counters and the wall-clock straggler flags), equal the
reference's: the mixed trace on a 4x2 mesh with 2 slots a replica; PDQ
weights and chunked prefill on 2x2; N = 4 decode steps a dispatch on 4x2
(the reference's run at N = 4 too); mamba2 and deepseek-v2 on 2x2.  Each
replica's projections run through its row's per-shard blocks
(``linops.tp_place``): views of the home's whole weights where the
entries repeat the CPU, and - the mixed trace and the PDQ case again -
copies of their own with the home keeping no whole split weight, as a row
over distinct cards places them.
Temperature streams (the port samples by its own hash, not JAX's threefry)
are compared with the port's single-device engine: the paged pool on 4x2
at temperature 0.9, with a pool tight enough to preempt (its stats against
the reference's paged mesh run, whose schedule does not depend on the
tokens), and N = 4 at temperature, fp and int8 KV, paged.  The streaming
service over a mesh engine: a cancel and a deadline evict their own
request alone, every other stream equal to the reference's batch run.
"""
import json
import os
import subprocess
import sys
import textwrap
import time

import jax
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as j_reduced
from repro.models import build_model as j_build
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import reduced_config as t_reduced
from repro_torch.launch.mesh import make_serve_mesh
from repro_torch.serve import Request, ServeConfig, ServeService, build_engine

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SKIP_STATS = {"prefill_compiles", "chunk_compiles", "decode_compiles", "straggler_flags",
              "prefill_straggler_flags"}
MIXED = [3, 5, 8, 9, 12, 16, 17, 23, 30, 4, 11, 27]
KW = dict(max_len=64, buckets=(8, 16, 32))
SVC_LENS, SVC_NEW = [3, 9, 12, 5, 17, 7], 16
GROW = dict(max_len=64, buckets=(8, 16, 32), temperature=0.9, paged=True, page_size=16,
            pool_pages=6)

# (name, arch, mesh, spr, lens, max_new, engine kwargs); the reference runs
# every case with telemetry off (and quantized blocks where "quantize")
CASES = [
    ("mixed", "stablelm-1.6b", (4, 2), 2, MIXED, 6, KW),
    ("int8", "stablelm-1.6b", (2, 2), 2, [3, 9, 14, 6, 12, 30], 4,
     dict(KW, quantize_weights=True)),
    ("chunked", "stablelm-1.6b", (2, 2), 2, [4, 20, 40, 11], 4,
     dict(max_len=64, buckets=(8, 16), chunked_prefill=True)),
    ("nstep", "stablelm-1.6b", (4, 2), 2, MIXED, 9, dict(KW, decode_steps=4)),
    ("mamba2", "mamba2-2.7b", (2, 2), 2, [3, 7, 11, 16, 5, 9], 4,
     dict(max_len=48, buckets=(8, 16))),
    ("deepseek", "deepseek-v2-236b", (2, 2), 2, [3, 7, 11, 16, 5, 9], 4,
     dict(max_len=48, buckets=(8, 16))),
    ("grow", "stablelm-1.6b", (4, 2), 2, [17] * 8, 30, GROW),
    ("svc", "stablelm-1.6b", (4, 2), 1, SVC_LENS, SVC_NEW, KW),
]

_REF = """
import json, sys
import jax, numpy as np
from repro.configs import reduced_config
from repro.models import build_model
from repro.models.linops import quantize_param_tree
from repro.serve import Request, ShardedServeEngine

CASES = json.loads(sys.argv[1])
out = {}
for name, arch, (D, T), spr, lens, max_new, kw in CASES:
    cfg = reduced_config(arch)
    params = build_model(cfg).init(jax.random.PRNGKey(0))
    if kw.pop("quantize_weights", False):
        params = dict(params, blocks=jax.vmap(quantize_param_tree)(params["blocks"]))
    if "buckets" in kw:
        kw["buckets"] = tuple(kw["buckets"])
    eng = ShardedServeEngine(cfg, params, mesh=jax.make_mesh((D, T), ("data", "model")),
                             slots_per_replica=spr, telemetry=False, **kw)
    rng = np.random.default_rng(0)
    reqs = [Request(uid=i, prompt=rng.integers(0, cfg.vocab, L).astype(np.int32),
                    max_new=max_new) for i, L in enumerate(lens)]
    eng.run(reqs)
    assert all(r.done for r in reqs)
    out[name] = dict(streams=[list(map(int, r.generated)) for r in reqs],
                     stats={k: v for k, v in eng.stats.items()})
with open(sys.argv[2], "w") as f:
    json.dump(out, f, default=int)
print("REF OK")
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """Every case's reference run (one subprocess, 8 forced host devices);
    the temperature cases' streams are not compared with it."""
    path = tmp_path_factory.mktemp("sharded") / "ref.json"
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH="src", JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", textwrap.dedent(_REF), json.dumps(CASES),
                          str(path)], capture_output=True, text=True, env=env, cwd=REPO,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(path.read_text())


_PARAMS: dict = {}


def _params(arch):
    """The reference's PRNGKey(0) weights, bridged to the port (once)."""
    if arch not in _PARAMS:
        jp = j_build(j_reduced(arch)).init(jax.random.PRNGKey(0))
        _PARAMS[arch] = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return _PARAMS[arch]


def _requests(cfg, lens, max_new):
    rng = np.random.default_rng(0)
    return [Request(uid=i, prompt=rng.integers(0, cfg.vocab, L).astype(np.int32),
                    max_new=max_new) for i, L in enumerate(lens)]


def _case(name):
    return next(c for c in CASES if c[0] == name)


def _engine(arch, mesh=None, spr=2, **kw):
    cfg = t_reduced(arch)
    if mesh is not None:
        kw.update(mesh=make_serve_mesh(*mesh, ["cpu"] * (mesh[0] * mesh[1])),
                  slots_per_replica=spr)
    return build_engine(ServeConfig(device="cpu", **kw), cfg=cfg, params=_params(arch))


def _serve(eng, lens, max_new):
    reqs = _requests(eng.cfg, lens, max_new)
    eng.run(reqs)
    assert all(r.done and r.error is None for r in reqs)
    return [list(r.generated) for r in reqs]


def _stats(st):
    return {k: v for k, v in st.items() if k not in SKIP_STATS}


@pytest.mark.parametrize("name", ["mixed", "int8", "chunked", "nstep", "mamba2", "deepseek"])
def test_sharded_engine_matches_the_reference(ref, name):
    _, arch, mesh, spr, lens, max_new, kw = _case(name)
    eng = _engine(arch, mesh, spr, telemetry=False, **kw)
    got = _serve(eng, lens, max_new)
    want = ref[name]
    assert got == want["streams"], [i for i, (a, b) in enumerate(zip(got, want["streams"]))
                                    if a != b]
    assert _stats(eng.stats) == _stats(want["stats"])
    assert min(eng.stats["replica_admits"]) >= 1
    assert eng.stats["replica_occupancy"] == [0] * mesh[0]
    if name == "chunked":
        assert eng.stats["chunked_requests"] == 2
    if name == "nstep":
        # full blocks: two admission waves of lockstep rows, 8 decode
        # tokens each -> 2 dispatches a wave
        assert eng.stats["decode_tokens"] == len(lens) * 8
        assert eng.stats["decode_steps"] == 4


@pytest.mark.parametrize("name", ["mixed", "int8"])
def test_rows_placed_as_over_distinct_cards_match_the_reference(ref, name, monkeypatch):
    """The placement of rows over distinct cards (``tp_place(copies=True)``:
    each shard's block a copy of its own, the home holding meta tensors in
    place of every split weight) serves the reference's streams and stats:
    nothing reads a split weight whole, and each row's split weights sum to
    one copy of the whole ones."""
    import functools

    from repro_torch.models import linops
    from repro_torch.serve import sharded
    monkeypatch.setattr(sharded, "tp_place", functools.partial(linops.tp_place, copies=True))
    _, arch, mesh, spr, lens, max_len, kw = _case(name)
    eng = _engine(arch, mesh, spr, telemetry=False, **kw)
    got = _serve(eng, lens, max_len)
    assert got == ref[name]["streams"]
    assert _stats(eng.stats) == _stats(ref[name]["stats"])
    rep = eng.replicas[0]
    leaves = [leaf["q"] if isinstance(leaf, dict) else leaf
              for leaf, _ in rep.row.blocks.values()]
    assert id(rep.params["blocks"][0]["attn"]["wo"]) in rep.row.blocks
    assert leaves and all(t.device.type == "meta" for t in leaves)
    whole = sum(b["q"].nbytes + b["scale"].nbytes + b["colsum"].nbytes
                if isinstance(b, dict) else b.nbytes
                for _, blocks in rep.row.blocks.values() for b in blocks)
    assert rep.row.weight_bytes() == {"cpu": whole} and whole > 0


def test_paged_mesh_at_temperature_preempts_and_matches_one_device(ref):
    """Temperature streams on a paged 4x2 mesh equal the port's
    single-device slot-row engine; with a pool of 6 pages a replica
    (5 usable, 2-page prompts growing to 3) decode growth preempts and
    requeues, streams still equal, and the schedule's stats equal the
    reference's paged mesh run."""
    lens = MIXED
    one = _serve(_engine("stablelm-1.6b", slots=8, temperature=0.9, **KW), lens, 6)
    got = _serve(_engine("stablelm-1.6b", (4, 2), 2, temperature=0.9, paged=True,
                         page_size=16, **KW), lens, 6)
    assert got == one
    _, arch, mesh, spr, lens, max_new, kw = _case("grow")
    eng = _engine(arch, mesh, spr, telemetry=False, **kw)
    grow = _serve(eng, lens, max_new)
    kw1 = {k: v for k, v in kw.items() if k not in ("paged", "page_size", "pool_pages")}
    assert grow == _serve(_engine(arch, slots=8, **kw1), lens, max_new)
    assert eng.stats["preemptions"] > 0
    assert _stats(eng.stats) == _stats(ref["grow"]["stats"])


@pytest.mark.parametrize("int8_kv,paged", [(False, False), (False, True), (True, True)])
def test_nstep_at_temperature_matches_one_step(int8_kv, paged):
    """N = 4 decode steps a dispatch on a 4x2 mesh at temperature 0.9 equal
    the single-device N = 1 engine, token for token."""
    kw = dict(KW, temperature=0.9, int8_kv=int8_kv)
    want = _serve(_engine("stablelm-1.6b", slots=4, **kw), MIXED, 9)
    eng = _engine("stablelm-1.6b", (4, 2), 2, decode_steps=4,
                  **dict(kw, **(dict(paged=True, page_size=16) if paged else {})))
    assert _serve(eng, MIXED, 9) == want
    assert eng.stats["decode_steps"] == 4


def test_service_cancel_and_deadline_evict_alone_over_a_mesh(ref):
    """ServeService over a 4x2 mesh engine (1 slot a replica): a mid-flight
    cancel and a deadline on the round clock each evict their own request;
    the other streams equal the reference's batch run, and every replica's
    slot comes back."""
    want = ref["svc"]["streams"]
    eng = _engine("stablelm-1.6b", (4, 2), 1, **KW)
    eng._clock = lambda: float(eng._round)          # deadlines in rounds
    svc = ServeService(eng, max_pending=16).start()
    prompts = [r.prompt for r in _requests(eng.cfg, SVC_LENS, SVC_NEW)]
    streams = [svc.submit(p, max_new=SVC_NEW, deadline_s=(4.0 if i == 2 else None))
               for i, p in enumerate(prompts)]
    got1 = []
    while len(got1) < 2:                            # uid 1: cancel mid-flight
        got1.extend(streams[1].drain()[0])
        time.sleep(0.005)
    svc.cancel(1, reason="client gone")
    res = {s.uid: s.result(timeout=300) for s in streams}
    svc.stop()
    toks, fin, err = res[1]
    assert fin == "cancel" and err == "client gone"
    all1 = list(got1) + list(toks)
    assert all1 == want[1][:len(all1)] and len(all1) < SVC_NEW
    toks2, fin2, _ = res[2]
    assert fin2 == "deadline" and len(toks2) < SVC_NEW
    assert list(toks2) == want[2][:len(toks2)]
    for uid in (0, 3, 4, 5):
        toks, fin, _ = res[uid]
        assert fin == "complete" and list(toks) == want[uid], uid
    assert eng.stats["cancelled"] == 1 and eng.stats["deadline_expired"] == 1
    assert eng.stats["replica_occupancy"] == [0] * 4
    assert eng._free_total() == eng.slots


def test_spill_and_the_per_request_baseline_are_refused():
    """The reference's refusals: host spill is single-device only, and a
    mesh engine has no per-request prefill (batch_prefill is forced)."""
    mesh = make_serve_mesh(2, 1, ["cpu"] * 2)
    from repro_torch.serve.sharded import ShardedServeEngine
    cfg = t_reduced("stablelm-1.6b")
    with pytest.raises(ValueError, match="single-device only"):
        ShardedServeEngine(cfg, _params("stablelm-1.6b"), mesh=mesh, spill=True,
                           paged=True)
    eng = ShardedServeEngine(cfg, _params("stablelm-1.6b"), mesh=mesh, slots_per_replica=1,
                             max_len=32)
    assert eng.batch_prefill and eng._submit_one is None
