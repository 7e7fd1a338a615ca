"""The port's MultiHostServeEngine: a real 2-process fleet over a gloo
group on the CPU, against the port's single-process ShardedServeEngine on
the same logical mesh (the reference's contract, tests/test_serve_multihost.py:
tokens identical, the coordinator's accounting per process).

  * The fleet: one spawn of two processes (``launch.mesh.init_distributed``
    on a fresh port, every process a hard timeout) runs the reference
    test's seven cases on a 4x2 mesh with 2 slots a replica - fp, PDQ int8,
    chunked prefill, paged at temperature 0.9, a tight paged pool that
    preempts, and N = 4 decode steps a dispatch, slot rows and tight paged
    (these against the one-step engine); tokens equal the single-process
    engine's, host_stats show both processes' replicas admitting and every
    pool drained, and (at N = 1) the replicas' admits and the schedule's
    stats equal.
  * One process (a group of one): the same engine class is the sharded
    engine; the worker entry point is refused on the coordinator.
  * A corrupted command header (``FaultPlan(corrupt_header_at_seq=...)``)
    kills the worker with the typed ``ProtocolError`` and the coordinator
    exits non-zero instead of hanging.
  * The launcher: ``launch/serve.py --device cpu --mesh 2x2
    --num-processes 2`` prints the streams, stats and replica lines that
    ``--mesh 2x2`` prints, the per-process lines, and with ``--trace-out``
    one merged trace holding both processes' spans; a child that dies takes
    the fleet down, the launcher naming it and every peer that dies within
    its grace.
"""
import json
import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.configs import reduced_config
from repro_torch.launch.mesh import make_serve_mesh
from repro_torch.models import build_model
from repro_torch.serve import Request, ServeConfig, build_engine

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 180           # hard cap a process (seconds)
MIXED = [3, 5, 8, 9, 12, 16, 17, 23, 30, 4, 11, 27]
KW = dict(max_len=64, buckets=(8, 16, 32))
# (name, lens, max_new, engine kwargs), as the reference test's
CASES = [
    ("fp", MIXED, 6, KW),
    ("int8", MIXED, 6, dict(KW, quantize_weights=True)),
    ("chunked", [4, 20, 40, 11], 4, dict(max_len=64, buckets=(8, 16), chunked_prefill=True)),
    ("paged", MIXED, 6, dict(KW, temperature=0.9, paged=True, page_size=16)),
    ("paged_tight", [17] * 8, 30, dict(KW, temperature=0.9, paged=True, page_size=16,
                                       pool_pages=6)),
    ("nstep", MIXED, 9, dict(KW, temperature=0.9, decode_steps=4)),
    ("nstep_tight", [17] * 8, 30, dict(KW, temperature=0.9, paged=True, page_size=16,
                                       pool_pages=6, decode_steps=4)),
]
SAME_STATS = ("prefill_batches", "chunk_batches", "prefill_requests", "chunked_requests",
              "prefill_tokens", "prefill_padded_tokens", "decode_tokens", "completed",
              "failed", "preemptions", "pages_total", "replica_admits", "replica_occupancy")

_FLEET = """
import json, sys
import numpy as np, torch
torch.set_num_threads(1)
rank, port, out, cases = int(sys.argv[1]), sys.argv[2], sys.argv[3], json.loads(sys.argv[4])
from repro_torch.configs import reduced_config
from repro_torch.distributed.fault import FaultPlan
from repro_torch.launch.mesh import init_distributed, make_serve_mesh
from repro_torch.models import build_model
from repro_torch.serve import Request, ServeConfig, build_engine
init_distributed(f"127.0.0.1:{port}", 2, rank)
cfg = reduced_config("stablelm-1.6b")
params = build_model(cfg, "cpu").init(0)
res = {}
for name, lens, max_new, kw in cases:
    if "buckets" in kw:
        kw["buckets"] = tuple(kw["buckets"])
    fault = kw.pop("fault", None)
    eng = build_engine(ServeConfig(device="cpu", multihost=True, slots_per_replica=2,
                                   mesh=make_serve_mesh(4, 2, ["cpu"] * 8, processes=2),
                                   fault=None if fault is None else FaultPlan(**fault).injector(),
                                   **kw), cfg=cfg, params=params)
    if rank == 0:
        rng = np.random.default_rng(0)
        reqs = [Request(uid=i, prompt=rng.integers(0, cfg.vocab, L).astype(np.int32),
                        max_new=max_new) for i, L in enumerate(lens)]
        eng.run(reqs)
        eng.stop_workers()
        res[name] = dict(streams=[list(map(int, r.generated)) for r in reqs],
                         done=all(r.done and r.error is None for r in reqs),
                         stats=eng.stats, host_stats=eng.host_stats())
    else:
        eng.serve_worker()
        res[name] = dict(stats=eng.stats)
with open(f"{out}.{rank}", "w") as f:
    json.dump(res, f, default=int)
torch.distributed.destroy_process_group()
print("PROC", rank, "OK")
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env():
    return dict(os.environ, PYTHONPATH="src", OMP_NUM_THREADS="1")


def _fleet(cases, out):
    """Spawn the two processes on a fresh port; every process is killed at
    TIMEOUT.  Returns their (return code, stderr)."""
    port = _free_port()
    procs = [subprocess.Popen([sys.executable, "-c", textwrap.dedent(_FLEET), str(r),
                               str(port), str(out), json.dumps(cases)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                              env=_env(), cwd=REPO) for r in (0, 1)]
    res = []
    try:
        for p in procs:
            try:
                _, err = p.communicate(timeout=TIMEOUT)
            except subprocess.TimeoutExpired:
                p.kill()
                _, err = p.communicate()
            res.append((p.returncode, err))
    finally:
        for p in procs:
            p.kill()
    return res


_PARAMS = {}


def _one_process(name, lens, max_new, kw):
    """The single-process ShardedServeEngine's run of a case (N = 1: the
    N-step cases against the one-step engine)."""
    if "params" not in _PARAMS:
        _PARAMS["cfg"] = reduced_config("stablelm-1.6b")
        _PARAMS["params"] = build_model(_PARAMS["cfg"], "cpu").init(0)
    cfg = _PARAMS["cfg"]
    kw = {k: v for k, v in kw.items() if k != "decode_steps"}
    eng = build_engine(ServeConfig(device="cpu", slots_per_replica=2,
                                   mesh=make_serve_mesh(4, 2, ["cpu"] * 8), **kw),
                       cfg=cfg, params=_PARAMS["params"])
    rng = np.random.default_rng(0)
    reqs = [Request(uid=i, prompt=rng.integers(0, cfg.vocab, L).astype(np.int32),
                    max_new=max_new) for i, L in enumerate(lens)]
    eng.run(reqs)
    return [list(r.generated) for r in reqs], eng.stats


@pytest.fixture(scope="module")
def fleet(tmp_path_factory):
    out = tmp_path_factory.mktemp("mh") / "fleet.json"
    res = _fleet(CASES, out)
    for rank, (rc, err) in enumerate(res):
        assert rc == 0, (rank, err[-3000:])
    return [json.loads(open(f"{out}.{r}").read()) for r in (0, 1)]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_fleet_matches_the_single_process_engine(fleet, case):
    name, lens, max_new, kw = case
    want, st1 = _one_process(name, lens, max_new, kw)
    got = fleet[0][name]
    assert got["done"]
    assert got["streams"] == want, [i for i, (a, b) in enumerate(zip(got["streams"], want))
                                    if a != b]
    st = got["stats"]
    # the schedule's stats; at N = 4 a tight pool grows, preempts and
    # readmits on another schedule than at N = 1 (the tokens still agree)
    for k in SAME_STATS if "decode_steps" not in kw else ():
        if k in st1:
            assert st[k] == st1[k], k
    hs = got["host_stats"]
    assert set(hs) == {"0", "1"}
    assert all(h["replicas"] == 2 and h["slots"] == 4 for h in hs.values())
    assert all(h["admits"] >= 1 and h["occupied"] == 0 for h in hs.values())
    if "decode_steps" not in kw:
        assert sum(h["admits"] for h in hs.values()) == sum(st1["replica_admits"])
    if name.endswith("tight"):
        assert st["preemptions"] > 0
    if name.startswith("nstep"):
        assert st["decode_steps"] < st1["decode_steps"]


def test_one_process_group_is_the_sharded_engine():
    """A group of one: MultiHostServeEngine serves ShardedServeEngine's
    tokens; it is the coordinator, hosts every replica, refuses the worker
    entry point, and stop_workers is a no-op."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import init_distributed
    from repro_torch.serve.multihost import MultiHostServeEngine
    want, _ = _one_process("fp", MIXED[:6], 4, KW)
    init_distributed(f"127.0.0.1:{_free_port()}", 1, 0)
    try:
        eng = build_engine(ServeConfig(device="cpu", multihost=True, slots_per_replica=2,
                                       mesh=make_serve_mesh(4, 2, ["cpu"] * 8), **KW),
                           cfg=_PARAMS["cfg"], params=_PARAMS["params"])
        assert isinstance(eng, MultiHostServeEngine)
        rng = np.random.default_rng(0)
        reqs = [Request(uid=i, prompt=rng.integers(0, 512, L).astype(np.int32), max_new=4)
                for i, L in enumerate(MIXED[:6])]
        eng.run(reqs)
        assert [list(r.generated) for r in reqs] == want
        assert eng.is_coordinator and eng.n_processes == 1
        assert eng.host_replicas == {0: [0, 1, 2, 3]}
        with pytest.raises(RuntimeError, match="coordinator"):
            eng.serve_worker()
        eng.stop_workers()
        with pytest.raises(ValueError, match="processes"):
            build_engine(ServeConfig(device="cpu", multihost=True,
                                     mesh=make_serve_mesh(2, 1, ["cpu"] * 2, processes=2)),
                         cfg=_PARAMS["cfg"], params=_PARAMS["params"])
    finally:
        dist.destroy_process_group()


def test_corrupt_header_is_a_typed_protocol_error(tmp_path):
    """Opcode 99 at command seq 4: the worker dies with the typed
    ProtocolError, and the coordinator exits non-zero (its next collective
    fails, or its 20 s deadline watchdog fires) instead of hanging."""
    res = _fleet([("corrupt", [3, 5, 8, 6, 4], 8,
                   dict(max_len=48, buckets=[8, 16], launch_timeout=20.0,
                        fault=dict(corrupt_header_at_seq=4)))], tmp_path / "c.json")
    (rc0, err0), (rc1, err1) = res
    assert rc1 not in (0, None) and "unknown multi-host serve opcode 99" in err1, err1[-2000:]
    assert rc0 not in (0, None), err0[-2000:]


LAUNCH = ["--reduced", "--device", "cpu", "--int8", "--requests", "6", "--max-new", "5",
          "--buckets", "8,16", "--max-len", "64", "--prompt-len", "12", "--mesh", "2x2",
          "--slots-per-replica", "2"]


def _launch(args, timeout=TIMEOUT):
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.serve", *LAUNCH, *args],
                          capture_output=True, text=True, env=_env(), cwd=REPO,
                          timeout=timeout)


def _launch_here(args):
    """The launcher's single-process run in this process: its standard
    output.  The same ``main`` a child runs, without a new interpreter and
    its torch import, which are most of a launch's CPU seconds (~3.5 of
    ~4): on a host loaded ~8x over its cores a launch took 67-83 s, and
    each subprocess launch here has TIMEOUT.  Its signal handlers are put
    back after it."""
    import contextlib
    import io
    import signal

    from repro_torch.launch import serve as launcher
    out = io.StringIO()
    prev = {sig: signal.getsignal(sig) for sig in (signal.SIGTERM, signal.SIGINT)}
    try:
        with contextlib.redirect_stdout(out):
            launcher.main([*LAUNCH, *args])
    finally:
        for sig, handler in prev.items():
            signal.signal(sig, handler)
    return out.getvalue()


def _lines(out, *prefixes):
    return [ln for ln in out.splitlines() if ln.strip().startswith(prefixes)]


def test_launcher_num_processes_prints_what_the_mesh_prints(tmp_path):
    """Two processes print the single-process launch's request, replica
    and stats lines (less ``remote_ingress`` and the straggler counts,
    which time the launches), one ``process`` line each, and with
    ``--trace-out`` one trace holding both processes' spans.  The
    single-process launch runs in this process (``_launch_here``)."""
    one = _launch_here([])
    trace = tmp_path / "trace.json"
    two = _launch(["--num-processes", "2", "--trace-out", str(trace)])
    assert two.returncode == 0, two.stderr[-3000:]
    assert _lines(two.stdout, "req ", "replica ") == _lines(one, "req ", "replica ")
    assert len(_lines(one, "req ")) == 3
    stats = [json.loads(ln.split("stats:", 1)[1].strip().replace("'", '"'))
             for ln in (_lines(one, "stats:")[0], _lines(two.stdout, "stats:")[0])]
    stats[1].pop("remote_ingress")
    timing = ("straggler_flags", "prefill_straggler_flags")
    assert {k: v for k, v in stats[1].items() if k not in timing} == {
        k: v for k, v in stats[0].items() if k not in timing}
    assert "x2proc" in two.stdout and "[proc 1] worker done" in two.stdout
    procs = _lines(two.stdout, "process ")
    assert len(procs) == 2 and all("occupied=0/2" in ln for ln in procs)
    # one merged trace: spans of both processes, the worker's its launches
    ev = json.loads(trace.read_text())["traceEvents"]
    spans = [e for e in ev if e["ph"] == "X"]
    assert {e["pid"] for e in spans} == {0, 1}
    assert all(e["name"].startswith("launch:") for e in spans if e["pid"] == 1)


def test_launcher_exits_non_zero_when_a_child_dies():
    """A mesh whose data axis does not divide over the processes is refused
    before any child starts; a coordinator child that dies (here: its
    --resume record does not exist) takes the fleet down, the launcher
    naming it and exiting non-zero."""
    bad = _launch(["--num-processes", "3"])
    assert bad.returncode != 0 and "must divide" in bad.stderr
    dead = _launch(["--num-processes", "2", "--resume", "/nonexistent/snapshot.npy"])
    assert dead.returncode != 0
    assert "serve launcher: process 0 died with exit code" in dead.stderr


def test_launcher_reports_the_peers_that_die_with_the_first(monkeypatch):
    """A fleet's processes fail together and the first death seen is not
    always the cause (a worker whose coordinator left its group dies
    first): the launcher collects every child that exits non-zero within
    its grace, in the order seen, and leaves a child still running (or
    one that exits 0) out of the report."""
    from repro_torch.launch import serve as launcher
    monkeypatch.setattr(launcher, "PEER_GRACE_S", 4.0)

    def child(code, after):
        return subprocess.Popen([sys.executable, "-c",
                                 f"import sys, time; time.sleep({after}); sys.exit({code})"])

    live = {0: child(7, 0.3), 1: child(0, 0.1), 2: child(3, 1.5), 3: child(0, 60)}
    try:
        assert launcher._peer_deaths(live) == [(0, 7), (2, 3)]
        assert list(live) == [3]
    finally:
        for p in live.values():
            p.kill()
            p.wait()
