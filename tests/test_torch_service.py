"""The port's fault handling, streaming service, HTTP front door and
telemetry plane (``repro_torch.distributed.fault``, ``repro_torch.serve.
service`` / ``frontend`` / ``telemetry`` and ``repro_torch.launch.serve``):
the single-device cases of the reference's tests/test_serve_service.py,
tests/test_serve_faults.py and tests/test_telemetry.py, run against the
port's engine on the CPU (reduced stablelm-1.6b, seeded random weights).

Each case pins the reference's own contract within the port: streamed ==
batch tokens, deterministic overload shedding, cancel/deadline isolation,
typed HTTP statuses and SSE, SIGTERM drain -> snapshot -> --resume through
the port's launcher, request isolation under injected NaN logits and
raising launches, the straggler EMAs, snapshot/resume token parity, the
Prometheus exposition, histograms and the Chrome-trace export.  Tokens
are compared within the port (its temperature sampler is its own; greedy
streams against JAX are tests/test_torch_engine.py's).

Not here: the chunked-prefill cases (``test_cancel_mid_chunked_prefill_
reclaims_slot_same_round``, ``test_chunked_launches_feed_the_prefill_
straggler``) wait for chunked prefill (ROADMAP.md Queue 1, item 6); the
multi-process fleet and heartbeat cases wait for multi-GPU serving (item
8).  The PDQ collector's cases are tests/test_torch_pdq_guard.py's.
"""
import asyncio
import contextlib
import dataclasses
import http.client
import json
import os
import re
import signal
import socket
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings, strategies as st
except ImportError:
    from _hypo_compat import given, settings, strategies as st

from repro_torch.configs import reduced_config
from repro_torch.distributed.fault import (DeadlineWatchdog, FaultInjector, FaultPlan,
                                           StragglerWatchdog, load_snapshot,
                                           save_snapshot)
from repro_torch.models import build_model
from repro_torch.serve import (EngineDraining, HttpFrontend, OverloadedError,
                               Request, ServeConfig, ServeEngine, ServeService,
                               build_engine, resume_requests)
from repro_torch.serve.telemetry import (LATENCY_BUCKETS, Histogram,
                                         MetricsRegistry, Telemetry, Tracer)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def small_model():
    cfg = reduced_config("stablelm-1.6b")
    m = build_model(cfg, "cpu")
    params = m.init(0)
    return cfg, m, params


def _engine(cfg, params, **kw):
    kw.setdefault("slots", 4)
    kw.setdefault("max_len", 64)
    kw.setdefault("buckets", (8, 16, 32))
    kw.setdefault("device", "cpu")
    return build_engine(ServeConfig(**kw), cfg=cfg, params=params)


def _launch_env():
    return dict(os.environ, PYTHONPATH="src", OMP_NUM_THREADS="1")


# ---------------------------------------------------------------------------
# service: continuous admission, overload, cancel, deadlines, HTTP
# ---------------------------------------------------------------------------


def _prompts(cfg, lens, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab, L).astype(np.int32) for L in lens]


def _batch_ref(cfg, params, reqs, **kw):
    """Run copies of ``reqs`` through a fresh engine's batch path; return
    {uid: tokens}.  Sampling keys are (uid, step)-derived, so this is THE
    reference the streamed tokens must equal bit-for-bit."""
    eng = _engine(cfg, params, **kw)
    copies = [Request(uid=r.uid, prompt=np.asarray(r.prompt),
                      max_new=r.max_new) for r in reqs]
    eng.run(copies)
    assert all(r.done and r.error is None for r in copies)
    return {r.uid: tuple(r.generated) for r in copies}


def _wait(pred, timeout=300.0, every=0.01):
    deadline = time.monotonic() + timeout
    while not pred():
        if time.monotonic() > deadline:
            raise TimeoutError("condition not reached")
        time.sleep(every)


class _SlowDecode(FaultInjector):
    """Really sleep before each decode launch (FaultPlan.delay_rounds is
    VIRTUAL - watchdog-only) so a cancel racing a fast tiny-model decode
    reliably lands while the request is still in flight."""

    def __init__(self, seconds: float = 0.03):
        self.seconds = seconds

    def on_exec(self, kind: str, rnd: int) -> None:
        if kind == "decode":
            time.sleep(self.seconds)


def test_streamed_tokens_match_batch_run(small_model):
    """Requests submitted continuously (staggered, mid-flight) through the
    service produce the same tokens as one batch run() - and the streams
    deliver them incrementally, first token before the request finishes."""
    cfg, m, params = small_model
    lens = [3, 9, 12, 5, 17, 7]
    prompts = _prompts(cfg, lens)
    reqs = [Request(uid=i, prompt=p, max_new=6) for i, p in
            enumerate(prompts)]
    want = _batch_ref(cfg, params, reqs)

    eng = _engine(cfg, params)
    svc = ServeService(eng, max_pending=16).start()
    streams = []
    for i, p in enumerate(prompts):
        streams.append(svc.submit(p, max_new=6))
        if i == 2:      # stagger: later submits land mid-decode
            _wait(lambda: eng.stats["decode_steps"] > 0)
    got = {s.uid: s.result(timeout=300) for s in streams}
    assert {u: tuple(t) for u, (t, _, _) in got.items()} == want
    assert all(fin == "complete" and err is None
               for _, fin, err in got.values())
    st = svc.stats()
    assert st["completed"] == len(lens) and st["shed"] == 0
    assert st["pending"] == 0 and st["free_slots"] == st["slots"]
    svc.stop()
    assert not svc._streams           # stream table drained, nothing leaked


def _soak(cfg, params, rounds=60, per_round=6):
    """Deterministic 3x-capacity open-loop soak via burst injection:
    ``per_round`` submits hit a 2-slot engine with a 4-deep admission
    queue at the top of every scheduler round."""
    burst = {r: [[3 + (r + i) % 6, 4] for i in range(per_round)]
             for r in range(rounds)}
    plan = FaultPlan(burst_rounds=dict(burst))
    eng = _engine(cfg, params, slots=2, buckets=(8,),
                  fault=plan.injector())
    svc = ServeService(eng, max_pending=4).start()
    # every offered request terminal (monotonic counters: no transient
    # window mid queue-to-slot handoff, unlike polling pending/active)
    _wait(lambda: eng.stats["shed"] + eng.stats["completed"]
          == rounds * per_round, timeout=600)
    svc.stop()
    accepted = list(eng.finished)
    stats = dict(eng.stats)
    return eng, accepted, stats


def test_overload_soak_sheds_deterministically_no_leak(small_model):
    cfg, m, params = small_model
    eng, accepted, stats = _soak(cfg, params)
    # sustained 3x overload: the bounded queue shed most of the offered
    # load, every shed is counted, and what WAS accepted all completed
    assert eng._round >= 50
    assert stats["shed"] > 0
    assert stats["completed"] == len(accepted) > 0
    assert stats["shed"] + stats["completed"] == 60 * 6
    assert all(r.done and r.finish_reason == "complete" for r in accepted)
    # no slot/queue leak after the storm
    assert eng._free_total() == eng.slots
    assert not eng.pending and all(r is None for r in eng.active)
    # accepted streams are token-for-token the batch-run tokens
    want = _batch_ref(cfg, params, accepted, slots=2, buckets=(8,))
    assert {r.uid: tuple(r.generated) for r in accepted} == want
    # the soak is deterministic: same plan, same rounds -> same shed
    # pattern and same accepted set, replayed end to end
    eng2, accepted2, stats2 = _soak(cfg, params)
    assert stats2["shed"] == stats["shed"]
    assert stats2["completed"] == stats["completed"]
    assert ([(r.uid, tuple(r.generated)) for r in accepted2]
            == [(r.uid, tuple(r.generated)) for r in accepted])


def test_overloaded_error_is_typed_and_counted(small_model):
    cfg, m, params = small_model
    eng = _engine(cfg, params, slots=2, buckets=(8,))
    svc = ServeService(eng, max_pending=2, retry_after=1.5)
    # not started: submits queue in ingress, so the watermark is exact
    p = _prompts(cfg, [4])[0]
    svc.submit(p, max_new=4)
    svc.submit(p, max_new=4)
    with pytest.raises(OverloadedError) as ei:
        svc.submit(p, max_new=4)
    assert ei.value.retry_after == 1.5
    assert eng.stats["shed"] == 1
    svc.start()
    svc.stop()


def test_cancel_midflight_evicts_only_own_request(small_model):
    cfg, m, params = small_model
    prompts = _prompts(cfg, [5, 9, 12, 7])
    reqs = [Request(uid=i, prompt=p, max_new=12) for i, p in
            enumerate(prompts)]
    want = _batch_ref(cfg, params, reqs)

    eng = _engine(cfg, params, fault=_SlowDecode())
    svc = ServeService(eng, max_pending=16).start()
    streams = [svc.submit(p, max_new=12) for p in prompts]
    victim = streams[1]
    got_early: list[int] = []

    def two_tokens_flowed():
        got_early.extend(victim.drain()[0])
        return len(got_early) >= 2

    _wait(two_tokens_flowed)
    svc.cancel(victim.uid, reason="user hit stop")
    results = {s.uid: s.result(timeout=300) for s in streams}
    svc.stop()

    toks, fin, err = results[victim.uid]
    assert fin == "cancel" and err == "user hit stop"
    early_and_late = tuple(got_early) + tuple(toks)
    assert early_and_late == want[victim.uid][:len(early_and_late)]
    assert len(early_and_late) < 12           # actually cut short
    # peers: bit-exact, untouched by the eviction
    for uid in (0, 2, 3):
        toks, fin, _ = results[uid]
        assert fin == "complete" and tuple(toks) == want[uid]
    assert eng.stats["cancelled"] == 1
    assert eng._free_total() == eng.slots     # slot reclaimed


def test_cancel_of_finished_or_unknown_uid_is_noop(small_model):
    cfg, m, params = small_model
    eng = _engine(cfg, params)
    req = Request(uid=7, prompt=_prompts(cfg, [5])[0], max_new=3)
    eng.run([req])
    assert req.done and req.finish_reason == "complete"
    before = dict(eng.stats)
    assert eng.cancel(7) is False             # finished: no-op
    assert eng.cancel(999) is False           # never existed: no-op
    assert eng.stats == before
    assert req.finish_reason == "complete"    # untouched


def test_submit_after_drain_rejected_with_typed_error(small_model):
    cfg, m, params = small_model
    eng = _engine(cfg, params)
    svc = ServeService(eng, max_pending=8).start()
    s = svc.submit(_prompts(cfg, [5])[0], max_new=3)
    svc.request_drain()
    with pytest.raises(EngineDraining):
        svc.submit(_prompts(cfg, [4])[0], max_new=3)
    with pytest.raises(EngineDraining):
        eng.submit(Request(uid=99, prompt=np.array([1, 2], np.int32),
                           max_new=2))
    with pytest.raises(EngineDraining):
        eng.run([Request(uid=98, prompt=np.array([1], np.int32), max_new=2)])
    svc.join(60)
    toks, fin, _ = s.result(timeout=10)
    assert fin in ("drain", "complete")       # drained or just finished
    assert svc.error is None


def test_deadline_evicts_only_own_request_round_clock(small_model):
    """Deadlines on a deterministic round-counter clock: the expiring
    request is evicted alone (typed 'deadline' finish, counted), peers
    run to completion bit-exactly, the slot comes back."""
    cfg, m, params = small_model
    prompts = _prompts(cfg, [5, 9, 7])
    ref = _batch_ref(cfg, params, [Request(uid=i, prompt=p, max_new=10)
                                   for i, p in enumerate(prompts)])
    eng = _engine(cfg, params)
    eng._clock = lambda: float(eng._round)    # rounds, not wall time
    reqs = [Request(uid=0, prompt=prompts[0], max_new=10),
            Request(uid=1, prompt=prompts[1], max_new=10, deadline=3.0),
            Request(uid=2, prompt=prompts[2], max_new=10)]
    eng.run(reqs)
    assert reqs[1].done and reqs[1].finish_reason == "deadline"
    assert 0 < len(reqs[1].generated) < 10
    assert tuple(reqs[1].generated) == ref[1][:len(reqs[1].generated)]
    assert tuple(reqs[0].generated) == ref[0]
    assert tuple(reqs[2].generated) == ref[2]
    assert eng.stats["deadline_expired"] == 1
    assert eng.stats["cancelled"] == 0        # separate counters
    assert eng._free_total() == eng.slots


def test_deadline_through_service_submit(small_model):
    cfg, m, params = small_model
    eng = _engine(cfg, params)
    eng._clock = lambda: float(eng._round)
    svc = ServeService(eng, max_pending=8).start()
    s_ok = svc.submit(_prompts(cfg, [5])[0], max_new=8)
    s_dl = svc.submit(_prompts(cfg, [9], seed=1)[0], max_new=64,
                      deadline_s=4.0)
    toks_dl, fin_dl, err_dl = s_dl.result(timeout=300)
    toks_ok, fin_ok, _ = s_ok.result(timeout=300)
    svc.stop()
    assert fin_dl == "deadline" and "deadline" in err_dl
    assert len(toks_dl) < 64
    assert fin_ok == "complete" and len(toks_ok) == 8
    assert eng.stats["deadline_expired"] == 1


def test_injected_disconnect_and_slow_consumer(small_model):
    cfg, m, params = small_model
    plan = FaultPlan(disconnect_uid=0, disconnect_after=2,
                     stall_uid=1, stall_cap=2)
    eng = _engine(cfg, params, fault=plan.injector())
    svc = ServeService(eng, max_pending=8).start()
    s_disc = svc.submit(_prompts(cfg, [5])[0], max_new=16)
    s_stall = svc.submit(_prompts(cfg, [7], seed=1)[0], max_new=16)
    assert (s_disc.uid, s_stall.uid) == (0, 1)
    # disconnect: consumer drains normally but the injected client drop
    # cancels after 2 delivered tokens
    toks, fin, _ = s_disc.result(timeout=300)
    assert fin == "disconnect" and len(toks) <= 3
    # slow consumer: NOBODY drains this stream; the bounded buffer (cap 2
    # via stream_cap) overflows and the service cancels the request
    _wait(lambda: s_stall.finished, timeout=300)
    toks, fin = s_stall.drain()
    assert fin[0] == "slow_consumer" and "overflowed" in fin[1]
    assert len(toks) <= 2                     # nothing past the cap
    svc.stop()
    assert eng.stats["cancelled"] == 2
    assert eng._free_total() == eng.slots


@contextlib.contextmanager
def _http(svc):
    fe = HttpFrontend(svc)
    ready = threading.Event()
    box = {}

    def run():
        async def amain():
            await fe.start()
            box["loop"] = asyncio.get_running_loop()
            box["stop"] = asyncio.Event()
            ready.set()
            await box["stop"].wait()
            await fe.stop()

        asyncio.run(amain())

    t = threading.Thread(target=run, daemon=True)
    t.start()
    assert ready.wait(30)
    try:
        yield fe
    finally:
        box["loop"].call_soon_threadsafe(box["stop"].set)
        t.join(10)


def _req(port, method, path, body=None, timeout=300):
    c = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        c.request(method, path, None if body is None else json.dumps(body),
                  {"Content-Type": "application/json"})
        r = c.getresponse()
        return r.status, r.read(), dict(r.getheaders())
    finally:
        c.close()


def _sse(port, body, timeout=300):
    """POST a stream=true completion; return (tokens, finish_event)."""
    c = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        c.request("POST", "/v1/completions", json.dumps(body),
                  {"Content-Type": "application/json"})
        r = c.getresponse()
        assert r.status == 200, r.read()
        toks, fin, saw_done = [], None, False
        for raw in r.fp:
            line = raw.decode().strip()
            if not line.startswith("data: "):
                continue
            if line == "data: [DONE]":
                saw_done = True
                break
            d = json.loads(line[6:])
            if "token" in d:
                assert d["index"] == len(toks)
                toks.append(d["token"])
            else:
                fin = d
        assert saw_done
        return toks, fin
    finally:
        c.close()


def test_http_endpoints_roundtrip(small_model):
    cfg, m, params = small_model
    prompts = _prompts(cfg, [5, 9])
    want = _batch_ref(cfg, params,
                      [Request(uid=i, prompt=p, max_new=5)
                       for i, p in enumerate(prompts)])
    eng = _engine(cfg, params)
    svc = ServeService(eng, max_pending=8).start()
    with _http(svc) as fe:
        st, body, _ = _req(fe.port, "GET", "/healthz")
        assert st == 200 and json.loads(body)["status"] == "serving"
        st, body, _ = _req(fe.port, "GET", "/v1/stats")
        stats = json.loads(body)
        assert {"shed", "completed", "watermark", "round"} <= set(stats)
        # non-streaming completion: exact batch tokens
        st, body, _ = _req(fe.port, "POST", "/v1/completions",
                           {"prompt": prompts[0].tolist(), "max_tokens": 5})
        out = json.loads(body)
        assert st == 200 and tuple(out["tokens"]) == want[0]
        assert out["finish_reason"] == "complete"
        # SSE: same tokens, one event each, typed finish, [DONE]
        toks, fin = _sse(fe.port, {"prompt": prompts[1].tolist(),
                                   "max_tokens": 5, "stream": True})
        assert tuple(toks) == want[1]
        assert fin["finish_reason"] == "complete" and fin["error"] is None
        # typed client errors
        st, body, _ = _req(fe.port, "POST", "/v1/completions",
                           {"max_tokens": 5})
        assert st == 400                      # no prompt
        st, body, _ = _req(fe.port, "POST", "/v1/completions",
                           {"prompt": list(range(500)), "max_tokens": 2})
        assert st == 400                      # oversized for every bucket
        st, _, _ = _req(fe.port, "GET", "/nope")
        assert st == 404
        # draining -> 503 with the drain state visible on healthz
        svc.request_drain()
        st, body, _ = _req(fe.port, "POST", "/v1/completions",
                           {"prompt": [1, 2], "max_tokens": 2})
        assert st == 503
        st, body, _ = _req(fe.port, "GET", "/healthz")
        assert json.loads(body)["status"] == "draining"
    svc.join(60)
    assert svc.error is None


def test_http_overload_returns_429_with_retry_after(small_model):
    cfg, m, params = small_model
    eng = _engine(cfg, params, slots=2, buckets=(8,))
    svc = ServeService(eng, max_pending=2, retry_after=0.7)
    p = _prompts(cfg, [4])[0]
    svc.submit(p, max_new=4)                  # service not started: the
    svc.submit(p, max_new=4)                  # queue sits at the watermark
    with _http(svc) as fe:
        st, body, hdrs = _req(fe.port, "POST", "/v1/completions",
                              {"prompt": p.tolist(), "max_tokens": 4})
        assert st == 429
        assert hdrs.get("Retry-After") == "0.7"
        assert "shed" in json.loads(body)["error"]
        assert eng.stats["shed"] == 1
        svc.start()
        _wait(lambda: json.loads(_req(fe.port, "GET", "/v1/stats")[1])
              ["completed"] == 2, timeout=300)
    svc.stop()


def test_http_client_disconnect_cancels_request(small_model):
    cfg, m, params = small_model
    eng = _engine(cfg, params, fault=_SlowDecode())
    svc = ServeService(eng, max_pending=8).start()
    with _http(svc) as fe:
        # raw socket: http.client hides its fd once the server announces
        # Connection: close, and this test needs an abrupt client close
        body = json.dumps({"prompt": _prompts(cfg, [5])[0].tolist(),
                           "max_tokens": 512, "stream": True})
        s = socket.create_connection(("127.0.0.1", fe.port), timeout=300)
        s.sendall((f"POST /v1/completions HTTP/1.1\r\nHost: t\r\n"
                   f"Content-Type: application/json\r\n"
                   f"Content-Length: {len(body)}\r\n\r\n{body}").encode())
        buf = b""
        while b'"token"' not in buf:           # at least one token flowed
            chunk = s.recv(4096)
            assert chunk, f"stream closed early: {buf!r}"
            buf += chunk
        s.close()                             # client hangs up mid-stream
        # the connection watcher turns EOF into cancel(uid): the slot
        # comes back and the cancel is counted as a disconnect
        _wait(lambda: eng.stats["cancelled"] == 1
              and eng._free_total() == eng.slots, timeout=300)
    req = eng.finished[-1]
    assert req.finish_reason == "disconnect"
    assert len(req.generated) < 512
    svc.stop()


def test_sigterm_under_live_http_traffic_snapshots_then_resumes(small_model):
    """launch/serve --http: SIGTERM while an SSE stream is mid-request
    drains at a round boundary (client sees a typed 'drain' finish),
    snapshots, exits 0; a --resume run regenerates the interrupted
    request token-for-token (prefix already streamed + resumed tokens ==
    the uninterrupted reference)."""
    cfg, m, params = small_model
    prompt = _prompts(cfg, [6])[0]
    ref_req = Request(uid=0, prompt=prompt, max_new=96)
    want = _batch_ref(cfg, params, [ref_req], max_len=128)[0]

    common = ["-m", "repro_torch.launch.serve", "--arch", "stablelm-1.6b",
              "--device", "cpu",
              "--reduced", "--slots", "4", "--max-len", "128",
              "--buckets", "8,16,32"]
    with tempfile.TemporaryDirectory() as td:
        snap = os.path.join(td, "drain.npy")
        proc = subprocess.Popen(
            [sys.executable, *common, "--http", "0", "--snapshot", snap],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=_launch_env(), cwd=REPO)
        try:
            port = None
            for line in proc.stdout:
                mo = re.search(r"serving HTTP on 127\.0\.0\.1:(\d+)", line)
                if mo:
                    port = int(mo.group(1))
                    break
            assert port, "server never reported its port"
            c = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
            c.request("POST", "/v1/completions",
                      json.dumps({"prompt": prompt.tolist(),
                                  "max_tokens": 96, "stream": True}),
                      {"Content-Type": "application/json"})
            r = c.getresponse()
            assert r.status == 200
            first = r.fp.readline()           # live traffic: token flowing
            assert b"token" in first
            proc.send_signal(signal.SIGTERM)  # preempt mid-stream
            streamed, fin = [json.loads(first[6:])["token"]], None
            for raw in r.fp:
                line = raw.decode().strip()
                if not line.startswith("data: ") or line == "data: [DONE]":
                    continue
                d = json.loads(line[6:])
                if "token" in d:
                    streamed.append(d["token"])
                else:
                    fin = d
            c.close()
            out, _ = proc.communicate(timeout=600)
        finally:
            proc.kill()
        assert proc.returncode == 0, out[-3000:]
        assert tuple(streamed) == want[:len(streamed)]

        if fin is not None and fin["finish_reason"] == "drain":
            # the interesting path: preempted mid-request -> the snapshot
            # must exist and --resume must regenerate uid 0 token-exactly
            assert len(streamed) < 96
            assert os.path.exists(snap), out[-3000:]
            res = subprocess.run(
                [sys.executable, *common, "--resume", snap],
                capture_output=True, text=True, env=_launch_env(),
                cwd=REPO, timeout=600)
            assert res.returncode == 0, res.stderr[-3000:]
            assert "resuming 1 unfinished" in res.stdout
            mo = re.search(r"req 0: \[([\d, ]*)\]", res.stdout)
            assert mo, res.stdout[-2000:]
            resumed = tuple(int(x) for x in mo.group(1).split(",") if
                            x.strip())
            assert resumed == want
        else:
            # the request beat the signal: it must then be COMPLETE with
            # the full reference stream (still pins token-exact serving
            # under a drain racing live traffic)
            assert fin is not None and fin["finish_reason"] == "complete"
            assert tuple(streamed) == want


# ---------------------------------------------------------------------------
# fault handling: request isolation, watchdogs, snapshots
# ---------------------------------------------------------------------------


def _reqs(cfg, lens, max_new=6, seed=0):
    rng = np.random.default_rng(seed)
    return [Request(uid=i,
                    prompt=rng.integers(0, cfg.vocab, L).astype(np.int32),
                    max_new=max_new) for i, L in enumerate(lens)]


def _toks(reqs):
    return {r.uid: tuple(r.generated) for r in reqs}


def test_nan_poisoned_prefill_fails_alone(small_model):
    """A request whose prefill logits carry NaN is failed + evicted; its
    batch peers (same prefill launch) are token-for-token unaffected."""
    cfg, m, params = small_model
    kw = dict(slots=4, max_len=64, temperature=0.7, seed=7)
    ref = _reqs(cfg, [4, 6, 5, 7])
    ServeEngine(cfg, params, device="cpu", **kw).run(ref)

    eng = ServeEngine(cfg, params, device="cpu", **kw,
                      fault=FaultPlan(nan_uid=1, nan_kind="prefill").injector())
    got = _reqs(cfg, [4, 6, 5, 7])
    eng.run(got)

    assert got[1].done and got[1].error == "non-finite logits at prefill"
    assert got[1].generated == []
    assert eng.stats["failed"] == 1
    assert eng.failures.count("nonfinite") == 1
    for uid in (0, 2, 3):                      # peers of the poisoned launch
        assert got[uid].error is None
        assert _toks(got)[uid] == _toks(ref)[uid]
    # the engine keeps serving after the eviction: freed slot is reusable
    late = _reqs(cfg, [5], max_new=3, seed=9)[0]
    late.uid = 99
    eng.run([late])
    assert late.done and late.error is None and len(late.generated) == 3


def test_nan_poisoned_decode_evicts_mid_stream(small_model):
    """NaN appearing at decode evicts that slot only; peers sharing the
    decode batch keep their exact streams."""
    cfg, m, params = small_model
    kw = dict(slots=4, max_len=64, temperature=0.7, seed=7)
    ref = _reqs(cfg, [4, 6, 5], max_new=8)
    ServeEngine(cfg, params, device="cpu", **kw).run(ref)

    eng = ServeEngine(cfg, params, device="cpu", **kw,
                      fault=FaultPlan(nan_uid=2, nan_kind="decode").injector())
    got = _reqs(cfg, [4, 6, 5], max_new=8)
    eng.run(got)

    assert got[2].done and got[2].error == "non-finite logits at decode"
    assert len(got[2].generated) == 1          # prefill token landed, then cut
    assert _toks(got)[2] == _toks(ref)[2][:1]  # ... and it matches the ref
    assert eng.failures.count("nonfinite") == 1
    for uid in (0, 1):
        assert got[uid].error is None
        assert _toks(got)[uid] == _toks(ref)[uid]


def test_malformed_prompt_fails_alone(small_model):
    """A structurally bad prompt fails at dequeue (kind='plan'); it never
    reaches a device launch and its co-submitted peers are unaffected."""
    cfg, m, params = small_model
    kw = dict(slots=4, max_len=64, temperature=0.7, seed=7)
    ref = _reqs(cfg, [4, 6, 5])
    ServeEngine(cfg, params, device="cpu", **kw).run(ref)

    eng = ServeEngine(cfg, params, device="cpu", **kw)
    got = _reqs(cfg, [4, 6, 5])
    bad = Request(uid=9, prompt=np.linspace(0.0, 1.0, 5), max_new=4)  # floats
    eng.run(got[:1] + [bad] + got[1:])

    assert bad.done and "malformed prompt" in bad.error
    assert bad.generated == []
    assert eng.failures.count("plan") == 1 and eng.stats["failed"] == 1
    assert _toks(got) == _toks(ref)


def test_raising_launch_fails_only_its_requests(small_model):
    """An exception inside one device launch fails that launch's requests
    and releases their slots; the engine keeps serving and later launches
    (including the SAME uids' peers) are exact."""
    cfg, m, params = small_model
    ref = _reqs(cfg, [4, 5, 6, 7], max_new=4)
    ServeEngine(cfg, params, device="cpu", slots=2, max_len=64).run(ref)

    plan = FaultPlan(raise_kind="prefill", raise_round=0)   # one-shot
    eng = ServeEngine(cfg, params, device="cpu", slots=2, max_len=64, fault=plan.injector())
    got = _reqs(cfg, [4, 5, 6, 7], max_new=4)
    eng.run(got)

    failed = [r for r in got if r.error]
    ok = [r for r in got if not r.error]
    assert len(failed) == 2                    # first admission group (2 slots)
    assert all("prefill launch failed" in r.error for r in failed)
    assert all("injected prefill launch fault" in r.error for r in failed)
    assert eng.stats["failed"] == 2 and eng.failures.count("exec") == 2
    assert len(ok) == 2
    for r in ok:
        assert _toks(got)[r.uid] == _toks(ref)[r.uid]


def test_deadline_watchdog_fires_cancels_and_disarms():
    fired = []
    with DeadlineWatchdog(0.05, reason="unit",
                          on_timeout=lambda r, s: fired.append((r, s))) as wd:
        time.sleep(0.4)
    assert wd.fired and fired == [("unit", 0.05)]

    with DeadlineWatchdog(5.0, on_timeout=lambda r, s: fired.append("no")) as wd:
        pass                                   # exits before expiry: cancelled
    time.sleep(0.1)
    assert not wd.fired and fired == [("unit", 0.05)]

    with DeadlineWatchdog(None, on_timeout=lambda r, s: fired.append("no")) as wd:
        assert wd._timer is None               # disarmed entirely
    assert not wd.fired


def test_snapshot_roundtrip_and_resume_clears_progress(tmp_path):
    snap = {
        "version": 1, "round": 5,
        "inflight": [{"uid": 2, "prompt": np.arange(4, dtype=np.int32),
                      "max_new": 8, "generated": [7, 9], "error": None}],
        "pending": [{"uid": 3, "prompt": np.arange(6, dtype=np.int32),
                     "max_new": 8, "generated": [], "error": None}],
        "finished": [{"uid": 1, "prompt": np.arange(3, dtype=np.int32),
                      "max_new": 2, "generated": [4, 4], "error": None}],
        "stats": {"completed": 1}, "failures": [],
    }
    path = os.path.join(tmp_path, "snap.npy")
    save_snapshot(path, snap)
    got = load_snapshot(path)
    assert got["version"] == 1 and got["round"] == 5
    np.testing.assert_array_equal(got["inflight"][0]["prompt"], np.arange(4))

    finished, todo = resume_requests(got)
    assert [r.uid for r in finished] == [1] and finished[0].done
    assert [r.uid for r in todo] == [2, 3]     # inflight first, then pending
    assert all(r.generated == [] and not r.done for r in todo)


def test_fault_plan_ships_over_json():
    """FaultPlan is the subprocess fixture format: asdict -> json -> init
    reproduces the plan (delay_rounds keys re-intified by the unpacker)."""
    plan = FaultPlan(nan_uid=3, kill_process=1, kill_at_seq=6,
                     delay_rounds={4: 5.0}, corrupt_header_at_seq=2)
    d = json.loads(json.dumps(dataclasses.asdict(plan)))
    d["delay_rounds"] = {int(k): v for k, v in d["delay_rounds"].items()}
    plan2 = FaultPlan(**d)
    assert plan2 == plan
    inj = plan2.injector()
    assert inj.exec_delay("decode", 4) == 5.0
    assert inj.exec_delay("decode", 3) == 0.0


@settings(max_examples=20, deadline=None)
@given(warmup=st.integers(min_value=5, max_value=30),
       magnitude=st.floats(min_value=4.0, max_value=50.0),
       base=st.floats(min_value=1e-3, max_value=0.1))
def test_straggler_watchdog_flags_spikes_not_steady_state(warmup, magnitude,
                                                         base):
    """Any spike past factor x EMA after any warmup is flagged on THAT
    observation; a steady stream never flags."""
    wd = StragglerWatchdog()
    for _ in range(warmup):
        assert not wd.observe(base)
    assert wd.observe(base * magnitude)        # magnitude > factor (3.0)
    assert wd.flagged == 1

    steady = StragglerWatchdog()
    for _ in range(warmup + 1):
        steady.observe(base)
    assert steady.flagged == 0


def test_straggler_flag_surfaces_in_engine_stats(small_model):
    """An injected virtual decode delay (never actually slept) is flagged
    by the serving loop within the run and lands in stats + failure log."""
    cfg, m, params = small_model
    plan = FaultPlan(delay_rounds={6: 300.0})
    eng = ServeEngine(cfg, params, device="cpu", slots=2, max_len=64, fault=plan.injector())
    req = _reqs(cfg, [6], max_new=12)[0]
    eng.run([req])
    assert req.done and req.error is None
    assert eng.stats["straggler_flags"] >= 1
    assert eng.failures.count("straggler") >= 1
    detail = [e for e in eng.failures.events if e["kind"] == "straggler"]
    assert "EMA" in detail[0]["detail"]


def test_prefill_straggler_has_own_ema_and_event_kind(small_model):
    """Prefill launches feed their OWN watchdog: an injected virtual delay
    scoped to ``delay_kind='prefill'`` flags the prefill EMA (distinct
    'straggler_prefill' event kind) and never touches the decode EMA's
    flag count - the two streams have very different baselines, so one
    shared EMA would either mask prefill stragglers or false-flag every
    prefill after a decode-heavy stretch."""
    cfg, m, params = small_model
    # rounds 1-4 serve request 0's undelayed prefill + decode (warming the
    # prefill EMA); every LATER prefill is virtually 300s slow
    plan = FaultPlan(delay_rounds={r: 300.0 for r in range(5, 60)},
                     delay_kind="prefill")
    eng = ServeEngine(cfg, params, device="cpu", slots=1, max_len=64,
                      fault=plan.injector())
    assert eng.prefill_straggler is not eng.straggler   # independent EMAs
    reqs = _reqs(cfg, [5, 6, 4], max_new=4)
    eng.run(reqs)
    assert all(r.done and r.error is None for r in reqs)
    assert eng.stats["prefill_straggler_flags"] >= 1
    assert eng.failures.count("straggler_prefill") >= 1
    ev = [e for e in eng.failures.events if e["kind"] == "straggler_prefill"]
    assert "prefill launch" in ev[0]["detail"] and "EMA" in ev[0]["detail"]
    # the decode watchdog saw only real (undelayed) decode timings
    decode_flagged = [e for e in eng.failures.events
                      if e["kind"] == "straggler"]
    assert not any("300" in e["detail"].split("s >")[0]
                   for e in decode_flagged)


@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_preempt_snapshot_resume_token_parity(small_model, tmp_path,
                                              temperature):
    """Preempt mid-serve, snapshot, resume on a FRESH engine: finished +
    regenerated streams are token-for-token the uninterrupted run, greedy
    and sampled (keys derive from (uid, step), not engine history)."""
    cfg, m, params = small_model
    kw = dict(slots=2, max_len=64, temperature=temperature,
              seed=3)
    lens = [4, 6, 9, 5, 7]
    ref = _reqs(cfg, lens, max_new=8)
    ServeEngine(cfg, params, device="cpu", **kw).run(ref)

    plan = FaultPlan(preempt_at_round=3)
    eng = ServeEngine(cfg, params, device="cpu", **kw, fault=plan.injector())
    eng.snapshot_path = os.path.join(tmp_path, f"snap{temperature}.npy")
    eng.run(_reqs(cfg, lens, max_new=8))
    assert eng.drained and os.path.exists(eng.snapshot_path)

    finished, todo = resume_requests(load_snapshot(eng.snapshot_path))
    assert todo                                # the preemption left real work
    eng2 = ServeEngine(cfg, params, device="cpu", **kw)      # fresh engine, no shared state
    eng2.run(todo)

    out = finished + todo
    assert {r.uid for r in out} == set(range(len(lens)))
    assert all(r.done and r.error is None for r in out)
    assert _toks(out) == _toks(ref)


# ---------------------------------------------------------------------------
# telemetry plane
# ---------------------------------------------------------------------------


def test_prometheus_exposition_names_types_and_series():
    m = MetricsRegistry()
    m.counter("reqs_total", "requests seen").inc(3)
    m.gauge("pool_free", "free pages").set(41)
    h = m.histogram("lat_seconds", "latency", buckets=(0.1, 1.0))
    h.observe(0.05)
    h.observe(0.5)
    h.observe(7.0)
    text = m.render()
    lines = text.splitlines()
    assert text.endswith("\n")
    assert "# HELP reqs_total requests seen" in lines
    assert "# TYPE reqs_total counter" in lines
    assert "reqs_total 3" in lines
    assert "# TYPE pool_free gauge" in lines
    assert "pool_free 41" in lines
    assert "# TYPE lat_seconds histogram" in lines
    # cumulative buckets, +Inf == _count, integral values print as ints
    assert 'lat_seconds_bucket{le="0.1"} 1' in lines
    assert 'lat_seconds_bucket{le="1"} 2' in lines
    assert 'lat_seconds_bucket{le="+Inf"} 3' in lines
    assert "lat_seconds_count 3" in lines
    assert any(l.startswith("lat_seconds_sum 7.55") for l in lines)
    # families are sorted and every non-comment line belongs to a family
    fams = [l.split()[2] for l in lines if l.startswith("# TYPE")]
    assert fams == sorted(fams)


def test_prometheus_label_escaping_and_label_sets():
    m = MetricsRegistry()
    m.counter("c_total", "c", kind='we"ird\\path\nx').inc()
    m.counter("c_total", "c", kind="plain").inc(2)
    text = m.render()
    # one TYPE line, two children, escaped backslash/quote/newline
    assert text.count("# TYPE c_total counter") == 1
    assert 'c_total{kind="we\\"ird\\\\path\\nx"} 1' in text
    assert 'c_total{kind="plain"} 2' in text
    # same (name, labels) returns the same child
    assert m.counter("c_total", kind="plain").value == 2.0


def test_registry_is_shared_by_handle_and_lookup():
    tel = Telemetry(enabled=True)
    tel.ttft.observe(0.2)
    again = tel.metrics.histogram("serve_ttft_seconds")
    assert again is tel.ttft and again.count == 1
    text = tel.metrics.render()
    for name in ("serve_ttft_seconds", "serve_per_token_seconds",
                 "serve_queue_wait_seconds", "serve_round_occupancy",
                 "serve_shed_total", "pdq_fallbacks", "pdq_clip_hits",
                 "pdq_clip_total", "pdq_clip_rate"):
        assert f"# TYPE {name}" in text, name


def test_disabled_telemetry_renders_empty_and_spans_are_noops():
    tel = Telemetry(enabled=False, trace=True)
    assert tel.metrics.render() == "\n"
    with tel.span("launch:decode"):
        pass
    assert tel.tracer.events() == []
    assert tel.summary() == {}
    tel.observe_pdq(1, 2, 3)          # must not raise, must not record
    assert tel.metrics.render() == "\n"


@settings(max_examples=60, deadline=None)
@given(groups=st.lists(st.lists(st.floats(min_value=0.0, max_value=100.0,
                                          allow_nan=False), max_size=30),
                       min_size=1, max_size=6),
       data=st.data())
def test_histogram_observe_merge_never_loses_counts(groups, data):
    """Observations spread over several histograms and merged in any order
    conserve count, per-bucket counts and sum exactly."""
    parts = [Histogram(buckets=(0.5, 1.0, 5.0, 50.0)) for _ in groups]
    for h, vals in zip(parts, groups):
        for v in vals:
            h.observe(v)
    total = Histogram(buckets=(0.5, 1.0, 5.0, 50.0))
    order = data.draw(st.permutations(range(len(parts))))
    for i in order:
        total.merge(parts[i])
    all_vals = [v for vals in groups for v in vals]
    assert total.count == len(all_vals)
    assert sum(total.counts) == total.count
    assert total.sum == pytest.approx(sum(all_vals))
    # bucket membership matches a direct histogram of the same values
    direct = Histogram(buckets=(0.5, 1.0, 5.0, 50.0))
    for v in all_vals:
        direct.observe(v)
    assert total.counts == direct.counts


def test_histogram_percentiles_bracket_the_data():
    h = Histogram(buckets=LATENCY_BUCKETS)
    assert h.percentile(0.5) == 0.0           # empty: defined, zero
    for v in [0.002] * 90 + [0.2] * 10:
        h.observe(v)
    assert 0.001 <= h.percentile(0.50) <= 0.0025
    assert 0.1 <= h.percentile(0.99) <= 0.25
    h2 = Histogram(buckets=(1.0,))
    h2.observe(100.0)                         # overflow bucket
    assert h2.percentile(0.99) == 1.0         # reports the edge


def test_histogram_merge_rejects_mismatched_buckets():
    with pytest.raises(AssertionError):
        Histogram(buckets=(1.0,)).merge(Histogram(buckets=(2.0,)))


def test_tracer_exports_valid_chrome_trace():
    clock = iter(np.arange(0.0, 10.0, 0.001))
    tr = Tracer(enabled=True, pid=0, clock=lambda: next(clock))
    with tr.span("launch:decode", cat="phase", tid=2, rows=4):
        pass
    tr.add("launch:prefill", ts=100.0, dur=250.0, pid=1, tid=2,
           args={"process": 1})
    tr.name_process(1, "process 1")
    tr.name_thread(1, 2, "launch")
    obj = json.loads(json.dumps(tr.export()))    # JSON-serializable
    evs = obj["traceEvents"]
    spans = [e for e in evs if e["ph"] == "X"]
    meta = [e for e in evs if e["ph"] == "M"]
    assert len(spans) == 2
    for e in spans:
        assert isinstance(e["name"], str) and isinstance(e["cat"], str)
        assert isinstance(e["ts"], (int, float)) and e["ts"] >= 0
        assert isinstance(e["dur"], (int, float)) and e["dur"] >= 0
        assert isinstance(e["pid"], int) and isinstance(e["tid"], int)
    assert {e["pid"] for e in spans} == {0, 1}
    # metadata names every pid and every (pid, tid)
    proc_rows = {e["pid"] for e in meta if e["name"] == "process_name"}
    thread_rows = {(e["pid"], e["tid"]) for e in meta
                   if e["name"] == "thread_name"}
    assert {0, 1} <= proc_rows
    assert {(0, 2), (1, 2)} <= thread_rows
    named = {e["pid"]: e["args"]["name"] for e in meta
             if e["name"] == "process_name"}
    assert named[1] == "process 1"
    # args values are JSON primitives
    assert spans[1]["args"]["process"] == 1


def test_tracer_ring_is_bounded_and_counts_drops():
    clock = iter(np.arange(0.0, 10.0, 0.001))
    tr = Tracer(enabled=True, capacity=4, clock=lambda: next(clock))
    for i in range(10):
        tr.add(f"s{i}", ts=float(i), dur=1.0)
    assert len(tr.events()) == 4
    assert tr.dropped == 6
    assert tr.export()["otherData"]["dropped_spans"] == 6
    assert [e["name"] for e in tr.events()] == ["s6", "s7", "s8", "s9"]


def test_served_engine_populates_standard_series(small_model):
    cfg, m, params = small_model
    eng = _engine(cfg, params, trace=True)
    rng = np.random.default_rng(0)
    reqs = [Request(uid=i,
                    prompt=rng.integers(0, cfg.vocab, L).astype(np.int32),
                    max_new=4) for i, L in enumerate([3, 9, 12])]
    eng.run(reqs)
    assert all(r.done for r in reqs)
    tel = eng.tel
    assert tel.ttft.count == 3
    assert tel.per_token.count == sum(len(r.generated) - 1 for r in reqs)
    assert tel.queue_wait.count == 3
    assert tel.round_occupancy.count > 0
    kinds = {k for labels, _ in
             tel.metrics.get("serve_launch_seconds").items()
             for lk, k in labels if lk == "kind"}
    assert {"prefill", "decode"} <= kinds
    summ = tel.summary()
    for key in ("ttft", "per_token", "queue_wait"):
        s = summ[key]
        assert s["count"] > 0 and 0 <= s["p50"] <= s["p90"] <= s["p99"]
    names = {e["name"] for e in tel.tracer.events()}
    assert {"plan:prefill", "launch:prefill", "apply:prefill",
            "plan:decode", "launch:decode", "apply:decode"} <= names
    assert any(n.startswith("req 0") for n in names)
    # request spans ride the request thread row with uid attribution
    req_spans = [e for e in tel.tracer.events() if e["tid"] == 0]
    assert all("uid" in (e.get("args") or {}) for e in req_spans)


def test_telemetry_disabled_engine_serves_identically(small_model):
    cfg, m, params = small_model
    rng = np.random.default_rng(0)
    lens = [3, 9, 12, 5]
    mk = lambda: [Request(uid=i, prompt=np.asarray(p), max_new=4)
                  for i, p in enumerate(_prompts(cfg, lens))]
    on = _engine(cfg, params, telemetry=True)
    off = _engine(cfg, params, telemetry=False)
    r_on, r_off = mk(), mk()
    on.run(r_on)
    off.run(r_off)
    assert ([tuple(r.generated) for r in r_on]
            == [tuple(r.generated) for r in r_off])
    assert off.tel.metrics.render() == "\n"


def test_metrics_and_events_endpoints(small_model):
    cfg, m, params = small_model
    eng = _engine(cfg, params)
    svc = ServeService(eng, max_pending=8).start()
    with _http(svc) as fe:
        streams = [svc.submit(p, max_new=4)
                   for p in _prompts(cfg, [5, 9, 30])]
        for s in streams:
            s.result(timeout=300)
        st, body, hdrs = _req(fe.port, "GET", "/metrics")
        assert st == 200
        assert hdrs.get("Content-Type", "").startswith("text/plain")
        text = body.decode()
        for name in ("serve_ttft_seconds_bucket", "serve_ttft_seconds_count",
                     "serve_per_token_seconds_sum",
                     "serve_queue_wait_seconds_count",
                     "serve_launch_seconds_bucket", "serve_round_occupancy",
                     "pdq_fallbacks", "pdq_clip_rate"):
            assert name in text, name
        assert 'serve_launch_seconds_bucket{kind="prefill"' in text
        assert "serve_ttft_seconds_count 3" in text
        st, body, hdrs = _req(fe.port, "GET", "/v1/events")
        assert st == 200
        events = [json.loads(l) for l in body.decode().splitlines()]
        assert all({"t", "step", "kind", "detail"} <= set(e)
                   for e in events)
    svc.stop()


def test_stats_and_metrics_survive_concurrent_scrape_storm(small_model):
    """Regression for the /v1/stats race: scrape threads hammer /v1/stats,
    /metrics and /v1/events while the loop thread serves a 3x-overload
    burst (list-valued stats resized per admission); every response must
    parse and no scrape may crash the serializer."""
    cfg, m, params = small_model
    eng = _engine(cfg, params, slots=2, buckets=(8,))
    svc = ServeService(eng, max_pending=4).start()
    errs: list = []
    stop = threading.Event()

    def scrape(path, check):
        while not stop.is_set():
            try:
                c = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
                c.request("GET", path)
                r = c.getresponse()
                check(r.status, r.read())
                c.close()
            except Exception as e:          # noqa: BLE001 - collect, assert
                errs.append((path, repr(e)))
                return

    with _http(svc) as fe:
        port = fe.port
        threads = [
            threading.Thread(target=scrape, args=(
                "/v1/stats",
                lambda s, b: (json.loads(b), )[0] if s == 200
                else errs.append(("status", s)))),
            threading.Thread(target=scrape, args=(
                "/metrics",
                lambda s, b: b.decode() if s == 200
                else errs.append(("status", s)))),
            threading.Thread(target=scrape, args=(
                "/v1/events",
                lambda s, b: [json.loads(l) for l in b.splitlines()]
                if s == 200 else errs.append(("status", s)))),
        ]
        for t in threads:
            t.start()
        streams = []
        for i in range(24):
            try:
                streams.append(svc.submit(
                    _prompts(cfg, [4 + i % 5], seed=i)[0], max_new=4))
            except Exception:
                pass                        # shed: part of the storm
        for s in streams:
            s.result(timeout=300)
        stop.set()
        for t in threads:
            t.join(60)
    svc.stop()
    assert not errs, errs[:5]
    snap = eng.stats_snapshot()
    assert snap["completed"] == len(streams)
    assert isinstance(snap["replica_admits"], list)
