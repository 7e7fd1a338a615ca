"""The metric readers and the trace reduction on synthetic records."""
import numpy as np
import pytest

from perfbench import harness, trace


def _rec(requests, t0=0.0, t1=10.0, **kw):
    rec = {"t0": t0, "t1": t1, "slots": 4, "requests": requests, "spans": [], "steps": []}
    rec.update(kw)
    return rec


def _req(submit, times, accepted=None, admitted=None):
    return {"submit": submit, "times": list(times), "accepted": accepted, "admitted": admitted}


def _read(name, rec):
    return harness.metric_module(name).read(rec)


def _steady(n_req=4, step=0.01, t_end=10.0):
    return [_req(-1.0, np.arange(0.0, t_end, step) + 0.001 * i) for i in range(n_req)]


def test_output_tokens_count_only_the_window():
    reqs = [_req(-1.0, np.arange(-2.0, 12.0, 0.5))]      # 20 of 28 tokens in [0, 10)
    assert _read("output_tokens_per_s", _rec(reqs)) == pytest.approx(2.0)


def test_a_stall_in_the_window_moves_itl_p99():
    base = _read("itl_p99_ms", _rec(_steady()))
    assert base == pytest.approx(10.0, rel=1e-6)
    stalled = []
    for r in _steady():
        t = np.asarray(r["times"])
        for a in np.arange(1.0, 10.0, 1.0):             # nine 0.4 s prefill rounds
            t = np.where(t >= a, t + 0.4, t)
        stalled.append(_req(-1.0, t[t < 10.0]))
    assert _read("itl_p99_ms", _rec(stalled)) == pytest.approx(410.0, rel=1e-3)
    # a stall after the window closes moves nothing
    late = [_req(-1.0, np.r_[np.asarray(r["times"]), 10.5]) for r in _steady()]
    assert _read("itl_p99_ms", _rec(late)) == pytest.approx(base)


def test_an_unserved_request_counts_in_ttft_p90():
    served = [_req(1.0 + i * 0.1, [1.05 + i * 0.1]) for i in range(9)]
    assert _read("ttft_p90_ms", _rec(served)) == pytest.approx(50.0)
    waiting = served + [_req(2.0, [])]                   # still waiting at 10 s: 8 s so far
    assert _read("ttft_p90_ms", _rec(waiting)) == pytest.approx((0.05 + 0.1 * 7.95) * 1e3)
    before = served + [_req(-1.0, [])]                   # submitted before the window
    assert _read("ttft_p90_ms", _rec(before)) == pytest.approx(50.0)


def test_queue_wait_counts_unadmitted_requests():
    reqs = [_req(1.0, [1.2], accepted=1.0, admitted=1.01) for _ in range(9)]
    assert _read("queue_wait_p90_ms.reason", _rec(reqs)) == pytest.approx(10.0)
    reqs.append(_req(9.0, [], accepted=9.0, admitted=None))
    assert _read("queue_wait_p90_ms.reason", _rec(reqs)) == pytest.approx(109.0)


def test_counter_and_span_readers():
    stats0 = {"decode_steps": 10, "decode_tokens": 30}
    stats1 = {"decode_steps": 110, "decode_tokens": 430}
    assert _read("decode_occupancy.reason", _rec([], stats0=stats0, stats1=stats1)) == 100.0
    spans = [("launch:decode", 0.5, 0.52), ("launch:decode", 1.0, 1.04), ("plan:decode", 2.0, 3.0),
             ("launch:prefill", -1.0, 1.0), ("launch:chunked", 9.0, 11.0),
             ("launch:decode", 10.5, 11.0)]
    rec = _rec([], spans=spans)
    assert _read("decode_launch_ms.reason", rec) == pytest.approx(30.0)
    assert _read("prefill_share.reason", rec) == pytest.approx(20.0)


def test_model_step_share_of_peak():
    from perfbench import peaks
    from perfbench.reference import decoder
    m = {"n_layers": 2, "d_model": 64, "n_heads": 4, "n_kv_heads": 2, "head_dim": 16,
         "d_ff": 128, "vocab": 512, "dtype": "float32"}
    steps = [(1.0, 1.01, 4, 100), (2.0, 2.01, 4, 104)]
    spans = [("launch:decode", 1.0, 1.01), ("launch:decode", 2.0, 2.01)]
    rec = _rec([], steps=steps, spans=spans, model=m, counts=decoder)
    floor = sum(peaks.ops_s(*decoder.decode_ops(m, 4, live)) for live in (100, 104))
    assert _read("decode_mfu.reason", rec) == pytest.approx(100 * floor / 0.02)


def test_trace_reduction():
    ms = 1_000_000
    dev = [("k1", 0, 2 * ms, 7), ("k2", 1 * ms, 3 * ms, 7), ("k3", 5 * ms, 6 * ms, 9),
           ("k1", 8 * ms, 12 * ms, 11)]
    rt = [("cudaGraphLaunch", 0, 10_000, 7), ("cudaLaunchKernel", 4 * ms, 4 * ms + 1, 9)]
    steps = [(0, 4 * ms, 4, 80), (7 * ms, 13 * ms, 4, 84)]
    spans = [("launch:decode", 0, 4 * ms), ("launch:prefill", 4 * ms, 7 * ms)]
    p = trace.reduce({"device": dev, "runtime": rt}, (0, 10 * ms), steps, spans)
    assert p["window_s"] == pytest.approx(0.010) and p["busy_s"] == pytest.approx(0.006)
    assert p["device_ops"][0] == ["k1", pytest.approx(0.004)]
    # idle [3, 5) ms falls in the prefill span, [6, 8) ms after it
    assert dict(map(tuple, p["idle_gaps"])) == {"launch:prefill": pytest.approx(0.002),
                                                "none": pytest.approx(0.002)}
    assert p["decode"] == [(pytest.approx(0.003), 4, 80)]    # the second step leaves the window
    assert trace.union(np.array([[3, 4], [0, 2], [1, 3]])).tolist() == [[0, 4]]


def test_stratified_traffic_serves_every_seed_the_same_work():
    from perfbench.traffic import Traffic, load_mix
    mix = load_mix(harness.BENCH / "mixes" / "reason.json")
    runs = []
    for seed in (1, 2 ** 31 + 5):
        t = Traffic(mix, seed, 1000)
        first = t.initial(64)
        more = [t.next() for _ in range(mix["block"] * 4)]
        runs.append((sorted(len(p) for p, _ in more), sorted(n for _, n in more),
                     [n for _, n in first[:64]]))
        assert len(first) == mix["clients"] > 64
        assert all(1 <= n <= mix["output_tokens"]["max"] for _, n in first)
        # the clients that wait in the queue wait with whole outputs
        assert all(n >= mix["output_tokens"]["min"] for _, n in first[64:])
        assert all(p.max() < 1000 and p.min() >= 0 for p, _ in more)
    assert runs[0][:2] == runs[1][:2]
    assert sorted(runs[0][2]) == sorted(runs[1][2]) and runs[0][2] != runs[1][2]


def test_every_metric_file_matches_its_entry():
    bench = harness.benchmark()
    for m in bench["end_to_end"] + bench["per_layer"]:
        mod = harness.metric_module(m["name"])
        assert mod.UNIT == m["unit"], m["name"]
        if "layer" in m:
            assert (mod.LAYER, mod.MOVES) == (m["layer"], m["moves"]), m["name"]
