"""The benchmark's driver: one run of one cell of ``BENCHMARK.json``.

A cell names a configuration (``configs/<name>.json``: the model's sizes,
the engine's settings, the plain reference that checks it and the limit it
is checked against) and a traffic mix (``mixes/<name>.json``, drawn by
``traffic.py``); each metric is a reader of its own (``metrics/<name>.py``).
All are found by the names in ``BENCHMARK.json``, so a cell, a mix or a
metric is added with files and entries alone.

A run, on the card:

1. set-up: weights made on the card from the seed (the reference module's
   ``make_weights``), the program's engine built from them through
   ``repro_torch.serve.build_engine`` (its PDQ int8 weights, pool and
   captured decode graph) behind a ``ServeService``, and each client's first
   request submitted and admitted; every prefill bucket the mix reaches is
   prefilled there once;
2. the window: ``seconds`` of closed-loop traffic from one driver thread,
   each token's time taken where it lands in its stream;
3. the check: once the window has closed, the program's peak memory read
   and its state freed, the plain reference (float32, layer by layer, from
   the same weights made again from the seed) runs over a sample of the
   finished requests, longest included, with the tokens served, and the
   widest gap by which a served token's logit lies below the reference's
   best is held against the configuration's limit.

With ``trace`` the program's spans are on, a ``torch.profiler`` sub-window
reads the device, and the per-layer metrics are reported in place of the
end-to-end ones.
"""
from __future__ import annotations

import bisect
import gc
import importlib.util
import json
import os
import queue
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
PROFILE_S = 2.0          # length of the traced run's profiled sub-window
SETUP_LIMIT_S = 600.0    # set-up's admission wait gives up after this

# the CPU tests' sizes (``run_cell(small=...)``): the program's reduced
# config of the cell's arch, four slots and short requests; the limit is
# set from CPU readings at these sizes (program 0.005-0.006, the 4-bit
# control 0.20-0.32)
TEST_SIZES = {"serve": {"slots": 4, "max_len": 128, "buckets": [16, 32]},
              "mix": {"clients": 6, "block": 4,
                      "prompt_tokens": {"median": 16, "sigma": 0.5, "min": 8, "max": 32},
                      "output_tokens": {"median": 24, "sigma": 0.3, "min": 12, "max": 40}},
              "limit": 0.05}

if str(BENCH.parent) not in sys.path:
    sys.path.insert(0, str(BENCH.parent))
if str(ROOT / "src") not in sys.path:
    sys.path.insert(0, str(ROOT / "src"))

from perfbench import trace as tr  # noqa: E402
from perfbench.traffic import Traffic, load_mix  # noqa: E402


class RunError(RuntimeError):
    """A run that cannot give a result (no card, a bad cell)."""


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise RunError(f"cannot load {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def benchmark() -> dict:
    path = ROOT / "BENCHMARK.json"
    if not path.exists():
        raise RunError(f"{path} is missing")
    return json.loads(path.read_text())


def metric_module(name: str):
    return load_module(BENCH / "metrics" / f"{name}.py", f"perfbench_metric_{name}")


def reference_module(name: str):
    import importlib
    return importlib.import_module(f"perfbench.reference.{name}")


def cell(workload: str, trace: bool) -> dict:
    """The cell's workload entry, configuration, mix and the metrics it
    reports in this kind of run (end-to-end ones, or per-layer ones with
    ``trace``)."""
    bench = benchmark()
    work = {w["name"]: w for w in bench["workloads"]}.get(workload)
    if work is None:
        raise RunError(f"no workload {workload!r} in BENCHMARK.json")
    conf = {c["name"]: c for c in bench["configs"]}[work["config"]]
    config = json.loads((ROOT / conf["file"]).read_text())
    mix = load_mix(BENCH / "mixes" / f"{work['traffic']}.json")
    specs = bench["per_layer" if trace else "end_to_end"]
    metrics = [(m, metric_module(m["name"])) for m in specs
               if workload in m.get("workloads", [workload])]
    return {"workload": work, "config": config, "mix": mix, "metrics": metrics}


# ------------------------------------------------------------------ model
def port_config(config: dict, small: bool):
    """The program's ArchConfig of the cell: its own config of ``arch``,
    checked against every size of the configuration's file (``small``: the
    program's reduced sizes of the arch, for tests on the CPU)."""
    from repro_torch.configs import get_config, reduced_config
    cfg = reduced_config(config["arch"]) if small else get_config(config["arch"])
    if not small:
        for key, want in config["model"].items():
            got = getattr(cfg, key)
            if isinstance(want, dict):
                got = {k: getattr(got, k) for k in want}
            if got != want:
                raise RunError(f"{config['arch']}: the program's {key} is {got!r}, "
                               f"the configuration's {want!r}")
    return cfg


def model_sizes(cfg, model: dict) -> dict:
    """The configuration's model keys read from an ArchConfig."""
    out = {}
    for key, want in model.items():
        got = getattr(cfg, key)
        out[key] = {k: getattr(got, k) for k in want} if isinstance(want, dict) else got
    return out


# ----------------------------------------------------------------- driver
class Req:
    __slots__ = ("uid", "client", "prompt", "max_new", "t_submit", "times", "tokens",
                 "reason", "stream")

    def __init__(self, client, prompt, max_new, t_submit, stream):
        self.client, self.prompt, self.max_new = client, prompt, max_new
        self.t_submit, self.stream, self.uid = t_submit, stream, stream.uid
        self.times: list[float] = []
        self.tokens = None
        self.reason = None


class Driver:
    """One thread that submits for every client of a closed loop and takes
    each token's time in its stream's waker (on the service's loop thread,
    after the token is in the stream)."""

    def __init__(self, service, traffic: Traffic):
        self.service, self.traffic = service, traffic
        self.done: queue.SimpleQueue = queue.SimpleQueue()
        self.reqs: list[Req] = []
        self.submit_failures = 0
        self.failures_seen = 0
        self.submitting = True

    def submit(self, client: int, prompt, max_new: int) -> Req | None:
        t = time.perf_counter()
        try:
            stream = self.service.submit(prompt, max_new=max_new)
        except Exception as e:          # refused at the front door: a failure
            self.submit_failures += 1
            print(f"submit refused: {e!r}", file=sys.stderr)
            return None
        req = Req(client, prompt, max_new, t, stream)
        times, done = req.times, self.done

        def wake():
            now = time.perf_counter()
            if stream.finished:
                done.put(req)
            else:
                times.append(now)
        stream.add_waker(wake)
        self.reqs.append(req)
        return req

    def finish(self, req: Req) -> None:
        toks, fin = req.stream.drain()
        req.tokens = np.asarray(toks, dtype=np.int64)
        req.reason = fin[0] if fin else "unfinished"
        if fin and req.reason not in ("complete", "drain") and not self.failures_seen:
            print(f"request failed: {fin!r}", file=sys.stderr)      # the first only
        self.failures_seen += req.reason not in ("complete", "drain", "unfinished")
        if self.submitting:
            self.submit(req.client, *self.traffic.next())

    def pump(self, until: float) -> None:
        """Handle finishes until ``until`` (perf_counter s)."""
        while True:
            left = until - time.perf_counter()
            if left <= 0:
                return
            try:
                req = self.done.get(timeout=left)
            except queue.Empty:
                return
            self.finish(req)

    def drain(self) -> None:
        """After the service stopped: every stream has its finish."""
        self.submitting = False
        while True:
            try:
                self.finish(self.done.get_nowait())
            except queue.Empty:
                break
        for r in self.reqs:
            if r.reason is None:
                self.finish(r)


def process_age() -> float:
    """Seconds since this process started (from /proc)."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


# ------------------------------------------------------------------- check
def pick_sample(reqs: list[Req], n: int, seed: int) -> list[Req]:
    """The longest finished request and ``n - 1`` others drawn from the
    seed."""
    done = [r for r in reqs if r.reason == "complete" and len(r.tokens)]
    if not done:
        return []
    longest = max(done, key=lambda r: (len(r.tokens), -r.uid))
    rest = [r for r in done if r is not longest]
    rng = np.random.default_rng([int(seed) % 2 ** 63, 2])
    idx = rng.choice(len(rest), size=min(n - 1, len(rest)), replace=False)
    return [longest] + [rest[i] for i in sorted(idx)]


def logit_gaps(ref, model: dict, weights, sample: list[Req], device, control: bool = False):
    """Over every served token of ``sample``: the widest gap by which its
    float32 reference logit lies below the reference's best at its
    position, the tokens compared, and with ``control`` the widest gap of
    the token the 4-bit control puts first."""
    import torch
    gap, gap4, n = 0.0, 0.0, 0
    for r in sample:
        seq = torch.as_tensor(np.concatenate([r.prompt, r.tokens])[:-1], device=device)
        P, toks = len(r.prompt), torch.as_tensor(r.tokens, device=device)
        logits = ref.forward(weights, model, seq)[P - 1:]
        best = logits.max(-1).values
        got = logits.gather(1, toks[:, None])[:, 0]
        gap = max(gap, float((best - got).max()))
        n += len(r.tokens)
        if control:
            first = ref.forward(weights, model, seq, bits=4)[P - 1:].argmax(-1)
            gap4 = max(gap4, float((best - logits.gather(1, first[:, None])[:, 0]).max()))
        del logits
    return gap, n, gap4


# --------------------------------------------------------------------- run
def run_cell(workload: str, seed: int, seconds: float, trace: bool, *,
             device: str = "cuda", small: dict | None = None, control: bool = False,
             patch=None) -> dict:
    """One run; returns the result line's object (and, with ``control``,
    the 4-bit control's verdict by the same comparison under
    ``control_correct``, its gap under ``check["control_gap"]``).  ``small``: the test
    sizes (``{"serve": ..., "mix": ..., "limit": ...}`` overrides over the
    program's reduced config) on any device.  ``patch(engine)`` is called
    on the built engine (tests plant faults with it)."""
    import torch
    spec = cell(workload, trace)
    config, mix = spec["config"], dict(spec["mix"])
    serve = dict(config["serve"])
    limit = config["check"]["logit_gap_limit"]
    if small:
        serve.update(small.get("serve", {}))
        mix.update(small.get("mix", {}))
        limit = small.get("limit", limit)
    dev = torch.device(device)
    cfg = port_config(config, bool(small))
    model = model_sizes(cfg, config["model"]) if small else config["model"]
    ref = reference_module(config["reference"])

    from repro_torch.serve import ServeConfig, ServeService, build_engine
    traffic = Traffic(mix, seed, model["vocab"])
    weights = ref.make_weights(model, seed, dev)
    # every engine setting of the configuration's ``serve`` is a ServeConfig field
    sc = ServeConfig(arch=config["arch"], reduced=bool(small), device=device, trace=trace,
                     **{k: tuple(v) if isinstance(v, list) else v for k, v in serve.items()})
    eng = build_engine(sc, cfg=cfg, params=weights)
    del weights
    if patch is not None:
        patch(eng)
    steps: list[tuple[int, int, int, int]] = []
    # the traced run holds the loop thread's launches while the profiler
    # starts and stops, so that neither meets a launch in flight
    quiet = threading.Lock()
    if trace:
        exec_decode, exec_prefill = eng._exec_decode, eng._exec_prefill

        def timed(plan):
            with quiet:
                a = time.perf_counter_ns()
                out = exec_decode(plan)
                b = time.perf_counter_ns()
            live = int(plan.positions[plan.live, 0].sum()) + len(plan.live)
            steps.append((a, b, len(plan.live), live))
            return out

        def prefill(plan, extras):
            with quiet:
                return exec_prefill(plan, extras)
        eng._exec_decode, eng._exec_prefill = timed, prefill
    svc = ServeService(eng, max_pending=int(mix["clients"]),
                       max_stream_buffer=traffic.longest_output + 1).start()
    prof_cls = None
    if trace and dev.type == "cuda":
        from torch.profiler import ProfilerActivity, profile
        prof_cls = lambda: profile(activities=[ProfilerActivity.CUDA])   # noqa: E731
        with prof_cls():        # the profiler's own set-up, out of the window
            torch.ones(1, device=dev).add_(1)
            torch.cuda.synchronize(dev)

    drv = Driver(svc, traffic)
    initial = [drv.submit(c, *req) for c, req in enumerate(traffic.initial(eng.slots))]
    # set-up ends once every row holds its first request; the other
    # clients' requests wait in the queue
    running = initial[:eng.slots]
    give_up = time.perf_counter() + SETUP_LIMIT_S
    while not all(r is None or r.times or r.reason for r in running):
        if svc.error is not None or time.perf_counter() > give_up:
            svc.stop()
            raise RunError(f"set-up never admitted every first request: {svc.error!r}")
        drv.pump(time.perf_counter() + 0.01)

    # ------------------------------------------------------------- window
    setup_s = process_age()
    t0 = time.perf_counter()
    t1 = t0 + seconds
    stats0 = eng.stats_snapshot()
    prof, prof_ns = None, None
    if prof_cls is not None:
        drv.pump(t0 + max(0.0, (seconds - PROFILE_S) / 2))
        prof = prof_cls()
        with quiet:
            torch.cuda.synchronize(dev)
            prof.start()
            a = time.perf_counter_ns()
        drv.pump(min(t1, time.perf_counter() + PROFILE_S))
        with quiet:
            torch.cuda.synchronize(dev)
            b = time.perf_counter_ns()
            pair = tr.clock_pair()
            prof.stop()
        prof_ns = (a, b, pair)
    drv.pump(t1)
    stats1 = eng.stats_snapshot()
    svc.stop()
    drv.drain()
    window = time.perf_counter() - t0

    # ----------------------------------------------------- what was served
    programs = {r.uid: r for r in [*eng.finished, *(a for a in eng.active if a), *eng.pending]}
    rec = {"t0": t0, "t1": t1, "slots": eng.slots, "stats0": stats0, "stats1": stats1,
           "model": model, "counts": ref, "requests": []}
    for r in drv.reqs:
        p = programs.get(r.uid)
        rec["requests"].append({"submit": r.t_submit, "times": r.times,
                                "admitted": p.admitted_at if p else None,
                                "accepted": p.submitted_at if p else None})
    result_device = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                     "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                     "count": 1,
                     "memory_peak_bytes": (int(torch.cuda.max_memory_allocated(dev))
                                           if dev.type == "cuda" else 0)}
    breakdown = None
    if trace:
        tracer = eng.tel.tracer
        now = time.perf_counter()
        epoch = now - tracer.to_us(now) / 1e6
        rec["spans"] = [(e["name"], epoch + e["ts"] / 1e6, epoch + (e["ts"] + e["dur"]) / 1e6)
                        for e in tracer.events() if e["tid"] != 0]
        rec["steps"] = [(a / 1e9, b / 1e9, n, live) for a, b, n, live in steps]
        if prof is not None:
            a, b, pair = prof_ns
            events = tr.read_events(prof)
            off = tr.clock_offset(events, (a, b), pair)
            spans_ns = [(n, int(s * 1e9) + off, int(e * 1e9) + off) for n, s, e in rec["spans"]]
            steps_ns = [(s + off, e + off, n, live) for s, e, n, live in steps]
            rec["profile"] = tr.reduce(events, (a + off, b + off), steps_ns, spans_ns)
            p = rec["profile"]
            result_device.update(busy_s=p["busy_s"], window_s=p["window_s"])
            breakdown = {"device_ops": p["device_ops"], "idle_gaps": p["idle_gaps"]}
            busy = [b for b, _, _ in p["decode"]] or [float("nan")]
            print(f"profile: {len(events['device'])} device activities, "
                  f"{len(events['runtime'])} runtime calls, {len(p['decode'])} decode steps "
                  f"(device busy {1e3 * float(np.mean(busy)):.3f} ms a step)", file=sys.stderr)
            del events, prof
        if dev.type == "cuda":
            print(f"card: {card_power()}", file=sys.stderr)

    rec["setup_s"] = setup_s
    n_window, n_submitted = window_tokens(rec), len(submitted_in_window(rec))
    metrics = {}
    for m, mod in spec["metrics"]:
        value = mod.read(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    attempted = len(drv.reqs) + drv.submit_failures
    failed = drv.submit_failures + sum(r.reason not in ("complete", "drain") for r in drv.reqs)

    # -------------------------------------------------------------- check
    sample = pick_sample(drv.reqs, config["check"]["sample"], seed)
    del svc, eng, drv.service
    rec = None
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    weights = ref.make_weights(model, seed, dev)
    t_check = time.perf_counter()
    gap, n_tok, gap4 = logit_gaps(ref, model, weights, sample, dev, control)
    del weights
    check = {"logit_gap": {"value": gap, "limit": limit},
             "failed_requests": {"value": failed, "limit": 0}}
    correct = bool(sample) and gap <= limit and failed == 0
    if control:
        # the control's tokens judged by the same comparison
        check["control_gap"] = {"value": gap4, "limit": limit}
    print(f"window: {n_window} tokens landed ({n_window / seconds:.1f} a second), "
          f"{n_submitted} requests submitted", file=sys.stderr)
    print(f"check: {len(sample)} requests, {n_tok} served tokens against the float32 "
          f"reference in {time.perf_counter() - t_check:.1f} s; window {window:.3f} s",
          file=sys.stderr)
    for k, v in check.items():
        print(f"{k} {v['value']} limit {v['limit']}", file=sys.stderr)
    out = {"correct": correct, "attempted": attempted, "failed": failed,
           "metrics": metrics, "device": result_device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    if control:
        out["control_correct"] = bool(sample) and gap4 <= limit
    out["check"] = check
    return out


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name, compared whole, is JAX's or the
    JAX package's (the program's name only begins with the latter's)."""
    return sorted(k for k in sys.modules if k.split(".")[0] in FORBIDDEN)


def card_power() -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"not read ({e!r})"


def percentile(values, q: float) -> float | None:
    """The q-th percentile (numpy's linear rule) of ``values``, None when
    empty."""
    return float(np.percentile(np.asarray(values, dtype=np.float64), q)) if len(values) else None


def window_tokens(rec: dict) -> int:
    """Tokens that landed in their streams inside the window."""
    t0, t1 = rec["t0"], rec["t1"]
    return sum(bisect.bisect_left(r["times"], t1) - bisect.bisect_left(r["times"], t0)
               for r in rec["requests"])


def submitted_in_window(rec: dict) -> list[dict]:
    return [r for r in rec["requests"] if rec["t0"] <= r["submit"] < rec["t1"]]


def spans_in_window(rec: dict, *names: str) -> list[tuple[float, float]]:
    """(start, end) of the spans named ``names`` that start in the window."""
    t0, t1 = rec["t0"], rec["t1"]
    return [(s, e) for n, s, e in rec["spans"] if n in names and t0 <= s < t1]


def steps_in_window(rec: dict) -> list[tuple[float, float, int, int]]:
    return [st for st in rec["steps"] if rec["t0"] <= st[0] < rec["t1"]]
