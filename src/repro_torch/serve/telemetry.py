"""Telemetry plane for the serving stack: tracing + metrics, stdlib-only.

Two halves, deliberately decoupled from the scheduler so every engine
(single-device / sharded / multi-host coordinator) instruments the same
way:

  * ``Tracer`` - a bounded ring of completed spans.  The engines wrap
    request lifecycle edges (submit -> queued -> admit -> prefill/chunk ->
    decode -> finish/evict) and per-round phases (plan build, device
    launch, sample/apply, cache land, page COW copy, snapshot) in
    ``tracer.span(...)``; the multi-host coordinator additionally
    reconstructs worker-side launch spans from the timing slots riding
    the command-header exchange (``Tracer.add``).  ``export()`` emits
    Chrome trace-event JSON ({"traceEvents": [...]}; "X" complete events
    plus "M" process/thread-name metadata) loadable in Perfetto or
    chrome://tracing - one process row per jax process, one thread row
    per engine phase.  When disabled, ``span()`` returns a shared no-op
    context manager: the hot path pays one attribute check.

  * ``MetricsRegistry`` - counters, gauges and fixed-bucket histograms
    (TTFT, per-token latency, queue wait, launch wall time,
    admission-round occupancy, pdq health) rendered in the Prometheus
    text exposition format by ``render()`` (HELP/TYPE lines, cumulative
    ``_bucket{le=...}`` + ``_sum``/``_count`` series, label escaping).
    Histograms also answer ``percentile(q)`` from their buckets for the
    drain/exit printout, and ``merge()`` other histograms losslessly
    (fleet aggregation: per-worker timings fold into one distribution).

The facade ``Telemetry`` bundles one of each with the enable/trace
switches the engines thread from ``ServeConfig``.  Everything here is
thread-safe: the service loop thread records while the HTTP thread
scrapes.
"""
from __future__ import annotations

import bisect
import collections
import json
import math
import threading
import time

# Prometheus-style latency buckets (seconds): sub-millisecond kernels up
# to multi-second cold compiles all land in a finite bucket.
LATENCY_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
                   0.5, 1.0, 2.5, 5.0, 10.0, 30.0)
# admission-round occupancy (requests admitted / slots live per round)
OCCUPANCY_BUCKETS = (0.0, 1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0)
# fraction buckets (e.g. pdq clip-saturation rate per launch)
RATIO_BUCKETS = (0.0001, 0.001, 0.01, 0.05, 0.1, 0.25, 0.5, 1.0)


def _fmt(v: float) -> str:
    """Prometheus sample-value formatting: integral floats print as
    integers, +/-Inf spell Prometheus's '+Inf'/'-Inf'."""
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    if math.isnan(v):
        return "NaN"
    f = float(v)
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def _escape_label(v: str) -> str:
    return (str(v).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _escape_help(v: str) -> str:
    return str(v).replace("\\", "\\\\").replace("\n", "\\n")


def _labels_text(labels: tuple[tuple[str, str], ...],
                 extra: tuple[tuple[str, str], ...] = ()) -> str:
    items = labels + extra
    if not items:
        return ""
    return "{" + ",".join(f'{k}="{_escape_label(v)}"' for k, v in items) + "}"


class Counter:
    """Monotone counter.  ``inc`` is a single float add under the GIL, so
    scrapes racing the serving loop read a consistent (if slightly stale)
    value."""
    kind = "counter"

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        self.value += n

    def samples(self, labels):
        yield "", labels, (), self.value


class Gauge:
    kind = "gauge"

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)

    def inc(self, n: float = 1.0) -> None:
        self.value += n

    def samples(self, labels):
        yield "", labels, (), self.value


class Histogram:
    """Fixed-bucket histogram with Prometheus exposition semantics.

    ``counts[i]`` is the RAW count of observations in bucket i (le =
    ``buckets[i]``); the +Inf overflow rides ``counts[-1]``.  Rendering
    accumulates, so ``_bucket{le="x"}`` is cumulative as Prometheus
    requires; ``merge`` adds raw counts, which can never lose an
    observation (the property test pins sum(counts) == count through any
    observe/merge interleaving)."""
    kind = "histogram"

    __slots__ = ("buckets", "counts", "sum", "count")

    def __init__(self, buckets=LATENCY_BUCKETS):
        bs = sorted(float(b) for b in buckets)
        assert bs and all(b < c for b, c in zip(bs, bs[1:])), buckets
        self.buckets = tuple(bs)
        self.counts = [0] * (len(bs) + 1)         # [-1] is the +Inf bucket
        self.sum = 0.0
        self.count = 0

    def observe(self, v: float) -> None:
        v = float(v)
        self.counts[bisect.bisect_left(self.buckets, v)] += 1
        self.sum += v
        self.count += 1

    def merge(self, other: "Histogram") -> None:
        assert self.buckets == other.buckets, (self.buckets, other.buckets)
        for i, c in enumerate(other.counts):
            self.counts[i] += c
        self.sum += other.sum
        self.count += other.count

    def percentile(self, q: float) -> float:
        """Bucket-resolution quantile (upper bound of the bucket holding
        the q-th observation, linearly interpolated inside it); 0.0 when
        empty.  Good enough for a drain printout; the real distribution
        lives in Prometheus."""
        if self.count == 0:
            return 0.0
        target = q * self.count
        cum = 0
        lo = 0.0
        for i, c in enumerate(self.counts[:-1]):
            hi = self.buckets[i]
            if cum + c >= target:
                frac = (target - cum) / c if c else 1.0
                return lo + frac * (hi - lo)
            cum += c
            lo = hi
        return self.buckets[-1]        # overflow bucket: report the edge

    def samples(self, labels):
        cum = 0
        for i, le in enumerate(self.buckets):
            cum += self.counts[i]
            yield "_bucket", labels, (("le", _fmt(le)),), cum
        yield "_bucket", labels, (("le", "+Inf"),), self.count
        yield "_sum", labels, (), self.sum
        yield "_count", labels, (), self.count


class _Family:
    __slots__ = ("name", "help", "kind", "children")

    def __init__(self, name, help_, kind):
        self.name = name
        self.help = help_
        self.kind = kind
        self.children: dict[tuple, Counter | Gauge | Histogram] = {}


class MetricsRegistry:
    """Name -> metric family; families hold one child per label set.
    Repeated ``counter/gauge/histogram`` calls with the same (name,
    labels) return the SAME child, so hook sites can either cache the
    handle or re-look it up."""

    def __init__(self):
        self._lock = threading.Lock()
        self._families: dict[str, _Family] = {}

    def _child(self, name, help_, kind, ctor, labels):
        key = tuple(sorted((str(k), str(v)) for k, v in labels.items()))
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                fam = self._families[name] = _Family(name, help_, kind)
            assert fam.kind == kind, (name, fam.kind, kind)
            child = fam.children.get(key)
            if child is None:
                child = fam.children[key] = ctor()
            return child

    def counter(self, name: str, help: str = "", **labels) -> Counter:
        return self._child(name, help, "counter", Counter, labels)

    def gauge(self, name: str, help: str = "", **labels) -> Gauge:
        return self._child(name, help, "gauge", Gauge, labels)

    def histogram(self, name: str, help: str = "",
                  buckets=LATENCY_BUCKETS, **labels) -> Histogram:
        return self._child(name, help, "histogram",
                           lambda: Histogram(buckets), labels)

    def get(self, name: str):
        """The family's children dict ({label tuple: metric}) or None."""
        with self._lock:
            fam = self._families.get(name)
            return dict(fam.children) if fam is not None else None

    def render(self) -> str:
        """Prometheus text exposition (version 0.0.4)."""
        out = []
        with self._lock:
            fams = [(f.name, f.help, f.kind,
                     list(f.children.items())) for f in
                    sorted(self._families.values(), key=lambda f: f.name)]
        for name, help_, kind, children in fams:
            if help_:
                out.append(f"# HELP {name} {_escape_help(help_)}")
            out.append(f"# TYPE {name} {kind}")
            for labels, metric in children:
                for suffix, lbl, extra, value in metric.samples(labels):
                    out.append(f"{name}{suffix}"
                               f"{_labels_text(lbl, extra)} {_fmt(value)}")
        return "\n".join(out) + "\n"


# ---------------------------------------------------------------- tracing


class _NullSpan:
    """Shared no-op context manager: the disabled-tracer fast path."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class _Span:
    __slots__ = ("_tracer", "name", "cat", "tid", "args", "_t0")

    def __init__(self, tracer, name, cat, tid, args):
        self._tracer = tracer
        self.name = name
        self.cat = cat
        self.tid = tid
        self.args = args

    def __enter__(self):
        self._t0 = self._tracer.now_us()
        return self

    def __exit__(self, *exc):
        t1 = self._tracer.now_us()
        self._tracer.add(self.name, cat=self.cat, ts=self._t0,
                         dur=t1 - self._t0, tid=self.tid,
                         args=self.args or None)
        return False


class Tracer:
    """Bounded span ring -> Chrome trace-event JSON (Perfetto-loadable).

    Timestamps are microseconds since tracer construction on
    ``time.perf_counter`` (monotonic).  ``add`` accepts retroactive spans
    with an explicit pid: the multi-host coordinator reconstructs worker
    launch spans from the header timing slots (ts = arrival - duration on
    the coordinator clock), so the merged trace carries one process row
    per jax process without any clock-sync machinery - good enough to
    read phase overlap, not for cross-host causality."""

    def __init__(self, *, enabled: bool = False, capacity: int = 65536,
                 pid: int = 0, clock=time.perf_counter):
        self.enabled = enabled
        self.pid = pid
        self._clock = clock
        self._epoch = clock()
        self._lock = threading.Lock()
        self._ring: collections.deque = collections.deque(maxlen=capacity)
        self.dropped = 0
        self._proc_names: dict[int, str] = {}
        self._thread_names: dict[tuple[int, int], str] = {}

    def now_us(self) -> float:
        return (self._clock() - self._epoch) * 1e6

    def to_us(self, t: float) -> float:
        """Convert a raw clock stamp (time.perf_counter by default) to
        trace microseconds."""
        return (t - self._epoch) * 1e6

    def name_process(self, pid: int, name: str) -> None:
        self._proc_names[int(pid)] = str(name)

    def name_thread(self, pid: int, tid: int, name: str) -> None:
        self._thread_names[(int(pid), int(tid))] = str(name)

    def span(self, name: str, *, cat: str = "phase", tid: int = 0, **args):
        if not self.enabled:
            return _NULL_SPAN
        return _Span(self, name, cat, tid, args)

    def add(self, name: str, *, cat: str = "phase", ts: float, dur: float,
            pid: int | None = None, tid: int = 0, args=None) -> None:
        if not self.enabled:
            return
        ev = {"name": str(name), "cat": str(cat), "ph": "X",
              "ts": round(float(ts), 3), "dur": round(max(float(dur), 0.0), 3),
              "pid": int(self.pid if pid is None else pid), "tid": int(tid)}
        if args:
            ev["args"] = {k: (v if isinstance(v, (int, float, str, bool))
                              else str(v)) for k, v in args.items()}
        with self._lock:
            if len(self._ring) == self._ring.maxlen:
                self.dropped += 1
            self._ring.append(ev)

    def events(self) -> list[dict]:
        with self._lock:
            return list(self._ring)

    def export(self) -> dict:
        """The Chrome trace object: span events + M-metadata rows naming
        every (pid, tid) seen, so Perfetto shows 'proc N' process tracks
        with one named thread row per engine phase."""
        spans = self.events()
        pids = sorted({ev["pid"] for ev in spans} | set(self._proc_names))
        tids = sorted({(ev["pid"], ev["tid"]) for ev in spans}
                      | set(self._thread_names))
        meta = []
        for pid in pids:
            meta.append({"name": "process_name", "ph": "M", "pid": pid,
                         "tid": 0, "args": {"name": self._proc_names.get(
                             pid, f"jax process {pid}")}})
        for pid, tid in tids:
            meta.append({"name": "thread_name", "ph": "M", "pid": pid,
                         "tid": tid, "args": {"name": self._thread_names.get(
                             (pid, tid), f"tid {tid}")}})
        return {"traceEvents": meta + spans,
                "displayTimeUnit": "ms",
                "otherData": {"dropped_spans": self.dropped}}

    def write(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.export(), f)
            f.write("\n")


# trace thread rows: one per engine phase, stable ids so every engine's
# trace lines up the same way in Perfetto
TID_REQUEST = 0      # request lifecycle spans (queued/admit/finish)
TID_PLAN = 1         # plan build (host numpy)
TID_LAUNCH = 2       # device launch (prefill/chunk/decode/copy)
TID_APPLY = 3        # sample gather + result apply
TID_SNAPSHOT = 4     # drain snapshot capture
_TID_NAMES = {TID_REQUEST: "requests", TID_PLAN: "plan",
              TID_LAUNCH: "launch", TID_APPLY: "apply",
              TID_SNAPSHOT: "snapshot"}


class Telemetry:
    """One per engine: the metrics registry + tracer pair, plus the
    standard serving metric handles the scheduler hooks feed.  ``enabled``
    gates ALL recording (the <=2% overhead budget is measured against
    this switch); ``trace`` additionally turns on span capture (ring
    memory + a clock read per phase, so it is a separate opt-in via
    ``--trace-out``)."""

    def __init__(self, *, enabled: bool = True, trace: bool = False,
                 pid: int = 0, capacity: int = 65536,
                 clock=time.perf_counter):
        self.enabled = bool(enabled)
        self.metrics = MetricsRegistry()
        self.tracer = Tracer(enabled=self.enabled and bool(trace),
                             capacity=capacity, pid=pid, clock=clock)
        self.tracer.name_process(pid, f"jax process {pid}"
                                 + (" (coordinator)" if pid == 0 else ""))
        for tid, name in _TID_NAMES.items():
            self.tracer.name_thread(pid, tid, name)
        m = self.metrics
        if self.enabled:
            self.ttft = m.histogram(
                "serve_ttft_seconds", "submit -> first token latency")
            self.per_token = m.histogram(
                "serve_per_token_seconds",
                "inter-token latency after the first token")
            self.queue_wait = m.histogram(
                "serve_queue_wait_seconds", "submit -> slot admission wait")
            self.round_occupancy = m.histogram(
                "serve_round_occupancy",
                "live slots at each decode round", buckets=OCCUPANCY_BUCKETS)
            self.shed = m.counter(
                "serve_shed_total",
                "requests shed at the admission watermark (HTTP 429)")
            self.pdq_fallbacks = m.counter(
                "pdq_fallbacks",
                "pdq_guard fp-dequant fallback activations (per guarded "
                "projection per launch)")
            self.pdq_clip_hits = m.counter(
                "pdq_clip_hits", "int8 outputs saturated at the clip edges")
            self.pdq_clip_total = m.counter(
                "pdq_clip_total", "int8 outputs checked for clip saturation")
            self.pdq_clip_rate = m.gauge(
                "pdq_clip_rate",
                "cumulative int8 clip-saturation rate (hits / total)")

    def span(self, name: str, *, cat: str = "phase", tid: int = TID_LAUNCH,
             **args):
        return self.tracer.span(name, cat=cat, tid=tid, **args)

    def launch_histogram(self, kind: str, process: int | None = None
                         ) -> Histogram:
        """Per-kind (and, fleet-aggregated, per-process) launch wall-time
        histogram; created lazily so only kinds that actually run
        appear in /metrics."""
        labels = {"kind": kind}
        if process is not None:
            labels["process"] = str(process)
        return self.metrics.histogram(
            "serve_launch_seconds", "device launch wall time", **labels)

    def observe_pdq(self, fallbacks: float, clip_hits: float,
                    clip_total: float) -> None:
        """Fold one launch's device-side pdq health summary (rode the
        existing token gather; see kernels/ops.pdq_telemetry)."""
        if not self.enabled:
            return
        self.pdq_fallbacks.inc(float(fallbacks))
        self.pdq_clip_hits.inc(float(clip_hits))
        self.pdq_clip_total.inc(float(clip_total))
        if self.pdq_clip_total.value > 0:
            self.pdq_clip_rate.set(
                self.pdq_clip_hits.value / self.pdq_clip_total.value)

    def summary(self) -> dict:
        """Drain/exit printout payload: p50/p90/p99 of the latency
        histograms (seconds)."""
        out = {}
        if not self.enabled:
            return out
        for key, h in (("ttft", self.ttft), ("per_token", self.per_token),
                       ("queue_wait", self.queue_wait)):
            out[key] = {"count": h.count,
                        "p50": h.percentile(0.50),
                        "p90": h.percentile(0.90),
                        "p99": h.percentile(0.99)}
        return out
