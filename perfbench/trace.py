"""Reduction of a ``torch.profiler`` trace of a sub-window of the run to the
device's busy time, its idle gaps and the decode steps' device time.

Times are nanoseconds on the profiler's clock, the Unix epoch;
``clock_offset`` moves host spans taken with ``perf_counter`` onto it, so
that they can be laid over the kernels.
"""
from __future__ import annotations

import time

import numpy as np


def clock_pair() -> tuple[int, int]:
    """(perf_counter ns, epoch ns) read together."""
    a = time.perf_counter_ns()
    b = time.time_ns()
    c = time.perf_counter_ns()
    return (a + c) // 2, b


def union(iv: np.ndarray) -> np.ndarray:
    """Merged, sorted intervals of ``iv`` (n, 2)."""
    iv = np.asarray(iv, dtype=np.int64).reshape(-1, 2)
    if not len(iv):
        return iv
    iv = iv[np.argsort(iv[:, 0], kind="stable")]
    ends = np.maximum.accumulate(iv[:, 1])
    first = np.ones(len(iv), dtype=bool)
    first[1:] = iv[1:, 0] > ends[:-1]
    idx = np.flatnonzero(first)
    last = np.r_[idx[1:] - 1, len(iv) - 1]
    return np.stack([iv[idx, 0], ends[last]], axis=1)


def clip(iv: np.ndarray, lo: int, hi: int) -> np.ndarray:
    """``iv`` cut to [lo, hi), empty pieces dropped."""
    iv = np.clip(iv, lo, hi)
    return iv[iv[:, 1] > iv[:, 0]]


def read_events(prof) -> dict:
    """Device activities (kernels, copies, fills) and CUDA runtime calls of a
    stopped ``torch.profiler.profile``: names, [start, end) ns, correlation
    ids."""
    from torch.autograd import DeviceType
    dev, rt = [], []
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() == DeviceType.CUDA:
            dev.append((ev.name(), ev.start_ns(), ev.end_ns(), ev.correlation_id()))
        elif ev.name().startswith("cuda"):
            rt.append((ev.name(), ev.start_ns(), ev.end_ns(), ev.correlation_id()))
    return {"device": dev, "runtime": rt}


def clock_offset(events: dict, window_pc: tuple[int, int], pair: tuple[int, int]) -> int:
    """Add to a ``perf_counter_ns`` reading to get the profiler's clock
    (the epoch's offset, from ``clock_pair``); raises when the device
    activities' median does not fall inside the profiled window so
    moved."""
    off = pair[1] - pair[0]
    starts = [e[1] for e in events["device"]]
    lo, hi = window_pc
    if starts and not lo + off - 1e9 <= float(np.median(starts)) <= hi + off + 1e9:
        raise RuntimeError("the profiler's clock is not the epoch")
    return off


def reduce(events: dict, window: tuple[int, int], steps, spans, top: int = 10) -> dict:
    """The profiled window [start, end) on the profiler's clock, the
    decode ``steps`` ((start, end, rows, live) host intervals on that clock)
    and the host ``spans`` ((name, start, end) on that clock) ->

    * ``window_s``, ``busy_s``: the window and the union of every device
      activity inside it;
    * ``device_ops``: the ``top`` activity names by device seconds;
    * ``idle_gaps``: idle device seconds by the host span they fall in
      (the span over each gap's middle, ``none`` outside every span), the
      ``top`` labels;
    * ``decode``: (busy s, rows, live) of each decode step wholly inside
      the window: the union of the device activities its graph launch
      (``cudaGraphLaunch``) correlates with.
    """
    lo, hi = window
    dev = events["device"]
    merged = clip(union([(s, e) for _, s, e, _ in dev]), lo, hi)
    busy = int((merged[:, 1] - merged[:, 0]).sum()) if len(merged) else 0

    by_name: dict[str, int] = {}
    for name, s, e, _ in dev:
        s, e = max(s, lo), min(e, hi)
        if e > s:
            by_name[name] = by_name.get(name, 0) + e - s
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]

    # the loop thread's phase spans follow one another: the last one to
    # start before a gap's middle is the only one that can hold it
    sp = sorted((s, e, n) for n, s, e in spans)
    sp_starts = np.asarray([s for s, _, _ in sp], dtype=np.int64)
    gaps: dict[str, int] = {}
    edges = np.concatenate([[lo], merged.reshape(-1), [hi]]).reshape(-1, 2)
    for s, e in edges:
        if e <= s:
            continue
        mid = (s + e) // 2
        i = int(np.searchsorted(sp_starts, mid, side="right")) - 1
        label = sp[i][2] if i >= 0 and mid < sp[i][1] else "none"
        gaps[label] = gaps.get(label, 0) + int(e - s)
    idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:top]

    launches = sorted((s, c) for name, s, _, c in events["runtime"]
                      if name.startswith("cudaGraphLaunch"))
    graph = {c for _, c in launches}
    per_corr: dict[int, list] = {}
    for _, s, e, c in dev:
        if c in graph:
            per_corr.setdefault(c, []).append((s, e))
    decode = []
    for st in steps:
        if st[0] < lo or st[1] > hi:
            continue
        cs = [c for s, c in launches if st[0] <= s < st[1]]
        if len(cs) == 1 and cs[0] in per_corr:
            u = union(per_corr[cs[0]])
            decode.append((float((u[:, 1] - u[:, 0]).sum()) / 1e9, st[2], st[3]))
    return {"window_s": (hi - lo) / 1e9, "busy_s": busy / 1e9,
            "device_ops": [[n, v / 1e9] for n, v in ops],
            "idle_gaps": [[n, v / 1e9] for n, v in idle],
            "decode": decode}
