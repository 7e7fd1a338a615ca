"""The JAX-free part of the reference's fault handling that the serving
scheduler imports: failure bookkeeping, the straggler EMA, scheduler
snapshots, and the no-op fault-injection hook set.

Copied from ``repro/distributed/fault.py`` (which also holds mesh
resharding and needs JAX); the deterministic ``FaultPlan`` injector and the
deadline watchdog arrive with the fault-handling slice.
"""
from __future__ import annotations

import dataclasses
import io
import os
import time

import numpy as np

@dataclasses.dataclass
class StragglerWatchdog:
    """EMA step-time tracker: flags steps (hosts) slower than factor x EMA.

    On a fleet, per-host step times arrive via the coordination service;
    here the serving loop feeds its own round timings (serve/core.py
    observes every decode launch; tests inject synthetic delays through
    ``FaultPlan.delay_rounds``)."""
    factor: float = 3.0
    ema: float | None = None
    flagged: int = 0
    history: list = dataclasses.field(default_factory=list)

    def observe(self, dt: float) -> bool:
        slow = self.ema is not None and dt > self.factor * self.ema
        self.ema = dt if self.ema is None else 0.9 * self.ema + 0.1 * dt
        self.flagged += int(slow)
        self.history.append((dt, slow))
        return slow


@dataclasses.dataclass
class FailureLog:
    events: list = dataclasses.field(default_factory=list)

    def record(self, step: int, kind: str, detail: str = ""):
        self.events.append({"t": time.time(), "step": step, "kind": kind,
                            "detail": detail})

    def count(self, kind: str | None = None) -> int:
        return len([e for e in self.events if kind is None or e["kind"] == kind])



# ---------------------------------------------------------------------------
# Scheduler snapshots (drain-and-requeue records)
# ---------------------------------------------------------------------------
#
# A snapshot is a plain dict of numpy arrays / python scalars (built by
# serve/core.SchedulerCore.snapshot): request records for finished,
# in-flight and pending work plus the scheduler's counters.  In-flight
# requests are requeued and REGENERATED deterministically on resume
# (sampling keys derive from (uid, step), so token n of a request is the
# same computation whether or not the run was interrupted) - that is what
# makes a killed-and-resumed run token-for-token equal to an uninterrupted
# one without shipping cache pages.


def save_snapshot(path: str, snap: dict) -> None:
    """Write a scheduler snapshot atomically (tmp + rename: a watchdog
    firing mid-write must not leave a truncated record for the resume)."""
    buf = io.BytesIO()
    np.save(buf, np.asarray(snap, dtype=object), allow_pickle=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(buf.getvalue())
    os.replace(tmp, path)


def load_snapshot(path: str) -> dict:
    snap = np.load(path, allow_pickle=True).item()
    assert isinstance(snap, dict) and "version" in snap, (
        f"{path} is not a scheduler snapshot")
    return snap


# ---------------------------------------------------------------------------
# Deterministic fault injection
# ---------------------------------------------------------------------------


class FaultInjector:
    """No-op hook set threaded through the serving engines.

    The engines call these at fixed points; the default implementation
    does nothing, so production runs pay one virtual call per launch.
    Deterministic subclasses (see ``FaultPlan.injector``) key off the
    scheduler round / protocol sequence counters."""

    engine = None

    def bind(self, engine) -> None:
        """Called once by the engine at construction."""
        self.engine = engine

    def on_round(self, rnd: int) -> None:
        """Start of each scheduler round (serve/core.run loop)."""

    def on_exec(self, kind: str, rnd: int) -> None:
        """Immediately before a device launch ('prefill'/'chunked'/'decode').
        Raising here is treated as a launch failure (request isolation)."""

    def exec_delay(self, kind: str, rnd: int) -> float:
        """Virtual extra seconds added to the observed launch time (feeds
        the straggler watchdog deterministically)."""
        return 0.0

    def poison_rows(self, kind: str, plan) -> list[int]:
        """Batch rows whose logits should be overwritten with NaN before
        sampling (single-process engines only; models a corrupted kernel
        epilogue)."""
        return []

    def on_broadcast(self, seq: int, header: np.ndarray) -> np.ndarray:
        """Multi-host: before contributing to the command-header exchange.
        May sleep (hung collective), exit (process kill), or return a
        mutated header (corruption).  Called on every process; gate on
        ``self.engine.process_id``."""
        return header

    # ---- ingress faults (serve/service.ServeService hook points) ----

    def ingress_burst(self, rnd: int) -> list:
        """Extra ``(prompt, max_new)`` pairs the service submits at the top
        of round ``rnd`` - a deterministic client stampede for overload
        tests.  Submissions past the admission watermark are shed (counted
        in stats) exactly like external ones."""
        return []

    def drop_stream(self, uid: int, n_tokens: int) -> bool:
        """Return True to sever request ``uid``'s client after it has
        received ``n_tokens`` tokens (models a mid-stream disconnect; the
        service turns it into ``cancel(uid, kind='disconnect')``)."""
        return False

    def stream_cap(self, uid: int) -> int | None:
        """Override the per-stream token-buffer bound for ``uid`` (models a
        stalled SSE reader: a tiny cap overflows after a few tokens and the
        service cancels with ``kind='slow_consumer'``).  None = default."""
        return None
