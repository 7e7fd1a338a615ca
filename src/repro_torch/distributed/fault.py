"""Fault handling (port of ``repro/distributed/fault.py``): elastic
resharding, failure bookkeeping, the straggler EMA, deadline watchdogs,
scheduler snapshots, and the deterministic fault-injection harness.

  * ``reshard_state`` / ``gather_state`` - a train state's whole logical
    arrays (a checkpoint's, any mesh's) to this rank's blocks on a mesh,
    and the blocks of every rank back to whole arrays on one rank: so a
    checkpoint written over one mesh restores over another.

  * ``DeadlineWatchdog`` - a context manager arming a timer around any
    blocking launch; on expiry it runs a callback (default: print a typed
    ABORT line and ``os._exit(EXIT_DEADLINE)``) because a thread blocked
    inside a C++ call cannot be interrupted from Python.
  * ``save_snapshot`` / ``load_snapshot`` - the scheduler's pure-numpy
    drain record (serve/core.SchedulerCore.snapshot) to/from a file, so a
    preempted server can requeue in-flight work after a restart.
  * ``FaultPlan`` / ``FaultInjector`` - deterministic fault injection
    threaded through the serving engines behind no-op-by-default hooks:
    NaN a request's logits block, raise in a launch, inject virtual
    straggler delay, preempt at a round, and the ingress faults of the
    service (bursts, disconnects, stalled readers).  Everything keys off
    round/sequence COUNTERS, never wall-clock, so replays are exact.  The
    multi-process faults (kill, hang, corrupt a command header) fire in
    ``on_broadcast``, which ``serve/multihost.py`` calls on every command
    header.
"""
from __future__ import annotations

import dataclasses
import io
import os
import sys
import threading
import time

import numpy as np

from repro_torch import tree as tr

# typed process exit codes: the launcher / test harness reads these to tell
# an injected kill from a watchdog abort from an ordinary crash
EXIT_DEADLINE = 87     # DeadlineWatchdog expired (hung collective / dead peer)
EXIT_KILLED = 41       # FaultPlan kill_* injection


def reshard_state(state, target_mesh, spec_tree):
    """Elastic scaling: this rank's blocks of a whole ``state`` (numpy
    arrays or tensors, e.g. a restored checkpoint) on ``target_mesh``, as
    contiguous tensors on the rank's mesh entry.  The specs are logical
    (axis names), so they transfer between meshes."""
    import torch

    from repro_torch.distributed.sharding import block
    from repro_torch.launch.mesh import mesh_coords
    coords = mesh_coords(target_mesh)
    if coords is None:
        raise ValueError("this process holds no entry of the target mesh")
    dev = target_mesh.devices[coords["data"], coords["model"]]

    def place(x, spec):
        t = x if torch.is_tensor(x) else torch.from_numpy(np.asarray(x))
        return t[block(spec, t.shape, target_mesh, coords)].to(dev).contiguous().clone()

    return tr.tree_map(place, state, spec_tree)


def gather_state(state, mesh, spec_tree):
    """The inverse of ``reshard_state``: every rank's blocks joined into
    whole host tensors on the mesh's first rank, a leaf at a time; None on
    the other ranks.  Collective over the mesh."""
    from repro_torch.distributed import collectives as coll
    from repro_torch.distributed.sharding import axis_size, block
    from repro_torch.launch.mesh import mesh_groups
    g = mesh_groups(mesh)
    ranks = sorted(int(r) for r in mesh.processes.flat)
    where = {int(mesh.processes[d, m]): {"data": d, "model": m}
             for d in range(mesh.processes.shape[0]) for m in range(mesh.processes.shape[1])}
    out = []
    for (path, x), spec in zip(tr.leaves_with_path(state), tr.leaves(spec_tree)):
        parts = coll.gather_to(x, g.world)
        if parts is None:
            continue
        shape = [n * axis_size(mesh, e) for n, e in
                 zip(x.shape, tuple(spec) + (None,) * (x.dim() - len(spec)))]
        whole = parts[0].new_empty(shape)
        for r, part in zip(ranks, parts):
            whole[block(spec, shape, mesh, where[r])] = part
        out.append(whole)
    if coll.index(g.world) != 0:
        return None
    return tr.unflatten_like(state, out)


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
# Deadline watchdogs
# ---------------------------------------------------------------------------


def _default_deadline_abort(reason: str, seconds: float) -> None:
    sys.stderr.write(
        f"FATAL ABORT_DEADLINE: {reason} exceeded its {seconds:g}s deadline "
        f"(hung collective or dead peer); exiting {EXIT_DEADLINE}\n")
    sys.stderr.flush()
    os._exit(EXIT_DEADLINE)


class DeadlineWatchdog:
    """Arm a timer around a blocking launch; fire ``on_timeout`` on expiry.

    A Python thread blocked inside a gloo/XLA collective cannot be
    interrupted, so the only way to bound a hung rendezvous is a SIDE
    thread that declares the process dead: the default handler prints a
    typed ``ABORT_DEADLINE`` line and ``os._exit``s with ``EXIT_DEADLINE``
    so the launcher (launch/serve.py) tears the fleet down and reports
    which process timed out.  A custom ``on_timeout(reason, seconds)`` can
    first dump the scheduler snapshot (the coordinator does: host-side
    scheduler state is consistent between result applications, so the
    drain record is valid even while the main thread is stuck in a
    collective).

    ``seconds=None`` disarms (context manager becomes a no-op)."""

    def __init__(self, seconds: float | None, *, reason: str = "collective",
                 on_timeout=None):
        self.seconds = seconds
        self.reason = reason
        self.on_timeout = on_timeout or _default_deadline_abort
        self._timer: threading.Timer | None = None
        self.fired = False

    def _fire(self):
        self.fired = True
        self.on_timeout(self.reason, self.seconds)

    def __enter__(self):
        if self.seconds is not None:
            self._timer = threading.Timer(self.seconds, self._fire)
            self._timer.daemon = True
            self._timer.start()
        return self

    def __exit__(self, *exc):
        if self._timer is not None:
            self._timer.cancel()
            self._timer = None
        return False


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


@dataclasses.dataclass
class FaultPlan:
    """Declarative, deterministic fault schedule for one serving run.

    All triggers are counters (scheduler round, protocol command seq),
    never wall-clock.  JSON-serializable (``dataclasses.asdict``) so
    subprocess test fixtures can ship one over argv.
    """
    # NaN a request's logits block: every launch of ``nan_kind`` whose
    # batch carries ``nan_uid`` gets that row's logits poisoned.
    nan_uid: int | None = None
    nan_kind: str = "any"             # 'prefill' | 'decode' | 'any'
    # raise RuntimeError right before a launch of this kind at this round
    raise_kind: str | None = None
    raise_round: int = 0
    # virtual straggler delays: {round: extra_seconds} added to launch
    # timings (never actually slept); ``delay_kind`` scopes them to one
    # launch kind ('prefill' | 'chunked' | 'decode') so prefill- and
    # decode-straggler EMAs can be exercised independently
    delay_rounds: dict = dataclasses.field(default_factory=dict)
    delay_kind: str = "any"
    # coordinator preemption (SIGTERM stand-in): request a drain at round N
    preempt_at_round: int | None = None
    # multi-host process faults, gated on (process id, command seq):
    kill_process: int | None = None   # os._exit(EXIT_KILLED) before seq
    kill_at_seq: int = 0
    hang_process: int | None = None   # sleep(hang_seconds) before seq
    hang_at_seq: int = 0
    hang_seconds: float = 3600.0
    corrupt_header_at_seq: int | None = None   # coordinator ships opcode 99
    # ingress faults (service front door):
    # {round: [[prompt_len, max_new], ...]} - deterministic client burst
    # submitted at the top of that round (prompts are derived from the
    # round number, so replays are exact)
    burst_rounds: dict = dataclasses.field(default_factory=dict)
    disconnect_uid: int | None = None  # sever this client mid-stream ...
    disconnect_after: int = 1          # ... once it has this many tokens
    stall_uid: int | None = None       # stalled-reader stream: tiny buffer
    stall_cap: int = 4

    def injector(self) -> "PlanInjector":
        return PlanInjector(self)


class PlanInjector(FaultInjector):
    """Executes a ``FaultPlan`` at the engine hook points."""

    def __init__(self, plan: FaultPlan):
        self.plan = plan

    def on_round(self, rnd: int) -> None:
        p = self.plan
        if p.preempt_at_round is not None and rnd >= p.preempt_at_round:
            self.engine.request_drain()

    def on_exec(self, kind: str, rnd: int) -> None:
        p = self.plan
        if p.raise_kind == kind and rnd >= p.raise_round:
            p.raise_kind = None       # one-shot: later launches succeed
            raise RuntimeError(f"injected {kind} launch fault at round {rnd}")

    def exec_delay(self, kind: str, rnd: int) -> float:
        if self.plan.delay_kind not in (kind, "any"):
            return 0.0
        return float(self.plan.delay_rounds.get(rnd, 0.0))

    def poison_rows(self, kind: str, plan) -> list[int]:
        p = self.plan
        if p.nan_uid is None or p.nan_kind not in (kind, "any"):
            return []
        uids, steps = plan.row_uids, plan.row_steps
        live = getattr(plan, "live", None)
        return [i for i, u in enumerate(uids)
                if int(u) == p.nan_uid and (live is None or i in live)
                and (steps[i] >= 0)]

    def on_broadcast(self, seq: int, header: np.ndarray) -> np.ndarray:
        p, eng = self.plan, self.engine
        pid = getattr(eng, "process_id", 0)
        if p.kill_process == pid and seq >= p.kill_at_seq:
            sys.stderr.write(f"FAULT-INJECTION: killing process {pid} at "
                             f"command seq {seq}\n")
            sys.stderr.flush()
            os._exit(EXIT_KILLED)
        if p.hang_process == pid and seq >= p.hang_at_seq:
            sys.stderr.write(f"FAULT-INJECTION: hanging process {pid} at "
                             f"command seq {seq}\n")
            sys.stderr.flush()
            time.sleep(p.hang_seconds)
        if (p.corrupt_header_at_seq is not None and pid == 0
                and seq >= p.corrupt_header_at_seq):
            p.corrupt_header_at_seq = None    # one-shot
            header = np.array(header)
            header[0] = 99                    # not a real opcode
        return header

    def ingress_burst(self, rnd: int) -> list:
        spec = self.plan.burst_rounds.pop(rnd, None) if self.plan.burst_rounds \
            else None
        if not spec:
            return []
        vocab = int(getattr(self.engine.cfg, "vocab", 256))
        out = []
        for i, (plen, max_new) in enumerate(spec):
            rng = np.random.default_rng(1000 * rnd + i)
            prompt = rng.integers(0, vocab, size=int(plen)).astype(np.int32)
            out.append((prompt, int(max_new)))
        return out

    def drop_stream(self, uid: int, n_tokens: int) -> bool:
        p = self.plan
        return p.disconnect_uid == uid and n_tokens >= p.disconnect_after

    def stream_cap(self, uid: int) -> int | None:
        p = self.plan
        return p.stall_cap if p.stall_uid == uid else None
