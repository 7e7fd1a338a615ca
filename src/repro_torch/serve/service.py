"""Streaming serving service: continuous admission over a SchedulerCore
(port of ``repro/serve/service.py``; the loop thread binds the engine's
device first, ``engine.bind_thread``, so that a CUDA engine's graph replays
run on its card from that thread).

``run()`` is a run-to-drain library loop - fine for batch jobs, useless as
a front door: requests arrive continuously, clients hang up, queues grow
without bound.  ``ServeService`` wraps ANY serving engine (single-device,
sharded, or the multi-host coordinator) in a background step-loop thread
that admits from the pending queue EVERY round, with a thread-safe
submit/result handoff:

  * ``submit()`` validates, applies the overload watermark (a bounded
    admission queue: past ``max_pending`` queued requests the submit is
    SHED with a typed ``OverloadedError`` -> HTTP 429 + Retry-After,
    counted in ``engine.stats['shed']`` - pending never grows without
    bound), then hands the request to the loop thread.  The caller gets a
    ``TokenStream``.
  * per-uid token streams are fed from the scheduler's own apply path
    (``SchedulerCore.on_token``/``on_finish`` observers fire inside
    ``_apply_prefill``/``_apply_chunked``/``_apply_decode``), so the
    streamed tokens are EXACTLY the engine's tokens: sampling keys are
    per-(uid, step), which makes a continuously-admitted stream
    token-for-token equal to the same request through batch ``run()``.
  * cancellation (client disconnect, per-request deadline, slow consumer)
    propagates into the scheduler as the first-class ``cancel(uid)``:
    queued cancels apply at the next round boundary, evicting only their
    own request through the PR-6 isolation path - peers stay bit-exact.
    With the N-step decode fast path (``decode_steps > 1``) a "round" is
    one DISPATCH of up to N tokens per row: cancels, deadline sweeps and
    stream flushes quantize to dispatch boundaries (a mid-block cancel
    still delivers the block's already-sampled tokens first, exactly the
    tokens an N=1 engine would have produced), and peer streams stay
    token-identical because sampling keys are per-(uid, step).
  * a stalled consumer cannot wedge the fleet: stream buffers are bounded
    (``max_stream_buffer``) and an overflowing stream cancels ITS request
    with a ``slow_consumer`` finish, nothing else.
  * ``request_drain()`` (SIGTERM/SIGINT path) stops the loop at a round
    boundary: every unfinished request's stream gets a typed ``drain``
    finish event, the scheduler snapshot is written (``snapshot_path``),
    and ``--resume`` requeues the work token-exactly.

Ingress faults (burst, mid-stream disconnect, slow reader) are injectable
through the engine's ``FaultInjector`` so overload behaviour is
deterministically testable (distributed/fault.py).
"""
from __future__ import annotations

import collections
import threading
import time

import numpy as np

from repro_torch.distributed.fault import save_snapshot

from .core import EngineDraining, Request

__all__ = ["OverloadedError", "ServeService", "TokenStream"]


class OverloadedError(RuntimeError):
    """Admission watermark exceeded: the request was shed (HTTP 429)."""

    def __init__(self, pending: int, watermark: int, retry_after: float):
        self.retry_after = float(retry_after)
        super().__init__(
            f"admission queue at {pending} >= watermark {watermark}: "
            f"request shed, retry after {retry_after:g}s")


class TokenStream:
    """Thread-safe per-request token/finish buffer bridging the scheduler
    thread to a consumer (HTTP handler, test, or nobody).

    The producer side (``push_*``) is called on the scheduler loop thread
    and never blocks: a consumer that stops draining past ``max_buffer``
    undelivered tokens marks the stream overflowed, and the service
    cancels the request (``slow_consumer``) instead of stalling the fleet.
    Consumers either poll ``drain()`` with a waker (the SSE path) or block
    on ``result()``."""

    def __init__(self, uid: int, max_buffer: int = 512):
        self.uid = uid
        self.max_buffer = int(max_buffer)
        self._lock = threading.Lock()
        self._buf: list[int] = []
        self._finish: tuple[str, str | None] | None = None
        self._wakers: list = []
        self.overflowed = False
        self.submitted_at = time.perf_counter()
        self.first_token_at: float | None = None

    # ------------------------------------------------------------- producer
    def _notify(self, wakers) -> None:
        # wakers are advisory: a consumer whose event loop already closed
        # (an SSE handler racing shutdown) must not crash the scheduler
        # thread - its request finishes or drains regardless
        for w in wakers:
            try:
                w()
            except Exception:
                pass

    def push_token(self, tok: int) -> bool:
        """Append one token; False = the bounded buffer overflowed (the
        token is dropped and the stream is marked; the service cancels)."""
        with self._lock:
            if self._finish is not None or self.overflowed:
                return True                     # already closed: ignore
            if len(self._buf) >= self.max_buffer:
                self.overflowed = True
                return False
            if self.first_token_at is None:
                self.first_token_at = time.perf_counter()
            self._buf.append(int(tok))
            wakers = list(self._wakers)
        self._notify(wakers)
        return True

    def push_finish(self, reason: str, error: str | None) -> None:
        with self._lock:
            if self._finish is None:
                self._finish = (reason, error)
            wakers = list(self._wakers)
        self._notify(wakers)

    # ------------------------------------------------------------- consumer
    def add_waker(self, fn) -> None:
        """Register a zero-arg callable fired (outside the lock) after
        every push; pair with ``drain()``: clear-then-drain-then-wait."""
        with self._lock:
            self._wakers.append(fn)

    def drain(self) -> tuple[list[int], tuple[str, str | None] | None]:
        """Take every undelivered token; the finish tuple (reason, error)
        rides along once the request left the engine, else None."""
        with self._lock:
            toks, self._buf = self._buf, []
            return toks, self._finish

    @property
    def finished(self) -> bool:
        with self._lock:
            return self._finish is not None

    def result(self, timeout: float | None = None
               ) -> tuple[list[int], str, str | None]:
        """Block until the request finishes; returns
        ``(tokens, finish_reason, error)``."""
        ev = threading.Event()
        self.add_waker(ev.set)
        deadline = None if timeout is None else time.monotonic() + timeout
        toks: list[int] = []
        while True:
            ev.clear()
            got, fin = self.drain()
            toks.extend(got)
            if fin is not None:
                return toks, fin[0], fin[1]
            left = None if deadline is None else deadline - time.monotonic()
            if left is not None and left <= 0:
                raise TimeoutError(
                    f"request uid={self.uid} unfinished after {timeout:g}s")
            ev.wait(left)


class ServeService:
    """Continuous-admission driver: one background thread owns the
    scheduler; submits, cancels and drain requests cross over thread-safe
    queues applied at round boundaries (the scheduler itself stays
    single-threaded, exactly as under ``run()``)."""

    def __init__(self, engine, *, max_pending: int = 32,
                 retry_after: float = 0.5, max_stream_buffer: int = 512,
                 idle_wait: float = 0.05, extras=None):
        self.engine = engine
        self.max_pending = int(max_pending)
        self.retry_after = float(retry_after)
        self.max_stream_buffer = int(max_stream_buffer)
        self.idle_wait = float(idle_wait)
        self.extras = extras
        engine.on_token = self._on_token
        engine.on_finish = self._on_finish
        self._mutex = threading.Lock()      # ingress/cancel/stream tables
        self._ingress: collections.deque[Request] = collections.deque()
        self._cancels: collections.deque[tuple[int, str, str]] = \
            collections.deque()
        self._streams: dict[int, TokenStream] = {}
        self._next_uid = 0
        self._wake = threading.Event()
        self._stopped = threading.Event()
        self._thread: threading.Thread | None = None
        self.error: BaseException | None = None

    # ------------------------------------------------------------ lifecycle
    def start(self) -> "ServeService":
        assert self._thread is None, "service already started"
        self._thread = threading.Thread(target=self._loop_guarded,
                                        name="serve-loop", daemon=True)
        self._thread.start()
        return self

    def request_drain(self) -> None:
        """SIGTERM/SIGINT path: stop at the next round boundary; unfinished
        streams get a typed ``drain`` finish and the snapshot is written."""
        self.engine.request_drain()
        self._wake.set()

    def join(self, timeout: float | None = None) -> None:
        self._stopped.wait(timeout)
        if self._thread is not None:
            self._thread.join(timeout)

    def stop(self, timeout: float | None = 60.0) -> None:
        self.request_drain()
        self.join(timeout)
        if self.error is not None:
            raise self.error

    @property
    def draining(self) -> bool:
        return self.engine.drained

    # ------------------------------------------------------------ admission
    def _pending_total(self) -> int:
        return len(self._ingress) + len(self.engine.pending)

    def submit(self, prompt, *, max_new: int = 16,
               deadline_s: float | None = None, uid: int | None = None,
               stream: bool = True) -> TokenStream | Request:
        """Thread-safe submit from any thread.  Raises ``EngineDraining``
        once a drain was requested (HTTP 503), ``OverloadedError`` past the
        admission watermark (HTTP 429), ``ValueError`` for malformed or
        oversized prompts (HTTP 400).  Returns the request's
        ``TokenStream`` (or, with ``stream=False``, the bare ``Request`` -
        a headless submit nobody consumes, used by burst injection)."""
        eng = self.engine
        p = np.asarray(prompt)
        if p.ndim != 1 or p.size == 0 or not np.issubdtype(p.dtype,
                                                           np.integer):
            raise ValueError(
                f"malformed prompt: shape {p.shape}, dtype {p.dtype} "
                "(need a non-empty 1-D integer array)")
        eng._validate(int(p.size))          # oversized prompts: reject here
        eng._validate_extras(int(p.size), self.extras)
        deadline = (None if deadline_s is None
                    else eng._clock() + float(deadline_s))
        with self._mutex:
            if eng.drained or self._stopped.is_set():
                raise EngineDraining(
                    "service is draining: new submissions are rejected")
            if self._pending_total() >= self.max_pending:
                with eng.stats_lock:
                    eng.stats["shed"] += 1
                if eng.tel.enabled:
                    eng.tel.shed.inc()
                raise OverloadedError(self._pending_total(),
                                      self.max_pending, self.retry_after)
            if uid is None:
                uid = self._next_uid
            self._next_uid = max(self._next_uid, uid + 1)
            req = Request(uid=uid, prompt=p.astype(np.int32),
                          max_new=int(max_new), deadline=deadline)
            if eng.tel.enabled:
                # queue-wait/TTFT clock starts at ACCEPTANCE, not at the
                # loop thread's pickup - the client is waiting from here
                req.submitted_at = time.perf_counter()
            if stream:
                cap = eng.fault.stream_cap(uid)
                tstream = TokenStream(
                    uid, cap if cap is not None else self.max_stream_buffer)
                self._streams[uid] = tstream
            self._ingress.append(req)
        self._wake.set()
        return tstream if stream else req

    def cancel(self, uid: int, *, kind: str = "cancel",
               reason: str = "cancelled by client") -> None:
        """Queue a cancellation; the loop applies it at the next round
        boundary (pending: dropped; in-flight: evicted alone)."""
        with self._mutex:
            self._cancels.append((uid, kind, reason))
        self._wake.set()

    def stats(self) -> dict:
        # stats_snapshot copies under the engine's stats lock: the loop
        # thread mutates counters (and list cells) while HTTP handlers
        # serialize, so an unlocked dict/list walk could see a partially
        # updated structure mid-scrape
        eng = self.engine
        out = eng.stats_snapshot()
        out.update(round=eng._round, pending=self._pending_total(),
                   active=sum(r is not None for r in eng.active),
                   free_slots=eng._free_total(), slots=eng.slots,
                   draining=eng.drained, watermark=self.max_pending)
        return out

    def events(self) -> list[dict]:
        """The structured failure/eviction/preemption/straggler event
        ring, snapshot under the stats lock (JSONL via /v1/events)."""
        return self.engine.events_snapshot()

    def metrics_text(self) -> str:
        """Prometheus text exposition of the engine's metric registry."""
        return self.engine.tel.metrics.render()

    def trace(self) -> dict:
        """The Chrome-trace-event object collected so far."""
        return self.engine.tel.tracer.export()

    # ------------------------------------------------------ engine observers
    # called ON the scheduler loop thread, inside the _apply_* paths
    def _on_token(self, req: Request, tok: int) -> None:
        eng = self.engine
        if eng.fault.drop_stream(req.uid, len(req.generated)):
            # injected mid-stream client disconnect (deterministic tests)
            self._cancels.append((req.uid, "disconnect",
                                  "injected mid-stream disconnect"))
            return
        stream = self._streams.get(req.uid)
        if stream is None:
            return                      # headless request (burst / resume)
        if not stream.push_token(tok):
            self._cancels.append(
                (req.uid, "slow_consumer",
                 f"stream buffer overflowed ({stream.max_buffer} "
                 "undelivered tokens): consumer stalled"))

    def _on_finish(self, req: Request) -> None:
        with self._mutex:
            stream = self._streams.pop(req.uid, None)
        if stream is not None:
            stream.push_finish(req.finish_reason or "complete", req.error)

    # ------------------------------------------------------------- the loop
    def _loop_guarded(self) -> None:
        try:
            try:
                bind = getattr(self.engine, "bind_thread", None)
                if bind is not None:
                    bind()
                self._loop()
            except BaseException as e:  # noqa: B036 - must release consumers
                self.error = e
                self.engine._fleet_abort(e)
                self._close_streams("failed", f"service loop died: {e!r}")
                raise
        finally:
            # unconditionally: a raise INSIDE the release path above must
            # still unblock join()ers, or shutdown hangs forever
            self._stopped.set()

    def _loop(self) -> None:
        eng = self.engine
        while True:
            if eng.drained:
                break
            eng.fault.on_round(eng._round)
            for prompt, max_new in eng.fault.ingress_burst(eng._round):
                try:                    # injected bursts go through the
                    self.submit(prompt, max_new=max_new, stream=False)
                except OverloadedError:
                    pass                # watermark like everything else
            if eng.drained:
                break
            # multi-host residual: worker-side submits ride the ack exchange
            # as queue counts; pull any announced requests into the queue
            # (no-op [] on single-process engines)
            for req in eng.poll_ingress():
                eng.pending.append(req)
            with self._mutex:
                while self._ingress:
                    eng.pending.append(self._ingress.popleft())
                cancels = list(self._cancels)
                self._cancels.clear()
            for uid, kind, reason in cancels:
                eng.cancel(uid, kind=kind, reason=reason)
            eng._expire_deadlines()
            admitted = 0
            if eng.pending and eng._free_total():
                admitted = eng._admit(self.extras)
            n_active = eng.step()
            if admitted or n_active:
                eng._round += 1
                continue
            # idle: block until a submit/cancel/drain wakes the loop
            # (clear-then-check: a submit between the clear and the wait
            # has already appended to ingress, so the check catches it)
            self._wake.clear()
            with self._mutex:
                busy = bool(self._ingress or self._cancels)
            if not busy and not eng.drained:
                self._wake.wait(self.idle_wait)
        self._drain_epilogue()

    def _drain_epilogue(self) -> None:
        eng = self.engine
        with self._mutex:
            # accepted-but-not-yet-queued ingress rides the snapshot too:
            # those submits were acknowledged, they must not vanish
            while self._ingress:
                eng.pending.append(self._ingress.popleft())
        self._close_streams("drain", None)
        if eng.snapshot_path:
            save_snapshot(eng.snapshot_path, eng.snapshot())

    def _close_streams(self, reason: str, error: str | None) -> None:
        with self._mutex:
            streams, self._streams = self._streams, {}
        for stream in streams.values():
            stream.push_finish(reason, error)
