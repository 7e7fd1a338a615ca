"""Scheduler core: the device-agnostic half of every ServeEngine.

The serving engines share one scheduler - request validation, the FIFO
pending queue, bucket grouping, per-replica free-slot deques with
least-loaded routing, slot/length accounting, and ``engine.stats`` - but
differ in WHERE the device programs run (one device, a single-process
('data', 'model') mesh, or a ``jax.distributed`` multi-process mesh).
This module expresses the scheduler as host-side PLANS so that split is
structural:

  * ``SchedulerCore`` builds plans (pure numpy: padded token batches,
    seq_lens, scatter maps, slot placements) and applies sampled results
    back to the queue/slot state.  It never touches a jax array.
  * an engine subclass implements three exec hooks, each consuming a plan
    and returning the sampled next token per pool row:

        _exec_prefill(plan, extras)   # one bucketed prefill + scatter
        _exec_chunked(plan, extras)   # a chunked-prefill launch sequence
        _exec_decode(plan)            # one batched decode step

Because a plan is plain numpy, it can also be SHIPPED: the multi-host
engine's coordinator broadcasts each plan's arrays to the worker
processes, which execute the same SPMD launches (serve/multihost.py) -
the scheduler itself keeps running as a host-side singleton on the
coordinator, exactly as it does on one process.

Dummy rows (pool rows a prefill batch does not fill) carry ``seq_lens ==
0``: every token of the row is masked out end to end - attention writes
clamp to index 0, the SSM recurrence skips all of them (dt = 0), and MoE
routing masks the whole row (moe.route token_mask), so a dummy row claims
NO expert-capacity slot.
"""
from __future__ import annotations

import collections
import dataclasses
import threading
import time
from typing import Any

import numpy as np

from repro_torch.distributed.fault import (FailureLog, FaultInjector,
                                           StragglerWatchdog, save_snapshot)

from . import telemetry as tmod
from .pages import PageError, PagePool, PrefixStore, pages_for

DEFAULT_BUCKETS = (32, 64, 128, 256)


class EngineDraining(RuntimeError):
    """``submit()``/``run()`` called after ``request_drain()``: the engine
    is stopping and accepts no new work (the service front door maps this
    to HTTP 503)."""


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray               # (S,) int32
    max_new: int = 16
    generated: list[int] = dataclasses.field(default_factory=list)
    done: bool = False
    error: str | None = None         # set iff the request FAILED (isolated)
    # absolute deadline on the scheduler's clock (engine._clock, default
    # time.monotonic); None = no deadline.  Checked at round boundaries:
    # an expired request is evicted alone, peers untouched.
    deadline: float | None = None
    # how the request left the engine: 'complete' | 'failed' | 'cancel' |
    # 'deadline' | 'disconnect' | 'slow_consumer' | 'drain' (service-side)
    finish_reason: str | None = None
    # tokens already delivered to stream observers: a preempted request
    # regenerates its tokens bit-exactly ((uid, step) sampling keys), and
    # this watermark keeps ``_emit_token`` from delivering them twice
    emitted: int = 0
    # telemetry lifecycle stamps (time.perf_counter; None until reached):
    # TTFT = first_token_at - submitted_at, queue wait = admitted_at -
    # submitted_at, inter-token gaps stream off last_token_at.  Excluded
    # from snapshots - a resumed request re-times from scratch.
    submitted_at: float | None = None
    admitted_at: float | None = None
    first_token_at: float | None = None
    last_token_at: float | None = None


@dataclasses.dataclass
class PrefillPlan:
    """One bucketed prefill launch spanning every replica: prompts
    right-padded to ``bucket``, replica r's admits in rows [r*spr, r*spr +
    n_r) of the fixed ``slots``-row batch; rows with seq_lens == 0 are
    dummies the scatter drops.  ``src_map`` carries replica-LOCAL source
    rows (identical to global rows when n_replicas == 1)."""
    bucket: int
    tokens: np.ndarray               # (slots, bucket) int32
    seq_lens: np.ndarray             # (slots,) int32; 0 = dummy row
    src_map: np.ndarray              # (slots,) int32; -1 = keep pool slot
    placed: list[tuple[int, int, Request]]   # (slot, batch row, request)
    per_counts: list[int]            # admits per replica
    real_tokens: int                 # prompt tokens (pads excluded)
    row_uids: np.ndarray = None      # (slots,) int32; -1 = dummy row
    row_steps: np.ndarray = None     # (slots,) int32 token index; -1 = dummy
    # paged pool landing maps (None on slot-row engines): pool page p takes
    # page ``land_js[p]`` of replica-local scratch row ``land_rows[p]``;
    # -1 keeps the page (unallocated, or a shared prefix page)
    land_rows: np.ndarray = None     # (n_replicas * pool_pages,) int32
    land_js: np.ndarray = None       # (n_replicas * pool_pages,) int32
    share_ok: bool = False           # apply may register prefix pages


@dataclasses.dataclass
class ChunkedPlan:
    """A chunked prefill of one or more oversized prompts with the SAME
    chunk count (equal-length launch sequences co-batch into shared rows -
    solo chunking burned every dummy row's FLOPs): the first chunk runs as
    a normal bucketed prefill, later chunks continue against the
    accumulating rows, then the finished rows land via ``src_map``."""
    placed: list[tuple[int, int, Request]]   # (slot, batch row, request)
    per_counts: list[int]            # admits per replica
    real_tokens: int                 # prompt tokens (pads excluded)
    first: tuple[int, np.ndarray, np.ndarray]      # (bucket, tokens, seq_lens)
    chunks: list[tuple[int, np.ndarray, np.ndarray, np.ndarray]]
    #          (bucket, tokens, seq_lens, start_lens)
    src_map: np.ndarray              # (slots,) int32
    row_uids: np.ndarray = None      # (slots,) int32; -1 = dummy row
    row_steps: np.ndarray = None     # (slots,) int32; -1 = dummy row
    land_rows: np.ndarray = None     # (n_replicas * pool_pages,) int32
    land_js: np.ndarray = None       # (n_replicas * pool_pages,) int32
    share_ok: bool = False


@dataclasses.dataclass
class DecodePlan:
    live: list[int]                  # slots with an active request
    tokens: np.ndarray               # (slots, 1) int32
    positions: np.ndarray            # (slots, 1) int32
    row_uids: np.ndarray = None      # (slots,) int32; -1 = free slot
    row_steps: np.ndarray = None     # (slots,) int32; -1 = free slot
    # paged pool: per-slot page-table rows with replica-LOCAL page ids
    # (-1 beyond each row's allocation; free slots all -1)
    page_tables: np.ndarray = None   # (slots, n_pp) int32
    # multi-step decode: tokens each row consumes from this dispatch's
    # on-device block (min of the engine's decode_steps, the row's
    # remaining max_new budget, and its cache headroom; 0 = free slot)
    n_steps: np.ndarray = None       # (slots,) int32


class SchedulerCore:
    """Replica-aware admission/decode scheduler over a fixed slot pool.

    Subclasses must set up device state and implement the exec hooks; the
    driver methods here (``submit``/``run``/``step``) are shared by the
    single-device, sharded, and multi-host engines.
    """

    # ------------------------------------------------------------ state init
    # a launch exception fails the launch's requests and keeps serving;
    # the multi-host engine overrides this to False (a coordinator that
    # keeps scheduling after a desynced collective would hang the fleet -
    # it aborts and lets drain-and-resume requeue the work instead)
    _isolate_exec = True

    def _init_scheduler(self, *, slots: int, n_replicas: int, max_len: int,
                        patch_tokens: int, buckets: tuple[int, ...],
                        batch_prefill: bool, chunked_prefill: bool,
                        decode_steps: int = 1,
                        fault: FaultInjector | None = None,
                        tel: tmod.Telemetry | None = None) -> None:
        assert slots % n_replicas == 0, (slots, n_replicas)
        assert decode_steps >= 1, decode_steps
        assert batch_prefill or n_replicas == 1, (
            "the legacy per-request prefill baseline is single-replica only")
        assert batch_prefill or not chunked_prefill, (
            "chunked prefill requires the bucketed batched-prefill path")
        self.slots = slots
        self.n_replicas = n_replicas
        self.slots_per_replica = slots // n_replicas
        self.max_len = max_len
        # decode block size N: every decode dispatch runs N model steps
        # on-device (lax.scan) and backhauls an (slots, N) token block, so
        # host round-trips per token drop to 1/N.  Admission, deadline
        # sweeps, cancellation and stream flushes quantize to dispatch
        # boundaries; per-(uid, step) sampling keys keep N>1 output
        # token-for-token equal to N=1
        self.decode_steps = int(decode_steps)
        self.patch_tokens = patch_tokens
        self.batch_prefill = batch_prefill
        self.chunked_prefill = chunked_prefill
        self.lengths = np.zeros((slots,), np.int64)
        self.active: list[Request | None] = [None] * slots
        self.last_tokens = np.zeros((slots,), np.int64)
        self.finished: list[Request] = []   # completion order, appended O(1)
        # clamp buckets so prompt + patches + the first decode token always
        # fit the cache (a prompt filling the cache exactly would ring-wrap
        # the first decode write onto slot 0), dedupe and sort ascending;
        # _bucket() picks the smallest bucket >= prompt len.  Without
        # chunking the capacity limit always rides as the last bucket, so
        # any prompt the legacy per-request path served safely is still
        # servable (at most one extra executable); with chunking the
        # largest CONFIGURED bucket is the chunk size and longer prompts
        # (up to capacity) are split instead.
        limit = max_len - patch_tokens - 1
        if limit <= 0:
            raise ValueError(
                f"max_len ({max_len}) leaves no room for a prompt: need "
                f"patch_tokens ({patch_tokens}) + prompt + 1 decode slot")
        self._capacity = limit
        bset = {min(int(b), limit) for b in buckets if int(b) > 0}
        if not chunked_prefill:
            bset |= {limit}
        if not bset:
            raise ValueError("chunked prefill needs at least one bucket")
        self.buckets = tuple(sorted(bset))
        # admission scheduler state: FIFO pending queue + one free-slot
        # deque per replica (O(1) admit, no rescans of self.active; the
        # per-replica split is what least-loaded routing reads)
        self.pending: collections.deque[Request] = collections.deque()
        spr = self.slots_per_replica
        self._free_r: list[collections.deque[int]] = [
            collections.deque(range(r * spr, (r + 1) * spr))
            for r in range(n_replicas)]
        # fault-tolerance state: a no-op-by-default injector (tests thread
        # a FaultPlan injector through the engine kwarg), a straggler EMA
        # over decode launch times, a failure event log, the scheduler
        # round counter the injector keys off, and the drain flag that
        # preempts the run loop (SIGTERM / coordinator preemption)
        self.fault = fault if fault is not None else FaultInjector()
        self.fault.bind(self)
        self.straggler = StragglerWatchdog()
        # prefill/chunked launches get their OWN EMA: a bucketed prefill is
        # legitimately 10-100x a decode step, so sharing the decode EMA
        # would either flag every prefill or never flag a slow one
        self.prefill_straggler = StragglerWatchdog()
        self.failures = FailureLog()
        # telemetry plane (serve/telemetry.py): metrics registry + tracer;
        # engines thread enabled/trace through from ServeConfig
        self.tel = tel if tel is not None else tmod.Telemetry()
        # guards stats_snapshot()/events_snapshot() against the serving
        # loop thread mutating while an HTTP scrape serializes
        self.stats_lock = threading.Lock()
        self.snapshot_path: str | None = None
        self._round = 0
        self._draining = False
        self._inflight: list[Request] = []   # claimed by an unapplied plan
        # deadline clock: overridable so tests pin expiry to scheduler
        # rounds (e.g. ``eng._clock = lambda: float(eng._round)``) instead
        # of wall time - deterministic on every engine including multihost
        self._clock = time.monotonic
        # uids cancelled while claimed by an in-flight plan: the apply
        # handler releases the slot instead of activating (kind, reason)
        self._cancelled: dict[int, tuple[str, str]] = {}
        # token/finish observers for the streaming service (serve/service):
        # on_token(req, tok) fires for every token the engine produces, in
        # order, ON the scheduler thread; on_finish(req) fires exactly once
        # when a request leaves the engine (complete or failed/evicted)
        self.on_token = None
        self.on_finish = None
        # paged-pool defaults: engines opt in via _init_paging() AFTER this
        self.paged = False
        self.page_pools: list[PagePool] = []
        self._slot_uids: list[int | None] = [None] * slots
        self._spilled: dict[int, Any] = {}      # uid -> SpillRecord
        self.stats: dict[str, Any] = {
            "prefill_compiles": 0,     # distinct prefill executables traced
            "chunk_compiles": 0,       # distinct prefill_chunk executables
            "decode_compiles": 0,
            "prefill_batches": 0,      # prefill launches (bucketed: one per
                                       # bucket group; legacy: one per request)
            "chunk_batches": 0,        # prefill_chunk launches
            "prefill_requests": 0,     # requests admitted through prefill
            "chunked_requests": 0,     # ... of which needed chunking
            "prefill_tokens": 0,       # real prompt tokens prefetched
            "prefill_padded_tokens": 0,  # tokens actually executed (pads incl)
            "decode_steps": 0,
            "decode_tokens": 0,
            "completed": 0,
            "failed": 0,               # requests failed + evicted (isolated)
            "cancelled": 0,            # client cancel / disconnect evictions
            "deadline_expired": 0,     # per-request deadline evictions
            "shed": 0,                 # admissions refused at the watermark
                                       # (service front door: HTTP 429)
            "straggler_flags": 0,      # decode rounds flagged slow (EMA)
            "prefill_straggler_flags": 0,   # prefill/chunk launches flagged
            "pdq_fallbacks": 0,        # guarded-projection fp fallbacks fired
            "pdq_clip_hits": 0,        # int8 outputs saturated at clip edges
            "pdq_clip_total": 0,       # int8 outputs checked
            # per-replica occupancy/admit accounting (single-replica engines
            # report one-element lists)
            "replica_admits": [0] * n_replicas,
            "replica_occupancy": [0] * n_replicas,
        }

    def _init_paging(self, *, page_size: int, pool_pages: int, n_pp: int,
                     prefix_sharing: bool = True, spill: bool = False) -> None:
        """Turn the slot pool into a paged pool: one ``PagePool`` allocator
        (+ ``PrefixStore``) per replica, driven entirely at plan time - the
        device side consumes page tables and land maps shipped inside the
        plans.  ``pool_pages`` is per replica and INCLUDES the dump page;
        ``pool_pages >= n_pp + 1`` (asserted by PagePool) guarantees a
        sole live request can always grow to max_len, which is what makes
        the preemption loop terminate."""
        self.paged = True
        self.page_size = int(page_size)
        self.n_pp = int(n_pp)
        self.pool_pages = int(pool_pages)
        # sharing keys on token prefixes; patch tokens (vision) shift every
        # position, and per-request extras change cache content - disable
        self.prefix_sharing = bool(prefix_sharing) and self.patch_tokens == 0
        self.spill_enabled = bool(spill)
        self.page_pools = [PagePool(pool_pages, n_pp, page_size)
                           for _ in range(self.n_replicas)]
        self.prefix_stores = [PrefixStore(page_size)
                              for _ in range(self.n_replicas)]
        for pool, store in zip(self.page_pools, self.prefix_stores):
            pool.on_free = store.drop_page
        if self.tel.enabled:
            cow = self.tel.metrics.counter(
                "serve_cow_copies_total",
                "shared frontier pages broken by copy-on-write")
            for ri, pool in enumerate(self.page_pools):
                pool.on_cow = (lambda uid, src, dst, _r=ri, _c=cow:
                               _c.inc())
        self._slot_seq = [0] * self.slots    # activation order (preempt LIFO)
        self._act_seq = 0
        self._shared_k: dict[int, int] = {}  # uid -> shared prefix pages
        self.stats.update(
            pages_total=(pool_pages - 1) * self.n_replicas,
            pages_used=0, preemptions=0, spills=0, spill_restores=0,
            prefix_hits=0, prefix_shared_pages=0, cow_copies=0)

    def _refresh_page_stats(self) -> None:
        if not self.paged:
            return
        self.stats["pages_used"] = sum(p.used_pages() for p in self.page_pools)
        self.stats["cow_copies"] = sum(p.stats["cow_copies"]
                                       for p in self.page_pools)
        self.stats["prefix_hits"] = sum(s.stats["prefix_hits"]
                                        for s in self.prefix_stores)
        self.stats["prefix_shared_pages"] = sum(
            s.stats["prefix_shared_pages"] for s in self.prefix_stores)

    # ------------------------------------------------------- telemetry taps
    def stats_snapshot(self) -> dict[str, Any]:
        """Deep-enough copy of ``stats`` taken under ``stats_lock``: the
        HTTP scrape thread serializes THIS, never the live dict the
        serving loop mutates (lists included - ``list(v)`` of a list being
        resized concurrently is the old /v1/stats race)."""
        with self.stats_lock:
            return {k: (list(v) if isinstance(v, list) else v)
                    for k, v in self.stats.items()}

    def events_snapshot(self) -> list[dict]:
        """Copy of the structured event ring (failures, evictions,
        preemptions, stragglers) for ``GET /v1/events``."""
        with self.stats_lock:
            return [dict(e) for e in self.failures.events]

    def _observe_pdq(self, tel_sum) -> None:
        """Fold one launch's device-side [fallbacks, clip_hits, clip_total]
        summary (rode the token gather as host numpy) into stats + the
        metrics registry."""
        if tel_sum is None or not self.tel.enabled:
            return
        fb, hits, total = (float(x) for x in np.asarray(tel_sum).reshape(-1)[:3])
        with self.stats_lock:
            self.stats["pdq_fallbacks"] += int(round(fb))
            self.stats["pdq_clip_hits"] += int(round(hits))
            self.stats["pdq_clip_total"] += int(round(total))
        self.tel.observe_pdq(fb, hits, total)

    # ------------------------------------------------------------ exec hooks
    def _exec_prefill(self, plan: PrefillPlan, extras):
        """Run ONE bucketed prefill + cache scatter; return ``(nxt, ok)``:
        the sampled next token per pool row and a per-row finite flag
        (False = that row's logits carried NaN/Inf and the request must be
        failed without touching its batch peers).  Dummy rows' entries are
        ignored."""
        raise NotImplementedError

    def _exec_chunked(self, plan: ChunkedPlan, extras):
        raise NotImplementedError

    def _exec_decode(self, plan: DecodePlan):
        raise NotImplementedError

    def _submit_one(self, req: Request, extras) -> bool:
        raise NotImplementedError(
            "the legacy per-request path is single-device only")

    # paged-pool hooks (engines with paged=True implement these)
    def _exec_page_copy(self, replica: int, pairs) -> None:
        """Device copy of pool pages [(src, dst), ...] on one replica (the
        COW arm of ``PagePool.ensure_writable``)."""
        raise NotImplementedError

    def _exec_spill(self, slot: int, uid: int, page_ids):
        """Capture a preempted request's pages + flat rows to host memory;
        returns a ``pages.SpillRecord`` (warm resume) or raises."""
        raise NotImplementedError

    def _exec_restore(self, slot: int, rec, page_ids) -> None:
        """Scatter a SpillRecord back into freshly allocated pages + the
        claimed slot's flat rows."""
        raise NotImplementedError

    def _fleet_abort(self, e: BaseException) -> None:
        """A non-isolated scheduling error killed the driver loop: engines
        with peers to release override this (multi-host broadcasts
        CMD_ABORT + snapshots).  Single-process engines have nothing to do."""

    def poll_ingress(self) -> list[Request]:
        """Requests submitted OUTSIDE this process (multi-host workers
        forward their local submits to the coordinator; see
        multihost.submit_remote).  Single-process engines have none."""
        return []

    # --------------------------------------------------- stream observers
    def _emit_token(self, req: Request, tok: int) -> None:
        idx = len(req.generated) - 1
        if idx < req.emitted:
            return      # preempt-regenerated token: already delivered
        req.emitted = idx + 1
        if self.tel.enabled:
            now = time.perf_counter()
            if req.first_token_at is None:
                req.first_token_at = now
                if req.submitted_at is not None:
                    self.tel.ttft.observe(now - req.submitted_at)
            elif req.last_token_at is not None:
                self.tel.per_token.observe(now - req.last_token_at)
            req.last_token_at = now
        if self.on_token is not None:
            self.on_token(req, tok)

    def _emit_finish(self, req: Request) -> None:
        tr = self.tel.tracer
        if tr.enabled and req.submitted_at is not None:
            # the request's lifecycle lands as two spans on the request
            # row: queued (submit -> admit) and active (admit -> finish)
            t0 = tr.to_us(req.submitted_at)
            t1 = tr.to_us(req.admitted_at) if req.admitted_at else tr.now_us()
            tr.add(f"req {req.uid} queued", cat="request", ts=t0,
                   dur=t1 - t0, tid=tmod.TID_REQUEST, args={"uid": req.uid})
            tr.add(f"req {req.uid} {req.finish_reason or 'active'}",
                   cat="request", ts=t1, dur=tr.now_us() - t1,
                   tid=tmod.TID_REQUEST,
                   args={"uid": req.uid, "tokens": len(req.generated),
                         "reason": req.finish_reason or ""})
        if self.on_finish is not None:
            self.on_finish(req)

    # ------------------------------------------------------ request failure
    def _fail(self, req: Request, err: str, kind: str) -> None:
        """Fail ONE request in place: mark done with an error, surface it
        through ``finished`` (so ``run`` drains normally) and the failure
        log.  The caller releases any claimed slot."""
        req.done = True
        req.error = str(err)
        req.finish_reason = kind if kind in (
            "cancel", "deadline", "disconnect", "slow_consumer") else "failed"
        self._spilled.pop(req.uid, None)    # drop any host-spilled pages
        self.finished.append(req)
        self.stats["failed"] += 1
        self.failures.record(self._round, kind, f"uid={req.uid}: {err}")
        self._emit_finish(req)

    # -------------------------------------------------------- cancellation
    def cancel(self, uid: int, *, kind: str = "cancel",
               reason: str = "cancelled by client") -> bool:
        """First-class cancellation: drop a pending request, or evict an
        in-flight one through the ``_fail``/release path (per-slot
        cache state and (uid, step) sampling keys keep peers bit-exact).
        A uid claimed by an unapplied plan (e.g. mid-chunked-prefill) is
        marked and reclaimed when the launch's result applies - within the
        same round.  Cancelling an already-finished or unknown uid is a
        no-op returning False."""
        for r in self.pending:
            if r.uid == uid:
                self.pending.remove(r)
                self._count_cancel(kind)
                self._fail(r, reason, kind)
                return True
        for r in self._inflight:
            if r.uid == uid and not r.done:
                self._cancelled[uid] = (kind, reason)
                return True
        for slot, r in enumerate(self.active):
            if r is not None and r.uid == uid:
                self.active[slot] = None
                self._release_slot(slot)
                self._count_cancel(kind)
                self._fail(r, reason, kind)
                return True
        return False

    def _count_cancel(self, kind: str) -> None:
        self.stats["deadline_expired" if kind == "deadline"
                   else "cancelled"] += 1

    def _take_cancel(self, req: Request, slot: int) -> bool:
        """Apply-time arm of ``cancel``: if the uid was cancelled while its
        plan was in flight, release the claimed slot instead of activating."""
        ck = self._cancelled.pop(req.uid, None)
        if ck is None:
            return False
        self._release_slot(slot)
        self._count_cancel(ck[0])
        self._fail(req, ck[1], ck[0])
        return True

    def _expire_deadlines(self) -> int:
        """Round-boundary sweep: evict every pending/active request whose
        deadline passed on the engine clock.  Each eviction is isolated
        (same path as ``cancel``); returns the number evicted."""
        now = self._clock()
        n = 0
        for r in [r for r in self.pending
                  if r.deadline is not None and now >= r.deadline]:
            self.pending.remove(r)
            self._count_cancel("deadline")
            self._fail(r, f"deadline expired before admission "
                          f"(deadline={r.deadline:g})", "deadline")
            n += 1
        for slot, r in enumerate(self.active):
            if r is not None and r.deadline is not None and now >= r.deadline:
                self.active[slot] = None
                self._release_slot(slot)
                self._count_cancel("deadline")
                self._fail(r, f"deadline expired after {len(r.generated)} "
                              f"tokens (deadline={r.deadline:g})", "deadline")
                n += 1
        return n

    def _check_prompt(self, req: Request) -> None:
        """Structural validation at dequeue time: a malformed prompt must
        fail ALONE (raising inside ``_plan_prefill`` would poison the
        whole admission group)."""
        p = np.asarray(req.prompt)
        if p.ndim != 1 or p.size == 0 or not np.issubdtype(p.dtype, np.integer):
            raise ValueError(
                f"malformed prompt: shape {p.shape}, dtype {p.dtype} "
                "(need a non-empty 1-D integer array)")

    def _abort_launch(self, kind: str, slots_reqs, e: Exception) -> None:
        """A device launch raised: fail every request it carried, release
        their slots, keep the engine serving (request isolation)."""
        for slot, req in slots_reqs:
            if slot is not None:
                if self.active[slot] is req:
                    self.active[slot] = None
                self._release_slot(slot)
            self._fail(req, f"{kind} launch failed: {e!r}", "exec")
        self._inflight = []

    # ------------------------------------------------------- drain control
    def request_drain(self) -> None:
        """Stop scheduling at the next round boundary (SIGTERM handler /
        coordinator preemption); ``snapshot()`` then carries the queue and
        the in-flight work so a restarted engine can requeue it."""
        self._draining = True

    @property
    def drained(self) -> bool:
        return self._draining

    # ----------------------------------------------------------- snapshots
    def snapshot(self) -> dict:
        """The scheduler's drain record: a pure-numpy/python dict (shippable
        via ``distributed.fault.save_snapshot``) of finished, in-flight and
        pending requests plus counters.  In-flight covers both activated
        slots and requests claimed by a plan whose result never applied
        (e.g. the deadline watchdog fired mid-collective: host scheduler
        state is still consistent, the launch simply never landed)."""
        seen: set[int] = set()

        def pack(r: Request) -> dict:
            seen.add(id(r))
            return {"uid": int(r.uid), "prompt": np.asarray(r.prompt),
                    "max_new": int(r.max_new),
                    "generated": [int(t) for t in r.generated],
                    "error": r.error, "finish_reason": r.finish_reason}

        inflight = [pack(self.active[s]) for s in range(self.slots)
                    if self.active[s] is not None]
        inflight += [pack(r) for r in self._inflight if id(r) not in seen]
        return {
            "version": 1,
            "round": int(self._round),
            "inflight": inflight,
            "pending": [pack(r) for r in self.pending],
            "finished": [pack(r) for r in self.finished],
            "stats": {k: (list(v) if isinstance(v, list) else int(v))
                      for k, v in self.stats.items()},
            "failures": list(self.failures.events),
        }

    # ----------------------------------------------------------------- admin
    def _bucket(self, prompt_len: int) -> int:
        if prompt_len <= 0:
            raise ValueError("empty prompt: nothing to prefill")
        for b in self.buckets:
            if prompt_len <= b:
                return b
        raise ValueError(
            f"prompt of {prompt_len} tokens exceeds the largest prefill "
            f"bucket {self.buckets[-1]} (max_len={self.max_len}, "
            f"patch_tokens={self.patch_tokens})")

    def _validate(self, prompt_len: int) -> None:
        """Reject empty/oversized prompts up front (before any dequeue)."""
        if self.chunked_prefill and prompt_len > self.buckets[-1]:
            if prompt_len > self._capacity:
                raise ValueError(
                    f"prompt of {prompt_len} tokens exceeds the cache "
                    f"capacity {self._capacity} (max_len={self.max_len}, "
                    f"patch_tokens={self.patch_tokens})")
            return
        self._bucket(prompt_len)

    def _validate_extras(self, prompt_len: int, extras) -> None:
        """Entry-point companion of _validate: reject unsupported extras
        combinations BEFORE anything is queued or any plan claims a slot
        (raising mid-admission would drop dequeued peers / leak slots).
        The multi-host engine overrides this to reject all extras."""
        if extras and self.chunked_prefill and prompt_len > self.buckets[-1]:
            raise NotImplementedError(
                "chunked prefill is text-only (no vision/encdec extras)")

    def _free_total(self) -> int:
        return sum(len(f) for f in self._free_r)

    def _take_slot(self, replica: int) -> int:
        slot = self._free_r[replica].popleft()
        self.stats["replica_occupancy"][replica] += 1
        return slot

    def _release_slot(self, slot: int) -> None:
        r = slot // self.slots_per_replica
        self._free_r[r].append(slot)
        self.stats["replica_occupancy"][r] -= 1
        if self.paged:
            # THE page-freeing choke point: every slot-release path
            # (complete, fail, cancel, deadline, preempt) funnels here
            uid = self._slot_uids[slot]
            if uid is not None:
                self.page_pools[r].release(uid)
                self._shared_k.pop(uid, None)
                self._slot_uids[slot] = None

    def _assign(self, reqs: list[Request]) -> list[list[Request]]:
        """Route same-bucket admits to replicas, least-loaded first (most
        free slots net of this round's assignments; FIFO within the
        round).  Caller guarantees len(reqs) <= total free slots."""
        per: list[list[Request]] = [[] for _ in range(self.n_replicas)]
        for r in reqs:
            ri = max(range(self.n_replicas),
                     key=lambda i: (len(self._free_r[i]) - len(per[i]), -i))
            assert len(self._free_r[ri]) > len(per[ri]), "no free slot"
            per[ri].append(r)
        return per

    def _complete(self, req: Request) -> None:
        req.done = True
        req.finish_reason = "complete"
        self.finished.append(req)
        self.stats["completed"] += 1
        self._emit_finish(req)

    def _activate(self, slot: int, req: Request, prompt_len: int, tok: int):
        req.generated.append(tok)
        self._emit_token(req, tok)
        if len(req.generated) >= req.max_new:
            # prefill already produced the full budget: complete without
            # ever occupying a decode slot (max_new=1 = pure ingest)
            self._release_slot(slot)
            self._complete(req)
            return
        self.active[slot] = req
        self.lengths[slot] = prompt_len + self.patch_tokens
        self.last_tokens[slot] = tok

    # ------------------------------------------------------- prefill planning
    def _plan_prefill(self, per: list[list[Request]], bucket: int) -> PrefillPlan:
        """Lay replica r's admits into rows [r*spr, r*spr + len(per[r]))
        of a fixed ``slots``-row batch and claim their slots.  Rows beyond
        a replica's admits are dummies: seq_lens == 0 masks every one of
        their tokens out of attention writes, the SSM recurrence and MoE
        routing, and src_map == -1 makes the scatter drop them."""
        spr = self.slots_per_replica
        n = sum(len(g) for g in per)
        assert 0 < n <= self._free_total()
        tokens = np.zeros((self.slots, bucket), np.int32)
        seq_lens = np.zeros((self.slots,), np.int32)     # dummy rows: 0
        src_map = np.full((self.slots,), -1, np.int32)
        row_uids = np.full((self.slots,), -1, np.int32)
        row_steps = np.full((self.slots,), -1, np.int32)
        placed: list[tuple[int, int, Request]] = []
        for ri, reqs in enumerate(per):
            for i, r in enumerate(reqs):
                S = len(r.prompt)
                tokens[ri * spr + i, :S] = r.prompt
                seq_lens[ri * spr + i] = S
                row_uids[ri * spr + i] = r.uid
                row_steps[ri * spr + i] = len(r.generated)
                slot = self._take_slot(ri)
                src_map[slot] = i                        # replica-local row
                self._bind_slot(slot, r)
                placed.append((slot, ri * spr + i, r))
        land_rows, land_js = self._land_maps(placed, src_map)
        return PrefillPlan(bucket=bucket, tokens=tokens, seq_lens=seq_lens,
                           src_map=src_map, placed=placed,
                           per_counts=[len(g) for g in per],
                           real_tokens=int(seq_lens.sum()),
                           row_uids=row_uids, row_steps=row_steps,
                           land_rows=land_rows, land_js=land_js)

    def _bind_slot(self, slot: int, req: Request) -> None:
        """Bind the placed request's uid to its slot (page freeing rides
        ``_release_slot``) and stamp the activation sequence the
        preemption policy orders victims by (youngest first)."""
        if not self.paged:
            return
        self._slot_uids[slot] = req.uid
        self._act_seq += 1
        self._slot_seq[slot] = self._act_seq

    def _land_maps(self, placed, src_map):
        """Landing maps for a prefill/chunked plan: pool page p (replica-
        local id, laid out per replica block) takes page ``land_js[p]`` of
        replica-local scratch row ``land_rows[p]``.  ALL allocated pages
        land - including the tail beyond the prompt, whose scratch content
        is the pristine init fill, bit-exactly the never-written region of
        a slot-row cache.  Shared prefix pages are excluded (their content
        is already in the pool; first writer landed it)."""
        if not self.paged:
            return None, None
        spr = self.slots_per_replica
        N = self.pool_pages * self.n_replicas
        land_rows = np.full((N,), -1, np.int32)
        land_js = np.zeros((N,), np.int32)
        for slot, _, r in placed:
            ri = slot // spr
            base = ri * self.pool_pages
            row = int(src_map[slot])                     # local scratch row
            k = self._shared_k.get(r.uid, 0)
            for j, p in enumerate(self.page_pools[ri].pages(r.uid)):
                if j < k:
                    continue                             # shared prefix page
                land_rows[base + p] = row
                land_js[base + p] = j
        return land_rows, land_js

    def _register_prefix(self, plan, slot: int, req: Request) -> None:
        """Publish the landed prompt's full pages for COW sharing.  Since
        ``_claim_pages`` registers eagerly (intra-round sharing) this is
        normally a first-writer-wins no-op; it remains as the apply-time
        backstop so a prompt claimed with sharing disabled for the round
        (``plan.share_ok`` echoes the flush-time gate) never publishes,
        and because release fires ``on_free`` the store never outlives
        the pages either way."""
        if not (self.paged and plan.share_ok):
            return
        ri = slot // self.slots_per_replica
        self.prefix_stores[ri].register(
            np.asarray(req.prompt), self.page_pools[ri].pages(req.uid))

    def _claim_pages(self, ri: int, req: Request, extras) -> bool:
        """Claim this request's prompt pages on replica ``ri`` at PLAN
        time: longest registered prefix is aliased read-only (refcounted),
        the rest allocated fresh.  On PageError nothing is held (alloc is
        side-effect free + release drops the shared refs) and the caller
        defers the request instead of admitting it.

        A successful claim registers its own full pages IMMEDIATELY
        (first-writer-wins, so apply-time re-registration is a no-op):
        duplicates admitted in the SAME round - even the same launch -
        share pages instead of landing fresh copies.  Same-launch sharing
        is sound because the first writer's land maps cover the shared
        pages within that launch (``_land_maps`` skips only the SHARER's
        ``j < k`` entries), and an early entry never outlives its pages:
        if the claimer's launch aborts or its row is evicted, releasing
        the pages fires ``on_free`` and the store forgets them - unless a
        sharer still holds a reference, in which case the landed content
        (identical for identical prompts) is exactly what the sharer
        needs."""
        pool = self.page_pools[ri]
        need = pages_for(len(req.prompt) + self.patch_tokens, self.page_size)
        share = self.prefix_sharing and not extras
        k, shared = ((0, []) if not share
                     else self.prefix_stores[ri].lookup(np.asarray(req.prompt)))
        pool.attach(req.uid)
        pool.share(req.uid, shared)
        try:
            pool.alloc(req.uid, need - k)
        except PageError:
            pool.release(req.uid)
            return False
        if k:
            self._shared_k[req.uid] = k
        if share:
            self.prefix_stores[ri].register(np.asarray(req.prompt),
                                            pool.pages(req.uid))
        return True

    def _claim_per(self, per: list[list[Request]], extras):
        """Page-claim filter over an assigned admission group: requests
        whose pages do not fit are pushed BACK to the queue front (FIFO
        preserved) and retried next round - decode completions and
        preemptions free pages between rounds."""
        kept: list[list[Request]] = []
        deferred: list[Request] = []
        for ri, group in enumerate(per):
            kept.append([])
            for r in group:
                if self._claim_pages(ri, r, extras):
                    kept[ri].append(r)
                else:
                    deferred.append(r)
        for r in reversed(deferred):
            self.pending.appendleft(r)
        return kept, len(deferred)

    def _apply_prefill(self, plan: PrefillPlan, res) -> None:
        nxt, ok = res
        for ri, c in enumerate(plan.per_counts):
            self.stats["replica_admits"][ri] += c
        for slot, row, r in plan.placed:
            if self._take_cancel(r, slot):
                continue
            if not ok[row]:
                # poisoned row: fail + evict THIS request only; peers'
                # rows are untouched (per-slot attention/cache state)
                self._release_slot(slot)
                self._fail(r, "non-finite logits at prefill", "nonfinite")
                continue
            self._register_prefix(plan, slot, r)
            self._activate(slot, r, int(plan.seq_lens[row]), int(nxt[row]))
        self._inflight = []
        self.stats["prefill_batches"] += 1
        self.stats["prefill_requests"] += len(plan.placed)
        self.stats["prefill_tokens"] += plan.real_tokens
        self.stats["prefill_padded_tokens"] += self.slots * plan.bucket

    def _plan_chunked(self, reqs: list[Request],
                      per: list[list[Request]] | None = None) -> ChunkedPlan:
        """Split oversized prompts with EQUAL chunk counts into one shared
        launch sequence.  Each prompt rides its own row of the replica
        blocks (least-loaded routing, like ``_plan_prefill``); every chunk
        j < last is a full ``buckets[-1]`` window for every request, and
        the ragged last chunks pad together to one shared bucket.  Rows no
        request fills stay dummies (seq_lens == 0) - co-batching is what
        reclaims their FLOPs vs the old one-prompt-per-sequence planning."""
        spr = self.slots_per_replica
        Bp = self.slots
        chunk = self.buckets[-1]
        if per is None:
            per = self._assign(reqs)
        else:
            reqs = [r for g in per for r in g]
        n_chunks = -(-len(reqs[0].prompt) // chunk)
        assert all(-(-len(r.prompt) // chunk) == n_chunks for r in reqs)

        rows: list[tuple[int, np.ndarray]] = []   # (row, prompt) per request
        src_map = np.full((Bp,), -1, np.int32)
        row_uids = np.full((Bp,), -1, np.int32)
        row_steps = np.full((Bp,), -1, np.int32)
        placed: list[tuple[int, int, Request]] = []
        for ri, group in enumerate(per):
            for i, r in enumerate(group):
                row = ri * spr + i
                rows.append((row, np.asarray(r.prompt)))
                row_uids[row] = r.uid
                row_steps[row] = len(r.generated)
                slot = self._take_slot(ri)
                src_map[slot] = i                        # replica-local row
                self._bind_slot(slot, r)
                placed.append((slot, row, r))
        land_rows, land_js = self._land_maps(placed, src_map)

        # first chunk: with n_chunks >= 2 every prompt fills a whole window
        tokens = np.zeros((Bp, chunk), np.int32)
        seq_lens = np.zeros((Bp,), np.int32)
        for row, prompt in rows:
            tokens[row] = prompt[:chunk]
            seq_lens[row] = chunk
        first = (chunk, tokens, seq_lens)

        chunks: list[tuple[int, np.ndarray, np.ndarray, np.ndarray]] = []
        for j in range(1, n_chunks):
            off = j * chunk
            rems = [min(chunk, p.size - off) for _, p in rows]
            b = chunk if j < n_chunks - 1 else self._bucket(max(rems))
            tokens = np.zeros((Bp, b), np.int32)
            seq_lens = np.zeros((Bp,), np.int32)
            start_lens = np.zeros((Bp,), np.int32)
            for (row, prompt), rem in zip(rows, rems):
                tokens[row, :rem] = prompt[off:off + rem]
                seq_lens[row] = rem
                start_lens[row] = off
            chunks.append((b, tokens, seq_lens, start_lens))

        return ChunkedPlan(placed=placed, per_counts=[len(g) for g in per],
                           real_tokens=sum(p.size for _, p in rows),
                           first=first, chunks=chunks, src_map=src_map,
                           row_uids=row_uids, row_steps=row_steps,
                           land_rows=land_rows, land_js=land_js)

    def _apply_chunked(self, plan: ChunkedPlan, res) -> None:
        nxt, ok = res
        self.stats["prefill_batches"] += 1
        self.stats["chunk_batches"] += len(plan.chunks)
        self.stats["prefill_padded_tokens"] += self.slots * (
            plan.first[0] + sum(c[0] for c in plan.chunks))
        for ri, c in enumerate(plan.per_counts):
            self.stats["replica_admits"][ri] += c
        for slot, row, r in plan.placed:
            if self._take_cancel(r, slot):
                continue
            if not ok[row]:
                self._release_slot(slot)
                self._fail(r, "non-finite logits at chunked prefill",
                           "nonfinite")
                continue
            self._register_prefix(plan, slot, r)
            self._activate(slot, r, len(r.prompt), int(nxt[row]))
        self._inflight = []
        self.stats["prefill_requests"] += len(plan.placed)
        self.stats["chunked_requests"] += len(plan.placed)
        self.stats["prefill_tokens"] += plan.real_tokens

    # ------------------------------------------------------------- admission
    def submit(self, req: Request, extras: dict[str, Any] | None = None) -> bool:
        """Admit the request into a free slot now; False if engine is full.

        On the bucketed path this may opportunistically co-admit queued
        same-bucket requests into the same prefill launch.
        """
        if self._draining:
            raise EngineDraining(
                "engine is draining (request_drain() was called): new "
                "submissions are rejected; resume from the snapshot")
        if not self._free_total():
            return False
        if not self.batch_prefill:
            return self._submit_one(req, extras)
        self._validate(len(req.prompt))  # validate before touching the queue
        self._validate_extras(len(req.prompt), extras)
        if self.tel.enabled and req.submitted_at is None:
            req.submitted_at = time.perf_counter()
        self.pending.appendleft(req)
        self._admit(extras)
        return True

    def _admit(self, extras=None) -> int:
        """Bucket-grouped admission: ONE pass over the pending queue assigns
        the first len(free) requests (FIFO) to per-bucket groups, then each
        group prefills in ONE batched call spanning every replica (groups
        launch in first-arrival order).  Chunk-needing requests group by
        CHUNK COUNT the same way: equal-count prompts co-batch into one
        shared chunk sequence instead of each burning a whole
        dummy-row-padded launch sequence alone.  O(pending) per admission
        call, not per batch.  Returns the number of requests admitted."""
        free = self._free_total()
        groups: dict[tuple, list[Request]] = {}
        order: list[tuple] = []
        admitted = 0

        def launch(kind, plan, slots_reqs, exec_fn, apply_fn):
            # request isolation around ONE device launch: the fault hook
            # runs inside the guard (an injected launch fault exercises
            # the same path a real device error takes), and an exception
            # fails the launch's requests without taking the engine down
            self._inflight = [r for _, r in slots_reqs]
            if self.tel.enabled:
                now = time.perf_counter()
                for _, r in slots_reqs:
                    if r.admitted_at is None:
                        r.admitted_at = now
                        if r.submitted_at is not None:
                            self.tel.queue_wait.observe(now - r.submitted_at)
            t0 = time.perf_counter()
            try:
                self.fault.on_exec(kind, self._round)
                with self.tel.span(f"launch:{kind}", tid=tmod.TID_LAUNCH,
                                   reqs=len(slots_reqs), round=self._round):
                    res = exec_fn()
            except Exception as e:
                if not self._isolate_exec:
                    raise          # multi-host: abort + drain, never desync
                self._abort_launch(kind, slots_reqs, e)
            else:
                # prefill/chunked launches feed their OWN straggler EMA
                # (distinct event kind from the decode watchdog)
                dt = (time.perf_counter() - t0
                      + self.fault.exec_delay(kind, self._round))
                if self.prefill_straggler.observe(dt):
                    self.failures.record(
                        self._round, "straggler_prefill",
                        f"{kind} launch {dt:.4f}s > "
                        f"{self.prefill_straggler.factor:g}x EMA "
                        f"{self.prefill_straggler.ema:.4f}s")
                self.stats["prefill_straggler_flags"] = \
                    self.prefill_straggler.flagged
                if self.tel.enabled:
                    self.tel.launch_histogram(kind).observe(dt)
                with self.tel.span(f"apply:{kind}", tid=tmod.TID_APPLY):
                    apply_fn(plan, res)

        def flush():
            nonlocal admitted
            share = self.paged and self.prefix_sharing and not extras
            for key in order:
                per = self._assign(groups[key])
                if self.paged:
                    # claim pages at plan time; requests that don't fit go
                    # back to the queue front and wait for frees/preempts
                    per, n_deferred = self._claim_per(per, extras)
                    admitted -= n_deferred
                    if not any(per):
                        continue
                if key[0] == "chunk":
                    with self.tel.span("plan:chunked", tid=tmod.TID_PLAN):
                        plan = self._plan_chunked(groups[key], per=per)
                    plan.share_ok = share
                    launch("chunked", plan,
                           [(s, r) for s, _, r in plan.placed],
                           lambda p=plan: self._exec_chunked(p, extras),
                           self._apply_chunked)
                else:
                    with self.tel.span("plan:prefill", tid=tmod.TID_PLAN):
                        plan = self._plan_prefill(per, key[1])
                    plan.share_ok = share
                    launch("prefill", plan,
                           [(s, r) for s, _, r in plan.placed],
                           lambda p=plan: self._exec_prefill(p, extras),
                           self._apply_prefill)
            groups.clear()
            order.clear()

        holdback: list[Request] = []   # spilled uids that couldn't restore
        while self.pending and admitted < free:   # consumes a queue prefix
            r = self.pending.popleft()
            if self.paged and r.uid in self._spilled:
                # preempted-and-spilled: warm resume from the host copy
                # instead of re-prefilling (no pages -> wait at the front)
                if self._try_restore(r):
                    admitted += 1
                else:
                    holdback.append(r)
                continue
            try:
                self._check_prompt(r)
            except Exception as e:
                # malformed request: fails ALONE, peers stay queued/grouped
                self._fail(r, str(e), "plan")
                continue
            S = len(r.prompt)
            if self.chunked_prefill and S > self.buckets[-1]:
                # extras were rejected at submit()/run() entry
                # (_validate_extras) - raising here would drop the
                # dequeued peers and leak the planned slot
                key = ("chunk", -(-S // self.buckets[-1]))
            else:
                key = ("bucket", self._bucket(S))
            if key not in groups:
                groups[key] = []
                order.append(key)
            groups[key].append(r)
            admitted += 1
        for r in reversed(holdback):
            self.pending.appendleft(r)
        flush()
        self._refresh_page_stats()
        return admitted

    # ---------------------------------------------------------------- decode
    def _decode_budget(self, slot: int) -> int:
        """Tokens this live slot consumes from the next decode dispatch:
        the engine block size capped by the row's remaining ``max_new``
        budget and its cache headroom (the last writable position is
        ``max_len - 2``; the completion check below fires at
        ``max_len - 1``).  Always >= 1 for an active slot."""
        r = self.active[slot]
        return max(1, min(self.decode_steps,
                          r.max_new - len(r.generated),
                          self.max_len - 1 - int(self.lengths[slot])))

    def _poison_ok(self, kind: str, plan, ok: np.ndarray) -> np.ndarray:
        """Host-side arm of fault injection: flip the ok flag of every
        batch row the injector poisons this round (whole row: the request
        is evicted at the dispatch boundary, exactly like a device-side
        non-finite row)."""
        rows = self.fault.poison_rows(kind, plan)
        if rows:
            ok = np.array(ok, copy=True)
            ok[np.asarray(rows, np.int64)] = False
        return ok

    def _plan_decode(self) -> DecodePlan | None:
        live = [i for i, r in enumerate(self.active) if r is not None]
        if not live:
            return None
        row_uids = np.full((self.slots,), -1, np.int32)
        row_steps = np.full((self.slots,), -1, np.int32)
        n_steps = np.zeros((self.slots,), np.int32)
        for i in live:
            row_uids[i] = self.active[i].uid
            row_steps[i] = len(self.active[i].generated)
            n_steps[i] = self._decode_budget(i)
        page_tables = None
        if self.paged:
            spr = self.slots_per_replica
            page_tables = np.full((self.slots, self.n_pp), -1, np.int32)
            for s in live:
                uid = self._slot_uids[s]
                if uid is not None:
                    page_tables[s] = self.page_pools[s // spr].table_row(uid)
        return DecodePlan(live=live,
                          tokens=self.last_tokens[:, None].astype(np.int32),
                          positions=self.lengths[:, None].astype(np.int32),
                          row_uids=row_uids, row_steps=row_steps,
                          page_tables=page_tables, n_steps=n_steps)

    def _apply_decode(self, plan: DecodePlan, res) -> None:
        """Consume one dispatch's (slots, N) token block.  Each live row
        takes its planned ``n_steps`` tokens in order; a non-finite step
        evicts that request alone AT THE DISPATCH BOUNDARY (tokens the row
        produced before the poisoned step are kept - they were computed
        from finite state).  ``decode_steps`` counts DISPATCHES and
        ``decode_tokens`` consumed tokens, so host dispatches per token is
        deterministically 1/N when rows run full blocks."""
        nxt, ok = res
        nxt = np.asarray(nxt).reshape(self.slots, -1)
        ok = np.asarray(ok).reshape(self.slots, -1)
        self.stats["decode_steps"] += 1
        consumed = 0
        for i in plan.live:
            req = self.active[i]
            if req is None:
                continue              # evicted between plan and apply
            for t in range(int(plan.n_steps[i])):
                if not ok[i, t]:
                    # poisoned step: evict this request alone; peers' rows
                    # in the cache pool are untouched (per-slot state)
                    self.active[i] = None
                    self._release_slot(i)
                    self._fail(req, "non-finite logits at decode",
                               "nonfinite")
                    break
                tok = int(nxt[i, t])
                consumed += 1
                req.generated.append(tok)
                self.lengths[i] += 1
                self.last_tokens[i] = tok
                self._emit_token(req, tok)
                if (len(req.generated) >= req.max_new
                        or self.lengths[i] >= self.max_len - 1):
                    self.active[i] = None
                    self._release_slot(i)   # freed for the next admission
                    self._complete(req)
                    break
        self.stats["decode_tokens"] += consumed

    # ----------------------------------------------- paged decode growth
    def _ensure_decode_pages(self) -> None:
        """Make every live slot own (writably) every page the next decode
        dispatch writes - positions ``lengths[slot]`` through
        ``lengths[slot] + n_steps - 1`` (the whole N-step block is
        pre-allocated, so preemption only ever happens BETWEEN dispatches)
        - BEFORE the page tables are snapshotted into the decode plan.
        Growth allocations happen exactly when the block crosses a page
        boundary; a COW copy fires when a written page is prefix-shared
        (only the frontier page ``lengths // page`` can be - later pages
        are freshly allocated).  Under pool pressure the YOUNGEST request
        on the replica is preempted (LIFO: oldest-first iteration +
        youngest victim keeps head-of-line work moving);
        ``pool_pages >= n_pp + 1`` guarantees a sole survivor can always
        grow, so the victim loop terminates."""
        spr = self.slots_per_replica
        copies: dict[int, list[tuple[int, int]]] = {}
        order = sorted((s for s in range(self.slots)
                        if self.active[s] is not None),
                       key=lambda s: self._slot_seq[s])
        for slot in order:
            if self.active[slot] is None:
                continue                  # preempted earlier in this sweep
            ri = slot // spr
            pool = self.page_pools[ri]
            uid = self._slot_uids[slot]
            j0 = int(self.lengths[slot]) // self.page_size
            last = int(self.lengths[slot]) + self._decode_budget(slot) - 1
            need = last // self.page_size + 1
            while True:
                try:
                    while pool.n_owned(uid) < need:
                        pool.alloc(uid, 1)
                    for j in range(j0, need):
                        cp = pool.ensure_writable(uid, j)
                        if cp is not None:
                            copies.setdefault(ri, []).append(cp)
                    break
                except PageError:
                    victim = max((s for s in range(ri * spr, (ri + 1) * spr)
                                  if self.active[s] is not None),
                                 key=lambda s: self._slot_seq[s])
                    self._preempt(victim)
                    if victim == slot:
                        break             # preempted ourselves: give up
        for ri, pairs in copies.items():
            with self.tel.span("page_copy", tid=tmod.TID_LAUNCH,
                               replica=ri, pairs=len(pairs)):
                self._exec_page_copy(ri, pairs)

    def _preempt(self, slot: int) -> None:
        """Evict a request under pool pressure: pages free, the request
        goes back to the queue FRONT.  Without spill it restarts from
        prefill and regenerates its tokens bit-exactly ((uid, step)
        sampling keys; the ``emitted`` watermark stops double delivery);
        with spill the pages are captured to host memory first and resume
        is a device scatter instead of recompute."""
        req = self.active[slot]
        uid = self._slot_uids[slot]
        ri = slot // self.slots_per_replica
        self.stats["preemptions"] += 1
        if self.spill_enabled:
            try:
                rec = self._exec_spill(slot, uid,
                                       self.page_pools[ri].pages(uid))
            except Exception as e:     # spill is best-effort: fall back to
                self.failures.record(  # cold regeneration, stay bit-exact
                    self._round, "spill", f"uid={uid}: {e!r}")
            else:
                self._spilled[uid] = rec
                self.stats["spills"] += 1
        if uid not in self._spilled:
            del req.generated[:]       # keep list identity (stream holds it)
        self.active[slot] = None
        self._release_slot(slot)
        self.pending.appendleft(req)
        self.failures.record(self._round, "preempt", f"uid={uid} slot={slot}")

    def _try_restore(self, req: Request) -> bool:
        """Warm-resume a spilled request into a free slot + fresh pages.
        Returns True when the request was consumed (restored OR failed in
        isolation); False defers it at the queue front."""
        rec = self._spilled[req.uid]
        ri = max(range(self.n_replicas), key=lambda i: len(self._free_r[i]))
        if not self._free_r[ri]:
            return False
        pool = self.page_pools[ri]
        pool.attach(req.uid)
        try:
            ids = pool.alloc(req.uid, rec.n_pages)
        except PageError:
            pool.release(req.uid)
            return False
        slot = self._take_slot(ri)
        self._bind_slot(slot, req)
        try:
            self._exec_restore(slot, rec, ids)
        except Exception as e:
            if not self._isolate_exec:
                raise
            self._release_slot(slot)
            del self._spilled[req.uid]
            self._fail(req, f"spill restore failed: {e!r}", "exec")
            return True
        del self._spilled[req.uid]
        self.active[slot] = req
        self.lengths[slot] = rec.length
        self.last_tokens[slot] = rec.last_token
        self.stats["spill_restores"] += 1
        return True

    def step(self) -> int:
        """One batched decode step over all active slots; returns #active.

        The launch is timed into the straggler EMA (plus any injected
        virtual delay) and guarded by request isolation: a raising decode
        launch fails the live requests and keeps the engine serving."""
        if self.paged:
            # every live slot must own the page its next write hits BEFORE
            # the page tables are snapshotted into the plan
            self._ensure_decode_pages()
        with self.tel.span("plan:decode", tid=tmod.TID_PLAN):
            plan = self._plan_decode()
        if plan is None:
            return 0
        if self.tel.enabled:
            self.tel.round_occupancy.observe(len(plan.live))
        t0 = time.perf_counter()
        try:
            self.fault.on_exec("decode", self._round)
            with self.tel.span("launch:decode", tid=tmod.TID_LAUNCH,
                               live=len(plan.live), round=self._round):
                res = self._exec_decode(plan)
        except Exception as e:
            if not self._isolate_exec:
                raise
            self._abort_launch("decode",
                               [(i, self.active[i]) for i in plan.live
                                if self.active[i] is not None], e)
        else:
            dt = (time.perf_counter() - t0
                  + self.fault.exec_delay("decode", self._round))
            if self.straggler.observe(dt):
                self.failures.record(
                    self._round, "straggler",
                    f"decode launch {dt:.4f}s > {self.straggler.factor:g}x "
                    f"EMA {self.straggler.ema:.4f}s")
            self.stats["straggler_flags"] = self.straggler.flagged
            if self.tel.enabled:
                self.tel.launch_histogram("decode").observe(dt)
            with self.tel.span("apply:decode", tid=tmod.TID_APPLY):
                self._apply_decode(plan, res)
        self._refresh_page_stats()
        return len([r for r in self.active if r is not None])

    def run(self, requests: list[Request], extras=None) -> list[Request]:
        """Drain a request list through the engine (continuous batching).

        Admission is bucket-grouped and batched (``_admit``); completion is
        tracked incrementally: ``step`` appends each finished request to
        ``self.finished`` as its slot frees, so draining is O(1) per
        completion instead of rescanning the whole request list every
        decode step.
        """
        if self._draining:
            raise EngineDraining(
                "engine is draining (request_drain() was called): new "
                "submissions are rejected; resume from the snapshot")
        for r in requests:                 # validate upfront: an oversized
            self._validate(len(r.prompt))  # prompt must not dequeue peers
            self._validate_extras(len(r.prompt), extras)
        if self.tel.enabled:
            now = time.perf_counter()
            for r in requests:
                if r.submitted_at is None:
                    r.submitted_at = now
        self.pending.extend(requests)
        n_active = sum(r is not None for r in self.active)   # pre-submitted
        while self.pending or n_active:
            if self._draining:
                break                 # preempted: snapshot() carries the rest
            self.fault.on_round(self._round)
            if self._draining:
                break
            if self._expire_deadlines():
                n_active = sum(r is not None for r in self.active)
                if not (self.pending or n_active):
                    break
            if self.batch_prefill:
                self._admit(extras)
            else:
                while self.pending and self._free_total():
                    self._submit_one(self.pending.popleft(), extras)
            n_active = self.step()
            self._round += 1
        if self._draining and self.snapshot_path:
            # persist the drain record as part of the preemption path: the
            # relaunch rebuilds its queue via ``resume_requests``
            with self.tel.span("snapshot", tid=tmod.TID_SNAPSHOT):
                save_snapshot(self.snapshot_path, self.snapshot())
        return requests


def resume_requests(snap: dict) -> tuple[list[Request], list[Request]]:
    """Rebuild requests from a drain snapshot: ``(finished, todo)``.

    ``todo`` (in-flight in slot order first, then pending in queue order)
    carries each unfinished request with its progress CLEARED: on resume
    the engine regenerates from the original prompt, and because sampling
    keys derive from (uid, step) - not from engine launch history - token
    n of a request is the identical computation whether or not the run was
    interrupted, on whatever mesh the restarted engine got.  That is what
    makes a killed-and-resumed run token-for-token equal to an
    uninterrupted one without shipping cache pages in the snapshot (a lost
    worker's pages could not be shipped anyway).
    """
    assert snap.get("version") == 1, snap.get("version")

    def unpack(rec: dict, *, clear: bool) -> Request:
        return Request(uid=int(rec["uid"]),
                       prompt=np.asarray(rec["prompt"]),
                       max_new=int(rec["max_new"]),
                       generated=[] if clear else list(rec["generated"]),
                       done=not clear, error=rec.get("error"),
                       finish_reason=None if clear
                       else rec.get("finish_reason"))

    finished = [unpack(rec, clear=False) for rec in snap["finished"]]
    todo = [unpack(rec, clear=True)
            for rec in list(snap["inflight"]) + list(snap["pending"])]
    return finished, todo
