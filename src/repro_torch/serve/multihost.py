"""Multi-process serving: ``MultiHostServeEngine`` over a ``torch.distributed``
gloo group, with a coordinator protocol (port of ``repro/serve/multihost.py``).

Topology.  N OS processes split the 'data' axis of the ('data', 'model')
serve mesh into contiguous blocks (``launch.mesh.make_serve_mesh(...,
processes=N)``): process p hosts the replicas of its block
(``distributed/sharding.process_replicas``), their pools, graphs and
launches.  A replica's shards never straddle processes (a ``data`` axis
that does not divide over the processes raises), so tensor parallelism
stays inside one process and only host data crosses between them: plans,
the command header and sampled tokens, as int32 CPU tensors over gloo.

  * **coordinator (process 0)** runs the scheduler core (serve/core.py) as
    a host-side singleton: the pending queue, bucket grouping and
    least-loaded replica routing live only there.  Each launch it decides
    is announced as a COMMAND: a fixed-shape int32 header (opcode + bucket
    length), exchanged by an ``all_reduce`` to which every process adds its
    own slots, then the plan's arrays, broadcast from rank 0.
  * **workers (process > 0)** run ``serve_worker()``: receive a command,
    run it on their own replicas, repeat until CMD_STOP.  They hold no
    scheduler state.

Every process then runs the same launch body (``ShardedServeEngine``'s
``_start`` / ``_more`` / ``_land_and_sample`` / ``_decode`` /
``_page_copy``) on the replicas it hosts, samples their rows, and the
processes ``all_gather`` their (rows, N) token blocks and health vectors,
so that every process holds the whole block, as the reference's replicated
out-sharding gives it.  Each replica computes what the single-process
sharded engine computes for it, so tokens and every stat that is not per
replica are identical to it.

gloo pairs collectives by the order in which they are posted: every
collective here is posted from the thread that drives the engine, in one
order on every process, and a launch's results reach a collective only
after their copy to the host (which waits for the card).

Failure handling.  The header carries a monotonically increasing sequence
number and a per-process ack slot, so each command doubles as a fleet
heartbeat: the coordinator checks that every worker acked the previous
command, and a desynced worker is a typed ``ProtocolError``.  Aborts are
typed: ``CMD_ABORT`` ships a reason code and workers raise
``CoordinatorAbort``.  Every blocking collective and launch is armed with
a ``DeadlineWatchdog`` (``launch_timeout=`` seconds; None disarms): on
expiry a side thread dumps the coordinator's snapshot (``snapshot_path``),
prints a typed ABORT_DEADLINE line and exits with ``fault.EXIT_DEADLINE``.
Exec-launch exceptions are fleet-fatal here (``_isolate_exec = False``):
recovery is drain-and-resume.  ``FaultInjector.on_broadcast`` sees every
header before it is exchanged.
"""
from __future__ import annotations

import collections
import threading
import time

import numpy as np
import torch

from repro_torch.distributed.fault import (DeadlineWatchdog, _default_deadline_abort,
                                           save_snapshot)
from repro_torch.distributed.sharding import process_replicas

from . import telemetry as tmod
from .core import ChunkedPlan, DecodePlan, PrefillPlan, Request
from .engine import DECODE_PAD, DEFAULT_BUCKETS, copy_map
from .sharded import ShardedServeEngine

# coordinator -> worker opcodes.  Header: int32[4 + 3 * n_processes] =
# [op, arg, seq, n_extras, ack_0..ack_{n-1}, ing_0..ing_{n-1},
#  tim_0..tim_{n-1}] - arg is the bucket length (prefill/chunk), the abort
# reason code, the decode block size, the source process (ingress pull) or
# the replica (page copy); seq numbers every command; ack_p is process p's
# last-completed command seq (the heartbeat); ing_p is the length of
# process p's local ingress queue, so every command exchange doubles as an
# ingress announcement; tim_p is the wall time (microseconds, int32-clamped)
# process p spent executing its PREVIOUS command - the telemetry piggyback,
# which the coordinator folds into per-process launch histograms and, when
# tracing, retroactive worker spans.  Timing costs no extra collective.
CMD_STOP = 0
CMD_PREFILL = 1        # payload: tokens (slots, L), seq_lens, src_map,
                       #          row_uids, row_steps [+ land maps]
                       #          [+ n_extras arrays, each a shape-tag
                       #          header then the values]
CMD_CHUNK_FIRST = 2    # payload: tokens (slots, L), seq_lens, row_uids,
                       #          row_steps (kept for the chunk end)
CMD_CHUNK_NEXT = 3     # payload: tokens (slots, L), seq_lens, start_lens
CMD_CHUNK_END = 4      # payload: src_map [+ land maps]
CMD_DECODE = 5         # payload: tokens (slots, 1), positions (slots, 1),
                       #          row_uids, row_steps, n_steps [+ page
                       #          tables]; arg = the block size N
CMD_ABORT = 6          # coordinator died: workers raise (arg = reason)
CMD_INGRESS = 7        # pull process arg's queued submits: count int32[1]
                       # from arg, then per request meta int32[4] =
                       # [uid, prompt_len, max_new, deadline_ms] + prompt
CMD_POLL = 8           # no-op rendezvous: harvest acks + ingress counts
CMD_PAGE_COPY = 9      # paged pool COW copy on replica arg: payload copy
                       # map (pool_pages,) int32, -1 = keep

# opcode -> launch kind for the header timing piggyback
_CMD_KINDS = {CMD_PREFILL: "prefill", CMD_CHUNK_FIRST: "chunked",
              CMD_CHUNK_NEXT: "chunked", CMD_DECODE: "decode",
              CMD_PAGE_COPY: "page_copy"}

# extras keys the prefill payload can carry (shape-tag header word 0);
# float32 values ride the int32 exchange bit-cast
_EXTRA_KEYS = {"frames": 1, "patches": 2}
_EXTRA_IDS = {v: k for k, v in _EXTRA_KEYS.items()}

# typed abort reasons (CMD_ABORT arg)
ABORT_EXC = 1          # coordinator raised while scheduling
ABORT_DEADLINE = 2     # a deadline watchdog fired fleet-side
ABORT_DESYNC = 3       # heartbeat ack mismatch: a worker fell out of step
ABORT_REASONS = {ABORT_EXC: "coordinator exception",
                 ABORT_DEADLINE: "deadline exceeded",
                 ABORT_DESYNC: "worker desynchronized"}


class ProtocolError(RuntimeError):
    """The command stream itself is corrupt (bad opcode, failed ack)."""


class CoordinatorAbort(RuntimeError):
    """Raised on workers when the coordinator broadcasts CMD_ABORT."""

    def __init__(self, reason: int):
        self.reason = int(reason)
        super().__init__(
            "multi-host serve coordinator aborted: "
            f"{ABORT_REASONS.get(self.reason, f'reason {reason}')}")


def _group():
    """(world size, rank) of the initialized default group, or raise."""
    import torch.distributed as dist
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "MultiHostServeEngine needs the torch.distributed group of its fleet: "
            "call launch.mesh.init_distributed(coordinator, num_processes, "
            "process_id) in every process first")
    return dist.get_world_size(), dist.get_rank()


class MultiHostServeEngine(ShardedServeEngine):
    """ShardedServeEngine over several processes of one ('data', 'model')
    mesh built with ``processes=N``.

    Every process constructs the engine with IDENTICAL arguments (the same
    params: same init seed or checkpoint).  Process 0 then drives
    ``run(requests)``; every other process calls ``serve_worker()`` and
    follows the command stream.  Call ``stop_workers()`` on the
    coordinator when the engine is done so that the workers' loops return.

    Vision/encdec extras ride the prefill payload as shape-tagged float32
    arrays bit-cast to int32; unsupported combinations (unknown keys,
    non-float dtypes, chunked prefill + extras) are typed
    ``ProtocolError``s at submit entry."""

    # a failed launch is fleet-fatal: the workers already rendezvoused on
    # this command, so skipping it on the coordinator alone would desync
    # every later collective
    _isolate_exec = False

    def __init__(self, cfg, params, *, mesh, slots_per_replica: int = 4,
                 max_len: int = 256, quantize_weights: bool = False,
                 temperature: float = 0.0, seed: int | None = None,
                 buckets: tuple[int, ...] = DEFAULT_BUCKETS,
                 chunked_prefill: bool = False, decode_steps: int = 1,
                 fault=None, pdq_fallback: bool = False,
                 launch_timeout: float | None = None,
                 snapshot_path: str | None = None,
                 paged: bool = False, page_size: int = 64,
                 pool_pages: int | None = None, prefix_sharing: bool = True,
                 telemetry: bool = True, trace: bool = False):
        self.n_processes, self.process_id = _group()
        self.is_coordinator = self.process_id == 0
        data = int(mesh.shape["data"])
        if data % self.n_processes:
            # a mesh row straddling a process boundary would make TP a
            # cross-process collective
            raise ValueError(f"mesh 'data' axis ({data}) must divide over the "
                             f"{self.n_processes} torch.distributed processes")
        self.host_replicas = process_replicas(mesh)
        if sorted(self.host_replicas) != list(range(self.n_processes)):
            raise ValueError(
                f"the mesh's processes {sorted(self.host_replicas)} are not the group's "
                f"{self.n_processes}: build it with make_serve_mesh(..., "
                f"processes={self.n_processes})")
        self._stopped = False
        self.launch_timeout = launch_timeout
        self._hdr = 4 + 3 * self.n_processes
        self._seq = 1                  # next command number (coordinator)
        self._done_seq = 0             # last completed command (workers)
        self._last_exec_us = 0         # worker: previous command exec wall
        self._prev_kind = None         # coordinator: previous command kind
        self._chunk_us = None          # (uids, steps) held across chunk cmds
        # worker-side ingress: local submits queued for coordinator pickup
        self._ingress_lock = threading.Lock()
        self._out_q: collections.deque = collections.deque()
        self._ingress_counts = [0] * self.n_processes
        self._remote: dict[int, dict] = {}   # uid -> {'max_new', 'tokens'}
        self._remote_seq = 1
        # each process's Telemetry is keyed by its process index; the
        # coordinator's also aggregates the fleet (piggybacked timings)
        tel = tmod.Telemetry(enabled=telemetry, trace=trace, pid=self.process_id)
        super().__init__(cfg, params, mesh=mesh, slots_per_replica=slots_per_replica,
                         max_len=max_len, quantize_weights=quantize_weights,
                         temperature=temperature, seed=seed, buckets=buckets,
                         chunked_prefill=chunked_prefill, decode_steps=decode_steps,
                         fault=fault, pdq_fallback=pdq_fallback, paged=paged,
                         page_size=page_size, pool_pages=pool_pages,
                         prefix_sharing=prefix_sharing, tel=tel)
        if self.is_coordinator:
            for p in range(1, self.n_processes):
                self.tel.tracer.name_process(p, f"process {p}")
                self.tel.tracer.name_thread(p, tmod.TID_LAUNCH, "launch")
        self.snapshot_path = snapshot_path
        self.stats["remote_ingress"] = 0   # requests pulled from workers

    def _hosted(self) -> list[int]:
        return process_replicas(self.mesh)[self.process_id]

    # ------------------------------------------------- deadline watchdogs
    def _deadline(self, reason: str) -> DeadlineWatchdog:
        """Arm a watchdog around one blocking collective or launch;
        disarmed when ``launch_timeout`` is None or the fleet is one
        process."""
        seconds = self.launch_timeout if self.n_processes > 1 else None
        return DeadlineWatchdog(seconds, reason=reason, on_timeout=self._deadline_abort)

    def _deadline_abort(self, reason: str, seconds: float) -> None:
        # the main thread is stuck inside a collective, but the host-side
        # scheduler state is consistent between result applications: dump
        # the drain record first, then declare this process dead
        if self.is_coordinator and self.snapshot_path:
            try:
                save_snapshot(self.snapshot_path, self.snapshot())
            except Exception:
                pass
        _default_deadline_abort(f"process {self.process_id}: {reason}", seconds)

    # -------------------------------------------------------- collectives
    def _broadcast(self, arrays, *, all_ranks: bool = False,
                   src: int = 0) -> list[np.ndarray]:
        """Exchange int32 arrays across the fleet, all in ONE collective
        (every process passes equal shapes).  Default: one-to-all from
        ``src`` (the coordinator ships plans with src=0, an ingress pull
        reverses direction).  With ``all_ranks`` every process adds its
        own slots (the others zero) and all read the sum: the command
        header, whose acks and ingress counts ride the same exchange."""
        arrays = [np.ascontiguousarray(a, np.int32) for a in arrays]
        if self.n_processes == 1:
            return arrays
        import torch.distributed as dist
        flat = torch.from_numpy(np.concatenate([a.ravel() for a in arrays]))
        with self._deadline("collective broadcast"):
            if all_ranks:
                dist.all_reduce(flat)
            else:
                dist.broadcast(flat, src)
        out, i = [], 0
        for a in arrays:
            out.append(flat[i:i + a.size].numpy().reshape(a.shape))
            i += a.size
        return out

    def _collect(self, parts, n: int):
        """Every process's replicas' packed outputs, ``all_gather``ed in
        process order (= replica order), so every process holds the whole
        block."""
        if self.n_processes > 1:
            import torch.distributed as dist
            mine = torch.from_numpy(np.concatenate(parts))
            every = [torch.empty_like(mine) for _ in range(self.n_processes)]
            with self._deadline("token gather"):
                dist.all_gather(every, mine)
            parts = np.split(torch.cat(every).numpy(), self.data_size)
        return super()._collect(parts, n)

    # ----------------------------------------------------- command stream
    def _cmd(self, op: int, arg: int = 0, n_extras: int = 0) -> None:
        if not self.is_coordinator:
            # a worker that drives scheduling would contribute zero rows to
            # its own command and desync the fleet
            raise RuntimeError(
                f"process {self.process_id} is a worker: only the coordinator "
                "(process 0) issues commands; call serve_worker() here")
        seq = self._seq
        N = self.n_processes
        hdr = np.zeros((self._hdr,), np.int32)
        hdr[0], hdr[1], hdr[2], hdr[3] = op, arg, seq, n_extras
        hdr[4] = seq - 1                 # coordinator's own ack slot
        hdr = self.fault.on_broadcast(seq, hdr)
        out, = self._broadcast((hdr,), all_ranks=True)
        self._seq += 1
        self._ingress_counts = [int(out[4 + N + p]) for p in range(N)]
        # slot p carries the wall time of worker p's PREVIOUS command
        if self._prev_kind is not None and self.tel.enabled:
            tr = self.tel.tracer
            for p in range(1, N):
                us = int(out[4 + 2 * N + p])
                if us > 0:
                    self.tel.launch_histogram(self._prev_kind, process=p).observe(us / 1e6)
                    if tr.enabled:
                        tr.add(f"launch:{self._prev_kind}", ts=tr.now_us() - us, dur=us,
                               pid=p, tid=tmod.TID_LAUNCH, args={"process": p})
        self._prev_kind = _CMD_KINDS.get(op)
        # the worker loop is sequential: at this rendezvous every live
        # worker must have completed seq - 1 exactly
        for p in range(1, N):
            if int(out[4 + p]) != seq - 1:
                raise ProtocolError(
                    f"worker {p} acked command seq {int(out[4 + p])} at command seq "
                    f"{seq} (expected {seq - 1}): the fleet is desynchronized")

    def _recv_cmd(self) -> tuple[int, int, int, int]:
        hdr = np.zeros((self._hdr,), np.int32)
        hdr[4 + self.process_id] = self._done_seq      # heartbeat/ack
        with self._ingress_lock:                       # queued submits
            hdr[4 + self.n_processes + self.process_id] = len(self._out_q)
        hdr[4 + 2 * self.n_processes + self.process_id] = self._last_exec_us
        hdr = self.fault.on_broadcast(self._done_seq + 1, hdr)
        out, = self._broadcast((hdr,), all_ranks=True)
        op, arg, seq, n_ex = (int(out[0]), int(out[1]), int(out[2]), int(out[3]))
        if op == CMD_ABORT:
            raise CoordinatorAbort(arg)
        return op, arg, seq, n_ex

    def _send(self, arrays) -> None:
        self._broadcast(arrays)

    def _recv(self, shapes) -> list[np.ndarray]:
        return self._broadcast([np.zeros(s, np.int32) for s in shapes])

    # ------------------------------------------------------ extras payload
    # header int32[6] = [key_id, ndim, d0, d1, d2, d3], then the raveled
    # float32 buffer reinterpreted as int32 (bit-preserving in transit)
    def _norm_extras(self, extras) -> list[tuple[str, np.ndarray]]:
        return [(k, np.ascontiguousarray(np.asarray(extras[k], np.float32)))
                for k in sorted(dict(extras or {}))]

    def _send_extras(self, ex) -> None:
        for key, a in ex:
            hdr = np.zeros((6,), np.int32)
            hdr[0], hdr[1] = _EXTRA_KEYS[key], a.ndim
            hdr[2:2 + a.ndim] = a.shape
            self._send([hdr])
            self._send([a.ravel().view(np.int32)])

    def _recv_extras(self, n: int) -> dict[str, np.ndarray]:
        ex = {}
        for _ in range(n):
            hdr, = self._recv([(6,)])
            key = _EXTRA_IDS.get(int(hdr[0]))
            nd = int(hdr[1])
            if key is None or not 1 <= nd <= 4:
                raise ProtocolError(f"bad extras shape tag {hdr.tolist()} in prefill "
                                    "payload (unknown key id or ndim out of range)")
            shape = tuple(int(d) for d in hdr[2:2 + nd])
            flat, = self._recv([(int(np.prod(shape)),)])
            ex[key] = flat.view(np.float32).reshape(shape)
        return ex

    # ------------------------------------------------- shared launch bodies
    # Each _do_* runs on EVERY process with identical host arrays (the
    # coordinator's plan, local or just received) on the replicas it hosts.
    def _do_prefill(self, tokens, seq_lens, src_map, uids, steps, extras=None,
                    land_rows=None, land_js=None):
        with self._deadline("prefill launch"):
            self._start(tokens, seq_lens, extras)
            return self._do_land(src_map, land_rows, land_js, uids, steps)

    def _do_chunk_first(self, tokens, seq_lens, uids, steps) -> None:
        self._chunk_us = (uids, steps)
        with self._deadline("chunked-prefill launch"):
            self._start(tokens, seq_lens)

    def _do_chunk_next(self, tokens, seq_lens, start_lens) -> None:
        with self._deadline("chunked-prefill launch"):
            self._more(tokens, seq_lens, start_lens)

    def _do_chunk_end(self, src_map, land_rows=None, land_js=None):
        uids, steps = self._chunk_us
        self._chunk_us = None
        with self._deadline("chunk landing"):
            return self._do_land(src_map, land_rows, land_js, uids, steps)

    def _do_land(self, src_map, land_rows, land_js, uids, steps):
        nxt, ok, health = self._land_and_sample(src_map, land_rows, land_js, uids, steps)
        self._observe_pdq(health)       # fleet totals, every process
        self._track_remote(nxt, ok, uids, steps)
        return nxt, ok

    def _do_decode(self, tokens, positions, uids, steps, n_steps, page_tables=None):
        with self._deadline("decode launch"):
            nxt, ok, health = self._decode(tokens, positions, uids, steps, n_steps,
                                           page_tables)
        self._observe_pdq(health)
        self._track_remote(nxt, ok, uids, steps)
        return nxt, ok

    def _do_page_copy(self, replica: int, cmap) -> None:
        with self._deadline("page copy launch"):
            self._page_copy(replica, cmap)

    def _track_remote(self, nxt, ok, uids, steps) -> None:
        """Worker-side token mirror for its own remote submits, read off
        the gathered token blocks of the plans it executes (no backhaul).
        A token lands only if its step equals the tokens mirrored so far;
        a row's block walk stops at the first bad token."""
        if not self._remote:
            return
        uids = np.asarray(uids)
        steps = np.asarray(steps)
        nxt = np.asarray(nxt).reshape(len(uids), -1)
        ok = np.asarray(ok).reshape(len(uids), -1)
        for row, uid in enumerate(uids):
            rec = self._remote.get(int(uid))
            if rec is None:
                continue
            for t in range(nxt.shape[1]):
                tok = int(nxt[row, t])
                if (not bool(ok[row, t]) or tok == DECODE_PAD
                        or int(steps[row]) + t != len(rec["tokens"])
                        or len(rec["tokens"]) >= rec["max_new"]):
                    break
                rec["tokens"].append(tok)

    # ----------------------------------------------------- coordinator side
    def _land_payload(self, plan) -> list:
        return [plan.land_rows, plan.land_js] if self.paged else []

    def _exec_prefill(self, plan: PrefillPlan, extras):
        ex = self._norm_extras(extras)
        self._cmd(CMD_PREFILL, plan.bucket, n_extras=len(ex))
        self._send([plan.tokens, plan.seq_lens, plan.src_map, plan.row_uids,
                    plan.row_steps] + self._land_payload(plan))
        self._send_extras(ex)
        # launch on the wire-format (float32) extras, as the workers do
        nxt, ok = self._do_prefill(plan.tokens, plan.seq_lens, plan.src_map,
                                   plan.row_uids, plan.row_steps, extras=dict(ex),
                                   land_rows=plan.land_rows, land_js=plan.land_js)
        return nxt, self._poison_ok("prefill", plan, ok)

    def _exec_chunked(self, plan: ChunkedPlan, extras):
        if extras:
            # unreachable for well-formed use: _validate_extras rejects it
            raise ProtocolError("chunked-prefill commands carry no extras payload")
        b, tokens, seq_lens = plan.first
        self._cmd(CMD_CHUNK_FIRST, b)
        self._send([tokens, seq_lens, plan.row_uids, plan.row_steps])
        self._do_chunk_first(tokens, seq_lens, plan.row_uids, plan.row_steps)
        for b, tokens, seq_lens, start_lens in plan.chunks:
            self._cmd(CMD_CHUNK_NEXT, b)
            self._send([tokens, seq_lens, start_lens])
            self._do_chunk_next(tokens, seq_lens, start_lens)
        self._cmd(CMD_CHUNK_END)
        self._send([plan.src_map] + self._land_payload(plan))
        nxt, ok = self._do_chunk_end(plan.src_map, plan.land_rows, plan.land_js)
        return nxt, self._poison_ok("chunked", plan, ok)

    def _exec_decode(self, plan: DecodePlan):
        # arg carries the block size N: a worker built with another
        # decode_steps would run another block and desync the fleet
        self._cmd(CMD_DECODE, self.decode_steps)
        payload = [plan.tokens, plan.positions, plan.row_uids, plan.row_steps,
                   plan.n_steps]
        if self.paged:
            payload.append(plan.page_tables)
        self._send(payload)
        nxt, ok = self._do_decode(plan.tokens, plan.positions, plan.row_uids,
                                  plan.row_steps, plan.n_steps, plan.page_tables)
        return nxt, self._poison_ok("decode", plan, ok)

    def _exec_page_copy(self, replica: int, pairs) -> None:
        cmap = copy_map(self.pool_pages, pairs)
        self._cmd(CMD_PAGE_COPY, replica)
        self._send([cmap])
        self._do_page_copy(replica, cmap)

    def _validate_extras(self, prompt_len: int, extras) -> None:
        # rejected at the entry point, before anything queues: these are
        # what the COMMAND STREAM cannot carry
        if not extras:
            return
        for key, v in dict(extras).items():
            if key not in _EXTRA_KEYS:
                raise ProtocolError(
                    f"extras key {key!r} is not part of the multi-host command "
                    f"protocol (known: {sorted(_EXTRA_KEYS)})")
            a = np.asarray(v)
            if a.dtype.kind != "f":
                raise ProtocolError(
                    f"extras[{key!r}] dtype {a.dtype} is not a float type: the "
                    "prefill payload bit-casts float32 over the int32 exchange")
            if not 1 <= a.ndim <= 4:
                raise ProtocolError(f"extras[{key!r}] ndim {a.ndim} exceeds the "
                                    "shape-tag header (1..4 dims)")
        if self.chunked_prefill and prompt_len > self.buckets[-1]:
            raise ProtocolError(
                "chunked-prefill commands carry no extras payload: oversized prompt "
                f"({prompt_len} > bucket {self.buckets[-1]}) cannot combine with "
                "vision/encdec extras on a multi-host fleet")

    def run(self, requests, extras=None):
        if not self.is_coordinator:
            raise RuntimeError(f"process {self.process_id} is a worker: call "
                               "serve_worker(), only process 0 drives run()")
        if extras:
            self._validate_extras(0, extras)
        try:
            return super().run(requests, extras)
        except BaseException as e:
            self._fleet_abort(e)
            raise

    def _fleet_abort(self, e: BaseException) -> None:
        # persist the drain record first, then best-effort release workers
        # waiting at the next header (a worker stuck inside a payload
        # collective is the watchdog's); the workers then exit, so the
        # fleet is stopped (serve/service.py's step loop shares this)
        if self.snapshot_path:
            try:
                save_snapshot(self.snapshot_path, self.snapshot())
            except Exception:
                pass
        reason = ABORT_DESYNC if isinstance(e, ProtocolError) else ABORT_EXC
        try:
            self._cmd(CMD_ABORT, reason)
        except Exception:
            pass               # peer already gone: keep the original error
        finally:
            self._stopped = True

    def stop_workers(self) -> None:
        """Release the worker loops; the engine stays usable for stats."""
        if self.is_coordinator and not self._stopped:
            self._cmd(CMD_STOP)
            self._stopped = True

    # ------------------------------------------------------ worker ingress
    # A request can enter the fleet through ANY process: a worker's
    # submit_remote() queues locally, the queue LENGTH rides every header
    # exchange, and the coordinator pulls the payload with CMD_INGRESS (at
    # its next command, or an explicit CMD_POLL when idle).  Tokens need no
    # backhaul: every process holds every sampled token block.
    def submit_remote(self, prompt, *, max_new: int = 16, deadline_ms: int = 0) -> int:
        """Worker-side submit: queue a request for coordinator pickup;
        returns its fleet-unique uid (namespaced by process id).
        ``deadline_ms`` is RELATIVE (processes share no clock); 0 = none."""
        if self.is_coordinator:
            raise RuntimeError("the coordinator submits locally (submit()/ServeService)")
        uid = (self.process_id << 20) | self._remote_seq
        self._remote_seq += 1
        prompt = np.asarray(prompt, np.int32)
        self._remote[uid] = {"max_new": int(max_new), "tokens": []}
        with self._ingress_lock:
            self._out_q.append((uid, prompt, int(max_new), int(deadline_ms)))
        return uid

    def remote_tokens(self, uid: int) -> list[int]:
        """Tokens mirrored so far for a submit_remote() uid (worker-side)."""
        return list(self._remote[uid]["tokens"])

    def remote_done(self, uid: int) -> bool:
        rec = self._remote[uid]
        return len(rec["tokens"]) >= rec["max_new"]

    def poll_ingress(self) -> list[Request]:
        """Coordinator: pull every announced worker submit into Requests.
        Issues a CMD_POLL rendezvous first when no counts are known yet."""
        if not self.is_coordinator or self.n_processes == 1 or self._stopped:
            return []
        if not any(self._ingress_counts[1:]):
            self._cmd(CMD_POLL)
        out: list[Request] = []
        for p in range(1, self.n_processes):
            if self._ingress_counts[p]:
                out.extend(self._pull_ingress(p))
        self.stats["remote_ingress"] += len(out)
        return out

    def _pull_ingress(self, p: int) -> list[Request]:
        self._cmd(CMD_INGRESS, p)
        cnt, = self._broadcast((np.zeros((1,), np.int32),), src=p)
        reqs = []
        for _ in range(int(cnt[0])):
            meta, = self._broadcast((np.zeros((4,), np.int32),), src=p)
            uid, L, max_new, dl_ms = (int(x) for x in meta)
            prompt, = self._broadcast((np.zeros((L,), np.int32),), src=p)
            r = Request(uid=uid, prompt=prompt.astype(np.int32), max_new=max_new)
            if dl_ms > 0:
                r.deadline = self._clock() + dl_ms / 1000.0
            reqs.append(r)
        return reqs

    def _serve_ingress(self, src: int) -> None:
        """Worker side of CMD_INGRESS: process ``src`` drains its queue onto
        the wire; every other process contributes zeros and discards."""
        mine = src == self.process_id
        if mine:
            with self._ingress_lock:
                batch = list(self._out_q)
                self._out_q.clear()
        else:
            batch = []
        cnt, = self._broadcast((np.array([len(batch)], np.int32),), src=src)
        for i in range(int(cnt[0])):
            if mine:
                uid, prompt, max_new, dl_ms = batch[i]
                meta = np.array([uid, len(prompt), max_new, dl_ms], np.int32)
            else:
                meta = np.zeros((4,), np.int32)
            meta, = self._broadcast((meta,), src=src)
            pr = batch[i][1] if mine else np.zeros((int(meta[1]),), np.int32)
            self._broadcast((pr,), src=src)

    # --------------------------------------------------------- worker loop
    def serve_worker(self) -> None:
        """Follow the coordinator's command stream until CMD_STOP.  Each
        completed command's seq is acked on the NEXT header exchange; a
        coordinator abort raises ``CoordinatorAbort``, an unknown opcode
        ``ProtocolError``."""
        if self.is_coordinator:
            raise RuntimeError("process 0 is the coordinator: it drives run()")
        S = self.slots
        Np = self.pool_pages * self.n_replicas if self.paged else 0
        lnd = [(Np,), (Np,)] if self.paged else []
        while True:
            op, arg, seq, n_ex = self._recv_cmd()
            if op == CMD_STOP:
                return
            t0 = time.perf_counter()   # stamped on the NEXT header exchange
            if op == CMD_PREFILL:
                recv = self._recv([(S, arg), (S,), (S,), (S,), (S,)] + lnd)
                ex = self._recv_extras(n_ex)
                self._do_prefill(*recv[:5], extras=ex, land_rows=recv[5] if lnd else None,
                                 land_js=recv[6] if lnd else None)
            elif op == CMD_CHUNK_FIRST:
                self._do_chunk_first(*self._recv([(S, arg), (S,), (S,), (S,)]))
            elif op == CMD_CHUNK_NEXT:
                self._do_chunk_next(*self._recv([(S, arg), (S,), (S,)]))
            elif op == CMD_CHUNK_END:
                recv = self._recv([(S,)] + lnd)
                self._do_chunk_end(recv[0], recv[1] if lnd else None,
                                   recv[2] if lnd else None)
            elif op == CMD_DECODE:
                if arg != self.decode_steps:
                    raise ProtocolError(
                        f"coordinator decode block size {arg} != this worker's "
                        f"decode_steps {self.decode_steps}: every process must "
                        "construct the engine with identical arguments")
                recv = self._recv([(S, 1), (S, 1), (S,), (S,), (S,)]
                                  + ([(S, self.n_pp)] if self.paged else []))
                self._do_decode(*recv[:5], page_tables=recv[5] if self.paged else None)
            elif op == CMD_PAGE_COPY:
                cmap, = self._recv([(self.pool_pages,)])
                self._do_page_copy(arg, cmap)
            elif op == CMD_INGRESS:
                self._serve_ingress(arg)
            elif op == CMD_POLL:
                pass        # pure rendezvous: ack + counts already rode it
            else:
                raise ProtocolError(
                    f"unknown multi-host serve opcode {op} at command seq {seq} "
                    "(corrupt or desynchronized command stream)")
            if op in _CMD_KINDS:
                self._last_exec_us = int(min((time.perf_counter() - t0) * 1e6, 2**31 - 1))
            self._done_seq = seq

    # ------------------------------------------------------ per-host stats
    def host_stats(self) -> dict[int, dict[str, int]]:
        """Coordinator-side admit/occupancy totals per OWNING process, from
        the replica -> process map (the scheduler lives on process 0)."""
        out: dict[int, dict[str, int]] = {}
        for proc, reps in self.host_replicas.items():
            out[proc] = {
                "replicas": len(reps),
                "admits": sum(self.stats["replica_admits"][r] for r in reps),
                "occupied": sum(self.stats["replica_occupancy"][r] for r in reps),
                "slots": len(reps) * self.slots_per_replica,
            }
        return out


__all__ = ["ABORT_DEADLINE", "ABORT_DESYNC", "ABORT_EXC", "ABORT_REASONS",
           "CoordinatorAbort", "MultiHostServeEngine", "ProtocolError"]
