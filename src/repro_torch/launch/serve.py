"""Serving driver, single device (the single-device subset of
``repro/launch/serve.py``): bucketed batched prefill + continuous batching
with the PDQ-int8 path, on the card unless ``--device cpu``.

    PYTHONPATH=src python -m repro_torch.launch.serve --reduced \
        --requests 8 --max-new 16 [--int8] [--int8-kv] [--paged] \
        [--decode-steps 4] [--pdq-fallback] [--no-telemetry] [--device cpu]

``--arch`` picks a registered model (stablelm-1.6b, gemma3-12b, gemma2-2b,
yi-6b, deepseek-v2-236b, arctic-480b, mamba2-2.7b, zamba2-7b,
phi-3-vision-4.2b, seamless-m4t-medium; the last two serve the canned trace
with seeded stub extras, ``models.frontend.stub_extras``: patches prepended
to every prompt, or the encoder's frames); ``--chunked-prefill`` splits
prompts longer than the largest bucket into chunks of that bucket's length
(``--prompt-len`` sets the longest canned prompt).

``--http PORT`` serves the streaming front door instead of a canned trace
(``ServeService`` + ``HttpFrontend``: ``POST /v1/completions`` with SSE,
``GET /healthz``, ``/v1/stats``, ``/metrics``, ``/v1/events``; 0 picks a
free port, printed on startup).  SIGTERM/SIGINT drain, snapshot
(``--snapshot``) and exit cleanly.

``--legacy-prefill`` serves with the per-request prefill baseline
(``batch_prefill=False``: every request prefills alone at its exact
length; not with ``--paged`` or ``--chunked-prefill``).

``--mesh DxM`` serves over a data x model mesh (``ShardedServeEngine``,
``--slots-per-replica`` slots a replica, default ``--slots``): on the card
it takes the first D*M CUDA devices, replica r's M shards on cards r*M ..
r*M + M - 1 (tensor parallelism across cards: each shard holds its own
block of every split weight and the replica's decode graph spans its
cards), and raises with the count when there are fewer, or when a row's
cards are not peers; with ``--device cpu`` every entry is the CPU.
``--num-processes N`` splits the mesh's data axis over N processes
(``MultiHostServeEngine`` over a gloo group): the launcher spawns the
children (each with ``--process-id`` and ``--coordinator``; on the card
each sees its own block of D*M/N cards), exits non-zero when one dies and
forwards SIGTERM to the coordinator first.  ``--launch-timeout`` arms the
fleet's deadline watchdog on every collective.

``--prompts FILE`` serves the prompts of a JSON list of token-id lists
(``--max-new`` new tokens each) in place of the canned trace and prints
every request's tokens.
"""
from __future__ import annotations

import argparse
import collections
import json
import os
import signal
import subprocess
import sys
import threading
import time

import numpy as np


def build_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="stablelm-1.6b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--int8", action="store_true", help="PDQ int8 weights")
    ap.add_argument("--int8-kv", action="store_true", help="int8 KV cache")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--decode-steps", type=int, default=1,
                    help="decode tokens fused per host dispatch (one captured "
                         "graph on the card; 1 = per-token dispatches)")
    ap.add_argument("--prompt-len", type=int, default=8,
                    help="max prompt length (lengths are drawn in [1, this])")
    ap.add_argument("--buckets", default="32,64,128,256",
                    help="comma-separated prefill length buckets")
    ap.add_argument("--paged", action="store_true",
                    help="paged KV pool: fixed-size pages + indirection tables "
                         "instead of slot rows (prefix sharing, preempt-and-"
                         "requeue under pressure)")
    ap.add_argument("--page-size", type=int, default=64,
                    help="tokens per KV page (--paged)")
    ap.add_argument("--pool-pages", type=int, default=None,
                    help="physical pages (--paged; default sizes the pool for "
                         "slot-row parity)")
    ap.add_argument("--no-prefix-sharing", action="store_true",
                    help="disable copy-on-write prompt-prefix sharing (--paged)")
    ap.add_argument("--spill", action="store_true",
                    help="spill preempted pages to host memory for warm resume "
                         "(--paged)")
    ap.add_argument("--snapshot", default=None, metavar="PATH",
                    help="write the scheduler drain record here on preemption "
                         "(SIGTERM)")
    ap.add_argument("--resume", default=None, metavar="PATH",
                    help="requeue the unfinished requests of a previous run's "
                         "--snapshot record instead of generating a fresh trace")
    ap.add_argument("--pdq-fallback", action="store_true",
                    help="guard every PDQ projection with a per-launch "
                         "fp-dequant fallback on non-finite output")
    ap.add_argument("--http", type=int, default=None, metavar="PORT",
                    help="serve an HTTP front door instead of a canned trace: "
                         "POST /v1/completions (SSE streaming), GET /healthz, "
                         "GET /v1/stats; 0 picks a free port (printed on "
                         "startup).  SIGTERM/SIGINT drain, snapshot "
                         "(--snapshot) and exit cleanly")
    ap.add_argument("--max-pending", type=int, default=32,
                    help="HTTP admission watermark: submits past this many "
                         "queued requests are shed with 429 + Retry-After")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="write a Chrome-trace-event JSON of request/phase "
                         "spans here on exit")
    ap.add_argument("--no-telemetry", action="store_true",
                    help="disable the metrics registry, lifecycle timing and "
                         "the PDQ health counters (/metrics then renders empty)")
    ap.add_argument("--chunked-prefill", action="store_true",
                    help="split prompts longer than the largest bucket into chunks")
    ap.add_argument("--device", default="cuda",
                    help="the engine's device: the card unless 'cpu'")
    ap.add_argument("--mesh", default=None, metavar="DxM",
                    help="serve over a data x model device mesh (ShardedServeEngine)")
    ap.add_argument("--slots-per-replica", type=int, default=None,
                    help="cache slots per data-parallel replica (default: --slots)")
    ap.add_argument("--num-processes", type=int, default=1,
                    help="split --mesh over N processes (spawns the children "
                         "unless --process-id is set)")
    ap.add_argument("--process-id", type=int, default=None,
                    help="this child's process index (set by the --num-processes "
                         "launcher)")
    ap.add_argument("--coordinator", default=None,
                    help="the process group's HOST:PORT (default: the launcher "
                         "picks a free local port; a hand-started child needs one)")
    ap.add_argument("--launch-timeout", type=float, default=None,
                    help="per-launch deadline (seconds) for multi-process "
                         "collectives; a hung rendezvous exits with the typed "
                         "watchdog code instead of blocking forever")
    ap.add_argument("--legacy-prefill", action="store_true")
    ap.add_argument("--prompts", default=None, metavar="FILE",
                    help="a JSON list of token-id lists to serve in place of the "
                         "canned trace")
    return ap.parse_args(argv)


def _fmt_ms(seconds: float) -> str:
    return f"{seconds * 1e3:.1f}ms"


def report_telemetry(eng, args) -> None:
    """Drain/exit printout: latency histogram summaries (p50/p90/p99), the
    shed rate and the PDQ health, plus the --trace-out write.  Shared by
    the canned-trace and --http exits."""
    summ = eng.tel.summary()
    for key, label in (("ttft", "ttft"), ("per_token", "per-token"),
                       ("queue_wait", "queue wait")):
        s = summ.get(key)
        if s and s["count"]:
            print(f"  {label}: n={s['count']} p50={_fmt_ms(s['p50'])} "
                  f"p90={_fmt_ms(s['p90'])} p99={_fmt_ms(s['p99'])}")
    shed = eng.stats.get("shed", 0)
    served = len(eng.finished)
    if shed:
        print(f"  shed: {shed} requests "
              f"({shed / max(shed + served, 1):.1%} of submitted)")
    total = eng.stats["pdq_clip_total"]
    if total:
        print(f"  pdq: fallbacks={eng.stats['pdq_fallbacks']} "
              f"clip_hits={eng.stats['pdq_clip_hits']} clip_total={total} "
              f"clip_rate={eng.stats['pdq_clip_hits'] / total:.6f}")
    if args.trace_out:
        eng.tel.tracer.write(args.trace_out)
        n = len(eng.tel.tracer.events())
        print(f"  trace: {n} spans -> {args.trace_out}", flush=True)


def _tee_stderr(proc, ring) -> threading.Thread:
    """Stream a child's stderr to ours while keeping its tail in ``ring``
    (the launcher's post-mortem: what the dead process last said)."""

    def pump():
        for line in iter(proc.stderr.readline, ""):
            ring.append(line.rstrip("\n"))
            sys.stderr.write(line)
            sys.stderr.flush()
        proc.stderr.close()

    t = threading.Thread(target=pump, daemon=True)
    t.start()
    return t


def _exit_meaning(rc: int) -> str | None:
    from repro_torch.distributed.fault import EXIT_DEADLINE, EXIT_KILLED
    return {EXIT_DEADLINE: "deadline watchdog: hung collective or dead peer",
            EXIT_KILLED: "fault injection kill"}.get(rc)


PEER_GRACE_S = 5.0       # how long the launcher waits for a dead child's peers


def _peer_deaths(live) -> list[tuple[int, int]]:
    """(process, exit code) of each child in ``live`` that exits non-zero
    within ``PEER_GRACE_S``, in the order seen; the exited leave ``live``."""
    dead, end = [], time.monotonic() + PEER_GRACE_S
    while live and time.monotonic() < end:
        time.sleep(0.1)
        for j, q in list(live.items()):
            if q.poll() is not None:
                del live[j]
                if q.returncode != 0:
                    dead.append((j, q.returncode))
    return dead


def spawn_processes(args, argv) -> int:
    """Launcher mode: one child per process, fail fast and loud.

    Children share this terminal's stdout; their stderr is teed through a
    ring buffer.  The first child to exit non-zero takes the fleet down:
    the others are terminated, and the launcher reports which process
    died, its exit code (the typed watchdog / fault-injection codes
    decoded) and the last lines it wrote to stderr.  A peer's collectives
    break the moment one process leaves the group, so the first death seen
    is not always the cause: every child that dies within
    ``PEER_GRACE_S`` of the first is reported too, in the order seen.  A SIGTERM (or SIGINT)
    to the launcher goes to the coordinator child first: it drains,
    snapshots (--snapshot) and releases the workers through the command
    protocol, so the whole fleet exits cleanly."""
    from repro_torch.launch.mesh import parse_mesh, pick_coordinator
    data, model = parse_mesh(args.mesh)
    if data % args.num_processes:
        raise SystemExit(f"--mesh data axis ({data}) must divide over "
                         f"--num-processes ({args.num_processes})")
    if args.device != "cpu":
        import torch
        have = torch.cuda.device_count()
        if have < data * model:
            raise SystemExit(f"--mesh {args.mesh} over {args.num_processes} processes "
                             f"needs {data * model} CUDA devices, found {have}")
    coordinator = pick_coordinator(args.coordinator)
    per = data * model // args.num_processes
    procs = []
    for i in range(args.num_processes):
        env = dict(os.environ)
        if args.device != "cpu" and "CUDA_VISIBLE_DEVICES" not in env:
            # each child sees its own block of the cards as cuda:0..per-1
            env["CUDA_VISIBLE_DEVICES"] = ",".join(str(i * per + k) for k in range(per))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.serve", *argv,
             "--coordinator", coordinator, "--process-id", str(i)], env=env,
            stderr=subprocess.PIPE, text=True))
    return run_fleet(procs, "serve")


def run_fleet(procs, name: str) -> int:
    """Watch a launcher's children (started with ``stderr=PIPE``) to the
    end, as ``spawn_processes`` describes: the exit code of the first to
    die, else 0."""
    rings = [collections.deque(maxlen=20) for _ in procs]
    tees = [_tee_stderr(p, r) for p, r in zip(procs, rings)]
    live = dict(enumerate(procs))

    def forward_term(signum, frame):
        if 0 in live:
            live[0].send_signal(signal.SIGTERM)     # the coordinator drains

    prev = signal.signal(signal.SIGTERM, forward_term)
    prev_int = signal.signal(signal.SIGINT, forward_term)
    try:
        while live:
            time.sleep(0.2)
            for i, p in list(live.items()):
                rc = p.poll()
                if rc is None:
                    continue
                del live[i]
                if rc != 0:
                    dead = [(i, rc)] + _peer_deaths(live)
                    for t in tees:
                        t.join(timeout=2)
                    for j, code in dead:
                        meaning = _exit_meaning(code)
                        print(f"{name} launcher: process {j} died with exit code {code}"
                              f"{f' [{meaning}]' if meaning else ''}", file=sys.stderr)
                        for line in rings[j]:
                            print(f"  [proc {j}] {line}", file=sys.stderr)
                    print(f"{name} launcher: terminating {len(live)} remaining",
                          file=sys.stderr, flush=True)
                    for q in live.values():
                        q.terminate()
                    for q in live.values():
                        q.wait()
                    return rc
        return 0
    finally:
        signal.signal(signal.SIGTERM, prev)
        signal.signal(signal.SIGINT, prev_int)
        for t in tees:
            t.join(timeout=2)


def serve_http(args, eng, multiproc: bool = False) -> None:
    """``--http`` mode: the streaming front door drives the scheduler
    continuously; requests arrive over HTTP instead of a canned trace.
    SIGTERM and SIGINT both route through ``request_drain()``: the loop
    stops at a round boundary, unfinished streams get a typed ``drain``
    finish, the snapshot is written (--snapshot), and a later ``--resume``
    run regenerates the interrupted work token-exactly."""
    import asyncio

    from repro_torch.serve import HttpFrontend, ServeService

    svc = ServeService(eng, max_pending=args.max_pending)
    if args.resume:
        from repro_torch.distributed.fault import load_snapshot
        from repro_torch.serve import resume_requests
        done, reqs = resume_requests(load_snapshot(args.resume))
        eng.pending.extend(reqs)       # headless requeue: no client holds these
        print(f"resuming {len(reqs)} unfinished requests "
              f"({len(done)} already finished) from {args.resume}", flush=True)
    svc.start()

    async def amain():
        fe = await HttpFrontend(svc, port=args.http).start()
        print(f"serving HTTP on 127.0.0.1:{fe.port} "
              f"(watermark {args.max_pending})", flush=True)
        stop = asyncio.Event()
        loop = asyncio.get_running_loop()

        def on_signal():
            svc.request_drain()
            stop.set()

        for sig in (signal.SIGTERM, signal.SIGINT):
            loop.add_signal_handler(sig, on_signal)
        await stop.wait()
        # the drain must COMPLETE while this loop is still alive: open SSE
        # handlers deliver their typed 'drain' finish through loop wakers
        await loop.run_in_executor(None, svc.join, 600.0)
        await fe.stop()

    asyncio.run(amain())
    svc.join(timeout=600)
    if multiproc:
        eng.stop_workers()
    if svc.error is not None:
        raise SystemExit(f"serve loop failed: {svc.error!r}")
    done = len(eng.finished)
    left = len(eng.pending) + sum(r is not None for r in eng.active)
    print(f"drained: {done} requests finished, {left} unfinished "
          + (f"snapshotted to {eng.snapshot_path}" if eng.snapshot_path
             else "(no --snapshot: progress dropped)"), flush=True)
    print("  stats:  ", {k: v for k, v in eng.stats.items()
                         if not k.startswith("replica_")})
    report_telemetry(eng, args)


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    args = build_args(argv)

    multiproc = args.num_processes > 1 or args.process_id is not None
    if multiproc:
        if not args.mesh:
            raise SystemExit("--num-processes requires --mesh DxM")
        if args.legacy_prefill:
            raise SystemExit("--legacy-prefill is single-device only")
    if args.num_processes > 1 and args.process_id is None:
        raise SystemExit(spawn_processes(args, argv))
    if not multiproc:
        return serve(args)
    # child: join the fleet's process group before building anything, and
    # leave it before the interpreter exits (a live gloo group at exit can
    # abort the process)
    if not args.coordinator:
        raise SystemExit("a hand-started --process-id child needs an explicit "
                         "--coordinator HOST:PORT")
    import torch.distributed as dist

    from repro_torch.launch.mesh import init_distributed
    init_distributed(args.coordinator, args.num_processes, args.process_id)
    try:
        return serve(args, multiproc)
    finally:
        dist.destroy_process_group()


def serve(args, multiproc: bool = False):
    """Build the engine ``args`` describe and serve the canned trace (or
    the HTTP front door); a worker process follows the coordinator."""
    import torch

    from repro_torch.launch.mesh import make_serve_mesh, parse_mesh
    from repro_torch.models import frontend
    from repro_torch.serve import Request, ServeConfig, build_engine

    if args.paged and args.legacy_prefill:
        raise SystemExit("--paged needs the bucketed prefill path")
    if args.chunked_prefill and args.legacy_prefill:
        raise SystemExit("--chunked-prefill needs the bucketed prefill path")
    mesh = None
    if args.mesh:
        data, model = parse_mesh(args.mesh)
        n = data * model
        try:
            mesh = make_serve_mesh(data, model,
                                   ["cpu"] * n if args.device == "cpu" else None,
                                   processes=args.num_processes)
        except (RuntimeError, ValueError) as e:
            raise SystemExit(str(e))

    sc = ServeConfig(
        arch=args.arch, reduced=args.reduced, int8_kv=args.int8_kv,
        slots=args.slots, max_len=args.max_len,
        quantize_weights=args.int8, temperature=args.temperature,
        buckets=tuple(int(b) for b in args.buckets.split(",")),
        batch_prefill=not args.legacy_prefill,
        chunked_prefill=args.chunked_prefill,
        decode_steps=args.decode_steps, pdq_fallback=args.pdq_fallback,
        snapshot_path=args.snapshot, paged=args.paged,
        page_size=args.page_size, pool_pages=args.pool_pages,
        prefix_sharing=not args.no_prefix_sharing, spill=args.spill,
        telemetry=not args.no_telemetry, trace=args.trace_out is not None,
        device=args.device, mesh=mesh, slots_per_replica=args.slots_per_replica,
        multihost=multiproc, launch_timeout=args.launch_timeout)
    try:
        eng = build_engine(sc)
    except (ValueError, NotImplementedError) as e:
        raise SystemExit(str(e))
    cfg = eng.cfg
    if mesh is not None:
        mode = f"sharded {data}x{model} ({eng.slots_per_replica} slots/replica)"
        if multiproc:
            mode += f" x{args.num_processes}proc"
    else:
        mode = "legacy" if args.legacy_prefill else "bucketed"
    mode += ((f" paged/{args.page_size}" if args.paged else "")
             + (" chunked" if args.chunked_prefill else ""))
    if multiproc and not eng.is_coordinator:
        print(f"[proc {args.process_id}] worker following the coordinator "
              f"command stream", flush=True)
        eng.serve_worker()
        print(f"[proc {args.process_id}] worker done", flush=True)
        return

    gen = torch.Generator(device=eng.device)
    gen.manual_seed(0)
    extras = frontend.stub_extras(cfg, gen)
    if args.http is not None:
        if extras is not None:
            raise SystemExit(f"--http serves text-only families; {cfg.name} needs "
                             f"prefill extras (serve its canned trace instead)")
        return serve_http(args, eng, multiproc)

    if args.resume:
        # requeue the previous run's unfinished work (progress cleared:
        # (uid, step)-keyed sampling regenerates the identical tokens)
        from repro_torch.distributed.fault import load_snapshot
        from repro_torch.serve import resume_requests
        done, reqs = resume_requests(load_snapshot(args.resume))
        print(f"resuming {len(reqs)} unfinished requests "
              f"({len(done)} already finished) from {args.resume}", flush=True)
    elif args.prompts:
        with open(args.prompts) as f:
            reqs = [Request(uid=i, prompt=np.asarray(p, np.int32), max_new=args.max_new)
                    for i, p in enumerate(json.load(f))]
    else:
        rng = np.random.default_rng(0)
        reqs = [Request(uid=i,
                        prompt=rng.integers(0, cfg.vocab,
                                            int(rng.integers(1, args.prompt_len + 1))),
                        max_new=args.max_new) for i in range(args.requests)]
    # preemption: SIGTERM/SIGINT request a drain - the scheduler finishes
    # the round, snapshots (with --snapshot) and run() returns
    signal.signal(signal.SIGTERM, lambda *_: eng.request_drain())
    signal.signal(signal.SIGINT, lambda *_: eng.request_drain())
    t0 = time.perf_counter()
    eng.run(reqs, extras=extras)
    if multiproc:
        eng.stop_workers()
    dt = time.perf_counter() - t0
    if eng.drained:
        left = sum(not r.done for r in reqs)
        print(f"drained on preemption: {left} unfinished requests "
              + (f"snapshotted to {eng.snapshot_path}" if eng.snapshot_path
                 else "(no --snapshot: progress dropped)"), flush=True)
    total_new = sum(len(r.generated) for r in reqs)
    print(f"served {len(reqs)} requests, {total_new} tokens in {dt:.2f}s "
          f"({total_new / dt:.1f} tok/s) int8={args.int8} int8_kv={args.int8_kv} "
          f"prefill={mode} device={eng.device}")
    print("  buckets:", eng.buckets)
    print("  stats:  ", {k: v for k, v in eng.stats.items()
                         if not k.startswith("replica_")})
    report_telemetry(eng, args)
    if mesh is not None:
        for r, (adm, occ) in enumerate(zip(eng.stats["replica_admits"],
                                           eng.stats["replica_occupancy"])):
            print(f"  replica {r}: admits={adm} occupied={occ}/{eng.slots_per_replica}")
    if multiproc:
        for proc, hs in sorted(eng.host_stats().items()):
            print(f"  process {proc}: replicas={hs['replicas']} admits={hs['admits']} "
                  f"occupied={hs['occupied']}/{hs['slots']}")
    for r in (reqs if args.prompts else reqs[:3]):
        print(f"  req {r.uid}: {r.generated}")


if __name__ == "__main__":
    main()
