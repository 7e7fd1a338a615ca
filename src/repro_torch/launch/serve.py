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

Multi-GPU serving (``--mesh``, ``--num-processes``, ``--slots-per-replica``,
``--launch-timeout``) is ROADMAP.md Queue 1 item 8 and the per-request
prefill baseline (``--legacy-prefill``) item 9: each raises naming its
item.
"""
from __future__ import annotations

import argparse
import signal
import sys
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
    # not ported yet: each raises naming its ROADMAP.md item
    ap.add_argument("--mesh", default=None, metavar="DxM")
    ap.add_argument("--num-processes", type=int, default=1)
    ap.add_argument("--slots-per-replica", type=int, default=None)
    ap.add_argument("--launch-timeout", type=float, default=None)
    ap.add_argument("--legacy-prefill", action="store_true")
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


def serve_http(args, eng) -> None:
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

    import torch

    from repro_torch.models import frontend
    from repro_torch.serve import Request, ServeConfig, build_engine
    from repro_torch.serve.engine import not_ported

    if (args.mesh or args.num_processes > 1 or args.slots_per_replica is not None
            or args.launch_timeout is not None):
        raise not_ported("multi-GPU serving (--mesh, --num-processes)", "8")
    if args.legacy_prefill:
        raise not_ported("the per-request prefill baseline", "9")

    sc = ServeConfig(
        arch=args.arch, reduced=args.reduced, int8_kv=args.int8_kv,
        slots=args.slots, max_len=args.max_len,
        quantize_weights=args.int8, temperature=args.temperature,
        buckets=tuple(int(b) for b in args.buckets.split(",")),
        chunked_prefill=args.chunked_prefill,
        decode_steps=args.decode_steps, pdq_fallback=args.pdq_fallback,
        snapshot_path=args.snapshot, paged=args.paged,
        page_size=args.page_size, pool_pages=args.pool_pages,
        prefix_sharing=not args.no_prefix_sharing, spill=args.spill,
        telemetry=not args.no_telemetry, trace=args.trace_out is not None,
        device=args.device)
    try:
        eng = build_engine(sc)
    except ValueError as e:
        raise SystemExit(str(e))
    cfg = eng.cfg
    mode = ("bucketed" + (f" paged/{args.page_size}" if args.paged else "")
            + (" chunked" if args.chunked_prefill else ""))

    gen = torch.Generator(device=eng.device)
    gen.manual_seed(0)
    extras = frontend.stub_extras(cfg, gen)
    if args.http is not None:
        if extras is not None:
            raise SystemExit(f"--http serves text-only families; {cfg.name} needs "
                             f"prefill extras (serve its canned trace instead)")
        return serve_http(args, eng)

    if args.resume:
        # requeue the previous run's unfinished work (progress cleared:
        # (uid, step)-keyed sampling regenerates the identical tokens)
        from repro_torch.distributed.fault import load_snapshot
        from repro_torch.serve import resume_requests
        done, reqs = resume_requests(load_snapshot(args.resume))
        print(f"resuming {len(reqs)} unfinished requests "
              f"({len(done)} already finished) from {args.resume}", flush=True)
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
    for r in reqs[:3]:
        print(f"  req {r.uid}: {r.generated}")


if __name__ == "__main__":
    main()
