#!/usr/bin/env python3
"""Tensor-parallel serving over distinct cards, on a host with four; from
the repository root:

    python3 tools/torch_serve_mesh_cards.py

stablelm-1.6b uncut (bf16, PDQ-int8 weights, int8 KV, max_len 512, weights
from seed 0 on cuda:0) serves ``chip_smoke.make_requests``'s 8 requests
(A's), every decode dispatch one replay of each replica's graph, in:

  * A: the single-device engine on cuda:0, 8 slots (``chip_smoke``'s A);
  * XC22: a 2x2 mesh over cards 0-3 (replica r's shards on cards 2r, 2r +
    1), 4 slots a replica;
  * XC14: a 1x4 mesh over cards 0-3, 8 slots;
  * each one's twin: the same mesh shape over cuda:0 repeated, built in the
    same run;
  * MHC: XC22 through ``launch/serve.py --mesh 2x2 --num-processes 2`` (two
    processes, two cards each), on the same prompts.

Checks (the script exits 1 on the first that fails): XC22's and XC14's
streams equal their twins' exactly, their op counts equal the twins'
(launches == entries, no K3), every dispatch a replay of each replica's
graph, one replayed decode step's logits (a graph of one ``decode_step``
per replica, at position STEP_POS over the served pool) equal the twin's
bit for bit - where they part, the largest gap and the first projection
whose output parts, from an eager step of each - and MHC's tokens equal
XC22's.

Prints one JSON line: the card's name and power limit, ``nvidia-smi topo
-m``'s links between the four cards (or its error) and the measured copy
rate from card 0 to each other card; per mesh run the split-weight
bytes on each card, capture s, dispatch median ms, decode tokens/s, the
peer bytes a replay copies, one replayed step's wall ms in STEP_PAIRS
alternated windows against the twin and against A, and the streams a
replica runs on.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke  # noqa: E402

MESHES = {"XC22": ((2, 2), 4), "XC14": ((1, 4), 8)}
MAX_LEN = 512
STEP_POS = 300          # the position a timed or compared step decodes at
STEP_PAIRS, STEP_RUNS = 5, 3
LAUNCH_TIMEOUT = 900    # seconds for MHC's two processes, startup included


def fail(msg):
    print(f"FAIL: {msg}", flush=True)
    raise SystemExit(1)


def need(cond, msg):
    if not cond:
        fail(msg)


def log(msg):
    print(msg, flush=True)


def smi(*args):
    """``nvidia-smi``'s output, or its error where it fails (``topo -m``
    does on some hosts)."""
    out = subprocess.run(["nvidia-smi", *args], capture_output=True, text=True, timeout=60)
    return (out.stdout if out.returncode == 0 else
            f"nvidia-smi {' '.join(args)} failed ({out.returncode}): "
            f"{(out.stdout + out.stderr).strip()}").strip()


def links(n=4, mib=256):
    """Peer access and the copy rate (GB/s, CUDA events, median of 5) from
    card 0 to each other card: what a shard's copies ride on."""
    import torch
    src = torch.empty(mib << 20, dtype=torch.uint8, device="cuda:0")
    out = {}
    for j in range(1, n):
        dst = torch.empty_like(src, device=f"cuda:{j}")
        peer = torch.cuda.can_device_access_peer(torch.device("cuda:0"), torch.device(j))
        times = []
        for _ in range(6):
            with torch.cuda.device(0):
                a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                a.record()
                dst.copy_(src)
                b.record()
                b.synchronize()
                times.append(a.elapsed_time(b))
        ms = sorted(times[1:])[2]
        out[f"cuda:0->cuda:{j}"] = dict(peer=peer, copy_gb_s=src.numel() / ms / 1e6)
        del dst
    return out


def config(mesh_devices, shape, spr):
    from repro_torch.launch.mesh import make_serve_mesh
    from repro_torch.serve import ServeConfig
    return ServeConfig(arch="stablelm-1.6b", reduced=False, slots_per_replica=spr,
                       max_len=MAX_LEN, int8_kv=True, quantize_weights=True, device="cuda",
                       mesh=make_serve_mesh(*shape, mesh_devices))


def serve(eng, cfg):
    """A's requests through ``eng``: (streams, counts, stats, the decode
    dispatches' median ms and tokens/s)."""
    import torch
    from repro_torch.kernels import ops
    reqs = chip_smoke.make_requests(cfg)
    torch.cuda.synchronize()
    ops.reset_counts()
    res = chip_smoke.run_batch(eng, reqs)
    torch.cuda.synchronize()
    st = eng.stats
    need(all(fin == "complete" and err is None for _, fin, err in res.values()),
         f"requests did not complete: {res}")
    dec = sorted(dt for dt, _ in eng.straggler.history)
    return ({i: r[0] for i, r in res.items()}, ops.counts(), dict(st),
            dec[len(dec) // 2] * 1e3, st["decode_tokens"] / sum(dec))


def step_rows(B):
    import numpy as np
    return (np.full(B, 7, np.int32), np.full(B, STEP_POS, np.int32),
            np.arange(B, dtype=np.int32), np.zeros(B, np.int32), np.ones(B, np.int32))


def step_logits(eng):
    """One decode step of every replica at STEP_POS over its served pool,
    captured as a graph on the replica's home and replayed: the logits of
    all replicas, on the host.  The kernels' counts are left as found."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.serve import decode_graph as dg
    before = ops.count_state()
    outs = []
    for rep in eng.replicas:
        B = eng.slots_per_replica
        with rep.device_ctx():
            tok = torch.full((B, 1), 7, dtype=torch.int32, device=rep.device)
            pos = torch.full((B, 1), STEP_POS, dtype=torch.int32, device=rep.device)

            def body(caches, rep=rep, tok=tok, pos=pos):
                with ops.tp_shard(rep.row):
                    return rep.bundle.decode_step(rep.params, caches, tok, pos)[0]

            dg._warm_up(body, rep.caches, rep.device)
            graph, out, _, _ = dg._capture(body, rep.caches, rep.device)
            graph.replay()
            torch.cuda.synchronize(rep.device)
            outs.append(out.float().cpu())
            del graph
    ops.set_counts(before)
    return torch.cat(outs)


def projection_outputs(eng):
    """Every projection's output of one eager decode step (replica 0, at
    STEP_POS over its pool), in call order: where a mesh and its twin part."""
    import torch
    from repro_torch.kernels import ops
    rep, B = eng.replicas[0], eng.slots_per_replica
    seen, inner = [], ops._fp_matmul

    def record(*a, **k):
        y = inner(*a, **k)
        seen.append(y.float().cpu())
        return y

    ops._fp_matmul = record
    try:
        with rep.device_ctx(), ops.tp_shard(rep.row):
            tok = torch.full((B, 1), 7, dtype=torch.int32, device=rep.device)
            pos = torch.full((B, 1), STEP_POS, dtype=torch.int32, device=rep.device)
            rep.bundle.decode_step(rep.params, rep.caches, tok, pos)
            torch.cuda.synchronize(rep.device)
    finally:
        ops._fp_matmul = inner
    return seen


def step_walls(engines):
    """One replayed decode step of each engine (every replica's graph at
    STEP_POS), in STEP_PAIRS windows of STEP_RUNS steps, the engines'
    order rotating each window: {name: [ms a step per window]}."""
    import torch

    def stepper(eng):
        if getattr(eng, "replicas", None) is None:
            rows = step_rows(eng.slots)
            return lambda: eng._graph.packed(*rows)
        rows = step_rows(eng.slots)

        def step():
            for rep in eng.replicas:
                with rep.device_ctx():
                    rep.graph.packed(*(a[rep.rows] for a in rows))
        return step

    steps = {k: stepper(e) for k, e in engines.items()}
    names = list(steps)
    walls = {k: [] for k in names}
    for w in range(STEP_PAIRS):
        for k in names[w % len(names):] + names[:w % len(names)]:
            steps[k]()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(STEP_RUNS):
                steps[k]()
            walls[k].append((time.perf_counter() - t0) / STEP_RUNS * 1e3)
    return walls


def layer0_records(rep):
    """Layer 0's four split records in the replica's home tree."""
    p0 = rep.params["blocks"][0]
    return {"qkv": p0["attn"]["wq"]["group"], "wo": p0["attn"]["wo"],
            "gate/up": p0["ffn"]["w_gate"]["group"], "w_down": p0["ffn"]["w_down"]}


def shard_times(eng):
    """At the replica's decode rows, for each of layer 0's records: K2 over
    the last shard's block on its card (CUDA events there, a 64 MB flush of
    that card's L2 before each), its plain version and ``torch._int_mm``
    (K-major, as ``chip_smoke.library_int_mm``) on the same operands, its
    bound (``chip_smoke.bound_ms``: each operand read once, the bf16 out
    written once, or the int8 operations at the card's peak), and the whole
    split projection through the row (K2 on every shard, the copies, the
    fork and join) timed on the home's stream (only the home's L2
    flushed).  {record: {...}}."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels import w8a8_matmul as mm
    rep, M = eng.replicas[0], eng.slots_per_replica
    row, j = rep.row, rep.row.shards - 1
    home, dev = row.home, row.devices[j]
    out = {}
    before = ops.count_state()
    kw = dict(out_dtype=torch.bfloat16)
    for label, rec in layer0_records(rep).items():
        b = row.split(rec)[j]
        K, n = b["q"].shape
        N = n * row.shards
        E = N // 128 if "segs" in rec else 1
        gen = torch.Generator(device=home)
        gen.manual_seed(5)
        x_q = torch.randint(-127, 128, (M, K), dtype=torch.int8, device=home, generator=gen)
        s_x = 0.001 + 0.01 * torch.rand((M, 1), generator=gen, device=home)
        lo = -20 - 10 * torch.rand((M, E), generator=gen, device=home)
        hi = 20 + 10 * torch.rand((M, E), generator=gen, device=home)
        e = E // row.shards if E > 1 else 1
        g = slice(j * e, (j + 1) * e) if E > 1 else slice(None)
        args = [t.to(dev) for t in (x_q, b["q"], s_x)] + [None, b["scale"].reshape(1, n),
                                                          None, None, None]
        args += [lo[:, g].contiguous().to(dev), hi[:, g].contiguous().to(dev)]
        with torch.cuda.device(dev):
            flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
            k2 = chip_smoke.median_ms(lambda: mm.w8a8_matmul_cuda(*args, **kw), flush=flush)
            plain = chip_smoke.median_ms(lambda: mm.w8a8_matmul_plain(*args, **kw),
                                         flush=flush)
            lib, lib_rm, _ = chip_smoke.library_int_mm(args[0], args[1], flush)
        b_ms, b_by = chip_smoke.bound_ms(M * K + K * n + M * n * 2 + n * 4 + M * (4 + 8 * e),
                                         2 * M * K * n, chip_smoke.INT8_OPS)
        with torch.cuda.device(home), ops.tp_shard(row):
            flush = torch.empty(64 << 20, dtype=torch.uint8, device=home)
            x = torch.zeros((M, K), dtype=torch.bfloat16, device=home)
            split = chip_smoke.median_ms(
                lambda: ops._fp_matmul(x, x_q, s_x, rec, lo, hi, torch.bfloat16),
                flush=flush, spin=4_000_000)
        out[label] = dict(shape=f"({M}, {K}) @ ({K}, {n}), epilogue ({M}, {e})",
                          device=str(dev), k2_ms=k2, plain_ms=plain, library_ms=lib,
                          library_row_major_ms=lib_rm, bound_ms=b_ms, bound_by=b_by,
                          split_projection_ms=split)
    ops.set_counts(before)
    return out


def profile_step(eng):
    """torch.profiler over STEP_RUNS replayed steps: per device, the busy
    ms a step (kernels and copies) and the records a step; {} if the
    profiler records no device work."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    rows = step_rows(eng.slots)

    def step():
        for rep in eng.replicas:
            with rep.device_ctx():
                rep.graph.packed(*(a[rep.rows] for a in rows))

    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(STEP_RUNS):
            step()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.events():
        if ev.device_type != DeviceType.CUDA:
            continue
        d = out.setdefault(f"cuda:{ev.device_index}", dict(busy_ms=0.0, copy_ms=0.0,
                                                            records=0))
        us = getattr(ev, "self_device_time_total", 0) / STEP_RUNS
        d["busy_ms"] += us / 1e3
        d["records"] += 1
        if "emcpy" in ev.key or "Memset" in ev.key:
            d["copy_ms"] += us / 1e3
    for d in out.values():
        d["records"] //= STEP_RUNS
    return out


def mesh_run(name, cfg, params, a_eng, a_stream):
    """XC22 or XC14 against its one-card twin (and A's step)."""
    import torch
    from repro_torch.serve import build_engine
    (D, M), spr = MESHES[name]
    runs, engines = {}, {}
    for kind, devs in (("cards", [f"cuda:{i}" for i in range(D * M)]),
                       ("twin", ["cuda:0"] * (D * M))):
        t0 = time.perf_counter()
        eng = build_engine(config(devs, (D, M), spr), cfg=cfg, params=params)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        streams, counts, st, med, tps = serve(eng, cfg)
        need(st["replica_graph_replays"] == [st["decode_steps"]] * D,
             f"{name} {kind}: replays {st['replica_graph_replays']}, "
             f"{st['decode_steps']} dispatches")
        need(all(c["launches"] == c["entries"] for c in counts.values()),
             f"{name} {kind}: launches differ from entries {counts}")
        need(counts["w8a8_swiglu_matmul"]["launches"] == 0, f"{name} {kind}: K3 ran")
        runs[kind] = dict(
            build_s=build_s, streams=streams, counts=counts, stats=st,
            dispatch_median_ms=med, decode_tokens_per_s=tps,
            capture_s=[rep.graph.capture_s for rep in eng.replicas],
            peer_bytes_a_replay=[rep.graph.peer_bytes for rep in eng.replicas],
            streams_a_replica=[rep.row.stream_count() for rep in eng.replicas],
            split_weight_bytes=chip_smoke.split_weight_bytes(eng))
        log(f"{name} {kind}: built in {build_s:.1f} s, graphs captured in "
            f"{runs[kind]['capture_s']} s; split weights a device "
            f"{runs[kind]['split_weight_bytes']}; streams a replica "
            f"{runs[kind]['streams_a_replica']}; peer bytes a replay "
            f"{runs[kind]['peer_bytes_a_replay']}; dispatch median {med:.3f} ms, "
            f"{tps:.1f} tokens/s")
        engines[kind] = eng
    cards, twin = runs["cards"], runs["twin"]
    need(cards["streams"] == twin["streams"], f"{name}: streams {cards['streams']} "
         f"differ from the twin's {twin['streams']}")
    need(cards["counts"] == twin["counts"], f"{name}: counts {cards['counts']}, the "
         f"twin's {twin['counts']}")
    parted = [i for i, s in cards["streams"].items() if s != a_stream[i]]
    got, want = step_logits(engines["cards"]), step_logits(engines["twin"])
    gap = float((got - want).abs().max())
    res = dict(runs=runs, streams_equal_twin=True, parts_from_A=parted,
               logits_max_gap=gap, logits_equal=bool(torch.equal(got, want)))
    if not res["logits_equal"]:
        a, b = projection_outputs(engines["cards"]), projection_outputs(engines["twin"])
        first = next((i for i, (x, y) in enumerate(zip(a, b)) if not torch.equal(x, y)),
                     None)
        res["first_projection_that_parts"] = first
        fail(f"{name}: a replayed step's logits part from the twin's by {gap} (the first "
             f"projection that parts: {first} of {len(a)})")
    walls = step_walls({name: engines["cards"], f"{name} twin": engines["twin"], "A": a_eng})
    res["step_wall_ms"] = walls
    res["step_wall_ms_median"] = {k: sorted(v)[len(v) // 2] for k, v in walls.items()}
    log(f"{name}: streams and counts equal the twin's, a step's logits bit-equal; "
        f"{len(parted)} streams part from A's; replayed step wall ms (median) "
        f"{res['step_wall_ms_median']}")
    res["profile"] = {k: profile_step(e) for k, e in engines.items()}
    res["shard_ms"] = {k: shard_times(e) for k, e in engines.items()}
    brief = {k: {r: {f: round(v[f] * 1e3, 2) for f in ("k2_ms", "plain_ms", "library_ms",
                                                         "bound_ms", "split_projection_ms")
                     if v[f] is not None}
                 for r, v in t.items()} for k, t in res["shard_ms"].items()}
    log(f"{name}: a replayed step's device time by card {res['profile']}; layer 0's K2 on "
        f"the last shard's card (plain, torch._int_mm, bound) and the whole split "
        f"projection, us {brief}")
    del engines
    torch.cuda.empty_cache()
    return res


def mhc_run(cfg, xc22_streams):
    """MHC: the launcher over the 2x2 mesh in two processes, two cards
    each, on A's prompts: its tokens against XC22's."""
    reqs = chip_smoke.make_requests(cfg)
    with tempfile.TemporaryDirectory() as td:
        path = Path(td) / "prompts.json"
        path.write_text(json.dumps([r.prompt.tolist() for r in reqs]))
        t0 = time.perf_counter()
        out = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.serve", "--mesh", "2x2",
             "--num-processes", "2", "--slots-per-replica", "4", "--int8", "--int8-kv",
             "--max-len", str(MAX_LEN), "--max-new", str(reqs[0].max_new), "--prompts",
             str(path)], capture_output=True, text=True, timeout=LAUNCH_TIMEOUT, cwd=ROOT,
            env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
        wall = time.perf_counter() - t0
    need(out.returncode == 0, f"MHC: the launcher exited {out.returncode}: "
         f"{out.stderr[-3000:]}")
    got = {}
    for line in out.stdout.splitlines():
        line = line.strip()
        if line.startswith("req "):
            uid, toks = line[4:].split(":", 1)
            got[int(uid)] = json.loads(toks.strip())
    need(got == xc22_streams, f"MHC: tokens {got} differ from XC22's {xc22_streams}")
    served = next(x for x in out.stdout.splitlines() if x.startswith("served "))
    log(f"MHC: the tokens of {len(got)} requests equal XC22's; {served.strip()}; "
        f"launcher wall {wall:.1f} s")
    return dict(streams_equal_xc22=True, served=served.strip(), wall_s=wall)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        fail("CUDA is not available")
    need(torch.cuda.device_count() >= 4,
         f"needs four cards, found {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.models import build_model
    from repro_torch.serve import ServeConfig, build_engine
    card = smi("--query-gpu=name,power.limit", "--format=csv,noheader").splitlines()
    topo = smi("topo", "-m").splitlines()
    link = links()
    log(f"cards: {card}")
    log("\n".join(topo[:5]))
    log(f"links: {link}")
    t0 = time.perf_counter()
    _build.build_all()
    log(f"kernels built in {time.perf_counter() - t0:.1f} s")
    cfg = get_config("stablelm-1.6b")
    params = build_model(cfg, "cuda:0").init(0)
    a_eng = build_engine(ServeConfig(arch="stablelm-1.6b", reduced=False, slots=8,
                                     max_len=MAX_LEN, int8_kv=True, quantize_weights=True,
                                     device="cuda"), cfg=cfg, params=params)
    a_streams, _, _, a_med, a_tps = serve(a_eng, cfg)
    log(f"A: dispatch median {a_med:.3f} ms, {a_tps:.1f} tokens/s")
    out = dict(card=card, topo=topo[:5], links=link, A=dict(dispatch_median_ms=a_med,
                                                 decode_tokens_per_s=a_tps))
    for name in MESHES:
        out[name] = mesh_run(name, cfg, params, a_eng, a_streams)
    out["MHC"] = mhc_run(cfg, out["XC22"]["runs"]["cards"]["streams"])
    for name in MESHES:
        for run in out[name]["runs"].values():
            del run["streams"]
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / "torch_serve_mesh_cards.json").write_text(
        json.dumps(out, default=str))
    print(json.dumps(out, default=str), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
