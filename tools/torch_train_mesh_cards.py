#!/usr/bin/env python3
"""The sharded train step with one card a mesh entry (NCCL), on a host with
at least D*M cards; from the repository root:

    python3 tools/torch_train_mesh_cards.py [--mesh 2x2] [--steps 6]

  1. ``launch/train.py --mesh DxM`` on the first D*M cards (NCCL), reduced
     stablelm-1.6b and reduced deepseek-v2 (expert parallel), 4 steps of 8 x
     32 tokens, against the same launcher on card 0: stablelm alone (no
     mesh), deepseek over the same mesh of D*M ranks sharing card 0 (gloo;
     expert parallelism routes each rank's tokens, so one process computes
     another function).  Every run makes its params on a card (a CUDA
     generator; a CPU run would start from other weights).  Both runs' last
     losses and their relative gap (the script exits 1 past 1e-5).
  2. stablelm-1.6b uncut (bf16, remat "full", f32 AdamW), 4 x 1024 tokens,
     ``--steps`` steps over the same mesh of cards, in D*M processes of this
     script (``--rank``): each step's seconds between two barriers, the
     seconds of its collectives (each timed between two synchronizations,
     ``chip_smoke._CollTimer``), peak GiB a rank, and the step-1 loss
     against one process's on card 0 (the same batch and params, run
     first).

Prints one JSON line with every number and the card's name and power
limit (``nvidia-smi``).
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
LAUNCH = ["--reduced", "--steps", "4", "--batch", "8", "--seq", "32", "--ckpt-every", "1000"]
SEQ, BATCH = 1024, 4
TIMEOUT = 600


def launcher(arch, ckpt, *extra):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", "--arch", arch,
                          "--ckpt-dir", ckpt, *LAUNCH, *extra],
                         env=env, capture_output=True, text=True, timeout=TIMEOUT, cwd=ROOT)
    if out.returncode:
        raise SystemExit(f"launch/train.py {arch} {extra}: {out.stderr[-3000:]}")
    return [r["loss"] for r in json.loads(out.stdout)["history"]]


def rank_main(rank, n, shape, coordinator, steps, out):
    """One rank of part 2."""
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    import torch.distributed as dist

    import chip_smoke
    from repro_torch.configs import get_config
    from repro_torch.distributed import collectives as coll
    from repro_torch.launch.mesh import init_distributed, make_host_mesh, train_backend
    from repro_torch.models import build_model
    from repro_torch.models import context as mctx
    from repro_torch.optim import AdamWConfig
    from repro_torch.train.train_step import build_train_step, dist_context_for, make_state
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.set_device(rank)
    mesh = make_host_mesh(*shape)
    init_distributed(coordinator, n, rank, timeout=TIMEOUT, backend=train_backend(mesh))
    cfg = get_config("stablelm-1.6b")
    b = build_model(cfg, f"cuda:{rank}")
    opt = AdamWConfig(lr=1e-3)
    batches = [chip_smoke.tm_batch(cfg, i, BATCH, SEQ) for i in range(steps)]
    ctx = dist_context_for(mesh)
    one = None
    if rank == 0:
        st, step = make_state(b, opt, 0), build_train_step(b, opt)
        one = float(step(st, batches[0])[1]["loss"])
        del st, step
        torch.cuda.empty_cache()
    coll.barrier(ctx.groups.world)
    timer = chip_smoke._CollTimer()
    timer.install()
    mctx.set_context(ctx)
    torch.cuda.reset_peak_memory_stats()
    st, step = make_state(b, opt, 0, mesh), build_train_step(b, opt, mesh)
    res = dict(loss=[], s=[], coll_s=[], host_bytes=[])
    for x in batches:
        coll.barrier(ctx.groups.world)
        timer.s, timer.host_bytes, timer.on = 0.0, 0, True
        t0 = time.perf_counter()
        st, m = step(st, x)
        torch.cuda.synchronize()
        coll.barrier(ctx.groups.world)
        res["s"].append(time.perf_counter() - t0)
        timer.on = False
        res["loss"].append(float(m["loss"]))
        res["coll_s"].append(timer.s)
        res["host_bytes"].append(timer.host_bytes)
    res.update(peak_gib=torch.cuda.max_memory_allocated() / 2**30, one_loss=one,
               backend=train_backend(mesh))
    allr = [None] * n
    dist.all_gather_object(allr, res, group=ctx.groups.world)
    if rank == 0:
        Path(out).write_text(json.dumps(allr))
    dist.destroy_process_group()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default="2x2")
    ap.add_argument("--steps", type=int, default=6)
    ap.add_argument("--rank", nargs=3, help=argparse.SUPPRESS)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.launch.mesh import parse_mesh, pick_coordinator
    shape = parse_mesh(args.mesh)
    n = shape[0] * shape[1]
    if args.rank:
        rank, coordinator, out = args.rank
        return rank_main(int(rank), n, shape, coordinator, args.steps, out)
    import torch
    if torch.cuda.device_count() < n:
        raise SystemExit(f"--mesh {args.mesh} needs {n} cards, found {torch.cuda.device_count()}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout
    res = {"nvidia_smi": smi.strip().splitlines(), "mesh": args.mesh}
    worst = 0.0
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        one_card = ",".join(["cuda:0"] * n)
        for arch, ref in (("stablelm-1.6b", []),
                          ("deepseek-v2-236b", ["--mesh", args.mesh, "--devices", one_card])):
            cards = launcher(arch, f"{tmp}/{arch}_cards", "--mesh", args.mesh)
            card0 = launcher(arch, f"{tmp}/{arch}_card0", *ref)
            gap = max(abs(a - c) / abs(c) for a, c in zip(cards, card0))
            worst = max(worst, gap)
            res[arch] = dict(loss_cards=cards, loss_card0=card0,
                             card0="one process" if not ref else f"{args.mesh} on card 0",
                             rel_gap=gap)
        out = f"{tmp}/full.json"
        coord = pick_coordinator(None)
        t0 = time.perf_counter()
        procs = [subprocess.Popen([sys.executable, __file__, "--mesh", args.mesh, "--steps",
                                   str(args.steps), "--rank", str(r), coord, out])
                 for r in range(n)]
        rcs = [p.wait(timeout=TIMEOUT) for p in procs]
        if any(rcs):
            raise SystemExit(f"the full-size ranks exited {rcs}")
        allr = json.loads(Path(out).read_text())
        r0 = allr[0]
        res["full"] = dict(
            backend=r0["backend"], loss=r0["loss"], one_process_step1_loss=r0["one_loss"],
            step1_rel=abs(r0["loss"][0] - r0["one_loss"]) / abs(r0["one_loss"]),
            s_per_step=[r["s"] for r in allr],
            s_per_step_median=statistics.median(r0["s"][1:]),
            coll_s_median=[statistics.median(r["coll_s"][1:]) for r in allr],
            host_bytes_per_step=[r["host_bytes"][-1] for r in allr],
            peak_gib=[r["peak_gib"] for r in allr], wall_s=time.perf_counter() - t0)
    print(json.dumps(res))
    if worst > 1e-5:
        raise SystemExit(f"the cards' losses part from card 0's by {worst}")


if __name__ == "__main__":
    main()
