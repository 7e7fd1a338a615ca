#!/usr/bin/env python3
"""The sequence-parallel prefill with one card a mesh entry (NCCL), on a
host with at least four cards; from the repository root:

    python3 tools/torch_seq_prefill_cards.py [--archs stablelm-1.6b,yi-6b]

For each config, uncut, with PDQ-int8 weights (``quantize_param_tree`` of
init(0)) and the int8 KV cache: ROWS rows of SEQ seeded tokens - the
16x16 production cell's share of a replica (prefill_32k's 32 rows over 16
data ranks) - prefilled over a 1x4 (data, model) mesh of four processes of
this script (``--rank``), one card each, SEQ / 4 positions a card
(``serve/seq_parallel.SeqPrefill``), against one card's ``bundle.prefill``
of the same rows (rank 0 on card 0, first and alone).  The gates are
``chip_smoke.py``'s SP's: every cache leaf, joined from the cards' blocks,
equal to one card's; every card's logits equal and within 0.25 of one
card's (the largest difference printed), the greedy next token equal
wherever one card's top-2 margin is at least that; each card's K1/K2/K3
launches equal to one card's.  Printed beside them: the wall seconds of
both, each card's peak GiB beside the dry run's traced peak for the same
(arch, shape, 1x4, opt) cell (``launch/dryrun.run_cell``, traced in a
child process while the cards run), and the collective bytes by kind and
group beside the traced ones (which must be equal).

Prints one JSON line with every number and the cards' names and power
limits (``nvidia-smi``); exits 1 where a gate fails.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
ROWS, SEQ, SEED = 2, 32768, 11
MESH = (1, 4)
LOGIT_TOL = 0.25                 # chip_smoke.py's LOGIT_TOL["A"]
TIMEOUT = 1800


def _cfg(arch):
    import dataclasses

    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(arch), quant_kv="dynamic")


def trace_main(arch, out):
    """The dry run's cell of this prefill (``--trace``), no card visible."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.launch import dryrun
    from repro_torch.models.api import ShapeSpec
    rec = dryrun.run_cell(arch, ShapeSpec("prefill", "prefill", SEQ, ROWS), variant="opt",
                          mesh=MESH, cfg=_cfg(arch), pdq=True)
    Path(out).write_text(json.dumps(rec))


def rank_main(rank, arch, coordinator, out):
    """One card's part (``--rank``)."""
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch import tree as tr
    from repro_torch.distributed import collectives as coll
    from repro_torch.distributed import sharding as shd
    from repro_torch.kernels import ops
    from repro_torch.launch import hlo_analysis
    from repro_torch.launch.mesh import init_distributed, make_host_mesh, train_backend
    from repro_torch.models import build_model
    from repro_torch.models.linops import quantize_param_tree
    from repro_torch.serve.seq_parallel import SeqPrefill
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.set_device(rank)
    n = MESH[0] * MESH[1]
    mesh = make_host_mesh(*MESH)
    init_distributed(coordinator, n, rank, timeout=TIMEOUT, backend=train_backend(mesh))
    b = build_model(_cfg(arch), f"cuda:{rank}")
    prog = SeqPrefill(b, mesh, ROWS, SEQ)
    world = prog.groups.world
    rng = np.random.default_rng(SEED)
    tokens = torch.as_tensor(rng.integers(0, b.cfg.vocab, (ROWS, SEQ), dtype=np.int32))
    one = None
    if rank == 0:                   # one card's prefill first, alone
        whole = quantize_param_tree(b.init(0))
        caches = b.init_caches(ROWS, SEQ)
        torch.cuda.synchronize()
        ops.reset_counts()
        t0 = time.perf_counter()
        logits, caches = b.prefill(whole, {"tokens": tokens.cuda()}, caches)
        torch.cuda.synchronize()
        one = dict(s=time.perf_counter() - t0, logits=logits.float().cpu(),
                   counts={k: v["launches"] for k, v in ops.counts().items()},
                   caches=dict(tr.leaves_with_path(tr.tree_map(lambda t: t.cpu(), caches))))
        del logits, caches
    coll.barrier(world)
    if rank != 0:
        whole = quantize_param_tree(b.init(0))
    params = prog.place_params(whole)
    del whole
    batch = prog.place_batch({"tokens": tokens})
    caches = prog.init_caches()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    coll.barrier(world)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_counts()
    t0 = time.perf_counter()
    with hlo_analysis.collective_counter(prog.groups) as moved:
        logits = prog(params, batch, caches)
        torch.cuda.synchronize()
    coll.barrier(world)
    mine = dict(s=time.perf_counter() - t0, peak_bytes=torch.cuda.max_memory_allocated(),
                counts={k: v["launches"] for k, v in ops.counts().items()},
                coll_bytes=moved.collective_bytes, coll_groups=moved.group_bytes,
                logits=logits.float().cpu())
    every = [None] * n
    dist.all_gather_object(every, mine, group=world)
    apart = []
    for (path, blk), spec, leaf in zip(tr.leaves_with_path(caches),
                                       tr.leaves(prog.cache_specs), tr.leaves(prog.template)):
        parts = coll.gather_to(blk, world)
        if rank == 0:
            want = one["caches"][path]
            for r, part in enumerate(parts):
                coords = {"data": r // MESH[1], "model": r % MESH[1]}
                if not torch.equal(part, want[shd.block(spec, leaf.shape, mesh, coords)]):
                    apart.append((tr.path_str(path), r))
    if rank == 0:
        ref = one["logits"]
        top2 = ref.topk(2, dim=-1).values
        sure = (top2[:, 0] - top2[:, 1]) >= LOGIT_TOL
        same = (every[0]["logits"].argmax(-1) == ref.argmax(-1)) | ~sure
        Path(out).write_text(json.dumps(dict(
            one_s=one["s"], s=[e["s"] for e in every], peak_bytes=[e["peak_bytes"] for e in every],
            coll_bytes=every[0]["coll_bytes"], coll_groups=every[0]["coll_groups"],
            logits_max_abs_diff=max(float((e["logits"] - ref).abs().max()) for e in every),
            ranks_alike=all(torch.equal(e["logits"], every[0]["logits"]) for e in every),
            greedy_sure=int(sure.sum()), greedy_equal=bool(same.all()), caches_apart=apart,
            census_one={k: v for k, v in one["counts"].items() if v},
            census=[{k: v for k, v in e["counts"].items() if v} for e in every],
            census_equal=all(e["counts"] == one["counts"] for e in every),
            backend=train_backend(mesh))))
    dist.destroy_process_group()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--archs", default="stablelm-1.6b,yi-6b")
    ap.add_argument("--rank", nargs=4, help=argparse.SUPPRESS)
    ap.add_argument("--trace", nargs=2, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.trace:
        return trace_main(*args.trace)
    if args.rank:
        rank, arch, coordinator, out = args.rank
        return rank_main(int(rank), arch, coordinator, out)
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    from repro_torch.kernels import _build
    from repro_torch.launch.mesh import pick_coordinator
    n = MESH[0] * MESH[1]
    if torch.cuda.device_count() < n:
        raise SystemExit(f"a {MESH[0]}x{MESH[1]} mesh needs {n} cards, found "
                         f"{torch.cuda.device_count()}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout
    archs = args.archs.split(",")
    res = {"nvidia_smi": smi.strip().splitlines(), "mesh": f"{MESH[0]}x{MESH[1]}",
           "rows": ROWS, "seq": SEQ}
    failed = []
    _build.build_all()              # once, before the ranks load them
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
        traces = {a: subprocess.Popen([sys.executable, __file__, "--trace", a,
                                       f"{tmp}/trace_{a}.json"], env=env,
                                      preexec_fn=lambda: os.nice(10)) for a in archs}
        for arch in archs:
            out = f"{tmp}/{arch}.json"
            coord = pick_coordinator(None)
            t0 = time.perf_counter()
            procs = [subprocess.Popen([sys.executable, __file__, "--rank", str(r), arch, coord,
                                       out]) for r in range(n)]
            rcs = [p.wait(timeout=TIMEOUT) for p in procs]
            if any(rcs):
                raise SystemExit(f"{arch}: the ranks exited {rcs}")
            row = json.loads(Path(out).read_text())
            row["wall_s"] = time.perf_counter() - t0
            res[arch] = row
        for arch, p in traces.items():
            if p.wait(timeout=TIMEOUT):
                raise SystemExit(f"{arch}: the dry run's trace exited {p.returncode}")
            rec = json.loads(Path(f"{tmp}/trace_{arch}.json").read_text())
            row = res[arch]
            if rec["status"] != "ok":
                raise SystemExit(f"{arch}: the dry run's cell {rec['status']}: {rec.get('error')}")
            row["traced"] = dict(peak_bytes=rec["peak_bytes"],
                                 collectives=rec["scaled_collectives"],
                                 by_group=rec["collectives_by_group"], trace_s=rec["trace_s"],
                                 census=rec["kernels"])
            row["peak_gib"] = [b / 2**30 for b in row["peak_bytes"]]
            row["traced_peak_gib"] = rec["peak_bytes"] / 2**30
            bytes_equal = (rec["scaled_collectives"]
                           == {k: float(v) for k, v in row["coll_bytes"].items()}
                           and rec["collectives_by_group"] == row["coll_groups"])
            row["bytes_equal_traced"] = bytes_equal
            for ok, what in ((not row["caches_apart"], "cache blocks apart"),
                             (row["ranks_alike"], "the cards' logits differ"),
                             (row["logits_max_abs_diff"] <= LOGIT_TOL, "logits"),
                             (row["greedy_equal"], "greedy tokens"),
                             (row["census_equal"], "census"),
                             (all(row["census_one"].get(k, 0) > 0 for k in (
                                 "pdq_prologue", "w8a8_matmul", "w8a8_swiglu_matmul")),
                              "K1-K3 not launched"),
                             (bytes_equal, "collective bytes against the trace")):
                if not ok:
                    failed.append(f"{arch}: {what}")
    print(json.dumps(res))
    if failed:
        raise SystemExit(f"failed: {failed}")


if __name__ == "__main__":
    main()
