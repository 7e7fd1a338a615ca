#!/usr/bin/env python3
"""Is the CNN track's training reproducible on the card?  Trains each of
path G's tasks (``chip_smoke.py``: cls_resnet, cls_mobilenet, seg_unet at
width 24, res 20, 16 classes, batch 32) twice in one process and compares
the two weight trees bit for bit, under one of three settings:

  as_is      ``models.cnn.train_cnn`` as the package runs it;
  cudnn_det  with ``torch.backends.cudnn.deterministic = True`` around it;
  all_det    with ``torch.use_deterministic_algorithms(True)`` (the process
             is started with ``CUBLAS_WORKSPACE_CONFIG=:4096:8``): an op
             without a deterministic kernel raises, naming itself.

Before the full runs, one forward and backward pass of each task twice on
the same batch, and the leaves whose gradients differ, which localises the
op that adds in a run-dependent order.  Needs an NVIDIA GPU; from the
repository root:

    python3 tools/torch_cnn_determinism.py [--steps N] [--modes as_is,...]

Each mode runs in its own process.  Prints one line per (mode, task) and
the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
TASKS = {"cls_resnet": "mini_resnet", "cls_mobilenet": "mini_mobilenet",
         "seg_unet": "mini_seg"}
WIDTH, RES, CLASSES, BATCH = 24, 20, 16, 32
MODES = ("as_is", "cudnn_det", "all_det")


def leaves_diff(a, b):
    """{leaf index: max |a - b|} of the leaves that are not bit-equal."""
    import torch
    return {i: float((x - y).abs().max()) for i, (x, y) in enumerate(zip(a, b))
            if not torch.equal(x, y)}


def one_mode(mode: str, steps: int) -> dict:
    import torch
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.models import cnn
    if mode == "cudnn_det":
        torch.backends.cudnn.deterministic = True
    if mode == "all_det":
        torch.use_deterministic_algorithms(True)
    out = {}
    for task, arch in TASKS.items():
        seg = task.startswith("seg")
        cfg = cnn.CNNConfig(arch=arch, width=WIDTH, res=RES, n_classes=CLASSES)
        rec = {}
        try:
            p0 = cnn.cnn_init(0, cfg, "cuda")
            xb, yb = cnn.make_gratings(1001, BATCH, res=RES, n_classes=CLASSES, noise=0.45)
            if seg:
                yb = cnn.seg_labels(yb, RES, CLASSES)
            xb, yb = torch.from_numpy(xb).cuda(), torch.from_numpy(yb).cuda()
            grads = []
            for _ in range(2):
                p = [a.detach().clone().requires_grad_(True) for a in cnn._leaves(p0)]
                it = iter(p)
                tree = cnn._tree_map(lambda _: next(it), p0)
                with cnn.qlinear.fp32_convs():
                    grads.append(torch.autograd.grad(cnn._loss(tree, xb, yb, cfg), p))
            rec["grad_leaves_apart"] = leaves_diff(*grads)
            runs = [cnn._leaves(cnn.train_cnn(cfg, steps=steps, batch=BATCH,
                                              segmentation=seg, device="cuda"))
                    for _ in range(2)]
            rec["weight_leaves_apart"] = leaves_diff(*runs)
            rec["equal"] = not rec["weight_leaves_apart"]
        except RuntimeError as e:
            rec["error"] = str(e).splitlines()[0]
        out[task] = rec
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=250)
    ap.add_argument("--modes", default=",".join(MODES))
    ap.add_argument("--one", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        print(json.dumps(one_mode(args.one, args.steps)), flush=True)
        return 0
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    for mode in args.modes.split(","):
        env = dict(os.environ)
        if mode == "all_det":
            env["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
        r = subprocess.run([sys.executable, __file__, "--one", mode, "--steps",
                            str(args.steps)], capture_output=True, text=True, env=env,
                           timeout=600)
        if r.returncode:
            print(f"{mode}: exit {r.returncode}: {r.stderr[-2000:]}")
            continue
        for task, rec in json.loads(r.stdout.strip().splitlines()[-1]).items():
            print(f"{mode} {task}: {json.dumps(rec)}", flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
