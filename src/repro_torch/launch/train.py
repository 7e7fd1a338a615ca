"""End-to-end training driver (port of ``repro/launch/train.py``), on the
card unless ``--device cpu``:

    PYTHONPATH=src python -m repro_torch.launch.train --arch stablelm-1.6b \
        --reduced --steps 100 --batch 8 --seq 128 [--device cpu]

``--reduced`` takes the smoke-scale config of the same family; without it
the full config trains.  It prints the same JSON as the reference (the last
five history records, ``restarts``, ``final_loss``).  The loop runs under
the trainer's deterministic setting, which needs ``CUBLAS_WORKSPACE_CONFIG``
before torch makes its first cuBLAS handle: ``main`` sets it (unless the
environment already has it) before any CUDA work.  ``--mesh`` other
than ``none`` (the reference's sharded step) is ROADMAP.md Queue 1 item 8b
and refuses.
"""
from __future__ import annotations

import argparse
import json
import os

from repro_torch.configs import ALL_ARCHS, get_config, reduced_config
from repro_torch.data import DataConfig
from repro_torch.models import build_model
from repro_torch.models.context import not_ported
from repro_torch.optim import AdamWConfig
from repro_torch.train import Trainer, TrainerConfig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="stablelm-1.6b", choices=list(ALL_ARCHS))
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default="build/train_ckpt")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--mesh", choices=["none", "host", "pod", "multipod"], default="none")
    ap.add_argument("--quant-opt-state", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    # the trainer's deterministic cuBLAS workspace, read at the first
    # cuBLAS handle, which no code has made yet
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    if args.mesh != "none":
        raise not_ported(f"sharded training (--mesh {args.mesh})", "8b")

    cfg = reduced_config(args.arch) if args.reduced else get_config(args.arch)
    bundle = build_model(cfg, args.device)
    trainer = Trainer(
        bundle,
        AdamWConfig(lr=args.lr, quant_state=args.quant_opt_state),
        DataConfig(vocab=cfg.vocab, seq_len=args.seq, batch=args.batch),
        TrainerConfig(total_steps=args.steps, ckpt_every=args.ckpt_every,
                      ckpt_dir=args.ckpt_dir, log_every=10),
    )
    out = trainer.train()
    print(json.dumps({"history": out["history"][-5:],
                      "restarts": out["restarts"],
                      "final_loss": out["final_loss"]}, indent=1))


if __name__ == "__main__":
    main()
