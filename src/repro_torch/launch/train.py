"""End-to-end training driver (port of ``repro/launch/train.py``), on the
card unless ``--device cpu``:

    PYTHONPATH=src python -m repro_torch.launch.train --arch stablelm-1.6b \
        --reduced --steps 100 --batch 8 --seq 128 [--device cpu] [--mesh 2x2]

``--reduced`` takes the smoke-scale config of the same family; without it
the full config trains.  It prints the same JSON as the reference (the last
five history records, ``restarts``, ``final_loss``).  The loop runs under
the trainer's deterministic setting, which needs ``CUBLAS_WORKSPACE_CONFIG``
before torch makes its first cuBLAS handle: ``main`` sets it (unless the
environment already has it) before any CUDA work.

``--mesh DxM`` trains the sharded step over a data x model mesh, one
process an entry (``--num-processes``, D*M, the default, and no other
count): the launcher spawns the children (each with ``--process-id`` and
``--coordinator``), exits non-zero when one dies, and rank 0 prints the
JSON and writes the checkpoints.  Every child sets
``set_context(dist_context_for(mesh))``, as the reference's launcher does.
On the card the entries are the first D*M cards (NCCL) unless
``--devices`` lists them, one an entry (``cuda:0,cuda:0,cuda:0,cuda:0``:
four ranks on one card, over gloo); with ``--device cpu`` every entry is
the CPU (gloo).  ``--mesh host`` is every local card on the data axis (one
CPU entry with ``--device cpu``).  The reference's ``pod`` and
``multipod`` production meshes (256 and 512 cards) exist here only as the
dry run's fake cards (``launch/dryrun.py``), and are refused.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys


def build_args(argv=None):
    from repro_torch.configs import ALL_ARCHS
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="stablelm-1.6b", choices=list(ALL_ARCHS))
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default="build/train_ckpt")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--mesh", default="none",
                    help="none, host or DxM (the reference's pod / multipod are refused)")
    ap.add_argument("--num-processes", type=int, default=None)
    ap.add_argument("--process-id", type=int, default=None)
    ap.add_argument("--coordinator", default=None)
    ap.add_argument("--devices", default=None,
                    help="the mesh entries' devices, comma-separated, row-major")
    ap.add_argument("--quant-opt-state", action="store_true")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def mesh_shape(args) -> tuple[int, int] | None:
    """(D, M) of ``--mesh``, None for no mesh."""
    from repro_torch.launch.mesh import parse_mesh
    if args.mesh == "none":
        return None
    if args.mesh in ("pod", "multipod"):
        raise SystemExit(f"--mesh {args.mesh} is the reference's production mesh of 256 or 512 "
                         f"cards, which has no counterpart here but the dry run's fake cards "
                         f"(launch/dryrun.py): give --mesh DxM")
    if args.mesh == "host":
        if args.device == "cpu":
            return 1, 1
        import torch
        return max(torch.cuda.device_count(), 1), 1
    return parse_mesh(args.mesh)


def entry_devices(args, n: int):
    """The mesh entries' devices: ``--devices``, else every entry the CPU
    with ``--device cpu``, else None (the first n cards)."""
    if args.devices:
        return args.devices.split(",")
    return ["cpu"] * n if args.device == "cpu" else None


def train(args, shape) -> None:
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.data import DataConfig
    from repro_torch.models import build_model
    from repro_torch.models import context as mctx
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import Trainer, TrainerConfig

    cfg = reduced_config(args.arch) if args.reduced else get_config(args.arch)
    mesh, device, rank = None, args.device, 0
    if shape is not None:
        from repro_torch.launch.mesh import make_host_mesh, mesh_coords
        from repro_torch.train.train_step import dist_context_for
        mesh = make_host_mesh(*shape, entry_devices(args, shape[0] * shape[1]))
        c = mesh_coords(mesh)
        device = mesh.devices[c["data"], c["model"]]
        rank = int(mesh.processes[c["data"], c["model"]])
        if device.type == "cuda":
            import torch
            torch.cuda.set_device(device)
        mctx.set_context(dist_context_for(mesh))
    bundle = build_model(cfg, device)
    trainer = Trainer(
        bundle,
        AdamWConfig(lr=args.lr, quant_state=args.quant_opt_state),
        DataConfig(vocab=cfg.vocab, seq_len=args.seq, batch=args.batch),
        TrainerConfig(total_steps=args.steps, ckpt_every=args.ckpt_every,
                      ckpt_dir=args.ckpt_dir, log_every=10),
        mesh=mesh,
    )
    out = trainer.train()
    if rank == 0:
        print(json.dumps({"history": out["history"][-5:],
                          "restarts": out["restarts"],
                          "final_loss": out["final_loss"]}, indent=1), flush=True)


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    args = build_args(argv)
    # the trainer's deterministic cuBLAS workspace, read at the first
    # cuBLAS handle, which no code has made yet
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    shape = mesh_shape(args)
    n = 1 if shape is None else shape[0] * shape[1]
    procs = args.num_processes or n
    if procs != n:
        raise SystemExit(f"--mesh {args.mesh} trains one process an entry: "
                         f"--num-processes {n}, not {procs}")
    if n == 1:
        return train(args, shape)
    if args.process_id is None:
        from repro_torch.launch.mesh import pick_coordinator
        from repro_torch.launch.serve import run_fleet
        coordinator = pick_coordinator(args.coordinator)
        children = [subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.train", *argv,
             "--coordinator", coordinator, "--process-id", str(i)],
            stderr=subprocess.PIPE, text=True) for i in range(n)]
        raise SystemExit(run_fleet(children, "train"))
    if not args.coordinator:
        raise SystemExit("a hand-started --process-id child needs an explicit "
                         "--coordinator HOST:PORT")
    import torch.distributed as dist

    from repro_torch.launch.mesh import init_distributed, make_host_mesh, train_backend
    init_distributed(args.coordinator, n, args.process_id,
                     backend=train_backend(make_host_mesh(*shape, entry_devices(args, n))))
    try:
        train(args, shape)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
