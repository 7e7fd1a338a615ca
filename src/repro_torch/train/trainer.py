"""Fault-tolerant training loop (port of ``repro/train/trainer.py``).

  * checkpoint/restart: periodic checkpoints written on a background
    thread; on ANY step failure the loop restores the newest checkpoint and
    replays.  The data is a pure function of the step index, and every step
    runs under ``deterministic()``, so the replay is exact.
  * failure injection: ``failure_hook(step)`` may raise to simulate a
    preemption or a lost node.
  * straggler watchdog: a step-time EMA; a step slower than
    ``straggler_factor`` x the EMA is counted.
  * a blocking final save.
  * a mesh (``mesh=``, one process a mesh entry, every rank running the
    same loop): the step is the sharded one and the state this rank's
    blocks.  Checkpoints hold whole logical arrays, as the reference's do:
    every rank's blocks are gathered to the mesh's rank 0, which writes
    them (``distributed/fault.gather_state``), and a restore reads the
    whole arrays and takes this rank's blocks (``reshard_state``), so a
    checkpoint written over one mesh restores over another or on one
    device.  Before a restore, rank 0 finishes its pending write and every
    rank waits for it.

Determinism on the card: the backward of ``embedding`` and of the gathers
(``take_along_dim``, the MoE's bucket scatter and its combine) accumulates
with atomics by default, so two runs of one step may differ in their last
bits.  ``deterministic()`` turns on ``torch.use_deterministic_algorithms``
for the training loop only (the sort-based deterministic kernels compute
the same sums) and needs ``CUBLAS_WORKSPACE_CONFIG=:4096:8`` (or ``:16:8``)
in the environment before the process makes its first cuBLAS handle:
``launch/train.py`` sets it before any CUDA work.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from typing import Any, Callable

import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.data.pipeline import DataConfig, make_source
from repro_torch.distributed import collectives as coll
from repro_torch.distributed.fault import gather_state, reshard_state
from repro_torch.optim import adamw

from .train_step import abstract_state, build_train_step, make_state

CUBLAS_DETERMINISTIC = (":4096:8", ":16:8")


@contextlib.contextmanager
def deterministic(device):
    """``torch.use_deterministic_algorithms(True)`` inside, the caller's
    setting restored after; on CUDA it first checks that cuBLAS was given
    a deterministic workspace (``CUBLAS_WORKSPACE_CONFIG``)."""
    if (torch.device(device).type == "cuda"
            and os.environ.get("CUBLAS_WORKSPACE_CONFIG") not in CUBLAS_DETERMINISTIC):
        raise RuntimeError(
            "deterministic training on CUDA needs CUBLAS_WORKSPACE_CONFIG=:4096:8 "
            "in the environment before the first cuBLAS call of the process")
    prev = torch.are_deterministic_algorithms_enabled()
    warn = torch.is_deterministic_algorithms_warn_only_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(prev, warn_only=warn)


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    ckpt_every: int = 20
    ckpt_dir: str = "repro_ckpt"
    keep: int = 3
    log_every: int = 10
    straggler_factor: float = 3.0
    max_restarts: int = 5


class Trainer:
    def __init__(self, bundle, opt_cfg: adamw.AdamWConfig, data_cfg: DataConfig,
                 tcfg: TrainerConfig, mesh=None, seed: int = 0,
                 failure_hook: Callable[[int], None] | None = None):
        self.bundle = bundle
        self.opt_cfg = opt_cfg
        self.data_cfg = data_cfg
        self.tcfg = tcfg
        self.mesh = mesh
        self.failure_hook = failure_hook
        self.step_fn = build_train_step(bundle, opt_cfg, mesh)
        # over a mesh, the mesh's rank 0 writes the checkpoints
        self.writer = mesh is None or coll.index(self.step_fn.g.world) == 0
        self.ckpt = CheckpointManager(tcfg.ckpt_dir, keep=tcfg.keep)
        self.seed = seed
        self.history: list[dict[str, Any]] = []
        self.restarts = 0
        self.straggler_steps = 0

    # ----------------------------------------------------------------- state
    def fresh_state(self):
        return make_state(self.bundle, self.opt_cfg, self.seed, self.mesh)

    def restore_or_init(self):
        """(state, step): the newest checkpoint's on the bundle's device
        (this rank's blocks of it over a mesh), else a fresh state at step
        0."""
        if self.mesh is None:
            tree, meta = self.ckpt.restore(abstract_state(self.bundle, self.opt_cfg),
                                           device=self.bundle.device)
            if tree is None:
                return self.fresh_state(), 0
            return tree, int(meta["step"])
        if self.writer:
            self.ckpt.wait()
        coll.barrier(self.step_fn.g.world)
        tree, meta = self.ckpt.restore(abstract_state(self.bundle, self.opt_cfg))
        if tree is None:
            return self.fresh_state(), 0
        return reshard_state(tree, self.mesh, self.step_fn.specs), int(meta["step"])

    def save(self, step: int, state, block: bool = False):
        """Checkpoint ``state`` at ``step`` (collective over a mesh: the
        blocks are gathered whole to the writer)."""
        if self.mesh is not None:
            state = gather_state(state, self.mesh, self.step_fn.specs)
        if self.writer:
            self.ckpt.save(step, state, {"step": step}, block=block)

    # ------------------------------------------------------------------ loop
    def train(self) -> dict[str, Any]:
        source = make_source(self.data_cfg)
        dev = self.bundle.device
        with deterministic(dev):
            state, step = self.restore_or_init()
            ema = None
            while step < self.tcfg.total_steps:
                try:
                    batch = source.batch_at(step)
                    if self.failure_hook is not None:
                        self.failure_hook(step)
                    t0 = time.perf_counter()
                    state, metrics = self.step_fn(state, batch)
                    if dev.type == "cuda":
                        torch.cuda.synchronize(dev)
                    dt = time.perf_counter() - t0
                    ema = dt if ema is None else 0.9 * ema + 0.1 * dt
                    if dt > self.tcfg.straggler_factor * ema:
                        self.straggler_steps += 1
                    step += 1
                    if step % self.tcfg.log_every == 0 or step == self.tcfg.total_steps:
                        rec = {k: float(v) for k, v in metrics.items()}
                        rec.update(step=step, sec_per_step=dt)
                        self.history.append(rec)
                    if step % self.tcfg.ckpt_every == 0:
                        self.save(step, state)
                except KeyboardInterrupt:
                    raise
                except Exception as e:   # preemption / injected failure / OOM
                    self.restarts += 1
                    if self.restarts > self.tcfg.max_restarts:
                        raise RuntimeError(
                            f"exceeded max_restarts={self.tcfg.max_restarts}") from e
                    state = None
                    state, step = self.restore_or_init()
        self.save(self.tcfg.total_steps, state, block=True)
        self.ckpt.wait()
        return {"state": state, "history": self.history, "restarts": self.restarts,
                "straggler_steps": self.straggler_steps,
                "final_loss": self.history[-1]["loss"] if self.history else None}
