"""End-to-end LM training on the PyTorch port.

Default: a ~20M-param GPT-style model for 200 steps on the card.  --full
trains a ~110M model for 300 steps - the "100M for a few hundred steps"
target.  ``--device cpu`` trains on the CPU (use --steps and the sizes to
keep it short).  Checkpoints go under build/ in the repository.

    PYTHONPATH=src python examples/torch_train_lm.py [--full] [--steps N] [--device cpu]
"""
import argparse
import os
from pathlib import Path

# the trainer's deterministic cuBLAS workspace, read at the first cuBLAS
# handle, which must not exist yet
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

from repro_torch.data import DataConfig  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.config import ArchConfig  # noqa: E402
from repro_torch.optim import AdamWConfig  # noqa: E402
from repro_torch.train import Trainer, TrainerConfig  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def small_cfg(full: bool) -> ArchConfig:
    if full:  # ~110M params
        return ArchConfig(name="gpt-110m", n_layers=12, d_model=768,
                          n_heads=12, n_kv_heads=12, d_ff=3072, vocab=32000,
                          head_dim=64, loss_chunk=128, dtype="float32")
    return ArchConfig(name="gpt-20m", n_layers=6, d_model=384, n_heads=6,
                      n_kv_heads=6, d_ff=1536, vocab=8192, head_dim=64,
                      remat="none", loss_chunk=64, dtype="float32")


def main(argv=None):
    """Train and print; returns the trainer's output (history, state)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--log-every", type=int, default=20)
    ap.add_argument("--ckpt-dir", default=str(ROOT / "build" / "torch_train_lm"))
    args = ap.parse_args(argv)

    cfg = small_cfg(args.full)
    steps = args.steps or (300 if args.full else 200)
    bundle = build_model(cfg, args.device)
    trainer = Trainer(
        bundle, AdamWConfig(lr=3e-3),
        DataConfig(vocab=cfg.vocab, seq_len=args.seq, batch=args.batch),
        TrainerConfig(total_steps=steps, ckpt_every=100,
                      ckpt_dir=args.ckpt_dir, log_every=args.log_every))
    out = trainer.train()
    first, last = out["history"][0]["loss"], out["history"][-1]["loss"]
    print(f"{cfg.name}: loss {first:.3f} -> {last:.3f} over {steps} steps "
          f"(restarts={out['restarts']}, device={bundle.device})")
    assert last < first, "training did not reduce the loss"
    return out


if __name__ == "__main__":
    main()
