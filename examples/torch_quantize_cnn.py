"""Paper-track example on the PyTorch port: train a Mini-ResNet, calibrate,
and compare static / dynamic / PDQ quantization in-domain and under
corruption.  Runs on the card; ``--device cpu`` runs it on the CPU.

    PYTHONPATH=src python examples/torch_quantize_cnn.py [--device cpu] [--steps N]
"""
import argparse

import numpy as np
import torch

from repro_torch.core import qlinear, run_calibration, spec_for_mode
from repro_torch.data.corruptions import corrupt_batch
from repro_torch.models import resolve_device
from repro_torch.models.cnn import CNNConfig, cnn_apply, cnn_init, make_gratings, train_cnn


def main(argv=None):
    """Train, calibrate, evaluate and print; returns the fp32 eval loss
    before and after training and every mode's top-1 per domain."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--steps", type=int, default=150)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--eval", type=int, default=256, help="eval images")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = CNNConfig(arch="mini_resnet", width=16, res=20)
    print("training fp32 Mini-ResNet on synthetic gratings...")
    init = cnn_init(0, cfg, device)
    params = train_cnn(cfg, steps=args.steps, batch=args.batch, device=device, params=init)

    def apply_fn(p, x, *, spec, qstate, tape=None):
        return cnn_apply(p, x, cfg=cfg, spec=spec, qstate=qstate, tape=tape)

    calib_imgs, _ = make_gratings(5, 16, res=cfg.res)
    spec = spec_for_mode("pdq", per_channel=True)
    imgs, labels = make_gratings(77, args.eval, res=cfg.res)
    imgs_ood = corrupt_batch(imgs, np.random.default_rng(1))
    fp32 = spec_for_mode("none")
    out = {}
    with qlinear.fp32_convs(), torch.no_grad():
        qstate = run_calibration(apply_fn, params,
                                 [torch.from_numpy(calib_imgs).to(device)], spec)
        x, y = torch.from_numpy(imgs).to(device), torch.from_numpy(labels).to(device)
        out["loss"] = [float(torch.nn.functional.cross_entropy(
            apply_fn(p, x, spec=fp32, qstate={}), y.long())) for p in (init, params)]
        print(f"fp32 eval loss {out['loss'][0]:.3f} -> {out['loss'][1]:.3f} "
              f"over {args.steps} steps")
        for name, data in (("in-domain", imgs), ("corrupted", imgs_ood)):
            print(f"\n{name}:")
            for mode in ("none", "static", "dynamic", "pdq"):
                sp = spec_for_mode(mode, per_channel=True)
                logits = apply_fn(params, torch.from_numpy(data).to(device), spec=sp,
                                  qstate=qstate)
                acc = float((logits.argmax(-1).cpu().numpy() == labels).mean())
                out[(name, mode)] = acc
                print(f"  {mode:8s} top-1 = {acc:.4f}")
    return out


if __name__ == "__main__":
    main()
