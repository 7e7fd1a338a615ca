"""Quickstart on the PyTorch port: the PDQ idea in 30 lines.

Calibrate once, then quantize a layer's output with parameters *predicted
from the input* - before the matmul runs (paper Sec. 4).  Runs on the
card; ``--device cpu`` runs it on the CPU.

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""
import argparse

import torch

from repro_torch.core import qlinear, run_calibration, spec_for_mode
from repro_torch.models import resolve_device


def model(params, x, *, spec, qstate, tape=None):
    """A 2-layer MLP whose pre-activations are quantized per the spec."""
    h = qlinear.dense(x, params[0], None, name="fc1",
                      policy=spec.resolve("fc1"), state=qstate, tape=tape)
    h = torch.relu(h)
    return qlinear.dense(h, params[1], None, name="fc2",
                         policy=spec.resolve("fc2"), state=qstate, tape=tape)


def rel_errors(params, calib, x):
    """{mode: mean |out - fp| / mean |fp|} of the static, dynamic and PDQ
    modes on ``x``, every mode's state calibrated on ``calib``."""
    spec = spec_for_mode("pdq", per_channel=True)
    qstate = run_calibration(model, params, calib, spec)
    with torch.no_grad():
        ref = model(params, x, spec=spec_for_mode("none"), qstate={})
        return {mode: float((model(params, x, spec=spec_for_mode(mode, per_channel=True),
                                   qstate=qstate) - ref).abs().mean() / ref.abs().mean())
                for mode in ("static", "dynamic", "pdq")}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)

    def normal(*shape):
        return torch.randn(shape, generator=gen, device=device)

    params = (0.1 * normal(256, 512), 0.1 * normal(512, 64))

    # 1. calibrate (16 samples, shared by static & PDQ - as in the paper)
    calib = [normal(8, 256) for _ in range(2)]
    # 2. evaluate the three quantization modes under an input-scale shift
    x = 5.0 * normal(32, 256)
    errs = rel_errors(params, calib, x)
    for mode, err in errs.items():
        print(f"{mode:8s} rel-err under 5x input shift: {err:.4f}")
    print("-> PDQ tracks the shifted inputs (like dynamic) without ever "
          "materializing an unquantized output tensor (like static).")
    return errs


if __name__ == "__main__":
    main()
