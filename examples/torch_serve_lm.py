"""Batched serving with the PDQ-int8 path on the PyTorch port.

Runs the same prompts through the fp and PDQ-int8 (W8A8 + int8 KV)
engines and compares greedy outputs and tokens/s.  On the card every
decode dispatch replays the engine's captured CUDA graph and the PDQ path
runs the hand-written kernels; ``--device cpu`` runs their plain versions.

    PYTHONPATH=src python examples/torch_serve_lm.py [--device cpu]
"""
import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs import reduced_config
from repro_torch.models import build_model
from repro_torch.serve import Request, ServeEngine


def main(argv=None, params=None):
    """Serve and print; returns {tag: greedy streams}.  ``params`` (a
    param tree on the device) replaces the seeded weights."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--arch", default="yi-6b", help="a registered config, reduced")
    ap.add_argument("--prompts", type=int, default=6)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--slots", type=int, default=3)
    ap.add_argument("--max-len", type=int, default=64)
    args = ap.parse_args(argv)

    cfg = reduced_config(args.arch)
    if params is None:
        params = build_model(cfg, args.device).init(0)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, args.prompt_len) for _ in range(args.prompts)]

    results = {}
    for tag, kw, c in (
        ("fp", dict(quantize_weights=False), cfg),
        ("pdq-int8", dict(quantize_weights=True),
         dataclasses.replace(cfg, quant_kv="dynamic")),
    ):
        eng = ServeEngine(c, params, slots=args.slots, max_len=args.max_len,
                          device=args.device, **kw)
        reqs = [Request(uid=i, prompt=p, max_new=args.max_new)
                for i, p in enumerate(prompts)]
        t0 = time.perf_counter()
        eng.run(reqs)
        if eng.device.type == "cuda":
            torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        toks = sum(len(r.generated) for r in reqs)
        results[tag] = [tuple(int(t) for t in r.generated) for r in reqs]
        print(f"{tag:9s}: {toks} tokens in {dt:.2f}s ({toks / dt:.1f} tok/s)")

    agree = np.mean([a == b for a, b in zip(results["fp"], results["pdq-int8"])])
    print(f"greedy sequence agreement fp vs pdq-int8: {agree:.2f} "
          "(random-weight demo model: near-uniform logits flip easily; "
          "tests/test_torch_engine.py checks parity with the reference on the same weights)")
    return results


if __name__ == "__main__":
    main()
