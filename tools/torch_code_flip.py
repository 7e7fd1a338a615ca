#!/usr/bin/env python3
"""How far one wo code one apart moves zamba2's logits, on the CPU.

Reduced zamba2-7b (``reduced_config``, ``n_layers`` 9: 5 mamba layers, one
occurrence of the shared attention + MLP block, 3 tail mamba layers; d_model
64), PDQ-int8 records, int8 KV cache, random weights from seed 0: a prompt of
``--prompt`` tokens, then ``--steps`` greedy decode steps twice, the second
run teacher-forced on the first's tokens with ONE int8 code of the shared
occurrence's wo prologue (K5's ``o_q``, its plain version on the CPU) moved
by one at decode step ``--flip`` - what a K5 code within its contract does
on the card (``chip_smoke.py`` phase 5, ``code_flips``).  Prints, per step,
the largest |logit| difference between the two runs: the flipped step's
own and the drift the SSD state and the KV cache carry after it; then the
largest |logit| of the run.  For each model dtype of ``--dtypes``:

    python3 tools/torch_code_flip.py [--prompt 40] [--steps 8] [--flip 1]
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def run(dtype: str, prompt_len: int, steps: int, flip: int) -> list[float]:
    import numpy as np
    import torch
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import reduced_config
    from repro_torch.kernels import kv_cache as kv
    from repro_torch.models import build_model
    from repro_torch.models.linops import quantize_param_tree
    cfg = reduced_config("zamba2-7b", n_layers=9, dtype=dtype, quant_kv="dynamic")
    bundle = build_model(cfg, "cpu")
    params = quantize_param_tree(bundle.init(0))
    prompt = torch.as_tensor(np.random.default_rng(7).integers(
        0, cfg.vocab, size=(1, prompt_len)).astype(np.int32))
    at = [0, None]              # the decode step running; the step to flip at

    orig = kv.decode_attend_i8kv_fused

    def flipped(*args, **kw):
        res = orig(*args, **kw)
        if at[0] != at[1]:
            return res
        o, o_q, *rest = res
        o_q = o_q.clone()
        flat = o_q.view(o_q.shape[0], -1)
        c = int(flat[0, 0])
        flat[0, 0] = c + 1 if c < 127 else c - 1
        return (o, o_q, *rest)

    def decode(teacher=None):
        caches = bundle.init_caches(1, prompt_len + steps + 1)
        at[0] = 0
        logits, caches = bundle.prefill_many(params, {"tokens": prompt}, caches,
                                             torch.tensor([prompt_len], dtype=torch.int32))
        out, toks = [logits[0].float()], []
        for i in range(steps - 1):
            tok = int(out[-1].argmax()) if teacher is None else teacher[i]
            toks.append(tok)
            at[0] = i + 1
            logits, caches = bundle.decode_step(
                params, caches, torch.tensor([[tok]], dtype=torch.int32),
                torch.tensor([[prompt_len + i]], dtype=torch.int32))
            out.append(logits[0].float())
        return out, toks

    kv.decode_attend_i8kv_fused = flipped
    try:
        base, toks = decode()
        at[1] = flip
        moved, _ = decode(teacher=toks)
    finally:
        kv.decode_attend_i8kv_fused = orig
    diffs = [float((a - b).abs().max()) for a, b in zip(base, moved)]
    print(f"{dtype}: one wo code of the shared occurrence moved by one at decode step "
          f"{flip}: max |logit diff| per step {diffs}; max |logit| "
          f"{max(float(x.abs().max()) for x in base):.4g}", flush=True)
    return diffs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--prompt", type=int, default=40)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--flip", type=int, default=1)
    ap.add_argument("--dtypes", default="float32,bfloat16")
    args = ap.parse_args()
    import torch
    torch.set_num_threads(1)
    for dtype in args.dtypes.split(","):
        run(dtype, args.prompt, args.steps, args.flip)
    return 0


if __name__ == "__main__":
    sys.exit(main())
