"""One run of one benchmark cell on the card; prints the result as the last
line of standard output.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout.  Exits 2 without a result when the card
is missing or fewer cards are present than the cell asks for, when the cell
cannot run (see ``harness.py``), or when JAX or the JAX package is loaded in
this process once the window has closed.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # the program's one build cache, its kernels', is build/kernels inside
    # the checkout, at a path fixed by the program
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    from perfbench import harness

    import torch
    try:
        need = harness.cell(args.workload, False)["workload"]["chips"]
        if not torch.cuda.is_available() or torch.cuda.device_count() < need:
            raise harness.RunError(
                f"the cell needs {need} CUDA card(s); this machine has "
                f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        out = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace))
        loaded = harness.forbidden_modules()      # the window has closed
        if loaded:
            raise harness.RunError(f"modules of JAX or of the JAX package are loaded: {loaded[:8]}")
    except (harness.RunError, ModuleNotFoundError) as e:
        # ModuleNotFoundError: a checkout without the program (only perfbench/)
        print(f"no result: {e}", file=sys.stderr)
        return 2
    sys.stdout.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
