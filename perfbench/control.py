"""The check's two readings on the card, at the cell's own size: for each
seed, one run of the cell (its window at the cell's own load) and, over the
same sample of served requests, the widest logit gap of the program's
tokens and of the tokens the 4-bit control (``forward(..., bits=4)`` of
the cell's reference) puts first, each judged by the same comparison.  The
limit in the configuration's file lies between the largest program reading
and the smallest control reading.  With ``--fault`` a fault of
``faults.py`` is planted under the timed path and the program's reading is
the fault's (no control is read).

    python3 perfbench/control.py --workload <name> --seeds 1,2,3 --seconds 45 \\
        [--fault altered_token] [--out chiprun_out/control.jsonl]

Exits 1 when a control or a fault comes out correct.  The benchmark's own
runs do not run it.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--fault", default=None, help="a fault of faults.py to plant")
    ap.add_argument("--out", default=None, help="append one JSON line a seed here")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    from perfbench import harness
    from perfbench.faults import FAULTS

    import torch
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    patch = FAULTS[args.fault] if args.fault else None
    rc = 0
    for seed in (int(s) for s in args.seeds.split(",")):
        out = harness.run_cell(args.workload, seed, args.seconds, False,
                               control=patch is None, patch=patch)
        rec = {"workload": args.workload, "seed": seed, "fault": args.fault,
               "program_gap": out["check"]["logit_gap"]["value"], "correct": out["correct"]}
        if patch is None:
            rec.update(control_gap=out["check"]["control_gap"]["value"],
                       control_correct=out["control_correct"])
        rec.update(metrics=out["metrics"], device=out["device"])
        if out["correct"] if patch is not None else out["control_correct"]:
            rc = 1
        line = json.dumps(rec)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
        torch.cuda.reset_peak_memory_stats()
    return rc


if __name__ == "__main__":
    sys.exit(main())
