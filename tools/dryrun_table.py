#!/usr/bin/env python3
"""PERF.md's tables of the dry run's records (``python -m
repro_torch.launch.dryrun --all --both-meshes [--variant opt]``, which
writes ``build/dryrun/<arch>__<shape>__<mesh>[__opt].json``).

    python3 tools/dryrun_table.py [--dir build/dryrun] [--other DIR]

Prints one markdown table, a row an arch and a column a shape: the peak
GiB a card of its four cells (16x16 and 2x16x16, baseline then opt; "✗"
past the record's ``card_bytes``, "s" skipped, "f" failed), then each
cell's matmul TFLOP a card, collective GB a card by kind (all-gather /
all-reduce / all-to-all) and trace seconds.  Then the cells' statuses
counted, the longest trace, and, with ``--other`` (another run's records,
e.g. the card machine's), every cell whose numbers differ between the two
runs but ``trace_s`` and ``card_bytes``.
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")
MESHES = ("pod16x16", "pod2x16x16")
VARIANTS = ("", "__opt")
VOLATILE = ("trace_s", "card_bytes", "fits")


def load(d: Path) -> dict:
    return {p.stem: json.loads(p.read_text()) for p in sorted(d.glob("*.json"))}


def peak(rec) -> str:
    if rec is None:
        return "—"
    if rec["status"] != "ok":
        return rec["status"][0]
    g = rec["peak_bytes"] / 2**30
    return f"{g:.1f}{'' if rec['peak_bytes'] <= rec['card_bytes'] else '✗'}"


def work(rec) -> str:
    if rec is None or rec["status"] != "ok":
        return "—"
    c = rec["collectives"]
    gb = "/".join(f"{c.get(k, 0) / 1e9:.3g}" for k in ("all-gather", "all-reduce", "all-to-all"))
    return f"{rec['flops'] / 1e12:.4g}; {gb}; {rec['trace_s']:.0f}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="build/dryrun")
    ap.add_argument("--other")
    args = ap.parse_args(argv)
    recs = load(Path(args.dir))
    archs = sorted({r["arch"] for r in recs.values()}, key=list(dict.fromkeys(
        r["arch"] for r in recs.values())).index)

    def cell(a, s, m, v):
        return recs.get(f"{a}__{s}__{m}{v}")

    print("| arch | " + " | ".join(SHAPES) + " |")
    print("|---|" + "---|" * len(SHAPES))
    for a in archs:
        print(f"| {a} | " + " | ".join(
            " / ".join(peak(cell(a, s, m, v)) for v in VARIANTS for m in MESHES) + " ‖ "
            + " ‖ ".join(work(cell(a, s, m, v)) for v in VARIANTS for m in MESHES)
            for s in SHAPES) + " |")
    print()
    status = {}
    for r in recs.values():
        status[r["status"]] = status.get(r["status"], 0) + 1
    ok = [r for r in recs.values() if r["status"] == "ok"]
    longest = max(ok, key=lambda r: r["trace_s"]) if ok else None
    print(f"cells: {status}; trace_s summed {sum(r['trace_s'] for r in ok):.0f}", end="")
    if longest:
        print(f", longest {longest['arch']} {longest['shape']} {longest['mesh']} "
              f"{longest['variant']} {longest['trace_s']:.0f} s", end="")
    print()
    if args.other:
        other = load(Path(args.other))
        both = sorted(set(recs) & set(other))
        differ = [k for k in both
                  if {x: y for x, y in recs[k].items() if x not in VOLATILE}
                  != {x: y for x, y in other[k].items() if x not in VOLATILE}]
        print(f"against {args.other}: {len(both)} cells in both, {len(differ)} differ "
              f"{differ}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
