"""The 99th percentile of every gap between consecutive tokens of one
request, over all gaps that end in the window (host clock, each token's
time taken where it lands in its stream)."""
from perfbench.harness import percentile

UNIT = "ms"


def read(rec):
    t0, t1 = rec["t0"], rec["t1"]
    gaps = [b - a for r in rec["requests"] for a, b in zip(r["times"], r["times"][1:])
            if t0 <= b < t1]
    p = percentile(gaps, 99)
    return None if p is None else p * 1e3
