"""The 90th percentile of submit -> first token over every request submitted
in the window (host clock); a request still without a token when the
window closes counts with its wait so far."""
from perfbench.harness import percentile, submitted_in_window

UNIT = "ms"


def read(rec):
    t1 = rec["t1"]
    waits = [(r["times"][0] if r["times"] and r["times"][0] < t1 else t1) - r["submit"]
             for r in submitted_in_window(rec)]
    p = percentile(waits, 90)
    return None if p is None else p * 1e3
