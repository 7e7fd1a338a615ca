"""The 90th percentile of the front door's queue wait, acceptance ->
admission (the program's own stamps ``Request.submitted_at`` and
``admitted_at``), over every request submitted in the window; one still
queued when the window closes counts with its wait so far."""
from perfbench.harness import percentile, submitted_in_window

UNIT = "ms"
LAYER = "front door"
MOVES = "ttft_p90_ms"


def read(rec):
    t1 = rec["t1"]
    waits = [(r["admitted"] if r["admitted"] is not None and r["admitted"] < t1 else t1)
             - r["accepted"] for r in submitted_in_window(rec) if r["accepted"] is not None]
    p = percentile(waits, 90)
    return None if p is None else p * 1e3
