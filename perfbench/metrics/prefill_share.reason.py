"""The share of the window spent in prefill launches: the program's
``launch:prefill`` and ``launch:chunked`` spans, cut to the window, over
its length."""

UNIT = "%"
LAYER = "engine"
MOVES = "itl_p99_ms"


def read(rec):
    t0, t1 = rec["t0"], rec["t1"]
    busy = sum(max(0.0, min(e, t1) - max(s, t0)) for n, s, e in rec["spans"]
               if n in ("launch:prefill", "launch:chunked"))
    return 100.0 * busy / (t1 - t0)
