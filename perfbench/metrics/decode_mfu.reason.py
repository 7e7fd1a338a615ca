"""The decode steps' model operations as a floor time (int8 projection
operations at the card's int8 peak, attention or the SSD update and the
head at its bf16 peak), over the summed host time of the window's decode
launches (the program's ``launch:decode`` spans)."""
from perfbench import peaks
from perfbench.harness import spans_in_window, steps_in_window

UNIT = "%"
LAYER = "model step"
MOVES = "output_tokens_per_s"


def read(rec):
    spans = spans_in_window(rec, "launch:decode")
    steps = steps_in_window(rec)
    if not spans or not steps:
        return None
    m, counts = rec["model"], rec["counts"]
    floor = sum(peaks.ops_s(*counts.decode_ops(m, rows, live)) for _, _, rows, live in steps)
    return 100.0 * floor * len(spans) / len(steps) / sum(e - s for s, e in spans)
