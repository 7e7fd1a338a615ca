"""The mean host time of a decode launch in the window: the program's
``launch:decode`` spans (plan's rows in, the graph's replay, the tokens'
copy out), summed over their count."""
from perfbench.harness import spans_in_window

UNIT = "ms"
LAYER = "engine"
MOVES = "output_tokens_per_s"


def read(rec):
    spans = spans_in_window(rec, "launch:decode")
    if not spans:
        return None
    return 1e3 * sum(e - s for s, e in spans) / len(spans)
