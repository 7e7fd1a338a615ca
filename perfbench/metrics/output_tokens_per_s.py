"""Output tokens that landed in their streams during the window, over the
window's length (host clock)."""
from perfbench.harness import window_tokens

UNIT = "tokens/s"


def read(rec):
    return window_tokens(rec) / (rec["t1"] - rec["t0"])
