"""Process start until the window opens: imports, the card's context, the
weights made from the seed and quantized, the pool, the decode graph's
capture, the kernels' build or load, and every client's first request
admitted (host clock)."""

UNIT = "s"


def read(rec):
    return rec["setup_s"]
