"""The decode step's share of its roofline: over the decode steps of the
profiled sub-window, the byte floor at the card's HBM bandwidth (the
configuration's count: weights read once, live cache or state read once,
what the step writes written once, whatever kernels do it), over the
device busy time of the activities each step's graph launch ran."""

from perfbench import peaks

UNIT = "%"
LAYER = "kernels"
MOVES = "output_tokens_per_s"


def read(rec):
    steps = rec.get("profile", {}).get("decode")
    if not steps:
        return None
    m, counts = rec["model"], rec["counts"]
    floor = sum(counts.decode_bytes(m, rows, live) for _, rows, live in steps) / peaks.HBM_BYTES_S
    return 100.0 * floor / sum(busy for busy, _, _ in steps)
