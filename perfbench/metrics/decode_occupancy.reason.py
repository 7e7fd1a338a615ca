"""The share of slot rows that consumed a token in the window's decode
steps: the change of the engine's ``decode_tokens`` over the change of its
``decode_steps`` times the slots (``engine.stats``)."""

UNIT = "%"
LAYER = "scheduler"
MOVES = "output_tokens_per_s"


def read(rec):
    s0, s1 = rec["stats0"], rec["stats1"]
    steps = s1["decode_steps"] - s0["decode_steps"]
    if steps <= 0:
        return None
    return 100.0 * (s1["decode_tokens"] - s0["decode_tokens"]) / (steps * rec["slots"])
