"""The device's idle share of the profiled sub-window: one less the union of
every device activity's interval over the sub-window's length
(``torch.profiler``)."""

UNIT = "%"
LAYER = "device"
MOVES = "output_tokens_per_s"


def read(rec):
    p = rec.get("profile")
    if not p or p["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])
