"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates,
at the full 700 W power limit).  Roofline and utilization shares are taken
against these, with the card's power limit reported beside them."""

HBM_BYTES_S = 3.35e12        # HBM3
INT8_OPS_S = 1979e12         # tensor cores, int8
BF16_FLOPS_S = 989e12        # tensor cores, bf16 / fp16


def ops_s(int8_ops: float, flops: float) -> float:
    """The least time the card's tensor cores take for these operations:
    int8 ones at the int8 peak, the rest at the bf16 peak, one after the
    other."""
    return int8_ops / INT8_OPS_S + flops / BF16_FLOPS_S
