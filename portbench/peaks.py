"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
the 700 W limit): the denominators of every roofline and MFU share."""

HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
F32_FLOP_PER_S = 67e12        # outside the tensor cores


def bound_s(nbytes: float, flops: float, flop_per_s: float) -> float:
    """The least time the chip could take: the larger of bytes over HBM
    bandwidth and operations over the peak."""
    return max(nbytes / HBM_BYTES_PER_S, flops / flop_per_s)
