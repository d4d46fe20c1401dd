"""The card's published peaks (NVIDIA H100 SXM data sheet, dense, at its
700 W limit), the yardstick of every roofline share and ``mfu``."""

BF16_FLOP_PER_S = 989e12
HBM_BYTES_PER_S = 3.35e12


def least_seconds(flop: float, nbytes: float) -> float:
    """The least time of ``flop`` dot-product FLOPs and ``nbytes`` bytes:
    the larger of the two terms."""
    return max(flop / BF16_FLOP_PER_S, nbytes / HBM_BYTES_PER_S)
