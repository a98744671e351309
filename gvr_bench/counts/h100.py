"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates,
at the full 700 W power limit)."""

HBM_BYTES_PER_S = 3.35e12        # HBM3
BF16_FLOPS = 989e12              # dense bf16 on the tensor cores


def bound_s(nbytes: float, flops: float) -> float:
    """The least seconds the card could take: bytes over the memory's rate
    or operations over the bf16 peak, whichever is larger."""
    return max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS)
