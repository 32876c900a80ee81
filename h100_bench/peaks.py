"""Published peaks of one NVIDIA H100 SXM (data sheet, dense, 700 W)."""
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12  # float32 outside the tensor cores
MEMORY_BYTES = 80e9


def least_seconds(work: dict) -> float:
    """The least time for ``{"bytes", "flops"}``: the larger of the bytes
    over the memory rate and the operations over the float32 peak."""
    return max(work["bytes"] / HBM_BYTES_PER_S, work["flops"] / F32_FLOPS_PER_S)
