"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
its 700 W limit): the yardstick of every least time."""
F32_FLOPS = 67e12          # float32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12  # HBM3


def least_seconds(ops: float, nbytes: float) -> float:
    return max(ops / F32_FLOPS, nbytes / HBM_BYTES_PER_S)
