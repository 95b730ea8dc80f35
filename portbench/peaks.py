"""Published peaks of one NVIDIA H100 SXM (data sheet, dense rates, 700 W)."""

HBM_BYTES_PER_S = 3.35e12          # HBM3
F32_FLOPS_PER_S = 67e12            # float32 outside the tensor cores
VECTOR_OPS_PER_S = 67e12           # 32-bit integer and float lanes (codec kernels)
TF32_FLOPS_PER_S = 495e12          # dense TF32 on the tensor cores


def bound_seconds(nbytes: float, ops: float) -> float:
    """The least time the chip could take: bytes over the memory bandwidth
    or operations over the lanes' peak, whichever is larger."""
    return max(nbytes / HBM_BYTES_PER_S, ops / VECTOR_OPS_PER_S)
