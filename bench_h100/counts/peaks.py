"""Published peaks of one NVIDIA H100 SXM (data sheet, dense rates, at
the full 700 W power limit)."""

F32_FLOPS = 67e12          # float32 outside the tensor cores
BF16_FLOPS = 989e12        # bfloat16 tensor cores
HBM_BYTES = 3.35e12        # HBM3 bandwidth


def bound_s(nbytes: float, f32_ops: float = 0.0,
            bf16_ops: float = 0.0) -> float:
    """The least time of a call: the larger of its bytes at the HBM
    bandwidth and its operations at the peaks."""
    return max(nbytes / HBM_BYTES, f32_ops / F32_FLOPS
               + bf16_ops / BF16_FLOPS)
