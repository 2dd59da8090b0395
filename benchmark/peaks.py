"""Published peaks of one NVIDIA H100 SXM (data sheet, dense, at 700 W)."""

BF16_FLOPS = 989e12
TF32_FLOPS = 494.7e12
FP32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12


def flops_peak(precision: str) -> float:
    """The peak of a program precision: "exact" runs float32 outside the
    tensor cores (TF32 off), "fast" bfloat16."""
    return {"exact": FP32_FLOPS, "fast": BF16_FLOPS}[precision]

