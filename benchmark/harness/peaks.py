"""The card's published peaks and the least time a piece of work needs.

NVIDIA H100 SXM data sheet, dense rates without sparsity, at the full
700 W power limit: 989 TFLOP/s in bf16 and fp16, 67 TFLOP/s in float32
outside the tensor cores, 3.35 TB/s of HBM.
"""

PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
HBM_BYTES_PER_S = 3.35e12


def bound_s(flops: float, nbytes: float, precision: str) -> float:
    """The larger of operations over the peak and bytes over the HBM rate."""
    return max(flops / PEAK_FLOPS[precision], nbytes / HBM_BYTES_PER_S)
