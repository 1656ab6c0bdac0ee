"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at the card's full 700 W), frozen with the benchmark: every
roofline share and every ``mfu`` reads them."""

HBM_BYTES_PER_S = 3.35e12
FLOPS = {"bfloat16": 989e12, "tf32": 495e12, "float32": 67e12}


def bound_s(flops: float, nbytes: float, dtype: str) -> float:
    """The least seconds the card could take: the larger of the compute
    and the memory term."""
    return max(flops / FLOPS[dtype], nbytes / HBM_BYTES_PER_S)
