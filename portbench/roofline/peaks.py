"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense,
without sparsity), at the full 700 W power limit: a roofline share is
stated against these, with the card's power limit beside it."""

HBM_BYTES_PER_S = 3.35e12
OPS_PER_S = {
    "f32": 67e12,     # CUDA cores, outside the tensor cores
    "tf32": 495e12,
    "bf16": 989e12,
    "int8": 1979e12,
}


def bound_s(ops: float, ops_kind: str, nbytes: float) -> float:
    """The least time the card could take: the larger of the operations
    over their peak and the bytes over the memory's."""
    return max(ops / OPS_PER_S[ops_kind], nbytes / HBM_BYTES_PER_S)
