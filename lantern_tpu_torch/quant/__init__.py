"""Quantised storage: product quantization (``quant.pq``) and scalar i8 /
1-bit rows (``quant.scalar``)."""

from lantern_tpu_torch.quant.pq import (  # noqa: F401
    PQCodebook,
    pq_decode,
    pq_encode,
    train_codebook,
)
from lantern_tpu_torch.quant.scalar import (  # noqa: F401
    binarize,
    dequantize_i8,
    quantize_i8,
)
