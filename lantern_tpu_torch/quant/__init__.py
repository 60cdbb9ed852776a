"""Quantised storage: product quantization (``quant.pq``) and scalar i8 /
1-bit rows (``quant.scalar``)."""

from lantern_tpu_torch.quant.pq import (  # noqa: F401
    PQCodebook,
    array_to_pqvec,
    dequantize_vector,
    pq_decode,
    pq_encode,
    pqvec_to_array,
    quantize_vector,
    train_codebook,
    train_codebook_chunked,
)
from lantern_tpu_torch.quant.scalar import (  # noqa: F401
    binarize,
    dequantize_i8,
    quantize_i8,
)
