"""Quantised storage: product quantization (``quant.pq``)."""
