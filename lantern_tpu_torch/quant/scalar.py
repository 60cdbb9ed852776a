"""Scalar quantisation of stored rows: i8 and 1-bit (port of
lantern_tpu/quant/scalar.py).

- i8: symmetric per-row scaling, ``codes = round(x * 127 / max|x|)`` with a
  per-row f32 scale; the device keeps the int8 codes and the scales, and
  distances widen the codes on the fly (4x fewer bytes than f32 rows).
- b1: sign bits packed into 32-bit words (int32 tensors carrying the
  uint32 bits); distances become hamming, 32x fewer bytes than f32.

``quantize_i8`` matches the reference bit for bit: the same f32 division by
the scale, then round-half-to-even (``torch.round``, as ``jnp.round``).
"""

from __future__ import annotations

import torch

from lantern_tpu_torch.ops.distance import pack_bits


def quantize_i8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-row int8 quantisation -> (codes [n, d] int8, scales [n]
    f32)."""
    xf = x.float()
    amax = xf.abs().amax(-1)
    scales = torch.clamp(amax, min=1e-30) / 127.0
    codes = torch.clamp(torch.round(xf / scales[..., None]), -127, 127)
    return codes.to(torch.int8), scales


def dequantize_i8(codes: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    return codes.float() * scales[..., None]


def binarize(x: torch.Tensor) -> torch.Tensor:
    """1-bit quantisation: sign bits packed into int32 words (b1 storage)."""
    return pack_bits(x)
