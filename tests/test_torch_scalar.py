"""Parity: the port's quant/scalar.py against lantern_tpu's.

quantize_i8 must match bit for bit (codes and scales): the same f32
division by the scale and round-half-to-even, including rows whose scaled
values land exactly on .5 and all-zero rows. dequantize_i8 is one f32
product per element, so it matches exactly too. binarize / pack_bits give
the same bits (the port's int32 words viewed as uint32).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lantern_tpu.quant import scalar as js
from lantern_tpu_torch.ops.distance import unpack_bits
from lantern_tpu_torch.quant import scalar as ts


def _rows(rng):
    x = rng.standard_normal((64, 37)).astype(np.float32) * 3
    x[0] = 0.0  # all-zero row: scale 1e-30 / 127, codes 0
    x[1, :7] = [127.0, 0.5, 1.5, 2.5, -0.5, -2.5, 126.5]  # scale 1: halves
    x[1, 7:] = 0.0
    x[2] *= 1e-20  # tiny scale
    return x


def test_quantize_i8_bit_equal(rng):
    x = _rows(rng)
    codes, scales = ts.quantize_i8(torch.from_numpy(x))
    wc, ws = js.quantize_i8(jnp.asarray(x))
    assert codes.dtype == torch.int8 and scales.dtype == torch.float32
    np.testing.assert_array_equal(codes.numpy(), np.asarray(wc))
    np.testing.assert_array_equal(scales.numpy().view(np.int32),
                                  np.asarray(ws).view(np.int32))
    assert codes[1, :7].tolist() == [127, 0, 2, 2, 0, -2, 126]  # half-even
    np.testing.assert_array_equal(
        ts.dequantize_i8(codes, scales).numpy(),
        np.asarray(js.dequantize_i8(wc, ws)))


def test_quantize_i8_is_idempotent_on_dequantised_rows(rng):
    """The device mirror re-encodes the engine's dequantised rows: the
    codes must come back unchanged."""
    codes, scales = ts.quantize_i8(torch.from_numpy(_rows(rng)))
    again, _ = ts.quantize_i8(ts.dequantize_i8(codes, scales))
    assert torch.equal(again, codes)


@pytest.mark.parametrize("dim", [31, 32, 33, 70, 1024])
def test_binarize_bit_equal(rng, dim):
    x = rng.standard_normal((9, dim)).astype(np.float32)
    x[0, :3] = 0.0  # zero is not positive: bit clear
    got = ts.binarize(torch.from_numpy(x))
    want = np.asarray(js.binarize(jnp.asarray(x)))
    assert got.dtype == torch.int32 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    np.testing.assert_array_equal(unpack_bits(got, dim).numpy(),
                                  (x > 0).astype(np.float32))
