"""Parity: the port's DeviceGraph against lantern_tpu's to_device.

Every array equals the reference's exactly (labels compared as u64; the
reference's dummy neighbors0 row kept), for f32 and bf16 rows, i8 codes with
their scales, and hamming words (the port's int32 words hold the
reference's uint32 bits), both through the port's own to_device and through
from_jax_arrays.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lantern_tpu.config import HnswParams, Metric, QuantKind
from lantern_tpu.graph.device import join_labels
from lantern_tpu.graph.device import to_device as jax_to_device
from lantern_tpu.graph.device import with_aug_norms as jax_with_aug_norms
from lantern_tpu.native import NativeHnsw as JaxNativeHnsw
from lantern_tpu_torch.graph.device import (
    from_jax_arrays,
    to_device,
    upper_ids_from_slots,
    with_aug_norms,
)
from lantern_tpu_torch.native import NativeHnsw

TENSORS = ("vectors", "sq_norms", "neighbors0", "upper_neighbors",
           "upper_slot", "levels", "deleted", "upper_ids")


def _np(t):
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy()
    return t.numpy()


def _jnp(a):
    a = np.asarray(a)
    if a.dtype == np.uint32:
        return a.view(np.int32)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def _assert_same(port, ref):
    for name in TENSORS:
        np.testing.assert_array_equal(_np(getattr(port, name)),
                                      _jnp(getattr(ref, name)), err_msg=name)
    np.testing.assert_array_equal(port.labels.numpy().view(np.uint64),
                                  join_labels(np.asarray(ref.labels)))
    assert (port.vec_scales is None) == (ref.vec_scales is None)
    if ref.vec_scales is not None:
        np.testing.assert_array_equal(port.vec_scales.numpy(),
                                      np.asarray(ref.vec_scales))
    assert (port.entry, port.max_level, port.num_nodes) == (
        int(ref.entry), int(ref.max_level), int(ref.num_nodes))
    assert (port.m, port.dim, port.metric, port.quant) == (
        ref.m, ref.dim, ref.metric, ref.quant)


@pytest.fixture(scope="module")
def engines():
    rng = np.random.default_rng(7)
    base = rng.standard_normal((500, 16)).astype(np.float32)
    labels = (rng.permutation(500).astype(np.uint64) << np.uint64(33)) + 5
    p = HnswParams(dim=16, m=8, ef_construction=32)
    port, ref = NativeHnsw(p, capacity=512, seed=1), JaxNativeHnsw(
        p, capacity=512, seed=1)
    for eng in (port, ref):
        eng.add(base, labels=labels, nthreads=1)
        eng.mark_deleted(labels[:40])
    return port, ref


@pytest.mark.parametrize("bf16", [False, True])
def test_to_device_matches_reference(engines, bf16):
    port_eng, ref_eng = engines
    ref = jax_to_device(ref_eng, dtype=jnp.bfloat16 if bf16 else None)
    port = to_device(port_eng, dtype=torch.bfloat16 if bf16 else None,
                     device="cpu")
    _assert_same(port, ref)
    _assert_same(port.to("cpu"), ref)
    assert port.neighbors0.shape[0] == port.cap + 1
    assert (port.neighbors0[-1] == -1).all()


@pytest.mark.parametrize("bf16", [False, True])
def test_from_jax_arrays_matches_reference(engines, bf16):
    ref = jax_with_aug_norms(
        jax_to_device(engines[1], dtype=jnp.bfloat16 if bf16 else None))
    arrays = {f.name: np.asarray(getattr(ref, f.name))
              for f in dataclasses.fields(ref)
              if getattr(ref, f.name) is not None
              and f.metadata.get("pytree_node", True)}
    port = from_jax_arrays(arrays, m=ref.m, dim=ref.dim, metric=ref.metric,
                           quant=ref.quant, device="cpu")
    _assert_same(port, ref)
    for name in ("upper_vectors", "upper_sq"):
        np.testing.assert_array_equal(_np(getattr(port, name)),
                                      _jnp(getattr(ref, name)))


@pytest.fixture(scope="module")
def quant_engines():
    """Engines over i8-dequantised rows (l2sq) and over packed words
    (hamming), port and reference built alike."""
    from lantern_tpu.quant.scalar import dequantize_i8, quantize_i8

    rng = np.random.default_rng(8)
    rows = rng.standard_normal((400, 16)).astype(np.float32)
    deq = np.asarray(dequantize_i8(*quantize_i8(jnp.asarray(rows))))
    words = rng.integers(0, 2**32, (400, 3), dtype=np.uint32)
    out = {}
    for name, vecs, kw in (("i8", deq, {}),
                           ("hamming", words, dict(metric=Metric.HAMMING))):
        p = HnswParams(dim=16 if name == "i8" else 80, m=8, ef_construction=32,
                       **kw)
        pair = NativeHnsw(p, capacity=400, seed=2), JaxNativeHnsw(
            p, capacity=400, seed=2)
        for eng in pair:
            eng.add(vecs, nthreads=1)
            eng.mark_deleted(np.arange(0, 400, 13, dtype=np.uint64))
        out[name] = pair
    return out


@pytest.mark.parametrize("kind", ["i8", "hamming"])
def test_quant_to_device_matches_reference(quant_engines, kind):
    port_eng, ref_eng = quant_engines[kind]
    if kind == "i8":
        ref = jax_to_device(ref_eng, quant=QuantKind.I8)
        port = to_device(port_eng, quant=QuantKind.I8, device="cpu")
        assert port.vectors.dtype == torch.int8
    else:
        ref = jax_to_device(ref_eng, dtype=jnp.bfloat16)  # no cast for words
        port = to_device(port_eng, dtype=torch.bfloat16, device="cpu")
        assert port.vectors.dtype == torch.int32 and port.vectors.shape[1] == 3
        assert not port.sq_norms.any()
        assert (port.vectors < 0).any()  # words >= 2^31 kept as their bits
    _assert_same(port, ref)
    arrays = {f.name: np.asarray(getattr(ref, f.name))
              for f in dataclasses.fields(ref)
              if getattr(ref, f.name) is not None
              and f.metadata.get("pytree_node", True)}
    _assert_same(from_jax_arrays(arrays, m=ref.m, dim=ref.dim,
                                 metric=ref.metric, quant=ref.quant,
                                 device="cpu"), ref)
    assert with_aug_norms(port) is port  # no upper cache for i8 / hamming


def test_with_aug_norms_caches_upper_tables(engines):
    port = with_aug_norms(to_device(engines[0], device="cpu"))
    ref = jax_with_aug_norms(jax_to_device(engines[1]))
    np.testing.assert_array_equal(port.upper_vectors.numpy(),
                                  np.asarray(ref.upper_vectors))
    np.testing.assert_array_equal(port.upper_sq.numpy(),
                                  np.asarray(ref.upper_sq))
    assert with_aug_norms(port) is port


def test_upper_ids_from_slots_inverts():
    slots = np.array([-1, 0, -1, 2, 1], np.int32)
    np.testing.assert_array_equal(upper_ids_from_slots(slots, 4),
                                  [1, 4, 3, -1])


def test_mirror_survives_engine_growth():
    """to_device copies: growing the engine (a realloc) leaves it intact."""
    p = HnswParams(dim=16, m=8, ef_construction=32)
    eng = NativeHnsw(p, capacity=64, seed=0)
    eng.add(np.ones((50, 16), np.float32), nthreads=1)
    g = to_device(eng, device="cpu")
    eng.grow(4096)
    eng.add(np.zeros((10, 16), np.float32), nthreads=1)
    assert g.cap == 50 and bool((g.vectors == 1).all())
