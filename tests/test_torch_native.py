"""Parity: the port's copy of the native HNSW engine against lantern_tpu's.

The same source, seed, rows and nthreads=1 must give byte-equal graphs
(tolerance: exact equality of every exported array).
"""

import pathlib

import numpy as np
import pytest

from lantern_tpu.config import HnswParams as JaxHnswParams
from lantern_tpu.graph.host_build import LMAX as JAX_LMAX
from lantern_tpu.native import NativeHnsw as JaxNativeHnsw
from lantern_tpu_torch.config import HnswParams, Metric
from lantern_tpu_torch.native import LMAX, NativeHnsw

ROOT = pathlib.Path(__file__).resolve().parents[1]
FIELDS = ("vectors", "neighbors0", "counts0", "upper_neighbors",
          "upper_counts", "upper_slot", "levels", "labels", "deleted")


def test_engine_source_is_the_reference_source():
    port = (ROOT / "lantern_tpu_torch/native/hnsw_engine.cpp").read_bytes()
    ref = (ROOT / "lantern_tpu/native/hnsw_engine.cpp").read_bytes()
    assert port == ref
    assert LMAX == JAX_LMAX
    assert f"constexpr int LMAX = {LMAX};".encode() in port


@pytest.mark.parametrize("metric", ["l2sq", "cos"])
def test_engine_matches_reference(rng, metric):
    base = rng.standard_normal((600, 24)).astype(np.float32)
    labels = rng.permutation(10**6)[:600].astype(np.uint64)
    kw = dict(dim=24, m=8, ef_construction=32, metric=Metric.from_string(metric))
    port = NativeHnsw(HnswParams(**kw), capacity=256, seed=3)
    ref = JaxNativeHnsw(JaxHnswParams(**kw), capacity=256, seed=3)
    for eng in (port, ref):
        eng.grow(1024)
        eng.add(base[:300], labels=labels[:300], nthreads=1)
        eng.add(base[300:], labels=labels[300:], nthreads=1)
        eng.mark_deleted(labels[::7])
    assert (port.n, port.n_upper, port.entry, port.max_level) == (
        ref.n, ref.n_upper, ref.entry, ref.max_level)
    for name in FIELDS:
        np.testing.assert_array_equal(getattr(port, name), getattr(ref, name),
                                      err_msg=name)
    ids_p, d_p = port.search(base[5] + 0.01, k=10, ef=32)
    ids_r, d_r = ref.search(base[5] + 0.01, k=10, ef=32)
    np.testing.assert_array_equal(ids_p, ids_r)
    np.testing.assert_array_equal(d_p, d_r)


def test_engine_refuses_hamming():
    with pytest.raises(NotImplementedError, match="hamming"):
        NativeHnsw(HnswParams(dim=64, metric=Metric.HAMMING))
