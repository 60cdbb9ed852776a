"""Parity: the port's copy of the native HNSW engine against lantern_tpu's.

The same source, seed, rows and nthreads=1 must give byte-equal graphs
(tolerance: exact equality of every exported array), for f32 rows (l2sq,
cos) and for packed uint32 words (hamming, ceil(dim/32) words a row).
nthreads=1 because a multi-threaded build depends on thread timing (fault
F1 of the reference).
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


def _rows(rng, metric, n, dim):
    if metric != "hamming":
        return rng.standard_normal((n, dim)).astype(np.float32)
    # clustered bit rows: 12 centres, each bit flipped with p = 1/8
    words = -(-dim // 32)
    centres = rng.integers(0, 2**32, (12, words), dtype=np.uint32)
    flips = [rng.integers(0, 2**32, (n, words), dtype=np.uint32) for _ in range(3)]
    return centres[rng.integers(0, 12, n)] ^ (flips[0] & flips[1] & flips[2])


@pytest.mark.parametrize("metric", ["l2sq", "cos", "hamming"])
def test_engine_matches_reference(rng, metric):
    dim = 70 if metric == "hamming" else 24  # 3 words, the last one partial
    base = _rows(rng, metric, 600, dim)
    labels = rng.permutation(10**6)[:600].astype(np.uint64)
    kw = dict(dim=dim, m=8, ef_construction=32, metric=Metric.from_string(metric))
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
    query = base[5] ^ np.uint32(0b1011) if metric == "hamming" else base[5] + 0.01
    ids_p, d_p = port.search(query, k=10, ef=32)
    ids_r, d_r = ref.search(query, k=10, ef=32)
    np.testing.assert_array_equal(ids_p, ids_r)
    np.testing.assert_array_equal(d_p, d_r)
    if metric == "hamming":
        assert port.vectors.dtype == np.uint32 and port.vectors.shape[1] == 3


def test_engine_refuses_hamming():
    """A hamming engine takes ceil(dim/32) words a row and refuses dim-wide
    float rows, as the reference's does."""
    p = HnswParams(dim=64, metric=Metric.HAMMING)
    port, ref = NativeHnsw(p, capacity=16), JaxNativeHnsw(p, capacity=16)
    for eng in (port, ref):
        with pytest.raises(ValueError, match="width 64 != expected 2"):
            eng.add(np.ones((4, 64), np.float32), nthreads=1)
    assert port.words == ref.words == 2
