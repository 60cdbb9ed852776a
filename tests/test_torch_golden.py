"""G2: the reference's small-world and cosine goldens held by the port.

The reference's ``tests/test_golden.py`` mirrors the pg_regress golden files
with the ``small_world`` fixture (the 8 corners of the unit cube,
test/expected/hnsw_select.out:5-19) and the cos_dist goldens. Here the
port's ``Index`` (on the CPU) is held to the same expected outputs on both
engines (native, python) and in the auto, graph and flat modes, and to the
reference's own results on the same inputs.
"""

import numpy as np
import pytest

from lantern_tpu_torch import HnswParams, Index
from lantern_tpu_torch.config import Metric

# the reference's small_world: 8 corners of the unit cube, ids 000..111
SMALL_WORLD = {
    "000": [0.0, 0.0, 0.0],
    "001": [0.0, 0.0, 1.0],
    "010": [0.0, 1.0, 0.0],
    "011": [0.0, 1.0, 1.0],
    "100": [1.0, 0.0, 0.0],
    "101": [1.0, 0.0, 1.0],
    "110": [1.0, 1.0, 0.0],
    "111": [1.0, 1.0, 1.0],
}
VECS = np.array(list(SMALL_WORLD.values()), np.float32)
# labels = binary value of the id string + 1 (0 is the null label)
LABELS = np.array([int(k, 2) + 1 for k in SMALL_WORLD], np.uint64)
ENGINES = ["native", "python"]
MODES = ["auto", "graph", "flat"]


@pytest.fixture(scope="module", params=ENGINES)
def small_world(request):
    ix = Index(HnswParams(dim=3, m=4, ef_construction=16), capacity=8, seed=0,
               engine=request.param, device="cpu")
    ix.add(VECS, labels=LABELS)
    return ix


@pytest.mark.parametrize("mode", MODES)
def test_small_world_golden_order(small_world, mode):
    """ORDER BY v <-> '{0,0,0}' LIMIT 8: the hamming-weight pattern
    0,1,1,1,2,2,2,3 of hnsw_select.out, '000' first, every label once."""
    d, labels = small_world.search(np.zeros(3, np.float32), k=8, ef=16,
                                   mode=mode)
    np.testing.assert_allclose(d[0], [0, 1, 1, 1, 2, 2, 2, 3], atol=1e-6)
    assert labels[0, 0] == 1
    assert sorted(labels[0].tolist()) == list(range(1, 9))


@pytest.mark.parametrize("mode", MODES)
def test_small_world_each_corner_self(small_world, mode):
    d, labels = small_world.search(VECS, k=1, ef=16, mode=mode)
    np.testing.assert_allclose(d[:, 0], 0, atol=1e-6)
    np.testing.assert_array_equal(labels[:, 0], LABELS)


@pytest.mark.parametrize("mode", MODES)
def test_small_world_matches_exact(small_world, mode):
    q = np.array([[0.1, 0.2, 0.9]], np.float32)
    d, labels = small_world.search(q, k=8, ef=16, mode=mode)
    exact = ((VECS.astype(np.float64) - q[0]) ** 2).sum(1)
    order = np.argsort(exact, kind="stable")
    np.testing.assert_allclose(d[0], exact[order], rtol=1e-5, atol=1e-5)
    # '111' and '010' tie at 1.46: labels compared as sets of each distance
    key = exact[order].round(6)
    for dist in np.unique(key):
        assert (sorted(labels[0][key == dist].tolist())
                == sorted(LABELS[order][key == dist].tolist()))


def test_small_world_deterministic_across_engines():
    results = []
    for engine in ENGINES:
        ix = Index(HnswParams(dim=3, m=4, ef_construction=16), capacity=8,
                   seed=0, engine=engine, device="cpu")
        ix.add(VECS, labels=LABELS)
        d, got = ix.search(np.zeros(3, np.float32), k=8, ef=16)
        results.append((d.round(6).tolist(), sorted(got[0].tolist())))
    assert results[0][0] == results[1][0]
    assert results[0][1] == results[1][1] == list(range(1, 9))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("engine", ENGINES)
def test_cosine_golden(engine, mode):
    """cos_dist goldens from the reference's dist-function tests."""
    vecs = np.array([[1, 0], [0, 1], [1, 1], [-1, 0]], np.float32)
    ix = Index(HnswParams(dim=2, m=4, ef_construction=16, metric=Metric.COS),
               capacity=4, seed=0, engine=engine, device="cpu")
    ix.add(vecs, labels=np.array([1, 2, 3, 4], np.uint64))
    d, labels = ix.search(np.array([1.0, 0.0], np.float32), k=4, ef=16,
                          mode=mode)
    np.testing.assert_allclose(
        d[0], [0.0, 1.0 - 1.0 / np.sqrt(2), 1.0, 2.0], atol=1e-6)
    assert labels[0].tolist() == [1, 3, 2, 4]


@pytest.mark.parametrize("mode", MODES)
def test_small_world_equals_reference(small_world, mode):
    """The same queries through the reference's Index: equal labels,
    distances within 1e-6."""
    from lantern_tpu import HnswParams as JaxParams
    from lantern_tpu import Index as JaxIndex

    ref = JaxIndex(JaxParams(dim=3, m=4, ef_construction=16), capacity=8,
                   seed=0)
    ref.add(VECS, labels=LABELS)
    q = np.concatenate([np.zeros((1, 3), np.float32), VECS,
                        np.array([[0.1, 0.2, 0.9]], np.float32)])
    want_d, want_l = ref.search(q, k=8, ef=16, mode=mode)
    d, labels = small_world.search(q, k=8, ef=16, mode=mode)
    np.testing.assert_allclose(d, want_d, rtol=0, atol=1e-6)
    # ties (equal distances) may come in either order
    for row_d, row_l, ref_l in zip(np.asarray(want_d), labels, np.asarray(want_l)):
        for dist in np.unique(row_d.round(5)):
            at = row_d.round(5) == dist
            assert sorted(row_l[at].tolist()) == sorted(ref_l[at].tolist())
