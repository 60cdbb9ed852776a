"""Parity: the port's numpy host engine (graph/host_build.py, HostHnsw)
against lantern_tpu's, and tests/test_graph.py's host cases through the
port's device mirror and beam.

HostHnsw is numpy only, the same code in both packages: after ``add`` with
the same seed every array is equal, and so are single-query searches. The
port's beam over ``to_device(HostHnsw)`` on the CPU must reach the
reference's recall floors (>= 0.9 against an exact scan).
"""

import copy

import numpy as np
import pytest
import torch

from lantern_tpu.graph.host_build import HostHnsw as RefHostHnsw
from lantern_tpu_torch.config import HnswParams, Metric
from lantern_tpu_torch.graph import LMAX, HostHnsw, search_batched, to_device
from lantern_tpu_torch.ops.distance import exact_search, pack_bits

CPU = "cpu"
ARRAYS = ("vectors", "neighbors0", "counts0", "upper_neighbors",
          "upper_counts", "upper_slot", "levels", "labels", "deleted")


def _recall(found_ids, true_ids):
    hits = 0
    for f, t in zip(found_ids, true_ids):
        hits += len(set(int(x) for x in f if x >= 0) & set(int(x) for x in t))
    return hits / true_ids.size


def assert_engines_equal(a, b):
    assert (a.n, a.n_upper, a.entry, a.max_level) == (
        b.n, b.n_upper, b.entry, b.max_level)
    for name in ARRAYS:
        np.testing.assert_array_equal(np.asarray(getattr(a, name)),
                                      np.asarray(getattr(b, name)), name)


@pytest.fixture(scope="module")
def built_l2():
    rng = np.random.default_rng(42)
    base = rng.standard_normal((2000, 32)).astype(np.float32)
    p = HnswParams(dim=32, m=8, ef_construction=64, metric=Metric.L2SQ)
    h = HostHnsw(p, capacity=2048, seed=1)
    h.add(base, labels=np.arange(2000, dtype=np.uint64) + 100)
    return h, base


@pytest.mark.parametrize("metric", [Metric.L2SQ, Metric.COS, Metric.HAMMING])
def test_arrays_equal_reference(metric):
    """Same seed, same rows, same batches: every array equals the
    reference's, through capacity doubling (capacity 8 < 700 rows)."""
    from lantern_tpu.config import HnswParams as RefParams

    rng = np.random.default_rng(3)
    if metric == Metric.HAMMING:
        base = rng.integers(0, 2**32, (700, 2), dtype=np.uint32)
        dim = 64
    else:
        base = rng.standard_normal((700, 16)).astype(np.float32)
        dim = 16
    kw = dict(dim=dim, m=6, ef_construction=32, metric=int(metric))
    port = HostHnsw(HnswParams(**kw), capacity=8, seed=9)
    ref = RefHostHnsw(RefParams(**kw), capacity=8, seed=9)
    for lo, hi in ((0, 300), (300, 700)):
        port.add(base[lo:hi])
        ref.add(base[lo:hi])
    dead = np.arange(0, 700, 7, dtype=np.uint64)
    assert port.mark_deleted(dead) == ref.mark_deleted(dead) == len(dead)
    assert port.mark_deleted(dead) == 0  # a repeat delete kills nothing
    assert_engines_equal(port, ref)
    assert port.upper_neighbors.shape[1] == LMAX
    for q in base[:5]:
        ids_p, d_p = port.search(q, k=5, ef=32)
        ids_r, d_r = ref.search(q, k=5, ef=32)
        np.testing.assert_array_equal(ids_p, ids_r)
        np.testing.assert_array_equal(d_p, d_r)


def test_add_refuses_bad_input():
    h = HostHnsw(HnswParams(dim=4, m=4, ef_construction=16), seed=0)
    with pytest.raises(ValueError, match="width"):
        h.add(np.zeros((2, 5), np.float32))
    with pytest.raises(ValueError, match="labels"):
        h.add(np.zeros((2, 4), np.float32), labels=np.arange(3))


def test_host_build_invariants(built_l2):
    h, _ = built_l2
    assert h.n == 2000
    assert h.entry >= 0 and h.max_level >= 0
    assert (h.counts0[: h.n] <= h.p.m0).all()
    assert (h.upper_counts <= h.p.m).all()
    for v in range(0, h.n, 97):
        nb = h.neighbors0[v, : h.counts0[v]]
        assert ((nb >= 0) & (nb < h.n)).all()
        assert v not in nb
    assert (h.levels[: h.n] == 0).mean() > 0.8


def test_host_search_recall(built_l2):
    h, base = built_l2
    rng = np.random.default_rng(7)
    queries = rng.standard_normal((20, 32)).astype(np.float32)
    _, true_ids = exact_search(torch.from_numpy(queries),
                               torch.from_numpy(base), k=10)
    found = np.stack([h.search(q, k=10, ef=64)[0] for q in queries])
    assert _recall(found, true_ids.numpy()) >= 0.9


def test_device_search_matches_oracle_recall(built_l2):
    h, base = built_l2
    rng = np.random.default_rng(8)
    queries = torch.from_numpy(rng.standard_normal((32, 32)).astype(np.float32))
    g = to_device(h, device=CPU)
    d, ids, labels = search_batched(g, queries, k=10, ef=64)
    d, ids = d.numpy(), ids.numpy()
    _, true_ids = exact_search(queries, torch.from_numpy(base), k=10)
    assert _recall(ids, true_ids.numpy()) >= 0.9
    valid = ids >= 0
    np.testing.assert_array_equal(labels.numpy().view(np.uint64)[valid],
                                  (ids[valid] + 100).astype(np.uint64))
    dd = np.where(np.isfinite(d), d, np.inf)
    assert (np.diff(dd, axis=1) >= -1e-6).all()


def test_device_vs_host_same_graph_close(built_l2):
    """Over the same graph the batched beam (exact upper entry scan) finds
    results at least as good as the host's greedy descent."""
    h, _ = built_l2
    rng = np.random.default_rng(9)
    queries = rng.standard_normal((8, 32)).astype(np.float32)
    g = to_device(h, device=CPU)
    d_dev, _, _ = search_batched(g, torch.from_numpy(queries), k=5, ef=48)
    for qi, q in enumerate(queries):
        _, d_host = h.search(q, k=5, ef=48)
        dd = np.sort(d_dev[qi].numpy())
        dh = np.sort(d_host)
        assert dd[0] <= dh[0] + 1e-3
        assert float(dd.sum()) <= float(dh.sum()) + 1e-2


def test_tombstones_filtered(built_l2):
    h, _ = built_l2
    rng = np.random.default_rng(11)
    queries = torch.from_numpy(rng.standard_normal((4, 32)).astype(np.float32))
    _, before, _ = search_batched(to_device(h, device=CPU), queries, k=5, ef=48)
    before = before.numpy()
    h2 = copy.deepcopy(h)
    n_killed = h2.mark_deleted((before[0] + 100).astype(np.uint64))
    assert n_killed == len(set(before[0].tolist()))
    _, after, _ = search_batched(to_device(h2, device=CPU), queries, k=5, ef=48)
    live = after.numpy()[0]
    live = live[live >= 0]
    assert not set(live.tolist()) & set(before[0].tolist())


def test_cosine_graph():
    rng = np.random.default_rng(12)
    base = rng.standard_normal((800, 24)).astype(np.float32)
    h = HostHnsw(HnswParams(dim=24, m=8, ef_construction=48,
                            metric=Metric.COS), seed=3)
    h.add(base)
    queries = torch.from_numpy(rng.standard_normal((16, 24)).astype(np.float32))
    _, ids, _ = search_batched(to_device(h, device=CPU), queries, k=10, ef=64)
    _, true_ids = exact_search(queries, torch.from_numpy(base), k=10,
                               metric=Metric.COS)
    assert _recall(ids.numpy(), true_ids.numpy()) >= 0.9


def test_hamming_graph():
    rng = np.random.default_rng(13)
    raw = torch.from_numpy(rng.standard_normal((600, 64)).astype(np.float32))
    packed = pack_bits(raw)  # int32 words carrying the uint32 bits
    h = HostHnsw(HnswParams(dim=64, m=8, ef_construction=48,
                            metric=Metric.HAMMING), seed=4)
    h.add(packed.numpy().view(np.uint32))
    qp = pack_bits(torch.from_numpy(
        rng.standard_normal((8, 64)).astype(np.float32)))
    _, ids, _ = search_batched(to_device(h, device=CPU), qp, k=10, ef=64)
    _, true_ids = exact_search(qp, packed, k=10, metric=Metric.HAMMING)
    pk, qn = packed.numpy().view(np.uint32), qp.numpy().view(np.uint32)
    d_found, d_true = [], []
    for qi in range(8):
        dq = np.bitwise_count(np.bitwise_xor(qn[qi][None, :], pk)).sum(1)
        d_found.append(np.sort(dq[ids.numpy()[qi]]))
        d_true.append(np.sort(dq[true_ids.numpy()[qi]]))
    # ties are the rule at 64 bits: compare the distance profiles
    assert (np.array(d_found) <= np.array(d_true) + 2).mean() >= 0.9


def test_single_node_and_tiny_graphs():
    p = HnswParams(dim=4, m=4, ef_construction=16)
    h = HostHnsw(p, seed=5)
    eye = np.eye(4, dtype=np.float32)
    h.add(eye[:1])
    _, ids, _ = search_batched(to_device(h, device=CPU),
                               torch.from_numpy(eye[:2]), k=3, ef=8)
    ids = ids.numpy()
    assert ids[0, 0] == 0 and (ids[:, 1:] == -1).all()
    h.add(eye[1:3])
    _, ids, _ = search_batched(to_device(h, device=CPU),
                               torch.from_numpy(eye[:1]), k=3, ef=8)
    assert ids.numpy()[0, 0] == 0


def test_search_stats(built_l2):
    h, _ = built_l2
    rng = np.random.default_rng(99)
    q = torch.from_numpy(rng.standard_normal((4, 32)).astype(np.float32))
    _, _, _, stats = search_batched(to_device(h, device=CPU), q, k=5, ef=32,
                                    with_stats=True)
    assert int(stats["iterations"]) > 0
    vis, exp = stats["visited"].numpy(), stats["expanded"].numpy()
    assert (vis >= exp).all() and (exp >= 1).all()
    assert (vis <= h.n).all()
