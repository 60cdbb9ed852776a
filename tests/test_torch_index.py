"""Parity: the port's Index facade against lantern_tpu.Index.

Both build the same graph (nthreads=1). Flat search must return the same
labels (distances within 1e-4 abs + 1e-5 rel); graph search, where the
reference runs its own einsum beam, must reach the same recall@10 against
exact ground truth within 0.01. Filters and deletes go through both.
"""

import numpy as np
import pytest

import lantern_tpu
import lantern_tpu_torch
from lantern_tpu_torch.config import HnswParams, Metric, QuantKind

K = 10


def _data(seed=5, n=1500, dim=32, nq=40):
    rng = np.random.default_rng(seed)
    c = rng.standard_normal((24, dim)).astype(np.float32)
    base = c[rng.integers(0, 24, n)] + 0.35 * rng.standard_normal((n, dim))
    q = c[rng.integers(0, 24, nq)] + 0.35 * rng.standard_normal((nq, dim))
    return base.astype(np.float32), q.astype(np.float32)


def _recall(found, truth):
    return np.mean([len(set(f.tolist()) & set(t.tolist())) / K
                    for f, t in zip(found, truth)])


CONFIGS = {
    "l2sq": dict(),
    "cos": dict(metric=Metric.COS),
    "bf16": dict(quant=QuantKind.F16),
}


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def pair(request):
    base, q = _data()
    labels = np.arange(len(base), dtype=np.uint64) * np.uint64(7) + np.uint64(11)
    p = HnswParams(dim=32, m=8, ef_construction=48, **CONFIGS[request.param])
    ref = lantern_tpu.Index(p, capacity=256, seed=0)
    port = lantern_tpu_torch.Index(p, capacity=256, seed=0, device="cpu")
    for ix in (ref, port):
        ix.add(base, labels=labels, nthreads=1)
        ix.delete(labels[::9])
    return request.param, ref, port, base, q, labels


def _truth(port, q, **kw):
    d, lab = port.search(q, k=K, mode="flat", **kw)
    return lab


def test_flat_matches_reference(pair):
    _, ref, port, _, q, labels = pair
    for kw in ({}, {"allow_labels": labels[:700]},
               {"deny_labels": labels[100:900]}):
        wd, wl = ref.search(q, k=K, mode="flat", **kw)
        d, lab = port.search(q, k=K, mode="flat", **kw)
        assert lab.dtype == np.uint64
        np.testing.assert_array_equal(lab, wl)
        np.testing.assert_allclose(d, wd, rtol=1e-5, atol=1e-4)
    deleted = set(labels[::9].tolist())
    assert not deleted & set(lab.ravel().tolist())


def test_graph_recall_matches_reference(pair):
    name, ref, port, _, q, labels = pair
    for kw in ({}, {"allow_labels": labels[:700]},
               {"deny_labels": labels[100:900]}):
        truth = _truth(port, q, **kw)
        _, wl = ref.search(q, k=K, mode="graph", **kw)
        _, lab, stats = port.search(q, k=K, mode="graph", with_stats=True, **kw)
        assert stats["mode"] == "graph" and stats["ef"] == 64
        assert stats["visited"].shape == (len(q),)
        assert abs(_recall(lab, truth) - _recall(wl, truth)) <= 0.01 + 1e-9, name
        assert _recall(lab, truth) >= 0.9
        if "allow_labels" in kw:
            assert set(lab.ravel().tolist()) <= set(kw["allow_labels"].tolist()) | {0}


def test_auto_picks_flat_and_matches(pair):
    _, ref, port, _, q, _ = pair
    d, lab, stats = port.search(q, k=K, with_stats=True)
    assert stats["mode"] == "flat"
    np.testing.assert_array_equal(lab, ref.search(q, k=K, mode="flat")[1])


def test_rows_for_labels_and_size(pair):
    _, ref, port, _, _, labels = pair
    probe = np.concatenate([labels[[3, 0, 99]], np.array([1, 2**63], np.uint64)])
    np.testing.assert_array_equal(port.rows_for_labels(probe),
                                  ref.rows_for_labels(probe))
    assert port.size == ref.size == len(labels)


def test_unported_parts_raise():
    with pytest.raises(NotImplementedError, match="PQ"):
        lantern_tpu_torch.Index(HnswParams(dim=8, pq=True, num_subvectors=2),
                                device="cpu")
    with pytest.raises(NotImplementedError, match="hamming"):
        lantern_tpu_torch.Index(
            HnswParams(dim=64, metric=Metric.HAMMING, quant=QuantKind.B1),
            device="cpu")
    ix = lantern_tpu_torch.Index(HnswParams(dim=8), device="cpu")
    with pytest.raises(NotImplementedError, match="device-builder"):
        ix.add(np.ones((4, 8), np.float32), build="device")
    for name in ("save", "compact", "search_streaming", "train_pq"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            getattr(ix, name)()
