"""Parity: the port's Index facade against lantern_tpu.Index.

Both build the same graph (nthreads=1). Flat search must return the same
labels (distances within 1e-4 abs + 1e-5 rel); graph search, where the
reference runs its own einsum beam, must reach the same recall@10 against
exact ground truth within 0.01. Filters and deletes go through both.

PQ indexes (plain l2sq, cos, OPQ) are given the reference's codebook, so
both build the same graph over the same decoded rows: every mode (flat,
graph, rerank=L, rerank="auto") returns the same labels (up to the order
of exactly tied distances; distances within 1e-4 abs + 1e-4 rel), and
calibrate_rerank picks the same depth from the same coverages.

i8 indexes (quant=I8) and b1 hamming indexes (metric=HAMMING, quant=B1, fed
float rows that both binarise, or packed uint32 words) go through both
facades. i8 flat labels are equal, distances within 1e-4 abs + 1e-5 rel;
hamming distances are exact integers and equal, and labels equal up to the
order of tied distances (ties are the rule at small widths). Graph recall@10
(tie-aware for hamming: a label counts if its distance is within the k-th
true distance) matches the reference's within 0.01.
"""

import numpy as np
import pytest
import torch

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


def test_unported_parts_raise(tmp_path):
    """No part of the reference facade is left unported: the port's Index
    has every public method and property of lantern_tpu.Index, none of
    them a stub raising NotImplementedError, and save, compact and
    search_streaming run on an empty (or, for the search, a one-row)
    index."""
    public = {n for n in dir(lantern_tpu.Index) if not n.startswith("_")}
    assert public <= set(dir(lantern_tpu_torch.Index)), sorted(
        public - set(dir(lantern_tpu_torch.Index)))
    ix = lantern_tpu_torch.Index(HnswParams(dim=8), device="cpu")
    ix.save(str(tmp_path / "empty.ldb"))
    assert lantern_tpu_torch.Index.load(str(tmp_path / "empty.ldb"),
                                        device="cpu").size == 0
    assert ix.compact().size == 0 and ix.num_deleted == 0
    ix.add(np.ones((1, 8), np.float32), labels=np.array([7], np.uint64))
    assert list(ix.search_streaming(np.ones(8, np.float32))) == [(0.0, 7)]


PQ_CONFIGS = {
    "pq": dict(),
    "pq_cos": dict(metric=Metric.COS),
    "opq": dict(rotate=True),
}


def _same_labels(lab, want, d):
    """Labels equal, except that exactly tied distances may swap."""
    tied = np.zeros(d.shape, bool)
    tied[:, 1:] |= d[:, 1:] == d[:, :-1]
    tied[:, :-1] |= d[:, :-1] == d[:, 1:]
    assert ((lab == want) | tied).all(), (lab, want)
    np.testing.assert_array_equal(np.sort(lab, 1), np.sort(want, 1))


@pytest.fixture(scope="module", params=sorted(PQ_CONFIGS))
def pq_pair(request):
    from lantern_tpu_torch.quant.pq import PQCodebook

    cfg = dict(PQ_CONFIGS[request.param])
    rotate = cfg.pop("rotate", False)
    rng = np.random.default_rng(9)
    base = rng.standard_normal((1200, 32)).astype(np.float32)
    q = rng.standard_normal((30, 32)).astype(np.float32)
    labels = np.arange(len(base), dtype=np.uint64) * np.uint64(5) + np.uint64(3)
    p = HnswParams(dim=32, m=8, ef_construction=48, pq=True, num_subvectors=8,
                   num_centroids=32, **cfg)
    ref = lantern_tpu.Index(p, capacity=256, seed=0)
    cb = ref.train_pq(base, iters=8, rotate=rotate, opq_iters=3)
    port = lantern_tpu_torch.Index(p, capacity=256, seed=0, device="cpu")
    port._codebook = PQCodebook(np.array(cb.centroids),
                                None if cb.rotation is None
                                else np.array(cb.rotation))
    for ix in (ref, port):
        ix.add(base, labels=labels, nthreads=1)
        ix.delete(labels[::11])
    return request.param, ref, port, q, labels


@pytest.mark.parametrize("kw", [dict(mode="flat"), dict(mode="graph"),
                                dict(rerank=60), dict(rerank="auto")],
                         ids=["flat", "graph", "rerank60", "rerank_auto"])
def test_pq_search_matches_reference(pq_pair, kw):
    _, ref, port, q, labels = pq_pair
    wd, wl = ref.search(q, k=K, **kw)
    d, lab, stats = port.search(q, k=K, with_stats=True, **kw)
    assert lab.dtype == np.uint64
    _same_labels(lab, wl, d)
    np.testing.assert_allclose(d, wd, rtol=1e-4, atol=1e-4)
    assert not set(labels[::11].tolist()) & set(lab.ravel().tolist())
    if "rerank" in kw:
        assert stats["mode"] == "flat_pq_rerank"
        assert stats["shortlist"] == (60 if kw["rerank"] == 60
                                      else port._rerank_auto[0])


def test_pq_calibration_matches_reference(pq_pair):
    _, ref, port, _, _ = pq_pair
    want = ref.calibrate_rerank(k=K, sample=64, ladder=(20, 40, 80, 160))
    got = port.calibrate_rerank(k=K, sample=64, ladder=(20, 40, 80, 160))
    assert got == want


def test_pq_auto_picks_flat_and_filters(pq_pair):
    _, ref, port, q, labels = pq_pair
    _, lab, stats = port.search(q, k=K, with_stats=True,
                                allow_labels=labels[:500])
    assert stats["mode"] == "flat"
    _, wl = ref.search(q, k=K, mode="flat", allow_labels=labels[:500])
    np.testing.assert_array_equal(np.sort(lab, 1), np.sort(wl, 1))
    assert set(lab.ravel().tolist()) <= set(labels[:500].tolist())


def test_pq_add_trains_on_first_batch_and_keeps_raw_rows():
    rng = np.random.default_rng(4)
    base = rng.standard_normal((300, 16)).astype(np.float32)
    p = HnswParams(dim=16, m=8, ef_construction=32, pq=True,
                   num_centroids=16)  # S = dim / 4 by default
    ix = lantern_tpu_torch.Index(p, capacity=64, device="cpu")
    ix.add(base[:200], nthreads=1)
    assert ix._codebook.centroids.shape == (4, 16, 4)
    ix.add(base[200:], nthreads=1)
    g = ix.device_graph
    assert g.vectors.dtype == torch.uint8 and g.vectors.shape == (300, 4)
    np.testing.assert_array_equal(ix._raw_rows, base)
    d, lab = ix.search(base[:5], k=3, rerank=20)
    np.testing.assert_array_equal(lab[:, 0], np.arange(5, dtype=np.uint64))
    np.testing.assert_allclose(d[:, 0], 0.0, atol=1e-3)  # bf16 self-match
    nokeep = lantern_tpu_torch.Index(p, capacity=64, device="cpu",
                                     keep_raw=False)
    nokeep.train_pq(base[:200])  # the same codebook as the first batch's
    nokeep.add(base, nthreads=1)
    with pytest.raises(ValueError, match="rerank source"):
        nokeep.search(base[:2], rerank=10)
    nokeep.set_rerank_source(base)
    np.testing.assert_array_equal(nokeep.search(base[:2], k=3, rerank=20)[1],
                                  ix.search(base[:2], k=3, rerank=20)[1])
    with pytest.raises(ValueError, match="rows"):
        nokeep.set_rerank_source(base[:10])
    with pytest.raises(ValueError, match="pq=True"):
        lantern_tpu_torch.Index(HnswParams(dim=8), device="cpu").train_pq(
            base[:, :8])


QUANT_CONFIGS = {
    "i8": dict(quant=QuantKind.I8),
    "b1_float": dict(metric=Metric.HAMMING, quant=QuantKind.B1),
    "b1_words": dict(metric=Metric.HAMMING, quant=QuantKind.B1),
}


def _bit_rows(rng, n, words, centres=24):
    """Clustered packed rows: centre XOR (r1 & r2 & r3), p(flip) = 1/8."""
    c = rng.integers(0, 2**32, (centres, words), dtype=np.uint32)
    r = [rng.integers(0, 2**32, (n, words), dtype=np.uint32) for _ in range(3)]
    return c[rng.integers(0, centres, n)] ^ (r[0] & r[1] & r[2])


@pytest.fixture(scope="module", params=sorted(QUANT_CONFIGS))
def quant_pair(request):
    name = request.param
    if name == "b1_words":
        rng = np.random.default_rng(6)
        rows = _bit_rows(rng, 1540, 3)
        base, q = rows[:1500], rows[1500:]
    else:
        base, q = _data()
    labels = np.arange(len(base), dtype=np.uint64) * np.uint64(7) + np.uint64(11)
    p = HnswParams(dim=96 if name == "b1_words" else 32, m=8,
                   ef_construction=48, **QUANT_CONFIGS[name])
    ref = lantern_tpu.Index(p, capacity=256, seed=0)
    port = lantern_tpu_torch.Index(p, capacity=256, seed=0, device="cpu")
    for ix in (ref, port):
        ix.add(base, labels=labels, nthreads=1)
        ix.delete(labels[::9])
    return name, ref, port, base, q, labels


def _words_of(port, x):
    """The index's packed uint32 rows/queries for hamming distances."""
    x = np.asarray(x)
    if x.dtype == np.uint32:
        return x
    from lantern_tpu_torch.quant.scalar import binarize

    return binarize(torch.from_numpy(x)).numpy().view(np.uint32)


def _label_dists(port, base, q, labels, lab):
    """Exact hamming distances of the returned labels (inf for label 0)."""
    table = np.array([bin(i).count("1") for i in range(256)], np.int64)
    words, qw = _words_of(port, base), _words_of(port, q)
    rows = port.rows_for_labels(lab.ravel()).reshape(lab.shape)
    x = np.bitwise_xor(qw[:, None, :], words[np.maximum(rows, 0)])
    d = table[x.view(np.uint8)].sum(-1).astype(np.float32)
    return np.where(rows >= 0, d, np.inf)


def test_quant_flat_matches_reference(quant_pair):
    name, ref, port, base, q, labels = quant_pair
    g = port.device_graph
    if name == "i8":
        assert g.vectors.dtype == torch.int8 and g.vec_scales is not None
    else:
        assert g.vectors.dtype == torch.int32
        assert g.vectors.shape[1] == -(-port.params.dim // 32)
    for kw in ({}, {"deny_labels": labels[100:900]}):
        wd, wl = ref.search(q, k=K, mode="flat", **kw)
        d, lab = port.search(q, k=K, mode="flat", **kw)
        assert lab.dtype == np.uint64
        if name == "i8":
            np.testing.assert_array_equal(lab, wl)
            np.testing.assert_allclose(d, wd, rtol=1e-5, atol=1e-4)
            continue
        np.testing.assert_array_equal(d, wd)  # exact integers
        np.testing.assert_array_equal(_label_dists(port, base, q, labels, lab), d)
        for row, wrow, drow in zip(lab, wl, d):
            inner = drow < drow[-1]
            assert set(row[inner].tolist()) == set(wrow[inner].tolist())
    assert not set(labels[::9].tolist()) & set(lab.ravel().tolist())


def test_quant_graph_recall_matches_reference(quant_pair):
    name, ref, port, base, q, labels = quant_pair
    d_true, truth = port.search(q, k=K, mode="flat")
    _, wl = ref.search(q, k=K, mode="graph")
    d, lab, stats = port.search(q, k=K, mode="graph", with_stats=True)
    assert stats["mode"] == "graph"
    if name == "i8":
        got, want = _recall(lab, truth), _recall(wl, truth)
    else:  # tie-aware: a label within the k-th true distance counts
        kth = d_true[:, -1:]
        got = np.mean(_label_dists(port, base, q, labels, lab) <= kth)
        want = np.mean(_label_dists(port, base, q, labels, wl) <= kth)
        np.testing.assert_array_equal(
            _label_dists(port, base, q, labels, lab), d)
    assert abs(got - want) <= 0.01 + 1e-9, name
    assert got >= 0.9


def test_costmodel_counts_stored_bytes(quant_pair):
    """auto dispatch prices the table as stored: int32 words (4 bytes each,
    ceil(dim/32) a row) for b1, one byte a component for i8."""
    from lantern_tpu_torch.costmodel import choose_search_strategy

    name, _, port, _, _, _ = quant_pair
    g = port.device_graph
    row = port.params.dim if name == "i8" else 4 * -(-port.params.dim // 32)
    table = port.size * row
    width, itemsize = g.vectors.shape[1], g.vectors.element_size()
    assert width * itemsize == row
    assert choose_search_strategy(port.size, width, itemsize, table) == "flat"
    assert choose_search_strategy(port.size, width, itemsize, table - 1) == "graph"


def test_b1_takes_words_and_floats_alike():
    """Float rows and queries are binarised by sign: the same index and
    results as their packed words; auto mode picks the flat scan."""
    base, q = _data(dim=70)  # 3 words, the last one partial
    p = HnswParams(dim=70, m=8, ef_construction=48, metric=Metric.HAMMING,
                   quant=QuantKind.B1)
    floats = lantern_tpu_torch.Index(p, capacity=256, device="cpu")
    packed = lantern_tpu_torch.Index(p, capacity=256, device="cpu")
    floats.add(base, nthreads=1)
    packed.add(_words_of(floats, base), nthreads=1)
    words = _words_of(floats, q)
    for mode in ("flat", "graph"):
        d, lab = floats.search(q, k=K, mode=mode)
        d2, lab2 = packed.search(words, k=K, mode=mode)
        np.testing.assert_array_equal(lab, lab2)
        np.testing.assert_array_equal(d, d2)
    _, _, stats = floats.search(words, k=K, with_stats=True)
    assert stats["mode"] == "flat"
