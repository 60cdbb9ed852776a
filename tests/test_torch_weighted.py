"""Parity: the port's weighted and hybrid search (weighted.py) against
lantern_tpu's on the CPU, and the weighted cases of tests/test_text.py
through the port.

Both packages build the same indexes (one insert thread); at these sizes
each column's candidate pull is a flat scan, so the candidate sets agree,
and the weighted re-rank is the same numpy arithmetic. Labels are equal
except inside tied weighted distances, distances within 1e-5 relative +
1e-5 absolute (hamming columns: exactly). A hamming column queried with
+-1 floats is packed through the port's int32 words viewed as uint32:
words whose top bit is set are negative as int32 and must count as the
reference's uint32 words do.
"""

import numpy as np
import pytest

import lantern_tpu_torch
from lantern_tpu_torch.config import HnswParams, Metric, QuantKind
from lantern_tpu_torch.weighted import hybrid_search, weighted_search

CPU = "cpu"


def both(params_kw, rows, labels=None, delete=None):
    """(port index, reference index) holding the same rows."""
    from lantern_tpu import config as rconfig
    from lantern_tpu.index import Index as RefIndex

    def ref_params():
        kw = dict(params_kw)
        if "metric" in kw:
            kw["metric"] = rconfig.Metric(int(kw["metric"]))
        if "quant" in kw:
            kw["quant"] = rconfig.QuantKind(int(kw["quant"]))
        return rconfig.HnswParams(**kw)

    port = lantern_tpu_torch.Index(HnswParams(**params_kw),
                                   capacity=len(rows), device=CPU)
    ref = RefIndex(ref_params(), capacity=len(rows))
    for ix in (port, ref):
        ix.add(rows, labels=labels, nthreads=1)
        if delete is not None:
            ix.delete(np.asarray(delete, np.uint64))
    return port, ref


def assert_same(got, want, exact=False):
    (d, lab), (wd, wl) = got, want
    assert lab.dtype == wl.dtype and d.dtype == wd.dtype
    if exact:
        np.testing.assert_array_equal(d, wd)
    else:
        np.testing.assert_allclose(d, wd, rtol=1e-5, atol=1e-5)
    tied = np.zeros(len(d), bool)
    tied[1:] |= np.isclose(d[1:], d[:-1], rtol=1e-6)
    tied[:-1] |= np.isclose(d[:-1], d[1:], rtol=1e-6)
    tied |= np.isclose(d, d[-1], rtol=1e-6) if len(d) else tied
    np.testing.assert_array_equal(lab[~tied], wl[~tied])


def _rows(rng, n, dim, scale=1.0):
    return (scale * rng.standard_normal((n, dim))).astype(np.float32)


@pytest.mark.parametrize("metric", ["L2SQ", "COS"])
def test_weighted_search_equals_the_reference(rng, metric):
    n = 400
    labels = np.arange(n, dtype=np.uint64) * 3 + 7
    a, b = _rows(rng, n, 8), _rows(rng, n, 12)
    m = Metric[metric]
    pa, ra = both(dict(dim=8, m=8, ef_construction=32, metric=m), a, labels)
    pb, rb = both(dict(dim=12, m=8, ef_construction=32, metric=m), b, labels)
    from lantern_tpu.weighted import weighted_search as ref_weighted

    for target in (0, 123, 399):
        for wa, wb in ((0.7, 0.3), (1.0, 2.0), (1.0, 0.0)):
            qa = a[target] + 0.01
            qb = b[target] - 0.01
            got = weighted_search([(pa, wa, qa), (pb, wb, qb)], k=7)
            want = ref_weighted([(ra, wa, qa), (rb, wb, qb)], k=7)
            assert_same(got, want)
        assert got[1][0] == labels[target]


def test_weighted_distances_are_the_exact_weighted_sum(rng):
    """Each returned distance is the weighted sum of the two columns'
    exact l2sq distances, and no candidate of the pools ranks above it."""
    n = 300
    a, b = _rows(rng, n, 16), _rows(rng, n, 16)
    pa, _ = both(dict(dim=16, m=8, ef_construction=32), a)
    pb, _ = both(dict(dim=16, m=8, ef_construction=32), b)
    qa, qb = _rows(rng, 1, 16)[0], _rows(rng, 1, 16)[0]
    d, lab = weighted_search([(pa, 0.7, qa), (pb, 0.3, qb)], k=10, pull_k=n)
    ids = lab.astype(np.int64)
    exact = (0.7 * ((a - qa) ** 2).sum(1) + 0.3 * ((b - qb) ** 2).sum(1))
    np.testing.assert_allclose(d, exact[ids], rtol=1e-5)
    np.testing.assert_array_equal(ids, np.argsort(exact, kind="stable")[:10])


def test_tombstones_are_excluded(rng):
    base = _rows(rng, 200, 8)
    pa, ra = both(dict(dim=8, m=4, ef_construction=16), base)
    pb, rb = both(dict(dim=8, m=4, ef_construction=16), base, delete=[7, 9])
    from lantern_tpu.weighted import weighted_search as ref_weighted

    got = weighted_search([(pa, 1.0, base[7]), (pb, 1.0, base[7])], k=5,
                          ef=32)
    want = ref_weighted([(ra, 1.0, base[7]), (rb, 1.0, base[7])], k=5, ef=32)
    assert 7 not in got[1].tolist() and 9 not in got[1].tolist()
    assert_same(got, want)


def test_hamming_column_with_pm1_float_queries(rng):
    """+-1 floats against a b1 column: the query is sign-packed into int32
    words (top bits set, so negative) and counted as uint32."""
    raw = np.sign(_rows(rng, 150, 96))
    raw[:, 31::32] = 1.0  # the top bit of every word: negative int32 words
    dense = _rows(rng, 150, 8)
    ph, rh = both(dict(dim=96, m=4, ef_construction=16,
                       metric=Metric.HAMMING, quant=QuantKind.B1), raw)
    pd, rd = both(dict(dim=8, m=4, ef_construction=16), dense)
    words = ph._binarized(raw[:1]).numpy()
    assert (words < 0).all()
    from lantern_tpu.weighted import weighted_search as ref_weighted

    for t in (3, 77):
        q = raw[t].copy()
        q[:5] *= -1  # five bits off the stored row
        got = weighted_search([(ph, 1.0, q)], k=5, ef=32)
        want = ref_weighted([(rh, 1.0, q)], k=5, ef=32)
        assert_same(got, want, exact=True)
        assert got[1][0] == t and got[0][0] == 5.0
        got = weighted_search([(ph, 0.5, q), (pd, 2.0, dense[t])], k=5)
        want = ref_weighted([(rh, 0.5, q), (rd, 2.0, dense[t])], k=5)
        assert_same(got, want)
    # packed uint32 queries are taken as they are
    packed = words.view(np.uint32)[0]
    got = weighted_search([(ph, 1.0, packed)], k=3, ef=32)
    assert got[1][0] == 0 and got[0][0] == 0.0


def test_empty_and_errors(rng):
    base = _rows(rng, 20, 8)
    pa, _ = both(dict(dim=8, m=4, ef_construction=16), base)
    with pytest.raises(ValueError):
        weighted_search([])
    d, lab = weighted_search([(pa, 0.0, base[0])], k=3)
    assert d.dtype == np.float32 and lab.dtype == np.uint64 and len(d) == 0


def test_hybrid_search_equals_the_reference(rng):
    from lantern_tpu.text.bm25 import Bm25Index
    from lantern_tpu.weighted import hybrid_search as ref_hybrid

    docs = {
        0: "the quick brown fox jumps over the lazy dog",
        1: "cuda kernels with tensor cores are fast",
        2: "postgres index access methods and vacuum",
        3: "fox hunting with hounds in the countryside",
        4: "tensor cores love large batched matmuls",
    }
    base = _rows(rng, 5, 16, scale=5.0)
    base[4] = base[1] + 0.01
    labels = np.arange(5, dtype=np.uint64)
    pix, rix = both(dict(dim=16, m=4, ef_construction=16), base, labels)
    bm = Bm25Index()
    bm.add_documents(docs)
    for q, text, k in ((base[1], "tensor kernels", 3), (base[2], "fox", 5)):
        got = hybrid_search(pix, bm, q, text, k=k)
        want = ref_hybrid(rix, bm, q, text, k=k)
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_allclose(got[0], want[0], rtol=1e-6)
    s, lab = hybrid_search(pix, bm, base[1], "tensor kernels", k=3)
    assert set(lab[:2].tolist()) == {1, 4} and s[0] >= s[1] >= s[-1]
