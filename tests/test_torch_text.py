"""Parity: the port's text/ and utils/bench copies against the reference's.

On tests/test_text.py's inputs the port gives the same Porter stems, the
same stopword-filtered stem arrays, the same bloom filter bits (and
serialised bytes, loadable by the other package), and the same BM25
scores and rankings, on the exact path and the popular-term approximation,
with u64 labels and a save/load round trip. The bench timers count and sum
as the reference's.
"""

import numpy as np
import pytest

from lantern_tpu_torch.text import (
    DEFAULT_STOPWORDS,
    Bloom,
    Bm25Index,
    create_bm25_table,
    porter_stem,
    text_to_stem_array,
)
from lantern_tpu_torch.utils import bench

WORDS = ["caresses", "ponies", "ties", "caress", "cats", "feed", "agreed",
         "plastered", "motoring", "sing", "conflated", "troubled", "sized",
         "hopping", "happy", "relational", "conditional", "vietnamization",
         "predication", "triplicate", "formative", "formalize", "electriciti",
         "revival", "allowance", "adjustable", "effective", "probate",
         "controll", "roll", "generously", "hopefulness", "y", "sky", "a"]
SENTENCES = ["The quick brown foxes are running over the lazy dogs",
             "vector search with hnsw graphs on tpu hardware",
             "It's what they'd've wanted: cats' pajamas, 42 times!"]
DOCS = {
    1: "the cat sat on the mat",
    2: "dogs chase cats in the park",
    3: "tpu accelerators run matrix multiplications fast",
    4: "vector search with hnsw graphs on tpu hardware",
    5: "the mat was sat on by a very large cat repeatedly cat cat",
}
QUERIES = ["cat mat", "tpu", "zebra unicorn", "cats sitting on mats",
           "hnsw vector graphs"]


def test_stems_and_stopwords_match_reference():
    from lantern_tpu import text as ref

    assert [porter_stem(w) for w in WORDS] == [ref.porter_stem(w) for w in WORDS]
    for s in SENTENCES:
        assert text_to_stem_array(s) == ref.text_to_stem_array(s)
        assert text_to_stem_array(s, None) == ref.text_to_stem_array(s, None)
    assert DEFAULT_STOPWORDS == ref.DEFAULT_STOPWORDS


@pytest.mark.parametrize("n,fp", [(1000, 0.01), (37, 0.1), (5000, 0.001)])
def test_bloom_bits_match_reference(n, fp):
    from lantern_tpu.text import Bloom as RBloom

    items = np.random.default_rng(n).integers(0, 2**63, n, dtype=np.uint64)
    items[:3] = [0, 2**64 - 1, 2**63 + 5]
    b, rb = Bloom.from_array(items, fp), RBloom.from_array(items, fp)
    assert (b.num_bits, b.num_hashes) == (rb.num_bits, rb.num_hashes)
    np.testing.assert_array_equal(b.bits, rb.bits)
    assert b.to_bytes() == rb.to_bytes()
    probe = np.arange(10_000, 11_000, dtype=np.uint64)
    np.testing.assert_array_equal(b.contains(probe), rb.contains(probe))
    assert b.contains(items).all()
    np.testing.assert_array_equal(Bloom.from_bytes(rb.to_bytes()).bits, rb.bits)
    with pytest.raises(ValueError):
        Bloom.from_bytes(b.to_bytes()[:-4])


def _scores_equal(got: dict, want: dict):
    assert got.keys() == want.keys()
    for key in want:
        assert got[key] == pytest.approx(want[key], rel=1e-12)


@pytest.mark.parametrize("threshold", [8000, 2])
def test_bm25_matches_reference(threshold):
    """Exact postings, and (threshold 2) popular terms approximated through
    their blooms, with and without a candidate set."""
    from lantern_tpu.text import create_bm25_table as ref_create

    ix = create_bm25_table(DOCS, approximation_threshold=threshold)
    rix = ref_create(DOCS, approximation_threshold=threshold)
    for q in QUERIES:
        _scores_equal(ix.score(q), rix.score(q))
        cand = np.array([1, 2, 5, 99], np.int64)
        _scores_equal(ix.score(q, doc_ids=cand), rix.score(q, doc_ids=cand))
        assert [d for d, _ in ix.search(q, k=3)] == [d for d, _ in rix.search(q, k=3)]
    assert {d for d, _ in ix.search("tpu", k=2)} == {3, 4}
    assert ix.search("zebra unicorn", k=2) == []


def test_bm25_incremental_u64_and_save_match_reference(tmp_path):
    from lantern_tpu.text.bm25 import Bm25Index as RBm25

    big = 2**63 + 5
    docs = {i: "filler common words" for i in range(20)}
    docs[3] = "filler common words rare"
    docs[big] = "giant hash label common"
    ix, rix = Bm25Index(approximation_threshold=5), RBm25(approximation_threshold=5)
    for a in (ix, rix):
        a.add_documents(docs)
        a.add_documents({50: "common common common"})
    post, rpost = ix.postings["common"], rix.postings["common"]
    np.testing.assert_array_equal(post.doc_ids, rpost.doc_ids)
    np.testing.assert_array_equal(post.fqs, rpost.fqs)
    np.testing.assert_array_equal(post.bloom.bits, rpost.bloom.bits)
    for q in ("rare common", "giant hash", "words"):
        _scores_equal(ix.score(q), rix.score(q))
    path = str(tmp_path / "bm.pkl")
    ix.save(path)
    back = Bm25Index.load(path)
    assert isinstance(back, Bm25Index)
    _scores_equal(back.score("giant hash"), rix.score("giant hash"))


def test_bench_timers_match_reference(monkeypatch):
    from lantern_tpu.utils import bench as rbench

    for mod in (bench, rbench):
        monkeypatch.setattr(mod, "_enabled", False)
        mod.reset()
        with mod.bench("off"):
            pass
        assert mod.stats() == {}
        mod.enable(True)
        for _ in range(3):
            with mod.bench("loop"):
                pass

        @mod.benched()
        def work(x):
            return x + 1

        assert work(1) == 2
        mod.enable(False)
    got, want = bench.stats(), rbench.stats()
    work_name = "test_bench_timers_match_reference.<locals>.work"
    assert got.keys() == want.keys() == {"loop", work_name}
    assert [v["count"] for v in got.values()] == [v["count"] for v in want.values()]
    bench.reset()
    rbench.reset()
