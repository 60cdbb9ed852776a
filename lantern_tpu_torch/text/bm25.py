"""BM25 full-text scoring (own copy of lantern_tpu/text/bm25.py; numpy only)
— parity with lantern_extras bm25 (X4).

Reference: an inverted index as a plain table
``<t>_bm25(term, term_freq, doc_ids[], fqs[], doc_lens[], doc_ids_bloom)``
built by create_bm25_table (bm25_api.sql:1-59), scored by the bm25_agg
aggregate / search_bm25; popular terms (doc count > approximation threshold,
default 8000) are approximated: fq≈1, doc_len≈avgdl, membership via the
bloom filter (bm25_agg.rs:103-119, lib.rs:141-150). Defaults k1=1.2, b=0.75.

Same structure here: Bm25Index holds per-term postings (doc ids, term
frequencies) + per-doc lengths + blooms for popular terms; scoring is
vectorized numpy over postings.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from lantern_tpu_torch.text.bloom import Bloom
from lantern_tpu_torch.text.stemmer import DEFAULT_STOPWORDS, text_to_stem_array

DEFAULT_K1 = 1.2          # lantern_extras.bm25_default_k1
DEFAULT_B = 0.75          # lantern_extras.bm25_default_b
DEFAULT_APPROX_THRESHOLD = 8000  # bm25_default_approximation_threshhold


@dataclasses.dataclass
class _Posting:
    doc_ids: np.ndarray   # [n] uint64 sorted (labels are arbitrary u64 keys)
    fqs: np.ndarray       # [n] int32
    bloom: Bloom | None   # set for popular terms


class Bm25Index:
    """Inverted index + BM25 scoring over tokenized documents."""

    def __init__(self, k1: float = DEFAULT_K1, b: float = DEFAULT_B,
                 approximation_threshold: int = DEFAULT_APPROX_THRESHOLD,
                 stopwords=DEFAULT_STOPWORDS, stem: bool = True):
        self.k1 = k1
        self.b = b
        self.approx_threshold = approximation_threshold
        self.stopwords = stopwords
        self.stem = stem
        self.postings: dict[str, _Posting] = {}
        self.doc_lens: dict[int, int] = {}
        self.num_docs = 0
        self.avgdl = 0.0
        self._dl_cache = None  # (sorted doc ids u64, lengths f32)

    def _tokens(self, text: str) -> list[str]:
        if self.stem:
            return text_to_stem_array(text, self.stopwords)
        import re

        return [t for t in re.findall(r"[a-z0-9']+", text.lower())
                if t not in (self.stopwords or ())]

    # ---- build (create_bm25_table analog) ----
    def add_documents(self, docs: dict[int, str] | list[str]):
        if isinstance(docs, list):
            docs = {i: d for i, d in enumerate(docs)}
        term_docs: dict[str, dict[int, int]] = {}
        for doc_id, text in docs.items():
            toks = self._tokens(text)
            self.doc_lens[doc_id] = self.doc_lens.get(doc_id, 0) + len(toks)
            for t in toks:
                term_docs.setdefault(t, {}).setdefault(doc_id, 0)
                term_docs[t][doc_id] += 1
        for term, dmap in term_docs.items():
            # uint64: doc ids share the vector index's label space (u64
            # keys, e.g. hashes >= 2**63 — int64 would overflow)
            new_ids = np.fromiter(dmap.keys(), np.uint64, len(dmap))
            new_fqs = np.fromiter(dmap.values(), np.int64, len(dmap))
            old = self.postings.get(term)
            if old is not None:
                # vectorized merge — a per-element python loop over a large
                # existing posting makes repeated batches quadratic
                new_ids = np.concatenate([old.doc_ids.astype(np.uint64), new_ids])
                new_fqs = np.concatenate([old.fqs.astype(np.int64), new_fqs])
            uniq, inv = np.unique(new_ids, return_inverse=True)
            agg = np.zeros(len(uniq), np.int64)
            np.add.at(agg, inv, new_fqs)
            ids = uniq
            fqs = agg.astype(np.int32)
            bloom = None
            if len(ids) > self.approx_threshold:
                bloom = Bloom.from_array(ids.astype(np.uint64))
            self.postings[term] = _Posting(ids, fqs, bloom)
        self.num_docs = len(self.doc_lens)
        self.avgdl = (
            float(np.mean(list(self.doc_lens.values()))) if self.doc_lens else 0.0
        )
        self._dl_cache = None  # doc lengths changed
        return self

    def _doc_len_arrays(self):
        """Sorted (doc_ids u64, lengths f32) for vectorized dl lookups —
        rebuilt once per add_documents, not per query term (a per-element
        dict loop over each posting costs tens of ms/query at scale; the
        reference stores doc_lens[] right in the term row)."""
        if self._dl_cache is None:
            ids = np.fromiter(self.doc_lens.keys(), np.uint64,
                              len(self.doc_lens))
            vals = np.fromiter(self.doc_lens.values(), np.float32,
                               len(self.doc_lens))
            order = np.argsort(ids)
            self._dl_cache = (ids[order], vals[order])
        return self._dl_cache

    # ---- scoring ----
    def _idf(self, df: int) -> float:
        return float(np.log(1.0 + (self.num_docs - df + 0.5) / (df + 0.5)))

    def score(self, query: str, doc_ids: np.ndarray | None = None) -> dict[int, float]:
        """BM25 scores for docs matching the query terms (bm25_agg analog).

        Popular terms (posting > approx_threshold) are approximated
        UNCONDITIONALLY like the reference (bm25_agg.rs:103-119): fq ~= 1,
        doc_len ~= avgdl — with a candidate ``doc_ids`` set, membership
        goes through the bloom filter; without one, every posting member
        gets the constant contribution. Accumulation is vectorized (one
        np.unique aggregate at the end), not a per-element dict loop.
        """
        terms = self._tokens(query)
        dl_ids, dl_vals = self._doc_len_arrays()
        id_chunks: list[np.ndarray] = []
        sc_chunks: list[np.ndarray] = []
        for t in set(terms):
            post = self.postings.get(t)
            if post is None:
                continue
            df = len(post.doc_ids)
            idf = self._idf(df)
            if post.bloom is not None:
                # popular-term approximation: fq=1, dl=avgdl -> norm = k1
                s_const = idf * (self.k1 + 1.0) / (1.0 + self.k1)
                if doc_ids is not None:
                    cand = np.asarray(doc_ids, np.uint64)
                    ids = cand[post.bloom.contains(cand)]
                else:
                    ids = post.doc_ids
                id_chunks.append(np.asarray(ids, np.uint64))
                sc_chunks.append(np.full(len(ids), s_const, np.float64))
                continue
            # vectorized dl lookup via the sorted doc-length arrays
            pos = np.searchsorted(dl_ids, post.doc_ids.astype(np.uint64))
            pos = np.minimum(pos, max(len(dl_ids) - 1, 0))
            dl = np.where(
                dl_ids[pos] == post.doc_ids.astype(np.uint64), dl_vals[pos], 0.0
            ) if len(dl_ids) else np.zeros(len(post.doc_ids), np.float32)
            norm = self.k1 * (1.0 - self.b + self.b * dl / max(self.avgdl, 1e-9))
            s = idf * post.fqs * (self.k1 + 1.0) / (post.fqs + norm)
            id_chunks.append(np.asarray(post.doc_ids, np.uint64))
            sc_chunks.append(np.asarray(s, np.float64))
        if not id_chunks:
            return {}
        ids_cat = np.concatenate(id_chunks)
        sc_cat = np.concatenate(sc_chunks)
        uniq, inv = np.unique(ids_cat, return_inverse=True)
        agg = np.zeros(len(uniq), np.float64)
        np.add.at(agg, inv, sc_cat)
        if doc_ids is not None:
            keep = np.isin(uniq, np.asarray(doc_ids, np.uint64))
            uniq, agg = uniq[keep], agg[keep]
        return {int(u): float(a) for u, a in zip(uniq.tolist(), agg.tolist())}

    def search(self, query: str, k: int = 10) -> list[tuple[int, float]]:
        """Top-k (doc_id, score), descending (search_bm25 analog)."""
        scores = self.score(query)
        return sorted(scores.items(), key=lambda kv: -kv[1])[:k]

    # ---- persistence (the reference's table is just rows; same idea) ----
    def save(self, path: str):
        import os
        import pickle

        # atomic: a crash mid-dump must not destroy the previous good copy
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "wb") as f:
            pickle.dump(self, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)

    @classmethod
    def load(cls, path: str) -> "Bm25Index":
        import pickle

        with open(path, "rb") as f:
            ix = pickle.load(f)
        if not hasattr(ix, "_dl_cache"):  # pickles from before the cache
            ix._dl_cache = None
        return ix


def create_bm25_table(docs, **kw) -> Bm25Index:
    """create_bm25_table SQL fn analog."""
    return Bm25Index(**kw).add_documents(docs)
