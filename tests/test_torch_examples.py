"""The port's examples (``lantern_tpu_torch/examples/``) against the same
steps run through ``lantern_tpu``, on the CPU, at ``N_SMALL`` rows (the
size ``tests/test_examples.py`` runs the reference scripts at).

- quickstart: top-1 labels equal; labels equal up to ties, distances
  within DIST_RTOL relative + DIST_ATOL absolute (both packages scan flat,
  exactly, at this size); the same after the snapshot round trip and after
  the deletes.
- filters_and_maintenance: deny and allow results equal, the hybrid search
  puts label 3 on top in both, sizes and tombstone counts after compact
  and reindex equal, ``validate`` clean (inside ``main``).
- pq_rerank: reranked recall >= ADC recall in both, and the port's
  reranked recall within RECALL_TOL of the reference's. The codebooks
  differ: the port draws its k-means init from a seeded torch generator,
  the reference from ``jax.random``, so ADC codes (and ADC recall) are not
  comparable row for row, and only the reranked recall is held.
- sharded_mesh: recall@10 > 0.8 in both and within RECALL_TOL (the port's
  device builder and the reference's draw levels from different
  generators); with ``ranks=2`` and ``4``, gloo ranks return the
  one-process results bit for bit.

Each example also runs as ``python -m ... --device cpu --n N_SMALL`` (the
counterpart of ``tests/test_examples.py``), imports neither jax nor
lantern_tpu while it runs, and, with no card and no device named, raises.
"""

import json
import os
import subprocess
import sys
import tempfile

import numpy as np
import pytest
import torch

from lantern_tpu_torch.examples import (
    filters_and_maintenance,
    pq_rerank,
    quickstart,
    sharded_mesh,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = {"quickstart": quickstart, "pq_rerank": pq_rerank,
            "filters_and_maintenance": filters_and_maintenance,
            "sharded_mesh": sharded_mesh}
N_SMALL = 1200
CPU = "cpu"
DIST_RTOL, DIST_ATOL = 1e-5, 1e-4
RECALL_TOL = 0.05
PROC_TIMEOUT_S = 120


@pytest.fixture()
def few_threads(monkeypatch):
    """Small runs: one torch thread here and in the processes started."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def assert_equal_up_to_ties(got_l, got_d, want_l, want_d):
    got_l, want_l = np.asarray(got_l), np.asarray(want_l)
    got_d, want_d = np.asarray(got_d), np.asarray(want_d)
    np.testing.assert_allclose(got_d, want_d, rtol=DIST_RTOL, atol=DIST_ATOL)
    for q in range(len(want_l)):
        for i in range(want_l.shape[1]):
            tied = np.isclose(want_d[q], want_d[q, i], rtol=DIST_RTOL,
                              atol=DIST_ATOL).sum() > 1
            if not tied:
                assert got_l[q, i] == want_l[q, i], (q, i)


def ref_quickstart(n):
    from lantern_tpu import HnswParams, Index

    rng = np.random.default_rng(0)
    vectors = rng.standard_normal((n, 64)).astype(np.float32)
    queries = vectors[:5] + 0.01 * rng.standard_normal((5, 64)).astype(np.float32)
    ix = Index(HnswParams(dim=64, m=16, ef_construction=128), capacity=n)
    ix.add(vectors)
    d, labels = ix.search(queries, k=10)
    with tempfile.TemporaryDirectory() as td:
        ix.save(os.path.join(td, "index.ldb"))
        d2, l2 = Index.load(os.path.join(td, "index.ldb")).search(queries, k=10)
    ix.delete(np.arange(5))
    d3, l3 = ix.search(queries, k=10)
    return dict(d=d, l=labels, d2=d2, l2=l2, d3=d3, l3=l3)


def check_quickstart(got, n):
    want = ref_quickstart(n)
    assert got["top1"] == want["l"][:, 0].tolist() == list(range(5))
    assert_equal_up_to_ties(got["labels"], got["dists"], want["l"], want["d"])
    assert_equal_up_to_ties(got["labels_after_load"],
                            got["dists_after_load"], want["l2"], want["d2"])
    assert_equal_up_to_ties(got["labels_after_delete"],
                            got["dists_after_delete"], want["l3"], want["d3"])
    assert not np.isin(got["labels_after_delete"], np.arange(5)).any()
    assert got["size"] == n and got["mode"] == "flat"


def ref_filters(n):
    import dataclasses

    from lantern_tpu import HnswParams, Index
    from lantern_tpu.text.bm25 import Bm25Index
    from lantern_tpu.weighted import hybrid_search

    rng = np.random.default_rng(7)
    vectors = rng.standard_normal((n, 32)).astype(np.float32)
    ix = Index(HnswParams(dim=32, m=8, ef_construction=64), capacity=n)
    ix.add(vectors)
    q = vectors[42]
    _, deny = ix.search(q, k=5, deny_labels=np.array([42], np.uint64))
    _, allow = ix.search(q, k=5,
                         allow_labels=np.arange(1000, 1100, dtype=np.uint64))
    docs = {i: f"document {i} about topic {i % 7}" for i in range(50)}
    docs[3] = "tpu pallas kernels and systolic arrays"
    bm = Bm25Index()
    bm.add_documents(docs)
    small = Index(HnswParams(dim=32, m=8, ef_construction=32), capacity=64)
    small.add(vectors[:50], labels=np.arange(50, dtype=np.uint64))
    _, hybrid = hybrid_search(small, bm, vectors[3], "pallas kernels", k=3)
    ix.delete(np.arange(0, n // 2, dtype=np.uint64))
    tombstoned = ix.num_deleted
    ix.compact()
    ix.validate().raise_if_failed()
    compacted = {"size": ix.size, "num_deleted": ix.num_deleted}
    ix.reindex(dataclasses.replace(ix.params, m=12, ef_construction=96))
    return dict(deny=deny[0].tolist(), allow=allow[0].tolist(),
                hybrid=hybrid.tolist(), tombstoned=tombstoned,
                compacted=compacted,
                reindexed={"size": ix.size, "num_deleted": ix.num_deleted,
                           "m": ix.params.m,
                           "ef_construction": ix.params.ef_construction})


def check_filters(got, n):
    want = ref_filters(n)
    assert got["deny_labels"] == want["deny"] and 42 not in want["deny"]
    assert got["allow_labels"] == want["allow"]
    assert got["hybrid_labels"][0] == want["hybrid"][0] == 3
    assert got["tombstoned"] == want["tombstoned"] == n // 2
    assert got["after_compact"] == want["compacted"]
    assert got["after_reindex"] == want["reindexed"]
    assert got["plan"]["mode"] == "flat"


def ref_pq_rerank(n):
    from lantern_tpu import HnswParams, Index
    from lantern_tpu.ops import exact_search

    rng = np.random.default_rng(0)
    vectors = rng.standard_normal((n, 96)).astype(np.float32)
    queries = rng.standard_normal((8, 96)).astype(np.float32)
    ix = Index(HnswParams(dim=96, m=16, ef_construction=64, pq=True,
                          num_subvectors=24, num_centroids=64), capacity=n)
    ix.add(vectors)
    _, true_ids = exact_search(queries, vectors, k=10)
    true_ids = np.asarray(true_ids)
    _, raw = ix.search(queries, k=10, mode="flat")
    _, rr = ix.search(queries, k=10, rerank=100)
    return (pq_rerank.recall(np.asarray(raw), true_ids),
            pq_rerank.recall(np.asarray(rr), true_ids))


def check_pq_rerank(got, n):
    adc, reranked = ref_pq_rerank(n)
    assert reranked >= adc
    assert got["rerank_recall"] >= got["adc_recall"]
    assert abs(got["rerank_recall"] - reranked) <= RECALL_TOL, (got, reranked)
    assert got["size"] == n


def ref_sharded(n):
    import jax.numpy as jnp

    from lantern_tpu import HnswParams
    from lantern_tpu.ops import exact_search
    from lantern_tpu.parallel import (
        build_sharded_device,
        make_mesh,
        search_sharded,
    )

    vectors, queries = sharded_mesh.data(n)
    mesh = make_mesh(n_shards=8)
    ix = build_sharded_device(vectors, HnswParams(dim=32, m=8,
                                                  ef_construction=48), mesh)
    _, gids, _ = search_sharded(ix, jnp.asarray(queries), k=10, ef=48)
    _, true_ids = exact_search(jnp.asarray(queries), jnp.asarray(vectors), k=10)
    return float(np.mean([
        len(set(a[a >= 0].tolist()) & set(b.tolist())) / 10
        for a, b in zip(np.asarray(gids), np.asarray(true_ids))]))


def check_sharded(got, n):
    want = ref_sharded(n)
    assert got["recall"] > 0.8 and want > 0.8
    assert abs(got["recall"] - want) <= RECALL_TOL, (got["recall"], want)
    assert got["shards"] == 8


CHECKS = {"quickstart": check_quickstart, "pq_rerank": check_pq_rerank,
          "filters_and_maintenance": check_filters,
          "sharded_mesh": check_sharded}


@pytest.mark.parametrize("name", list(EXAMPLES))
def test_example_matches_the_reference(name, few_threads):
    got = EXAMPLES[name].main(device=CPU, n=N_SMALL)
    assert got["example"] == name and got["device"] == CPU
    assert got["n"] == N_SMALL
    # the wrappers count CUDA launches only
    assert set(got["launches"].values()) == {0}
    json.dumps(got)  # what __main__ prints
    CHECKS[name](got, N_SMALL)


@pytest.mark.parametrize("ranks", [2, 4])
def test_sharded_mesh_ranks_equal_one_process(ranks, few_threads):
    got = sharded_mesh.main(device=CPU, n=N_SMALL, ranks=ranks)
    assert got["ranks"]["world"] == ranks
    assert got["ranks"]["shards_per_rank"] == 8 // ranks
    assert got["ranks"]["ids_equal"] is True
    assert got["recall"] > 0.8


def run_module(name, *args, env=None):
    return subprocess.run(
        [sys.executable, "-m", f"lantern_tpu_torch.examples.{name}", *args],
        cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=PROC_TIMEOUT_S)


@pytest.mark.parametrize("name", list(EXAMPLES))
def test_example_runs_as_a_module(name, few_threads):
    out = run_module(name, "--device", CPU, "--n", str(N_SMALL))
    assert out.returncode == 0, f"{name}:\n{out.stdout}\n{out.stderr}"
    last = json.loads(out.stdout.strip().splitlines()[-1])
    assert last["example"] == name and last["n"] == N_SMALL


def test_examples_import_neither_jax_nor_reference(few_threads):
    probe = (
        "import sys\n"
        "from lantern_tpu_torch.examples import (filters_and_maintenance, "
        "pq_rerank, quickstart, sharded_mesh)\n"
        "for m in (quickstart, pq_rerank, filters_and_maintenance, "
        "sharded_mesh):\n"
        f"    m.main(device='cpu', n={N_SMALL})\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'lantern_tpu', 'ml_dtypes'))\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    out = subprocess.run([sys.executable, "-c", probe], cwd=ROOT,
                         capture_output=True, text=True,
                         timeout=PROC_TIMEOUT_S)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("clean")


@pytest.mark.parametrize("name", list(EXAMPLES))
def test_example_without_a_card_raises(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        EXAMPLES[name].main(n=N_SMALL)
