"""Parity: the port's maintenance (Index.compact, reindex, reindex_concurrent)
and streaming scan (search_streaming) against lantern_tpu's, and
tests/test_concurrent_reindex.py's cases through the port on the CPU.

compact / reindex over the same engine give equal engine arrays: host
rebuilds on one thread (nthreads=1), device rebuilds through each package's
builder (the two are exactly equal on the CPU, tests/test_torch_build_device.py).
PQ rerank rows follow the compacted slot order. The streaming scan over
the same graph yields the reference generator's rows: equal labels,
distances within 1e-5 rel + 1e-4 abs.
"""

import dataclasses
import itertools
import threading

import numpy as np
import pytest
import torch

import lantern_tpu_torch
from lantern_tpu_torch.config import HnswParams, Metric, QuantKind

CPU = "cpu"
DIM = 24
P = HnswParams(dim=DIM, m=8, ef_construction=48, ef=64)
ARRAYS = ("vectors", "neighbors0", "counts0", "upper_slot", "levels",
          "labels", "deleted")



def jax_ref():
    """The JAX package, imported by the CPU parity tests only: the card's
    machine has no jax, and runs this file's cuda-marked tests without it."""
    import lantern_tpu
    import lantern_tpu.storage.snapshot

    return lantern_tpu

def Index(*a, **kw):
    return lantern_tpu_torch.Index(*a, device=CPU, **kw)


def assert_engines_equal(a, b, edges=True):
    """Equal engines; ``edges=False`` leaves out the adjacency (hamming
    device builds: the reverse pass orders tied distances its own way)."""
    n = a.n
    assert (n, a.n_upper, a.entry, a.max_level) == (
        b.n, b.n_upper, b.entry, b.max_level)
    for name in ARRAYS:
        if edges or name not in ("neighbors0", "counts0"):
            np.testing.assert_array_equal(np.asarray(getattr(a, name))[:n],
                                          np.asarray(getattr(b, name))[:n],
                                          name)
    if not edges:
        return
    nu = max(a.n_upper, 1)
    for name in ("upper_neighbors", "upper_counts"):
        np.testing.assert_array_equal(np.asarray(getattr(a, name))[:nu],
                                      np.asarray(getattr(b, name))[:nu], name)


def _clustered(seed, n, dim=16):
    rng = np.random.default_rng(seed)
    c = rng.standard_normal((10, dim)).astype(np.float32)
    return (c[rng.integers(0, 10, n)]
            + 0.4 * rng.standard_normal((n, dim))).astype(np.float32)


COMPACT_CONFIGS = {
    "f32": dict(),
    "b1": dict(metric=Metric.HAMMING, quant=QuantKind.B1),
    "i8": dict(quant=QuantKind.I8),
    "pq": dict(pq=True, num_subvectors=4, num_centroids=64),
}


def _pair(name, n=500, build="host"):
    from lantern_tpu_torch.quant.pq import PQCodebook

    dim = 64 if name == "b1" else 16  # 64 sign bits: fewer hamming ties
    base = _clustered(31, n, dim)
    labels = np.arange(n, dtype=np.uint64) * np.uint64(2) + np.uint64(1)
    p = HnswParams(dim=dim, m=8, ef_construction=32, **COMPACT_CONFIGS[name])
    ref = jax_ref().Index(p, capacity=n, seed=0)
    port = Index(p, capacity=n, seed=0)
    if p.pq:
        cb = ref.train_pq(base, iters=5)
        port._codebook = PQCodebook(np.array(cb.centroids))
    for ix in (ref, port):
        if build == "host":
            ix.add(base, labels=labels, nthreads=1)
        else:
            ix.add(base, labels=labels, build="device", batch=64)
        ix.delete(labels[::3])
    return ref, port, base, labels


@pytest.mark.parametrize("name", sorted(COMPACT_CONFIGS))
def test_compact_host_matches_reference(name):
    ref, port, base, labels = _pair(name)
    for ix in (ref, port):
        ix.compact(nthreads=1)
        assert ix.num_deleted == 0 and ix.size == len(labels) - len(labels[::3])
    assert_engines_equal(port._eng, ref._eng)
    port.validate().raise_if_failed()
    q = base[1:40:3]
    d, lab = port.search(q, k=5, mode="flat")
    wd, wl = ref.search(q, k=5, mode="flat")
    np.testing.assert_allclose(d, wd, rtol=1e-5, atol=1e-4)
    assert not set(labels[::3].tolist()) & set(lab.ravel().tolist())
    if port.params.pq:
        # the rerank rows follow the compacted slot order
        keep = np.ones(len(base), bool)
        keep[::3] = False
        np.testing.assert_array_equal(port._raw_rows, base[keep])
        np.testing.assert_array_equal(port._raw_rows, np.asarray(ref._raw_rows))
        d, lab = port.search(base[1:40:3], k=3, rerank=40)
        assert (lab[:, 0] == labels[1:40:3]).all()


@pytest.mark.parametrize("name", ["f32", "b1"])
def test_compact_device_matches_reference(name):
    """compact(build="device"): each package's builder over the live rows
    gives equal engines (hamming: equal rows, levels and slots; the edges
    may differ where pair distances tie)."""
    ref, port, base, labels = _pair(name, n=400, build="device")
    edges = name != "b1"
    assert_engines_equal(port._eng, ref._eng, edges)
    for ix in (ref, port):
        ix.compact(build="device", batch=64)
        assert ix.num_deleted == 0
    assert_engines_equal(port._eng, ref._eng, edges)
    port.validate().raise_if_failed()
    _, lab = port.search(base[2], k=5, mode="graph", ef=64)
    assert lab[0, 0] == labels[2]


def test_reindex_matches_reference():
    ref, port, base, _ = _pair("f32")
    p2 = dataclasses.replace(port.params, m=12, ef_construction=40)
    port.reindex(p2, nthreads=1)
    ref.reindex(p2, nthreads=1)
    assert port.params.m == 12
    assert_engines_equal(port._eng, ref._eng)
    port.validate().raise_if_failed()
    with pytest.raises(ValueError, match="compact cannot change"):
        port.reindex(dataclasses.replace(port.params, metric=Metric.COS))
    with pytest.raises(ValueError, match="unknown build"):
        port.compact(build="gpu")


def test_compact_python_engine():
    base = _clustered(32, 300)
    ix = Index(HnswParams(dim=16, m=8, ef_construction=32), engine="python")
    ix.add(base)
    ix.delete(np.arange(100, dtype=np.uint64))
    with pytest.raises(ValueError, match="native engine"):
        ix.compact(build="device")
    ix.compact()
    assert (ix.size, ix.num_deleted) == (200, 0)
    assert ix._engine_kind == "python"
    ix.validate().raise_if_failed()
    _, lab = ix.search(base[150], k=3, mode="graph")
    assert lab[0, 0] == 150


# ---- tests/test_concurrent_reindex.py through the port ----

def test_reindex_concurrent_search_loop(rng):
    """No failed query while a compacting reindex runs; the exact scan over
    the live set is unchanged by the swap."""
    base = rng.standard_normal((1500, DIM)).astype(np.float32)
    qs = rng.standard_normal((8, DIM)).astype(np.float32)
    ix = Index(P, capacity=2048, seed=3)
    ix.add(base, nthreads=1)
    ix.delete(np.arange(0, 300, dtype=np.uint64))
    _, l0 = ix.search(qs, k=10, mode="flat")

    stop = threading.Event()
    failures, results = [], []

    def search_loop():
        try:
            while not stop.is_set():
                _, lab = ix.search(qs, k=10, mode="flat")
                assert lab.shape == (8, 10)
                assert (lab >= 300).all()  # tombstones never surface
                results.append(lab)
        except Exception as e:  # reported below
            failures.append(e)

    t = threading.Thread(target=search_loop)
    t.start()
    try:
        h = ix.reindex_concurrent(nthreads=1)
        assert h.join(timeout=600)
        assert h.done
    finally:
        stop.set()
        t.join(timeout=60)
    assert not t.is_alive()
    assert not failures, failures
    assert results  # the loop ran during the rebuild
    assert ix.num_deleted == 0 and ix.size == 1200
    _, l1 = ix.search(qs, k=10, mode="flat")
    np.testing.assert_array_equal(l0, l1)


def test_reindex_concurrent_replays_writes(rng):
    """add() / delete() during the rebuild survive the swap."""
    base = rng.standard_normal((800, DIM)).astype(np.float32)
    extra = rng.standard_normal((40, DIM)).astype(np.float32)
    ix = Index(P, capacity=1024, seed=3)
    ix.add(base, nthreads=1)
    ix.delete(np.arange(100, dtype=np.uint64))

    h = ix.reindex_concurrent()
    ix.add(extra, labels=np.arange(1000, 1040, dtype=np.uint64), nthreads=1)
    ix.delete(np.asarray([1000, 1001, 200], dtype=np.uint64))
    assert h.join(timeout=600)

    # the deletes land before the swap (700 + 38 rows, label 200 a
    # tombstone) or after it (all 40 adds replayed, 3 tombstones)
    assert (ix.size, ix.num_deleted) in {(738, 1), (740, 3)}
    _, lab = ix.search(extra[5], k=1, mode="flat")
    assert lab[0, 0] == 1005
    _, lab = ix.search(extra[:2], k=5, mode="flat")
    assert not {1000, 1001} & set(lab.ravel().tolist())
    rows = ix.rows_for_labels(np.asarray([200], dtype=np.uint64))
    if rows[0] >= 0:
        assert bool(np.asarray(ix._eng.deleted)[rows[0]])
    ix.compact()
    _, lab2 = ix.search(extra[5], k=1, mode="flat")
    assert lab2[0, 0] == 1005


def test_reindex_concurrent_reparametrize(rng):
    base = rng.standard_normal((400, DIM)).astype(np.float32)
    ix = Index(P, capacity=512, seed=3)
    ix.add(base, nthreads=1)
    h = ix.reindex_concurrent(params=HnswParams(dim=DIM, m=12,
                                                ef_construction=64, ef=64))
    assert h.join(timeout=600)
    assert ix.params.m == 12
    ix.validate().raise_if_failed()
    with pytest.raises(ValueError, match="cannot change"):
        ix.reindex_concurrent(params=HnswParams(dim=DIM + 1, m=8))


def test_reindex_concurrent_device_build_matches_compact():
    """reindex_concurrent(build="device") with no writes in flight builds
    the engine compact(build="device") builds; the rerank rows of a PQ
    index follow, and a failed rebuild surfaces through join()."""
    ref, port, base, labels = _pair("pq", n=400, build="device")
    twin = Index(port.params, capacity=400, seed=0)
    twin._codebook = port._codebook
    twin.add(base, labels=labels, build="device", batch=64)
    twin.delete(labels[::3])
    h = port.reindex_concurrent(build="device", batch=64)
    assert h.join(timeout=600) and h.swapped
    twin.compact(build="device", batch=64)
    assert_engines_equal(port._eng, twin._eng)
    np.testing.assert_array_equal(port._raw_rows, twin._raw_rows)
    live = [4, 5, 7]  # labels[::3] are deleted
    _, lab = port.search(base[live], k=1, rerank=120)
    np.testing.assert_array_equal(lab[:, 0], labels[live])
    bad = port.reindex_concurrent(build="device", batch=64, store="f16")
    with pytest.raises(ValueError, match="store"):
        bad.join(timeout=600)
    assert bad.done and not bad.swapped


def test_searches_beside_writes_copy_a_consistent_engine():
    """Graph searches on two threads while the main thread adds: a search
    that finds the mirror stale copies the engine under the writers' lock,
    so it never copies rows and links of two moments (without the lock the
    copy met a link past its rows within the first adds)."""
    import sys
    import time

    rng = np.random.default_rng(37)
    n = 6000
    base = rng.standard_normal((n, 16)).astype(np.float32)
    ix = Index(HnswParams(dim=16, m=4, ef_construction=32), capacity=n)
    ix.add(base[:1000], nthreads=1)
    stop, errors, served = threading.Event(), [], []

    def loop():
        try:
            while not stop.is_set():
                ix.search(base[:4], k=5, mode="graph")
                served.append(1)
        except Exception as e:  # reported below
            errors.append(e)

    threads = [threading.Thread(target=loop) for _ in range(2)]
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for t in threads:
            t.start()
        for i in range(1000, n, 16):
            ix.add(base[i:i + 16], nthreads=2)
            time.sleep(0.002)
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=60)
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    assert len(served) >= 2 and ix.size == n  # searches overlapped the adds
    _, lab = ix.search(base[n - 4:], k=1, mode="graph")
    np.testing.assert_array_equal(lab[:, 0], np.arange(n - 4, n))


# ---- the streaming scan ----

def test_streaming_matches_reference():
    """Over the same engine the port's streaming scan yields the
    reference's rows, across the 64 and 256 tiers. The reference's mirror
    takes its Pallas gather-distance kernel (interpret mode), the kernel K1
    replaces: its default norm-folded einsum rounds the rows to bf16."""
    base = _clustered(33, 600)
    p = HnswParams(dim=16, m=8, ef_construction=32)
    ref = jax_ref().Index(p, capacity=600)
    port = Index(p, capacity=600)
    for ix in (ref, port):
        ix.add(base, nthreads=1)
    ref._graph = dataclasses.replace(ref.device_graph, use_pallas=True)
    for qi in (3, 42):
        got = list(itertools.islice(
            port.search_streaming(base[qi], init_k=4, ef=64), 120))
        want = list(itertools.islice(
            ref.search_streaming(base[qi], init_k=4, ef=64), 120))
        assert [lab for _, lab in got] == [lab for _, lab in want]
        np.testing.assert_allclose([d for d, _ in got], [d for d, _ in want],
                                   rtol=1e-5, atol=1e-4)
        assert got[0][1] == qi


def test_streaming_search_grows_k(rng):
    base = rng.standard_normal((300, 8)).astype(np.float32)
    ix = Index(HnswParams(dim=8, m=8, ef_construction=32), capacity=300)
    ix.add(base, nthreads=1)
    gen = ix.search_streaming(base[42], init_k=4, ef=64)
    rows = [next(gen) for _ in range(100)]  # past the 64 tier
    labels = [lab for _, lab in rows]
    assert labels[0] == 42
    assert len(set(labels)) == 100  # no duplicates across re-searches
    dists = [d for d, _ in rows[:64]]
    assert all(b >= a - 1e-5 for a, b in zip(dists, dists[1:]))
    assert set(lantern_tpu_torch.Index.STREAM_TIERS) == {64, 256, 1000}


def test_streaming_exhausts_small_index(rng):
    base = rng.standard_normal((12, 8)).astype(np.float32)
    ix = Index(HnswParams(dim=8, m=4, ef_construction=16), capacity=12)
    ix.add(base, nthreads=1)
    rows = list(ix.search_streaming(base[0], init_k=4, ef=32))
    assert len(rows) == 12  # everything reachable, then stop


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_reindex_concurrent_with_search_thread_on_card(cuda):
    """On the card: a search thread keeps serving graph batches while the
    device rebuild runs on its own stream; the swap reclaims the
    tombstones, and the writes made during it land."""
    base = _clustered(34, 20_000, 32)
    q = _clustered(35, 64, 32)
    ix = lantern_tpu_torch.Index(HnswParams(dim=32, m=8, ef_construction=48),
                                 capacity=20_000, device=cuda)
    ix.add(base, nthreads=1)
    dead = np.arange(0, 20_000, 4, dtype=np.uint64)
    ix.delete(dead)
    ix.search(q, k=10, mode="graph")  # warm
    stop, served, failures = threading.Event(), [], []

    def loop():
        try:
            while not stop.is_set():
                _, lab = ix.search(q, k=10, mode="graph")
                assert not set(dead.tolist()) & set(lab.ravel().tolist())
                served.append(lab)
        except Exception as e:  # reported below
            failures.append(e)

    t = threading.Thread(target=loop)
    t.start()
    try:
        h = ix.reindex_concurrent(build="device", batch=1024)
        extra = _clustered(36, 8, 32)
        ix.add(extra, labels=np.arange(50_000, 50_008, dtype=np.uint64))
        ix.delete(np.arange(50_000, 50_004, dtype=np.uint64))
        assert h.join(timeout=600) and h.swapped
    finally:
        stop.set()
        t.join(timeout=60)
    assert not t.is_alive() and not failures, failures
    assert served
    assert ix.num_deleted == 0 and ix.size == 15_000 + 4
    _, lab = ix.search(extra[4:], k=1, mode="flat")
    np.testing.assert_array_equal(lab[:, 0], np.arange(50_004, 50_008))
