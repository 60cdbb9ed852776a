"""The port's graph utilities and the facade's device build.

- ``validate`` against lantern_tpu.graph.validate.validate on the same
  engine arrays: a good graph and seven corruptions give the same report
  (ok, errors, reachable count); ``validate_device`` reads a DeviceGraph
  and ignores the builder's dummy slot.
- ``bfs_order`` and the device BFS against the reference's, exactly (perm
  and inv); ``reorder_bfs`` returns the same search results up to internal
  ids and a valid graph.
- ``NativeHnsw.import_graph``: a device-built graph (f32, and hamming words
  >= 2^31) becomes the engine's state bit for bit; a graph of another
  width or m, more nodes than the capacity, too few labels and int8 codes
  are refused.
- ``Index.add(build="device")`` on both branches (the bulk build of an
  empty index, ``device_insert`` into a live one) with capacity growth,
  host inserts in between, the builder's options passed on, hamming and PQ
  indexes, and ``Index.validate``.
- The ``device_build`` golden of tests/test_recall_golden.py (0.876 at
  m=16, efc=64, batch 256, ef=64, on the pinned 10k x 128 fixture) held by
  the port alone, within its tolerance of 0.01.
"""

import dataclasses
import pathlib
import types

import numpy as np
import pytest
import torch

from lantern_tpu_torch.config import HnswParams, Metric, QuantKind
from lantern_tpu_torch.graph.build_device import build_on_device
from lantern_tpu_torch.graph.device import to_device
from lantern_tpu_torch.graph.reorder import _bfs_order_device, bfs_order, reorder_bfs
from lantern_tpu_torch.graph.search import search_batched
from lantern_tpu_torch.graph.validate import validate, validate_device
from lantern_tpu_torch.index import Index
from lantern_tpu_torch.native import NativeHnsw
from lantern_tpu_torch.quant.scalar import quantize_i8

CPU = "cpu"
P = HnswParams(dim=16, m=8, ef_construction=48)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for this module: the builder's many small ops
    run faster on one, and the suite's workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def base():
    return np.random.default_rng(71).standard_normal((800, 16)).astype(np.float32)


@pytest.fixture(scope="module")
def graph(base):
    return build_on_device(base, P, batch=128, seed=0, device=CPU)


def _view(eng):
    """The engine's arrays as a plain namespace (copies, so they can be
    corrupted)."""
    n = eng.n
    return types.SimpleNamespace(
        n=n, p=eng.p, entry=eng.entry, max_level=eng.max_level,
        n_upper=eng.n_upper, neighbors0=np.array(eng.neighbors0[:n]),
        counts0=np.array(eng.counts0[:n]), levels=np.array(eng.levels[:n]),
        upper_slot=np.array(eng.upper_slot[:n]),
        upper_neighbors=np.array(eng.upper_neighbors[:eng.n_upper]),
        upper_counts=np.array(eng.upper_counts[:eng.n_upper]))


def _corruptions(v):
    """Seven broken copies of a good view, one fault each."""
    first_upper = int(np.nonzero(v.levels >= 1)[0][0])
    slot = v.upper_slot[first_upper]
    out = []
    for fault in range(7):
        c = types.SimpleNamespace(**{k: (x.copy() if isinstance(x, np.ndarray)
                                         else x) for k, x in vars(v).items()})
        if fault == 0:
            c.neighbors0[5, 0] = 5  # self loop
        elif fault == 1:
            c.neighbors0[7, 0] = c.n + 3  # id out of range
        elif fault == 2:
            r = int(np.nonzero(c.counts0 < c.neighbors0.shape[1])[0][0])
            c.neighbors0[r, -1] = 4  # padding not -1
        elif fault == 3:
            c.entry = int(np.nonzero(c.levels == 0)[0][0])  # entry below max
        elif fault == 4:
            c.upper_slot[np.nonzero(c.levels == 0)[0][0]] = 0  # level-0 slot
        elif fault == 5:
            c.upper_neighbors[slot, 0, 0] = int(np.nonzero(c.levels == 0)[0][0])
            c.upper_counts[slot, 0] = max(c.upper_counts[slot, 0], 1)
        else:
            c.neighbors0[:] = -1  # nothing reachable
            c.counts0[:] = 0
            c.upper_neighbors[:] = -1
            c.upper_counts[:] = 0
        out.append(c)
    return out


def test_validate_matches_reference(base):
    from lantern_tpu.graph.validate import validate as rvalidate

    eng = NativeHnsw(P, capacity=800, seed=0)
    eng.add(base, nthreads=1)
    v = _view(eng)
    got, want = validate(eng), rvalidate(v)
    assert got.ok and want.ok and got.n_reachable == want.n_reachable
    for c in _corruptions(v):
        got, want = validate(c), rvalidate(c)
        assert not got.ok
        assert (got.ok, got.errors, got.n, got.n_reachable) == (
            want.ok, want.errors, want.n, want.n_reachable)


def test_validate_device(graph):
    rep = validate_device(graph)
    assert rep.ok and rep.n == 800 and rep.n_reachable >= 0.98 * 800
    # the builder's dummy slot lies past the last used slot and is not read
    g = dataclasses.replace(graph, upper_neighbors=graph.upper_neighbors.clone())
    g.upper_neighbors[-1] = 12345
    assert validate_device(g).ok
    g.neighbors0 = graph.neighbors0.clone()
    g.neighbors0[3, 0] = 3
    rep = validate_device(g)
    assert not rep.ok and "self-loop at level 0" in rep.errors
    with pytest.raises(AssertionError, match="self-loop"):
        rep.raise_if_failed()


def test_bfs_orders_match_reference(graph):
    import jax.numpy as jnp
    from lantern_tpu.graph import reorder as rr

    nb = graph.neighbors0.numpy()
    np.testing.assert_array_equal(bfs_order(nb, graph.entry, 800),
                                  rr.bfs_order(nb, graph.entry, 800))
    for rounds in (64, 2):  # 2: the frontier is cut, the rest are orphans
        perm, inv = _bfs_order_device(graph.neighbors0, graph.entry, 800,
                                      max_rounds=rounds)
        rperm, rinv = rr._bfs_order_device(jnp.asarray(nb), graph.entry, 800,
                                           max_rounds=rounds)
        np.testing.assert_array_equal(perm.numpy(), np.asarray(rperm))
        np.testing.assert_array_equal(inv.numpy(), np.asarray(rinv))


def test_reorder_bfs_identical_results(graph, base):
    g2 = reorder_bfs(graph)
    validate_device(g2).raise_if_failed()
    assert g2.entry == 0 and g2.levels[0] == graph.max_level
    q = torch.from_numpy(base[:24])
    d1, i1, _ = search_batched(graph, q, k=10, ef=48)
    d2, _, lab2 = search_batched(g2, q, k=10, ef=48)
    np.testing.assert_array_equal(i1.numpy(), lab2.numpy())  # labels = old ids
    np.testing.assert_allclose(d1.numpy(), d2.numpy(), rtol=1e-5)
    with pytest.raises(ValueError, match="fully-populated"):
        reorder_bfs(dataclasses.replace(graph, num_nodes=799))


def test_import_graph_adopts_the_graph(graph, base):
    eng = NativeHnsw(P, capacity=800, seed=0)
    labels = np.arange(800, dtype=np.uint64) + np.uint64(2**63)
    eng.import_graph(graph, labels=labels)
    assert (eng.n, eng.entry, eng.max_level) == (800, graph.entry,
                                                 graph.max_level)
    np.testing.assert_array_equal(eng.neighbors0[:800],
                                  graph.neighbors0[:800].numpy())
    np.testing.assert_array_equal(eng.vectors[:800], base)
    np.testing.assert_array_equal(eng.labels[:800], labels)
    nu = eng.n_upper
    np.testing.assert_array_equal(eng.upper_neighbors[:nu],
                                  graph.upper_neighbors[:nu].numpy())
    np.testing.assert_array_equal(eng.counts0[:800],
                                  (graph.neighbors0[:800] >= 0).sum(1).numpy())
    assert validate(eng).ok
    ids, _ = eng.search(base[3], k=3, ef=32)
    assert ids[0] == 3
    back = to_device(eng, device=CPU)
    assert torch.equal(back.neighbors0, graph.neighbors0)


def test_import_graph_hamming_words():
    words = np.random.default_rng(4).integers(0, 2**32, (300, 2), dtype=np.uint32)
    words[:, 0] |= np.uint32(2**31)  # negative as int32
    p = HnswParams(dim=64, m=8, ef_construction=32, metric=Metric.HAMMING)
    g = build_on_device(words, p, batch=64, seed=0, device=CPU)
    eng = NativeHnsw(p, capacity=300, seed=0)
    eng.import_graph(g)
    np.testing.assert_array_equal(eng.vectors[:300], words)
    np.testing.assert_array_equal(eng.labels[:300], np.arange(300))
    ids, d = eng.search(words[7], k=1, ef=16)
    assert ids[0] == 7 and d[0] == 0


def test_import_graph_refuses_mismatches(graph):
    cases = [
        (NativeHnsw(HnswParams(dim=8, m=8), capacity=800), "width"),
        (NativeHnsw(HnswParams(dim=16, m=4), capacity=800), "m=8"),
        (NativeHnsw(P, capacity=500), "capacity"),
    ]
    for eng, msg in cases:
        with pytest.raises(ValueError, match=msg):
            eng.import_graph(graph)
    eng = NativeHnsw(P, capacity=800)
    with pytest.raises(ValueError, match="labels"):
        eng.import_graph(graph, labels=np.arange(10, dtype=np.uint64))
    codes, scales = quantize_i8(graph.vectors)
    g8 = dataclasses.replace(graph, vectors=codes, vec_scales=scales,
                             quant=int(QuantKind.I8))
    with pytest.raises(ValueError, match="codes"):
        eng.import_graph(g8)
    assert eng.n == 0


def test_index_device_build_both_branches(rng):
    base = rng.standard_normal((1200, 16)).astype(np.float32)
    ix = Index(P, capacity=16, device=CPU)  # undersized: grows
    ix.add(base, build="device", batch=128)
    assert ix.size == 1200 and ix._eng._cap >= 1200
    _, labels = ix.search(base[:8], k=5, mode="graph", ef=48)
    assert (labels[:, 0] == np.arange(8)).all()
    ids_cpu, _ = ix._eng.search(base[0], k=5, ef=48)  # the engine's own search
    assert ids_cpu[0] == 0
    extra = rng.standard_normal((4, 16)).astype(np.float32)
    ix.add(extra, nthreads=1)  # host inserts after a device build
    _, lab3 = ix.search(extra, k=1, mode="graph", ef=48)
    assert (lab3[:, 0] == 1200 + np.arange(4)).all()
    extra2 = rng.standard_normal((900, 16)).astype(np.float32)
    ix.add(extra2, build="device", batch=128)  # device_insert; 2048 -> 4096
    assert ix.size == 2104 and ix._eng._cap == 4096
    _, lab4 = ix.search(extra2[:8], k=1, mode="graph", ef=48)
    assert (lab4[:, 0] == 1204 + np.arange(8)).all()
    ids_cpu2, _ = ix._eng.search(extra2[0], k=3, ef=48)
    assert ids_cpu2[0] == 1204
    _, lab5 = ix.search(base[:8], k=5, mode="graph", ef=48)
    assert (lab5[:, 0] == np.arange(8)).all()
    ix.validate().raise_if_failed()
    # builder options pass through; others are refused
    ix3 = Index(P, device=CPU)
    ix3.add(base[:800], build="device", batch=128, candidates="hybrid",
            flat_until=300, store="bf16")
    _, lab6 = ix3.search(base[:8], k=5, mode="graph", ef=48)
    assert (lab6[:, 0] == np.arange(8)).all()
    with pytest.raises(ValueError, match="build"):
        ix3.add(base[:4], build="gpu")
    with pytest.raises(TypeError, match="candidates"):
        ix3.add(base[:4], candidates="beam")


def test_index_device_build_hamming_and_pq(rng):
    x = rng.standard_normal((700, 64)).astype(np.float32)
    ix = Index(HnswParams(dim=64, m=8, ef_construction=32,
                          metric=Metric.HAMMING, quant=QuantKind.B1),
               device=CPU)
    ix.add(x[:500], build="device", batch=128)  # float rows, binarised
    ix.add(x[500:], build="device", batch=128)
    d, lab = ix.search(x[495:505], k=1, mode="graph", ef=32)
    assert (d[:, 0] == 0).all() and ix.validate().ok
    rows = np.array(ix._eng.vectors[:700])
    hits = (ix._eng.vectors[lab[:, 0].astype(np.int64)] == rows[495:505]).all(1)
    assert hits.all()
    pq = Index(HnswParams(dim=32, m=8, ef_construction=32, pq=True,
                          num_subvectors=8, num_centroids=32), device=CPU)
    y = rng.standard_normal((600, 32)).astype(np.float32)
    pq.add(y, build="device", batch=128)
    _, lab = pq.search(y[:8], k=5, rerank=50)
    assert (lab[:, 0] == np.arange(8)).all() and pq.validate().ok


def test_golden_device_build():
    from lantern_tpu.io.dotvecs import parse_fvecs

    fixtures = pathlib.Path(__file__).parent / "fixtures"
    base = parse_fvecs(str(fixtures / "golden_base.fvecs.gz"))
    queries = parse_fvecs(str(fixtures / "golden_query.fvecs.gz"))
    b_sq = np.einsum("nd,nd->n", base, base)
    gt = np.argsort(b_sq[None, :] - 2.0 * (queries @ base.T), axis=1,
                    kind="stable")[:, :10]
    g = build_on_device(base, HnswParams(dim=128, m=16, ef_construction=64),
                        batch=256, seed=0, device=CPU)
    _, ids, _ = search_batched(g, torch.from_numpy(queries), k=10, ef=64)
    hits = sum(len(set(f.tolist()) & set(t.tolist()))
               for f, t in zip(ids.numpy(), gt))
    assert hits / gt.size >= 0.876 - 0.01
