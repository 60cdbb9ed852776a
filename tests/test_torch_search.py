"""Parity: the port's batched beam search against lantern_tpu's.

Both packages search the SAME graph: the reference builds it (NativeHnsw,
nthreads=1), mirrors it with to_device, and the port adopts the mirror's
arrays through from_jax_arrays. The reference runs with use_pallas=True, so
its candidate distances go through its Pallas gather kernel (interpret mode
on the CPU), the kernel the port's K1 replaces.

Tolerances: ids equal; distances within 1e-4 abs + 1e-5 rel (f32 sums in a
different order); stats equal.
"""

import dataclasses
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lantern_tpu.config import HnswParams, Metric, QuantKind
from lantern_tpu.graph.device import to_device as jax_to_device
from lantern_tpu.graph.search import search_batched as jax_search
from lantern_tpu.native import NativeHnsw as JaxNativeHnsw
from lantern_tpu_torch.graph.device import from_jax_arrays
from lantern_tpu_torch.graph.search import search_batched
from lantern_tpu_torch.ops.gather_dists import gather_dists

ATOL, RTOL = 1e-4, 1e-5


def _arrays(g):
    return {f.name: np.asarray(getattr(g, f.name))
            for f in dataclasses.fields(g)
            if getattr(g, f.name) is not None and f.metadata.get(
                "pytree_node", True)}


def _port(g):
    return from_jax_arrays(_arrays(g), m=g.m, dim=g.dim, metric=g.metric,
                           quant=g.quant, device="cpu")


def _data(rng, n, dim, centers=16):
    c = rng.standard_normal((centers, dim)).astype(np.float32)
    base = c[rng.integers(0, centers, n)] + 0.35 * rng.standard_normal((n, dim))
    q = c[rng.integers(0, centers, 24)] + 0.35 * rng.standard_normal((24, dim))
    return base.astype(np.float32), q.astype(np.float32)


@pytest.fixture(scope="module")
def graphs():
    rng = np.random.default_rng(0xA47E60DB)
    base, q = _data(rng, 800, 32)
    out = {}
    for metric in (Metric.L2SQ, Metric.COS):
        eng = JaxNativeHnsw(HnswParams(dim=32, m=8, ef_construction=48,
                                       metric=metric), capacity=800, seed=0)
        eng.add(base, nthreads=1)
        out[metric] = eng
    return out, q


def _compare(g, q, ties=False, **kw):
    """Search g with both packages; ids equal (``ties=True``: equal up to the
    order of exactly tied distances, which PQ rows with equal codes give)."""
    gp = dataclasses.replace(g, use_pallas=True)
    jd, ji, jl, js = jax_search(gp, jnp.asarray(q), with_stats=True, **kw)
    ex = kw.pop("exclude", None)
    if ex is not None:
        kw["exclude"] = torch.from_numpy(np.array(ex))
    gather_dists.launches = 0
    tq = q.view(np.int32) if q.dtype == np.uint32 else q  # words: int32 bits
    td, ti, tl, ts = search_batched(_port(g), torch.from_numpy(tq),
                                    with_stats=True, **kw)
    assert gather_dists.launches == 0  # CPU tensors take the plain version
    same = ti.numpy() == np.asarray(ji)
    if ties:
        d = td.numpy()
        tied = np.zeros(d.shape, bool)
        tied[:, 1:] |= d[:, 1:] == d[:, :-1]
        tied[:, :-1] |= d[:, :-1] == d[:, 1:]
        same |= tied
        np.testing.assert_array_equal(np.sort(ti.numpy(), 1),
                                      np.sort(np.asarray(ji), 1))
    assert same.all(), (ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=RTOL, atol=ATOL)
    jlab = np.asarray(jl)
    want = jlab[..., 0].astype(np.uint64) | (jlab[..., 1].astype(np.uint64) << 32)
    lab = tl.numpy().view(np.uint64)
    if ties:
        lab, want = np.sort(lab, 1), np.sort(want, 1)
    np.testing.assert_array_equal(lab, want)
    for key in ("iterations", "visited", "expanded"):
        np.testing.assert_array_equal(ts[key].numpy(), np.asarray(js[key]))
    return ti.numpy()


@pytest.mark.parametrize("seeds,expand", [(1, 1), (8, 1), (1, 2), (8, 2)])
def test_search_matches_reference(graphs, seeds, expand):
    engs, q = graphs
    _compare(jax_to_device(engs[Metric.L2SQ]), q, k=10, ef=32, seeds=seeds,
             expand=expand)


@pytest.mark.parametrize("case", ["tombstones", "exclude", "upper_descent",
                                  "cos", "bf16"])
def test_search_variants_match_reference(graphs, case):
    engs, q = graphs
    kw = dict(k=10, ef=32, seeds=8)
    if case == "cos":
        g = jax_to_device(engs[Metric.COS])
    elif case == "bf16":
        g = jax_to_device(engs[Metric.L2SQ], dtype=jnp.bfloat16)
    else:
        g = jax_to_device(engs[Metric.L2SQ])
    mask = np.random.default_rng(1).random(g.cap) < 0.25
    if case == "tombstones":
        g = g.replace(deleted=jnp.asarray(mask))
    elif case == "exclude":
        kw["exclude"] = jnp.asarray(mask)
    elif case == "upper_descent":
        g = g.replace(upper_ids=None)
        kw["seeds"] = 1
    ids = _compare(g, q, **kw)
    if case in ("tombstones", "exclude"):
        assert not mask[ids[ids >= 0]].any()


def test_port_reaches_host_build_golden():
    """The port's beam on the port's own host build of the pinned 10k x 128
    fixture reaches the host-build golden recall@10 (0.866, tol 0.01)."""
    from lantern_tpu.io.dotvecs import parse_fvecs
    from lantern_tpu_torch.graph.device import to_device
    from lantern_tpu_torch.native import NativeHnsw

    fixtures = pathlib.Path(__file__).parent / "fixtures"
    base = parse_fvecs(str(fixtures / "golden_base.fvecs.gz"))
    queries = parse_fvecs(str(fixtures / "golden_query.fvecs.gz"))
    b_sq = np.einsum("nd,nd->n", base, base)
    gt = np.argsort(b_sq[None, :] - 2.0 * (queries @ base.T), axis=1,
                    kind="stable")[:, :10]
    eng = NativeHnsw(HnswParams(dim=128, m=16, ef_construction=64),
                     capacity=len(base), seed=0)
    eng.add(base, nthreads=1)
    _, ids, _ = search_batched(to_device(eng, device="cpu"),
                               torch.from_numpy(queries), k=10, ef=64)
    hits = sum(len(set(f[f >= 0].tolist()) & set(t.tolist()))
               for f, t in zip(ids.numpy(), gt))
    assert hits / gt.size >= 0.866 - 0.01


@pytest.fixture(scope="module")
def pq_graphs():
    """Reference PQ graphs (plain and OPQ codebooks) over the decoded rows
    of clustered data, built with nthreads=1."""
    from lantern_tpu.quant.pq import pq_decode, pq_encode, train_codebook

    rng = np.random.default_rng(0xA47E60DC)
    base, q = _data(rng, 800, 32)
    out = {}
    for name, rotate, metric in (("l2sq", False, Metric.L2SQ),
                                 ("cos", False, Metric.COS),
                                 ("opq", True, Metric.L2SQ)):
        cb = train_codebook(base, 8, 32, iters=8, seed=0, rotate=rotate,
                            opq_iters=3)
        eng = JaxNativeHnsw(HnswParams(dim=32, m=8, ef_construction=48,
                                       metric=metric), capacity=800, seed=0)
        eng.add(pq_decode(pq_encode(base, cb), cb), nthreads=1)
        out[name] = jax_to_device(eng, pq_codebook=cb)
    return out, q


@pytest.mark.parametrize("case", ["l2sq", "cos", "opq", "tombstones",
                                  "upper_descent", "expand2"])
def test_pq_search_matches_reference(pq_graphs, case):
    """The ADC beam (and its PQ entry scan) on a reference PQ graph carried
    across with from_jax_arrays: ids equal up to exact ties, stats equal."""
    from lantern_tpu_torch.ops.pq_decode import pq_decode

    graphs, q = pq_graphs
    g = graphs.get(case, graphs["l2sq"])
    kw = dict(k=10, ef=32, seeds=8)
    if case == "tombstones":
        mask = np.random.default_rng(1).random(g.cap) < 0.25
        g = g.replace(deleted=jnp.asarray(mask))
    elif case == "upper_descent":
        g = g.replace(upper_ids=None)
        kw["seeds"] = 1
    elif case == "expand2":
        kw["expand"] = 2
    pq_decode.launches = 0
    _compare(g, q, ties=True, **kw)
    assert pq_decode.launches == 0  # CPU tensors: the plain decode


@pytest.fixture(scope="module")
def quant_graphs():
    """Reference graphs over i8-dequantised rows (l2sq, cos) and over
    clustered 80-bit words (hamming), built with nthreads=1."""
    from lantern_tpu.quant.scalar import dequantize_i8, quantize_i8

    rng = np.random.default_rng(0xA47E60DD)
    base, q = _data(rng, 800, 32)
    deq = np.asarray(dequantize_i8(*quantize_i8(jnp.asarray(base))))
    out = {}
    for metric in (Metric.L2SQ, Metric.COS):
        eng = JaxNativeHnsw(HnswParams(dim=32, m=8, ef_construction=48,
                                       metric=metric), capacity=800, seed=0)
        eng.add(deq, nthreads=1)
        out[f"i8_{metric.name.lower()}"] = (jax_to_device(eng, quant=QuantKind.I8), q)
    centres = rng.integers(0, 2**32, (16, 3), dtype=np.uint32)
    flips = [rng.integers(0, 2**32, (824, 3), dtype=np.uint32) for _ in range(3)]
    words = centres[rng.integers(0, 16, 824)] ^ (flips[0] & flips[1] & flips[2])
    eng = JaxNativeHnsw(HnswParams(dim=80, m=8, ef_construction=48,
                                   metric=Metric.HAMMING), capacity=800, seed=0)
    eng.add(words[:800], nthreads=1)
    out["hamming"] = (jax_to_device(eng), words[800:])
    return out


@pytest.mark.parametrize("case", ["i8_l2sq", "i8_cos", "i8_tombstones",
                                  "i8_upper_descent"])
def test_i8_search_matches_reference(quant_graphs, case):
    """The i8 beam (widened codes x vec_scales, the i8 entry scan) on a
    reference i8 graph: ids equal, distances within the f32 tolerances,
    stats equal. K1 is never launched."""
    g, q = quant_graphs["i8_cos" if case == "i8_cos" else "i8_l2sq"]
    kw = dict(k=10, ef=32, seeds=8)
    if case == "i8_tombstones":
        mask = np.random.default_rng(1).random(g.cap) < 0.25
        g = g.replace(deleted=jnp.asarray(mask))
    elif case == "i8_upper_descent":
        g = g.replace(upper_ids=None)
        kw["seeds"] = 1
    _compare(g, q, **kw)


def _hamming_dists(words, q, ids):
    """Exact hamming distances [Q, k] of ``ids`` (inf where id < 0)."""
    table = np.array([bin(i).count("1") for i in range(256)], np.int64)
    x = np.bitwise_xor(q[:, None, :], words[np.maximum(ids, 0)])
    d = table[x.view(np.uint8)].sum(-1).astype(np.float32)
    return np.where(ids >= 0, d, np.inf)


@pytest.mark.parametrize("case", ["seeds8", "seeds1", "tombstones",
                                  "upper_descent"])
def test_hamming_search_matches_reference(quant_graphs, case):
    """The hamming beam on a reference hamming graph (uint32 words carried
    across as int32 words).

    Hamming distances are small integers, so ties are the rule. The entry
    scan's top-k (``ops/row_topk.py``) keeps the lower ids of a tie at the
    k-th place, as the reference's exact ``lax.top_k`` does, so with 8
    seeds (with or without tombstones) both beams start from the same
    seeds: ids and every statistic are equal. With one seed the reference
    scans at recall target 0.999 (``approx_max_k``), which can pick another
    member of a tie; the beams then start from different (equally distant)
    seeds, and visited/expanded differ on some queries. So every case holds
    per-query distance profiles exactly equal, every returned id to its
    returned distance, the labels, and ``iterations``. The greedy-descent
    entry (no upper scan; argmin takes the first minimum in both) starts
    both beams alike: there ids are equal up to tied distances and every
    statistic is equal.
    """
    from lantern_tpu.graph.search import search_batched as jax_search_batched

    g, q = quant_graphs["hamming"]
    kw = dict(k=10, ef=32, seeds=1 if case == "seeds1" else 8)
    if case == "tombstones":
        mask = np.random.default_rng(1).random(g.cap) < 0.25
        g = g.replace(deleted=jnp.asarray(mask))
    elif case == "upper_descent":
        g = g.replace(upper_ids=None)
        kw["seeds"] = 1
        _compare(g, q, ties=True, **kw)
        return
    jd, ji, jl, js = jax_search_batched(g, jnp.asarray(q), with_stats=True, **kw)
    td, ti, tl, ts = search_batched(_port(g), torch.from_numpy(q.view(np.int32)),
                                    with_stats=True, **kw)
    words = np.asarray(g.vectors)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))  # profiles
    np.testing.assert_array_equal(_hamming_dists(words, q, ti.numpy()),
                                  td.numpy())
    np.testing.assert_array_equal(ts["iterations"].numpy(),
                                  np.asarray(js["iterations"]))
    jlab = np.asarray(g.labels)
    want = jlab[..., 0].astype(np.uint64) | (jlab[..., 1].astype(np.uint64) << 32)
    ids = ti.numpy()
    np.testing.assert_array_equal(tl.numpy().view(np.uint64),
                                  np.where(ids >= 0, want[np.maximum(ids, 0)], 0))
    if case == "tombstones":
        assert not mask[ids[ids >= 0]].any()
    if case != "seeds1":  # the same seeds: the same beam
        np.testing.assert_array_equal(ids, np.asarray(ji))
        for key in ("visited", "expanded"):
            np.testing.assert_array_equal(ts[key].numpy(), np.asarray(js[key]))
