"""Parity: the port's PQ scans against lantern_tpu/flat.py's.

flat_search_pq, flat_search_pq_rerank, flat_search_graph_rerank and the PQ
branch of flat_search_graph, each against the reference on the same codes
and codebook (the reference's top-k is exact on the CPU), for l2sq and cos,
with and without an OPQ rotation and tombstones, on the one-shot and the
blocked path. Ids are equal up to ties (equal distances may come in either
order); distances agree within 1e-4 abs + 1e-4 rel (the same bf16 products
and f32 sums, summed in another order). The PQ DeviceGraph the port builds
itself equals the reference's field for field.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lantern_tpu import flat as ref_flat
from lantern_tpu.config import HnswParams, Metric
from lantern_tpu.graph.device import to_device as jax_to_device
from lantern_tpu.native import NativeHnsw as JaxNativeHnsw
from lantern_tpu.quant import pq as ref_pq
from lantern_tpu_torch import flat
from lantern_tpu_torch.graph.device import QUANT_PQ, from_jax_arrays, to_device
from lantern_tpu_torch.native import NativeHnsw
from lantern_tpu_torch.ops.pq_decode import pq_decode
from lantern_tpu_torch.quant.pq import PQCodebook

ATOL, RTOL = 1e-4, 1e-4
N, DIM, S, K = 700, 32, 8, 32


def _assert_ids_equal_up_to_ties(ids, want, d):
    ids, want, d = np.asarray(ids), np.asarray(want), np.asarray(d)
    tied = np.zeros(d.shape, bool)
    tied[:, 1:] |= d[:, 1:] == d[:, :-1]
    tied[:, :-1] |= d[:, :-1] == d[:, 1:]
    assert ((ids == want) | tied).all(), (ids, want)


def _check(got, want):
    _assert_ids_equal_up_to_ties(got[1].numpy(), want[1], got[0].numpy())
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=RTOL, atol=ATOL)


@pytest.fixture(scope="module", params=["plain", "opq"])
def setup(request):
    rng = np.random.default_rng(11)
    base = rng.standard_normal((N, DIM)).astype(np.float32)
    queries = rng.standard_normal((9, DIM)).astype(np.float32)
    cb = ref_pq.train_codebook(base, S, K, iters=5, seed=0,
                               rotate=request.param == "opq", opq_iters=3)
    codes = np.array(ref_pq.pq_encode(base, cb))  # writable: torch wraps it
    dele = rng.random(N) < 0.2
    return dict(base=base, q=queries, cb=cb, codes=codes, dele=dele)


def _args(st, tombstones):
    cb = st["cb"]
    rot = None if cb.rotation is None else np.array(cb.rotation)
    jargs = dict(centroids=jnp.asarray(cb.centroids),
                 rotation=None if rot is None else jnp.asarray(rot),
                 deleted=jnp.asarray(st["dele"]) if tombstones else None)
    targs = dict(centroids=torch.from_numpy(np.array(cb.centroids)),
                 rotation=None if rot is None else torch.from_numpy(rot),
                 deleted=torch.from_numpy(st["dele"]) if tombstones else None)
    return jargs, targs


@pytest.mark.parametrize("metric", [Metric.L2SQ, Metric.COS])
@pytest.mark.parametrize("block", [1 << 19, 128])  # one-shot; blocked + tail
@pytest.mark.parametrize("tombstones", [False, True])
def test_flat_search_pq_matches_reference(setup, metric, block, tombstones):
    jargs, targs = _args(setup, tombstones)
    want = ref_flat.flat_search_pq(
        jnp.asarray(setup["codes"]), queries=jnp.asarray(setup["q"]), k=10,
        metric=int(metric), exact=True, block=block, **jargs)
    pq_decode.launches = 0
    got = flat.flat_search_pq(
        torch.from_numpy(setup["codes"]), queries=torch.from_numpy(setup["q"]),
        k=10, metric=metric, block=block, **targs)
    assert pq_decode.launches == 0  # CPU tensors: the plain decode
    _check(got, want)
    if tombstones:
        assert not setup["dele"][got[1].numpy()].any()


def test_flat_search_pq_k_above_n(setup):
    jargs, targs = _args(setup, False)
    codes = setup["codes"][:6]
    want = ref_flat.flat_search_pq(jnp.asarray(codes),
                                   queries=jnp.asarray(setup["q"]), k=9,
                                   exact=True, **jargs)
    got = flat.flat_search_pq(torch.from_numpy(codes),
                              queries=torch.from_numpy(setup["q"]), k=9,
                              **targs)
    _check(got, want)
    assert (got[1][:, 6:] == -1).all()


@pytest.mark.parametrize("metric", [Metric.L2SQ, Metric.COS])
@pytest.mark.parametrize("tombstones", [False, True])
@pytest.mark.parametrize("block", [1 << 19, 256])
def test_flat_search_pq_rerank_matches_reference(setup, metric, tombstones,
                                                 block):
    jargs, targs = _args(setup, tombstones)
    base = setup["base"]
    sqn = np.einsum("nd,nd->n", base, base).astype(np.float32)
    want = ref_flat.flat_search_pq_rerank(
        jnp.asarray(setup["codes"]), vectors=jnp.asarray(base),
        sq_norms=jnp.asarray(sqn), queries=jnp.asarray(setup["q"]), k=10,
        shortlist=40, metric=int(metric), block=block, **jargs)
    got = flat.flat_search_pq_rerank(
        torch.from_numpy(setup["codes"]), vectors=torch.from_numpy(base),
        queries=torch.from_numpy(setup["q"]), k=10, shortlist=40,
        metric=metric, block=block, **targs)
    _check(got, want)


def _pq_graphs(st, metric):
    """The reference's PQ DeviceGraph over the decoded rows, and the port's
    copy of it (from_jax_arrays) and own build (to_device)."""
    cb = st["cb"]
    decoded = ref_pq.pq_decode(st["codes"], cb)
    p = HnswParams(dim=DIM, m=8, ef_construction=32, metric=metric)
    jeng, teng = JaxNativeHnsw(p, capacity=N, seed=0), NativeHnsw(p, capacity=N,
                                                                   seed=0)
    for eng in (jeng, teng):
        eng.add(decoded, nthreads=1)
    jg = jax_to_device(jeng, pq_codebook=cb)
    arrays = {f.name: np.asarray(getattr(jg, f.name))
              for f in dataclasses.fields(jg)
              if getattr(jg, f.name) is not None
              and f.metadata.get("pytree_node", True)}
    tg = from_jax_arrays(arrays, m=jg.m, dim=jg.dim, metric=jg.metric,
                         quant=jg.quant, device="cpu")
    own = to_device(teng, device="cpu",
                    pq_codebook=PQCodebook(np.array(cb.centroids),
                                           cb.rotation))
    return jg, tg, own


@pytest.mark.parametrize("metric", [Metric.L2SQ, Metric.COS])
def test_pq_device_graph_matches_reference(setup, metric):
    jg, tg, own = _pq_graphs(setup, metric)
    assert own.quant == tg.quant == QUANT_PQ == jg.quant
    for name in ("vectors", "sq_norms", "neighbors0", "upper_neighbors",
                 "upper_slot", "levels", "deleted", "upper_ids",
                 "pq_codebook"):
        np.testing.assert_array_equal(getattr(own, name).numpy(),
                                      np.asarray(getattr(jg, name)), err_msg=name)
    assert own.vectors.dtype == torch.uint8 and own.vectors.shape == (N, S)
    if jg.pq_rotation is None:
        assert own.pq_rotation is None and tg.pq_rotation is None
    else:
        np.testing.assert_array_equal(own.pq_rotation.numpy(),
                                      np.asarray(jg.pq_rotation))
    assert own.upper_vectors is None  # with_aug_norms leaves PQ graphs alone


def _labels(jl):
    jl = np.asarray(jl)
    return jl[..., 0].astype(np.uint64) | (jl[..., 1].astype(np.uint64) << 32)


@pytest.mark.parametrize("metric", [Metric.L2SQ, Metric.COS])
def test_flat_search_graph_and_rerank_match_reference(setup, metric):
    jg, tg, _ = _pq_graphs(setup, metric)
    mask = np.random.default_rng(2).random(N) < 0.2
    jg = jg.replace(deleted=jnp.asarray(mask))
    tg = dataclasses.replace(tg, deleted=torch.from_numpy(mask))
    exclude = np.zeros(N, bool)
    exclude[100:200] = True
    q = setup["q"]
    wd, wi, wl = ref_flat.flat_search_graph(jg, jnp.asarray(q), k=10,
                                            exact=True,
                                            exclude=jnp.asarray(exclude))
    d, ids, lab = flat.flat_search_graph(tg, torch.from_numpy(q), k=10,
                                         exclude=torch.from_numpy(exclude))
    _check((d, ids), (wd, wi))
    np.testing.assert_array_equal(lab.numpy().view(np.uint64)[ids.numpy() >= 0],
                                  _labels(wl)[ids.numpy() >= 0])
    rows = setup["base"]
    sqn = np.einsum("nd,nd->n", rows, rows).astype(np.float32)
    wd, wi, wl = ref_flat.flat_search_graph_rerank(
        jg, jnp.asarray(rows, jnp.bfloat16), jnp.asarray(sqn), jnp.asarray(q),
        k=10, shortlist=50, exclude=jnp.asarray(exclude))
    d, ids, lab = flat.flat_search_graph_rerank(
        tg, torch.from_numpy(rows).to(torch.bfloat16), torch.from_numpy(q),
        k=10, shortlist=50, exclude=torch.from_numpy(exclude))
    _check((d, ids), (wd, wi))
    found = ids.numpy()
    assert not (mask[found] | exclude[found]).any()


def test_graph_rerank_refuses_unquantised_graph(setup):
    jg, tg, _ = _pq_graphs(setup, Metric.L2SQ)
    with pytest.raises(ValueError, match="PQ graphs only"):
        flat.flat_search_graph_rerank(dataclasses.replace(tg, quant=0),
                                      torch.zeros((N, DIM)),
                                      torch.zeros((2, DIM)))
