"""Parity: the port's flat scan against lantern_tpu's flat_search(exact=True).

Ids equal; distances within 1e-4 abs + 1e-5 rel (the same f32 scores summed
in another order). Covers tombstones, unfilled capacity rows, exclude, cos,
bf16 rows, i8 codes with per-row scales, the blocked merge (block < n) and
k > n. Hamming scans (int32 words against the reference's uint32 words)
return exactly equal distances and ids equal up to the order of tied
distances, ties at the k-th place included.

The l2sq score block is one GEMM with the bias -|x|^2 (-inf at excluded
rows) in its epilogue (``flat._l2sq_scores``): it is held to the three
passes it replaced (2<q,x>, minus |x|^2, then the mask) within f32
rounding, with -inf exactly at the excluded rows, and its counter to one
block per l2sq f32, bf16 or PQ block and none for cosine, i8 or hamming.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lantern_tpu.flat import flat_search as jax_flat_search
from lantern_tpu.flat import flat_search_graph as jax_flat_search_graph
from lantern_tpu.graph.device import to_device as jax_to_device
from lantern_tpu.native import NativeHnsw as JaxNativeHnsw
from lantern_tpu_torch import flat
from lantern_tpu_torch.config import HnswParams, Metric
from lantern_tpu_torch.flat import flat_search, flat_search_graph
from lantern_tpu_torch.graph.device import to_device
from lantern_tpu_torch.native import NativeHnsw

ATOL, RTOL = 1e-4, 1e-5


def _check(got, want):
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("metric", [Metric.L2SQ, Metric.COS])
@pytest.mark.parametrize("block", [None, 96])  # 96 < n: blocked merge + tail
@pytest.mark.parametrize("bf16", [False, True])
def test_flat_search_matches_reference(rng, metric, block, bf16):
    v = rng.standard_normal((500, 24)).astype(np.float32)
    q = rng.standard_normal((13, 24)).astype(np.float32)
    dele = rng.random(500) < 0.2
    jv = jnp.asarray(v).astype(jnp.bfloat16) if bf16 else jnp.asarray(v)
    tv = torch.from_numpy(v)
    tv = tv.to(torch.bfloat16) if bf16 else tv
    sqn = np.einsum("nd,nd->n", v, v).astype(np.float32)
    want = jax_flat_search(jv, jnp.asarray(sqn), jnp.asarray(q), k=10,
                           metric=int(metric), exact=True, block=block,
                           deleted=jnp.asarray(dele))
    got = flat_search(tv, torch.from_numpy(sqn), torch.from_numpy(q), k=10,
                      metric=metric, exact=True, block=block,
                      deleted=torch.from_numpy(dele))
    _check(got, want)
    assert not dele[got[1].numpy()].any()


@pytest.mark.parametrize("metric", [Metric.L2SQ, Metric.COS])
@pytest.mark.parametrize("block", [None, 96])
def test_flat_search_i8_matches_reference(rng, metric, block):
    from lantern_tpu.quant.scalar import dequantize_i8, quantize_i8

    v = rng.standard_normal((500, 24)).astype(np.float32)
    q = rng.standard_normal((13, 24)).astype(np.float32)
    dele = rng.random(500) < 0.2
    codes, scales = quantize_i8(jnp.asarray(v))
    deq = np.asarray(dequantize_i8(codes, scales))
    sqn = np.einsum("nd,nd->n", deq, deq).astype(np.float32)
    want = jax_flat_search(codes, jnp.asarray(sqn), jnp.asarray(q), k=10,
                           metric=int(metric), exact=True, block=block,
                           vec_scales=scales, deleted=jnp.asarray(dele))
    got = flat_search(torch.from_numpy(np.array(codes)), torch.from_numpy(sqn),
                      torch.from_numpy(q), k=10, metric=metric, exact=True,
                      block=block, deleted=torch.from_numpy(dele),
                      vec_scales=torch.from_numpy(np.array(scales)))
    _check(got, want)


def check_hamming(got, want, base_u32, queries_u32):
    """Exact distances; ids equal up to ties: each id's true distance is its
    slot's, and the ids strictly inside the k-th distance agree as sets."""
    d, ids = got[0].numpy(), got[1].numpy()
    np.testing.assert_array_equal(d, np.asarray(want[0]))
    wids = np.asarray(want[1])
    table = np.array([bin(i).count("1") for i in range(256)], np.int64)
    valid = ids >= 0
    np.testing.assert_array_equal(valid, wids >= 0)
    x = np.bitwise_xor(queries_u32[:, None, :], base_u32[np.maximum(ids, 0)])
    true_d = table[x.view(np.uint8)].sum(-1).astype(np.float32)
    np.testing.assert_array_equal(np.where(valid, true_d, np.inf), d)
    for row, wrow, drow in zip(ids, wids, d):
        kth = drow[np.isfinite(drow)].max(initial=-1)
        inner = drow < kth
        assert set(row[inner].tolist()) == set(wrow[inner].tolist())
        assert len(set(row[row >= 0].tolist())) == int((row >= 0).sum())


@pytest.mark.parametrize("block,k", [(None, 10), (96, 10), (None, 600)])
def test_flat_search_hamming_matches_reference(rng, block, k):
    words = rng.integers(0, 2**32, (16, 2), dtype=np.uint32)
    flips = [rng.integers(0, 2**32, (500, 2), dtype=np.uint32) for _ in range(3)]
    v = words[rng.integers(0, 16, 500)] ^ (flips[0] & flips[1] & flips[2])
    q = v[rng.integers(0, 500, 13)] ^ np.uint32(0x80000001)
    dele = rng.random(500) < 0.2
    want = jax_flat_search(jnp.asarray(v), jnp.zeros(500), jnp.asarray(q), k=k,
                           metric=int(Metric.HAMMING), exact=True, block=block,
                           deleted=jnp.asarray(dele))
    got = flat_search(torch.from_numpy(v.view(np.int32)), torch.zeros(500),
                      torch.from_numpy(q.view(np.int32)), k=k,
                      metric=Metric.HAMMING, exact=True, block=block,
                      deleted=torch.from_numpy(dele))
    assert got[1].dtype == torch.int32 and got[0].shape == (13, k)
    check_hamming(got, want, v, q)
    assert not dele[got[1].numpy()[got[1].numpy() >= 0]].any()


def test_flat_search_k_above_n(rng):
    v = rng.standard_normal((6, 8)).astype(np.float32)
    q = rng.standard_normal((3, 8)).astype(np.float32)
    sqn = np.einsum("nd,nd->n", v, v).astype(np.float32)
    want = jax_flat_search(jnp.asarray(v), jnp.asarray(sqn), jnp.asarray(q),
                           k=9, exact=True)
    got = flat_search(torch.from_numpy(v), torch.from_numpy(sqn),
                      torch.from_numpy(q), k=9, exact=True)
    _check(got, want)
    assert (got[1][:, 6:] == -1).all() and torch.isinf(got[0][:, 6:]).all()


def test_flat_search_graph_matches_reference(rng):
    """Unfilled capacity rows (cap > n after growth), tombstones, exclude."""
    base = rng.standard_normal((300, 16)).astype(np.float32)
    labels = np.arange(300, dtype=np.uint64) * np.uint64(3) + np.uint64(2**40)
    p = HnswParams(dim=16, m=8, ef_construction=32)
    port, ref = NativeHnsw(p, capacity=300, seed=0), JaxNativeHnsw(
        p, capacity=300, seed=0)
    for eng in (port, ref):
        eng.add(base, labels=labels, nthreads=1)
        eng.mark_deleted(labels[:30])
    jg, tg = jax_to_device(ref), to_device(port, device="cpu")
    # pad both mirrors to cap 512: unfilled rows of zeros, as after growth
    pad = 512 - jg.cap
    jg = jg.replace(vectors=jnp.pad(jg.vectors, ((0, pad), (0, 0))),
                    sq_norms=jnp.pad(jg.sq_norms, (0, pad)),
                    deleted=jnp.pad(jg.deleted, (0, pad)),
                    labels=jnp.pad(jg.labels, ((0, pad), (0, 0))))
    tg.vectors = torch.nn.functional.pad(tg.vectors, (0, 0, 0, pad))
    tg.sq_norms = torch.nn.functional.pad(tg.sq_norms, (0, pad))
    tg.deleted = torch.nn.functional.pad(tg.deleted, (0, pad))
    tg.labels = torch.nn.functional.pad(tg.labels, (0, pad))
    q = np.concatenate([np.zeros((1, 16), np.float32), base[:8] + 0.01])
    exclude = np.zeros(512, bool)
    exclude[40:80] = True
    wd, wi, wl = jax_flat_search_graph(jg, jnp.asarray(q), k=10, exact=True,
                                       exclude=jnp.asarray(exclude))
    d, ids, lab = flat_search_graph(tg, torch.from_numpy(q), k=10, exact=True,
                                    exclude=torch.from_numpy(exclude))
    _check((d, ids), (wd, wi))
    wl = np.asarray(wl)
    np.testing.assert_array_equal(
        lab.numpy().view(np.uint64),
        wl[..., 0].astype(np.uint64) | (wl[..., 1].astype(np.uint64) << 32))
    found = ids.numpy()
    assert (found < 300).all() and not ((found < 30) | ((found >= 40) & (found < 80))).any()


def _three_pass(q, v, sqn, excluded):
    """The l2sq block in three passes over it: the product, doubled, minus
    |x|^2, then the mask."""
    qdt = v.dtype
    s = q.to(qdt).float() @ v.float().T
    s.mul_(2.0).sub_(sqn[None, :])
    return s.masked_fill_(excluded[None, :], float("-inf"))


def _l2sq_case(rng, mask, bf16, n=500, d=24, nq=13):
    v = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32))
    q = torch.from_numpy(rng.standard_normal((nq, d)).astype(np.float32))
    if bf16:
        v = v.to(torch.bfloat16)
    sqn = (v.float() ** 2).sum(1)
    dele = torch.from_numpy(rng.random(n) < 0.2)
    excluded = {"deleted": dele,
                "not_built": torch.arange(n) >= 350,
                "exclude": dele | ((torch.arange(n) >= 40)
                                   & (torch.arange(n) < 80))}[mask]
    return v, q, sqn, excluded


@pytest.mark.parametrize("mask", ["deleted", "not_built", "exclude"])
@pytest.mark.parametrize("block", [None, 96])
@pytest.mark.parametrize("bf16", [False, True])
def test_l2sq_block_matches_three_passes(rng, mask, block, bf16):
    v, q, sqn, excluded = _l2sq_case(rng, mask, bf16)
    n = v.shape[0]
    step = n if block is None else block
    for start in range(0, n, step):
        stop = min(start + step, n)
        got = flat._scores(v[start:stop], sqn[start:stop], q, Metric.L2SQ,
                           excluded=excluded[start:stop])
        want = _three_pass(q, v[start:stop], sqn[start:stop],
                           excluded[start:stop])
        ex = excluded[start:stop][None, :].expand_as(got)
        assert torch.equal(torch.isneginf(got), ex)
        assert torch.isfinite(got[~ex]).all()
        # the same f32 products summed in the GEMM's order: within rounding
        scale = 2.0 * (q.to(v.dtype).float().abs()
                       @ v[start:stop].float().abs().T) + sqn[start:stop]
        tol = v.shape[1] * torch.finfo(torch.float32).eps * scale
        assert ((got - want).abs()[~ex] <= tol[~ex]).all()
    # the scan's ids are the three-pass block's top-k
    d, ids = flat_search(v, sqn, q, k=10, block=block, deleted=excluded)
    full = _three_pass(q, v, sqn, excluded)
    np.testing.assert_array_equal(ids.numpy(),
                                  torch.topk(full, 10, dim=1).indices.numpy())
    assert not excluded[ids.long()].any()


@pytest.mark.parametrize("block", [None, 4])
@pytest.mark.parametrize("bf16", [False, True])
def test_flat_search_fewer_live_rows_than_k(rng, block, bf16):
    """A query with fewer live rows than k: the live rows in order, then
    (inf, -1)."""
    v, q, sqn, _ = _l2sq_case(rng, "deleted", bf16, n=12, d=8, nq=3)
    dele = torch.ones(12, dtype=torch.bool)
    dele[[2, 5, 9]] = False
    d, ids = flat_search(v, sqn, q, k=5, block=block, deleted=dele)
    want = _three_pass(q, v, sqn, dele)
    order = torch.argsort(want[:, [2, 5, 9]], dim=1, descending=True)
    live = torch.tensor([2, 5, 9])[order]
    assert torch.equal(ids[:, :3].long(), live)
    assert torch.isfinite(d[:, :3]).all()
    assert (ids[:, 3:] == -1).all() and torch.isinf(d[:, 3:]).all()


@pytest.mark.parametrize("kind,metric,blocked,blocks", [
    ("f32", Metric.L2SQ, False, 1), ("f32", Metric.L2SQ, True, 4),
    ("bf16", Metric.L2SQ, False, 1), ("pq", Metric.L2SQ, False, 1),
    ("pq", Metric.L2SQ, True, 3), ("f32", Metric.COS, False, 0),
    ("i8", Metric.L2SQ, False, 0), ("i8", Metric.COS, False, 0),
    ("hamming", Metric.HAMMING, False, 0), ("pq", Metric.COS, False, 0)])
def test_l2sq_scores_counts_blocks(rng, monkeypatch, kind, metric, blocked,
                                   blocks):
    """One count per l2sq score block formed by the GEMM's epilogue, none
    where a per-column scale or K4 forms the block."""
    from lantern_tpu_torch.quant.scalar import quantize_i8

    monkeypatch.setattr(flat._l2sq_scores, "blocks", 0)
    q = torch.from_numpy(rng.standard_normal((7, 24)).astype(np.float32))
    dele = torch.from_numpy(rng.random(300) < 0.2)
    if kind == "pq":
        codes = torch.from_numpy(rng.integers(0, 16, (300, 4)).astype(np.uint8))
        cents = torch.from_numpy(
            rng.standard_normal((4, 16, 6)).astype(np.float32))
        flat.flat_search_pq(codes, cents, q, k=5, metric=metric,
                            block=128 if blocked else 1 << 19, deleted=dele)
    elif kind == "hamming":
        w = torch.from_numpy(rng.integers(-2**31, 2**31, (300, 2),
                                          dtype=np.int64).astype(np.int32))
        flat_search(w, torch.zeros(300), w[:7], k=5, metric=metric,
                    deleted=dele)
    else:
        v = torch.from_numpy(rng.standard_normal((300, 24)).astype(np.float32))
        scales = None
        if kind == "i8":
            v, scales = quantize_i8(v)
        elif kind == "bf16":
            v = v.to(torch.bfloat16)
        sqn = (v.float() ** 2).sum(1)
        flat_search(v, sqn, q, k=5, metric=metric, deleted=dele,
                    block=96 if blocked else None, vec_scales=scales)
    assert flat._l2sq_scores.blocks == blocks
