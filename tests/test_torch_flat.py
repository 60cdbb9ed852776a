"""Parity: the port's flat scan against lantern_tpu's flat_search(exact=True).

Ids equal; distances within 1e-4 abs + 1e-5 rel (the same f32 scores summed
in another order). Covers tombstones, unfilled capacity rows, exclude, cos,
bf16 rows, i8 codes with per-row scales, the blocked merge (block < n) and
k > n. Hamming scans (int32 words against the reference's uint32 words)
return exactly equal distances and ids equal up to the order of tied
distances, ties at the k-th place included.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lantern_tpu.flat import flat_search as jax_flat_search
from lantern_tpu.flat import flat_search_graph as jax_flat_search_graph
from lantern_tpu.graph.device import to_device as jax_to_device
from lantern_tpu.native import NativeHnsw as JaxNativeHnsw
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
