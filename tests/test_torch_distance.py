"""Parity: the port's ops/distance.py against lantern_tpu's (rtol 1e-5; the
hamming and bit-packing results are integers and compared exactly). The
port's packed words are int32 tensors carrying the uint32 bits."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lantern_tpu.ops import distance as jd
from lantern_tpu_torch.ops import distance as td
from lantern_tpu_torch.ops import hamming as th

RTOL, ATOL = 1e-5, 1e-5


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("name", ["l2sq_dist", "cos_dist"])
def test_pair_distances(rng, name):
    a = rng.standard_normal((9, 33)).astype(np.float32)
    b = rng.standard_normal((9, 33)).astype(np.float32)
    np.testing.assert_allclose(getattr(td, name)(_t(a), _t(b)).numpy(),
                               np.asarray(getattr(jd, name)(a, b)),
                               rtol=RTOL, atol=ATOL)


def test_hamming_and_popcount(rng):
    a = rng.integers(0, 2**32, size=(7, 5), dtype=np.uint32)
    b = rng.integers(0, 2**32, size=(7, 5), dtype=np.uint32)
    want = np.asarray(jd.hamming_dist(a, b))
    np.testing.assert_array_equal(
        td.hamming_dist(_t(a.astype(np.int64)), _t(b.astype(np.int64))).numpy(),
        want)
    np.testing.assert_array_equal(
        td.hamming_dist(_t(a.view(np.int32)), _t(b.view(np.int32))).numpy(), want)
    np.testing.assert_array_equal(
        th._popcount_u32(_t(a.astype(np.int64))).numpy(),
        np.asarray(jd._popcount_u32(jnp.asarray(a))))


@pytest.mark.parametrize("metric", [1, 3, 8])
def test_pairwise_dist(rng, metric):
    if metric == 8:
        q = rng.integers(0, 2**32, size=(6, 3), dtype=np.uint32)
        b = rng.integers(0, 2**32, size=(40, 3), dtype=np.uint32)
        want = np.asarray(jd.pairwise_dist(q, b, metric))
        got = td.pairwise_dist(_t(q.view(np.int32)), _t(b.view(np.int32)),
                               metric)
        np.testing.assert_array_equal(got.numpy(), want)
        got = td.pairwise_dist(_t(q.astype(np.int64)), _t(b.astype(np.int64)),
                               metric)
        np.testing.assert_array_equal(got.numpy(), want)
        return
    q = rng.standard_normal((6, 20)).astype(np.float32)
    b = rng.standard_normal((40, 20)).astype(np.float32)
    np.testing.assert_allclose(td.pairwise_dist(_t(q), _t(b), metric).numpy(),
                               np.asarray(jd.pairwise_dist(q, b, metric)),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("metric,block", [(3, 65536), (3, 64), (1, 64)])
def test_exact_search(rng, metric, block):
    q = rng.standard_normal((11, 16)).astype(np.float32)
    b = rng.standard_normal((300, 16)).astype(np.float32)
    d, i = td.exact_search(_t(q), _t(b), 7, metric, block=block)
    wd, wi = jd.exact_search(jnp.asarray(q), jnp.asarray(b), 7, metric,
                             block=block)
    np.testing.assert_array_equal(i.numpy(), np.asarray(wi))
    np.testing.assert_allclose(d.numpy(), np.asarray(wd), rtol=RTOL, atol=ATOL)


def test_exact_search_k_above_n_and_empty(rng):
    q = rng.standard_normal((3, 8)).astype(np.float32)
    b = rng.standard_normal((5, 8)).astype(np.float32)
    d, i = td.exact_search(_t(q), _t(b), 9)
    assert d.shape == (3, 5) and sorted(i[0].tolist()) == list(range(5))
    d, i = td.exact_search(_t(q), _t(b[:0]), 4)
    assert d.shape == (3, 0) and i.shape == (3, 0)


def test_exact_search_refuses_tf32(rng, monkeypatch):
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    with pytest.raises(RuntimeError, match="allow_tf32"):
        td.exact_search(_t(np.ones((1, 4), np.float32)),
                        _t(np.ones((3, 4), np.float32)), 1)


def test_pack_unpack_bits(rng):
    x = rng.standard_normal((4, 70)).astype(np.float32)
    packed = td.pack_bits(_t(x))
    assert packed.dtype == torch.int32
    np.testing.assert_array_equal(packed.numpy().view(np.uint32),
                                  np.asarray(jd.pack_bits(jnp.asarray(x))))
    np.testing.assert_array_equal(td.unpack_bits(packed, 70).numpy(),
                                  np.asarray(jd.unpack_bits(jd.pack_bits(
                                      jnp.asarray(x)), 70)))
