"""Parity: the port's quant/pq.py against lantern_tpu/quant/pq.py.

The two packages draw their k-means inits from different generators, so
training is held to the reference in three ways:
- the same Lloyd iterations from a shared init: centroids within 1e-4;
- the same OPQ alternation from the reference's own init (its
  jax.random.choice draw, recomputed here): rotation and centroids within
  1e-3;
- whole training from each package's own init: quantisation MSE at most
  1.05x the reference's, plain and OPQ.
Given the same codebook, encode gives equal codes, pq_decode equal rows, and
the ADC tables and sums agree within 1e-5 (f32 sums in another order). The
port-trained OPQ-16 codebook reaches the pq_rerank golden recall on the
pinned 10k fixture.
"""

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lantern_tpu.config import Metric
from lantern_tpu.quant import pq as ref
from lantern_tpu_torch.quant import pq as port

FIXTURES = pathlib.Path(__file__).parent / "fixtures"


def _clustered(seed, n=600, dim=16, centers=16):
    """Rotated clusters: well-separated assignments, correlated dims."""
    rng = np.random.default_rng(seed)
    c = rng.standard_normal((centers, dim)).astype(np.float32) * 3
    x = c[rng.integers(0, centers, n)] + 0.3 * rng.standard_normal((n, dim))
    mix, _ = np.linalg.qr(rng.standard_normal((dim, dim)))
    return (x @ mix).astype(np.float32)


def _correlated(seed, n=1500, dim=32):
    """The reference tests' correlated data: scaled gaussian, rotated."""
    rng = np.random.default_rng(seed)
    z = rng.standard_normal((n, dim)).astype(np.float32)
    scales = np.geomspace(4.0, 0.1, dim).astype(np.float32)
    mix, _ = np.linalg.qr(rng.standard_normal((dim, dim)).astype(np.float32))
    return ((z * scales) @ mix.astype(np.float32)).astype(np.float32)


def _split(x, s):
    n, dim = x.shape
    return np.ascontiguousarray(x.reshape(n, s, dim // s).transpose(1, 0, 2))


def _jax_init(x, s, k, seed):
    """The reference's init draw (_train_jit / _train_opq_jit)."""
    n = len(x)
    idx = np.asarray(jax.random.choice(jax.random.PRNGKey(seed), n,
                                       shape=(k,), replace=n < k))
    return np.ascontiguousarray(_split(x, s)[:, idx, :])


def _cb(centroids, rotation=None):
    return (ref.PQCodebook(centroids=centroids, rotation=rotation),
            port.PQCodebook(centroids=centroids, rotation=rotation))


@pytest.mark.parametrize("iters", [1, 10])
def test_lloyd_matches_reference_from_shared_init(iters):
    x = _clustered(2)
    s, k = 4, 8
    init = _jax_init(x, s, k, seed=2)
    want = jax.vmap(ref._kmeans_one_subspace, in_axes=(0, 0, None))(
        jnp.asarray(_split(x, s)), jnp.asarray(init), iters)
    got = port._kmeans(torch.from_numpy(_split(x, s)), torch.from_numpy(init),
                       iters)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def test_opq_matches_reference_from_shared_init():
    # data without assignment near-ties: one flipped argmin sends the
    # alternation down another path (seed 3 of _clustered does that)
    x = _clustered(1)
    s, k, iters, opq_iters = 4, 8, 5, 4
    want_c, want_r = ref._train_opq_jit(jnp.asarray(x), 1, s, k, iters,
                                        opq_iters)
    got_c, got_r = port._train_opq(
        torch.from_numpy(x), torch.from_numpy(_jax_init(x, s, k, seed=1)),
        iters, opq_iters)
    np.testing.assert_allclose(got_r.numpy(), np.asarray(want_r), atol=1e-3)
    np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c), atol=1e-3)


@pytest.mark.parametrize("rotate", [False, True])
def test_training_quality_matches_reference(rotate):
    x = _correlated(0)
    kw = dict(num_subvectors=8, num_centroids=16, iters=20, seed=0,
              rotate=rotate, opq_iters=8)
    cbj = ref.train_codebook(x, **kw)
    cbp = port.train_codebook(x, device="cpu", **kw)
    assert cbp.centroids.shape == (8, 16, 4) and cbp.centroids.dtype == np.float32
    if rotate:
        np.testing.assert_allclose(cbp.rotation @ cbp.rotation.T, np.eye(32),
                                   atol=1e-4)
    else:
        assert cbp.rotation is None
    mse_ref = np.mean((ref.pq_decode(ref.pq_encode(x, cbj), cbj) - x) ** 2)
    mse = np.mean((port.pq_decode(port.pq_encode(x, cbp, device="cpu"), cbp)
                   - x) ** 2)
    assert mse <= 1.05 * mse_ref, (mse, mse_ref)


def test_init_is_seeded_sample():
    a, b = port.init_rows(100, 16, 5), port.init_rows(100, 16, 5)
    assert torch.equal(a, b) and len(set(a.tolist())) == 16
    assert len(port.init_rows(4, 16, 5)) == 16  # with replacement when n < K


def test_training_rejects_bad_shapes():
    x = np.zeros((10, 9), np.float32)
    with pytest.raises(ValueError, match="divisible"):
        port.train_codebook(x, 2, device="cpu")
    with pytest.raises(ValueError, match="256"):
        port.train_codebook(x, 3, num_centroids=300, device="cpu")


@pytest.mark.parametrize("rotate", [False, True])
def test_encode_decode_match_reference(rotate):
    x = _correlated(1, n=400)
    cbj = ref.train_codebook(x, num_subvectors=8, num_centroids=32, iters=5,
                             rotate=rotate, opq_iters=3)
    cbj, cbp = _cb(np.asarray(cbj.centroids), cbj.rotation)
    codes = port.pq_encode(x, cbp, device="cpu")
    assert codes.dtype == np.uint8 and codes.shape == (400, 8)
    np.testing.assert_array_equal(codes, ref.pq_encode(x, cbj))
    np.testing.assert_array_equal(port.pq_decode(codes, cbp),
                                  ref.pq_decode(codes, cbj))


@pytest.mark.parametrize("metric", [Metric.L2SQ, Metric.COS])
# the reference's one-shot and subspace-scanned ADC (q*c*s*k above 2^27)
@pytest.mark.parametrize("q,c,k", [(5, 7, 32), (64, 2048, 256)])
def test_adc_matches_reference(rng, metric, q, c, k):
    s, dsub = 8, 4
    cents = rng.standard_normal((s, k, dsub)).astype(np.float32)
    queries = rng.standard_normal((q, s * dsub)).astype(np.float32)
    codes = rng.integers(0, k, (q, c, s)).astype(np.int32)
    want_lut = ref.adc_lut(jnp.asarray(queries), jnp.asarray(cents), metric)
    lut = port.adc_lut(torch.from_numpy(queries), torch.from_numpy(cents),
                       metric)
    np.testing.assert_allclose(lut.numpy(), np.asarray(want_lut), rtol=1e-5,
                               atol=1e-5)
    want = ref.adc_distances(want_lut, jnp.asarray(codes))
    got = port.adc_distances(lut, torch.from_numpy(codes.astype(np.uint8)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_port_opq_codebook_reaches_golden_recall():
    """OPQ-16 trained by the port on the pinned 10k x 128 fixture, then the
    port's ADC shortlist of 100 and exact rerank: recall@10 >= 0.779 - 0.01
    (the reference's pq_rerank golden, test_recall_golden.py)."""
    from lantern_tpu.io.dotvecs import parse_fvecs
    from lantern_tpu_torch.flat import flat_search_pq_rerank

    base = parse_fvecs(str(FIXTURES / "golden_base.fvecs.gz"))
    queries = parse_fvecs(str(FIXTURES / "golden_query.fvecs.gz"))
    b_sq = np.einsum("nd,nd->n", base, base)
    gt = np.argsort(b_sq[None, :] - 2.0 * (queries @ base.T), axis=1,
                    kind="stable")[:, :10]
    cb = port.train_codebook(base, num_subvectors=16, num_centroids=256,
                             iters=10, seed=0, rotate=True, opq_iters=8,
                             device="cpu")
    codes = port.pq_encode(base, cb, device="cpu")
    _, ids = flat_search_pq_rerank(
        torch.from_numpy(codes), torch.from_numpy(cb.centroids),
        torch.from_numpy(base), torch.from_numpy(queries), k=10,
        shortlist=100, rotation=torch.from_numpy(cb.rotation))
    hits = sum(len(set(f.tolist()) & set(t.tolist()))
               for f, t in zip(ids.numpy(), gt))
    assert hits / gt.size >= 0.779 - 0.01
