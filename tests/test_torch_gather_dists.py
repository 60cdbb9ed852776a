"""K1: the port's gather-distance kernel against the reference's Pallas one.

On the CPU the wrapper runs its plain version, gather_dists_ref, which is held
against gather_dists_pallas in interpret mode (rtol 1e-5, atol 1e-5: the same
f32 products summed in another order). The tests marked ``cuda`` hold the
CUDA kernel against gather_dists_ref on the card (1e-5 rel + 1e-4 abs) and
skip where there is no card. This module imports jax only inside the CPU
parity test, so ``pytest -m cuda`` runs on a machine without jax.
"""

import numpy as np
import pytest
import torch

from lantern_tpu_torch.config import Metric
from lantern_tpu_torch.ops.gather_dists import gather_dists, gather_dists_ref


@pytest.fixture()
def rng():
    """The conftest's seeded generator, repeated here so that ``pytest
    --noconftest -m cuda`` runs this file on a machine without jax."""
    return np.random.default_rng(0xA47E60DB)


def _inputs(rng, n, d, q, c):
    vecs = rng.standard_normal((n, d)).astype(np.float32)
    ids = rng.integers(0, n, size=(q, c)).astype(np.int32)
    queries = rng.standard_normal((q, d)).astype(np.float32)
    return vecs, ids, queries, (queries * queries).sum(1).astype(np.float32)


@pytest.mark.parametrize("c", [1, 33])
@pytest.mark.parametrize("metric", [Metric.L2SQ, Metric.COS])
@pytest.mark.parametrize("bf16", [False, True])
def test_ref_matches_pallas(rng, c, metric, bf16):
    import jax.numpy as jnp

    from lantern_tpu.ops.pallas_gather import gather_dists_pallas

    vecs, ids, queries, q_sq = _inputs(rng, 200, 24, 37, c)  # 37: not a qb multiple
    jv = jnp.asarray(vecs).astype(jnp.bfloat16) if bf16 else jnp.asarray(vecs)
    want = gather_dists_pallas(jv, jnp.asarray(ids), jnp.asarray(queries),
                               jnp.asarray(q_sq), metric=int(metric), qb=16,
                               interpret=True)
    tv = torch.from_numpy(vecs)
    tv = tv.to(torch.bfloat16) if bf16 else tv
    args = (tv, torch.from_numpy(ids), torch.from_numpy(queries),
            torch.from_numpy(q_sq), metric)
    gather_dists.launches = 0
    got = gather_dists(*args)
    assert gather_dists.launches == 0  # CPU tensors: plain version, no launch
    np.testing.assert_array_equal(got.numpy(), gather_dists_ref(*args).numpy())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_rejects_hamming(rng):
    vecs, ids, queries, q_sq = map(torch.from_numpy, _inputs(rng, 10, 8, 2, 3))
    with pytest.raises(ValueError, match="HAMMING"):
        gather_dists(vecs, ids, queries, q_sq, Metric.HAMMING)


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("d", [128, 100, 130, 7])  # 16-byte rows, bf16 tail, scalar
@pytest.mark.parametrize("c", [1, 32, 33])
@pytest.mark.parametrize("metric", [Metric.L2SQ, Metric.COS])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_ref_on_card(rng, cuda, d, c, metric, dtype):
    vecs, ids, queries, q_sq = _inputs(rng, 5000, d, 67, c)
    args = (torch.from_numpy(vecs).to(cuda, dtype), torch.from_numpy(ids).to(cuda),
            torch.from_numpy(queries).to(cuda), torch.from_numpy(q_sq).to(cuda),
            metric)
    before = gather_dists.launches
    got = gather_dists(*args)
    torch.cuda.synchronize()
    assert gather_dists.launches == before + 1
    want = gather_dists_ref(*args)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)


@pytest.mark.cuda
def test_kernel_rejects_bad_inputs_on_card(rng, cuda):
    vecs, ids, queries, q_sq = _inputs(rng, 100, 16, 4, 5)
    v = torch.from_numpy(vecs).to(cuda)
    with pytest.raises(ValueError, match="int32"):
        gather_dists(v, torch.from_numpy(ids).long().to(cuda),
                     torch.from_numpy(queries).to(cuda),
                     torch.from_numpy(q_sq).to(cuda))
    with pytest.raises(ValueError, match="ids is on"):
        gather_dists(v, torch.from_numpy(ids), torch.from_numpy(queries).to(cuda),
                     torch.from_numpy(q_sq).to(cuda))
