"""K4: the port's hamming kernel against the reference's Pallas one.

On the CPU the wrapper runs its plain version, hamming_block_ref, which is
held against hamming_block in interpret mode exactly (the counts are
integers), at Q and N that are no tile multiples, W = 1, 3, 4, 32, 48 and
128 words, and words >= 2^31 (negative as int32). hamming_scores (the flat
scan's negated, tombstone-masked block) is held exactly to the reference's
``_hamming_scores`` plus its ``jnp.where`` mask, with no mask, a ragged one
and an all-deleted one. hamming_exact_topk is held to the reference's:
distances exactly equal, ids equal up to the order of tied distances. The
tests marked ``cuda`` hold the CUDA kernel (both epilogues) bit-equal to the
plain versions on the card, at tile edges and an unaligned row slice, and
skip where there is no card. This module imports jax only inside the CPU
parity tests, so ``pytest -m cuda`` runs on a machine without jax.
"""

import numpy as np
import pytest
import torch

from lantern_tpu_torch.ops import hamming as th
from lantern_tpu_torch.ops.distance import exact_search, pairwise_dist
from lantern_tpu_torch.ops.hamming import (
    hamming_block,
    hamming_block_ref,
    hamming_exact_topk,
    hamming_scores,
    hamming_scores_ref,
)


@pytest.fixture()
def rng():
    """The conftest's seeded generator, repeated here so that ``pytest
    --noconftest -m cuda`` runs this file on a machine without jax."""
    return np.random.default_rng(0xA47E60DB)


# (Q, N, W): ragged Q and N; 1, 3, 4 words; 1024, 1536 and 4096 bits
SHAPES = [(37, 333, 1), (5, 130, 3), (17, 257, 4), (9, 140, 32), (3, 129, 48),
          (2, 70, 128)]
# the CUDA kernel's tile edges: 64 queries a warpgroup tile, 128 base rows a
# block, 32 words kept expanded (33 takes a second chunk); Q and N one under
# and one over
EDGE_SHAPES = [(q, n, w) for w in (1, 3, 32, 33, 128)
               for q, n in ((63, 127), (65, 129))]
MASKS = ["none", "ragged", "all"]


def _mask(rng, kind, n):
    """No mask, a ragged one (about a third of the rows) or all deleted."""
    if kind == "none":
        return None
    return np.ones(n, bool) if kind == "all" else rng.random(n) < 0.3


def _words(rng, rows, w):
    """uint32 words (about half >= 2^31) and their int32 view."""
    u = rng.integers(0, 2**32, size=(rows, w), dtype=np.uint32)
    return u, torch.from_numpy(u.view(np.int32))


def _naive(q, b):
    """numpy popcount by byte table: [Q, W] x [N, W] uint32 -> [Q, N]."""
    table = np.array([bin(i).count("1") for i in range(256)], np.int64)
    x = np.bitwise_xor(q[:, None, :], b[None, :, :]).view(np.uint8)
    return table[x].sum(-1).astype(np.float32)


@pytest.mark.parametrize("shape", SHAPES, ids=[f"{q}x{n}x{w}" for q, n, w in SHAPES])
def test_ref_matches_pallas(rng, shape):
    import jax.numpy as jnp

    from lantern_tpu.ops.pallas_kernels import hamming_block as jax_hamming_block

    nq, n, w = shape
    qu, qt = _words(rng, nq, w)
    bu, bt = _words(rng, n, w)
    assert (qu >= 2**31).any() and (bu >= 2**31).any()
    want = np.asarray(jax_hamming_block(jnp.asarray(qu), jnp.asarray(bu),
                                        interpret=True))
    hamming_block.launches = 0
    got = hamming_block(qt, bt)
    assert hamming_block.launches == 0  # CPU tensors: plain version, no launch
    assert got.dtype == torch.float32 and got.shape == (nq, n)
    np.testing.assert_array_equal(got.numpy(), want)
    # the same words as int64 values (unsigned) count the same
    np.testing.assert_array_equal(
        hamming_block_ref(torch.from_numpy(qu.astype(np.int64)),
                          torch.from_numpy(bu.astype(np.int64))).numpy(), want)
    np.testing.assert_array_equal(pairwise_dist(qt, bt, 8).numpy(), want)


@pytest.mark.parametrize("mask", MASKS)
@pytest.mark.parametrize("shape", SHAPES[:3] + [(9, 140, 32)],
                         ids=lambda s: "x".join(map(str, s)))
def test_scores_match_reference(rng, shape, mask):
    """hamming_scores == the reference flat scan's _hamming_scores plus its
    tombstone mask (lantern_tpu/flat.py:78-84, 223-224), exactly."""
    import jax.numpy as jnp

    from lantern_tpu.flat import _hamming_scores

    nq, n, w = shape
    qu, qt = _words(rng, nq, w)
    bu, bt = _words(rng, n, w)
    dele = _mask(rng, mask, n)
    want = _hamming_scores(jnp.asarray(bu), jnp.asarray(qu))
    if dele is not None:
        want = jnp.where(jnp.asarray(dele)[None, :], -jnp.inf, want)
    hamming_block.launches = 0
    got = hamming_scores(qt, bt, None if dele is None else torch.from_numpy(dele))
    assert hamming_block.launches == 0  # CPU tensors: plain version
    assert got.dtype == torch.float32 and got.shape == (nq, n)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert np.array_equal(np.signbit(got.numpy()), np.signbit(np.asarray(want)))


@pytest.mark.parametrize("mask", MASKS)
def test_flat_scan_matches_reference(rng, mask):
    """The hamming flat scan (hamming_scores inside) against the reference's
    flat_search: distances exactly, ids up to ties, tombstones never
    returned; an all-deleted table returns (inf, -1) everywhere."""
    import jax.numpy as jnp

    from lantern_tpu.flat import flat_search as jax_flat_search
    from lantern_tpu_torch.config import Metric
    from lantern_tpu_torch.flat import flat_search

    centres = rng.integers(0, 2**32, (8, 3), dtype=np.uint32)
    flips = [rng.integers(0, 2**32, (300, 3), dtype=np.uint32) for _ in range(3)]
    v = centres[rng.integers(0, 8, 300)] ^ (flips[0] & flips[1] & flips[2])
    q = v[rng.integers(0, 300, 11)] ^ np.uint32(0x80000001)
    dele = _mask(rng, mask, 300)
    jd = None if dele is None else jnp.asarray(dele)
    td = None if dele is None else torch.from_numpy(dele)
    wd, wi = jax_flat_search(jnp.asarray(v), jnp.zeros(300), jnp.asarray(q),
                             k=10, metric=int(Metric.HAMMING), exact=True,
                             deleted=jd)
    d, ids = flat_search(torch.from_numpy(v.view(np.int32)), torch.zeros(300),
                         torch.from_numpy(q.view(np.int32)), k=10,
                         metric=Metric.HAMMING, exact=True, deleted=td)
    d, ids, wd, wi = d.numpy(), ids.numpy(), np.asarray(wd), np.asarray(wi)
    if mask == "all":
        assert (ids == -1).all() and (wi == -1).all()
        assert np.isinf(d).all() and np.isinf(wd).all()
        return
    _assert_topk_equal(d, ids.astype(np.int64), wd, wi, _naive(q, v))
    if dele is not None:
        assert not dele[ids].any()


def test_ref_chunks_its_intermediate(rng, monkeypatch):
    """A chunk of a few rows gives the same block as one chunk."""
    qu, qt = _words(rng, 7, 5)
    bu, bt = _words(rng, 101, 5)
    monkeypatch.setattr(th, "_REF_CHUNK_ELEMS", 7 * 5 * 3)  # 3 rows a chunk
    np.testing.assert_array_equal(hamming_block_ref(qt, bt).numpy(),
                                  _naive(qu, bu))


def _assert_topk_equal(d, ids, want_d, want_ids, full):
    """Distances exactly equal; each id's true distance equals its slot's,
    and the ids strictly closer than the k-th distance agree as sets."""
    np.testing.assert_array_equal(d, want_d)
    np.testing.assert_array_equal(np.take_along_axis(full, ids, 1), d)
    for row, wrow, drow in zip(ids, want_ids, d):
        assert len(set(row.tolist())) == len(row)
        inner = drow < drow[-1]
        assert set(row[inner].tolist()) == set(wrow[inner].tolist())


@pytest.mark.parametrize("block_n", [128, 65536])
def test_exact_topk_matches_reference(rng, block_n):
    import jax.numpy as jnp

    from lantern_tpu.ops.pallas_kernels import (
        hamming_exact_topk as jax_hamming_exact_topk,
    )

    qu, qt = _words(rng, 6, 2)
    bu, bt = _words(rng, 500, 2)
    wd, wi = jax_hamming_exact_topk(jnp.asarray(qu), jnp.asarray(bu), k=7,
                                    block_n=block_n, interpret=True)
    d, ids = hamming_exact_topk(qt, bt, 7, block_n=block_n)
    assert ids.dtype == torch.int32 and d.shape == (6, 7)
    _assert_topk_equal(d.numpy(), ids.numpy(), np.asarray(wd), np.asarray(wi),
                       _naive(qu, bu))
    # exact_search takes the hamming metric by its number too
    d2, i2 = exact_search(qt, bt, 7, 8, block=block_n)
    np.testing.assert_array_equal(d2.numpy(), d.numpy())
    np.testing.assert_array_equal(i2.numpy(), ids.numpy())


def test_exact_topk_k_above_n_and_empty(rng):
    _, qt = _words(rng, 3, 2)
    bu, bt = _words(rng, 5, 2)
    d, ids = hamming_exact_topk(qt, bt, 9, block_n=2)
    assert d.shape == (3, 5) and sorted(ids[0].tolist()) == list(range(5))
    d, ids = hamming_exact_topk(qt, bt[:0], 4)
    assert d.shape == (3, 0) and ids.shape == (3, 0)


def test_rejects_mismatched_widths(rng):
    _, qt = _words(rng, 3, 2)
    _, bt = _words(rng, 5, 3)
    with pytest.raises(ValueError, match="W"):
        hamming_block(qt, bt)


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize(
    "shape", SHAPES + EDGE_SHAPES + [(1024, 70_001, 32), (130, 4099, 7)],
    ids=lambda s: "x".join(map(str, s)))
def test_kernel_matches_ref_on_card(rng, cuda, shape):
    nq, n, w = shape
    _, qt = _words(rng, nq, w)
    _, bt = _words(rng, n, w)
    q, b = qt.to(cuda), bt.to(cuda)
    before = hamming_block.launches
    got = hamming_block(q, b)
    torch.cuda.synchronize()
    assert hamming_block.launches == before + 1
    assert torch.equal(got, hamming_block_ref(q, b))  # bit-equal
    # base words one word past a 16-byte boundary take the word-by-word loads
    shifted = torch.empty(n * w + 1, dtype=torch.int32, device=cuda)[1:]
    shifted = shifted.view(n, w)
    shifted.copy_(b)
    assert shifted.data_ptr() % 16 != 0
    assert torch.equal(hamming_block(q, shifted), got)


@pytest.mark.cuda
@pytest.mark.parametrize("mask", MASKS)
@pytest.mark.parametrize("shape", SHAPES + EDGE_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_scores_kernel_matches_ref_on_card(rng, cuda, shape, mask):
    nq, n, w = shape
    _, qt = _words(rng, nq, w)
    _, bt = _words(rng, n + 5, w)
    dele = _mask(rng, mask, n)
    dele = None if dele is None else torch.from_numpy(dele).to(cuda)
    q = qt.to(cuda)
    # a row slice of a larger table, as the flat scan passes it: five rows
    # in, so an odd offset of words from the allocation
    b = bt.to(cuda)[5:]
    before = hamming_block.launches
    got = hamming_scores(q, b, dele)
    torch.cuda.synchronize()
    assert hamming_block.launches == before + 1  # one launch: no extra pass
    want = hamming_scores_ref(q, b, dele)
    assert torch.equal(got, want)  # bit-equal, -inf included
    assert torch.equal(torch.signbit(got), torch.signbit(want))


@pytest.mark.cuda
def test_exact_topk_on_card(rng, cuda):
    qu, qt = _words(rng, 64, 32)
    bu, bt = _words(rng, 20_000, 32)
    d, ids = hamming_exact_topk(qt.to(cuda), bt.to(cuda), 10, block_n=4096)
    full = _naive(qu, bu)
    want = np.sort(full, 1)[:, :10]
    _assert_topk_equal(d.cpu().numpy(), ids.cpu().numpy().astype(np.int64),
                       want, np.argsort(full, 1, kind="stable")[:, :10], full)


@pytest.mark.cuda
def test_kernel_rejects_bad_inputs_on_card(rng, cuda):
    _, qt = _words(rng, 4, 4)
    _, bt = _words(rng, 9, 4)
    with pytest.raises(ValueError, match="int32"):
        hamming_block(qt.long().to(cuda), bt.to(cuda))
    with pytest.raises(ValueError, match="queries are on"):
        hamming_block(qt, bt.to(cuda))
    with pytest.raises(ValueError, match="deleted"):
        hamming_scores(qt.to(cuda), bt.to(cuda),
                       torch.zeros(9, dtype=torch.uint8, device=cuda))
    with pytest.raises(ValueError, match="deleted"):
        hamming_scores(qt.to(cuda), bt.to(cuda),
                       torch.zeros(8, dtype=torch.bool, device=cuda))
