"""The exact row top-k (``ops/row_topk.py``, ``csrc/row_topk.cu``) and the
flat scan's selects through it (``flat._blocked_flat_topk``).

On the CPU: the plain version's values equal a float64 sort and its
positions the lowest-position choice among ties, over k in {1, 10, 128,
1024} and blocks that are ragged, narrower than k, all equal, masked to
fewer finite entries than k, holding NaN, +-inf and signed zeros, or sorted
ascending (every entry beats the ones before it); the blocked scan (several
blocks, so the running merge runs) returns the same ids as one block; the
plain version's row groups; the launch plan's invariants; and the JAX
reference's flat search gives the same ids where its distances tie. On the
card (``cuda``, skipped without one): the kernel bit-equal to the plain
version over the same blocks, also at k = 1025 and 2400 (several launches,
each below the last one's k-th; "under_k" selects whole rows so), and at
the cells' [1024, 1M] shape (scores from ``portbench``'s data makers) at
k = 10 and 128, one launch a flat search and no ``torch.topk`` on a CUDA
block. Imports jax only inside the reference's test: the card's tests run
with ``--noconftest``.
"""

import contextlib

import numpy as np
import pytest
import torch

from lantern_tpu_torch import flat
from lantern_tpu_torch.config import Metric
from lantern_tpu_torch.ops import row_topk as rt
from portbench import spec

KS = [1, 10, 128, 1024]
CASES = ["random", "ragged", "under_k", "all_equal", "few_finite", "nan",
         "ascending", "integers", "signed_zeros"]


def _block(case: str, k: int, q: int = 5, seed: int = 0) -> torch.Tensor:
    """A [q, n] f32 block of the named kind, sized from k."""
    g = torch.Generator().manual_seed(seed * 1009 + k)
    n = {"ragged": 3 * k + 4099, "under_k": max(1, k // 2 + 3)}.get(
        case, max(4 * k, 2000) + 1)
    s = torch.randn((q, n), generator=g)
    if case == "all_equal":
        s.fill_(0.5)
    elif case == "few_finite":  # fewer finite entries than k in every row
        keep = torch.rand((q, n), generator=g) < (k // 2) / n
        s = s.masked_fill(~keep, float("-inf"))
    elif case == "nan":
        r = torch.rand((q, n), generator=g)
        s[r < 0.01] = float("nan")
        s[(r >= 0.01) & (r < 0.02)] = float("inf")
        s[(r >= 0.02) & (r < 0.05)] = float("-inf")
    elif case == "ascending":
        s = torch.arange(n, dtype=torch.float32).repeat(q, 1)
    elif case == "integers":  # ties everywhere, as hamming scores have them
        s = -torch.randint(0, 24, (q, n), generator=g).float()
    elif case == "signed_zeros":
        s = torch.where(torch.rand((q, n), generator=g) < 0.5,
                        torch.tensor(0.0), torch.tensor(-0.0))
        s[:, ::7] = -1.0
    return s


def _order(scores: torch.Tensor) -> np.ndarray:
    """Each row's positions, best first, from a float64 sort: NaN first,
    then larger scores, equal ones (-0.0 == +0.0) in ascending position."""
    v = scores.double().numpy()
    nan = np.isnan(v)
    key = np.where(nan, 0.0, -v)
    pos = np.broadcast_to(np.arange(v.shape[1]), v.shape)
    return np.stack([np.lexsort((p, kk, ~nn)) for p, kk, nn in
                     zip(pos, key, nan)])


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous().view(torch.int32)


def _check_select(values, positions, scores, k):
    want = torch.from_numpy(_order(scores)[:, :k].copy())
    assert positions.dtype == torch.int64
    assert torch.equal(positions.cpu(), want)
    # the values are the block's own entries, bit for bit (NaN included)
    assert torch.equal(_bits(values.cpu()),
                       _bits(torch.gather(scores, 1, want)))


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("case", CASES)
def test_ref_is_the_float64_order_with_lower_positions_first(case, k):
    s = _block(case, k)
    kk = min(k, s.shape[1])
    values, positions = rt.row_topk(s, kk)
    _check_select(values, positions, s, kk)


def _blocked(scores, k, block):
    """``_blocked_flat_topk`` over a fixed block (hamming: dist = -score)."""
    q, n = scores.shape
    return flat._blocked_flat_topk(
        lambda start, stop: scores[:, start:stop], n, min(k, n), k, block,
        torch.zeros(q), Metric.HAMMING)


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("case", CASES)
def test_blocked_scan_merges_to_the_same_ids(case, k):
    s = _block(case, k, seed=1)
    n = s.shape[1]
    block = max(1, n // 3 - 5)  # several ragged blocks: the merge runs
    d, ids = _blocked(s, k, block)
    kk = min(k, n)
    pos = torch.from_numpy(_order(s)[:, :kk].copy())
    top = torch.gather(s, 1, pos)
    finite = torch.isfinite(top)
    want_ids = torch.where(finite, pos, -1).int()
    assert torch.equal(ids[:, :kk], want_ids)
    assert torch.equal(d[:, :kk], torch.where(finite, -top, float("inf")))
    assert (ids[:, kk:] == -1).all() and torch.isinf(d[:, kk:]).all()
    one = _blocked(s, k, n)
    assert torch.equal(one[1], ids) and torch.equal(one[0], d)


def test_ref_in_row_groups_equals_one_group(monkeypatch):
    """The plain version keys a few rows at a time; the groups' edges
    change nothing."""
    s = _block("integers", 10, q=11)
    whole = rt.row_topk_ref(s, 37)
    monkeypatch.setattr(rt, "_REF_GROUP", 3 * s.shape[1] - 1)  # 2 rows a group
    parts = rt.row_topk_ref(s, 37)
    assert torch.equal(parts[1], whole[1])
    assert torch.equal(_bits(parts[0]), _bits(whole[0]))
    _check_select(*parts, s, 37)


@pytest.mark.parametrize("step", [1024, 4096])
@pytest.mark.parametrize("q", [1, 7, 1024, 100_000])
@pytest.mark.parametrize("n,k", [(n, k) for n in (1, 5, 4096, 4097, 1_000_000,
                                                  3_000_001)
                                 for k in (1, 10, 128, 129, 1024) if k <= n])
def test_plan_covers_the_row_within_the_kernel_limits(q, n, k, step):
    p = rt.plan(q, n, k, step)
    assert p.kp >= k and p.kp & (p.kp - 1) == 0
    assert p.cap >= 2 * p.kp and p.cap & (p.cap - 1) == 0 and p.cap * 8 <= 48 * 1024
    assert p.slice_len % step == 0
    assert (p.slices - 1) * p.slice_len < n <= p.slices * p.slice_len
    assert p.slices * p.kp <= p.merge <= rt.MERGE_MAX
    assert p.merge & (p.merge - 1) == 0 and p.merge_threads <= 1024
    assert q * p.slices < 2 ** 31


def test_row_topk_refuses_what_it_does_not_take():
    s = torch.zeros((3, 8))
    for bad in (s.double(), s[0], s.to(torch.bfloat16)):
        with pytest.raises(ValueError):
            rt.row_topk(bad, 2)
    for k in (-1, 9):
        with pytest.raises(ValueError):
            rt.row_topk(s, k)


def _words(rng, n, w):
    return rng.integers(0, 2 ** 32, (n, w), dtype=np.uint64).astype(np.uint32)


@pytest.mark.parametrize("k", [1, 10, 128])
def test_reference_flat_search_gives_the_same_ids_on_ties(k):
    """32-bit hamming rows: distances tie as a rule, and a k-th place is
    cut inside a tie. The JAX reference (``jax.lax.top_k``, lower index
    first) keeps the same ids as the port, with the rows' duplicates and a
    tombstone mask; the port returns them in ascending id inside a tie."""
    import jax.numpy as jnp

    from lantern_tpu.flat import flat_search as jax_flat_search

    rng = np.random.default_rng(k)
    v = _words(rng, 3000, 1)
    v[1500:1600] = v[:100]  # exact duplicates: equal distances, other ids
    q = _words(rng, 16, 1)
    dele = rng.random(3000) < 0.1
    want = jax_flat_search(jnp.asarray(v), jnp.zeros(3000), jnp.asarray(q),
                           k=k, metric=int(Metric.HAMMING), exact=True,
                           deleted=jnp.asarray(dele))
    got = flat.flat_search(torch.from_numpy(v.view(np.int32)),
                           torch.zeros(3000), torch.from_numpy(q.view(np.int32)),
                           k=k, metric=Metric.HAMMING,
                           deleted=torch.from_numpy(dele))
    wd, wi = np.asarray(want[0]), np.asarray(want[1])
    np.testing.assert_array_equal(got[0].numpy(), wd)
    # the same ids; the reference's last sort is unstable, so its order
    # inside a tie is its own: its ids sorted by (distance, id) are the port's
    order = np.lexsort((wi, wd), axis=1)
    np.testing.assert_array_equal(got[1].numpy(),
                                  np.take_along_axis(wi, order, 1))
    # the k-th place fell inside a tie: the ids are the lower ones there
    full = np.bitwise_count(q[:, None, 0] ^ v[None, :, 0]).astype(np.float32)
    full[:, dele] = np.inf
    srt = np.sort(full, axis=1)
    assert (srt[:, k - 1] == srt[:, k]).any()


# ---------------------------------------------------------------- the card


@pytest.fixture
def cuda(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    return torch.device("cuda")


@contextlib.contextmanager
def _no_topk_on_cuda():
    """``torch.topk`` raises on a CUDA tensor inside the block."""
    real = torch.topk

    def guarded(x, *a, **kw):
        if x.is_cuda:
            raise AssertionError("torch.topk reached a CUDA tensor")
        return real(x, *a, **kw)

    torch.topk = guarded
    try:
        yield
    finally:
        torch.topk = real


def _kernel_equals_ref(s, k):
    launches = rt.row_topk.launches
    with _no_topk_on_cuda():
        got = rt.row_topk(s, k)
        torch.cuda.synchronize()
    # one launch for each KMAX of k
    assert rt.row_topk.launches == launches + -(-k // rt.KMAX)
    want = rt.row_topk_ref(s, k)
    assert torch.equal(got[1], want[1])
    assert torch.equal(_bits(got[0]), _bits(want[0]))
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("k", KS + [1025, 2400])
@pytest.mark.parametrize("case", CASES)
def test_kernel_bit_equal_to_plain(cuda, case, k):
    s = _block(case, k, q=33, seed=2)
    kk = min(k, s.shape[1])
    got = _kernel_equals_ref(s.to(cuda), kk)
    _check_select(got[0], got[1], s, kk)


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [1, 2, 3])
def test_kernel_on_an_unaligned_view(cuda, offset):
    """Rows that start off a 16-byte boundary take the scalar loads."""
    g = torch.Generator().manual_seed(offset)
    flat_ = -torch.randint(0, 24, (9 * 6000 + 3,), generator=g).float()
    _kernel_equals_ref(flat_[offset:offset + 9 * 6000].view(9, 6000).to(cuda),
                       10)


def _cell_scores(cell, dev, q=1024):
    """A [q, 1M] score block of the cell's configuration: its rows and
    queries from the data maker, scored as the flat scan scores them."""
    cfg = spec.cell(cell).config
    gen = spec.load_module(spec.ROOT, "data", cfg["generator"])
    data = gen.make(cfg, 2_300_000_021, dev, cfg["rows"], q)
    rows, queries = data["rows"], data["queries"]
    metric = Metric.from_string(cfg["metric"])
    if metric == Metric.HAMMING:
        from lantern_tpu_torch.ops.hamming import hamming_scores

        return hamming_scores(queries, rows, None)
    return flat._scores(rows, (rows * rows).sum(1), queries, metric)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [10, 128])
@pytest.mark.parametrize("cell", ["sift1m.auto", "cohere1m-b1.auto",
                                  "openai1m.auto"])
def test_kernel_at_the_cells_shape(cuda, cell, k):
    s = _cell_scores(cell, cuda)
    launches = rt.row_topk.launches
    with _no_topk_on_cuda():
        values, positions = rt.row_topk(s, k)
        torch.cuda.synchronize()
    assert rt.row_topk.launches == launches + 1
    want = rt.row_topk_ref(s, k)
    assert torch.equal(positions, want[1])
    assert torch.equal(_bits(values), _bits(want[0]))


@pytest.mark.cuda
@pytest.mark.parametrize("block,selects", [(None, 1), (3000, 7)])
def test_one_launch_a_flat_search_block(cuda, block, selects):
    """A one-block flat search launches the kernel once; a blocked one once
    for each block and once for each merge after the first. No
    ``aten::topk`` under ``flat.topk``."""
    g = torch.Generator(device=cuda).manual_seed(5)
    rows = torch.randn((10_000, 128), device=cuda, generator=g)
    queries = torch.randn((64, 128), device=cuda, generator=g)
    sqn = (rows * rows).sum(1)
    launches = rt.row_topk.launches
    with _no_topk_on_cuda(), torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        flat.flat_search(rows, sqn, queries, k=10, block=block)
        torch.cuda.synchronize()
    assert rt.row_topk.launches == launches + selects
    names = {e.name for e in prof.events()}
    assert "row_topk.launch" in names and "aten::topk" not in names
