"""The f32 cosine score block on the tensor cores (``ops/cos_block.py``,
``csrc/cos_block.cu``).

On the CPU: the plain version's split (each half exact in TF32, the pair
within 2^-22 of the operand, rounding to nearest with ties away), its block
at the ``openai1m`` width against float64, and its epilogue against
``flat._scaled`` bit for bit. On the card (``cuda``, skipped without one):
the kernel against the plain version and float64 at ragged shapes, the
flat scan's routing (one launch a block, no ``flat.scale`` pass) and the
blocks that keep the three steps, and the wrapper's refusals. Imports no
jax: the card's tests run with ``--noconftest``.
"""

import pytest
import torch

from lantern_tpu_torch import flat
from lantern_tpu_torch.config import Metric
from lantern_tpu_torch.ops import cos_block as cb
from lantern_tpu_torch.utils import bench
from portbench import spec

# the block's reading against float64 at d = 1536 (the openai1m test's
# DIST_TOL): f32 products summed in f32 err by ~sqrt(d) 2^-24; TF32 operands
# by ~3e-5
DIST_TOL = 2e-6
# the kernel's error against float64, in units of |q| (a score is <q, x>/|x|):
# f32 accuracy reads ~1e-7-1e-6; TF32 operands alone read 1.7e-5 at d = 1536
# and more at narrower rows (~2^-11 sqrt(2 / d))
CARD_TOL = 4e-6


def _rand(shape, seed, scale=1.0):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=g) * scale


@pytest.mark.parametrize("scale", [1.0, 1e-3, 3e4])
def test_split_reconstructs_within_2_pow_minus_22(scale):
    x = _rand((4096,), 1, scale)
    hi, lo = cb.split_tf32(x)
    err = (hi.double() + lo.double() - x.double()).abs()
    assert (err <= 2.0 ** -22 * x.double().abs()).all()
    assert (lo.abs() <= 2.0 ** -11 * x.abs()).all()


@pytest.mark.parametrize("seed", [2, 3])
def test_halves_are_exact_tf32(seed):
    x = _rand((4096,), seed) * torch.exp(_rand((4096,), seed + 10))
    for half in cb.split_tf32(x):
        assert (half.view(torch.int32) & 0x1FFF == 0).all()


@pytest.mark.parametrize("x,want", [
    (1.0 + 2.0 ** -11, 1.0 + 2.0 ** -10),     # a tie: away from zero
    (-(1.0 + 2.0 ** -11), -(1.0 + 2.0 ** -10)),
    (1.0 + 2.0 ** -12, 1.0),                  # under half: down
    (1.0 + 2.0 ** -11 + 2.0 ** -23, 1.0 + 2.0 ** -10),
    (2.0 - 2.0 ** -23, 2.0),                  # carries into the exponent
    (0.0, 0.0),
])
def test_rna_tf32_rounds_to_nearest_ties_away(x, want):
    assert cb.rna_tf32(torch.tensor([x])).item() == want


@pytest.fixture(scope="module")
def unit_case():
    cfg = spec.cell("openai1m.auto").config
    gen = spec.load_module(spec.ROOT, "data", cfg["generator"])
    data = gen.make(cfg, 19, torch.device("cpu"), 3000, 64)
    return data["rows"], data["queries"]


def test_block_at_openai1m_width_within_dist_tol_of_float64(unit_case):
    rows, queries = unit_case
    assert rows.shape[1] == 1536
    sqn = (rows * rows).sum(1)
    got = cb.cos_scores_ref(queries, rows, sqn)
    exact = (queries.double() @ rows.double().T) / torch.linalg.vector_norm(
        rows.double(), dim=1)[None, :]
    assert (got.double() - exact).abs().max().item() <= DIST_TOL


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("zero_row", [False, True])
def test_epilogue_bit_equal_to_scaled(masked, zero_row):
    x = _rand((500, 256), 4)
    q = _rand((17, 256), 5)
    if zero_row:
        x[7] = 0.0
    sqn = (x * x).sum(1)
    excluded = (_rand((500,), 6) > 0.8) if masked else None
    want = flat._scaled(cb.split_dots(q, x), Metric.COS, sqn, None, excluded)
    got = cb.cos_scores_ref(q, x, sqn, excluded)
    assert torch.equal(got, want)
    if zero_row:
        assert got[:, 7].eq(0).all() or masked and excluded[7]


def test_cpu_wrapper_is_the_plain_version(monkeypatch):
    monkeypatch.setattr(cb.cos_block, "launches", 0)
    x, q = _rand((300, 64), 7), _rand((5, 64), 8)
    sqn = (x * x).sum(1)
    excluded = _rand((300,), 9) > 0.5
    assert torch.equal(cb.cos_block(q, x, sqn, excluded),
                       cb.cos_scores_ref(q, x, sqn, excluded))
    assert cb.cos_block.launches == 0
    assert not cb.takes(x)
    with pytest.raises(ValueError):
        cb.cos_block(q[:, :60], x, sqn)
    with pytest.raises(ValueError):
        cb.cos_block(q, x, sqn[:-1])


# ---- on the card ---------------------------------------------------------


@pytest.fixture
def cuda(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    return torch.device("cuda")


def _card_case(dev, q, n, d, masked, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    rows = torch.randn((n, d), device=dev, generator=g)
    queries = torch.randn((q, d), device=dev, generator=g)
    rows[n // 2] = 0.0  # a zero-norm row: divided by 1e-30
    sqn = (rows * rows).sum(1)
    excluded = (torch.rand(n, device=dev, generator=g) < 0.3) if masked else None
    return queries, rows, sqn, excluded


def _check_block(got, queries, rows, sqn, excluded):
    want = cb.cos_scores_ref(queries, rows, sqn, excluded)
    norm = torch.clamp(torch.sqrt(sqn.double()), min=1e-30)
    exact = (queries.double() @ rows.double().T) / norm[None, :]
    tol = CARD_TOL * torch.linalg.vector_norm(queries.double(), dim=1)[:, None]
    if excluded is not None:
        ex = excluded[None, :].expand_as(got)
        assert torch.equal(torch.isneginf(got), ex)
        keep = ~ex
    else:
        keep = torch.ones_like(got, dtype=torch.bool)
    assert torch.isfinite(got[keep]).all()
    assert ((got.double() - exact).abs() <= tol)[keep].all()
    assert ((got.double() - want.double()).abs() <= tol)[keep].all()


@pytest.mark.cuda
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("d", [4, 128, 1536, 3072])
@pytest.mark.parametrize("n", [1, 255, 100003])
@pytest.mark.parametrize("q", [1, 7, 1024])
def test_kernel_against_plain_and_float64(cuda, q, n, d, masked):
    queries, rows, sqn, excluded = _card_case(cuda, q, n, d, masked,
                                              q * 7 + n + d)
    launches = cb.cos_block.launches
    got = cb.cos_block(queries, rows, sqn, excluded)
    torch.cuda.synchronize()
    assert cb.cos_block.launches == launches + 1
    _check_block(got, queries, rows, sqn, excluded)


@pytest.mark.cuda
def test_kernel_on_a_row_slice_at_a_block_offset(cuda):
    queries, rows, sqn, excluded = _card_case(cuda, 300, 9000, 1536, True, 11)
    lo, hi = 1000, 6001  # the flat scan's blocks are such views
    got = cb.cos_block(queries, rows[lo:hi], sqn[lo:hi], excluded[lo:hi])
    torch.cuda.synchronize()
    _check_block(got, queries, rows[lo:hi], sqn[lo:hi], excluded[lo:hi])


def _flat_counts(monkeypatch, rows, sqn, queries, **kw):
    """(kernel launches, flat.score spans, flat.scale spans) of one cosine
    flat scan, from the LanternBench counters."""
    monkeypatch.setattr(bench, "_enabled", True)
    bench.reset()
    launches = cb.cos_block.launches
    flat.flat_search(rows, sqn, queries, k=10, metric=Metric.COS, **kw)
    torch.cuda.synchronize()
    st = bench.stats()
    return (cb.cos_block.launches - launches,
            st.get("flat.score", {}).get("count", 0),
            st.get("flat.scale", {}).get("count", 0))


@pytest.mark.cuda
@pytest.mark.parametrize("block,blocks", [(None, 1), (4096, 3)])
def test_flat_scan_takes_the_kernel(cuda, monkeypatch, block, blocks):
    queries, rows, sqn, excluded = _card_case(cuda, 64, 10000, 1536, True, 12)
    got = _flat_counts(monkeypatch, rows, sqn, queries, block=block,
                       deleted=excluded)
    assert got == (blocks, blocks, 0)
    d, ids = flat.flat_search(rows, sqn, queries, k=10, metric=Metric.COS,
                              deleted=excluded, exact=True)
    want = cb.cos_scores_ref(queries, rows, sqn, excluded)
    top = torch.topk(want, 10, dim=1)
    moved = ids.long() != top.indices
    # a differing id is a rounding tie of the plain block
    near = (want.gather(1, ids.long()) - top.values).abs()
    tie = 2 * CARD_TOL * torch.linalg.vector_norm(queries, dim=1)[:, None]
    assert (near <= tie)[moved].all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,d", [(torch.bfloat16, 1536),
                                     (torch.float32, 130)])
def test_other_blocks_keep_the_three_steps(cuda, monkeypatch, dtype, d):
    queries, rows, sqn, _ = _card_case(cuda, 64, 5000, d, False, 13)
    rows = rows.to(dtype)
    assert _flat_counts(monkeypatch, rows, sqn, queries) == (0, 1, 1)


@pytest.mark.cuda
def test_wrapper_raises_on_what_it_does_not_take(cuda):
    queries, rows, sqn, excluded = _card_case(cuda, 8, 512, 128, True, 14)
    bad = [
        (queries, rows.T.contiguous().T, sqn, excluded),   # not contiguous
        (queries[:, ::2], rows[:, ::2], sqn, excluded),     # strided
        (queries, rows.double(), sqn, excluded),            # float64 rows
        (queries, rows.to(torch.bfloat16), sqn, excluded),  # bf16 rows
        (queries, rows, sqn.double(), excluded),
        (queries, rows, sqn, excluded.to(torch.uint8)),     # not a bool mask
        (queries[:, :126].contiguous(), rows[:, :126].contiguous(), sqn,
         excluded),                                          # d % 4 != 0
    ]
    launches = cb.cos_block.launches
    for args in bad:
        with pytest.raises(ValueError):
            cb.cos_block(*args)
    assert cb.cos_block.launches == launches
