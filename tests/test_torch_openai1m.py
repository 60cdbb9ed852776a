"""The ``openai1m`` configuration at its published width on the CPU: 1536-d
unit rows under cosine, m=8, ef_construction=128, ef=128, k=10, built on the
device path (``Index.add(build="device")``) and searched through
``Index.search``, against the benchmark's plain reference
(``portbench/reference.py``).

3,000 rows and 64 queries from ``portbench/data/unit_clustered.py`` at the
configuration's own centres and jitter. The flat and ``auto`` scans must
return the exact neighbours, ids up to ties (``reference.compare``: a row
at the k-th exact distance counts), with distances within ``DIST_TOL``
of the float64 ones. The beam must reach ``GRAPH_RECALL``. The cosine score
block (``flat._cos_scores``) must be the three steps it replaced, bit for
bit, and count one block a block.
"""

import numpy as np
import pytest
import torch

from lantern_tpu_torch import Index, flat
from lantern_tpu_torch.config import HnswParams, Metric, SearchParams
from portbench import reference, spec

ROWS, QUERIES, SEED = 3000, 64, 18
# relative to each query's k-th exact distance (``reference.compare``'s
# dist_gap): a sum of 1536 f32 products of unit rows errs by about
# sqrt(1536) * 2^-24 = 2.3e-6 as a random walk (read: 1.7e-7); TF32
# operands err by ~3e-5 at this width, so the bound holds the scan to f32
DIST_TOL = 2e-6
# the beam over 3,000 rows at ef=128 reads 0.683: with 4096 centres a row
# has almost no cluster mates here, so its 10 nearest are near-random points
# of the 1536-d sphere, the beam's hardest case; the floor leaves 5% of it
GRAPH_RECALL = 0.65


@pytest.fixture(scope="module")
def case():
    cfg = spec.cell("openai1m.auto").config
    gen = spec.load_module(spec.ROOT, "data", cfg["generator"])
    data = gen.make(cfg, SEED, torch.device("cpu"), ROWS, QUERIES)
    rows, queries = data["rows"], data["queries"]
    ix = Index(HnswParams(dim=cfg["dim"], m=cfg["m"],
                          ef_construction=cfg["ef_construction"],
                          ef=cfg["ef"], metric=Metric.COS),
               capacity=ROWS, seed=SEED, device="cpu")
    ix.add(rows.numpy(), build="device", seed=SEED)
    kth = reference.exact_knn("cos", rows, queries, cfg["k"])[0][:, -1]
    return cfg, ix, rows, queries, kth


def _checked(case, mode):
    cfg, ix, rows, queries, kth = case
    p = SearchParams(k=cfg["k"], ef=cfg["ef"], seeds=cfg["seeds"])
    d, lab, stats = ix.search(queries.numpy(), params=p, mode=mode,
                              with_stats=True)
    got = reference.compare("cos", rows, queries, kth,
                            torch.arange(QUERIES), torch.from_numpy(d),
                            torch.from_numpy(lab.view(np.int64)))
    return got, stats


def test_unit_rows():
    cfg = spec.cell("openai1m.auto").config
    gen = spec.load_module(spec.ROOT, "data", cfg["generator"])
    data = gen.make(cfg, SEED, torch.device("cpu"), 50, 8)
    for x in data.values():
        assert x.dtype == torch.float32 and x.shape[1] == 1536
        assert torch.allclose(torch.linalg.vector_norm(x, dim=1),
                              torch.ones(x.shape[0]), atol=1e-6)
    again = gen.make(cfg, SEED, torch.device("cpu"), 50, 8)
    assert torch.equal(again["rows"], data["rows"])


@pytest.mark.parametrize("mode", ["flat", "auto"])
def test_exact_scan_equals_reference(case, mode):
    got, stats = _checked(case, mode)
    assert stats["mode"] == "flat"
    assert got["miss_share"] == 0.0 and got["recall"] == 1.0
    assert got["dist_gap"] <= DIST_TOL


def test_graph_reaches_recall(case):
    got, stats = _checked(case, "graph")
    assert stats["mode"] == "graph"
    assert got["recall"] >= GRAPH_RECALL
    assert got["dist_gap"] <= DIST_TOL


def _three_steps(qf, x, sq_norms, excluded):
    """The cosine block as ``flat._scores`` formed it before
    ``_cos_scores``: the product, the column divide, then the mask."""
    dots = qf @ x.float().T
    dots.div_(torch.clamp(torch.sqrt(sq_norms)[None, :], min=1e-30))
    if excluded is not None:
        dots.masked_fill_(excluded[None, :], float("-inf"))
    return dots


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("bf16", [False, True])
def test_cos_scores_bit_equal_to_three_steps(masked, bf16):
    g = torch.Generator().manual_seed(5)
    x = torch.randn((700, 1536), generator=g)
    q = torch.randn((33, 1536), generator=g)
    if bf16:
        x = x.to(torch.bfloat16)
    sqn = (x.float() ** 2).sum(1)
    excluded = torch.rand(700, generator=g) < 0.2 if masked else None
    qf = q.to(x.dtype).float()
    want = _three_steps(qf, x, sqn, excluded)
    assert torch.equal(flat._cos_scores(qf, x, sqn, excluded), want)
    assert torch.equal(flat._scores(x, sqn, q, Metric.COS, excluded=excluded),
                       want)


@pytest.mark.parametrize("block,blocks", [(None, 1), (256, 3), (100, 7)])
def test_cos_scores_counts_each_block(monkeypatch, block, blocks):
    monkeypatch.setattr(flat._cos_scores, "blocks", 0)
    g = torch.Generator().manual_seed(6)
    x = torch.randn((700, 1536), generator=g)
    q = torch.randn((9, 1536), generator=g)
    sqn = (x ** 2).sum(1)
    flat.flat_search(x, sqn, q, k=10, metric=Metric.COS, block=block)
    assert flat._cos_scores.blocks == blocks
    flat.flat_search(x, sqn, q, k=10, metric=Metric.L2SQ, block=block)
    assert flat._cos_scores.blocks == blocks  # l2sq takes _l2sq_scores
