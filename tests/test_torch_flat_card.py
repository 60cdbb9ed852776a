"""The flat scan's l2sq score block on the card: one GEMM with the bias
-|x|^2 (-inf at excluded rows) in its epilogue (``flat._l2sq_scores``).

At Q=1024 and N=262,144 with TF32 off, the block equals the three passes it
replaced (2<q,x>, minus |x|^2, then the mask) within f32 rounding, with -inf
exactly at the excluded rows; the scan's ids are the three-pass block's
top-k up to rounding ties; and under ``torch.profiler`` the kernels under
the ``flat.score`` span other than the GEMM's (the [N] bias, the doubled
query) take under 5% of its device time, so no other kernel passes over the
block. Imports no jax: it runs on the card's machine with ``--noconftest``.
"""

import pytest
import torch

from lantern_tpu_torch import flat
from lantern_tpu_torch.config import Metric

Q, N, D, K = 1024, 262_144, 128, 10


@pytest.fixture
def cuda(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    return torch.device("cuda")


def _three_pass(q, v, sqn, excluded):
    s = q @ v.T
    s.mul_(2.0).sub_(sqn[None, :])
    return s.masked_fill_(excluded[None, :], float("-inf"))


def _kernels_under(events, span):
    """(name, seconds) of every kernel launched under each ``span`` op."""
    out = []

    def walk(e):
        out.extend((k.name, k.duration / 1e6) for k in e.kernels)
        for c in e.cpu_children:
            walk(c)

    for e in events:
        if e.name == span:
            walk(e)
    return out


@pytest.mark.cuda
def test_l2sq_block_is_one_gemm_on_card(cuda):
    g = torch.Generator(device=cuda).manual_seed(5)
    centres = torch.randn(256, D, device=cuda, generator=g)
    pick = torch.randint(0, 256, (N,), device=cuda, generator=g)
    v = centres[pick] + 0.5 * torch.randn(N, D, device=cuda, generator=g)
    q = v[torch.randint(0, N, (Q,), device=cuda, generator=g)] + 0.1
    sqn = (v * v).sum(1)
    excluded = torch.rand(N, device=cuda, generator=g) < 0.1
    excluded[N - 1000:] = True  # unfilled capacity rows

    got = flat._scores(v, sqn, q, Metric.L2SQ, excluded=excluded)
    want = _three_pass(q, v, sqn, excluded)
    ex = excluded[None, :].expand_as(got)
    assert torch.equal(torch.isneginf(got), ex)
    assert torch.isfinite(got[~ex]).all()
    scale = 2.0 * (q.abs() @ v.abs().T) + sqn[None, :]
    tol = D * torch.finfo(torch.float32).eps * scale
    assert ((got - want).abs() <= tol)[~ex].all()
    del scale, tol, ex

    _, ids = flat.flat_search(v, sqn, q, k=K, exact=True, deleted=excluded)
    ids = ids.long()
    assert (ids >= 0).all() and not excluded[ids].any()
    top = torch.topk(want, K, dim=1)
    moved = ids != top.indices
    # a differing id is a rounding tie: its three-pass score is that rank's
    near = (want.gather(1, ids) - top.values).abs()
    rows = v[ids].abs()  # [Q, K, D]
    bound = 2 * D * torch.finfo(torch.float32).eps * (
        2.0 * (q.abs()[:, None, :] * rows).sum(-1) + sqn[ids])
    assert (near <= bound)[moved].all()
    del got, want, top

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    flat.flat_search(v, sqn, q, k=K, deleted=excluded)
    torch.cuda.synchronize()
    blocks = flat._l2sq_scores.blocks
    with torch.profiler.profile(activities=acts) as prof:
        flat.flat_search(v, sqn, q, k=K, deleted=excluded)
        torch.cuda.synchronize()
    assert flat._l2sq_scores.blocks == blocks + 1
    under = _kernels_under(prof.events(), "flat.score")
    gemm = sum(s for name, s in under if "at::native::" not in name)
    rest = sum(s for name, s in under if "at::native::" in name)
    print("flat.score kernels:", sorted({name[:120] for name, _ in under}))
    print(f"gemm {gemm * 1e3:.3f} ms, rest {rest * 1e3:.4f} ms")
    assert gemm > 0 and rest < 0.05 * gemm, under
