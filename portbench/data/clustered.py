"""Clustered f32 rows: SIFT1M's shape from a seed.

A frozen copy of ``chip_smoke.py``'s ``clustered()`` (line 470) and of its
held-out queries (line 3110), made with a ``torch.Generator`` on the run's
device in a few large calls: each row is one of ``centres`` Gaussian centres
(unit variance) plus Gaussian noise of standard deviation ``jitter``; the
query pool is drawn the same way from the same centres and is held out of
the table.
"""

from __future__ import annotations

import torch


def make(cfg: dict, seed: int, device: torch.device, rows: int,
         queries: int) -> dict:
    """{"rows": [rows, dim] f32, "queries": [queries, dim] f32} on ``device``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    dim, n_centres, jitter = cfg["dim"], cfg["centres"], cfg["jitter"]
    centres = torch.randn((n_centres, dim), generator=gen, device=device)

    def draw(n):
        out = torch.randn((n, dim), generator=gen, device=device)
        out.mul_(jitter)
        out.add_(centres[torch.randint(0, n_centres, (n,), generator=gen,
                                       device=device)])
        return out

    return {"rows": draw(rows), "queries": draw(queries)}
