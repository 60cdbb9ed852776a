"""Packed 1024-bit rows: binary-quantised sentence embeddings from a seed.

A frozen copy of ``chip_smoke.py``'s ``bit_rows()`` (line 1058) and of its
hamming path's centres and queries (line 1068), made with a
``torch.Generator`` on the run's device in a few large calls: ``centres``
random words rows, and each row a centre with each bit flipped with
p = 1/8 (the AND of three random words); the query pool is drawn the same
way from the same centres and is held out of the table. Words are int32
carrying the uint32 bits, 32 a 1024-bit row.
"""

from __future__ import annotations

import torch


def _words(shape, gen, device):
    return torch.randint(-2**31, 2**31, shape, generator=gen, device=device,
                         dtype=torch.int32)


def make(cfg: dict, seed: int, device: torch.device, rows: int,
         queries: int) -> dict:
    """{"rows": [rows, dim/32] int32, "queries": [queries, dim/32] int32}."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    words = cfg["dim"] // 32
    centres = _words((cfg["centres"], words), gen, device)

    def draw(n):
        flips = _words((n, words), gen, device)
        flips &= _words((n, words), gen, device)
        flips &= _words((n, words), gen, device)
        pick = torch.randint(0, cfg["centres"], (n,), generator=gen,
                             device=device)
        return centres[pick] ^ flips

    return {"rows": draw(rows), "queries": draw(queries)}
