"""Clustered unit-length f32 rows: the shape of text embeddings from a seed.

Rows and queries are drawn exactly as ``data/clustered.py`` draws them
(``centres`` Gaussian centres of unit variance plus Gaussian noise of
standard deviation ``jitter``, made on the run's device from the seed, the
query pool held out of the table), then each row is scaled to unit length
in f32, as OpenAI's ada-002 embeddings are delivered.
"""

from __future__ import annotations

from pathlib import Path

import torch

from portbench import spec

_clustered = spec.load_module(Path(__file__).resolve().parents[2], "data",
                              "clustered")


def make(cfg: dict, seed: int, device: torch.device, rows: int,
         queries: int) -> dict:
    """{"rows": [rows, dim] f32, "queries": [queries, dim] f32} on
    ``device``, every row of unit length."""
    out = _clustered.make(cfg, seed, device, rows, queries)
    for x in out.values():
        x.div_(torch.linalg.vector_norm(x, dim=1, keepdim=True))
    return out
