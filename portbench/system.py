"""The system under test: ``lantern_tpu_torch.Index``, built and searched
as a configuration and a traffic mix say. With ``builds/<build>.py`` the only
modules of the harness that call the program; the reference never imports
them.

Keys read here, so that a new cell needs files and entries, not edits:

- configuration: ``metric`` and ``quant`` (``Metric`` / ``QuantKind`` by
  name), ``dim``, ``m``, ``ef_construction``, ``ef``, ``k``, ``seeds``;
  ``hnsw``, further ``HnswParams`` fields (PQ's sizes, say); ``build``, the
  ``builds/<build>.py`` that makes the index (a PQ training step, shards);
- traffic: ``mode``; ``params``, further ``SearchParams`` fields;
  ``search``, further ``Index.search`` arguments (``rerank``, say).
"""

from __future__ import annotations

import numpy as np
import torch

from lantern_tpu_torch import Index
from lantern_tpu_torch.config import HnswParams, Metric, QuantKind, SearchParams


def index_rows(x: torch.Tensor) -> np.ndarray:
    """The harness's rows or queries as ``Index`` takes them: f32 rows as
    they are; packed int32 words as the uint32 words they carry."""
    a = x.cpu().numpy()
    return a.view(np.uint32) if a.dtype == np.int32 else a


def params(cfg: dict) -> HnswParams:
    return HnswParams(dim=cfg["dim"], m=cfg["m"],
                      ef_construction=cfg["ef_construction"], ef=cfg["ef"],
                      metric=Metric[cfg["metric"].upper()],
                      quant=QuantKind[cfg["quant"].upper()],
                      **cfg.get("hnsw", {}))


def index(cfg: dict, rows: np.ndarray, seed: int, device, build: str,
          **add) -> Index:
    """``Index(...).add(rows, build=build, seed=...)``, levels drawn from the
    run's seed, ended by a sync."""
    seed = seed % (2**31 - 1)
    ix = Index(params(cfg), capacity=len(rows), seed=seed, device=device)
    ix.add(rows, build=build, seed=seed, **add)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return ix


def search(ix, cfg: dict, traffic: dict, batch: np.ndarray, **extra):
    """One call of the cell's entry: ``Index.search(batch, params, mode)``
    with the configuration's k, ef and entry seeds; it returns once its
    numpy results are on the host. ``extra``: arguments the run adds (a
    filter's allowed labels)."""
    p = SearchParams(k=cfg["k"], ef=cfg["ef"], seeds=cfg["seeds"],
                     **traffic.get("params", {}))
    return ix.search(batch, params=p, mode=traffic["mode"],
                     **traffic.get("search", {}), **extra)
