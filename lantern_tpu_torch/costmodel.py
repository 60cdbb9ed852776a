"""Search-strategy dispatch (port of lantern_tpu/costmodel.py:77-94).

The planner's seq-scan-vs-index choice (the reference's hnswcostestimate,
hnsw.c:150-209): scan the whole table with one matmul while it fits the
device's memory budget, traverse the graph beyond it.
"""

from __future__ import annotations

import os

import torch


def memory_budget(device: torch.device) -> int:
    """Bytes a flat scan's table may occupy: half the card's memory
    (``torch.cuda.mem_get_info``), or half the host's RAM on the CPU."""
    if device.type == "cuda":
        _, total = torch.cuda.mem_get_info(device)
    else:
        total = os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")
    return total // 2


def choose_search_strategy(n: int, width: int, itemsize: int,
                           budget: int) -> str:
    """'flat' or 'graph': the dense scan wins wherever the stored table fits
    ``budget`` bytes; the graph serves tables too large to scan resident."""
    return "graph" if n * width * itemsize > budget else "flat"
