"""Cost model and search-strategy dispatch (port of lantern_tpu/costmodel.py).

The analytic HNSW query cost of the reference (lantern_hnsw/src/hnsw.c:89-145):
  mL          = 1 / ln(M)
  E[levels]   = ln(1 + n) * mL
  S (stop Pr) = 1 / (1 - e^{-mL})
  E[visited upper] ≈ levels * M * S
  E[visited L0]    ≈ ef * M * S
used there to estimate page fetches for the Postgres planner, here to size
batches and beam iterations and the bytes a query batch moves.

The planner's seq-scan-vs-index choice (the reference's hnswcostestimate,
hnsw.c:150-209): scan the whole table with one matmul while it fits the
device's memory budget, traverse the graph beyond it.
"""

from __future__ import annotations

import dataclasses
import math
import os

import torch


@dataclasses.dataclass(frozen=True)
class SearchCost:
    expected_levels: float
    expected_visited: float      # node visits per query
    expected_iters: int          # beam-search iterations (level 0)
    hbm_bytes_per_batch: int     # candidate vector+adjacency traffic
    flops_per_batch: int

    @property
    def summary(self) -> str:
        return (
            f"levels≈{self.expected_levels:.1f} visited≈{self.expected_visited:.0f} "
            f"iters≈{self.expected_iters} HBM/batch={self.hbm_bytes_per_batch/2**20:.1f}MiB"
        )


def estimate_search_cost(
    n: int,
    dim: int,
    m: int,
    ef: int,
    batch: int,
    expand: int = 1,
    dtype_bytes: int = 4,
) -> SearchCost:
    ml = 1.0 / math.log(m)
    levels = math.log(1 + max(n, 1)) * ml
    s = 1.0 / (1.0 - math.exp(-ml))
    visited_upper = levels * m * s
    visited_l0 = ef * m * s
    visited = visited_upper + visited_l0
    # each beam iteration expands `expand` nodes -> 2M*expand candidates
    iters = max(1, math.ceil(ef / expand) + 4)
    cand_per_iter = 2 * m * expand
    bytes_per_iter = batch * cand_per_iter * (dim * dtype_bytes + 4)
    flops_per_iter = batch * cand_per_iter * dim * 2
    return SearchCost(
        expected_levels=levels,
        expected_visited=visited,
        expected_iters=iters,
        hbm_bytes_per_batch=iters * bytes_per_iter,
        flops_per_batch=iters * flops_per_iter,
    )


def estimate_build_rows(first_block_live: int, total_blocks: int) -> int:
    """Row-count estimate from first-block density (utils.c:228-249 analog)."""
    return max(first_block_live, 1) * max(total_blocks, 1)


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
