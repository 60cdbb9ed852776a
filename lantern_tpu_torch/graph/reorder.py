"""Graph locality reordering (port of lantern_tpu/graph/reorder.py): node
ids renumbered in BFS order from the entry point, so a traversal's early
hops read a shared prefix of the arrays. External labels move with their
rows, so search results are the same up to internal ids.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from lantern_tpu_torch.graph.device import DeviceGraph


def bfs_order(neighbors0: np.ndarray, entry: int, n: int) -> np.ndarray:
    """Returns perm (new -> old) covering all n nodes (orphans appended)."""
    nb = neighbors0[:n]
    seen = np.zeros(n, bool)
    blocks = []
    frontier = np.array([entry], dtype=np.int64)
    seen[entry] = True
    while frontier.size:
        blocks.append(frontier)
        rows = nb[frontier]
        nxt = np.unique(rows[rows >= 0])
        nxt = nxt[~seen[nxt]]
        seen[nxt] = True
        frontier = nxt
    rest = np.nonzero(~seen)[0]
    if rest.size:
        blocks.append(rest)
    return np.concatenate(blocks)


def _bfs_order_device(neighbors0: torch.Tensor, entry: int, n: int,
                      max_rounds: int = 64):
    """BFS order on the device: (perm new -> old, inv old -> new), both
    [cap] int64, for a graph whose every row is live (n == cap).

    Each round marks the out-neighbours of the frontier (an index_add of
    the frontier flags over the edges) and numbers the newly reached nodes
    in id order by a cumulative sum; one host read a round tests whether
    the frontier is empty. Unreached nodes follow in id order.
    """
    cap = neighbors0.shape[0] - 1  # row cap is the -1 dummy
    dev = neighbors0.device
    live = torch.arange(cap, device=dev) < n
    visited = torch.zeros(cap, dtype=torch.bool, device=dev)
    visited[entry] = True
    order = torch.full((cap,), cap, dtype=torch.int64, device=dev)
    order[entry] = 0
    flat = neighbors0[:cap].reshape(-1)
    targets = torch.where(flat >= 0, flat, cap).long()
    frontier = visited.clone()
    pos = torch.ones((), dtype=torch.int64, device=dev)
    for _ in range(max_rounds):
        if not bool(frontier.any()):
            break
        src = frontier.repeat_interleave(neighbors0.shape[1]).int()
        hit = torch.zeros(cap + 1, dtype=torch.int32, device=dev)
        hit.index_add_(0, targets, src)
        new = (hit[:cap] > 0) & ~visited & live
        order = torch.where(new, pos + torch.cumsum(new.long(), 0) - 1, order)
        visited |= new
        pos = pos + new.sum()
        frontier = new
    orphan = live & ~visited
    order = torch.where(orphan, pos + torch.cumsum(orphan.long(), 0) - 1, order)
    inv = order
    perm = torch.empty_like(inv)
    perm[inv] = torch.arange(cap, device=dev)
    return perm, inv


def reorder_bfs(graph: DeviceGraph) -> DeviceGraph:
    """Renumber a fully populated DeviceGraph (num_nodes == cap) in BFS
    order, on its device. Rows, adjacency (remapped), levels, slots, labels
    and tombstones move together; ``upper_ids`` is remapped."""
    n = graph.num_nodes
    cap = graph.cap
    if n != cap:
        raise ValueError("reorder_bfs expects a fully-populated graph (n == cap)")
    perm, inv = _bfs_order_device(graph.neighbors0, graph.entry, n)

    def remap(ids):
        return torch.where(ids >= 0, inv[torch.clamp(ids, min=0).long()],
                           -1).to(torch.int32)

    nb = remap(graph.neighbors0[:cap][perm])
    dummy = torch.full((1, nb.shape[1]), -1, dtype=torch.int32, device=nb.device)
    return dataclasses.replace(
        graph,
        vectors=graph.vectors[perm],
        sq_norms=graph.sq_norms[perm],
        neighbors0=torch.cat([nb, dummy]),
        upper_neighbors=remap(graph.upper_neighbors),
        upper_slot=graph.upper_slot[perm],
        levels=graph.levels[perm],
        labels=graph.labels[perm],
        deleted=graph.deleted[perm],
        entry=int(inv[graph.entry]),
        vec_scales=(None if graph.vec_scales is None else graph.vec_scales[perm]),
        upper_ids=(None if graph.upper_ids is None else remap(graph.upper_ids)),
        # the cached upper tables hold the same rows; with_aug_norms
        # attaches them again on demand
        upper_vectors=None,
        upper_sq=None,
    )
