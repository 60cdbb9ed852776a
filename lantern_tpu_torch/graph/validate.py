"""Structural index validation (port of lantern_tpu/graph/validate.py),
the analog of the reference's validate_index (validate_index.c).

Array-level checks on an engine's arrays (numpy, duck-typed):
- id ranges and the -1 padding of the adjacency rows
- degree bounds (2M at level 0, M above; validate_index.c:151)
- no self-loops
- level consistency: an edge at level l joins two nodes of level >= l
- the upper_slot <-> level bijection
- the entry point holds the maximum level
- reachability: a BFS from the entry over all levels reaches (almost) every
  node

``validate_device`` reads a DeviceGraph's tensors into such a view.
"""

from __future__ import annotations

import dataclasses
import types

import numpy as np

from lantern_tpu_torch.config import HnswParams, Metric, QuantKind
from lantern_tpu_torch.graph.device import QUANT_PQ


@dataclasses.dataclass
class ValidationReport:
    ok: bool
    errors: list[str]
    n: int
    n_reachable: int

    def raise_if_failed(self):
        if not self.ok:
            raise AssertionError("index validation failed:\n" + "\n".join(self.errors))


def validate_device(graph, full: bool = True,
                    min_reachable_frac: float = 0.98) -> ValidationReport:
    """Validate a DeviceGraph: its first ``num_nodes`` rows, copied to the
    host. The dummy slot of a device build (masked-write scratch) lies past
    the last used slot and is not read."""
    n = int(graph.num_nodes)
    nbr0 = graph.neighbors0[:n].cpu().numpy()
    un = graph.upper_neighbors.cpu().numpy()
    slots = graph.upper_slot[:n].cpu().numpy()
    used = slots[slots >= 0]
    quant = QuantKind.F32 if graph.quant == QUANT_PQ else QuantKind(graph.quant)
    view = types.SimpleNamespace(
        n=n,
        neighbors0=nbr0,
        counts0=(nbr0 >= 0).sum(axis=1).astype(np.int32),
        levels=graph.levels[:n].cpu().numpy(),
        upper_slot=slots,
        upper_neighbors=un,
        upper_counts=(un >= 0).sum(axis=2).astype(np.int32),
        n_upper=int(used.max()) + 1 if used.size else 0,
        entry=int(graph.entry),
        max_level=int(graph.max_level),
        p=HnswParams(dim=max(graph.dim, 1), m=graph.m,
                     metric=Metric(graph.metric), quant=quant),
    )
    return validate(view, full=full, min_reachable_frac=min_reachable_frac)


def validate(engine, full: bool = True, min_reachable_frac: float = 0.98) -> ValidationReport:
    """Validate an engine: a NativeHnsw, or any object with its arrays."""
    errors: list[str] = []
    n = engine.n
    if n == 0:
        return ValidationReport(True, [], 0, 0)
    m = engine.p.m
    m0 = engine.p.m0

    counts0 = np.asarray(engine.counts0[:n])
    nbr0 = np.asarray(engine.neighbors0[:n])
    levels = np.asarray(engine.levels[:n])
    upper_slot = np.asarray(engine.upper_slot[:n])
    n_upper = engine.n_upper
    upper_nbrs = np.asarray(engine.upper_neighbors[:max(n_upper, 1)])
    upper_counts = np.asarray(engine.upper_counts[:max(n_upper, 1)])

    # --- degree bounds ---
    if (counts0 < 0).any() or (counts0 > m0).any():
        errors.append(f"level-0 degree out of [0,{m0}]")
    if (upper_counts < 0).any() or (upper_counts > m).any():
        errors.append(f"upper degree out of [0,{m}]")

    # --- padding discipline + id range at level 0 ---
    col = np.arange(nbr0.shape[1])[None, :]
    valid_mask = col < counts0[:, None]
    vals = nbr0[valid_mask]
    if vals.size and ((vals < 0).any() or (vals >= n).any()):
        errors.append("level-0 neighbor id out of range")
    pad_vals = nbr0[~valid_mask]
    if pad_vals.size and (pad_vals != -1).any():
        errors.append("level-0 padding slots not -1")
    rows = np.broadcast_to(np.arange(n)[:, None], nbr0.shape)[valid_mask]
    if vals.size and (vals == rows).any():
        errors.append("self-loop at level 0")

    # --- upper_slot / level consistency ---
    has_upper = levels >= 1
    if (upper_slot[has_upper] < 0).any():
        errors.append("node with level>=1 missing upper slot")
    if (upper_slot[~has_upper] != -1).any():
        errors.append("level-0 node has an upper slot")
    slots = upper_slot[has_upper]
    if slots.size:
        if (slots >= n_upper).any():
            errors.append("upper slot out of range")
        elif len(np.unique(slots)) != len(slots):
            errors.append("duplicate upper slots")

    # --- per-level edge consistency ---
    lmax = upper_nbrs.shape[1]
    node_of_slot = np.full(max(n_upper, 1), -1, np.int64)
    node_ids = np.nonzero(has_upper)[0]
    # out-of-range slots were REPORTED above; exclude them here or the
    # scatter itself raises IndexError and the validator (a post-crash
    # diagnostic tool) dies instead of returning ok=False
    in_range = (upper_slot[node_ids] >= 0) & (upper_slot[node_ids] < n_upper)
    node_ids = node_ids[in_range]
    node_of_slot[upper_slot[node_ids]] = node_ids
    for lvl in range(1, lmax + 1):
        cnt = upper_counts[:, lvl - 1]
        used = cnt > 0
        if not used.any():
            continue
        owners = node_of_slot[np.nonzero(used)[0]]
        if (owners < 0).any():
            errors.append(f"level-{lvl} adjacency on unassigned slot")
            continue
        if (levels[owners] < lvl).any():
            errors.append(f"node has level-{lvl} edges but lower level")
        nb = upper_nbrs[used, lvl - 1]
        c = cnt[used]
        mask = np.arange(nb.shape[1])[None, :] < c[:, None]
        vals = nb[mask]
        if vals.size:
            if ((vals < 0) | (vals >= n)).any():
                errors.append(f"level-{lvl} neighbor id out of range")
            elif (levels[vals] < lvl).any():
                errors.append(f"level-{lvl} edge points to node below level {lvl}")

    # --- entry point ---
    entry, max_level = engine.entry, engine.max_level
    if not (0 <= entry < n):
        errors.append(f"entry {entry} out of range")
    elif levels[entry] != max_level:
        errors.append(f"entry level {levels[entry]} != max_level {max_level}")
    if levels.max(initial=0) > max_level:
        errors.append("node level exceeds max_level")

    # --- reachability (BFS from entry over the union of ALL levels) ---
    # note: HNSW graphs are directed and neighbor pruning can orphan a small
    # fraction of nodes at level 0; upper levels usually recover them, and a
    # tiny residue is normal — hence the threshold rather than exactness.
    n_reach = 0
    if full and not errors:
        seen = np.zeros(n, bool)
        frontier = np.array([entry])
        seen[entry] = True
        while frontier.size:
            nb = nbr0[frontier]
            c = counts0[frontier]
            mask = np.arange(nb.shape[1])[None, :] < c[:, None]
            nxt_list = [nb[mask]]
            f_up = frontier[has_upper[frontier]]
            if f_up.size:
                s = upper_slot[f_up]
                ub = upper_nbrs[s].reshape(f_up.size, -1)
                nxt_list.append(ub[ub >= 0])
            nxt = np.unique(np.concatenate(nxt_list))
            nxt = nxt[(nxt >= 0) & ~seen[nxt]]
            seen[nxt] = True
            frontier = nxt
        n_reach = int(seen.sum())
        if n_reach < min_reachable_frac * n:
            errors.append(
                f"only {n_reach}/{n} nodes reachable from entry "
                f"(< {min_reachable_frac:.1%})"
            )
    return ValidationReport(not errors, errors, int(n), n_reach)
