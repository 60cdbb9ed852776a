"""Batched HNSW construction on the device (port of
lantern_tpu/graph/build_device.py).

A graph grows in insert ROUNDS of B new nodes each:

1. candidate pool: the ef_construction nearest built nodes, from a flat
   scan of the built prefix (``flat_search`` with the not-built rows masked;
   K4's score epilogue for hamming) or from a beam search of the partial
   graph (``search_batched``, expand 4, 16 seeds from the planned
   ``upper_ids``; K1 scores its candidates);
2. within-batch candidates: exact distances among the batch, so members of
   one round can link to each other;
3. selection: the HNSW diversity heuristic ("keep c iff it is closer to
   the query than to every kept neighbour") over the pool sorted by
   (distance, id), one column at a time;
4. forward edges: one scatter into the new nodes' rows;
5. reverse edges: edges grouped by target (a stable sort and segment
   ranks, at most ``max_in`` incomers a target a round), then each target
   row appends its incomers or, past its degree, is re-selected by the same
   heuristic.

Levels are drawn on the host with the floor(-ln(U)/ln(M)) law, so the
entry point, the maximum level and the node count are host ints, updated
round by round from the numpy levels with no device read. Upper levels
select from the exact nearest nodes of that level.

The plan is written once, over a leading shard axis of S shards: the host
plan (``plan_build`` / ``plan_insert``: level draws, upper slots, capacity
growth, the per-level id lists with their UPPER_POOL_CAP subsample), the
tables (``build_tables`` / ``grown_tables``) and one ``BuildState`` a shard
(``build_states``), the quantised round trip of an insert (``round_rows``,
``stored_rows``), the round groups with their flat / beam route
(``build_groups`` / ``insert_groups``) and ``insert_rounds``, which runs
each round over every shard. ``build_on_device`` and
``device_insert`` are its S=1 fronts; ``parallel/sharded.py`` runs it over
the shards of a rank.

The reference's ``lax.scan``s become Python loops (the selection loop runs
C columns of a few small launches each) and its donated state a
``BuildState`` updated in place. Masked lanes write to dedicated dummy
rows, row ``cap`` of ``neighbors0`` and upper slot ``ucap - 1``, and write
back the dummy's own content, so the dummies never change; no other row is
written twice in one scatter (torch leaves the order of duplicate indexed
writes open on CUDA). The reference gathers through a bf16 copy of the
table on a TPU only; here, as on its other backends, the rows are gathered
as stored.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from lantern_tpu_torch import resolve_device
from lantern_tpu_torch.config import HnswParams, Metric, QuantKind
from lantern_tpu_torch.flat import flat_search
from lantern_tpu_torch.graph.device import QUANT_PQ, DeviceGraph, upper_ids_from_slots
from lantern_tpu_torch.graph.search import search_batched
from lantern_tpu_torch.native import LMAX
from lantern_tpu_torch.quant.pq import _assign, _split
from lantern_tpu_torch.quant.scalar import quantize_i8
from lantern_tpu_torch.utils.bench import span

_INF = float("inf")
ROUND_GROUP = 16  # rounds between progress reports and hybrid-switch checks
# levels with more nodes than this are subsampled for the upper pools
UPPER_POOL_CAP = 32768
# f32 elements of the +-1 operands one hamming pair-distance product holds
_PM1_CHUNK = 1 << 27
# a build's tables, each a BuildState's tensor field
TABLES = ("vectors", "sq_norms", "neighbors0", "upper_neighbors", "upper_slot",
          "levels")


@dataclasses.dataclass
class BuildState:
    """The graph under construction; the rounds update its tensors in place.

    ``host_levels`` is ``levels`` on the host, so ``entry``, ``max_level``
    and ``n`` (nodes inserted so far) follow the rounds with no device read.
    ``upper_ids`` is the PLANNED slot -> node map (levels are drawn up
    front), which lets beam rounds take the dense entry scan; the search
    itself excludes ids >= ``n``.
    """

    vectors: torch.Tensor          # [cap, dim] f32/bf16, or [cap, W] int32 words
    sq_norms: torch.Tensor         # [cap] f32
    neighbors0: torch.Tensor       # [cap+1, m0] int32 (row cap = dummy)
    upper_neighbors: torch.Tensor  # [ucap, LMAX, m] int32 (slot ucap-1 = dummy)
    upper_slot: torch.Tensor       # [cap] int32
    levels: torch.Tensor           # [cap] int32
    host_levels: np.ndarray        # [cap] int32
    entry: int
    max_level: int
    n: int
    m: int = 16
    dim: int = 0
    metric: int = int(Metric.L2SQ)
    upper_ids: torch.Tensor | None = None  # [ucap] int32


def _graph_view(st: BuildState) -> DeviceGraph:
    cap = st.vectors.shape[0]
    dev = st.vectors.device
    return DeviceGraph(
        vectors=st.vectors,
        sq_norms=st.sq_norms,
        neighbors0=st.neighbors0,
        upper_neighbors=st.upper_neighbors,
        upper_slot=st.upper_slot,
        levels=st.levels,
        labels=torch.zeros(cap, dtype=torch.int64, device=dev),
        deleted=torch.zeros(cap, dtype=torch.bool, device=dev),
        entry=st.entry,
        max_level=st.max_level,
        num_nodes=st.n,
        upper_ids=st.upper_ids,
        m=st.m,
        dim=st.dim,
        metric=st.metric,
    )


def _sq_of(vecs, metric: Metric):
    """Squared norms recomputed from gathered rows (as the reference does,
    rather than gathering the table's ``sq_norms``); zeros for hamming."""
    if metric == Metric.HAMMING:
        return torch.zeros(vecs.shape[:-1], dtype=torch.float32,
                           device=vecs.device)
    v = vecs.float()
    return (v * v).sum(-1)


def _pm1(words):
    """[..., W] int32 words -> [..., 32W] f32 +-1 (bit set -> +1). The bit
    order within a word is any fixed one: both operands share it."""
    shifts = torch.arange(32, dtype=torch.int32, device=words.device)
    bits = (words[..., None] >> shifts) & 1
    return (bits.float() * 2.0 - 1.0).reshape(*words.shape[:-1], -1)


def _hamming_pairs(a, b):
    """[B, C, W] x [B, E, W] int32 words -> [B, C, E] hamming distances.

    The bits become +-1 floats and one batched product gives dot =
    32W - 2 * distance. It is exact: the products are +-1 and the sums are
    integers far below 2^24 (in TF32 too). Padding bits are equal in both
    operands, so they add 0 to the distance, as in the reference's XOR and
    popcount. Chunked over B so the +-1 operands stay under _PM1_CHUNK
    elements.
    """
    bsz, c, w = a.shape
    e = b.shape[1]
    out = torch.empty((bsz, c, e), dtype=torch.float32, device=a.device)
    step = max(1, _PM1_CHUNK // ((c + e) * 32 * w))
    for s in range(0, bsz, step):
        dots = torch.bmm(_pm1(a[s:s + step]), _pm1(b[s:s + step]).transpose(1, 2))
        out[s:s + step] = (32 * w - dots) * 0.5
    return out


def _pair_dists(vecs_a, sq_a, vecs_b, sq_b, metric: Metric):
    """[B, C, d] x [B, E, d] -> [B, C, E] distances (l2sq / cos / hamming).

    Hamming rows are int32 words and the sq arguments are unused. bf16 rows
    are widened: their products are exact in f32, as the reference's
    f32-accumulating einsum."""
    with span("build.pair_dists"):
        if metric == Metric.HAMMING:
            return _hamming_pairs(vecs_a, vecs_b)
        dots = torch.bmm(vecs_a.float(), vecs_b.float().transpose(1, 2))
        if metric == Metric.L2SQ:
            return sq_a[:, :, None] - 2.0 * dots + sq_b[:, None, :]
        na = torch.sqrt(sq_a)[:, :, None]
        nb = torch.sqrt(sq_b)[:, None, :]
        return 1.0 - dots / torch.clamp(na * nb, min=1e-30)


def select_heuristic_batch(pool_d, pair_d, keep_mask, m: int):
    """The HNSW selection heuristic over a batch of pools.

    pool_d [B, C] candidate -> query distances, ASCENDING per row;
    pair_d [B, C, C] candidate <-> candidate distances; keep_mask [B, C]
    eligible candidates. Column j is kept iff it is eligible, fewer than m
    are kept so far, and no kept column s has pair_d[:, j, s] <= pool_d[:, j].
    Returns the selected mask [B, C] (at most m a row). A loop of C steps
    (the reference's ``lax.scan``)."""
    with span("build.select"):
        b, c = pool_d.shape
        close = pair_d <= pool_d[:, :, None]
        selected = torch.zeros((b, c), dtype=torch.bool, device=pool_d.device)
        count = torch.zeros(b, dtype=torch.int32, device=pool_d.device)
        for j in range(c):
            viol = (selected & close[:, j, :]).any(1)
            keep = keep_mask[:, j] & (count < m) & ~viol
            selected[:, j] = keep
            count += keep
        return selected


def _mask_to_ids(pool_ids, selected, m: int):
    """The selected ids of each row in pool order, in m slots, -1 padded."""
    b, c = pool_ids.shape
    iota = torch.arange(c, device=pool_ids.device).expand(b, c)
    key = torch.where(selected, iota, c + 1)
    order = torch.sort(key, dim=1, stable=True).indices[:, :m]
    picked = torch.gather(pool_ids, 1, order)
    return torch.where(torch.gather(selected, 1, order), picked, -1)


def _sort_pool(d, ids):
    """Sort each row by (distance, id): a stable sort by id, then a stable
    sort by distance (the reference's two-key ``lax.sort``), so duplicate
    ids of equal distance sit side by side."""
    o = torch.sort(ids, dim=1, stable=True).indices
    d, ids = torch.gather(d, 1, o), torch.gather(ids, 1, o)
    o = torch.sort(d, dim=1, stable=True).indices
    return torch.gather(d, 1, o), torch.gather(ids, 1, o)


def _smallest(d, k: int):
    """(values, columns) of the k smallest entries of each row, ascending,
    ties in column order (``lax.top_k``'s rule: hamming distances tie)."""
    d, cols = torch.sort(d, dim=1, stable=True)
    return d[:, :k], cols[:, :k]


def _masked_set(table, idx, values, active, dummy: int):
    """``table[idx] = values`` on the active lanes; the other lanes name the
    ``dummy`` row and write its own content back. The active lanes name
    distinct rows other than ``dummy``, so every row but the dummy is
    written at most once."""
    idx = torch.where(active, idx, dummy)
    mask = active.reshape(active.shape + (1,) * (values.dim() - 1))
    table[idx.long()] = torch.where(mask, values, table[dummy])


def _scatter_reverse(
    adjacency,          # [R, deg] int32, updated in place; row dummy_row is scratch
    row_of_target,      # fn: target ids -> row indices
    dummy_row: int,
    targets,            # [E] int32 target node ids (-1 = skip)
    sources,            # [E] int32 new node ids
    all_vectors,        # the row table ([cap, d] or [cap, W] words)
    metric: Metric,
    maxdeg: int,
    max_in: int,
    lane_chunk: int = 1024,
    lane_budget: int | None = None,
):
    """Append the sources to their targets' rows, re-selecting a row by the
    heuristic where it overflows. Edges are sorted by target (stable); the
    first lane of each target's segment updates that row; at most
    ``max_in`` incomers a target a round are kept, in the order of the
    sort (the arrival order of concurrent inserts in the reference's
    threaded server).

    ``lane_budget`` caps the lanes processed after the valid lanes are
    moved to the front (upper levels: a many-sigma bound on their
    contributing nodes; a target past it misses this round's reverse
    edges). Each lane reads and writes only its own target's row, so how
    the lanes are cut into chunks of at most ``lane_chunk`` does not change
    the result."""
    with span("build.reverse"):
        e = targets.shape[0]
        r = adjacency.shape[0]
        dev = targets.device
        key = torch.where(targets >= 0, targets, 2**30)
        order = torch.sort(key, stable=True).indices
        t_sorted = targets[order]
        s_sorted = sources[order]
        valid = t_sorted >= 0
        first = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                           t_sorted[1:] != t_sorted[:-1]]) & valid
        pos = torch.arange(e, device=dev)
        seg_start = torch.cummax(torch.where(first, pos, 0), 0).values
        rank = pos - seg_start

        # incoming table [R, max_in], flat; masked lanes go to the dummy row
        keep = valid & (rank < max_in)
        t_rows = row_of_target(torch.clamp(t_sorted, min=0)).long()
        inc = torch.full((r * max_in,), -1, dtype=torch.int32, device=dev)
        _masked_set(inc, t_rows * max_in + torch.clamp(rank, max=max_in - 1),
                    s_sorted, keep, dummy_row * max_in)
        inc = inc.view(r, max_in)

        # lane pass: one lane per first-occurrence target
        lane_all = torch.where(first, t_sorted, -1)
        if lane_budget is not None and lane_budget < e:
            order2 = torch.sort((lane_all < 0).int(), stable=True).indices
            lane_all = lane_all[order2][:lane_budget]
        c2 = maxdeg + max_in
        lower = torch.tril(torch.ones((c2, c2), dtype=torch.bool, device=dev),
                           diagonal=-1)
        for start in range(0, lane_all.shape[0], lane_chunk):
            lt = lane_all[start:start + lane_chunk]
            active = lt >= 0
            lrow = torch.where(active, row_of_target(torch.clamp(lt, min=0)),
                               dummy_row).long()
            cand = torch.cat([adjacency[lrow], inc[lrow]], dim=1)  # [L, c2]
            cvalid = (cand >= 0) & active[:, None]
            # an incomer can already be a forward neighbour (t chose s and s
            # chose t in one round): keep each id's first occurrence only
            eq = cand[:, :, None] == cand[:, None, :]
            dup = (eq & lower[None] & cvalid[:, None, :]).any(2)
            cvalid &= ~dup
            cand_c = torch.where(cvalid, cand, 0).long()
            tvec = all_vectors[torch.clamp(lt, min=0).long()]
            tsq = _sq_of(tvec, metric)
            cvecs = all_vectors[cand_c]  # [L, c2, d]
            csq = _sq_of(cvecs, metric)
            d_t = _pair_dists(tvec[:, None, :], tsq[:, None], cvecs, csq,
                              metric)[:, 0, :]
            d_t = torch.where(cvalid, d_t, _INF)
            overflow = cvalid.sum(1) > maxdeg
            # candidates by distance to the target (stable), the pairwise
            # matrix permuted along both axes
            d_s, perm = torch.sort(d_t, dim=1, stable=True)
            cand_s = torch.gather(cand, 1, perm)
            valid_s = torch.gather(cvalid, 1, perm)
            pair_u = _pair_dists(cvecs, csq, cvecs, csq, metric)
            pair = torch.gather(pair_u, 1, perm[:, :, None].expand(-1, -1, c2))
            pair = torch.gather(pair, 2, perm[:, None, :].expand(-1, c2, -1))
            sel = select_heuristic_batch(d_s, pair, valid_s, maxdeg)
            pruned = _mask_to_ids(cand_s, sel, maxdeg)
            appended = _mask_to_ids(cand_s, valid_s, maxdeg)
            new_row = torch.where(overflow[:, None], pruned, appended)
            _masked_set(adjacency, lrow, new_row, active, dummy_row)


def _insert_round(st: BuildState, ids, level_ids: tuple, level_vecs: tuple,
                  ids_dev, efc: int, max_in: int, flat_cand: bool = False):
    """Insert one round of node ids (numpy [B] int32, -1 = padding lane)
    into ``st``, in place.

    ``level_ids``: per-level id tensors (level_ids[l-1] = the ids of level
    >= l, -1 padded); upper-level neighbours are selected from the exact
    nearest built nodes of the level. ``flat_cand``: the level-0 pool comes
    from a masked flat scan of the built prefix instead of a beam search.
    ``level_vecs``: the levels' gathered rows and squared norms (-1 pads
    gather row 0); ``ids_dev``: ``ids`` on the device. Levels with no
    node of the round are skipped: their scatters would only rewrite the
    dummy rows.
    """
    metric = Metric(st.metric)
    ids = np.asarray(ids, np.int32)
    dev = st.vectors.device
    b = ids.shape[0]
    m = st.m
    m0 = 2 * m
    cap = st.vectors.shape[0]
    ucap = st.upper_neighbors.shape[0]
    active = ids_dev >= 0
    safe_ids = torch.clamp(ids_dev, min=0)
    sl = safe_ids.long()
    gv = st.vectors  # the reference's bf16 gather view exists on a TPU only
    qvecs = gv[sl]
    qsq = _sq_of(qvecs, metric)

    with span("build.candidates"):
        if flat_cand:
            not_built = torch.arange(cap, device=dev) >= st.n
            d_cand, cand = flat_search(gv, st.sq_norms, qvecs, k=efc,
                                       metric=metric, deleted=not_built)
        else:
            d_cand, cand, _ = search_batched(
                _graph_view(st), qvecs, k=efc, ef=efc, expand=4,
                seeds=16 if st.upper_ids is not None else 1)

    # within-batch candidates (exact); self and padding lanes masked
    wb_full = _pair_dists(qvecs[None], qsq[None], qvecs[None], qsq[None],
                          metric)[0]
    bad = torch.eye(b, dtype=torch.bool, device=dev) | ~active[None, :]
    wb_full = wb_full.masked_fill(bad, _INF)
    wb_d, wb_j = _smallest(wb_full, min(b, m0))
    wb_ids = torch.where(torch.isfinite(wb_d), safe_ids[wb_j], -1)

    # merged pool sorted by (distance, id), deduplicated
    pool_ids = torch.cat([cand, wb_ids], dim=1)
    pool_d = torch.cat([torch.where(cand >= 0, d_cand, _INF),
                        torch.where(wb_ids >= 0, wb_d, _INF)], dim=1)
    pool_d, pool_ids = _sort_pool(pool_d, pool_ids)
    dup = torch.cat([torch.zeros((b, 1), dtype=torch.bool, device=dev),
                     pool_ids[:, 1:] == pool_ids[:, :-1]], dim=1)
    # a node finds itself when it is the pre-seeded entry point
    pool_valid = ((pool_ids >= 0) & ~dup & active[:, None]
                  & (pool_ids != safe_ids[:, None]))
    pool_d = torch.where(pool_valid, pool_d, _INF)
    pvecs = gv[torch.where(pool_valid, pool_ids, 0).long()]  # [B, C, d]
    psq = _sq_of(pvecs, metric)
    pair = _pair_dists(pvecs, psq, pvecs, psq, metric)  # [B, C, C]

    # ---- level 0: select, forward scatter, reverse update ----
    sel0 = select_heuristic_batch(pool_d, pair, pool_valid, m)
    fwd0 = _mask_to_ids(pool_ids, sel0, m)  # [B, m]
    row0 = torch.cat([fwd0, torch.full((b, m0 - m), -1, dtype=torch.int32,
                                       device=dev)], dim=1)
    _masked_set(st.neighbors0, safe_ids, row0, active, cap)
    _scatter_reverse(
        st.neighbors0, lambda t: t, cap,
        torch.where(active[:, None], fwd0, -1).reshape(-1),
        safe_ids.repeat_interleave(m), gv, metric, m0, max_in,
        # one chunk up to 16k lanes: fewer chunks, fewer selection loops
        lane_chunk=16384,
    )

    # ---- upper levels: exact per-level candidate pools ----
    live = ids >= 0
    new_lv = np.where(live, st.host_levels[np.maximum(ids, 0)], -1)
    new_levels = torch.where(active, st.levels[sl], -1)
    flat = st.upper_neighbors.view(ucap * LMAX, m)
    dummy_flat = (ucap - 1) * LMAX  # a row of the dummy slot
    n0 = st.n  # nodes inserted before this round
    for lvl in range(1, len(level_ids) + 1):
        if new_lv.max() < lvl:
            break
        node_has = new_levels >= lvl
        lids = level_ids[lvl - 1]  # [Ll] -1 padded
        lvecs, lsq = level_vecs[lvl - 1]
        d_up = _pair_dists(qvecs[None], qsq[None], lvecs[None], lsq[None],
                           metric)[0]
        usable = (lids >= 0) & (lids < n0)  # inserted; never the node itself
        d_up = d_up.masked_fill(~usable[None, :], _INF)
        up_d, uj = _smallest(d_up, min(2 * m, lids.shape[0]))
        up_ids = torch.where(torch.isfinite(up_d), lids[uj], -1)
        # merged with the batch members of this level
        wb_lvl_ok = st.levels[torch.clamp(wb_ids, min=0).long()] >= lvl
        wb_ids_l = torch.where((wb_ids >= 0) & wb_lvl_ok, wb_ids, -1)
        pu_ids = torch.cat([up_ids, wb_ids_l], dim=1)
        pu_d = torch.cat([torch.where(up_ids >= 0, up_d, _INF),
                          torch.where(wb_ids_l >= 0, wb_d, _INF)], dim=1)
        pu_d, pu_ids = _sort_pool(pu_d, pu_ids)
        udup = torch.cat([torch.zeros((b, 1), dtype=torch.bool, device=dev),
                          pu_ids[:, 1:] == pu_ids[:, :-1]], dim=1)
        pu_ok = ((pu_ids >= 0) & ~udup & node_has[:, None]
                 & (pu_ids != safe_ids[:, None]))
        pu_d = torch.where(pu_ok, pu_d, _INF)
        puv = gv[torch.where(pu_ok, pu_ids, 0).long()]
        pusq = _sq_of(puv, metric)
        upair = _pair_dists(puv, pusq, puv, pusq, metric)
        sel = select_heuristic_batch(pu_d, upair, pu_ok, m)
        fwd = _mask_to_ids(pu_ids, sel, m)  # [B, m]
        slots = st.upper_slot[sl].long()
        _masked_set(flat, slots * LMAX + (lvl - 1), fwd, node_has, dummy_flat)
        _scatter_reverse(
            flat,
            lambda t, lvl=lvl: (torch.clamp(st.upper_slot[t.long()], 0, ucap - 1)
                                * LMAX + (lvl - 1)),
            dummy_flat,
            torch.where(node_has[:, None], fwd, -1).reshape(-1),
            safe_ids.repeat_interleave(m), gv, metric, m, max_in,
            lane_chunk=4096,
            # level >= 1 holds ~B/m of the batch (P(level >= l) = m^-l), so
            # its valid lanes number ~B; 4B is a >20-sigma bound
            lane_budget=min(b * m, 4 * b),
        )

    # ---- entry point / max level / count: the first maximum of the batch
    # becomes the entry if it is strictly above the current maximum ----
    j = int(np.argmax(new_lv))
    if new_lv[j] > st.max_level:
        st.entry, st.max_level = int(max(ids[j], 0)), int(new_lv[j])
    st.n += int(live.sum())
    return st


def insert_rounds(states, level_ids, groups, efc: int, max_in: int) -> None:
    """Run the rounds of ``groups`` into the S shards' ``states``, in place.

    ``groups`` yields (rounds, flat_cand): ``rounds`` numpy [S, size] int32
    ids (-1 = padding lane), one a round in order, all on the pool route
    ``flat_cand``; a group's ids go to the device in one copy.
    ``level_ids``: the per-level [S, size] id lists (``_level_id_lists``).
    The levels' rows are gathered once. A shard whose lanes are all -1 in a
    round skips it (its round would only rewrite the dummy rows); shards
    are independent, so their order inside a round does not change the
    result.
    """
    dev = states[0].vectors.device
    metric = Metric(states[0].metric)
    lids = [torch.from_numpy(a).to(dev) for a in level_ids]
    shards = []
    for si, st in enumerate(states):
        lv = tuple(a[si] for a in lids)
        rows = [st.vectors[torch.clamp(ids, min=0).long()] for ids in lv]
        shards.append((lv, tuple((r, _sq_of(r, metric)) for r in rows)))
    for rounds, flat_cand in groups:
        ids_dev = torch.from_numpy(np.concatenate(rounds, 1)).to(dev)
        at = 0
        for ids in rounds:
            size = ids.shape[1]
            for si, st in enumerate(states):
                if ids[si, 0] >= 0:
                    _insert_round(st, ids[si], *shards[si], ids_dev[si, at:at + size],
                                  efc, max_in, flat_cand)
            at += size


def ramped_batches(n: int, batch: int, min_batch: int = 32):
    """Round schedule (start, live count, round size): rounds ramp 4x from
    ``min_batch`` so a round never exceeds ~1/4 of the built graph (batch
    staleness is what costs recall early), and large graphs run at full
    ``batch``."""
    pos = 0
    while pos < n:
        b = min_batch
        while b * 4 <= batch and b * 4 <= max(pos, min_batch) // 4:
            b *= 4
        if batch <= max(pos, min_batch) // 4:
            b = batch  # graph is big enough for the full round size
        b = min(b, batch)
        yield pos, min(b, n - pos), b
        pos += min(b, n - pos)


def _flat_cand(candidates: str, built: int, flat_until: int) -> bool:
    """The pool route of rounds that start after ``built`` nodes: flat for
    "flat", and for "hybrid" while fewer than ``flat_until``."""
    return candidates == "flat" or (candidates == "hybrid" and built < flat_until)


def build_groups(n: int, counts, batch: int, candidates: str, flat_until: int,
                 group: int = ROUND_GROUP):
    """The rounds of a build of S shards of ``counts`` nodes (``n`` the
    longest) as (ids [R, S, size], flat_cand, done): the ramped schedule,
    consecutive rounds of one size stacked into groups of at most
    ``group``; a round's lanes hold its live positions, -1 past them and
    past a shard's count. The hybrid switch is checked once a group, on the
    ``built`` positions before it; ``done`` counts them after it."""
    counts = np.asarray(counts)[:, None]
    pending, built, done = [], 0, 0
    for start, live, size in ramped_batches(n, batch):
        if pending and (size != pending[0].shape[1] or len(pending) == group):
            yield np.stack(pending), _flat_cand(candidates, built, flat_until), done
            pending, built = [], done
        lane = start + np.arange(size)
        ok = (lane < start + live) & (lane < counts)
        pending.append(np.where(ok, lane, -1).astype(np.int32))
        done = start + live
    if pending:
        yield np.stack(pending), _flat_cand(candidates, built, flat_until), done


def insert_groups(first, counts, span: int, batch: int, candidates: str,
                  flat_until: int, built: int, group: int = ROUND_GROUP):
    """The rounds of an insert into S shards as (rounds, flat_cand): a round
    at each offset pos = 0, batch, .. < ``span``, ``batch`` lanes wide (the
    last one span - pos); lane j holds shard si's node first[si] + pos + j
    while pos + j < counts[si], else -1. At most ``group`` rounds a group;
    the hybrid switch is checked once a group, on ``built`` + pos nodes."""
    first = np.asarray(first, np.int64)[:, None]
    counts = np.asarray(counts, np.int64)[:, None]
    rounds = []
    for pos in range(0, span, batch):
        off = np.arange(pos, min(pos + batch, span))
        rounds.append(np.where(off < counts, first + off, -1).astype(np.int32))
    for i in range(0, len(rounds), group):
        yield rounds[i:i + group], _flat_cand(candidates, built + i * batch, flat_until)


def _draw_levels(rng: np.random.Generator, n: int, lam: float) -> np.ndarray:
    """floor(-ln(U) * lam), capped at LMAX (insert.c:32-46's law)."""
    u = np.maximum(rng.random(n), 1e-300)
    return np.minimum((-np.log(u) * lam).astype(np.int64), LMAX).astype(np.int32)


def _upper_slots(levels: np.ndarray, start) -> tuple[np.ndarray, np.ndarray]:
    """Upper slots of S shards' [S, w] levels: shard si's nodes of level >= 1
    take start[si], start[si] + 1, .. in node order, the others -1.
    -> (slots [S, w] int32, nodes given a slot [S])."""
    has = levels >= 1
    slots = np.where(has, np.asarray(start)[:, None] + np.cumsum(has, 1) - 1, -1)
    return slots.astype(np.int32), has.sum(1)


def _level_id_lists(levels: np.ndarray, counts, rng=None) -> list[np.ndarray]:
    """Per-level id lists of S shards: out[l-1][si] = the ids of shard si
    with level >= l among its first counts[si] slots, up to the highest
    level. Levels above UPPER_POOL_CAP nodes are subsampled from ``rng`` in
    shard order (upper levels guide the descent and tolerate it; no
    subsample without ``rng``); each level is -1 padded to one power of two
    (at least 8) for all shards."""
    s = levels.shape[0]
    top = max(int(levels[si, :counts[si]].max(initial=0)) for si in range(s))
    out = []
    for level in range(1, top + 1):
        per = [np.nonzero(levels[si, :counts[si]] >= level)[0].astype(np.int32)
               for si in range(s)]
        if rng is not None:
            per = [np.sort(rng.choice(ids, UPPER_POOL_CAP, replace=False))
                   if len(ids) > UPPER_POOL_CAP else ids for ids in per]
        longest = max(max(len(ids) for ids in per), 1)
        arr = np.full((s, max(8, 1 << int(np.ceil(np.log2(longest))))), -1, np.int32)
        for si, ids in enumerate(per):
            arr[si, :len(ids)] = ids
        out.append(arr)
    return out


def check_candidates(candidates: str, flat_until: int | None,
                     store: str = "f32") -> int:
    """Raise on an unknown pool route or table type; returns ``flat_until``
    or its default, 2,000,000."""
    if candidates not in ("flat", "beam", "hybrid"):
        raise ValueError(f"candidates={candidates!r}; expected flat|beam|hybrid")
    if store not in ("f32", "bf16"):
        raise ValueError(f"store={store!r}; expected f32|bf16")
    return 2_000_000 if flat_until is None else flat_until


def plan_build(counts, lam: float, rng: np.random.Generator, batch: int):
    """The host plan of a build of S shards of ``counts`` nodes: levels
    drawn from ``rng`` shard by shard ([S, n] for the longest shard's n, 0
    past a shard's count), upper slots, the per-level id lists subsampled
    from the same generator, and each shard's entry and maximum level among
    the first round's nodes. -> (levels, slots, n_upper [S], level_ids,
    entry [S], max_level [S])."""
    levels = np.zeros((len(counts), max(counts)), np.int32)
    for si, ni in enumerate(counts):
        levels[si, :ni] = _draw_levels(rng, ni, lam)
    slots, n_upper = _upper_slots(levels, np.zeros(len(counts), np.int64))
    first = next(ramped_batches(levels.shape[1], batch))[1]
    head = [levels[si, :min(first, ni)] for si, ni in enumerate(counts)]
    return (levels, slots, n_upper, _level_id_lists(levels, counts, rng),
            [int(np.argmax(h)) for h in head], [int(h.max()) for h in head])


def plan_insert(levels: np.ndarray, counts, n_upper, owner, width: int,
                lam: float, rng: np.random.Generator, subsample: bool = True):
    """The host plan of an insert into S shards holding ``counts`` nodes and
    ``n_upper`` upper slots, their levels ``levels`` [S, cap]: new row i
    goes to shard owner[i]; its levels are drawn from ``rng`` in row order
    and each shard's rows form a block of ``width`` lanes at its count.
    Capacity doubles until every block fits. -> (levels [S, new_cap] with
    the blocks, block levels and upper slots [S, width], new_cap, ucap (+1
    dummy slot), level_ids over the grown counts)."""
    s, cap = levels.shape
    lv = _draw_levels(rng, len(owner), lam)
    blk = np.zeros((s, width), np.int32)
    for si in range(s):
        mine = lv[owner == si]
        blk[si, :len(mine)] = mine
    slots, added = _upper_slots(blk, n_upper)
    new_cap = cap
    while new_cap < int((counts + width).max()):
        new_cap = max(8, new_cap * 2)
    full = np.zeros((s, new_cap), np.int32)
    full[:, :cap] = levels
    for si in range(s):
        full[si, counts[si]:counts[si] + width] = blk[si]
    need = counts + np.bincount(owner, minlength=s)
    return (full, blk, slots, new_cap, int((n_upper + added).max()) + 1,
            _level_id_lists(full, need, rng if subsample else None))


def build_tables(vectors, sq_norms, levels, slots, ucap: int, m: int) -> dict:
    """The tables of a build of S shards, on the rows' device: ``vectors``
    [S, n, ..] and ``sq_norms`` [S, n] as given, empty adjacency (a dummy
    row at n; ucap - 1 upper slots and a dummy), the planned levels, upper
    slots and slot -> node map."""
    dev = vectors.device
    s, n = levels.shape
    return {
        "vectors": vectors,
        "sq_norms": sq_norms,
        "neighbors0": torch.full((s, n + 1, 2 * m), -1, dtype=torch.int32,
                                 device=dev),
        "upper_neighbors": torch.full((s, ucap, LMAX, m), -1, dtype=torch.int32,
                                      device=dev),
        "upper_slot": torch.from_numpy(slots).to(dev),
        "levels": torch.from_numpy(levels).to(dev),
        "upper_ids": torch.from_numpy(
            np.stack([upper_ids_from_slots(x, ucap) for x in slots])).to(dev),
    }


def grown(t: torch.Tensor, rows: int, fill) -> torch.Tensor:
    """A new [S, rows, ..] tensor: ``t`` ([S, r, ..], r <= rows) with rows
    appended, set to ``fill``."""
    extra = rows - t.shape[1]
    if extra <= 0:
        return t.clone()
    return torch.cat([t, t.new_full((t.shape[0], extra) + t.shape[2:], fill)], 1)


def put_blocks(t: torch.Tensor, starts, block: torch.Tensor) -> None:
    """t[si, starts[si]:starts[si] + B] = block[si] for every shard."""
    b = block.shape[1]
    for si, st in enumerate(starts):
        t[si, st:st + b] = block[si]


def grown_tables(tables: dict, counts, n_upper, upper_ids: np.ndarray,
                 new_cap: int, ucap: int, blocks: dict) -> dict:
    """An insert's tables: ``tables`` ([S, cap, ..], the vectors as the
    rounds' rows) grown to ``new_cap`` rows and at least ``ucap`` upper
    slots, with each shard's block of new rows (``blocks``: [S, b, ..]
    tensors or numpy arrays by table name) at its count counts[si]. A shard
    keeps its first n_upper[si] upper slots (the rest are blanks or a
    build's dummy) and their ids, ``upper_ids`` [S, >= n_upper]; its block's
    nodes take the slots ``blocks["upper_slot"]`` names. The dummy row of
    neighbors0 moves to the new cap."""
    dev = tables["levels"].device
    cap = tables["levels"].shape[1]
    u_old = tables["upper_neighbors"].shape[1]
    ucap = max(u_old, ucap)
    real = (torch.arange(u_old, device=dev)[None, :]
            < torch.from_numpy(np.asarray(n_upper)).to(dev)[:, None])
    out = {
        "vectors": grown(tables["vectors"], new_cap, 0),
        "sq_norms": grown(tables["sq_norms"], new_cap, 0),
        "neighbors0": grown(tables["neighbors0"][:, :cap], new_cap + 1, -1),
        "upper_neighbors": grown(torch.where(real[:, :, None, None],
                                             tables["upper_neighbors"], -1),
                                 ucap, -1),
        "upper_slot": grown(tables["upper_slot"], new_cap, -1),
        "levels": grown(tables["levels"], new_cap, 0),
    }
    for name, block in blocks.items():
        put_blocks(out[name], counts, torch.as_tensor(block, device=dev))
    uid = np.full((len(counts), ucap), -1, np.int32)
    slots = blocks["upper_slot"]
    for si, (n0, nu) in enumerate(zip(counts, n_upper)):
        uid[si, :nu] = upper_ids[si, :nu]
        has = slots[si] >= 0
        uid[si, slots[si][has]] = n0 + np.nonzero(has)[0]
    out["upper_ids"] = torch.from_numpy(uid).to(dev)
    return out


def build_states(tables: dict, host_levels, entry, max_level, n, m: int,
                 dim: int, metric: Metric, seeded: bool = True) -> list:
    """One BuildState a shard over views of the stacked ``tables``.
    ``seeded``: the states carry the planned ``upper_ids``, so beam rounds
    seed 16 entries from the dense entry scan (else one entry point)."""
    return [BuildState(**{k: tables[k][si] for k in TABLES},
                       host_levels=host_levels[si], entry=int(entry[si]),
                       max_level=int(max_level[si]), n=int(n[si]), m=m, dim=dim,
                       metric=int(metric),
                       upper_ids=tables["upper_ids"][si] if seeded else None)
            for si in range(len(host_levels))]


def _pq_decode_rows(codes, cb):
    """[..., S] uint8 codes -> [..., S*dsub] f32 rows (a codebook gather)."""
    sub = torch.arange(cb.shape[0], device=codes.device)
    return cb[sub, codes.long()].flatten(-2)


def pq_encode_rows(x, cb, rotation=None):
    """f32 rows -> [n, S] uint8 codes (rotated first under OPQ)."""
    if rotation is not None:
        x = x @ rotation
    return _assign(_split(x, cb.shape[0]), cb).T.contiguous()


def pq_snap(x, cb, rotation=None):
    """f32 rows -> their PQ reconstruction in the rotated space: what a PQ
    table stores of them, as rows the rounds can run over."""
    return _pq_decode_rows(pq_encode_rows(x, cb, rotation), cb)


def round_rows(vectors, quant: int, vec_scales=None, cb=None,
               widen: bool = True):
    """The rows an insert's rounds run over, of a stored [S, cap, ..]
    table: PQ codes decoded through ``cb`` (rows in the rotated space), i8
    codes times their scales, f16/bf16 rows widened to f32 where ``widen``;
    other tables as they are."""
    if quant == QUANT_PQ:
        return _pq_decode_rows(vectors, cb)
    if quant == int(QuantKind.I8):
        return vectors.float() * vec_scales[..., None]
    if widen and vectors.dtype in (torch.bfloat16, torch.float16):
        return vectors.float()
    return vectors


def stored_rows(rows, quant: int, dtype, cb=None):
    """``round_rows`` back: the rows [S, cap, ..] stored as before, exact
    for the old rows. PQ rows are centroids in the rotated space, so they
    are encoded without the rotation and the old codes come back unchanged;
    i8 rows are quantised again; others take ``dtype``. -> (vectors,
    vec_scales or None)."""
    if quant == QUANT_PQ:
        return torch.stack([pq_encode_rows(r, cb) for r in rows]), None
    if quant == int(QuantKind.I8):
        return quantize_i8(rows)
    return rows.to(dtype), None


def _labels_i64(labels, n: int, dev, start: int = 0) -> torch.Tensor:
    lab = (np.arange(start, start + n, dtype=np.uint64) if labels is None
           else np.ascontiguousarray(labels, np.uint64))
    return torch.from_numpy(lab.view(np.int64)).to(dev)


def build_on_device(
    vectors,
    params: HnswParams,
    batch: int = 256,
    seed: int = 0,
    max_in: int | None = None,
    labels: np.ndarray | None = None,
    progress_cb=None,
    candidates: str = "flat",
    donate: bool = False,
    store: str = "f32",
    flat_until: int | None = None,
    device: str | torch.device | None = None,
) -> DeviceGraph:
    """Build an HNSW graph over ``vectors`` on ``device`` (default cuda): the
    one-shard case of the plan ``build_sharded_device`` runs.

    ``vectors``: numpy rows (f32; packed uint32 words for hamming) or a
    tensor. A tensor already on the device in the stored type is used in
    place with ``donate=True`` (the caller's tensor becomes the graph's
    table); otherwise it is copied.

    ``store``: "f32" or "bf16", the table's type (l2sq / cos); a bf16 table
    returns a bf16 graph (quant F16).

    ``candidates``: "flat" (default) pools from a masked flat scan of the
    built prefix; "beam" from a beam search of the partial graph (the
    reference's construction semantics); "hybrid" flat while fewer than
    ``flat_until`` nodes (default 2,000,000) are built, beam after (the flat
    scan grows with the prefix, the beam does not). The switch is checked
    once per group of ROUND_GROUP rounds.

    ``progress_cb(frac)`` is called with the built fraction in [0, 1] after
    a group whenever its whole percent changed.
    """
    flat_until = check_candidates(candidates, flat_until, store)
    dev = resolve_device(device)
    metric = Metric(params.metric)
    if metric == Metric.HAMMING:
        store_dtype = torch.int32
    else:
        store_dtype = torch.bfloat16 if store == "bf16" else torch.float32
    if isinstance(vectors, torch.Tensor):
        if donate and vectors.device == dev and vectors.dtype == store_dtype:
            vec_dev = vectors
        else:
            vec_dev = vectors.to(dev, store_dtype, copy=True)
    else:
        np_dtype = np.uint32 if metric == Metric.HAMMING else np.float32
        host = np.ascontiguousarray(vectors, np_dtype)
        if metric == Metric.HAMMING:
            host = host.view(np.int32)
        vec_dev = torch.from_numpy(host).to(dev).to(store_dtype)
    n = vec_dev.shape[0]
    m = params.m
    batch = min(batch, n)

    levels, slots, n_upper, level_ids, entry, max_level = plan_build(
        [n], params.level_lambda, np.random.default_rng(seed), batch)
    tables = build_tables(vec_dev[None], _sq_of(vec_dev, metric)[None], levels,
                          slots, int(n_upper[0]) + 1, m)
    states = build_states(tables, levels, entry, max_level, [0], m, params.dim,
                          metric)

    def groups():
        # the first round's graph is empty: its within-batch pool does all
        # the linking (an exact pruned kNN seed graph)
        last_pct = -1
        for ids, flat, done in build_groups(n, [n], batch, candidates, flat_until):
            yield ids, flat
            pct = done * 100 // n
            if progress_cb is not None and pct != last_pct:
                last_pct = pct
                progress_cb(done / n)

    insert_rounds(states, level_ids, groups(), params.ef_construction,
                  max_in or max(4, m // 2))
    return dataclasses.replace(
        _graph_view(states[0]), vectors=vec_dev,
        labels=_labels_i64(labels, n, dev),
        deleted=torch.zeros(n, dtype=torch.bool, device=dev),
        quant=int(QuantKind.F16 if store_dtype == torch.bfloat16
                  else QuantKind.F32))


def device_insert(
    graph: DeviceGraph,
    vectors,
    labels: np.ndarray | None = None,
    batch: int = 256,
    seed: int = 0,
    max_in: int | None = None,
    ef_construction: int = 128,
    candidates: str = "flat",
    flat_until: int | None = None,
) -> DeviceGraph:
    """Insert ``vectors`` into a copy of ``graph`` on its device by the same
    rounds (the device analog of ldb_aminsert); ``graph`` is left as it is.
    The one-shard case of the plan ``insert_sharded`` runs.

    Capacity grows by doubling when it runs out. Levels come from
    ``default_rng(seed + n0)``, n0 the graph's node count; the per-level id
    lists are not subsampled. Quantised storage runs the rounds over an f32
    view and is restored after: i8 codes are dequantised and quantised
    again, bf16 widened and rounded again (both exact for the old rows), PQ
    codes decoded through the codebook (in the rotated space, under OPQ)
    with the new rows snapped to their codes first, then encoded again
    without the rotation, so the old codes come back unchanged.
    ``candidates`` / ``flat_until``: as in ``build_on_device``, the switch
    checked once per group of ROUND_GROUP rounds ("hybrid" suits trickle
    inserts into huge graphs, where a flat scan a round would dominate).
    """
    flat_until = check_candidates(candidates, flat_until)
    metric = Metric(graph.metric)
    dev = graph.device
    pq_cb, pq_rot = graph.pq_codebook, graph.pq_rotation
    if metric == Metric.HAMMING:
        new = torch.from_numpy(
            np.ascontiguousarray(vectors, np.uint32).view(np.int32)).to(dev)
    elif isinstance(vectors, torch.Tensor) and graph.quant != QUANT_PQ:
        new = vectors.float()
    else:
        new = torch.from_numpy(np.ascontiguousarray(vectors, np.float32)).to(dev)
    if graph.quant == QUANT_PQ:
        new = pq_snap(new, pq_cb, pq_rot)
    b_new = new.shape[0]
    n0 = graph.num_nodes
    m = graph.m

    old_slots = graph.upper_slot[:n0].cpu().numpy()
    n_upper0 = int(old_slots.max()) + 1 if (old_slots >= 0).any() else 0
    if graph.upper_ids is not None:
        old_ids = graph.upper_ids[:n_upper0].cpu().numpy()
    else:
        old_ids = upper_ids_from_slots(old_slots, max(n_upper0, 1))
    levels, blk, slots, new_cap, ucap, level_ids = plan_insert(
        graph.levels[None].cpu().numpy(), np.array([n0]), np.array([n_upper0]),
        np.zeros(b_new, np.int64), b_new, 1.0 / np.log(m),
        np.random.default_rng(seed + n0), subsample=False)
    old = {k: getattr(graph, k)[None] for k in TABLES}
    old["vectors"] = round_rows(old["vectors"], graph.quant, graph.vec_scales, pq_cb)
    tables = grown_tables(
        old, [n0], [n_upper0], old_ids[None], new_cap, ucap,
        {"vectors": new[None], "sq_norms": _sq_of(new, metric)[None],
         "levels": blk, "upper_slot": slots})
    states = build_states(tables, levels, [graph.entry], [graph.max_level], [n0],
                          m, graph.dim, metric)
    insert_rounds(states, level_ids,
                  insert_groups([n0], [b_new], -(-b_new // batch) * batch, batch,
                                candidates, flat_until, n0),
                  ef_construction, max_in or max(4, m // 2))

    lab = torch.cat([graph.labels[:n0], _labels_i64(labels, b_new, dev, n0),
                     torch.zeros(new_cap - n0 - b_new, dtype=torch.int64,
                                 device=dev)])
    deleted = torch.cat([graph.deleted[:n0],
                         torch.zeros(new_cap - n0, dtype=torch.bool, device=dev)])
    vecs, scales = stored_rows(tables["vectors"], graph.quant, graph.vectors.dtype,
                               pq_cb)
    return dataclasses.replace(
        _graph_view(states[0]), vectors=vecs[0], labels=lab, deleted=deleted,
        vec_scales=None if scales is None else scales[0], pq_codebook=pq_cb,
        pq_rotation=pq_rot, quant=graph.quant)
