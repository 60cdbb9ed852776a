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


def _level_tables(gv, level_ids, metric: Metric):
    """(rows, squared norms) of each level's id list (-1 pads gather row 0)."""
    out = []
    for lids in level_ids:
        v = gv[torch.clamp(lids, min=0).long()]
        out.append((v, _sq_of(v, metric)))
    return tuple(out)


def _insert_round(st: BuildState, ids, level_ids: tuple, level_vecs: tuple,
                  ids_dev, efc: int, max_in: int, flat_cand: bool = False):
    """Insert one round of node ids (numpy [B] int32, -1 = padding lane)
    into ``st``, in place.

    ``level_ids``: per-level id tensors (level_ids[l-1] = the ids of level
    >= l, -1 padded); upper-level neighbours are selected from the exact
    nearest built nodes of the level. ``flat_cand``: the level-0 pool comes
    from a masked flat scan of the built prefix instead of a beam search.
    ``level_vecs``: the levels' gathered rows and squared norms
    (``_level_tables``); ``ids_dev``: ``ids`` on the device. Levels with no
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


def insert_rounds(st: BuildState, ids2d, level_ids: tuple, efc: int,
                  max_in: int, flat_cand: bool = False) -> BuildState:
    """Run the rounds of ``ids2d`` (numpy [R, size]) one after the other,
    in place. The levels' row gathers are made once for the group."""
    ids2d = np.asarray(ids2d, np.int32)
    level_vecs = _level_tables(st.vectors, level_ids, Metric(st.metric))
    ids_dev = torch.from_numpy(ids2d).to(st.vectors.device)
    for r in range(ids2d.shape[0]):
        _insert_round(st, ids2d[r], level_ids, level_vecs, ids_dev[r], efc,
                      max_in, flat_cand)
    return st


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


def _grouped_round_ids(n: int, batch: int):
    """Yield (ids2d [R, size], done_count): consecutive equal-size rounds of
    the ramped schedule stacked into groups of <= ROUND_GROUP."""
    pending: list[np.ndarray] = []
    pend_size = -1
    done = 0

    def flush():
        return np.stack(pending), done

    for start, live, size in ramped_batches(n, batch):
        ids = np.full(size, -1, np.int32)
        ids[:live] = np.arange(start, start + live, dtype=np.int32)
        if pending and (size != pend_size or len(pending) == ROUND_GROUP):
            yield flush()
            pending = []
        pending.append(ids)
        pend_size = size
        done = start + live
    if pending:
        yield flush()


def _draw_levels(rng: np.random.Generator, n: int, lam: float) -> np.ndarray:
    """floor(-ln(U) * lam), capped at LMAX (insert.c:32-46's law)."""
    u = np.maximum(rng.random(n), 1e-300)
    return np.minimum((-np.log(u) * lam).astype(np.int64), LMAX).astype(np.int32)


def _padded_ids(lids: np.ndarray, dev) -> torch.Tensor:
    """An id list -1 padded to a power of two (at least 8), on ``dev``."""
    size = max(8, 1 << int(np.ceil(np.log2(len(lids)))))
    padded = np.full(size, -1, np.int32)
    padded[:len(lids)] = lids
    return torch.from_numpy(padded).to(dev)


def _check_candidates(candidates: str, flat_until: int | None) -> int:
    if candidates not in ("flat", "beam", "hybrid"):
        raise ValueError(f"candidates={candidates!r}; expected flat|beam|hybrid")
    return 2_000_000 if flat_until is None else flat_until


def _labels_i64(labels, n: int, dev) -> torch.Tensor:
    lab = (np.arange(n, dtype=np.uint64) if labels is None
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
    """Build an HNSW graph over ``vectors`` on ``device`` (default cuda).

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
    flat_until = _check_candidates(candidates, flat_until)
    if store not in ("f32", "bf16"):
        raise ValueError(f"store={store!r}; expected f32|bf16")
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
    n, _ = vec_dev.shape
    m = params.m
    max_in = max_in or max(4, m // 2)
    batch = min(batch, n)

    # host-side level draws and upper slots (insert.c:32-46's law)
    rng = np.random.default_rng(seed)
    levels = _draw_levels(rng, n, params.level_lambda)
    has_upper = levels >= 1
    upper_slot = np.full(n, -1, np.int32)
    upper_slot[has_upper] = np.arange(int(has_upper.sum()), dtype=np.int32)
    ucap = int(has_upper.sum()) + 1  # +1 dummy slot for masked writes

    first = next(ramped_batches(n, batch))[1]  # the first round's live count
    st = BuildState(
        vectors=vec_dev,
        sq_norms=_sq_of(vec_dev, metric),
        neighbors0=torch.full((n + 1, 2 * m), -1, dtype=torch.int32, device=dev),
        upper_neighbors=torch.full((ucap, LMAX, m), -1, dtype=torch.int32,
                                   device=dev),
        upper_slot=torch.from_numpy(upper_slot).to(dev),
        levels=torch.from_numpy(levels).to(dev),
        host_levels=levels,
        entry=int(np.argmax(levels[:first])),
        max_level=int(levels[:first].max()),
        n=0,
        m=m,
        dim=params.dim,
        metric=int(metric),
        upper_ids=torch.from_numpy(upper_ids_from_slots(upper_slot, ucap)).to(dev),
    )

    # per-level id lists; levels above UPPER_POOL_CAP nodes are subsampled
    # (upper levels guide the descent and tolerate it)
    level_ids = []
    for lvl in range(1, LMAX + 1):
        lids = np.nonzero(levels >= lvl)[0].astype(np.int32)
        if len(lids) == 0:
            break
        if len(lids) > UPPER_POOL_CAP:
            lids = np.sort(rng.choice(lids, UPPER_POOL_CAP, replace=False))
        level_ids.append(_padded_ids(lids, dev))
    level_ids = tuple(level_ids)

    # the first round's graph is empty: its within-batch pool does all the
    # linking (an exact pruned kNN seed graph)
    last_pct = -1
    built = 0  # nodes inserted before the current group (hybrid switch)
    for ids2d, done in _grouped_round_ids(n, batch):
        insert_rounds(st, ids2d, level_ids, efc=params.ef_construction,
                      max_in=max_in,
                      flat_cand=(candidates == "flat"
                                 or (candidates == "hybrid" and built < flat_until)))
        built = done
        if progress_cb is not None:
            pct = done * 100 // n
            if pct != last_pct:
                last_pct = pct
                progress_cb(done / n)

    return DeviceGraph(
        vectors=st.vectors,
        sq_norms=st.sq_norms,
        neighbors0=st.neighbors0,
        upper_neighbors=st.upper_neighbors,
        upper_slot=st.upper_slot,
        levels=st.levels,
        labels=_labels_i64(labels, n, dev),
        deleted=torch.zeros(n, dtype=torch.bool, device=dev),
        entry=st.entry,
        max_level=st.max_level,
        num_nodes=n,
        upper_ids=st.upper_ids,
        m=m,
        dim=params.dim,
        metric=int(metric),
        quant=int(QuantKind.F16 if store_dtype == torch.bfloat16
                  else QuantKind.F32),
    )


def _grown(t: torch.Tensor, rows: int, fill) -> torch.Tensor:
    """A new tensor: ``t`` with rows appended up to ``rows``, set to fill."""
    extra = max(rows - t.shape[0], 0)
    return torch.cat([t, t.new_full((extra,) + t.shape[1:], fill)])


def _pq_decode_rows(codes, cb):
    """[n, S] uint8 codes -> [n, S*dsub] f32 rows (a codebook gather)."""
    s = cb.shape[0]
    sub = torch.arange(s, device=codes.device)[None, :]
    return cb[sub, codes.long()].reshape(codes.shape[0], -1)


def _pq_encode_rows(x, cb, rotation=None):
    """f32 rows -> [n, S] uint8 codes (rotated first under OPQ)."""
    if rotation is not None:
        x = x @ rotation
    return _assign(_split(x, cb.shape[0]), cb).T.contiguous()


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

    Capacity grows by doubling when it runs out. Levels come from
    ``default_rng(seed + n0)``, n0 the graph's node count. Quantised
    storage runs the rounds over an f32 view and is restored after: i8
    codes are dequantised and quantised again, bf16 widened and rounded
    again (both exact for the old rows), PQ codes decoded through the
    codebook (in the rotated space, under OPQ) with the new rows snapped to
    their codes first, then encoded again without the rotation, so the old
    codes come back unchanged. ``candidates`` / ``flat_until``: as in
    ``build_on_device`` ("hybrid" suits trickle inserts into huge graphs,
    where a flat scan a round would dominate).
    """
    flat_until = _check_candidates(candidates, flat_until)
    metric = Metric(graph.metric)
    dev = graph.device
    restore = None
    pq_cb = pq_rot = None
    base = graph.vectors
    if graph.quant == QUANT_PQ:
        restore = "pq"
        pq_cb, pq_rot = graph.pq_codebook, graph.pq_rotation
        base = _pq_decode_rows(graph.vectors, pq_cb)
        x = torch.from_numpy(np.ascontiguousarray(vectors, np.float32)).to(dev)
        vectors = _pq_decode_rows(_pq_encode_rows(x, pq_cb, pq_rot), pq_cb)
    if graph.quant == int(QuantKind.I8):
        restore = "i8"
        base = graph.vectors.float() * graph.vec_scales[:, None]
    elif graph.vectors.dtype in (torch.bfloat16, torch.float16):
        restore = graph.vectors.dtype
        base = graph.vectors.float()
    if metric == Metric.HAMMING:
        new = torch.from_numpy(
            np.ascontiguousarray(vectors, np.uint32).view(np.int32)).to(dev)
    elif isinstance(vectors, torch.Tensor):
        new = vectors.float()
    else:
        new = torch.from_numpy(np.ascontiguousarray(vectors, np.float32)).to(dev)
    b_new = new.shape[0]
    n0 = graph.num_nodes
    m = graph.m
    need = n0 + b_new
    max_in = max_in or max(4, m // 2)

    # ---- grow (amortised doubling) ----
    cap = graph.cap
    new_cap = cap
    while new_cap < need:
        new_cap = max(8, new_cap * 2)
    rng = np.random.default_rng(seed + n0)
    new_levels = _draw_levels(rng, b_new, 1.0 / np.log(m))

    old_slots = graph.upper_slot[:n0].cpu().numpy()
    n_upper0 = int(old_slots.max()) + 1 if (old_slots >= 0).any() else 0
    add_upper = int((new_levels >= 1).sum())
    new_slot = np.full(b_new, -1, np.int32)
    new_slot[new_levels >= 1] = n_upper0 + np.arange(add_upper, dtype=np.int32)
    ucap_new = max(graph.upper_neighbors.shape[0], n_upper0 + add_upper + 1)

    vecs = _grown(base, new_cap, 0)
    vecs[n0:need] = new
    sqn = _grown(graph.sq_norms, new_cap, 0)
    sqn[n0:need] = _sq_of(new, metric)
    # the dummy row moves to the new cap
    nbr0 = torch.cat([graph.neighbors0[:cap],
                      torch.full((new_cap + 1 - cap, 2 * m), -1,
                                 dtype=torch.int32, device=dev)])
    levels = _grown(graph.levels, new_cap, 0)
    levels[n0:need] = torch.from_numpy(new_levels).to(dev)
    slots = _grown(graph.upper_slot, new_cap, -1)
    slots[n0:need] = torch.from_numpy(new_slot).to(dev)
    # exactly the n_upper0 real slots, then blank ones: graphs from
    # to_device carry no dummy slot, so the old last slot is real
    upper = torch.cat([graph.upper_neighbors[:n_upper0],
                       torch.full((ucap_new - n_upper0, LMAX, m), -1,
                                  dtype=torch.int32, device=dev)])
    # the planned slot -> id map of the grown graph, made before the rounds
    # so beam rounds take the dense entry scan
    up_ids = np.full(ucap_new, -1, np.int32)
    if graph.upper_ids is not None:
        up_ids[:n_upper0] = graph.upper_ids[:n_upper0].cpu().numpy()
    else:
        up_ids[:n_upper0] = upper_ids_from_slots(old_slots, max(n_upper0, 1))[:n_upper0]
    up_ids[n_upper0:n_upper0 + add_upper] = (
        n0 + np.nonzero(new_levels >= 1)[0].astype(np.int32))

    all_levels = np.concatenate([graph.levels[:n0].cpu().numpy(), new_levels])
    host_levels = np.zeros(new_cap, np.int32)
    host_levels[:need] = all_levels
    st = BuildState(
        vectors=vecs, sq_norms=sqn, neighbors0=nbr0, upper_neighbors=upper,
        upper_slot=slots, levels=levels, host_levels=host_levels,
        entry=graph.entry, max_level=graph.max_level, n=n0, m=m,
        dim=graph.dim, metric=int(metric),
        upper_ids=torch.from_numpy(up_ids).to(dev),
    )
    level_ids = tuple(
        _padded_ids(np.nonzero(all_levels >= lvl)[0].astype(np.int32), dev)
        for lvl in range(1, int(all_levels.max(initial=0)) + 1))

    rounds = []
    for pos in range(n0, need, batch):
        ids = np.full(batch, -1, np.int32)
        end = min(pos + batch, need)
        ids[:end - pos] = np.arange(pos, end, dtype=np.int32)
        rounds.append(ids)
    for i in range(0, len(rounds), ROUND_GROUP):
        built = n0 + i * batch  # nodes live before this group
        insert_rounds(st, np.stack(rounds[i:i + ROUND_GROUP]), level_ids,
                      efc=ef_construction, max_in=max_in,
                      flat_cand=(candidates == "flat"
                                 or (candidates == "hybrid" and built < flat_until)))

    if labels is None:
        labels = np.arange(n0, need, dtype=np.uint64)
    lab = torch.cat([graph.labels[:n0], _labels_i64(labels, b_new, dev),
                     torch.zeros(new_cap - need, dtype=torch.int64, device=dev)])
    deleted = torch.cat([graph.deleted[:n0],
                         torch.zeros(new_cap - n0, dtype=torch.bool, device=dev)])
    out_vecs, out_scales = st.vectors, None
    if restore == "pq":
        # old rows are decoded centroids (re-encoding is the identity), new
        # rows were snapped to their centroids above
        out_vecs = _pq_encode_rows(st.vectors, pq_cb)
    elif restore == "i8":
        out_vecs, out_scales = quantize_i8(st.vectors)
    elif restore is not None:
        out_vecs = st.vectors.to(restore)
    return DeviceGraph(
        vectors=out_vecs, sq_norms=st.sq_norms, neighbors0=st.neighbors0,
        upper_neighbors=st.upper_neighbors, upper_slot=st.upper_slot,
        levels=st.levels, labels=lab, deleted=deleted,
        entry=st.entry, max_level=st.max_level, num_nodes=need,
        upper_ids=st.upper_ids, vec_scales=out_scales,
        pq_codebook=pq_cb, pq_rotation=pq_rot,
        m=m, dim=graph.dim, metric=int(metric), quant=graph.quant,
    )
