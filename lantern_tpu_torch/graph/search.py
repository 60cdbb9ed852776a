"""Batched HNSW search (port of lantern_tpu/graph/search.py).

A block of Q queries searches the graph in lockstep:

- entry selection: one dense scan over the ~n/m upper-level nodes
  (``graph.upper_ids``) returns the best ``seeds`` entries per query; graphs
  without ``upper_ids`` take the greedy upper-level descent instead;
- level 0: a beam of ef candidates per query. Each iteration expands the
  ``expand`` best unexpanded beam entries, gathers their neighbor lists,
  drops ids already in the beam or in the log of expanded ids, and scores
  the rest with K1 (``ops/gather_dists.py``: the hand-written gather-distance
  kernel on the card), then merges by a stable sort that carries the payloads;
- PQ graphs (``quant == QUANT_PQ``) score candidates by ADC instead: a
  per-query table ``adc_lut`` built once per batch, summed over the gathered
  codes; their entry scan is a PQ flat scan (the PQ decode kernel). Under
  OPQ the query is rotated once, at the top of ``search_batched``;
- hamming graphs (int32 words, int32 word queries) score candidates by a row
  gather and XOR/popcount in plain torch, as the reference does in jnp; their
  entry scan is a flat hamming scan, so it runs K4 (``ops/hamming.py``). i8
  graphs gather the int8 rows and scale the products by ``vec_scales``;
- termination: the HNSW criterion (best unexpanded > worst of a full beam)
  as a per-query active mask.

The reference runs the loop on the device (``lax.while_loop``). Here it is a
Python loop whose activity test syncs the host only every
``_CHECK_EVERY`` iterations. The iterations run past the last active one are
exact no-ops (nothing is selected, so every expansion reads the all -1
dummy row ``cap``), and ``iterations`` counts only those in which some query
was active, so stats equal the reference's.

Deleted and excluded nodes route traversal but are dropped from the results
(the reference's tombstone semantics, scan.c:296-300 / delete.c).
"""

from __future__ import annotations

import torch

from lantern_tpu_torch.config import Metric, SearchParams
from lantern_tpu_torch.flat import flat_search, flat_search_pq
from lantern_tpu_torch.graph.device import QUANT_PQ, DeviceGraph
from lantern_tpu_torch.native import LMAX
from lantern_tpu_torch.ops.distance import hamming_dist
from lantern_tpu_torch.ops.gather_dists import gather_dists
from lantern_tpu_torch.quant.pq import adc_distances, adc_lut
from lantern_tpu_torch.utils.bench import span

_INF = float("inf")
# beam iterations between host-side "any query still active?" checks
_CHECK_EVERY = 4


def _candidate_dists(graph: DeviceGraph, queries, q_sq, cand_ids, lut=None):
    """Distances from each query to its candidates: K1 for f32/bf16 rows,
    ADC for PQ codes (``lut`` [Q, S, K] from adc_lut), plain torch for
    hamming words and i8 codes (the reference's jnp branches, which bypass
    its gather kernel too).

    queries [Q, d] f32 (or [Q, W] int32 words), cand_ids [Q, C] -> [Q, C]
    f32. Ids are clipped to [0, cap) here: ``vectors`` has no sentinel row,
    and K1 reads any id it is given.
    """
    metric = Metric(graph.metric)
    ids = torch.clamp(cand_ids, 0, graph.cap - 1).to(torch.int32).contiguous()
    if metric == Metric.HAMMING:
        return hamming_dist(queries[:, None, :], graph.vectors[ids.long()])
    if graph.vec_scales is not None:  # i8 codes: widen, dot, scale per row
        rows = ids.long()
        dots = torch.einsum("qd,qcd->qc", queries, graph.vectors[rows].float())
        dots = dots * graph.vec_scales[rows]
        x_sq = graph.sq_norms[rows]
        if metric == Metric.L2SQ:
            return q_sq[:, None] - 2.0 * dots + x_sq
        return 1.0 - dots / torch.clamp(torch.sqrt(q_sq)[:, None]
                                        * torch.sqrt(x_sq), min=1e-30)
    if graph.quant == QUANT_PQ:
        rows = ids.long()
        part = adc_distances(lut, graph.vectors[rows])
        if metric == Metric.L2SQ:
            return part  # the LUT already holds |q_s - c_sk|^2
        # cos: part sums dots; |x| from the decoded rows' norms
        xn = torch.sqrt(graph.sq_norms[rows])
        return 1.0 - part / torch.clamp(torch.sqrt(q_sq)[:, None] * xn,
                                        min=1e-30)
    return gather_dists(graph.vectors, ids, queries, q_sq, metric)


def _upper_descent(graph: DeviceGraph, queries, q_sq, lut=None):
    """Greedy 1-beam descent from the entry point down to level 1.

    Returns (entry id [Q], its distance [Q]) for the level-0 beam. Each
    greedy step syncs the host once (the fallback for graphs without
    ``upper_ids``).
    """
    q = queries.shape[0]
    dev = queries.device
    ucap, _, m = graph.upper_neighbors.shape
    flat_upper = graph.upper_neighbors.reshape(ucap * LMAX, m)
    curr = torch.full((q,), graph.entry, dtype=torch.int32, device=dev)
    curr_d = _candidate_dists(graph, queries, q_sq, curr[:, None], lut)[:, 0]
    for lvl in range(graph.max_level, 0, -1):
        improving = torch.ones(q, dtype=torch.bool, device=dev)
        for _ in range(64):
            if not bool(improving.any()):
                break
            slot = torch.clamp(graph.upper_slot[curr.long()], 0, ucap - 1)
            nbrs = flat_upper[(slot * LMAX + (lvl - 1)).long()]  # [Q, m]
            valid = nbrs >= 0
            d = _candidate_dists(graph, queries, q_sq,
                                 torch.where(valid, nbrs, 0), lut)
            d = torch.where(valid, d, _INF)
            j = torch.argmin(d, dim=1, keepdim=True)
            best_d = torch.gather(d, 1, j)[:, 0]
            best_id = torch.gather(nbrs, 1, j)[:, 0]
            improving = improving & (best_d < curr_d)
            curr = torch.where(improving, best_id, curr)
            curr_d = torch.where(improving, best_d, curr_d)
    return curr, curr_d


def _upper_entry_scan(graph: DeviceGraph, queries, q_sq, seeds: int = 1,
                      lut=None):
    """Entry selection by one dense scan over the upper-level node set.

    Scores every upper node (a flat scan of ~n/m rows; for PQ graphs the
    PQ flat scan of their codes, with ``queries`` already rotated) and
    returns the top ``seeds`` as (entry_ids [Q, seeds] int32, entry_d
    [Q, seeds]). Missing seeds get id -1 / dist inf; seed 0 falls back to
    ``graph.entry`` (scored like a candidate) so at least one live candidate
    exists.
    """
    uids = graph.upper_ids
    safe = torch.clamp(uids, min=0).long()
    # blank slots, and planned-but-not-yet-inserted nodes of a growing graph
    excluded = (uids < 0) | (safe >= graph.num_nodes)
    if graph.quant == QUANT_PQ:
        d, loc = flat_search_pq(graph.vectors[safe], graph.pq_codebook,
                                queries, k=seeds, metric=graph.metric,
                                deleted=excluded)
    else:
        cached = graph.upper_vectors is not None and graph.upper_sq is not None
        d, loc = flat_search(
            graph.upper_vectors if cached else graph.vectors[safe],
            graph.upper_sq if cached else graph.sq_norms[safe],
            queries, k=seeds, metric=graph.metric, deleted=excluded,
            vec_scales=(None if graph.vec_scales is None
                        else graph.vec_scales[safe]),
        )
    found = loc >= 0
    entry_ids = torch.where(
        found, safe[torch.clamp(loc, 0, safe.shape[0] - 1).long()].int(), -1
    )
    q = queries.shape[0]
    entry = torch.full((q, 1), graph.entry, dtype=torch.int32,
                       device=queries.device)
    dflt = _candidate_dists(graph, queries, q_sq, entry, lut)[:, 0]
    entry_ids[:, 0] = torch.where(found[:, 0], entry_ids[:, 0], graph.entry)
    entry_d = torch.where(found, d, _INF)
    entry_d[:, 0] = torch.where(found[:, 0], d[:, 0], dflt)
    return entry_ids, entry_d


def _dedup_fresh(ids, fresh):
    """Within-row dedup: keep only the first occurrence of each fresh id
    (a stable sort carrying positions, then a scatter back)."""
    q, c = ids.shape
    iota = torch.arange(c, device=ids.device).expand(q, c)
    key = torch.where(fresh, ids.long(), -1 - iota)  # invalids: unique negatives
    skey, spos = torch.sort(key, dim=1, stable=True)
    dup_sorted = torch.cat(
        [torch.zeros((q, 1), dtype=torch.bool, device=ids.device),
         skey[:, 1:] == skey[:, :-1]], dim=1)
    dup = torch.zeros_like(fresh).scatter_(1, spos, dup_sorted)
    return fresh & ~dup


def _active_mask(beam_d, beam_ids, expanded):
    unexp = (beam_ids >= 0) & ~expanded
    best_unexp = torch.where(unexp, beam_d, _INF).min(dim=1).values
    worst = beam_d[:, -1]  # inf while the beam is not full
    return unexp.any(dim=1) & (best_unexp <= worst)


def search_batched(
    graph: DeviceGraph,
    queries: torch.Tensor,
    k: int = 10,
    ef: int = 64,
    expand: int = 1,
    max_iters: int | None = None,
    with_stats: bool = False,
    exclude: torch.Tensor | None = None,
    seeds: int = 1,
):
    """Batched k-NN search. queries [Q, d] -> (dists, ids, labels) [Q, k].

    Invalid result slots (fewer than k reachable live nodes) have id -1,
    dist +inf, label 0. Labels are int64 holding the u64 bits. Hamming
    graphs take [Q, W] int32 word queries.

    ``seeds``: upper-scan entry points placed in the initial beam (needs
    ``graph.upper_ids``; the greedy-descent fallback uses 1).
    ``with_stats=True`` appends {"iterations", "visited", "expanded"}.
    ``exclude``: optional [cap] bool mask of nodes dropped from the RESULTS;
    they still route traversal, like tombstones.
    """
    ef = max(ef, k)
    if max_iters is None:
        max_iters = 2 * ef // expand + 16
    dev = graph.device
    hamming = Metric(graph.metric) == Metric.HAMMING
    queries = (queries.to(dev) if hamming
               else queries.to(dev, torch.float32)).contiguous()
    if graph.quant == QUANT_PQ and graph.pq_rotation is not None:
        # OPQ: codes live in the rotated space; rotate the query once here,
        # every distance below (LUT, entry scan) then works in that space
        queries = (queries @ graph.pq_rotation).contiguous()
    q = queries.shape[0]
    cap = graph.cap
    c = expand * graph.m0
    q_sq = (torch.zeros(q, device=dev) if hamming
            else (queries * queries).sum(1))
    lut = None
    if graph.quant == QUANT_PQ:
        lut = adc_lut(queries, graph.pq_codebook, graph.metric)

    with span("beam.entry"):
        if graph.upper_ids is not None and graph.upper_ids.shape[0] > 1:
            seeds = max(1, min(seeds, ef))
            entry_ids, entry_d = _upper_entry_scan(graph, queries, q_sq, seeds,
                                                   lut)
        else:
            entry_ids, entry_d = _upper_descent(graph, queries, q_sq, lut)
            entry_ids, entry_d = entry_ids[:, None], entry_d[:, None]
            seeds = 1

    # ---- level-0 beam state ----
    beam_d = torch.cat(
        [entry_d, torch.full((q, ef - seeds), _INF, device=dev)], 1)
    beam_ids = torch.cat(
        [entry_ids.int(),
         torch.full((q, ef - seeds), -1, dtype=torch.int32, device=dev)], 1)
    expanded = torch.zeros((q, ef), dtype=torch.bool, device=dev)
    # Re-visit filter: candidates already in the beam, or in the log of every
    # id ever expanded, are skipped (a node displaced from the beam and found
    # again is re-scored, never re-expanded; the results are the same).
    exp_log = torch.full((q, expand * max_iters), -2, dtype=torch.int32,
                         device=dev)  # -2 matches no id
    visited_n = torch.isfinite(entry_d).sum(1).int()
    iterations = torch.zeros((), dtype=torch.int32, device=dev)
    no_cand = torch.zeros((q, c), dtype=torch.bool, device=dev)

    for it in range(max_iters):
        act = _active_mask(beam_d, beam_ids, expanded)
        if it % _CHECK_EVERY == 0 and not bool(act.any()):
            break
        with span("beam.iter"):
            iterations += act.any().int()

            # the `expand` best unexpanded entries of each active query
            unexp_d = torch.where((beam_ids >= 0) & ~expanded & act[:, None],
                                  beam_d, _INF)
            sorted_d, order = torch.sort(unexp_d, dim=1, stable=True)
            sel_slots = order[:, :expand]
            sel_ids = torch.gather(beam_ids, 1, sel_slots)
            sel_valid = torch.isfinite(sorted_d[:, :expand])
            exp_ids = torch.where(sel_valid, sel_ids, cap)
            expanded = expanded | torch.zeros_like(expanded).scatter_(
                1, sel_slots, sel_valid)
            exp_log[:, it * expand:(it + 1) * expand] = torch.where(
                sel_valid, sel_ids, -2)

            # neighbor lists -> candidate block [Q, C]
            nbrs = graph.neighbors0[exp_ids.long()].reshape(q, c)
            valid = nbrs >= 0
            in_beam = (nbrs[:, :, None] == beam_ids[:, None, :]).any(2)
            in_log = (nbrs[:, :, None] == exp_log[:, None, :]).any(2)
            # dedup unconditionally: expanded nodes can share neighbors
            fresh = _dedup_fresh(nbrs, valid & ~(in_beam | in_log))
            visited_n += fresh.sum(1).int()

            d = _candidate_dists(graph, queries, q_sq,
                                 torch.where(fresh, nbrs, 0), lut)
            d = torch.where(fresh, d, _INF)

            # merge: one stable sort, payloads (ids, expanded) gathered along
            cat_d = torch.cat([beam_d, d], 1)
            cat_ids = torch.cat([beam_ids, torch.where(fresh, nbrs, -1)], 1)
            cat_exp = torch.cat([expanded, no_cand], 1)
            s_d, order = torch.sort(cat_d, dim=1, stable=True)
            keep = order[:, :ef]
            beam_d = s_d[:, :ef]
            beam_ids = torch.gather(cat_ids, 1, keep)
            expanded = torch.gather(cat_exp, 1, keep)

    # drop tombstones, invalid slots and exclusions; take the final top-k
    rows = torch.clamp(beam_ids, 0, cap - 1).long()
    dead = graph.deleted[rows]
    if exclude is not None:
        dead = dead | exclude[rows]
    final_d = torch.where((beam_ids < 0) | dead, _INF, beam_d)
    out_d, arg = torch.sort(final_d, dim=1, stable=True)
    out_d, arg = out_d[:, :k], arg[:, :k]
    out_ids = torch.where(torch.isfinite(out_d),
                          torch.gather(beam_ids, 1, arg), -1)
    out_labels = graph.labels_at(out_ids)
    if with_stats:
        stats = {
            "iterations": iterations,
            # distance computations; clipped so visited <= n holds even with
            # the rare re-scored node
            "visited": torch.clamp(visited_n, max=graph.num_nodes),
            "expanded": (exp_log != -2).sum(1).int(),
        }
        return out_d, out_ids, out_labels, stats
    return out_d, out_ids, out_labels


def search(graph: DeviceGraph, queries, params: SearchParams | None = None,
           **kw):
    """Convenience wrapper taking SearchParams."""
    params = params or SearchParams()
    ef = params.ef if params.ef is not None else max(64, params.k)
    return search_batched(
        graph, queries, k=params.k, ef=ef, expand=params.expand,
        max_iters=params.max_iters, seeds=params.seeds, **kw,
    )
