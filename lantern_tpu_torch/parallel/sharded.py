"""Sharded index on one card or over the ranks of a process group (port of
lantern_tpu/parallel/sharded.py).

The reference partitions the node set round-robin into S shards, builds one
HNSW subgraph per shard and stacks the shards' arrays on a leading shard
axis, which its mesh places one shard per device; a search runs every
shard's subgraph and merges the [S, Q, k] results once.

Here the shards a process holds are that same leading axis of stacked
tensors, on one device: ``ShardedIndex.shard(si)`` is a ``DeviceGraph`` of
views of slice ``si`` (contiguous, no copy), and every per-shard step of the
reference's vmap is a loop over those views through the port's
single-graph functions:

- search: ``graph/search.py::search_batched`` per shard (K1 for f32/bf16
  rows, the decode kernel in PQ shards' entry scans, K4 in hamming shards'
  entry scans), local ids mapped to global ids through ``global_ids``, then
  one merge by a stable sort of the [Q, S*k] block (``jax.lax.top_k`` puts
  the lower index first among equal values; so does a stable sort);
- flat scans: ``flat.py::flat_search_graph`` / ``flat_search_graph_rerank``
  per shard (the decode kernel for PQ shards, K4 for hamming shards);
- the device build and inserts: the plan of ``graph/build_device.py``
  (level draws from one generator in shard order, the UPPER_POOL_CAP
  subsample, per-level id lists padded to a common size, ramped rounds
  with -1 lanes for shorter shards, the tables, the quantised round trip
  and ``insert_rounds``, which runs each round over every shard's
  ``BuildState`` views of the stacked tables) is the reference's, so both
  packages build the same graphs. This module adds only the sharding: the
  round-robin partition, this rank's slice of the whole-host plan, the
  gathered levels and counts, global ids and the PQ rerank rows.

Ranks (``init_multihost``, then ``make_mesh(n_shards, data)`` over the
group): the world is a (data x shard) grid, rank = d * P + p with P = world
/ data shard ranks; rank (d, p) holds the contiguous block of shards
p*S/P .. (p+1)*S/P - 1 (the reference's ``devs.reshape(data, n_shards)``),
and the ranks of one shard column hold the same shards. Every rank gets the
same inputs and builds, inserts and encodes only its own shards from the
whole host plan, so the graphs equal a one-process build's. A search takes
the rank's Q/D slice of the queries, runs its shards, makes one all-gather
of the [S/P, Q/D, k] results over its data row (rank order is shard order,
so the merge orders ties as one process does) and one over its shard
column, and every rank returns the whole [Q, k]. With no process group
there is one rank and no collective.

Per-shard ``entry``, ``max_level`` and ``num_nodes`` are host ints of the
rank's shards, so a search never reads them from the device. A PQ index
keeps one codebook and rotation (the reference tiles the same codebook S
times).
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import torch

from lantern_tpu_torch import resolve_device
from lantern_tpu_torch.config import HnswParams, Metric, QuantKind
from lantern_tpu_torch.graph.build_device import (
    TABLES,
    build_groups,
    build_states,
    build_tables,
    check_candidates,
    grown,
    grown_tables,
    insert_groups,
    insert_rounds,
    plan_build,
    plan_insert,
    pq_encode_rows,
    pq_snap,
    put_blocks,
    round_rows,
    stored_rows,
)
from lantern_tpu_torch.graph.device import (
    QUANT_PQ,
    DeviceGraph,
    _sq_norms_np,
    upper_ids_from_slots,
)
from lantern_tpu_torch.native import LMAX
from lantern_tpu_torch.parallel import _dist
from lantern_tpu_torch.parallel._dist import init_multihost  # noqa: F401

_INF = float("inf")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The (data, shard) layout: ``shape == {"data": D, "shard": S}``, the
    device of this rank, and where this rank sits in the grid.

    ``rank`` = ``data_row`` * P + ``shard_col`` of ``world`` ranks (P =
    world / D shard ranks); ``local_shards`` are the global ids of the
    shards it holds; ``row_group`` is its data row (the ranks holding every
    shard once) and ``col_group`` its shard column (the ranks holding its
    shards). Without a process group: one rank, every shard, no groups.
    """

    shape: dict
    device: torch.device
    rank: int = 0
    world: int = 1
    data_row: int = 0
    shard_col: int = 0
    local_shards: tuple = ()
    row_group: object = None
    col_group: object = None

    @property
    def distributed(self) -> bool:
        return self.row_group is not None

    @property
    def shard_ranks(self) -> int:
        return self.world // self.shape["data"]


def make_mesh(n_shards: int | None = None, data: int = 1,
              device: str | torch.device | None = None) -> Mesh:
    """The layout of S shards over this process group's ranks (or over
    this process alone when there is no group), on ``device`` (default: the
    card ``init_multihost`` chose, else cuda; raises without a card unless
    the CPU is named).

    Unlike the reference's mesh (one shard per device), a rank's shards are
    a leading tensor axis of one device, so S only has to be a multiple of
    the P = world / ``data`` shard ranks; ``world`` must be a multiple of
    ``data``. ``n_shards=None`` means one shard per shard rank (with no
    group: one per visible card, as in the reference; 1 on the CPU).
    """
    if _dist.distributed():
        import torch.distributed as dist

        rank, world = dist.get_rank(), dist.get_world_size()
        dev = resolve_device(device if device is not None
                             else _dist.group_device())
    else:
        rank, world = 0, 1
        dev = resolve_device(device)
    if data < 1 or world % data:
        raise ValueError(f"data={data} does not divide the {world} rank(s)")
    shard_ranks = world // data
    if n_shards is None:
        if _dist.distributed():
            n_shards = shard_ranks
        else:
            n_shards = torch.cuda.device_count() if dev.type == "cuda" else 1
    if n_shards < 1:
        raise ValueError(f"n_shards={n_shards}; need at least one shard")
    if n_shards % shard_ranks:
        raise ValueError(f"n_shards={n_shards} is not a multiple of the "
                         f"{shard_ranks} shard rank(s)")
    d, p = divmod(rank, shard_ranks)
    per = n_shards // shard_ranks
    row = col = None
    if _dist.distributed():
        row, col = _dist.layout_groups(data, shard_ranks, d, p)
    return Mesh(shape={"data": data, "shard": int(n_shards)}, device=dev,
                rank=rank, world=world, data_row=d, shard_col=p,
                local_shards=tuple(range(p * per, (p + 1) * per)),
                row_group=row, col_group=col)


@dataclasses.dataclass
class ShardedIndex:
    """This rank's subgraphs stacked on a leading shard axis of one
    device's tensors (all S of them without a process group).

    Fields are a ``DeviceGraph``'s with the axis in front (``vectors [L,
    cap, ...]`` for the L = S/P local shards, ``neighbors0 [L, cap+1, m0]``,
    ``upper_neighbors [L, ucap, LMAX, m]``, ``upper_ids [L, ucap]``, ...),
    plus ``global_ids [L, cap+1]`` int32 (local slot -> global id, -1 at
    padding), the PQ shards' optional bf16 rerank rows ``[L, cap, d]`` and
    their f32 ``rerank_sqn [L, cap]``. ``cap`` and ``ucap`` are the largest
    over all S shards, so every rank's tables have one shape. Padding slots
    (shards shorter than the longest) are tombstoned. ``mesh`` places the
    index: ``shard_ids`` are its shards' global ids.
    """

    vectors: torch.Tensor
    sq_norms: torch.Tensor
    neighbors0: torch.Tensor
    upper_neighbors: torch.Tensor
    upper_slot: torch.Tensor
    levels: torch.Tensor
    labels: torch.Tensor           # [S, cap] int64 holding the u64 bits
    deleted: torch.Tensor
    upper_ids: torch.Tensor | None
    global_ids: torch.Tensor
    entry: tuple
    max_level: tuple
    num_nodes: tuple
    vec_scales: torch.Tensor | None = None
    pq_codebook: torch.Tensor | None = None   # [nsub, K, dsub] f32, one copy
    pq_rotation: torch.Tensor | None = None   # [d, d] f32
    rerank_rows: torch.Tensor | None = None
    rerank_sqn: torch.Tensor | None = None
    params: HnswParams | None = None
    m: int = 16
    dim: int = 0
    metric: int = int(Metric.L2SQ)
    quant: int = int(QuantKind.F32)
    mesh: Mesh | None = None

    @property
    def n_shards(self) -> int:
        """S, the shards of the whole index."""
        return self.n_local if self.mesh is None else self.mesh.shape["shard"]

    @property
    def n_local(self) -> int:
        """The shards this rank holds (the leading axis)."""
        return self.vectors.shape[0]

    @property
    def shard_ids(self) -> tuple:
        return (tuple(range(self.n_local)) if self.mesh is None
                else self.mesh.local_shards)

    @property
    def cap(self) -> int:
        return self.vectors.shape[1]

    @property
    def device(self) -> torch.device:
        return self.vectors.device

    def shard(self, si: int) -> DeviceGraph:
        """Local shard ``si`` (global shard ``shard_ids[si]``) as a
        DeviceGraph of views (no copy)."""
        return DeviceGraph(
            vectors=self.vectors[si],
            sq_norms=self.sq_norms[si],
            neighbors0=self.neighbors0[si],
            upper_neighbors=self.upper_neighbors[si],
            upper_slot=self.upper_slot[si],
            levels=self.levels[si],
            labels=self.labels[si],
            deleted=self.deleted[si],
            entry=self.entry[si],
            max_level=self.max_level[si],
            num_nodes=self.num_nodes[si],
            upper_ids=None if self.upper_ids is None else self.upper_ids[si],
            vec_scales=None if self.vec_scales is None else self.vec_scales[si],
            pq_codebook=self.pq_codebook,
            pq_rotation=self.pq_rotation,
            m=self.m,
            dim=self.dim,
            metric=self.metric,
            quant=self.quant,
        )


def _t(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    """numpy -> tensor on ``dev``; uint64 and uint32 arrays keep their bits
    as int64 / int32."""
    a = np.ascontiguousarray(a)
    if a.dtype == np.uint64:
        a = a.view(np.int64)
    elif a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a).to(dev)


def _host(t: torch.Tensor) -> np.ndarray:
    """A device tensor's values on the host (every device -> host read of
    this module goes through here)."""
    return t.cpu().numpy()


def _check_mesh(index: ShardedIndex, mesh: Mesh) -> None:
    if mesh.shape["shard"] != index.n_shards:
        raise ValueError(f"index has {index.n_shards} shards but mesh shard "
                         f"axis is {mesh.shape['shard']}")
    if mesh.local_shards != index.shard_ids:
        raise ValueError(f"this rank holds shards {index.shard_ids} but the "
                         f"mesh places {mesh.local_shards} here")


def build_sharded(
    vectors: np.ndarray,
    params: HnswParams,
    mesh: Mesh,
    labels: np.ndarray | None = None,
    seed: int = 0,
    use_native: bool = True,
    nthreads: int = 0,
) -> ShardedIndex:
    """Partition ``vectors`` round-robin over the shards, build one host
    subgraph per shard of this rank (shard ``si`` with seed ``seed + si``),
    then stack them on the mesh's device. Every rank is given the same
    ``vectors``."""
    n = len(vectors)
    s = mesh.shape["shard"]
    if n < s:
        raise ValueError(f"need at least one vector per shard ({n} < {s})")
    if labels is None:
        labels = np.arange(n, dtype=np.uint64)
    labels = np.asarray(labels, np.uint64)
    if use_native:
        from lantern_tpu_torch.native import NativeHnsw as Engine
    else:
        from lantern_tpu_torch.graph.host_build import HostHnsw as Engine

    shards, gids = [], []
    for si in mesh.local_shards:
        idx = np.arange(si, n, s)
        eng = Engine(params, capacity=len(idx), seed=seed + si)
        kw = {"nthreads": nthreads} if use_native else {}
        eng.add(vectors[idx], labels=labels[idx], **kw)
        shards.append(eng)
        gids.append(idx.astype(np.int32))
    return _stack_engines(shards, gids, params, mesh)


def _stack_engines(shards, gids, params: HnswParams, mesh: Mesh) -> ShardedIndex:
    """Stack this rank's per-shard host engines at the capacity common to
    all S shards (padding slots tombstoned, global id -1)."""
    metric = Metric(params.metric)
    max_n = max(eng.n for eng in shards)
    max_u = max(max(eng.n_upper, 1) for eng in shards)
    if mesh.distributed:  # two ints, so every rank's tables take one shape
        max_n, max_u = _dist.all_reduce_max([max_n, max_u], None, mesh.device)
    width = shards[0].vectors.shape[1]
    s = len(shards)
    vec_np = np.zeros((s, max_n, width), shards[0].vectors.dtype)
    sqn_np = np.zeros((s, max_n), np.float32)
    nbr_np = np.full((s, max_n + 1, params.m0), -1, np.int32)
    upn_np = np.full((s, max_u, LMAX, params.m), -1, np.int32)
    slt_np = np.full((s, max_n), -1, np.int32)
    lvl_np = np.zeros((s, max_n), np.int32)
    lab_np = np.zeros((s, max_n), np.uint64)
    del_np = np.zeros((s, max_n), bool)
    gid_np = np.full((s, max_n + 1), -1, np.int32)
    uid_np = np.full((s, max_u), -1, np.int32)
    for si, eng in enumerate(shards):
        ni = eng.n
        vec_np[si, :ni] = eng.vectors[:ni]
        sqn_np[si, :ni] = _sq_norms_np(eng.vectors[:ni], metric)
        nbr_np[si, :ni] = eng.neighbors0[:ni]
        nu = max(eng.n_upper, 1)
        upn_np[si, :nu] = eng.upper_neighbors[:nu]
        slt_np[si, :ni] = eng.upper_slot[:ni]
        uid_np[si] = upper_ids_from_slots(eng.upper_slot[:ni], max_u)
        lvl_np[si, :ni] = eng.levels[:ni]
        lab_np[si, :ni] = eng.labels[:ni]
        del_np[si, :ni] = eng.deleted[:ni]
        del_np[si, ni:] = True
        gid_np[si, :ni] = gids[si][:ni]
    dev = mesh.device
    return ShardedIndex(
        vectors=_t(vec_np, dev),
        sq_norms=_t(sqn_np, dev),
        neighbors0=_t(nbr_np, dev),
        upper_neighbors=_t(upn_np, dev),
        upper_slot=_t(slt_np, dev),
        levels=_t(lvl_np, dev),
        labels=_t(lab_np, dev),
        deleted=_t(del_np, dev),
        upper_ids=_t(uid_np, dev),
        global_ids=_t(gid_np, dev),
        entry=tuple(int(eng.entry) for eng in shards),
        max_level=tuple(int(eng.max_level) for eng in shards),
        num_nodes=tuple(int(eng.n) for eng in shards),
        params=params,
        m=params.m,
        dim=params.dim,
        metric=int(metric),
        mesh=mesh,
    )


def _queries(index: ShardedIndex, queries) -> torch.Tensor:
    """Queries on the index's device: f32 rows, or int32 words for hamming
    (numpy uint32 words keep their bits)."""
    if isinstance(queries, np.ndarray):
        queries = _t(queries, index.device)
    if Metric(index.metric) == Metric.HAMMING:
        return queries.to(index.device).contiguous()
    return queries.to(index.device, torch.float32).contiguous()


def _to_global(index: ShardedIndex, si: int, ids: torch.Tensor) -> torch.Tensor:
    gids = index.global_ids[si]
    safe = torch.clamp(ids, 0, gids.shape[0] - 1).long()
    return torch.where(ids >= 0, gids[safe], -1)


def _query_slice(index: ShardedIndex, q: torch.Tensor) -> torch.Tensor:
    """This rank's contiguous Q/D slice of the queries (all of them when
    D = 1)."""
    mesh = index.mesh
    d = 1 if mesh is None else mesh.shape["data"]
    if d == 1:
        return q
    if q.shape[0] % d:
        raise ValueError(f"{q.shape[0]} queries do not split over the "
                         f"{d} rows of the data axis")
    per = q.shape[0] // d
    return q[mesh.data_row * per:(mesh.data_row + 1) * per]


def _pack(d, gid, labels) -> torch.Tensor:
    """(f32 dists, int32 gids, int64 labels) [..., k] -> int32 [..., k, 4]:
    16 bytes an entry, one tensor for one all-gather."""
    return torch.cat([d.to(torch.float32).contiguous().view(torch.int32)[..., None],
                      gid.to(torch.int32)[..., None],
                      labels.contiguous().view(torch.int32).reshape(
                          labels.shape + (2,))], -1)


def _unpack(p: torch.Tensor):
    return (p[..., 0].contiguous().view(torch.float32), p[..., 1].contiguous(),
            p[..., 2:].contiguous().view(torch.int64)[..., 0])


def _per_shard(index: ShardedIndex, queries, exclude_gids, k: int, local):
    """Run ``local(si, graph, q, exclude_row)`` -> (d, ids, labels) [q, k]
    on this rank's shards for its slice q of the queries, then merge: one
    all-gather of the [L, q, k] results over the data row, the top-k merge
    in global shard order, one all-gather of the [q, k] merge over the
    shard column. Returns (d [Q, k] f32, global ids [Q, k] int32, labels
    [Q, k] int64) on every rank."""
    q = _query_slice(index, _queries(index, queries))
    excl = _as_local_masks(index, exclude_gids)
    ds, gs, ls = [], [], []
    for si in range(index.n_local):
        d, ids, lab = local(si, index.shard(si), q,
                            None if excl is None else excl[si])
        ds.append(d)
        gs.append(_to_global(index, si, ids))
        ls.append(lab)
    d, g, lab = torch.stack(ds), torch.stack(gs), torch.stack(ls)
    mesh = index.mesh
    if mesh is None or not mesh.distributed:
        return _merge_topk(d, g, lab, k)
    d, g, lab = _unpack(_dist.all_gather_cat(_pack(d, g, lab), mesh.row_group,
                                             merge=True))
    out = _merge_topk(d, g, lab, k)
    return _unpack(_dist.all_gather_cat(_pack(*out), mesh.col_group, merge=True))


def search_sharded(
    index: ShardedIndex,
    queries,
    k: int = 10,
    ef: int = 64,
    expand: int = 1,
    max_iters: int | None = None,
    exclude_gids: torch.Tensor | None = None,
):
    """Every shard searches its subgraph, then one global top-k merge.

    queries [Q, d] (int32 or uint32 words for hamming; the same on every
    rank) -> (dists [Q, k] f32, global ids [Q, k] int32, labels [Q, k]
    int64), the whole result on every rank.

    ``exclude_gids``: a [n_global] bool mask indexed by global id, or this
    rank's [L, cap] per-shard masks of :func:`local_exclude_masks`
    (precompute those once when one filter serves many searches).
    """
    from lantern_tpu_torch.graph.search import search_batched

    def local(si, graph, q, excl_row):
        return search_batched(graph, q, k=k, ef=ef, expand=expand,
                              max_iters=max_iters, exclude=excl_row)

    return _per_shard(index, queries, exclude_gids, k, local)


def local_exclude_masks(index: ShardedIndex, exclude_gids) -> torch.Tensor:
    """A [n_global] bool global-id mask -> [L, cap] node masks of this
    rank's shards (no collective).

    Blank gid slots are always excluded (they hold no node); gids at or
    beyond the mask's length are NOT excluded (a shorter, stale mask
    leaves newer inserts unfiltered rather than mapping them onto its last
    entry).
    """
    mask = torch.as_tensor(exclude_gids, device=index.device).bool()
    g = index.global_ids[:, :index.cap]
    n_mask = mask.shape[0]
    if n_mask == 0:
        return g < 0
    covered = (g >= 0) & (g < n_mask)
    return (g < 0) | (covered & mask[torch.clamp(g, 0, n_mask - 1).long()])


def _as_local_masks(index: ShardedIndex, exclude_gids):
    """None | [n_global] | [L, cap] -> None | [L, cap] local masks."""
    if exclude_gids is None:
        return None
    exclude_gids = torch.as_tensor(exclude_gids, device=index.device).bool()
    if exclude_gids.dim() == 2:
        return exclude_gids
    return local_exclude_masks(index, exclude_gids)


def _merge_topk(d, gid, labels, k: int):
    """[S, Q, k] per-shard results -> [Q, k] global top-k.

    A stable ascending sort of the [Q, S*k] block, so among equal distances
    the lower column (shard-major order) comes first, as ``jax.lax.top_k``
    orders them; hamming distances tie as a rule.
    """
    s, q, kk = d.shape
    d2 = d.permute(1, 0, 2).reshape(q, s * kk)
    gid2 = gid.permute(1, 0, 2).reshape(q, s * kk)
    lab2 = labels.permute(1, 0, 2).reshape(q, s * kk)
    sd, arg = torch.sort(torch.where(gid2 >= 0, d2, _INF), dim=1, stable=True)
    out_d, arg = sd[:, :k], arg[:, :k]
    out_gid = torch.where(torch.isfinite(out_d), torch.gather(gid2, 1, arg), -1)
    out_lab = torch.where(out_gid >= 0, torch.gather(lab2, 1, arg), 0)
    return out_d, out_gid.to(torch.int32), out_lab


def flat_search_sharded(
    index: ShardedIndex,
    queries,
    k: int = 10,
    exact: bool = False,
    recall_target: float = 0.95,
    exclude_gids: torch.Tensor | None = None,
):
    """Every shard scans its stored table (``flat_search_graph``: the
    decode kernel for PQ shards, K4 for hamming shards), one top-k merge.

    Exact per-shard top-k composes to the exact global top-k.
    ``recall_target`` is accepted for the reference's signature and unused:
    the port's top-k is exact.
    """
    from lantern_tpu_torch.flat import flat_search_graph

    del recall_target

    def local(si, graph, q, excl_row):
        return flat_search_graph(graph, q, k=k, exact=exact, exclude=excl_row)

    return _per_shard(index, queries, exclude_gids, k, local)


def flat_search_sharded_rerank(
    index: ShardedIndex,
    queries,
    k: int = 10,
    shortlist: int = 100,
    recall_target: float = 0.95,
    exclude_gids: torch.Tensor | None = None,
):
    """Per-shard ADC shortlist plus an exact re-score against each shard's
    bf16 row copy (``flat_search_graph_rerank``), then one top-k merge.
    Needs a PQ index quantised with ``keep_rerank=True``."""
    from lantern_tpu_torch.flat import flat_search_graph_rerank

    del recall_target
    if index.rerank_rows is None:
        raise ValueError(
            "flat_search_sharded_rerank needs rerank rows — quantize with "
            "keep_rerank=True"
        )

    def local(si, graph, q, excl_row):
        return flat_search_graph_rerank(graph, index.rerank_rows[si], q, k=k,
                                        shortlist=shortlist, exclude=excl_row)

    return _per_shard(index, queries, exclude_gids, k, local)


def quantize_sharded(
    index: ShardedIndex,
    mesh: Mesh,
    quant: str = "pq",
    codebook=None,
    train_rows: int = 65536,
    keep_rerank: bool = True,
    seed: int = 0,
) -> ShardedIndex:
    """Re-encode a built f32/bf16 index's rows as PQ codes or i8.

    - ``quant="pq"``: train (``rotate=True``, on a row sample taken evenly
      across the shards) or take a ``quant.pq.PQCodebook``, and store uint8
      codes ``[S, cap, nsub]``; ``keep_rerank=True`` keeps a bf16 copy of
      the rows and their f32 squared norms for
      :func:`flat_search_sharded_rerank`.
    - ``quant="i8"``: symmetric per-row int8 codes and f32 scales.

    The encode runs on the device; only the training sample goes to the
    host. Over ranks, the sample (the first rows of every shard) is
    all-gathered in shard order, rank 0 trains and broadcasts the codebook
    and rotation, so every rank holds the same bits; i8 is local.
    """
    _check_mesh(index, mesh)
    metric = Metric(index.metric)
    if metric == Metric.HAMMING:
        raise ValueError("hamming shards are already bit-packed; no PQ/i8")
    if index.quant not in (int(QuantKind.F32), int(QuantKind.F16)):
        raise ValueError("index is already quantized")
    _, cap, dim = index.vectors.shape
    s = index.n_shards
    dev = index.device
    p = index.params

    if quant == "pq":
        from lantern_tpu_torch.quant.pq import train_codebook

        if codebook is None:
            per = max(1, min(cap, train_rows // s))
            block = _host(index.vectors[:, :per].float())
            sample = np.concatenate(
                [block[si, :max(1, min(per, index.num_nodes[si]))]
                 for si in range(index.n_local)])
            if mesh.distributed and mesh.data_row == 0:
                sample = _dist.all_gather_rows(sample, mesh.row_group, dev)
            nsub = (p.effective_num_subvectors if p is not None
                    else max(1, dim // 4))
            ncent = p.num_centroids if p is not None else 256
            if mesh.rank == 0:
                codebook = train_codebook(sample, num_subvectors=nsub,
                                          num_centroids=min(ncent, 256),
                                          seed=seed, rotate=True, device=dev)
            if mesh.distributed:
                codebook = _dist.broadcast_object(codebook, dev)
        cent = torch.from_numpy(np.array(codebook.centroids, np.float32)).to(dev)
        rot = (None if codebook.rotation is None else
               torch.from_numpy(np.array(codebook.rotation, np.float32)).to(dev))
        codes = torch.stack([pq_encode_rows(index.vectors[si].float(), cent, rot)
                             for si in range(index.n_local)])
        new_params = (dataclasses.replace(
            p, pq=True, num_subvectors=codebook.num_subvectors,
            num_centroids=codebook.num_centroids) if p is not None else None)
        return dataclasses.replace(
            index, vectors=codes, vec_scales=None, pq_codebook=cent,
            pq_rotation=rot, quant=QUANT_PQ, params=new_params,
            rerank_rows=(index.vectors.to(torch.bfloat16) if keep_rerank
                         else None),
            rerank_sqn=index.sq_norms if keep_rerank else None,
        )

    if quant == "i8":
        from lantern_tpu_torch.quant.scalar import quantize_i8

        codes, scales = quantize_i8(index.vectors.float())
        new_params = (dataclasses.replace(p, quant=QuantKind.I8)
                      if p is not None else None)
        return dataclasses.replace(index, vectors=codes, vec_scales=scales,
                                   quant=int(QuantKind.I8), params=new_params,
                                   rerank_rows=None, rerank_sqn=None)

    raise ValueError(f"quant={quant!r}; expected 'pq' or 'i8'")


def build_sharded_device(
    vectors: np.ndarray,
    params: HnswParams,
    mesh: Mesh,
    batch: int = 256,
    seed: int = 0,
    labels: np.ndarray | None = None,
    max_in: int | None = None,
    candidates: str = "flat",
    store: str = "f32",
    flat_until: int | None = None,
) -> ShardedIndex:
    """Build every shard's subgraph on the device by the plan and the insert
    rounds of ``graph/build_device.py``, each round run over every shard of
    this rank. Every rank is given the same ``vectors`` and draws the whole
    host plan; no collective.

    ``candidates``: "flat" (default) pools from a masked flat scan of each
    shard's built prefix; "beam" from a beam search of the partial
    subgraph; "hybrid" flat for the rounds that start before ``flat_until``
    (default 2,000,000) built nodes, beam after. ``store``: "f32" or "bf16"
    tables (l2sq / cos; the squared norms come from the f32 rows). Hamming
    builds take packed uint32 words.
    """
    flat_until = check_candidates(candidates, flat_until, store)
    metric = Metric(params.metric)
    np_dtype = np.uint32 if metric == Metric.HAMMING else np.float32
    vectors = np.ascontiguousarray(vectors, np_dtype)
    n, dim = vectors.shape
    s = mesh.shape["shard"]
    if n < s:
        raise ValueError(f"need at least one vector per shard ({n} < {s})")
    m = params.m
    if labels is None:
        labels = np.arange(n, dtype=np.uint64)
    labels = np.asarray(labels, np.uint64)
    dev = mesh.device

    part = [np.arange(si, n, s) for si in range(s)]
    counts = [len(pp) for pp in part]
    nmax = max(counts)
    batch = min(batch, nmax)

    # the whole plan, from one generator in shard order; this rank keeps
    # its shards'
    levels, slots, n_upper, level_ids, entry, max_level = plan_build(
        counts, params.level_lambda, np.random.default_rng(seed), batch)
    loc = list(mesh.local_shards)

    sl = len(loc)
    vec_np = np.zeros((sl, nmax, dim), np_dtype)
    gid_np = np.full((sl, nmax + 1), -1, np.int32)
    lab_np = np.zeros((sl, nmax), np.uint64)
    for j, si in enumerate(loc):
        ids = part[si]
        vec_np[j, :len(ids)] = vectors[ids]
        gid_np[j, :len(ids)] = ids
        lab_np[j, :len(ids)] = labels[ids]

    if metric == Metric.HAMMING:
        sq = np.zeros((sl, nmax), np.float32)  # unused by hamming distances
    else:
        sq = np.einsum("snd,snd->sn", vec_np, vec_np).astype(np.float32)
    vec_t = _t(vec_np, torch.device("cpu"))
    if store == "bf16" and metric != Metric.HAMMING:
        # rounded on the host, so the device never holds the f32 table
        vec_t = vec_t.to(torch.bfloat16)
    # at least one upper slot and the dummy
    tables = build_tables(vec_t.to(dev), _t(sq, dev), levels[loc], slots[loc],
                          max(int(n_upper.max()), 1) + 1, m)
    del vec_t
    states = build_states(tables, levels[loc], [entry[si] for si in loc],
                          [max_level[si] for si in loc], [0] * sl, m, params.dim,
                          metric, seeded=False)
    # the hybrid switch is checked every round
    groups = build_groups(nmax, [counts[si] for si in loc], batch, candidates,
                          flat_until, group=1)
    insert_rounds(states, [a[loc] for a in level_ids],
                  ((ids, flat) for ids, flat, _ in groups),
                  params.ef_construction, max_in or max(4, m // 2))

    return ShardedIndex(
        **tables,
        labels=_t(lab_np, dev),
        deleted=_t(gid_np[:, :nmax] < 0, dev),  # padding slots tombstoned
        global_ids=_t(gid_np, dev),
        entry=tuple(st.entry for st in states),
        max_level=tuple(st.max_level for st in states),
        num_nodes=tuple(counts[si] for si in loc),
        params=params,
        m=m,
        dim=params.dim,
        metric=int(metric),
        quant=int(QuantKind.F16 if tables["vectors"].dtype == torch.bfloat16
                  else QuantKind.F32),
        mesh=mesh,
    )


# ---- lifecycle: save / load / insert / delete / compact -------------------
# A sharded index persists as one standard snapshot per shard plus a
# manifest, so every shard file loads in the single-index tooling of
# either package.


class _ShardView:
    """One shard's arrays on the host, shaped like an engine (for
    ``save_snapshot`` and ``compact_sharded``).

    Quantised shards are viewed through their SOURCE rows: the bf16 rerank
    copy (PQ with keep_rerank), the decoded centroids (PQ without) or the
    dequantised f32 rows (i8). bf16 rows stay a CPU bf16 tensor, which the
    snapshot writer tags "bfloat16" as the reference's files do."""

    def __init__(self, index: ShardedIndex, si: int):
        from lantern_tpu_torch.quant.scalar import dequantize_i8

        self.p = index.params
        self.n = index.num_nodes[si]
        self.entry = index.entry[si]
        self.max_level = index.max_level[si]
        if index.quant == QUANT_PQ:
            if index.rerank_rows is not None:
                self.vectors = index.rerank_rows[si].cpu()
            else:
                from lantern_tpu_torch.quant.pq import pq_decode

                self.vectors = pq_decode(_host(index.vectors[si]),
                                         _sharded_codebook(index))
        elif index.quant == int(QuantKind.I8):
            self.vectors = _host(dequantize_i8(index.vectors[si],
                                               index.vec_scales[si]))
        elif index.vectors.dtype == torch.bfloat16:
            self.vectors = index.vectors[si].cpu()
        elif Metric(index.metric) == Metric.HAMMING:
            self.vectors = _host(index.vectors[si]).view(np.uint32)
        else:
            self.vectors = _host(index.vectors[si])
        self.neighbors0 = _host(index.neighbors0[si])
        self.counts0 = (self.neighbors0 >= 0).sum(1).astype(np.int32)
        self.upper_neighbors = _host(index.upper_neighbors[si])
        self.upper_counts = (self.upper_neighbors >= 0).sum(-1).astype(np.int32)
        self.upper_slot = _host(index.upper_slot[si])
        used = self.upper_slot[:self.n]
        used = used[used >= 0]
        self.n_upper = int(used.max()) + 1 if used.size else 0
        self.levels = _host(index.levels[si])
        self.labels = _host(index.labels[si]).view(np.uint64)
        self.deleted = _host(index.deleted[si])


def _sharded_codebook(index: ShardedIndex):
    """The index's PQCodebook (numpy, from its device copy), or None."""
    if index.pq_codebook is None:
        return None
    from lantern_tpu_torch.quant.pq import PQCodebook

    return PQCodebook(
        centroids=_host(index.pq_codebook),
        rotation=None if index.pq_rotation is None else _host(index.pq_rotation),
    )


def _quant_kind(index: ShardedIndex) -> str | None:
    if index.quant == QUANT_PQ:
        return "pq"
    if index.quant == int(QuantKind.I8):
        return "i8"
    return None


def save_sharded(index: ShardedIndex, dir_path: str):
    """Persist: ``manifest.json`` (version 2, renamed into place last) plus
    ``shard_<i>.ldb`` (standard snapshots) and ``shard_<i>.gids.npy`` (local
    slot -> global id) per shard. Quantised indexes save their source rows
    and the codebook in every shard file; the manifest records the quant
    kind, and ``load_sharded`` encodes again.

    Over ranks, the ranks of data row 0 write their own shards' files; after
    a barrier rank 0 writes the manifest, and a second barrier returns every
    rank with the directory complete. The files are a one-process save's."""
    from lantern_tpu_torch.storage.snapshot import save_snapshot

    if index.params is None:
        raise ValueError("ShardedIndex has no params; cannot save")
    mesh = index.mesh
    distributed = mesh is not None and mesh.distributed
    if not distributed or mesh.data_row == 0:
        os.makedirs(dir_path, exist_ok=True)
        gids = _host(index.global_ids)
        codebook = _sharded_codebook(index)
        for j, si in enumerate(index.shard_ids):
            save_snapshot(_ShardView(index, j),
                          os.path.join(dir_path, f"shard_{si}.ldb"),
                          pq_codebook=codebook)
            np.save(os.path.join(dir_path, f"shard_{si}.gids.npy"), gids[j])
    if distributed:
        _dist.barrier(mesh.device)
    if not distributed or mesh.rank == 0:
        manifest = {"version": 2, "n_shards": index.n_shards,
                    "dim": index.params.dim, "m": index.params.m,
                    "metric": int(index.params.metric),
                    "quant": _quant_kind(index),
                    "keep_rerank": index.rerank_rows is not None}
        tmp = os.path.join(dir_path, "manifest.json.tmp")
        with open(tmp, "w") as f:
            json.dump(manifest, f)
        os.replace(tmp, os.path.join(dir_path, "manifest.json"))
    if distributed:
        _dist.barrier(mesh.device)


def load_sharded(dir_path: str, mesh: Mesh, engine: str = "native") -> ShardedIndex:
    """Load a ``save_sharded`` directory onto the mesh's device (its shard
    count must equal the mesh's; each rank reads only its own shards, so a
    directory written by any number of ranks loads on any other);
    quantised shards are encoded again from their saved source rows with
    the saved codebook."""
    from lantern_tpu_torch.storage.snapshot import load_snapshot

    with open(os.path.join(dir_path, "manifest.json")) as f:
        manifest = json.load(f)
    s = manifest["n_shards"]
    if mesh.shape["shard"] != s:
        raise ValueError(f"snapshot has {s} shards but mesh shard axis is "
                         f"{mesh.shape['shard']}")
    shards, gids = [], []
    params = codebook = None
    for si in mesh.local_shards:
        eng, cb = load_snapshot(os.path.join(dir_path, f"shard_{si}.ldb"),
                                engine=engine, return_codebook=True)
        params = eng.p
        codebook = codebook or cb
        g = np.load(os.path.join(dir_path, f"shard_{si}.gids.npy"))
        shards.append(eng)
        gids.append(g[g >= 0][:eng.n])
    quant_kind = manifest.get("quant")
    if quant_kind == "pq":
        ix = _stack_engines(shards, gids, dataclasses.replace(params, pq=False),
                            mesh)
        return quantize_sharded(ix, mesh, quant="pq", codebook=codebook,
                                keep_rerank=manifest.get("keep_rerank", True))
    if quant_kind == "i8":
        ix = _stack_engines(shards, gids,
                            dataclasses.replace(params, quant=QuantKind.F32), mesh)
        return quantize_sharded(ix, mesh, quant="i8")
    return _stack_engines(shards, gids, params, mesh)


def _unstack_shard(index: ShardedIndex, si: int) -> DeviceGraph:
    """Shard ``si`` as a standalone DeviceGraph (its own copies)."""
    view = index.shard(si)
    return dataclasses.replace(view, **{
        f.name: getattr(view, f.name).clone()
        for f in dataclasses.fields(view)
        if isinstance(getattr(view, f.name), torch.Tensor)
    })


def insert_sharded(
    index: ShardedIndex,
    vectors: np.ndarray,
    mesh: Mesh,
    labels: np.ndarray | None = None,
    batch: int = 256,
    seed: int = 0,
    candidates: str = "flat",
    flat_until: int = 2_000_000,
) -> ShardedIndex:
    """Insert new rows, each into its round-robin owner shard (global id
    ``gid % S``, the build's partition), by the plan and the rounds of
    :func:`build_sharded_device`; ``index`` is left as it is.

    The tables grow (capacity and upper capacity doubling as needed) and
    take the new rows on the device: the vector and adjacency tensors never
    go to the host. The host reads only per-node metadata (levels, 4 bytes
    a row) and per-shard counts to plan the rounds. Levels come from
    ``default_rng(seed + total nodes)``. PQ shards run the rounds over their
    decoded rows, the new rows snapped to their centroids first, and are
    encoded again (old codes come back unchanged; the rerank copy takes the
    new rows as given); i8 shards over their dequantised rows; bf16 tables
    stay bf16; hamming (b1) shards over their words. The hybrid switch is
    checked once an insert, on the shortest shard.

    Over ranks, every rank is given the whole batch and keeps the rows its
    shards own; one all-gather over the data row brings every shard's
    levels and counts (4 bytes a row), so each rank draws the whole plan.
    """
    if index.params is None:
        raise ValueError("ShardedIndex has no params; cannot insert")
    if index.upper_ids is None:
        raise ValueError("insert_sharded requires upper_ids (every "
                         "lantern_tpu_torch constructor sets them)")
    _check_mesh(index, mesh)
    params = index.params
    metric = Metric(index.metric)
    quant_mode = _quant_kind(index)
    if quant_mode is None and index.quant not in (
            int(QuantKind.F32), int(QuantKind.F16), int(QuantKind.B1)):
        raise NotImplementedError(
            f"insert into a quant={index.quant} ShardedIndex is not supported")
    np_dtype = np.uint32 if metric == Metric.HAMMING else np.float32
    vectors = np.ascontiguousarray(vectors, np_dtype)
    b, width = vectors.shape
    s, cap = index.n_shards, index.cap
    dev = index.device

    true_rows = None
    if quant_mode == "pq":
        codebook = _sharded_codebook(index)
        if codebook.dim != width:
            raise ValueError("PQ shard codebook missing or dim mismatch")
        # snapped to their centroids in the ROTATED space: the edges are
        # built over what will be stored, and encoding them again is exact
        true_rows = vectors
        vectors = _host(pq_snap(_t(vectors, dev), index.pq_codebook,
                                index.pq_rotation))

    # small reads: per-shard node counts, upper-slot highwater and largest
    # global id, and the levels (4 bytes a row), of every shard
    loc = list(index.shard_ids)
    sl = index.n_local
    meta = np.stack([np.asarray(index.num_nodes, np.int64),
                     np.maximum(_host(index.upper_slot.amax(1)).astype(np.int64)
                                + 1, 0),
                     _host(index.global_ids.amax(1)).astype(np.int64)], 1)
    lvl_old = _host(index.levels)
    if mesh.distributed:
        meta = _dist.all_gather_rows(meta, mesh.row_group, dev)
        lvl_old = _dist.all_gather_rows(lvl_old, mesh.row_group, dev)
    nn, nup = meta[:, 0], meta[:, 1]
    n_global = int(meta[:, 2].max())
    new_gids = np.arange(n_global + 1, n_global + 1 + b)
    labels = (new_gids.astype(np.uint64) if labels is None
              else np.asarray(labels, np.uint64))

    owner = (new_gids % s).astype(np.int64)
    b_si = np.bincount(owner, minlength=s)
    bmax = int(b_si.max())
    if bmax == 0:
        return index
    bpad = max(8, 1 << int(np.ceil(np.log2(bmax))))  # the per-shard block
    lvl_full, lvl_blk, slot_blk, new_cap, ucap, level_ids = plan_insert(
        lvl_old, nn, nup, owner, bpad, params.level_lambda,
        np.random.default_rng(seed + int(nn.sum())))

    # this rank's blocks of new rows
    rows_np = np.zeros((sl, bpad, width), np_dtype)
    sq_np = np.zeros((sl, bpad), np.float32)
    lab_blk = np.zeros((sl, bpad), np.uint64)
    gid_blk = np.full((sl, bpad), -1, np.int32)
    dele_blk = np.ones((sl, bpad), bool)  # lanes beyond b_si stay tombstoned
    with_rerank = quant_mode == "pq" and index.rerank_rows is not None
    if with_rerank:
        true_blk = np.zeros((sl, bpad, width), np.float32)
        true_sq_blk = np.zeros((sl, bpad), np.float32)
    for j, si in enumerate(loc):
        mine = owner == si
        k = int(b_si[si])
        rows_np[j, :k] = vectors[mine]
        if metric != Metric.HAMMING:
            vf = rows_np[j, :k].astype(np.float32)
            sq_np[j, :k] = np.einsum("nd,nd->n", vf, vf)
        if with_rerank:
            true_blk[j, :k] = true_rows[mine]
            true_sq_blk[j, :k] = np.einsum("nd,nd->n", true_blk[j, :k],
                                           true_blk[j, :k])
        lab_blk[j, :k] = labels[mine]
        gid_blk[j, :k] = new_gids[mine]
        dele_blk[j, :k] = False

    # ---- grow and scatter on the device, then the rounds ----
    nn_loc = nn[loc]
    old = {k: getattr(index, k) for k in TABLES}
    old["vectors"] = round_rows(index.vectors, index.quant, index.vec_scales,
                                index.pq_codebook, widen=False)
    tables = grown_tables(
        old, nn_loc, nup[loc], _host(index.upper_ids), new_cap, ucap,
        {"vectors": _t(rows_np, dev), "sq_norms": _t(sq_np, dev),
         "levels": lvl_blk[loc], "upper_slot": slot_blk[loc]})
    lab2 = grown(index.labels, new_cap, 0)
    put_blocks(lab2, nn_loc, _t(lab_blk, dev))
    dele2 = grown(index.deleted, new_cap, True)
    put_blocks(dele2, nn_loc, _t(dele_blk, dev))
    gid2 = grown(index.global_ids[:, :cap], new_cap + 1, -1)
    put_blocks(gid2, nn_loc, _t(gid_blk, dev))
    states = build_states(tables, lvl_full[loc], index.entry, index.max_level,
                          nn_loc, index.m, index.dim, metric, seeded=False)
    # one group: the hybrid switch is checked once an insert
    insert_rounds(states, [a[loc] for a in level_ids],
                  insert_groups(nn_loc, b_si[loc], bpad, batch, candidates,
                                flat_until, int(nn.min()), group=bpad),
                  params.ef_construction, max(4, index.m // 2))

    # ---- quantised storage restored (exact for the old rows) ----
    out_vecs, out_scales = stored_rows(tables.pop("vectors"), index.quant,
                                       index.vectors.dtype, index.pq_codebook)
    new_rerank, new_rsqn = index.rerank_rows, index.rerank_sqn
    if with_rerank:
        new_rerank = grown(index.rerank_rows, new_cap, 0)
        put_blocks(new_rerank, nn_loc, _t(true_blk, dev).to(new_rerank.dtype))
        new_rsqn = grown(index.rerank_sqn, new_cap, 0)
        put_blocks(new_rsqn, nn_loc, _t(true_sq_blk, dev))
    return dataclasses.replace(
        index, **tables, vectors=out_vecs, labels=lab2, deleted=dele2,
        global_ids=gid2,
        entry=tuple(st.entry for st in states),
        max_level=tuple(st.max_level for st in states),
        num_nodes=tuple(int(nn[si] + b_si[si]) for si in loc),
        vec_scales=out_scales, rerank_rows=new_rerank, rerank_sqn=new_rsqn,
    )


def delete_sharded(index: ShardedIndex, labels: np.ndarray) -> ShardedIndex:
    """Tombstone every row of the given labels across all shards (delete.c
    semantics; a duplicated label tombstones each of its rows). Each rank
    tombstones its own shards' rows; no collective.

    Labels are resolved on the host by a sorted search per shard, O((cap +
    L) log cap) time and 8 bytes a row of label reads."""
    dead = np.unique(np.asarray(labels, np.uint64).reshape(-1))
    lab = _host(index.labels).view(np.uint64)
    old = _host(index.deleted)
    hit = np.zeros_like(old)
    for si in range(lab.shape[0]):
        order = np.argsort(lab[si], kind="stable")
        slab = lab[si][order]
        lo = np.searchsorted(slab, dead, side="left")
        counts = np.searchsorted(slab, dead, side="right") - lo
        if counts.sum() == 0:
            continue
        starts = np.repeat(lo, counts)
        offs = np.arange(counts.sum()) - np.repeat(np.cumsum(counts) - counts,
                                                   counts)
        hit[si][order[starts + offs]] = True
    return dataclasses.replace(index,
                               deleted=_t(np.logical_or(old, hit), index.device))


def compact_sharded(
    index: ShardedIndex,
    mesh: Mesh,
    params: HnswParams | None = None,
    batch: int = 256,
    seed: int = 0,
    **kw,
) -> ShardedIndex:
    """Rebuild without the tombstoned rows (``Index.compact``'s sharded
    analog): the live rows, read through their source rows, go through
    :func:`build_sharded_device` over the mesh's shards; quantised indexes
    are encoded again with their old codebook. Labels are kept; global ids
    are assigned anew round-robin over the live rows.

    ``params`` may re-parametrise the graph (dim and metric must match).
    ``kw`` goes to ``build_sharded_device``.

    Over ranks, the live rows and labels are all-gathered over the data row
    in global shard order (each rank then holds every live row on the
    host: 512 MB at 1M f32 rows of 128), and each rank builds its shards.
    """
    p = index.params if params is None else params
    if index.params is not None:
        for field in ("dim", "metric"):
            if getattr(p, field) != getattr(index.params, field):
                raise ValueError(f"compact_sharded cannot change {field}")
    quant_kind = _quant_kind(index)
    live_vecs, live_labels = [], []
    for si in range(index.n_local):
        view = _ShardView(index, si)
        n = view.n
        alive = ~view.deleted[:n]
        v = view.vectors[:n]
        if isinstance(v, torch.Tensor):
            v = v.float().numpy()  # exact widening; store="bf16" rounds again
        live_vecs.append(np.asarray(v)[alive])
        live_labels.append(view.labels[:n][alive])
    vecs = np.concatenate(live_vecs)
    labels = np.concatenate(live_labels).astype(np.uint64)
    if mesh.distributed:
        vecs = _dist.all_gather_rows(vecs, mesh.row_group, mesh.device)
        labels = _dist.all_gather_rows(labels, mesh.row_group, mesh.device)
    base_p = p
    if quant_kind == "pq":
        base_p = dataclasses.replace(p, pq=False)
    elif quant_kind == "i8":
        base_p = dataclasses.replace(p, quant=QuantKind.F32)
    out = build_sharded_device(vecs, base_p, mesh, batch=batch, seed=seed,
                               labels=labels, **kw)
    if quant_kind is not None:
        out = quantize_sharded(out, mesh, quant=quant_kind,
                               codebook=_sharded_codebook(index),
                               keep_rerank=index.rerank_rows is not None)
    return out


@dataclasses.dataclass
class ShardedSearchStats:
    """Static description of a sharded search (for planning and costing)."""

    n_shards: int
    shard_cap: int
    collective_bytes_per_batch: int

    @classmethod
    def of(cls, index: ShardedIndex, q: int, k: int) -> "ShardedSearchStats":
        s = index.n_shards
        return cls(
            n_shards=s,
            shard_cap=index.global_ids.shape[1] - 1,
            # [S, Q, k] of f32 distance, i32 id and two u32 label words: the
            # results the merge reads (one all-gather on the reference's mesh;
            # over ranks, the data rows' all-gathers together, which
            # parallel._dist.merge_stats counts as received)
            collective_bytes_per_batch=s * q * k * 16,
        )
