"""Process groups for the sharded index: joining one, and the few
collectives the sharded legs make.

A collective's tensors live on the card under NCCL and in host memory
under gloo; under gloo every copy between the card and the host is made
here, explicitly. The search merges' bytes, host copies and seconds are
counted in ``merge_stats``.
"""

from __future__ import annotations

import datetime
import os
import time
import urllib.parse

import numpy as np
import torch
import torch.distributed as dist

from lantern_tpu_torch import resolve_device

DEFAULT_TIMEOUT_S = 120.0
# what init_multihost chose, and the (data, shard) groups made so far (every
# rank makes the same groups in the same order, so a layout's groups are made
# once and reused)
_state: dict = {"device": None, "timeout_s": DEFAULT_TIMEOUT_S, "groups": {}}
# this process's search-merge all-gathers since the last reset: calls,
# bytes this rank received, bytes copied between the card and the host,
# seconds (waiting for the slowest rank included)
merge_stats = {"calls": 0, "bytes": 0, "host_bytes": 0, "seconds": 0.0}


def reset_merge_stats() -> None:
    merge_stats.update(calls=0, bytes=0, host_bytes=0, seconds=0.0)


def _loopback(init_method: str) -> bool:
    """True when every rank of the store runs on this host (a file store or a
    loopback address)."""
    url = urllib.parse.urlparse(init_method)
    if url.scheme == "file":
        return True
    host = url.hostname or ""
    return host == "localhost" or host.startswith("127.") or host == "::1"


def init_multihost(coordinator_address: str | None = None,
                   num_processes: int | None = None,
                   process_id: int | None = None, *,
                   backend: str | None = None,
                   device: str | torch.device | None = None,
                   init_method: str | None = None,
                   timeout_s: float = DEFAULT_TIMEOUT_S) -> torch.device:
    """Join this process to a ``torch.distributed`` group of
    ``num_processes`` ranks as rank ``process_id``; returns the device it
    runs on. After this, ``make_mesh`` lays its shards over the group's
    ranks.

    With no arguments it reads torchrun's environment (``MASTER_ADDR``,
    ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``,
    ``LOCAL_WORLD_SIZE``). ``coordinator_address`` is ``host:port`` of rank
    0's TCP store; ``init_method`` (for example ``file:///tmp/store``)
    takes its place.

    - device: ``cuda:LOCAL_RANK`` (the local rank modulo the visible cards;
      without ``LOCAL_RANK``, the rank), or ``device``; with no card and no
      ``device="cpu"`` it raises;
    - backend: ``"nccl"`` on a card, ``"gloo"`` on the CPU, or ``backend``.
      NCCL refuses two ranks on one card, so when this host's ranks
      outnumber its cards, ``"nccl"`` raises and names ``backend="gloo"``
      (ranks sharing a card); it never switches backend itself;
    - ``timeout_s`` bounds every collective, so a rank that died fails the
      others instead of hanging them.
    """
    env = os.environ
    world = int(num_processes if num_processes is not None
                else env.get("WORLD_SIZE", 1))
    rank = int(process_id if process_id is not None else env.get("RANK", 0))
    if not 0 <= rank < world:
        raise ValueError(f"rank {rank} outside a world of {world}")
    if init_method is None:
        addr = coordinator_address
        if addr is None and "MASTER_ADDR" in env:
            addr = f"{env['MASTER_ADDR']}:{env.get('MASTER_PORT', 29500)}"
        if addr is None:
            raise ValueError("no coordinator: pass coordinator_address "
                             "(host:port) or init_method, or run under "
                             "torchrun (MASTER_ADDR, MASTER_PORT)")
        init_method = f"tcp://{addr}"
    local_rank = int(env.get("LOCAL_RANK", rank))
    local_world = int(env.get("LOCAL_WORLD_SIZE",
                              world if _loopback(init_method) else 1))
    cards = torch.cuda.device_count()
    if backend is None:
        named_cpu = device is not None and torch.device(device).type == "cpu"
        backend = "gloo" if named_cpu else "nccl"
    if backend == "nccl" and local_world > cards:
        raise ValueError(
            f"backend='nccl' with {local_world} ranks on this host and "
            f"{cards} visible card(s): NCCL refuses two ranks on one card; "
            "pass backend='gloo' for ranks sharing a card")
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", local_rank % cards)
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("backend='nccl' needs a CUDA device; use 'gloo' on "
                         "the CPU")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout_s))
    _state.update(device=dev, timeout_s=timeout_s, groups={})
    return dev


def distributed() -> bool:
    return dist.is_available() and dist.is_initialized()


def group_device() -> torch.device | None:
    """The device init_multihost chose (None: the group was made
    elsewhere)."""
    return _state["device"]


def layout_groups(data: int, shard_ranks: int, data_row: int, shard_col: int):
    """(the ranks of this rank's data row, those of its shard column) as
    process groups. Every rank makes every group, in the same order."""
    key = (data, shard_ranks)
    if key not in _state["groups"]:
        timeout = datetime.timedelta(seconds=_state["timeout_s"])
        rows = [dist.new_group([d * shard_ranks + p for p in range(shard_ranks)],
                               timeout=timeout) for d in range(data)]
        cols = [dist.new_group([d * shard_ranks + p for d in range(data)],
                               timeout=timeout) for p in range(shard_ranks)]
        _state["groups"][key] = (rows, cols)
    rows, cols = _state["groups"][key]
    return rows[data_row], cols[shard_col]


def _comm_device(group, dev: torch.device) -> torch.device:
    return dev if dist.get_backend(group) == "nccl" else torch.device("cpu")


def all_gather_cat(t: torch.Tensor, group, merge: bool = False) -> torch.Tensor:
    """Every rank's ``t`` (equal shapes) concatenated along dim 0 in the
    group's rank order, on ``t``'s device; ``merge`` counts it in
    ``merge_stats``."""
    t0 = time.perf_counter()
    dev = t.device
    cdev = _comm_device(group, dev)
    src = t.contiguous().to(cdev)
    n = dist.get_world_size(group)
    out = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(out, src, group=group)
    res = torch.cat(out).to(dev)
    if merge:
        merge_stats["calls"] += 1
        merge_stats["bytes"] += n * src.nbytes
        if cdev != dev:
            merge_stats["host_bytes"] += src.nbytes + n * src.nbytes
        merge_stats["seconds"] += time.perf_counter() - t0
    return res


def all_gather_rows(a: np.ndarray, group, dev: torch.device) -> np.ndarray:
    """Every rank's rows ``a`` ([n_rank, ...], n_rank may differ; one dtype
    and row shape) concatenated in the group's rank order. ``dev`` is the
    rank's device (NCCL moves the rows through it)."""
    a = np.ascontiguousarray(a)
    cdev = _comm_device(group, dev)
    n = torch.tensor([a.shape[0]], dtype=torch.int64, device=cdev)
    sizes = all_gather_cat(n, group).tolist()
    width = a.dtype.itemsize * int(np.prod(a.shape[1:], dtype=np.int64))
    padded = np.zeros((max(sizes), width), np.uint8)
    padded[:a.shape[0]] = a.view(np.uint8).reshape(a.shape[0], width)
    got = all_gather_cat(torch.from_numpy(padded).to(cdev), group)
    got = got.cpu().numpy().reshape(len(sizes), max(sizes), width)
    rows = np.concatenate([got[i, :sz] for i, sz in enumerate(sizes)])
    return rows.view(a.dtype).reshape((-1,) + a.shape[1:])


def all_reduce_max(values, group, dev: torch.device) -> list[int]:
    """The element-wise maximum over the group of a short list of ints."""
    t = torch.tensor([int(v) for v in values], dtype=torch.int64,
                     device=_comm_device(group, dev))
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
    return [int(v) for v in t.tolist()]


def broadcast_object(obj, dev: torch.device, src: int = 0):
    """``obj`` of rank ``src`` on every rank of the world (pickled)."""
    box = [obj]
    dist.broadcast_object_list(
        box, src=src, device=_comm_device(None, dev))
    return box[0]


def barrier(dev: torch.device) -> None:
    if dist.get_backend() == "nccl":
        dist.barrier(device_ids=[dev.index])
    else:
        dist.barrier()
