"""Sharded indexes: S subgraphs on a leading shard axis of one card, or
placed over the ranks of a process group (``init_multihost``)."""

from lantern_tpu_torch.parallel.sharded import (  # noqa: F401
    Mesh,
    ShardedIndex,
    build_sharded,
    build_sharded_device,
    compact_sharded,
    delete_sharded,
    flat_search_sharded,
    flat_search_sharded_rerank,
    init_multihost,
    insert_sharded,
    load_sharded,
    local_exclude_masks,
    make_mesh,
    quantize_sharded,
    save_sharded,
    search_sharded,
)
