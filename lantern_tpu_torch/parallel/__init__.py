"""Sharded indexes: S subgraphs on a leading shard axis of one card."""

from lantern_tpu_torch.parallel.sharded import (  # noqa: F401
    Mesh,
    ShardedIndex,
    build_sharded,
    build_sharded_device,
    compact_sharded,
    delete_sharded,
    flat_search_sharded,
    flat_search_sharded_rerank,
    insert_sharded,
    load_sharded,
    local_exclude_masks,
    make_mesh,
    quantize_sharded,
    save_sharded,
    search_sharded,
)
