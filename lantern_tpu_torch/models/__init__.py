"""The flagship "models" of the port: its index structures, not networks.

- :class:`~lantern_tpu_torch.index.Index`, the user-facing HNSW index
- :class:`~lantern_tpu_torch.graph.device.DeviceGraph`, the graph on the card
- :class:`~lantern_tpu_torch.parallel.sharded.ShardedIndex`, S subgraphs on a
  leading shard axis
"""

from lantern_tpu_torch.graph.device import DeviceGraph  # noqa: F401
from lantern_tpu_torch.index import Index  # noqa: F401
from lantern_tpu_torch.parallel.sharded import ShardedIndex  # noqa: F401

__all__ = ["Index", "DeviceGraph", "ShardedIndex"]
