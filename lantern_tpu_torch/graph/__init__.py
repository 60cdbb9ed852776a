"""The graph on the device and its batched search."""

from lantern_tpu_torch.graph.device import DeviceGraph, to_device  # noqa: F401
from lantern_tpu_torch.graph.search import search, search_batched  # noqa: F401
