"""The graph on the device and its batched search, and the numpy host
engine."""

from lantern_tpu_torch.graph.device import DeviceGraph, to_device  # noqa: F401
from lantern_tpu_torch.graph.search import search, search_batched  # noqa: F401
from lantern_tpu_torch.graph.host_build import LMAX, HostHnsw  # noqa: F401
