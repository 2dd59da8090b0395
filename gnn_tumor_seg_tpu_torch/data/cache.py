"""Byte-budgeted LRU cache for padded graphs (a copy of
gnn_tumor_seg_tpu/data/cache.py, sized without JAX's tree utilities).

Each sample is converted once to padded GraphBatch tensors and cached; the
dataset's cache holds host (CPU) graphs, the trainer's device cache their
copies on the card. Unbounded, a cache holds GBs at BraTS-2021 scale (1,251
brains), so both are LRUs with a byte budget: GTS_GRAPH_CACHE_MB (host) and
GTS_DEVICE_GRAPH_CACHE_MB (device), 4096 MB each by default. Beyond budget
the oldest entries are rebuilt on demand (a disk read and a repad) or copied
to the card again.
"""

from __future__ import annotations

import dataclasses
import os
from collections import OrderedDict

__all__ = ["LRUBytesCache", "nbytes_of", "default_cache_bytes",
           "device_cache_bytes"]


def default_cache_bytes() -> int:
    return int(float(os.environ.get("GTS_GRAPH_CACHE_MB", "4096")) * 2**20)


def device_cache_bytes() -> int:
    """Device-memory budget for the trainer's cache of graphs on the card (a
    hit costs no transfer in a step)."""
    return int(float(os.environ.get("GTS_DEVICE_GRAPH_CACHE_MB", "4096"))
               * 2**20)


def nbytes_of(value) -> int:
    """Total bytes of the arrays in `value`: a tensor or numpy array, or a
    dataclass of them (GraphBatch, GraphSample); other fields count 0."""
    if hasattr(value, "nbytes"):
        return int(value.nbytes)
    if dataclasses.is_dataclass(value):
        return sum(nbytes_of(getattr(value, f.name))
                   for f in dataclasses.fields(value))
    return 0


class LRUBytesCache:
    """An OrderedDict-backed LRU evicting by total stored bytes.

    Values are sized with nbytes_of at insert time. A single value larger
    than the budget is still stored (the cache then holds just that value) so
    a tiny budget degrades to "cache the current item", never to an error.
    """

    def __init__(self, max_bytes: int | None = None):
        self.max_bytes = default_cache_bytes() if max_bytes is None else int(max_bytes)
        self._data: OrderedDict = OrderedDict()
        self._sizes: dict = {}
        self.nbytes = 0

    def __len__(self) -> int:
        return len(self._data)

    def __contains__(self, key) -> bool:
        return key in self._data

    def get(self, key):
        if key not in self._data:
            return None
        self._data.move_to_end(key)
        return self._data[key]

    def put(self, key, value) -> None:
        if key in self._data:
            self._data.move_to_end(key)
            return
        size = nbytes_of(value)
        self._data[key] = value
        self._sizes[key] = size
        self.nbytes += size
        while self.nbytes > self.max_bytes and len(self._data) > 1:
            old_key, _ = self._data.popitem(last=False)
            self.nbytes -= self._sizes.pop(old_key)

    def clear(self) -> None:
        self._data.clear()
        self._sizes.clear()
        self.nbytes = 0
