"""Device-resident constant tables, made once per key and kept.

A decode reads its constant tables (templates, masks, constellation
points, twiddles, index ramps) from device tensors made on first use.  A
CUDA graph of the decode (pipeline.rx.make_serving_decoder) holds their
addresses, so a table must not be freed while a graph may replay it: an
evicted table's memory would go back to the allocator and be reused
under the graph.  ``device_constant`` caches are therefore never
evicted; they hold a few tables per config and device.
"""

from __future__ import annotations

import functools


def device_constant(fn):
    """Cache fn's result per argument tuple for the life of the process."""
    return functools.lru_cache(maxsize=None)(fn)
