"""Serving tier: PFCS page management for the decode hot path.

  * :class:`PagedKVCache`           — scalar paged-KV page manager (the
    bit-exact oracle; per-page §4.2 scans)
  * :class:`VectorizedPagedKVCache` — array-state page tables + bulk
    table-driven chain discovery
  * :class:`ShardedPagedKVCache`    — prime-space partitioned PFCS state;
    every registry change is rebuilt through the three CUDA kernels
  * :class:`ServingEngine`          — continuous-batching engine over any
    of the caches (``model=None`` load-generator mode)
  * :class:`SlotMachine` / :class:`SlotOracle` — the continuous-batching
    slot machine and its per-slot Python-loop twin
"""

from .engine import Request, ServingEngine, make_kv_backend
from .kv_cache import PARITY_COUNTERS, PagedKVCache, PageStats
from .kv_cache_sharded import ShardedPagedKVCache
from .kv_cache_vec import VectorizedPagedKVCache
from .slots import (SlotMachine, SlotOracle, SlotRequest,
                    poisson_arrival_ticks)

__all__ = [
    "Request", "ServingEngine", "make_kv_backend",
    "PagedKVCache", "PageStats", "PARITY_COUNTERS",
    "ShardedPagedKVCache", "VectorizedPagedKVCache",
    "SlotMachine", "SlotOracle", "SlotRequest", "poisson_arrival_ticks",
]
