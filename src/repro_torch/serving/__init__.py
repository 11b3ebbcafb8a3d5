"""Serving tier: PFCS page/expert management for the decode hot path.

  * :class:`PagedKVCache`           — scalar paged-KV page manager (the
    bit-exact oracle; per-page §4.2 scans)
  * :class:`VectorizedPagedKVCache` — array-state page tables + bulk
    table-driven chain discovery
  * :class:`ShardedPagedKVCache`    — prime-space partitioned PFCS state;
    every registry change is rebuilt through the three CUDA kernels
  * :class:`ElasticShardedPagedKVCache` — live resharding + shard-loss
    recovery by re-factorization (``ServingEngine`` takes it with
    ``kv="elastic"`` and exposes ``resize``/``fail_shard``);
    :class:`ElasticController` drives it from fleet events
  * :class:`ExpertCache` / :class:`VectorizedExpertCache` — the MoE
    expert-weight tier with co-activation prefetch (the scalar oracle and
    its array twin; ``moe="scalar"`` / ``"vec"``)
  * :class:`DedupOracle` / :class:`DedupVectorizedPagedKVCache` (and
    the sharded and elastic dedup caches) — cross-tenant copy-on-write
    shared-prefix dedup over the tenant namespaces of
    :mod:`repro_torch.tenancy` (``dedup=True``); :data:`DEDUP_COUNTERS`
    is their parity contract
  * :class:`ServingEngine`          — continuous-batching engine over any
    of the caches (``model=None`` load-generator mode; ``tenants=``,
    ``dedup=``)
  * :class:`SlotMachine` / :class:`SlotOracle` — the continuous-batching
    slot machine and its per-slot Python-loop twin
"""

from .elastic import (ElasticController, ElasticShardedPagedKVCache,
                      RecoveryReport)
from .engine import Request, ServingEngine, make_kv_backend
from .expert_cache import (EXPERT_PARITY_COUNTERS, ExpertCache,
                           ExpertCacheStats)
from .expert_cache_vec import VectorizedExpertCache
from .kv_cache import PARITY_COUNTERS, PagedKVCache, PageStats
from .kv_cache_sharded import ShardedPagedKVCache
from .kv_cache_vec import VectorizedPagedKVCache
from .slots import (SlotMachine, SlotOracle, SlotRequest,
                    poisson_arrival_ticks)

__all__ = [
    "Request", "ServingEngine", "make_kv_backend", "ExpertCache",
    "ExpertCacheStats", "EXPERT_PARITY_COUNTERS", "VectorizedExpertCache",
    "PagedKVCache", "PageStats", "PARITY_COUNTERS",
    "ShardedPagedKVCache", "VectorizedPagedKVCache",
    "ElasticShardedPagedKVCache", "ElasticController", "RecoveryReport",
    "SlotMachine", "SlotOracle", "SlotRequest", "poisson_arrival_ticks",
    "DEDUP_COUNTERS", "DedupOracle", "DedupVectorizedPagedKVCache",
    "DedupShardedPagedKVCache", "DedupElasticShardedPagedKVCache",
]

#: loaded on first use: ``dedup`` builds on ``repro_torch.tenancy``, which
#: imports this package's caches, so an eager import here would make
#: ``import repro_torch.tenancy`` circular
_DEDUP = ("DEDUP_COUNTERS", "DedupOracle", "DedupVectorizedPagedKVCache",
          "DedupShardedPagedKVCache", "DedupElasticShardedPagedKVCache")


def __getattr__(name):
    if name in _DEDUP:
        from . import dedup

        return getattr(dedup, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
