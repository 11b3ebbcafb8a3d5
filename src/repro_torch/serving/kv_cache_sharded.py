"""Prime-space partitioned paged KV cache (port of
``repro.serving.kv_cache_sharded``).

``VectorizedPagedKVCache`` made the serving cache an array state machine;
this module partitions the cache's *PFCS state* — the prime space, the
chain-composite registry, and the bulk-discovery work — into shards:

  * **Ownership.**  Every page's prime has exactly one owner shard
    (:class:`repro_torch.core.engine.shard.PrimeSpacePartition` —
    contiguous prime-value blocks striped round-robin).  A chain edge
    whose two page primes share an owner lives in that shard's registry
    slice; an edge straddling prime ranges is cross-shard and rides the
    batched gcd exchange.
  * **Per-shard bulk discovery.**  Successor tables are rebuilt per
    shard through the divisibility-mask kernel
    (:func:`repro_torch.core.engine.shard.sharded_successor_table`);
    cross-shard chains are resolved by the gcd kernel and decoded by the
    squarefree-factorization kernel.  This is the path that launches all
    three kernels on every registry change.  The assembled rows are
    bit-identical to the single-device table, so every placement
    decision — and therefore every ``PARITY_COUNTERS`` entry — stays
    bit-exact against the scalar oracle at ANY shard count.
  * **Owner-routed accounting.**  ``touch_batch`` routes each touch to
    the owner shard of the touched page: per-shard ``PageStats`` carry
    the same counters as the oracle's, and their field-wise sum equals
    the aggregate ``stats`` exactly (``shard_load``).

Placement (HBM slot arrays, LRU stamps) deliberately remains ONE global
state machine: Theorem 1's zero-false-positive guarantee and the
oracle-parity contract both pin the *global* interleaving of demand and
prefetch traffic, and HBM is one physical resource per serving host.
What spreads over ranks is the discovery work: with ``mesh="auto"`` and a
started ``torch.distributed`` group of at least ``n_shards`` ranks, each
rank scans one shard and the cross-shard slices ride an all-gather
(``core/engine/shard.py``); every rank runs the same serving program and
ends with the same rows and counters.  Without a group the shards run as
a loop on ``device``.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.engine.shard import (PrimeSpacePartition,
                                           ShardScanReport, resolve_mesh,
                                           sharded_successor_table)
from repro_torch.obs.trace import EV_GCD_EXCHANGE

from .kv_cache import PARITY_COUNTERS, PageStats
from .kv_cache_vec import VectorizedPagedKVCache

__all__ = ["ShardedPagedKVCache"]


class ShardedPagedKVCache(VectorizedPagedKVCache):
    """Drop-in ``VectorizedPagedKVCache`` with prime-space partitioned
    PFCS state.  Tables are always maintained by per-shard bulk rebuild (the
    registry slices are the shards' source of truth; incremental
    append-maintenance is a single-device optimization), triggered at
    most once per ``touch_batch`` when the registry changed.
    """

    def __init__(self, hbm_pages: int = 1024, page_size: int = 16,
                 prefetch_budget: int = 4, n_shards: int = 2,
                 mesh="auto", stripes_per_shard: int = 8,
                 max_bits: int = 62, device="cuda"):
        # discover="host" disables the incremental fast path, so every
        # registry change routes through the (sharded) bulk rebuild
        super().__init__(hbm_pages=hbm_pages, page_size=page_size,
                         prefetch_budget=prefetch_budget, discover="host",
                         max_bits=max_bits, device=device)
        self.partition = PrimeSpacePartition(n_shards, stripes_per_shard)
        self.n_shards = self.partition.n_shards
        self.mesh = resolve_mesh(mesh, self.n_shards)
        self.shard_stats: List[PageStats] = [PageStats()
                                             for _ in range(self.n_shards)]
        self.last_scan = ShardScanReport()

    # ------------------------------------------------------------------ #
    # ownership                                                           #
    # ------------------------------------------------------------------ #

    def owner_of_page(self, pid: int) -> int:
        """Owner shard of a page (pages without a prime fall to shard 0)."""
        p = self.assigner.prime_of(pid)
        return 0 if p is None else self.partition.owner(p)

    def shard_composites(self) -> Tuple[List[np.ndarray], np.ndarray]:
        """Current registry partition: per-shard-local composite arrays
        plus the cross-shard array, in global registration order (object
        dtype when the registry is wide)."""
        arr = self.registry.composites_view()
        local_pos, cross_pos = self.partition.classify(self.registry)
        return ([arr[np.asarray(pos, dtype=np.int64)]
                 if pos else np.empty(0, arr.dtype) for pos in local_pos],
                arr[np.asarray(cross_pos, dtype=np.int64)]
                if cross_pos else np.empty(0, arr.dtype))

    # ------------------------------------------------------------------ #
    # sharded bulk discovery                                              #
    # ------------------------------------------------------------------ #

    def refresh_tables(self, discover: Optional[str] = None) -> None:
        """Rebuild every successor row by per-shard divisibility scans +
        the cross-shard gcd exchange, on ``device`` (one shard per rank of
        ``mesh``, when there is one).  An explicit
        ``discover="host"|"kernel"`` falls back to the single-device
        bulk path (cross-check hook for the parity tests)."""
        if discover is not None:
            super().refresh_tables(discover)
            return
        self.last_scan = ShardScanReport()
        rows = sharded_successor_table(self.registry, self.assigner,
                                       range(self._next_page),
                                       self.partition, mesh=self.mesh,
                                       report=self.last_scan,
                                       device=self.device)
        if self.obs is not None:
            for sh, n_local in enumerate(self.last_scan.local_composites):
                self.obs.emit(EV_GCD_EXCHANGE, shard=sh, arg=n_local)
        self._ensure_pages(self._next_page)
        self._install_rows(rows)

    # ------------------------------------------------------------------ #
    # owner-routed touches and per-shard accounting                       #
    # ------------------------------------------------------------------ #

    def _page_for_tokens(self, token_block) -> Tuple[int, bool]:
        before = self.stats.shared_prefix_pages
        pid, hit = super()._page_for_tokens(token_block)
        if self.stats.shared_prefix_pages > before:
            ss = self.shard_stats[self.owner_of_page(pid)]
            ss.shared_prefix_pages += 1
        return pid, hit

    def touch_batch(self, items: Sequence[Tuple[int, int]]) -> List[str]:
        """Demand-access a decode batch, routing each touch to the owner
        shard of its page.  Placement applies in submission order (the
        parity contract pins the global interleaving); what the routing
        decides is accounting — every counter delta a touch produces,
        including evictions and prefetches it triggers, is charged to
        the serving shard."""
        self._sync_tables()
        tiers: List[str] = []
        for r, i in items:
            pid = self.chains[r][i]
            ss = self.shard_stats[self.owner_of_page(pid)]
            before = self.stats.parity_tuple()
            tiers.append(self._touch_one(pid))
            for f, b, a in zip(PARITY_COUNTERS, before,
                               self.stats.parity_tuple()):
                if a != b:
                    setattr(ss, f, getattr(ss, f) + (a - b))
        return tiers

    # ------------------------------------------------------------------ #
    # aggregation / introspection                                         #
    # ------------------------------------------------------------------ #

    def aggregate_shard_stats(self) -> PageStats:
        """Field-wise sum of the per-shard stats — equals the global
        ``stats`` on every ``PARITY_COUNTERS`` entry (tested)."""
        agg = PageStats()
        for ss in self.shard_stats:
            for f in PARITY_COUNTERS:
                setattr(agg, f, getattr(agg, f) + getattr(ss, f))
        return agg

    def shard_load(self) -> List[Dict[str, int]]:
        """Per-shard counter snapshot for the load benchmark report."""
        return [{f: getattr(ss, f) for f in PARITY_COUNTERS}
                for ss in self.shard_stats]
