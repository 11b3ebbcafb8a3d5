"""Elastic serving: live resharding + deterministic shard-loss recovery
(port of ``repro.serving.elastic``).

``ShardedPagedKVCache`` fixed its shard count at construction; this
module makes the shard dimension *elastic* while preserving the
bit-exact oracle-parity contract through every event:

* **Live resize** (:meth:`ElasticShardedPagedKVCache.resize`) — a
  shard-count change (2 -> 4 -> 2) swaps the
  :class:`~repro_torch.core.engine.shard.PrimeSpacePartition` striping
  and migrates ONLY the registry slice entries whose
  :class:`~repro_torch.sharding.stripes.BlockStripes` block changed
  owner (the :class:`~repro_torch.sharding.reshard.ReshardPlan`).
  Successor rows are untouched — they are placement state, global by
  design — so a resize costs O(moved entries), not a global rebuild.

* **Shard loss** (:meth:`fail_shard` / :meth:`recover_shard`) — a dead
  shard takes its registry slice classification and every successor row
  of the pages it owned.  Recovery reconstructs both purely by
  *re-factorizing surviving composites* through the port's
  factorization kernel on the cache's device: :meth:`ShardSlices.recover`
  decodes the lost chunk ownership from the replicated composite values
  (Theorem 1: exact, zero false positives), then one
  :func:`~repro_torch.core.engine.shard.sharded_successor_table` call
  over the dead shard's pages rebuilds exactly those rows (the mask,
  gcd and factorization kernels).  No snapshot, no
  replica of the lost metadata is consulted — determinism IS the
  recovery mechanism ("determinism-as-recoverability").

* **Failover on demand** — ``_sync_tables`` recovers any dead shard
  before the next touch, so a kill injected mid-trace can never serve
  from a hole; the chaos fuzz (``tests/test_torch_elastic.py``) pins
  bit-exact ``PARITY_COUNTERS`` / tier / LRU / prefetch-log parity
  against an uninterrupted scalar-oracle run and against the reference
  across pinned kill/resize schedules.

:class:`ElasticController` wires the dormant training-fleet pieces
(:class:`~repro_torch.training.elastic.FleetState` heartbeats,
:class:`~repro_torch.training.elastic.StragglerMonitor`,
:class:`~repro_torch.training.elastic.ElasticPlanner`) to those hooks with a
deterministic injectable clock: heartbeat expiry -> fail + recover;
straggler eviction -> same; healthy-count change -> planner-driven
resize to the largest power-of-two shard count.

Without a started ``torch.distributed`` group (or with fewer ranks than
shards) the shards run as a loop (``shard_mesh`` returns ``None``, the
case the reference takes on a host with fewer devices than shards); with
one, every resize re-meshes and each rank scans its shard.  Every kernel
call runs on the cache's ``device``.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, List, Optional, Tuple

from repro_torch.core.engine.shard import (PrimeSpacePartition,
                                           ShardScanReport, resolve_mesh,
                                           sharded_successor_table)
from repro_torch.obs.trace import EV_RECOVERY
from repro_torch.sharding.reshard import ReshardPlan, ShardSlices
from repro_torch.training.elastic import (ElasticPlanner, FleetState,
                                          StragglerMonitor)

from .kv_cache import PARITY_COUNTERS, PageStats
from .kv_cache_sharded import ShardedPagedKVCache
from .kv_cache_vec import EMPTY

__all__ = ["ElasticShardedPagedKVCache", "ElasticController",
           "RecoveryReport"]


@dataclass(frozen=True)
class RecoveryReport:
    """What one shard recovery did, and what it cost.

    ``refactorized`` counts composite chunks decoded through the
    factorize kernels (``mode="partial"``: just the lost slice;
    ``mode="full"``: the registry mutated while the shard was dead, so
    nothing was trusted and everything was re-derived).  ``pages`` are
    the dead shard's pages whose successor rows were rebuilt — the
    recovery-invariant test compares exactly these rows against a
    from-scratch ``successor_table``.
    """

    shard: int
    mode: str                        # "partial" | "full"
    refactorized: int
    rows_rebuilt: int
    pages: Tuple[int, ...]

    @property
    def reread_bytes(self) -> int:
        return 8 * self.refactorized


class ElasticShardedPagedKVCache(ShardedPagedKVCache):
    """``ShardedPagedKVCache`` with live ``resize``/``fail_shard``/
    ``recover_shard`` and a maintained
    :class:`~repro_torch.sharding.reshard.ShardSlices` registry index (which
    also feeds the sharded scan via ``precomputed=``, replacing the
    per-refresh ``classify`` walk)."""

    def __init__(self, hbm_pages: int = 1024, page_size: int = 16,
                 prefetch_budget: int = 4, n_shards: int = 2,
                 mesh="auto", stripes_per_shard: int = 8,
                 max_bits: int = 62, device="cuda"):
        super().__init__(hbm_pages=hbm_pages, page_size=page_size,
                         prefetch_budget=prefetch_budget, n_shards=n_shards,
                         mesh=mesh, stripes_per_shard=stripes_per_shard,
                         max_bits=max_bits, device=device)
        self.slices = ShardSlices(self.partition)
        self.dead_shards: set = set()
        self.recoveries = 0
        self.reshard_log: List[ReshardPlan] = []
        self.recovery_log: List[RecoveryReport] = []

    # ------------------------------------------------------------------ #
    # discovery (index-fed sharded scan)                                  #
    # ------------------------------------------------------------------ #

    def refresh_tables(self, discover: Optional[str] = None) -> None:
        if discover is not None:
            super().refresh_tables(discover)
            return
        self._recover_dead()
        self.slices.sync(self.registry)
        self.last_scan = ShardScanReport()
        rows = sharded_successor_table(
            self.registry, self.assigner, range(self._next_page),
            self.partition, mesh=self.mesh, report=self.last_scan,
            precomputed=(self.slices.local(), self.slices.cross()),
            device=self.device)
        self._ensure_pages(self._next_page)
        self._install_rows(rows)

    def _sync_tables(self) -> None:
        # failover on demand: a killed shard is recovered before any
        # touch can consult (or prefetch from) its wiped rows
        self._recover_dead()
        super()._sync_tables()

    def _recover_dead(self) -> None:
        for s in sorted(self.dead_shards):
            self.recover_shard(s)

    def _owned_pages(self, shard: int) -> List[int]:
        return [d for d in range(self._next_page)
                if (p := self.assigner.prime_of(d)) is not None
                and self.partition.owner(p) == shard]

    # ------------------------------------------------------------------ #
    # shard loss + recovery-as-refactorization                            #
    # ------------------------------------------------------------------ #

    def fail_shard(self, shard: int) -> int:
        """Kill a shard: its registry slice classification and the
        successor rows of every page it owns are dropped (per-shard
        stats survive — accounting is durable monitoring state, so the
        aggregate-parity invariant holds across failures).  Returns the
        number of registry index entries lost."""
        if not 0 <= shard < self.n_shards:
            raise ValueError(f"shard {shard} out of range "
                             f"[0, {self.n_shards})")
        if shard in self.dead_shards:
            return 0
        # survivors' index state is whatever was already synced plus the
        # replicated composite values — snapshot it before the loss
        self.slices.sync(self.registry)
        lost = self.slices.forget_shard(shard)
        for pid in self._owned_pages(shard):
            self._succ[pid, :] = EMPTY
            self._succ_len[pid] = 0
        self.dead_shards.add(shard)
        return lost

    def recover_shard(self, shard: int) -> RecoveryReport:
        """Reconstruct a dead shard's discovery state purely from the
        surviving composites: re-factorize to recover the lost slice
        classification, then rebuild ONLY its pages' successor rows
        through the sharded kernel scan."""
        if shard not in self.dead_shards:
            raise ValueError(f"shard {shard} is not dead")
        n_refac, mode = self.slices.recover(self.registry,
                                            device=self.device)
        pages = self._owned_pages(shard)
        report = ShardScanReport()
        rows = sharded_successor_table(
            self.registry, self.assigner, pages, self.partition,
            mesh=self.mesh, report=report,
            precomputed=(self.slices.local(), self.slices.cross()),
            device=self.device)
        self._ensure_pages(self._next_page)
        for d, row in rows.items():
            self._succ[d, :] = EMPTY
            self._succ_len[d] = 0
            for succ in row:
                self._succ_append(d, succ)
        self.dead_shards.discard(shard)
        self.recoveries += 1
        rep = RecoveryReport(shard=shard, mode=mode, refactorized=n_refac,
                             rows_rebuilt=len(rows),
                             pages=tuple(sorted(int(d) for d in rows)))
        self.recovery_log.append(rep)
        if self.obs is not None:
            self.obs.emit(EV_RECOVERY, shard=shard, arg=n_refac)
        return rep

    # ------------------------------------------------------------------ #
    # live resize                                                         #
    # ------------------------------------------------------------------ #

    def resize(self, n_shards: int, mesh="auto") -> ReshardPlan:
        """Live shard-count change: re-stripe the prime space, migrating
        only the moved blocks' registry index entries.  Successor rows
        and all placement state are untouched (they are shard-count
        independent), so every placement decision after a resize is
        bit-identical to the uninterrupted run.  ``mesh="auto"`` re-meshes
        (:func:`shard_mesh`: a sub-mesh of the first ``n_shards`` ranks, or
        ``None`` for the one-device loop); an explicit mesh must hold one
        rank per shard."""
        if n_shards < 1:
            raise ValueError("n_shards must be >= 1")
        self._recover_dead()
        self.slices.sync(self.registry)
        new_part = PrimeSpacePartition(int(n_shards),
                                       self.partition.stripes_per_shard)
        plan = self.slices.restripe(new_part)
        self.partition = new_part
        old_n, self.n_shards = self.n_shards, new_part.n_shards
        self.mesh = resolve_mesh(mesh, self.n_shards)
        # fold per-shard accounting so sum(shard_stats) == global stats
        # survives every resize (shard s's history lands on s % n_new)
        old_stats = self.shard_stats
        self.shard_stats = [PageStats() for _ in range(self.n_shards)]
        for s, ss in enumerate(old_stats):
            tgt = self.shard_stats[s % self.n_shards]
            for f in PARITY_COUNTERS:
                setattr(tgt, f, getattr(tgt, f) + getattr(ss, f))
        self.reshard_log.append(plan)
        return plan


class ElasticController:
    """Fleet-event loop gluing heartbeats/stragglers to the elastic
    cache.  One node == one shard-serving host (``chips_per_node=1``);
    the planner's model axis is 1, so ``plan(healthy).n_chips`` is the
    largest power-of-two shard count the surviving fleet supports —
    exactly the 2 -> 4 -> 2 resize ladder.

    ``clock`` is injectable (`ManualClock` in tests) — no wall-clock
    reads on any test path.
    """

    def __init__(self, cache: ElasticShardedPagedKVCache,
                 clock: Callable[[], float] = time.monotonic,
                 heartbeat_timeout_s: float = 30.0,
                 straggler_threshold: float = 1.5,
                 straggler_window: int = 8, evict_after: int = 3):
        self.cache = cache
        self.clock = clock
        self.fleet = FleetState(n_nodes=cache.n_shards, chips_per_node=1,
                                heartbeat_timeout_s=heartbeat_timeout_s,
                                clock=clock)
        for n in range(cache.n_shards):
            self.fleet.heartbeat(n)
        self.monitor = StragglerMonitor(threshold=straggler_threshold,
                                        window=straggler_window,
                                        evict_after=evict_after, clock=clock)
        self.planner = ElasticPlanner(model_axis=1,
                                      base_data_axis=cache.n_shards,
                                      base_pods=1,
                                      global_batch=cache.n_shards)
        self.events: List[dict] = []

    def heartbeat(self, node: Optional[int] = None) -> None:
        nodes = self.fleet.healthy_nodes if node is None else [node]
        for n in nodes:
            self.fleet.heartbeat(n)

    def join(self, node: int) -> None:
        """Admit a (new or replaced) node; the next ``tick`` may resize
        the cache back up."""
        self.fleet.join(node)

    def tick(self, replan: bool = True) -> List[dict]:
        """One control-loop step: expire silent nodes, evict confirmed
        stragglers, recover every newly-lost shard, then re-plan the
        shard count for the surviving fleet.  Returns the events taken
        (kind ``"recover"`` with latency + :class:`RecoveryReport`, or
        ``"resize"`` with the mesh plan + :class:`ReshardPlan`)."""
        out: List[dict] = []
        newly = list(self.fleet.sweep())
        _, evict = self.monitor.check()
        for n in evict:
            if n in self.fleet.healthy_nodes:
                self.fleet.mark_failed(n)
                newly.append(n)
        for node in newly:
            shard = node % self.cache.n_shards
            t0 = self.clock()
            self.cache.fail_shard(shard)
            rep = (self.cache.recover_shard(shard)
                   if shard in self.cache.dead_shards else None)
            out.append({"kind": "recover", "node": node, "shard": shard,
                        "latency_s": self.clock() - t0, "report": rep})
        healthy = len(self.fleet.healthy_nodes)
        if replan and healthy >= 1:
            plan = self.planner.plan(healthy)
            if plan.n_chips != self.cache.n_shards:
                rp = self.cache.resize(plan.n_chips)
                out.append({"kind": "resize", "mesh_plan": plan,
                            "reshard": rp})
        self.events.extend(out)
        return out
