"""Vectorized per-tenant admission control and weighted eviction (port of
``repro.tenancy.qos``).

The tenanted serving caches layer three QoS mechanisms over the
existing scalar/vec/sharded paged-KV and expert caches (DESIGN.md §8.3):

  * **Weighted HBM quotas.**  Each tenant holds at most ``hbm_quota[t]``
    resident pages (slots), with quotas derived from integer priority
    weights (``weighted_quotas`` — largest-remainder apportionment)
    and ``sum(quota) <= capacity`` enforced at construction.  Quota
    state is int32 array state (``quota`` / ``occupancy`` / ``priority``
    arrays alongside the HBM slot arrays).
  * **Confined eviction.**  A tenant at quota evicts its OWN least-
    recently-used page — one masked ``argmin`` over the stamp array in
    the vectorized cache, the first own-tenant entry of the
    ``OrderedDict`` in the scalar oracle (stamp order == dict order, so
    the two victims coincide exactly).  No insert, demand or prefetch,
    can ever displace another tenant's page: a scanner tenant thrashes
    only its own allotment.
  * **Per-tenant prefetch budgets.**  The §4.2 successor prefetch loop
    runs under ``prefetch_budget[t]`` of the *touching* page's tenant;
    every issued prefetch lands in the per-tenant prefetch log.  Cross-
    tenant prefetches are impossible by the namespace isolation theorem
    (``repro_torch.tenancy.namespace``) and audited by
    ``cross_tenant_prefetches()``.

The scalar twins are the bit-exact oracles: every ``PARITY_COUNTERS``
entry, every per-touch tier, the exact HBM LRU order, per-tenant stats,
and the prefetch logs must match between the tenanted scalar and
vectorized caches under any interleaving, at any tenant count, and
composed with the mesh-sharded cache — the established differential-
fuzz recipe (``tests/test_torch_tenancy.py`` holds the port to the
reference's caches as well).

Entry points: :class:`TenantQoSConfig`, the four tenanted paged-KV
caches and the two tenanted expert caches.  Quota state is numpy on the
host; every cache takes ``device`` (default ``"cuda"``) and passes it to
its untenanted parent, which runs its discovery kernels there (the
sharded and elastic caches on every registry refresh).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.core.primes import CacheLevel
from repro_torch.serving.expert_cache import ExpertCache
from repro_torch.serving.expert_cache_vec import VectorizedExpertCache
from repro_torch.serving.elastic import ElasticShardedPagedKVCache
from repro_torch.serving.kv_cache import (PARITY_COUNTERS, PagedKVCache,
                                          PageStats)
from repro_torch.serving.kv_cache_sharded import ShardedPagedKVCache
from repro_torch.serving.kv_cache_vec import EMPTY, VectorizedPagedKVCache

from .namespace import TenantAssigner, TenantNamespace

__all__ = [
    "weighted_quotas", "refcount_weighted_shares", "TenantQoSConfig",
    "QuotaState",
    "TenantedPagedKVCache", "TenantedVectorizedPagedKVCache",
    "TenantedShardedPagedKVCache", "TenantedElasticShardedPagedKVCache",
    "TenantedExpertCache", "TenantedVectorizedExpertCache",
]

_STAMP_MAX = np.iinfo(np.int64).max


def _audit_prefetch_log(log, assigner, namespace,
                        tenant_of_element) -> int:
    """Theorem-level audit shared by both cache tiers: count prefetch
    pairs whose source and target element primes fall in different
    tenants' block families (pure value ownership — the §8.2 corollary
    says this must be 0).  Elements whose prime was since recycled
    audit by ``tenant_of_element`` (the recorded binding) instead."""
    bad = 0
    for src, tgt in log:
        ps, pt = assigner.prime_of(src), assigner.prime_of(tgt)
        if ps is not None and pt is not None:
            if (namespace.tenant_of_value(ps)
                    != namespace.tenant_of_value(pt)):
                bad += 1
        elif tenant_of_element(src) != tenant_of_element(tgt):
            bad += 1
    return bad


def weighted_quotas(capacity: int, priorities: Sequence[int]) -> List[int]:
    """Apportion ``capacity`` HBM pages over tenants by integer priority
    weight: every tenant gets at least 1, the remainder is split
    proportionally (largest-remainder method, ties to the lower tenant
    id — fully deterministic)."""
    pri = [int(p) for p in priorities]
    n = len(pri)
    if n < 1:
        raise ValueError("need at least one tenant")
    if any(p < 1 for p in pri):
        raise ValueError("priorities must be >= 1")
    if capacity < n:
        raise ValueError(f"capacity {capacity} cannot give {n} tenants "
                         f"one page each")
    extra = capacity - n
    total = sum(pri)
    raw = [extra * p / total for p in pri]
    out = [1 + int(r) for r in raw]
    rem = capacity - sum(out)
    order = sorted(range(n), key=lambda i: (-(raw[i] - int(raw[i])), i))
    for i in order[:rem]:
        out[i] += 1
    return out


@dataclass(frozen=True)
class TenantQoSConfig:
    """Per-tenant QoS contract: HBM quota, prefetch budget, priority.

    ``shared_quota`` (default 0) reserves HBM slots for the shared
    dedup namespace's read-only pages (``repro_torch.serving.dedup``,
    DESIGN.md §12); it participates in the quota-partition inequality
    — ``sum(hbm_quota) + shared_quota <= capacity`` — so shared pages
    can never displace (or be displaced by) a tenant's private pages."""

    n_tenants: int
    hbm_quota: Tuple[int, ...]
    prefetch_budget: Tuple[int, ...]
    priority: Tuple[int, ...]
    shared_quota: int = 0

    def validate(self, capacity: int) -> None:
        T = self.n_tenants
        if T < 1:
            raise ValueError("n_tenants must be >= 1")
        for name, v in (("hbm_quota", self.hbm_quota),
                        ("prefetch_budget", self.prefetch_budget),
                        ("priority", self.priority)):
            if len(v) != T:
                raise ValueError(f"{name} has {len(v)} entries for "
                                 f"{T} tenants")
        if any(q < 1 for q in self.hbm_quota):
            raise ValueError("every tenant needs hbm_quota >= 1")
        if self.shared_quota < 0:
            raise ValueError("shared_quota must be >= 0")
        if sum(self.hbm_quota) + self.shared_quota > capacity:
            raise ValueError(
                f"sum(hbm_quota)={sum(self.hbm_quota)} + "
                f"shared_quota={self.shared_quota} exceeds HBM "
                f"capacity {capacity} — quotas must partition HBM "
                f"(that inequality IS the confinement guarantee)")
        if any(b < 0 for b in self.prefetch_budget):
            raise ValueError("prefetch budgets must be >= 0")

    @classmethod
    def even(cls, n_tenants: int, capacity: int,
             prefetch_budget: int = 4) -> "TenantQoSConfig":
        """Equal-priority split of the whole HBM capacity."""
        return cls.weighted(capacity, [1] * n_tenants, prefetch_budget)

    @classmethod
    def weighted(cls, capacity: int, priorities: Sequence[int],
                 prefetch_budget: int = 4) -> "TenantQoSConfig":
        """Priority-weighted split of the whole HBM capacity."""
        q = weighted_quotas(capacity, priorities)
        n = len(q)
        return cls(n_tenants=n, hbm_quota=tuple(q),
                   prefetch_budget=(int(prefetch_budget),) * n,
                   priority=tuple(int(p) for p in priorities))

    @classmethod
    def normalize(cls, qos: Union[int, "TenantQoSConfig"], capacity: int,
                  default_budget: int) -> "TenantQoSConfig":
        if isinstance(qos, int):
            qos = cls.even(qos, capacity, prefetch_budget=default_budget)
        qos.validate(capacity)
        return qos


class QuotaState:
    """The QoS array state: int32 quota / occupancy / priority /
    prefetch-budget vectors plus per-tenant prefetch logs, and — when
    the cache charges them (the paged-KV tier's ``_charge_touch``) —
    per-tenant stats.  ``stats_factory=None`` leaves ``tenant_stats``
    as ``None`` instead of planting counters nothing ever increments
    (the expert tier: per-tenant accounting there is the logs,
    ``occupancy``, and the per-expert tiers ``activate`` returns)."""

    def __init__(self, cfg: TenantQoSConfig, stats_factory=None):
        T = cfg.n_tenants
        self.quota = np.asarray(cfg.hbm_quota, dtype=np.int32)
        self.pf_budget = np.asarray(cfg.prefetch_budget, dtype=np.int32)
        self.priority = np.asarray(cfg.priority, dtype=np.int32)
        self.occupancy = np.zeros((T,), dtype=np.int32)
        # shared dedup namespace residency (serving/dedup.py):
        # tracked as a scalar alongside the per-tenant arrays so the
        # partition inequality stays checkable at runtime
        self.shared_quota = int(getattr(cfg, "shared_quota", 0))
        self.shared_occupancy = 0
        self.tenant_stats = None if stats_factory is None \
            else [stats_factory() for _ in range(T)]
        self.tenant_logs: List[List[Tuple[int, int]]] = [[] for _ in range(T)]


def refcount_weighted_shares(occupancy: Sequence[int],
                             shared_refs: Sequence[Dict[int, int]]
                             ) -> np.ndarray:
    """Refcount-weighted HBM accounting (DESIGN.md §12): each tenant is
    charged its private occupancy plus, for every HBM-resident shared
    page, the fraction of that page's references it holds —
    ``occupancy[t] + Σ_pages ref_t(page) / ref(page)``.  The column sum
    equals total resident pages, so dedup's HBM-bytes/user win shows up
    as each tenant's charged share dropping below its no-dedup
    footprint (``repro_torch.cases.case_dedup``)."""
    out = np.asarray(occupancy, dtype=np.float64).copy()
    for refs in shared_refs:
        total = sum(refs.values())
        if total <= 0:
            continue
        for t, r in refs.items():
            out[t] += r / total
    return out


# --------------------------------------------------------------------------- #
# paged-KV tenancy                                                            #
# --------------------------------------------------------------------------- #

class _TenantedKVBase:
    """Identity + accounting layer shared by every tenanted KV cache:
    tenant-scoped content addressing, namespace-routed prime assignment,
    per-tenant stats/log charging.  Placement enforcement lives in the
    scalar / vec placement subclasses below."""

    def _setup_tenancy(self, qos, namespace, capacity: int,
                       default_budget: int) -> None:
        cfg = TenantQoSConfig.normalize(qos, capacity, default_budget)
        if namespace is None:
            namespace = TenantNamespace(cfg.n_tenants)
        if namespace.n_tenants != cfg.n_tenants:
            raise ValueError(f"namespace has {namespace.n_tenants} tenants, "
                             f"qos config {cfg.n_tenants}")
        self.qos_config = cfg
        self.namespace = namespace
        self.qos = QuotaState(cfg, PageStats)
        self._tenant_of_req: Dict[int, int] = {}
        self._current_tenant = 0

    # -- identity hooks (see PagedKVCache._init_identity) ------------------

    def _make_assigner(self):
        return TenantAssigner(self.namespace, self.registry)

    def _content_key(self, token_block):
        # tenant-scoped content addressing: identical tokens, different
        # tenants -> different pages (no cross-tenant relationships)
        return (self._current_tenant,) + tuple(token_block)

    def _assign_page(self, pid: int) -> None:
        self.assigner.bind(pid, self._current_tenant)
        self.assigner.assign(pid, CacheLevel.L2)

    def tenant_of_page(self, pid: int) -> int:
        t = self.assigner.tenant_of(pid)
        return 0 if t is None else int(t)

    def tenant_of_request(self, req_id: int) -> int:
        return self._tenant_of_req.get(req_id, 0)

    # -- request lifecycle -------------------------------------------------

    def register_request(self, req_id: int, tokens, tenant: int = 0):
        t = int(tenant)
        if not 0 <= t < self.qos_config.n_tenants:
            raise ValueError(f"tenant {t} out of range "
                             f"[0, {self.qos_config.n_tenants})")
        self._tenant_of_req[req_id] = t
        self._current_tenant = t
        before = self.stats.shared_prefix_pages
        pages = super().register_request(req_id, tokens)
        self.qos.tenant_stats[t].shared_prefix_pages += \
            self.stats.shared_prefix_pages - before
        return pages

    def release_request(self, req_id: int) -> None:
        self._tenant_of_req.pop(req_id, None)
        super().release_request(req_id)

    # -- accounting --------------------------------------------------------

    def _charge_touch(self, t: int, before: Tuple[int, ...],
                      n_log: int) -> None:
        """Charge every counter delta (and prefetch-log slice) one touch
        produced to the touching tenant — confinement means every
        affected page is the tenant's own, so the attribution is exact
        (same delta-diff recipe as the sharded cache's shard stats)."""
        ts = self.qos.tenant_stats[t]
        for f, b, a in zip(PARITY_COUNTERS, before, self.stats.parity_tuple()):
            if a != b:
                setattr(ts, f, getattr(ts, f) + (a - b))
        if len(self.prefetch_log) > n_log:
            self.qos.tenant_logs[t].extend(self.prefetch_log[n_log:])

    def cross_tenant_prefetches(self) -> int:
        """Prefetch-log entries spanning tenant namespaces — must be 0
        (asserted by ``case_tenancy`` and the fuzz suite); see
        ``_audit_prefetch_log``."""
        return _audit_prefetch_log(self.prefetch_log, self.assigner,
                                   self.namespace, self.tenant_of_page)

    def tenant_hit_rates(self) -> List[float]:
        return [ts.hbm_hit_rate for ts in self.qos.tenant_stats]


class TenantedPagedKVCache(_TenantedKVBase, PagedKVCache):
    """Scalar oracle with per-tenant quotas — the bit-exact reference
    for the vectorized and sharded tenanted caches."""

    def __init__(self, hbm_pages: int = 1024, page_size: int = 16,
                 prefetch_budget: int = 4,
                 qos: Union[int, TenantQoSConfig] = 2,
                 namespace: Optional[TenantNamespace] = None,
                 max_bits: int = 62, device="cuda"):
        self._setup_tenancy(qos, namespace, hbm_pages, prefetch_budget)
        super().__init__(hbm_pages=hbm_pages, page_size=page_size,
                         prefetch_budget=prefetch_budget, max_bits=max_bits,
                         device=device)

    def _insert_hbm(self, pid: int, prefetched: bool) -> None:
        t = self.tenant_of_page(pid)
        q = self.qos
        if q.occupancy[t] >= q.quota[t]:
            # confined eviction: the tenant's own LRU page (first own
            # entry of the OrderedDict == oldest stamp)
            victim = next(x for x in self.hbm if self.tenant_of_page(x) == t)
            del self.hbm[victim]
            self.host.add(victim)
            self.stats.evictions += 1
            self._note_evict(victim)
            q.occupancy[t] -= 1
        super()._insert_hbm(pid, prefetched)   # base evict loop: no-op
        q.occupancy[t] += 1

    def touch(self, req_id: int, page_idx: int) -> str:
        pid = self.chains[req_id][page_idx]
        t = self.tenant_of_page(pid)
        self.prefetch_budget = int(self.qos.pf_budget[t])
        before = self.stats.parity_tuple()
        n_log = len(self.prefetch_log)
        tier = super().touch(req_id, page_idx)
        self._charge_touch(t, before, n_log)
        return tier


class _TenantedVecPlacement(_TenantedKVBase):
    """Array-state quota enforcement shared by the vectorized and the
    mesh-sharded tenanted caches."""

    def _init_slot_tenant(self) -> None:
        #: per-slot tenant id (-1 empty) — the mask the confined
        #: eviction argmin runs over
        self.slot_tenant = np.full((self.hbm_capacity,), -1, dtype=np.int32)

    def _insert(self, pid: int, prefetched: bool) -> None:
        t = self.tenant_of_page(pid)
        q = self.qos
        if q.occupancy[t] >= q.quota[t]:
            # confined eviction: oldest stamp among the tenant's own
            # slots (one masked argmin — unique stamps make it exactly
            # the scalar oracle's first-own-entry victim)
            n = self._n_occupied
            stamps = np.where(self.slot_tenant[:n] == t,
                              self.slot_t[:n], _STAMP_MAX)
            s = int(np.argmin(stamps))
            victim = int(self.slot_page[s])
            self.slot_of[victim] = EMPTY
            self.in_host[victim] = True
            self.stats.evictions += 1
            self._note_evict(victim)
            q.occupancy[t] -= 1
            self.in_host[pid] = False
            self.slot_page[s] = pid
            self.slot_of[pid] = s
            self.slot_t[s] = self._tick()
            self.slot_pf[s] = prefetched       # slot_tenant[s] stays t
        else:
            # below quota: sum(quota) <= capacity guarantees a free slot
            assert self._n_occupied < self.hbm_capacity, \
                "quota invariant broken: HBM full with a tenant under quota"
            super()._insert(pid, prefetched)
            self.slot_tenant[self.slot_of[pid]] = t
        q.occupancy[t] += 1

    def _touch_one(self, pid: int) -> str:
        t = self.tenant_of_page(pid)
        self.prefetch_budget = int(self.qos.pf_budget[t])
        before = self.stats.parity_tuple()
        n_log = len(self.prefetch_log)
        tier = super()._touch_one(pid)
        self._charge_touch(t, before, n_log)
        return tier


class TenantedVectorizedPagedKVCache(_TenantedVecPlacement,
                                     VectorizedPagedKVCache):
    """Drop-in :class:`~repro_torch.serving.kv_cache_vec.
    VectorizedPagedKVCache`
    with coprime tenant namespaces and array-state quota enforcement —
    bit-exact against ``TenantedPagedKVCache``."""

    def __init__(self, hbm_pages: int = 1024, page_size: int = 16,
                 prefetch_budget: int = 4, discover: str = "incremental",
                 qos: Union[int, TenantQoSConfig] = 2,
                 namespace: Optional[TenantNamespace] = None,
                 max_bits: int = 62, device="cuda"):
        self._setup_tenancy(qos, namespace, hbm_pages, prefetch_budget)
        super().__init__(hbm_pages=hbm_pages, page_size=page_size,
                         prefetch_budget=prefetch_budget, discover=discover,
                         max_bits=max_bits, device=device)
        self._init_slot_tenant()


class TenantedShardedPagedKVCache(_TenantedVecPlacement,
                                  ShardedPagedKVCache):
    """Tenant namespaces composed with the mesh-sharded cache: prime
    ownership stripes over SHARDS for discovery work (DESIGN.md §6) and
    over TENANTS for isolation/quotas (§8) — two independent pure
    functions of the same prime value, so the per-shard bulk rebuild
    and the collective gcd exchange run unchanged over the tenanted
    prime space."""

    def __init__(self, hbm_pages: int = 1024, page_size: int = 16,
                 prefetch_budget: int = 4, n_shards: int = 2,
                 mesh="auto", stripes_per_shard: int = 8,
                 qos: Union[int, TenantQoSConfig] = 2,
                 namespace: Optional[TenantNamespace] = None,
                 max_bits: int = 62, device="cuda"):
        self._setup_tenancy(qos, namespace, hbm_pages, prefetch_budget)
        super().__init__(hbm_pages=hbm_pages, page_size=page_size,
                         prefetch_budget=prefetch_budget, n_shards=n_shards,
                         mesh=mesh, stripes_per_shard=stripes_per_shard,
                         max_bits=max_bits, device=device)
        self._init_slot_tenant()


class TenantedElasticShardedPagedKVCache(_TenantedVecPlacement,
                                         ElasticShardedPagedKVCache):
    """Tenant namespaces composed with the ELASTIC sharded cache
    (DESIGN.md §9): ``resize``/``fail_shard``/``recover_shard`` operate
    purely on the shard striping of the prime space, while tenant
    isolation/quotas stripe the SAME prime values over tenants — two
    independent pure ownership functions, so no elastic event can move
    a page across a tenant boundary.  The chaos fuzz asserts the
    namespace isolation checker after every recovery
    (``tests/test_torch_tenancy.py``)."""

    def __init__(self, hbm_pages: int = 1024, page_size: int = 16,
                 prefetch_budget: int = 4, n_shards: int = 2,
                 mesh="auto", stripes_per_shard: int = 8,
                 qos: Union[int, TenantQoSConfig] = 2,
                 namespace: Optional[TenantNamespace] = None,
                 max_bits: int = 62, device="cuda"):
        self._setup_tenancy(qos, namespace, hbm_pages, prefetch_budget)
        super().__init__(hbm_pages=hbm_pages, page_size=page_size,
                         prefetch_budget=prefetch_budget, n_shards=n_shards,
                         mesh=mesh, stripes_per_shard=stripes_per_shard,
                         max_bits=max_bits, device=device)
        self._init_slot_tenant()


# --------------------------------------------------------------------------- #
# MoE expert tenancy                                                          #
# --------------------------------------------------------------------------- #

class _TenantedExpertBase:
    """Identity + QoS layer shared by the tenanted expert caches."""

    def _setup_expert_tenancy(self, qos, namespace, hbm_slots: int,
                              default_budget: int, n_experts: int,
                              tenant_of_expert) -> None:
        cfg = TenantQoSConfig.normalize(qos, hbm_slots, default_budget)
        if namespace is None:
            namespace = TenantNamespace(cfg.n_tenants)
        if namespace.n_tenants != cfg.n_tenants:
            raise ValueError(f"namespace has {namespace.n_tenants} tenants, "
                             f"qos config {cfg.n_tenants}")
        self.qos_config = cfg
        self.namespace = namespace
        self.qos = QuotaState(cfg)       # stats: logs/occupancy/tiers only
        if tenant_of_expert is None:
            # default: contiguous equal expert blocks per tenant
            tenant_of_expert = (np.arange(n_experts, dtype=np.int64)
                                * cfg.n_tenants) // max(1, n_experts)
        self.tenant_of_expert = np.asarray(tenant_of_expert, dtype=np.int32)
        if self.tenant_of_expert.shape != (n_experts,):
            raise ValueError("tenant_of_expert must map every expert")
        if (self.tenant_of_expert.min(initial=0) < 0
                or self.tenant_of_expert.max(initial=0) >= cfg.n_tenants):
            raise ValueError("tenant_of_expert entries out of range")
        #: router sets that spanned tenants and were split before
        #: registration (isolation by construction)
        self.cross_tenant_groups = 0

    # -- identity hooks ----------------------------------------------------

    def _make_assigner(self):
        return TenantAssigner(self.namespace, self.registry)

    def _assign_expert(self, e: int) -> None:
        self.assigner.bind(e, int(self.tenant_of_expert[e]))
        self.assigner.assign(e, CacheLevel.L2)

    # -- co-activation registration (split by tenant) ----------------------

    def observe_routing(self, expert_sets):
        """Split every router set by tenant before registration: a
        co-activation group spanning tenants would be a cross-tenant
        composite — exactly what the namespace forbids — so each
        tenant's sub-group registers separately (sub-groups keep the
        set's expert order; counted in ``cross_tenant_groups``)."""
        split = []
        for s in expert_sets:
            groups: Dict[int, List[int]] = {}
            for e in s:
                groups.setdefault(int(self.tenant_of_expert[int(e)]),
                                  []).append(int(e))
            if len(groups) > 1:
                self.cross_tenant_groups += 1
            split.extend(tuple(g) for g in groups.values())
        return super().observe_routing(split)

    def cross_tenant_prefetches(self) -> int:
        """Prefetch-log entries spanning tenant namespaces — must be 0;
        see ``_audit_prefetch_log``."""
        return _audit_prefetch_log(self.prefetch_log, self.assigner,
                                   self.namespace,
                                   lambda e: int(self.tenant_of_expert[e]))


class TenantedExpertCache(_TenantedExpertBase, ExpertCache):
    """Scalar oracle: per-tenant HBM-slot quotas and prefetch budgets
    over the MoE expert cache."""

    def __init__(self, n_experts: int, hbm_slots: int,
                 prefetch_budget: int = 4, max_group: int = 8,
                 qos: Union[int, TenantQoSConfig] = 2,
                 namespace: Optional[TenantNamespace] = None,
                 tenant_of_expert=None, device="cuda"):
        self._setup_expert_tenancy(qos, namespace, hbm_slots,
                                   prefetch_budget, n_experts,
                                   tenant_of_expert)
        super().__init__(n_experts, hbm_slots, prefetch_budget, max_group,
                         device=device)

    def _insert(self, e: int, prefetched: bool) -> None:
        t = int(self.tenant_of_expert[e])
        q = self.qos
        if q.occupancy[t] >= q.quota[t]:
            victim = next(x for x in self.hbm
                          if self.tenant_of_expert[x] == t)
            del self.hbm[victim]
            self.stats.evictions += 1
            q.occupancy[t] -= 1
        super()._insert(e, prefetched)         # base evict loop: no-op
        q.occupancy[t] += 1

    def _prefetch_coactivated(self, e: int) -> None:
        t = int(self.tenant_of_expert[e])
        self.prefetch_budget = int(self.qos.pf_budget[t])
        n_log = len(self.prefetch_log)
        super()._prefetch_coactivated(e)
        if len(self.prefetch_log) > n_log:
            self.qos.tenant_logs[t].extend(self.prefetch_log[n_log:])


class TenantedVectorizedExpertCache(_TenantedExpertBase,
                                    VectorizedExpertCache):
    """Drop-in :class:`~repro_torch.serving.expert_cache_vec.
    VectorizedExpertCache` with coprime tenant namespaces and
    array-state quota enforcement — bit-exact against
    ``TenantedExpertCache``."""

    def __init__(self, n_experts: int, hbm_slots: int,
                 prefetch_budget: int = 4, max_group: int = 8,
                 discover: str = "incremental",
                 qos: Union[int, TenantQoSConfig] = 2,
                 namespace: Optional[TenantNamespace] = None,
                 tenant_of_expert=None, device="cuda"):
        self._setup_expert_tenancy(qos, namespace, hbm_slots,
                                   prefetch_budget, n_experts,
                                   tenant_of_expert)
        super().__init__(n_experts, hbm_slots, prefetch_budget, max_group,
                         discover, device=device)
        self.slot_tenant = np.full((hbm_slots,), -1, dtype=np.int32)

    def _insert(self, e: int, prefetched: bool) -> None:
        t = int(self.tenant_of_expert[e])
        q = self.qos
        if q.occupancy[t] >= q.quota[t]:
            n = self._n_occupied
            stamps = np.where(self.slot_tenant[:n] == t,
                              self.slot_t[:n], _STAMP_MAX)
            s = int(np.argmin(stamps))
            victim = int(self.slot_expert[s])
            self.slot_of[victim] = EMPTY
            self.stats.evictions += 1
            q.occupancy[t] -= 1
            self.slot_expert[s] = e
            self.slot_of[e] = s
            self.slot_t[s] = self._tick()
            self.slot_pf[s] = prefetched       # slot_tenant[s] stays t
        else:
            assert self._n_occupied < self.hbm_slots, \
                "quota invariant broken: HBM full with a tenant under quota"
            super()._insert(e, prefetched)
            self.slot_tenant[self.slot_of[e]] = t
        q.occupancy[t] += 1

    def _prefetch_row(self, e: int) -> None:
        t = int(self.tenant_of_expert[e])
        self.prefetch_budget = int(self.qos.pf_budget[t])
        n_log = len(self.prefetch_log)
        super()._prefetch_row(e)
        if len(self.prefetch_log) > n_log:
            self.qos.tenant_logs[t].extend(self.prefetch_log[n_log:])
