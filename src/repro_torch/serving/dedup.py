"""Cross-tenant copy-on-write shared-prefix dedup (DESIGN.md §12; port of
``repro.serving.dedup``).

The dual of the tenancy isolation theorem: tenant
namespaces prove *private* pages never cross tenants, yet real traffic
is dominated by deliberately identical content — system prompts, RAG
documents — re-sent by millions of users.  This module shares exactly
that content, without weakening the isolation proof:

  * **Shared prime namespace.**  The tenant namespace reserves one
    extra block-stripe part (``TenantNamespace(..., shared=True)`` —
    ``n_parts = n_tenants + 1``).  Shared read-only pages draw primes
    from that part, coprime to every tenant's private block family, so
    ``check_isolation`` still proves no private data crosses tenants:
    a composite is a violation only when its primes span two distinct
    NON-shared tenants; wholly-shared and mixed shared<->private edges
    (the COW boundary) are legal and counted in ``n_shared``.
  * **Admission-time dedup.**  Page identity is content-addressed per
    tenant (isolation); a second, tenant-agnostic content map detects
    the SAME token prefix re-registered by a different tenant and
    *promotes* it: a fresh page in the shared namespace backs the
    content from then on (``dedup_promotions``), and every later
    admission of that prefix reuses the shared page (``dedup_hits``).
    Each admission with a shared run is cross-checked by the existing
    gcd machinery: ``shared_prefix`` against a live co-referencing
    request must recover the shared pages (Theorem 1 — exact, and the
    vectorized twin routes it through the batched-gcd kernels).
  * **Copy-on-write.**  The first block where a chain diverges from a
    shared prefix allocates a fresh PRIVATE page with a fresh prime
    from the requester's own namespace (``cow_copies``); the shared
    page's prime, refcounts, and existing composites are untouched.
  * **Refcounted placement.**  Shared pages are refcounted (int32
    array state in the vectorized twin) and live under a dedicated
    ``shared_quota`` HBM reservation — disjoint from every tenant
    quota, so dedup can never displace (or be displaced by) private
    pages.  A referenced shared page is never evicted: when the shared
    quota is pinned full by referenced pages, inserts degrade to host
    placement and prefetch candidates are skipped without consuming
    budget (``_can_insert``).  HBM accounting charges each tenant its
    refcount-weighted share of every resident shared page
    (:func:`repro_torch.tenancy.qos.refcount_weighted_shares`).

The scalar :class:`DedupOracle` is the bit-exact reference: the
vectorized / sharded / elastic dedup caches must reproduce every
``DEDUP_COUNTERS`` entry, tier, LRU order, prefetch log, per-tenant
stat, and refcount map under any interleaving — the established
differential-fuzz discipline, composed with ``SlotMachine`` continuous
batching and wide (``max_bits > 63``) registries
(``tests/test_torch_dedup.py`` holds the port to the reference as well).

On the card: every admission probe is ``shared_prefix``, which the
vectorized caches route through the batched gcd kernel (``gcd_batch``, or
the limb gcd when the registry is wide) and the squarefree factorization
on the cache's ``device``; the sharded and elastic dedup caches also
rebuild their successor tables through the discovery kernels.
"""

from __future__ import annotations

from dataclasses import replace
from typing import Dict, List, Optional, Set, Tuple, Union

import numpy as np

from repro_torch.core.primes import CacheLevel
from repro_torch.obs.trace import (EV_AGE_OUT, EV_COW, EV_DEDUP_HIT,
                                   EV_DEDUP_PROMOTE)
from repro_torch.serving.kv_cache import PARITY_COUNTERS, PagedKVCache
from repro_torch.serving.kv_cache_vec import EMPTY, VectorizedPagedKVCache
from repro_torch.tenancy.namespace import TenantNamespace
from repro_torch.tenancy.qos import (TenantQoSConfig,
                                     TenantedElasticShardedPagedKVCache,
                                     TenantedPagedKVCache,
                                     TenantedShardedPagedKVCache,
                                     TenantedVectorizedPagedKVCache,
                                     _STAMP_MAX, refcount_weighted_shares)

__all__ = ["DEDUP_COUNTERS", "DedupOracle", "DedupVectorizedPagedKVCache",
           "DedupShardedPagedKVCache", "DedupElasticShardedPagedKVCache"]


#: the full dedup parity contract: the base counters PLUS the dedup
#: counters (kept out of PARITY_COUNTERS so per-tenant stats still sum
#: to the global parity tuple in the non-dedup tenanted caches)
DEDUP_COUNTERS = PARITY_COUNTERS + ("dedup_hits", "dedup_promotions",
                                    "cow_copies")


class _DedupBase:
    """Admission / refcount / COW layer shared by the scalar oracle and
    the vectorized dedup caches.  Placement (shared-quota slots, pinned
    eviction protection) lives in the placement mixins below."""

    # -- construction ------------------------------------------------------

    @staticmethod
    def _dedup_config(qos: Union[int, TenantQoSConfig], capacity: int,
                      default_budget: int) -> TenantQoSConfig:
        """An int tenant count reserves ``capacity // (n + 1)`` HBM
        slots for the shared namespace and splits the rest evenly; an
        explicit config is used as-is (``shared_quota=0`` keeps shared
        pages host-resident — still bit-exact, just dedup-cold)."""
        if isinstance(qos, int):
            shared = max(1, capacity // (qos + 1))
            cfg = replace(TenantQoSConfig.even(qos, capacity - shared,
                                               default_budget),
                          shared_quota=shared)
        else:
            cfg = qos
        cfg.validate(capacity)
        return cfg

    def _dedup_normalize(self, qos, namespace, capacity: int,
                         default_budget: int
                         ) -> Tuple[TenantQoSConfig, TenantNamespace]:
        cfg = self._dedup_config(qos, capacity, default_budget)
        if namespace is None:
            namespace = TenantNamespace(cfg.n_tenants, shared=True)
        if namespace.shared_part is None:
            raise ValueError("dedup needs a shared-capable namespace: "
                             "TenantNamespace(n_tenants, shared=True)")
        return cfg, namespace

    def _setup_dedup(self, namespace: TenantNamespace,
                     shared_pf_budget: int) -> None:
        self.shared_part = int(namespace.shared_part)
        self._shared_pf_budget = int(shared_pf_budget)
        #: tenant-AGNOSTIC content map (raw token prefix -> page id) —
        #: the dedup detector; the per-tenant ``_content`` map keeps
        #: owning private isolation semantics unchanged
        self._global_content: Dict[Tuple[int, ...], int] = {}
        #: per shared page: per-tenant live reference counts
        self._tenant_refs: Dict[int, Dict[int, int]] = {}
        #: per live request: shared pages its chain references
        self._req_shared: Dict[int, List[int]] = {}
        #: per shared page: live requests referencing it (donor lookup
        #: for the admission gcd probe)
        self._shared_users: Dict[int, List[int]] = {}
        #: per live request: leading shared-page run length (pages) —
        #: the prefill the slot machine may skip
        self.dedup_prefix: Dict[int, int] = {}
        #: reverse of ``_global_content`` for shared pages only
        #: (page id -> content key), so age-out can drop the entry
        self._shared_key: Dict[int, Tuple[int, ...]] = {}
        #: (page id, prime) of every aged-out shared page, in order —
        #: the refcount-lifecycle audit trail (tests/test_torch_dedup.py)
        self.dedup_aged: List[Tuple[int, int]] = []
        #: aged pages whose prime release is deferred to the next
        #: admission (releasing mid-touch would mutate the registry
        #: under the live §4.2 scan / successor rows)
        self._aged_pending: List[int] = []
        self._aged_pending_set: Set[int] = set()
        #: admission gcd probes run (each asserts Theorem-1 recovery)
        self.dedup_probes = 0
        self._walk_refs: List[int] = []
        self._walk_diverged = True
        self._init_ref_store()

    # -- refcount store (overridden with int32 arrays in the vec mixin) ----

    def _init_ref_store(self) -> None:
        self._page_refs: Dict[int, int] = {}

    def ref_of(self, pid: int) -> int:
        return self._page_refs.get(pid, 0)

    def _ref_store_add(self, pid: int, delta: int) -> None:
        r = self._page_refs.get(pid, 0) + delta
        assert r >= 0, f"refcount of shared page {pid} went negative"
        self._page_refs[pid] = r

    def _ref_add(self, pid: int, tenant: int, delta: int) -> None:
        self._ref_store_add(pid, delta)
        d = self._tenant_refs.setdefault(pid, {})
        r = d.get(tenant, 0) + delta
        assert r >= 0, f"tenant {tenant} refcount of page {pid} negative"
        if r:
            d[tenant] = r
        else:
            d.pop(tenant, None)
        if not d:
            del self._tenant_refs[pid]

    # -- admission ---------------------------------------------------------

    def _is_shared_page(self, pid: int) -> bool:
        return self.tenant_of_page(pid) == self.shared_part

    def _alloc_shared_page(self) -> int:
        pid = self._next_page
        self._next_page += 1
        self.assigner.bind(pid, self.shared_part)
        self.assigner.assign(pid, CacheLevel.L2)
        return pid

    def _walk_note_shared(self, pid: int) -> None:
        self._walk_refs.append(pid)

    def _walk_note_private(self, fresh: bool) -> bool:
        if not self._walk_diverged:
            self._walk_diverged = True
            if fresh and self._walk_refs:
                # the first divergent block off a shared prefix: a
                # fresh PRIVATE page with a fresh prime — the shared
                # page and its composites are untouched (tested)
                self.stats.cow_copies += 1
                return True
        return False

    def _page_for_tokens(self, token_block) -> Tuple[int, bool]:
        key = tuple(token_block)
        owner = self._global_content.get(key)
        if owner is not None and self._is_shared_page(owner):
            # content already backed by a shared read-only page
            self.stats.shared_prefix_pages += 1
            self.stats.dedup_hits += 1
            ss = getattr(self, "shard_stats", None)
            if ss is not None:        # keep sum(shard_stats) == stats
                ss[self.owner_of_page(owner)].shared_prefix_pages += 1
            self._walk_note_shared(owner)
            if self.obs is not None:
                self.obs.emit(EV_DEDUP_HIT, page=owner,
                              tenant=self._current_tenant)
            return owner, True
        if owner is not None and self.tenant_of_page(owner) \
                != self._current_tenant:
            # private content re-seen from ANOTHER tenant: promote it
            # to a fresh shared-namespace page (the donor keeps its
            # private page; the content is shared from here on)
            pid = self._alloc_shared_page()
            self._global_content[key] = pid
            self._shared_key[pid] = key
            self.stats.dedup_promotions += 1
            self._walk_note_shared(pid)
            if self.obs is not None:
                self.obs.emit(EV_DEDUP_PROMOTE, page=pid,
                              tenant=self._current_tenant)
            return pid, False
        # same-tenant reuse (owner is this tenant's private page) or a
        # fresh allocation — both through the tenant-scoped path
        cow = self._walk_note_private(fresh=owner is None)
        pid, reused = super()._page_for_tokens(token_block)
        if owner is None:
            self._global_content[key] = pid
        if cow and self.obs is not None:
            self.obs.emit(EV_COW, page=pid, tenant=self._current_tenant)
        return pid, reused

    # -- shared-page age-out ------------------------------------------------

    def _age_out_shared(self, pid: int) -> None:
        """End-of-life for a zero-ref shared page evicted from the
        shared quota: drop its ``_global_content`` entry (these used to
        leak — the content map grew monotonically and kept resurrecting
        dead pages), bar it from prefetch resurrection, and schedule
        its prime for recycling.  The ``assigner.release`` itself is
        deferred to the next admission: running it here would drop
        composites out of the registry while the §4.2 scan (scalar) or
        a successor row (vec) of the very touch that triggered the
        eviction is still being iterated."""
        key = self._shared_key.pop(pid, None)
        if key is not None and self._global_content.get(key) == pid:
            del self._global_content[key]
        self._shared_users.pop(pid, None)
        p = self.assigner.prime_of(pid)
        self.dedup_aged.append((pid, -1 if p is None else int(p)))
        self._aged_pending.append(pid)
        self._aged_pending_set.add(pid)
        if self.obs is not None:
            self.obs.emit(EV_AGE_OUT, page=pid, tenant=self.shared_part)

    def _flush_aged(self) -> None:
        """Recycle the primes of aged-out shared pages (admission-time:
        the registry is quiescent here).  Dropping the prime purges its
        chain composites — all of them belong to dead chains or dangle
        off the dead page, since refs hit 0 only when no live chain
        contains it — and bumps the assigner epoch, which forces the
        vec twin's chunk caches and successor tables to rebuild (the
        tenancy's recycling machinery, so twin parity is preserved)."""
        if not self._aged_pending:
            return
        for pid in self._aged_pending:
            self.assigner.release(pid, CacheLevel.L2)
        self._aged_pending.clear()
        self._aged_pending_set.clear()

    # -- request lifecycle -------------------------------------------------

    def register_request(self, req_id: int, tokens, tenant: int = 0):
        self._flush_aged()
        if req_id in self.chains:             # re-register: drop old refs
            self._drop_refs(req_id)
        self._walk_refs = []
        self._walk_diverged = False
        pages = super().register_request(req_id, tokens, tenant=tenant)
        self._walk_diverged = True
        t = self.tenant_of_request(req_id)
        for pid in self._walk_refs:
            self._ref_add(pid, t, +1)
            users = self._shared_users.setdefault(pid, [])
            if req_id not in users:
                users.append(req_id)
        self._req_shared[req_id] = list(self._walk_refs)
        self.dedup_prefix[req_id] = len(self._walk_refs)
        self._admission_probe(req_id)
        return pages

    def _admission_probe(self, req_id: int) -> None:
        """Cross-check every dedup'd admission through the gcd
        machinery: against a live request co-referencing the deepest
        shared page, ``shared_prefix`` (scalar exact gcd / vectorized
        batched-gcd kernels) must recover that page — Theorem 1's
        zero-false-positive discovery applied to the dedup decision."""
        if not self._walk_refs:
            return
        last = self._walk_refs[-1]
        donor = next((r for r in self._shared_users.get(last, ())
                      if r != req_id and r in self.chains), None)
        if donor is None:
            return
        probe = self.shared_prefix(req_id, donor)
        assert last in probe, \
            "admission gcd probe failed to recover the shared prefix"
        self.dedup_probes += 1

    def _drop_refs(self, req_id: int) -> None:
        t = self.tenant_of_request(req_id)
        for pid in self._req_shared.pop(req_id, ()):
            self._ref_add(pid, t, -1)
            users = self._shared_users.get(pid)
            if users is not None:
                if req_id in users:
                    users.remove(req_id)
                if not users:
                    del self._shared_users[pid]
        self.dedup_prefix.pop(req_id, None)

    def release_request(self, req_id: int) -> None:
        self._drop_refs(req_id)
        super().release_request(req_id)

    # -- prefetch admission ------------------------------------------------

    def _part_of_page(self, pid: int) -> int:
        p = self.assigner.prime_of(pid)
        if p is not None:
            return int(self.namespace.tenant_of_value(p))
        return self.tenant_of_page(pid)

    def _prefetch_allowed(self, src: int, tgt: int) -> bool:
        # a shared page may be prefetched from anywhere; a private page
        # only along its own tenant's chain.  shared -> private is
        # blocked: the COW boundary fans out to EVERY diverging
        # tenant's private page, and the touching requester's identity
        # is not part of the §4.2 scan.
        if tgt in self._aged_pending_set:
            # dead page awaiting prime recycle: its registry edges are
            # still visible to the scan, but resurrecting it would race
            # the deferred release (skipped without consuming budget —
            # both twins walk the same candidate order)
            return False
        pt = self._part_of_page(tgt)
        return pt == self.shared_part or pt == self._part_of_page(src)

    def _can_insert(self, pid: int) -> bool:
        if not self._is_shared_page(pid) or self._resident(pid):
            return True
        q = self.qos
        return (q.shared_occupancy < q.shared_quota
                or self._has_shared_victim())

    def cross_tenant_prefetches(self) -> int:
        """Prefetch-log entries spanning two distinct NON-shared tenant
        namespaces — must be 0 (shared-namespace endpoints are the
        point of dedup, not a leak: the page is read-only and common)."""
        bad = 0
        for src, tgt in self.prefetch_log:
            ps, pt = self._part_of_page(src), self._part_of_page(tgt)
            if self.shared_part in (ps, pt):
                continue
            if ps != pt:
                bad += 1
        return bad

    # -- accounting --------------------------------------------------------

    def shared_page_refs(self, resident_only: bool = True
                         ) -> List[Dict[int, int]]:
        """Per-tenant reference maps of (HBM-resident) shared pages, in
        page-id order — the input :func:`refcount_weighted_shares`
        wants."""
        return [dict(sorted(self._tenant_refs[pid].items()))
                for pid in sorted(self._tenant_refs)
                if not resident_only or self._resident(pid)]

    def charged_shares(self) -> np.ndarray:
        """Refcount-weighted HBM pages charged to each tenant: private
        occupancy plus this tenant's fraction of every resident shared
        page (DESIGN.md §12; the HBM-bytes/user metric of
        ``case_dedup``)."""
        return refcount_weighted_shares(self.qos.occupancy,
                                        self.shared_page_refs())

    def dedup_state(self) -> Dict[str, object]:
        """Canonical dedup twin state for the differential fuzz."""
        return {
            "refs": {pid: self.ref_of(pid)
                     for pid in sorted(self._tenant_refs)},
            "tenant_refs": {pid: dict(sorted(self._tenant_refs[pid].items()))
                            for pid in sorted(self._tenant_refs)},
            "prefix": dict(sorted(self.dedup_prefix.items())),
            "shared_occupancy": int(self.qos.shared_occupancy),
            "probes": int(self.dedup_probes),
            "aged": list(self.dedup_aged),
            "aged_pending": list(self._aged_pending),
        }


class _DedupScalarPlacement(_DedupBase):
    """Shared-quota placement for the scalar oracle: dict/set tiers,
    first-matching-dict-entry eviction (== oldest stamp)."""

    def _resident(self, pid: int) -> bool:
        return pid in self.hbm

    def _has_shared_victim(self) -> bool:
        return any(self._is_shared_page(x) and self.ref_of(x) == 0
                   for x in self.hbm)

    def _insert_hbm(self, pid: int, prefetched: bool) -> None:
        if not self._is_shared_page(pid):
            super()._insert_hbm(pid, prefetched)     # tenant-confined path
            return
        q = self.qos
        if q.shared_occupancy >= q.shared_quota:
            victim = next((x for x in self.hbm
                           if self._is_shared_page(x)
                           and self.ref_of(x) == 0), None)
            if victim is None:
                # pinned full: every resident shared page is referenced
                # by a live chain — a read-only shared page is never
                # displaced, so the insert degrades to host placement
                self.host.add(pid)
                return
            del self.hbm[victim]
            self.stats.evictions += 1
            self._note_evict(victim)
            q.shared_occupancy -= 1
            # zero-ref + evicted = end of life: no host demotion — the
            # page's content entry and prime are reclaimed instead
            self._age_out_shared(victim)
        PagedKVCache._insert_hbm(self, pid, prefetched)
        q.shared_occupancy += 1

    def touch(self, req_id: int, page_idx: int) -> str:
        pid = self.chains[req_id][page_idx]
        if not self._is_shared_page(pid):
            return super().touch(req_id, page_idx)
        # shared pages run under the shared prefetch budget and charge
        # only the GLOBAL stats (per-tenant stats stay private-only —
        # refcount-weighted accounting covers the shared tier)
        self.prefetch_budget = self._shared_pf_budget
        return PagedKVCache.touch(self, req_id, page_idx)


class _DedupVecPlacement(_DedupBase):
    """Shared-quota placement for the vectorized caches: int32 refcount
    array alongside the per-page arrays, masked-argmin eviction over
    the shared slots (slot_tenant == shared_part)."""

    def _init_ref_store(self) -> None:
        self.page_refs = np.zeros((64,), dtype=np.int32)

    def ref_of(self, pid: int) -> int:
        if pid >= self.page_refs.shape[0]:
            return 0
        return int(self.page_refs[pid])

    def _ref_store_add(self, pid: int, delta: int) -> None:
        if pid >= self.page_refs.shape[0]:
            self._ensure_pages(pid + 1)
        r = int(self.page_refs[pid]) + delta
        assert r >= 0, f"refcount of shared page {pid} went negative"
        self.page_refs[pid] = r

    def _ensure_pages(self, n: int) -> None:
        super()._ensure_pages(n)
        cur = self.page_refs.shape[0]
        if self.slot_of.shape[0] > cur:
            self.page_refs = np.concatenate(
                [self.page_refs,
                 np.zeros((self.slot_of.shape[0] - cur,), dtype=np.int32)])

    def _resident(self, pid: int) -> bool:
        return pid < self.slot_of.shape[0] and self.slot_of[pid] >= 0

    def _shared_mask(self) -> np.ndarray:
        n = self._n_occupied
        pages = self.slot_page[:n]
        return ((self.slot_tenant[:n] == self.shared_part)
                & (self.page_refs[pages] == 0))

    def _has_shared_victim(self) -> bool:
        return bool(self._shared_mask().any())

    def _insert(self, pid: int, prefetched: bool) -> None:
        if not self._is_shared_page(pid):
            super()._insert(pid, prefetched)         # tenant-confined path
            return
        q = self.qos
        if q.shared_occupancy >= q.shared_quota:
            mask = self._shared_mask()
            if not mask.any():
                self.in_host[pid] = True             # pinned-full bypass
                return
            n = self._n_occupied
            stamps = np.where(mask, self.slot_t[:n], _STAMP_MAX)
            s = int(np.argmin(stamps))
            victim = int(self.slot_page[s])
            self.slot_of[victim] = EMPTY    # no host demotion: aged out
            self.stats.evictions += 1
            self._note_evict(victim)
            q.shared_occupancy -= 1
            self._age_out_shared(victim)
            self.in_host[pid] = False
            self.slot_page[s] = pid
            self.slot_of[pid] = s
            self.slot_t[s] = self._tick()
            self.slot_pf[s] = prefetched    # slot_tenant[s] stays shared
        else:
            assert self._n_occupied < self.hbm_capacity, \
                "quota invariant broken: HBM full under the shared quota"
            VectorizedPagedKVCache._insert(self, pid, prefetched)
            self.slot_tenant[self.slot_of[pid]] = self.shared_part
        q.shared_occupancy += 1

    def _touch_one(self, pid: int) -> str:
        if not self._is_shared_page(pid):
            return super()._touch_one(pid)
        self.prefetch_budget = self._shared_pf_budget
        return VectorizedPagedKVCache._touch_one(self, pid)


class DedupOracle(_DedupScalarPlacement, TenantedPagedKVCache):
    """Scalar COW shared-prefix dedup cache — the bit-exact reference
    twin for the vectorized / sharded / elastic dedup caches."""

    def __init__(self, hbm_pages: int = 1024, page_size: int = 16,
                 prefetch_budget: int = 4,
                 qos: Union[int, TenantQoSConfig] = 2,
                 namespace: Optional[TenantNamespace] = None,
                 max_bits: int = 62, device="cuda"):
        cfg, ns = self._dedup_normalize(qos, namespace, hbm_pages,
                                        prefetch_budget)
        self._setup_dedup(ns, prefetch_budget)
        TenantedPagedKVCache.__init__(
            self, hbm_pages=hbm_pages, page_size=page_size,
            prefetch_budget=prefetch_budget, qos=cfg, namespace=ns,
            max_bits=max_bits, device=device)


class DedupVectorizedPagedKVCache(_DedupVecPlacement,
                                  TenantedVectorizedPagedKVCache):
    """Vectorized COW shared-prefix dedup cache — int32 refcount array
    state, bit-exact against :class:`DedupOracle`."""

    def __init__(self, hbm_pages: int = 1024, page_size: int = 16,
                 prefetch_budget: int = 4, discover: str = "incremental",
                 qos: Union[int, TenantQoSConfig] = 2,
                 namespace: Optional[TenantNamespace] = None,
                 max_bits: int = 62, device="cuda"):
        cfg, ns = self._dedup_normalize(qos, namespace, hbm_pages,
                                        prefetch_budget)
        self._setup_dedup(ns, prefetch_budget)
        TenantedVectorizedPagedKVCache.__init__(
            self, hbm_pages=hbm_pages, page_size=page_size,
            prefetch_budget=prefetch_budget, discover=discover, qos=cfg,
            namespace=ns, max_bits=max_bits, device=device)


class DedupShardedPagedKVCache(_DedupVecPlacement,
                               TenantedShardedPagedKVCache):
    """Dedup composed with the mesh-sharded cache: shard ownership,
    tenant isolation, and the shared dedup namespace are three
    independent pure functions of the same prime value."""

    def __init__(self, hbm_pages: int = 1024, page_size: int = 16,
                 prefetch_budget: int = 4, n_shards: int = 2,
                 mesh="auto", stripes_per_shard: int = 8,
                 qos: Union[int, TenantQoSConfig] = 2,
                 namespace: Optional[TenantNamespace] = None,
                 max_bits: int = 62, device="cuda"):
        cfg, ns = self._dedup_normalize(qos, namespace, hbm_pages,
                                        prefetch_budget)
        self._setup_dedup(ns, prefetch_budget)
        TenantedShardedPagedKVCache.__init__(
            self, hbm_pages=hbm_pages, page_size=page_size,
            prefetch_budget=prefetch_budget, n_shards=n_shards, mesh=mesh,
            stripes_per_shard=stripes_per_shard, qos=cfg, namespace=ns,
            max_bits=max_bits, device=device)


class DedupElasticShardedPagedKVCache(_DedupVecPlacement,
                                      TenantedElasticShardedPagedKVCache):
    """Dedup composed with the ELASTIC sharded cache: resize /
    fail_shard / recover_shard operate on shard striping only, so no
    elastic event can move a page across the tenant or shared
    namespace boundaries."""

    def __init__(self, hbm_pages: int = 1024, page_size: int = 16,
                 prefetch_budget: int = 4, n_shards: int = 2,
                 mesh="auto", stripes_per_shard: int = 8,
                 qos: Union[int, TenantQoSConfig] = 2,
                 namespace: Optional[TenantNamespace] = None,
                 max_bits: int = 62, device="cuda"):
        cfg, ns = self._dedup_normalize(qos, namespace, hbm_pages,
                                        prefetch_budget)
        self._setup_dedup(ns, prefetch_budget)
        TenantedElasticShardedPagedKVCache.__init__(
            self, hbm_pages=hbm_pages, page_size=page_size,
            prefetch_budget=prefetch_budget, n_shards=n_shards, mesh=mesh,
            stripes_per_shard=stripes_per_shard, qos=cfg, namespace=ns,
            max_bits=max_bits, device=device)
