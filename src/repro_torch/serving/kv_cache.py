"""Paged KV cache with PFCS page management (the paper's technique as a
first-class serving feature).

Pages are fixed-size KV blocks (``page_size`` tokens) living in a tiered
store: HBM (hot, limited slots) and host memory (cold, large).  PFCS
assigns each page a prime; a request's page *chain* is encoded as
composites over consecutive page pairs, so

  * shared prefixes between requests are discovered deterministically —
    two chains sharing pages share primes, and ``gcd`` of their chain
    composites recovers exactly the shared pages (zero false sharing,
    Theorem 1);
  * on access to page p, the divisibility scan over the chain registry
    finds every chain through p; factorization yields the *successor*
    pages other requests needed next — those are prefetched host->HBM
    ahead of the decode step that will touch them.

The device-side block-table attention consuming these pages is standard
paged attention; here we manage placement.  Hit/miss/prefetch stats feed
the serving benchmark (case_serving).
"""

from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from repro_torch.core.assignment import PrimeAssigner
from repro_torch.core.composite import CompositeRegistry, encode_relationship
from repro_torch.core.factorization import Factorizer
from repro_torch.core.primes import CacheLevel, HierarchicalPrimeAllocator
from repro_torch.device import resolve_device
from repro_torch.obs.trace import EV_EVICT, EV_PREFETCH

__all__ = ["PagedKVCache", "PageStats", "PARITY_COUNTERS"]


#: the counters both cache implementations must agree on bit-for-bit
#: (tests/test_serving.py parity suite); ``registry_scans`` is excluded —
#: it counts *discovery work* and differs by design between the scalar
#: per-touch scan and the vectorized table-driven path.
PARITY_COUNTERS = ("hbm_hits", "host_hits", "misses", "prefetches",
                   "prefetch_hits", "evictions", "shared_prefix_pages")


@dataclass
class PageStats:
    hbm_hits: int = 0
    host_hits: int = 0          # page had to be fetched host -> HBM on demand
    misses: int = 0             # page did not exist (fresh allocation)
    prefetches: int = 0
    prefetch_hits: int = 0      # demanded while still resident from prefetch
    evictions: int = 0
    shared_prefix_pages: int = 0
    registry_scans: int = 0     # per-page §4.2 divisibility scans performed
    # cross-tenant dedup counters (serving/dedup.py; zero elsewhere —
    # kept OUT of PARITY_COUNTERS so per-tenant stats still sum to the
    # global parity tuple; the dedup fuzz pins them via DEDUP_COUNTERS)
    dedup_hits: int = 0         # admission reused a shared-namespace page
    dedup_promotions: int = 0   # private page content re-seen cross-tenant
    cow_copies: int = 0         # chains that diverged off a shared prefix

    @property
    def hbm_hit_rate(self) -> float:
        total = self.hbm_hits + self.host_hits + self.misses
        return self.hbm_hits / max(1, total)

    @property
    def prefetch_hit_rate(self) -> float:
        return self.prefetch_hits / max(1, self.prefetches)

    def parity_tuple(self) -> Tuple[int, ...]:
        """The counters the vectorized cache must reproduce exactly."""
        return tuple(getattr(self, f) for f in PARITY_COUNTERS)


class PagedKVCache:
    """Host-side page manager.  Page ids are globally unique ints."""

    def __init__(self, hbm_pages: int = 1024, page_size: int = 16,
                 prefetch_budget: int = 4, max_bits: int = 62,
                 device="cuda"):
        self._init_identity(hbm_pages, page_size, prefetch_budget, max_bits,
                            device)
        self.hbm: "OrderedDict[int, bool]" = OrderedDict()  # page -> prefetched
        self.host: Set[int] = set()

    def _init_identity(self, hbm_pages: int, page_size: int,
                       prefetch_budget: int, max_bits: int = 62,
                       device="cuda") -> None:
        """Page identity, prime assignment, and chain state — shared with
        the array-state implementation (``kv_cache_vec``), which replaces
        only the *placement* structures above.  ``device`` is where the
        discovery kernels run (placement state stays in numpy on the
        host).  ``max_bits > 63`` runs the registry in multi-limb wide
        mode (the discovery kernels take their limb twins); chain edges
        are pairwise either way, so the placement math is identical at
        every width."""
        self.device = resolve_device(device)
        self.page_size = page_size
        self.hbm_capacity = hbm_pages
        self.prefetch_budget = prefetch_budget
        self.factorizer = Factorizer()
        self.registry = CompositeRegistry(self.factorizer, max_bits=max_bits)
        self.assigner = self._make_assigner()
        self.chains: Dict[int, List[int]] = {}              # request -> pages
        self._content: Dict[Tuple, int] = {}  # content key -> page id (prefix share)
        self._next_page = 0
        self.stats = PageStats()
        #: observability sink (any object with ``emit``) — ``None`` by
        #: default; every hook below is ``if self.obs is not None``
        #: guarded, so the disabled path adds one attribute check and
        #: nothing else (inertness contract, tests/test_obs.py)
        self.obs = None
        #: every (source page, prefetched page) pair ever issued, in
        #: order — the zero-false-positive audit trail, and part of the
        #: scalar/vec parity contract (tests/test_serving.py,
        #: tests/test_tenancy.py)
        self.prefetch_log: List[Tuple[int, int]] = []

    def _make_assigner(self) -> PrimeAssigner:
        """Prime-assignment backend (overridden by the multi-tenant
        cache, which routes each page to its tenant's namespace —
        ``repro_torch.tenancy.qos``)."""
        return PrimeAssigner(HierarchicalPrimeAllocator(), self.registry)

    # ------------------------------------------------------------------ #
    # page identity & prefix sharing                                      #
    # ------------------------------------------------------------------ #

    def _page_for_tokens(self, token_block: Tuple[int, ...]) -> Tuple[int, bool]:
        """Content-addressed page id: identical prefixes share pages.

        The map is keyed on the FULL content key, not ``hash(key)``: a
        64-bit hash collision would silently alias two distinct token
        blocks to one page — a statistical false positive of exactly the
        kind Theorem 1 forbids (dict lookup already compares keys on
        hash collision, so equality here is exact)."""
        key = self._content_key(token_block)
        pid = self._content.get(key)
        if pid is not None:
            self.stats.shared_prefix_pages += 1
            return pid, True
        pid = self._next_page
        self._next_page += 1
        self._content[key] = pid
        self._assign_page(pid)
        return pid, False

    def _content_key(self, token_block: Tuple[int, ...]):
        """Content-addressing key.  The multi-tenant cache scopes it by
        tenant: identical token blocks from different tenants must NOT
        share a page (a shared page would be a cross-tenant
        relationship — the class of leak the namespace isolation theorem
        forbids, DESIGN.md §8)."""
        return token_block

    def _assign_page(self, pid: int) -> None:
        """Prime assignment for a fresh page (the multi-tenant cache
        binds the page to its tenant's namespace first)."""
        self.assigner.assign(pid, CacheLevel.L2)

    def register_request(self, req_id: int, tokens: Sequence[int]) -> List[int]:
        """Map a request's prompt onto pages; register chain relationships."""
        pages: List[int] = []
        blocks = [tuple(tokens[i:i + self.page_size])
                  for i in range(0, len(tokens), self.page_size)]
        prefix: Tuple[int, ...] = ()
        for blk in blocks:
            prefix = prefix + blk           # page identity includes prefix
            pid, _ = self._page_for_tokens(prefix)
            pages.append(pid)
        self.chains[req_id] = pages
        self._register_chain_edges(pages)
        return pages

    def _register_chain_edges(self, pages: Sequence[int]
                              ) -> List[Tuple[int, int]]:
        """Register consecutive page pairs (successor edges) as chain
        composites; returns the pairs whose composite is NEW to the
        registry, in registration order.  A pair whose composite is
        already live is skipped outright: re-registering would leave
        the §4.2 scan's discoveries unchanged (the registry keys
        relationships by composite value) while orphaning the old
        ``Relationship``, inflating prime degrees, and bumping the
        registry version — which would force the vectorized cache into
        needless table rebuilds.  The vectorized cache maintains its
        successor table incrementally from exactly the returned list."""
        edges: List[Tuple[int, int]] = []
        for a, b in zip(pages, pages[1:]):
            pa, pb = self.assigner.prime_of(a), self.assigner.prime_of(b)
            if pa is not None and pb is not None and pa != pb:
                fresh = any(
                    self.registry.relationship_of_composite(c) is None
                    for c in encode_relationship((pa, pb),
                                                 self.registry.max_bits))
                if fresh:
                    self.registry.register({pa, pb}, kind="chain")
                    edges.append((a, b))
        return edges

    # ------------------------------------------------------------------ #
    # placement                                                            #
    # ------------------------------------------------------------------ #

    def _note_evict(self, pid: int) -> None:
        """Trace one HBM eviction with tenant attribution (shared by the
        scalar and array placement paths — both call it exactly once per
        eviction, inside the insert that displaced the victim)."""
        if self.obs is not None:
            tenant = getattr(self, "tenant_of_page", lambda _p: -1)(pid)
            self.obs.emit(EV_EVICT, page=pid,
                          tenant=-1 if tenant is None else int(tenant))

    def _evict_to_host(self) -> None:
        while len(self.hbm) > self.hbm_capacity:
            pid, _ = self.hbm.popitem(last=False)
            self.host.add(pid)
            self.stats.evictions += 1
            self._note_evict(pid)

    def _insert_hbm(self, pid: int, prefetched: bool) -> None:
        self.host.discard(pid)
        self.hbm[pid] = prefetched
        self.hbm.move_to_end(pid)
        self._evict_to_host()

    def touch(self, req_id: int, page_idx: int) -> str:
        """Demand access to a request's page (decode step reads it).
        Returns the tier that served it ('hbm' | 'host' | 'new')."""
        pages = self.chains[req_id]
        pid = pages[page_idx]
        if pid in self.hbm:
            was_pf = self.hbm[pid]
            self.hbm[pid] = False
            self.hbm.move_to_end(pid)
            self.stats.hbm_hits += 1
            if was_pf:
                self.stats.prefetch_hits += 1
            tier = "hbm"
        elif pid in self.host:
            self.stats.host_hits += 1
            self._insert_hbm(pid, False)
            tier = "host"
        else:
            self.stats.misses += 1
            self._insert_hbm(pid, False)
            tier = "new"
        self._prefetch_successors(pid)
        return tier

    def touch_batch(self, items: Sequence[Tuple[int, int]]) -> List[str]:
        """Demand-access a whole decode batch: ``items`` is a sequence of
        ``(req_id, page_idx)`` pairs, processed in order.  The scalar
        implementation simply loops ``touch`` (one §4.2 registry scan per
        page); the vectorized cache overrides this with table-driven bulk
        discovery — the serving engine always goes through this entry
        point."""
        return [self.touch(r, i) for r, i in items]

    def _prefetch_allowed(self, src: int, tgt: int) -> bool:
        """Prefetch admission filter (hook).  The dedup cache restricts
        prefetch targets to the requester's tenant + the shared
        namespace; a filtered candidate is skipped WITHOUT consuming
        budget, so both twins walk the same candidate order."""
        return True

    def _can_insert(self, pid: int) -> bool:
        """Insertability filter (hook).  The dedup cache reports a page
        un-insertable when its shared-namespace quota is pinned full by
        referenced pages; such candidates are skipped without consuming
        prefetch budget."""
        return True

    def _prefetch_successors(self, pid: int) -> None:
        """§4.2 scan: chains through pid -> prefetch successor pages."""
        p = self.assigner.prime_of(pid)
        if p is None:
            return
        budget = self.prefetch_budget
        if budget <= 0:
            return
        self.stats.registry_scans += 1
        for rel in self.registry.containing(p):
            for q in rel.primes:
                if q == p:
                    continue
                succ = self.assigner.data_of(q)
                if succ is None or succ in self.hbm:
                    continue
                if not (self._prefetch_allowed(pid, succ)
                        and self._can_insert(succ)):
                    continue
                self._insert_hbm(succ, True)
                self.stats.prefetches += 1
                self.prefetch_log.append((pid, succ))
                if self.obs is not None:
                    self.obs.emit(EV_PREFETCH, page=pid, arg=succ)
                budget -= 1
                if budget <= 0:
                    return

    # ------------------------------------------------------------------ #
    # deterministic shared-prefix discovery                                #
    # ------------------------------------------------------------------ #

    def shared_prefix(self, req_a: int, req_b: int) -> List[int]:
        """Pages shared by two requests, recovered via gcd of the chain
        composites (exact — unique factorization).

        The gcd is exact Python-int arithmetic at ANY registry width;
        the factors are recovered by trial division against request a's
        own chain primes rather than a general factorization of ``g`` —
        a wide-mode (``max_bits > 63``) chain composite can exceed
        anything the budgeted :meth:`Factorizer.factorize` path fully
        factors, whereas dividing out a known pool is exact and
        width-agnostic (the same pool-reconstruction the vectorized
        ``gcd_batch_exact`` path uses)."""
        import math
        ca = self._chain_composite(req_a)
        cb = self._chain_composite(req_b)
        g = math.gcd(ca, cb)
        if g <= 1:
            return []
        out = []
        residual = g
        for pid in self.chains.get(req_a, []):
            p = self.assigner.prime_of(pid)
            if p and residual % p == 0:
                residual //= p
                out.append(pid)
        assert residual == 1, "gcd of chain composites must factor " \
            "entirely over the chain's own primes (Theorem 1)"
        return sorted(out)

    def _chain_composite(self, req_id: int) -> int:
        """Product of the chain's page primes, capped to arbitrary
        precision host int (device kernels use the chunked encoding)."""
        c = 1
        for pid in self.chains.get(req_id, []):
            p = self.assigner.prime_of(pid)
            if p:
                c *= p
        return c

    def release_request(self, req_id: int) -> None:
        self.chains.pop(req_id, None)
