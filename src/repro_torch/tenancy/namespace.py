"""Coprime tenant namespaces: disjoint prime-value blocks per tenant (port
of ``repro.tenancy.namespace``; numpy only, no kernel).

Every tenant draws its primes from its own family of contiguous value
blocks, dealt round-robin by the shared striping partitioner
(``repro_torch.sharding.stripes.BlockStripes`` — the same machinery the
mesh-sharded discovery layer stripes shards with, DESIGN.md §6.1/§8.1).
Disjoint blocks mean disjoint prime sets, and by unique factorization
the gcd of composites built from disjoint prime sets is identically 1:

    **Isolation theorem** (DESIGN.md §8.2).  For tenants s != t, every
    composite of tenant s is coprime to every composite of tenant t,
    and no live composite factors across two tenants' blocks.  Hence a
    §4.2 divisibility scan or gcd discovery issued with tenant t's
    primes can only ever surface tenant t's relationships — cross-tenant
    prefetch traffic is impossible by construction, not by policy.

``TenantNamespace.check_isolation`` is that theorem as an
executable check: it re-*factorizes* every live registry composite
(Algorithm 2, not a reverse index) and verifies the recovered member
primes map into a single tenant's block family; the optional pairwise
mode additionally verifies ``gcd == 1`` across every cross-tenant
composite pair.

Entry points: :class:`TenantNamespace` (block layout, vectorized
membership, the isolation checker) and :class:`TenantAssigner`
(per-tenant Algorithm-1 assigners over one shared registry, with
per-namespace prime recycling).  ``check_isolation`` decodes through the
registry's host factorizer and compares pairs with ``math.gcd``, as the
reference does.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass, field
from typing import Dict, Hashable, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.assignment import PrimeAssigner
from repro_torch.core.primes import (HierarchicalPrimeAllocator,
                                     LEVEL_PRIME_RANGES, PrimePool,
                                     segmented_sieve)
from repro_torch.sharding.stripes import BlockStripes

__all__ = ["TenantNamespace", "TenantAssigner", "StripedPrimePool",
           "IsolationReport"]


@functools.lru_cache(maxsize=256)
def _sieve_cached(lo: int, hi: int) -> Tuple[int, ...]:
    """Memoized sieve segment — tenant pools re-filter the same level
    ranges and lazy MEM segments per tenant and per cache construction;
    sieving each segment once per process keeps namespace construction
    at numpy-filter cost."""
    return tuple(int(p) for p in segmented_sieve(lo, hi))


@dataclass
class StripedPrimePool(PrimePool):
    """A ``repro_torch.core.primes.PrimePool`` restricted to the blocks
    one tenant owns: sieved primes are filtered through the namespace's
    vectorized ownership test, so two tenants' pools over the SAME level
    range can never hand out the same prime.  Allocation order within
    the tenant stays ascending (Algorithm 1's cheapest-factorization
    discipline), it just skips foreign blocks."""

    stripes: Optional[BlockStripes] = None
    part: int = 0

    def _owned(self, primes: Sequence[int]) -> List[int]:
        ps = np.asarray(primes, dtype=np.int64)
        if ps.size == 0:
            return []
        return [int(p) for p in ps[self.stripes.owners(ps) == self.part]]

    def __post_init__(self) -> None:
        assert self.stripes is not None
        if self.hi is not None:
            self._primes = self._owned(_sieve_cached(self.lo, self.hi + 1))
        else:
            self._lazy_cursor = self.lo
            self._extend(self.initial_capacity)

    def _extend(self, at_least: int) -> None:
        if self.hi is not None:
            return
        got = 0
        seg = 1 << 16
        while got < at_least:
            new = self._owned(_sieve_cached(self._lazy_cursor,
                                            self._lazy_cursor + seg))
            self._primes.extend(new)
            got += len(new)
            self._lazy_cursor += seg
            seg = min(seg * 2, 1 << 22)


@dataclass
class IsolationReport:
    """Result of ``TenantNamespace.check_isolation``."""

    ok: bool = True
    n_relationships: int = 0
    n_composites: int = 0
    per_tenant: List[int] = field(default_factory=list)
    #: (composite, tenant ids its factors span) for every violation
    violations: List[Tuple[int, Tuple[int, ...]]] = field(
        default_factory=list)
    #: cross-tenant composite pairs gcd-verified coprime (pairwise mode)
    coprime_pairs_checked: int = 0
    #: composites touching the shared dedup namespace (``shared=True``
    #: namespaces only): wholly-shared chain edges plus mixed
    #: shared↔private COW-boundary edges — legal by construction,
    #: excluded from the pairwise coprimality sweep (DESIGN.md §12)
    n_shared: int = 0


class TenantNamespace:
    """Disjoint contiguous prime-value blocks per tenant.

    Ownership is pure O(1) arithmetic on the prime value
    (``BlockStripes``), so membership tests
    vectorize over whole registries and any holder of a prime can
    classify it without coordination.  ``n_tenants == 1`` degenerates to
    the untenanted prime space: tenant 0 owns every block, and a
    1-tenant namespace allocator is value-for-value identical to the
    global ``HierarchicalPrimeAllocator``.
    """

    def __init__(self, n_tenants: int, stripes_per_tenant: int = 8,
                 ranges: Optional[Dict[int, Tuple[int, Optional[int]]]] = None,
                 mem_initial_capacity: int = 1024, shared: bool = False):
        if n_tenants < 1:
            raise ValueError("n_tenants must be >= 1")
        self.ranges = dict(ranges or LEVEL_PRIME_RANGES)
        # shared=True reserves ONE extra block family — the dedup
        # namespace (DESIGN.md §12): part id ``n_tenants`` in the same
        # BlockStripes deal, so shared blocks are disjoint from (hence
        # shared primes coprime to) every tenant's blocks by the same
        # construction that separates tenants from each other.
        n_parts = n_tenants + 1 if shared else n_tenants
        self.stripes = BlockStripes(n_parts, self.ranges,
                                    stripes_per_part=stripes_per_tenant)
        self.n_tenants = int(n_tenants)
        self.n_parts = self.stripes.n_parts
        self.shared_part: Optional[int] = n_tenants if shared else None
        self.mem_initial_capacity = mem_initial_capacity

    # ------------------------------------------------------------------ #
    # membership                                                          #
    # ------------------------------------------------------------------ #

    def tenant_of_value(self, p: int) -> int:
        """Tenant owning prime value ``p`` — pure function, O(1)."""
        return self.stripes.owner(p)

    def tenant_of_values(self, values: Sequence[int]) -> np.ndarray:
        """Vectorized membership: int array of values -> int32 tenant
        ids (one arithmetic pass per cache level, no per-value loop)."""
        return self.stripes.owners(values)

    def is_member(self, tenant: int, values: Sequence[int]) -> np.ndarray:
        """Bool mask: which of ``values`` fall inside ``tenant``'s
        blocks."""
        return self.tenant_of_values(values) == int(tenant)

    # ------------------------------------------------------------------ #
    # allocation                                                          #
    # ------------------------------------------------------------------ #

    def make_allocator(self, tenant: int) -> HierarchicalPrimeAllocator:
        """A level-pool façade whose every pool is restricted to the
        tenant's blocks (disjoint from every other tenant's by
        construction).  In a ``shared=True`` namespace, part id
        ``shared_part`` (== ``n_tenants``) is a valid target too — the
        dedup namespace's own allocator."""
        if not 0 <= int(tenant) < self.n_parts:
            raise ValueError(f"tenant {tenant} out of range "
                             f"[0, {self.n_parts})")
        alloc = HierarchicalPrimeAllocator.__new__(HierarchicalPrimeAllocator)
        alloc.pools = {
            lvl: StripedPrimePool(level=lvl, lo=lo, hi=hi,
                                  initial_capacity=self.mem_initial_capacity,
                                  stripes=self.stripes, part=int(tenant))
            for lvl, (lo, hi) in self.ranges.items()}
        return alloc

    # ------------------------------------------------------------------ #
    # the isolation theorem, as an executable check                       #
    # ------------------------------------------------------------------ #

    def check_isolation(self, registry,
                        pairwise_gcd: bool = False) -> IsolationReport:
        """Prove every live composite factors inside ONE tenant's block
        family.

        Each composite is re-factorized through the registry's
        factorizer (``registry.decode`` — Algorithm 2, the same decode
        path discovery uses), and the recovered primes are mapped
        through the vectorized membership test.  ``pairwise_gcd=True``
        additionally gcd-checks every cross-tenant composite pair
        against 1 — the coprimality statement of the theorem verified
        literally (quadratic; meant for tests and smoke benchmarks).

        In a ``shared=True`` namespace the theorem statement weakens
        exactly as DESIGN.md §12 proves it must: shared-part primes are
        *deliberately* common, so a composite is a violation only when
        its factors span two distinct **non-shared** tenants.  Wholly-
        shared and mixed shared↔private composites are counted in
        ``n_shared`` and excluded from the pairwise sweep (two tenants
        diverging off the same shared page legitimately share that
        page's prime across their COW-boundary edges).
        """
        arr = registry.composites_view()
        rep = IsolationReport(per_tenant=[0] * self.n_tenants,
                              n_relationships=len(registry),
                              n_composites=int(arr.size))
        tenant_of_comp: List[int] = []
        for c in arr:
            primes = registry.decode(int(c))
            parts = self.tenant_of_values(np.asarray(primes, dtype=np.int64))
            if self.shared_part is not None:
                shared_mask = parts == self.shared_part
                has_shared = bool(shared_mask.any())
                ts = np.unique(parts[~shared_mask])
            else:
                has_shared = False
                ts = np.unique(parts)
            if ts.size == 0:              # wholly shared-namespace edge
                rep.n_shared += 1
                tenant_of_comp.append(-2)
            elif ts.size == 1:
                t = int(ts[0])
                rep.per_tenant[t] += 1
                if has_shared:            # mixed COW-boundary edge
                    rep.n_shared += 1
                    tenant_of_comp.append(-2)
                else:
                    tenant_of_comp.append(t)
            else:
                rep.ok = False
                rep.violations.append((int(c), tuple(int(t) for t in ts)))
                tenant_of_comp.append(-1)
        if pairwise_gcd:
            for i in range(arr.size):
                for j in range(i + 1, arr.size):
                    if (tenant_of_comp[i] == tenant_of_comp[j]
                            or tenant_of_comp[i] < 0
                            or tenant_of_comp[j] < 0):
                        continue
                    rep.coprime_pairs_checked += 1
                    if math.gcd(int(arr[i]), int(arr[j])) != 1:
                        rep.ok = False
                        rep.violations.append(
                            (int(arr[i]),
                             (tenant_of_comp[i], tenant_of_comp[j])))
        return rep

    def assert_isolated(self, registry) -> None:
        """Raise ``AssertionError`` with the violation list if any live
        composite spans tenants (test/fuzz invariant hook)."""
        rep = self.check_isolation(registry)
        assert rep.ok, f"tenant isolation violated: {rep.violations}"

    def describe(self) -> str:
        return (f"TenantNamespace(n_tenants={self.n_tenants}, "
                f"{self.stripes.describe()})")


class TenantAssigner:
    """Per-tenant Algorithm-1 assigners over ONE shared registry.

    Each tenant gets its own ``PrimeAssigner`` — its own
    namespace-restricted pools and its own access tracker — so pool-exhaustion recycling is *per namespace*: a
    noisy tenant churning through its prime blocks recycles only its own
    LRU elements and can never stall (or purge composites of) another
    tenant.  The registry is shared, so the §4.2 divisibility scan, the
    successor tables, and the sharded discovery path all run unchanged
    over the union — isolation comes from the namespace math, not from
    splitting the registry.

    The façade speaks the ``PrimeAssigner`` vocabulary the serving
    caches use (``prime_of`` / ``data_of`` / ``assign`` / ``release``);
    routing is by the data element's recorded tenant binding on the data
    side and by pure value-ownership on the prime side.
    """

    def __init__(self, namespace: TenantNamespace, registry,
                 recycle_fraction: float = 0.1):
        self.namespace = namespace
        self.registry = registry
        # one assigner per part — includes the shared dedup part when
        # the namespace was built with shared=True (DESIGN.md §12)
        self.per_tenant: List[PrimeAssigner] = [
            PrimeAssigner(namespace.make_allocator(t), registry,
                          recycle_fraction=recycle_fraction)
            for t in range(namespace.n_parts)]
        self._tenant_of_data: Dict[Hashable, int] = {}

    # -- tenant binding ----------------------------------------------------

    def bind(self, d: Hashable, tenant: int) -> None:
        self._tenant_of_data[d] = int(tenant)

    def tenant_of(self, d: Hashable) -> Optional[int]:
        return self._tenant_of_data.get(d)

    # -- PrimeAssigner vocabulary (routed) ---------------------------------

    @property
    def epoch(self) -> int:
        """Aggregate release epoch (see ``PrimeAssigner.epoch``)."""
        return sum(a.epoch for a in self.per_tenant)

    def assign(self, d: Hashable, level: int) -> int:
        t = self._tenant_of_data.get(d)
        if t is None:
            raise KeyError(f"data element {d!r} has no tenant binding "
                           f"(call bind(d, tenant) first)")
        return self.per_tenant[t].assign(d, level)

    def prime_of(self, d: Hashable) -> Optional[int]:
        t = self._tenant_of_data.get(d)
        return None if t is None else self.per_tenant[t].prime_of(d)

    def data_of(self, p: int) -> Optional[Hashable]:
        # prime side routes by VALUE ownership — pure namespace math
        return self.per_tenant[self.namespace.tenant_of_value(p)].data_of(p)

    def release(self, d: Hashable, level: int) -> None:
        t = self._tenant_of_data.get(d)
        if t is not None:
            self.per_tenant[t].release(d, level)
