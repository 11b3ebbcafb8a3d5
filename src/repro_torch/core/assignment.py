"""Adaptive prime assignment (PFCS Algorithm 1).

Maps data elements to primes, level by level:

    1. GetCachedPrime(d, L)            — bidirectional map lookup
    2. PredictAccessFrequency(d, A)    — EWMA over the access history
    3. EstimateRelationshipCount(d, A) — registry degree + pattern hints
    4. ComputeFactorizationBudget(L)   — per-level time budget
    5. SelectOptimalPrimeRange(...)    — hot/low-degree data -> small primes
    6. AllocateFromPool(range, L)      — ascending allocation
    7. RecycleLRUPrimes(L, 0.1*pool)   — pool-exhaustion recycling

Recycling frees the primes of the least-recently-used elements *and*
purges their composites from the registry (otherwise factorization would
resurrect recycled identities — see composite.drop_prime).
"""

from __future__ import annotations

import itertools
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Dict, Hashable, List, Optional, Sequence, Tuple

from .composite import CompositeRegistry
from .primes import CacheLevel, HierarchicalPrimeAllocator

__all__ = ["AccessTracker", "PrimeAssigner", "AssignmentStats"]

DataID = Hashable


class AccessTracker:
    """EWMA access-frequency predictor + LRU ordering of elements."""

    def __init__(self, alpha: float = 0.25):
        self.alpha = alpha
        self._freq: Dict[DataID, float] = {}
        self._lru: "OrderedDict[DataID, int]" = OrderedDict()
        self._clock = 0

    def record(self, d: DataID) -> None:
        self._clock += 1
        f = self._freq.get(d, 0.0)
        self._freq[d] = f + self.alpha * (1.0 - f)
        if d in self._lru:
            self._lru.move_to_end(d)
        self._lru[d] = self._clock

    def decay_tick(self) -> None:
        """Periodic decay so stale elements cool down (called by the cache)."""
        for k in self._freq:
            self._freq[k] *= 1.0 - self.alpha * 0.1

    def predicted_frequency(self, d: DataID) -> float:
        return self._freq.get(d, 0.0)

    def lru_order(self) -> List[DataID]:
        return list(self._lru.keys())  # oldest first

    def forget(self, d: DataID) -> None:
        self._freq.pop(d, None)
        self._lru.pop(d, None)


@dataclass
class AssignmentStats:
    assigned: int = 0
    reused: int = 0
    recycle_events: int = 0
    recycled_primes: int = 0


class PrimeAssigner:
    """Algorithm 1 — adaptive prime assignment with predictive allocation."""

    # per-level factorization time budgets (seconds) — §3.2's
    # "progressively larger prime spaces, accepting higher factorization
    # costs": L1 must be near-instant, MEM can afford real work.
    LEVEL_BUDGETS = {
        CacheLevel.L1: 1e-6,
        CacheLevel.L2: 1e-4,
        CacheLevel.L3: 1e-3,
        CacheLevel.MEM: 5e-2,
    }

    def __init__(
        self,
        allocator: Optional[HierarchicalPrimeAllocator] = None,
        registry: Optional[CompositeRegistry] = None,
        tracker: Optional[AccessTracker] = None,
        recycle_fraction: float = 0.1,  # paper line 9: 0.1 * PoolSize[L]
    ):
        # NB: `x if x is not None else ...` — CompositeRegistry defines
        # __len__, so an *empty* registry is falsy and `or` would silently
        # replace it with a fresh one.
        self.allocator = allocator if allocator is not None else HierarchicalPrimeAllocator()
        self.registry = registry if registry is not None else CompositeRegistry()
        self.tracker = tracker if tracker is not None else AccessTracker()
        self.recycle_fraction = recycle_fraction
        self.stats = AssignmentStats()
        #: bumped whenever a data->prime binding is destroyed (release /
        #: recycling) — consumers caching prime-derived state (e.g. the
        #: vectorized cache's chain-composite chunks) key on this to
        #: notice that a cached prime may since have been recycled and
        #: reassigned to a different element
        self.epoch = 0
        # bidirectional maps, per level (Listing 1 data_to_prime/prime_to_data)
        self._data_to_prime: Dict[int, Dict[DataID, int]] = {l: {} for l in CacheLevel.ALL}
        self._prime_to_data: Dict[int, Dict[int, DataID]] = {l: {} for l in CacheLevel.ALL}

    # ------------------------------------------------------------------ #

    def get_cached_prime(self, d: DataID, level: int) -> Optional[int]:
        return self._data_to_prime[level].get(d)

    def prime_of(self, d: DataID) -> Optional[int]:
        """Prime of d at any level (hot levels searched first)."""
        for lvl in CacheLevel.ALL:
            p = self._data_to_prime[lvl].get(d)
            if p is not None:
                return p
        return None

    def data_of(self, p: int) -> Optional[DataID]:
        for lvl in CacheLevel.ALL:
            d = self._prime_to_data[lvl].get(p)
            if d is not None:
                return d
        return None

    def factorization_budget(self, level: int) -> float:
        return self.LEVEL_BUDGETS[level]

    def _select_range(self, freq: float, degree: int, level: int) -> int:
        """SelectOptimalPrimeRange: hot/high-degree data earns a *hotter*
        level's pool than its resident level, because its prime appears in
        many composites and must be cheap to factor out."""
        score = freq + 0.1 * min(degree, 10)
        if score > 0.75 and level > CacheLevel.L1:
            return level - 1  # promote one level hotter
        return level

    # ------------------------------------------------------------------ #

    def assign(self, d: DataID, level: int) -> int:
        """Algorithm 1 main entry: returns the prime for element d."""
        p = self.get_cached_prime(d, level)
        if p is not None:
            self.stats.reused += 1
            return p
        freq = self.tracker.predicted_frequency(d)
        degree = 0
        existing = self.prime_of(d)
        if existing is not None:
            degree = self.registry.degree(existing)
        rng_level = self._select_range(freq, degree, level)
        p = self.allocator.allocate(rng_level)
        if p is None and freq > 0.3:
            # pool exhaustion for genuinely *hot* data -> recycle 10% and
            # retry (paper lines 8-11). Cold data spills to a colder pool
            # instead — recycling an in-use hot prime for a cold element
            # would destroy more prefetch value than it creates.
            self._recycle(rng_level)
            p = self.allocator.allocate(rng_level)
        while p is None and rng_level < CacheLevel.MEM:
            rng_level += 1
            p = self.allocator.allocate(rng_level)
        assert p is not None, "MEM pool is unbounded; allocation cannot fail"
        self._data_to_prime[level][d] = p
        self._prime_to_data[level][p] = d
        self.stats.assigned += 1
        return p

    def assign_many(self, ds: Sequence[DataID], level: int) -> List[int]:
        """Batched :meth:`assign`, bit-identical to the per-element loop.

        Runs of *fresh, cold* elements (no prime at any level, zero
        predicted frequency — for those ``_select_range`` provably
        returns ``level`` and :meth:`assign` reduces to a pure pool
        allocation) are allocated in one :meth:`PrimePool.allocate_many`
        slice and bulk-inserted into the bidirectional maps.  Anything
        else — cached primes, warm elements, duplicates within the batch
        — flushes the pending run and falls back to scalar :meth:`assign`
        at its original position, so allocation order (and therefore
        every prime handed out) matches the scalar loop exactly.  This
        is the streamed-build fast path for million-element registries.
        """
        out: List[int] = []
        run: List[DataID] = []
        run_set: set = set()
        pool = self.allocator.pools[level]

        def flush() -> None:
            if not run:
                return
            ps = pool.allocate_many(len(run))
            d2p = self._data_to_prime[level]
            p2d = self._prime_to_data[level]
            for d, p in zip(run, ps):
                d2p[d] = p
                p2d[p] = d
            self.stats.assigned += len(ps)
            out.extend(ps)
            if len(ps) < len(run):
                # bounded pool ran dry mid-run: the scalar path would
                # spill the remainder level by level — defer to it
                for d in run[len(ps):]:
                    out.append(self.assign(d, level))
            run.clear()
            run_set.clear()

        for d in ds:
            if (d not in run_set
                    and self.tracker.predicted_frequency(d) == 0.0
                    and self.prime_of(d) is None):
                run.append(d)
                run_set.add(d)
            else:
                flush()
                out.append(self.assign(d, level))
        flush()
        return out

    def release(self, d: DataID, level: int) -> None:
        """Return d's prime at `level` to its pool and purge composites."""
        p = self._data_to_prime[level].pop(d, None)
        if p is None:
            return
        self.epoch += 1
        self._prime_to_data[level].pop(p, None)
        self.registry.drop_prime(p)
        self.allocator.free(self.allocator.level_of_prime(p), p)

    def _recycle(self, level: int) -> None:
        """RecycleLRUPrimes(L, 0.1 * PoolSize[L])."""
        pool = self.allocator.pool(level)
        want = max(1, int(self.recycle_fraction * max(pool.size, 1)))
        victims: List[Tuple[DataID, int]] = []
        mapped = self._data_to_prime[level]
        for d in self.tracker.lru_order():
            if d in mapped:
                victims.append((d, mapped[d]))
                if len(victims) >= want:
                    break
        if not victims:  # no tracked victims: recycle arbitrary mappings
            victims = list(itertools.islice(mapped.items(), want))
        for d, p in victims:
            self.release(d, level)
            self.tracker.forget(d)
        self.stats.recycle_events += 1
        self.stats.recycled_primes += len(victims)

    def migrate(self, d: DataID, src: int, dst: int) -> int:
        """Move an element between levels (cache promotion/demotion).

        The element gets a prime from the destination pool; its
        relationships are re-encoded so composites track level residency.
        """
        old = self._data_to_prime[src].get(d)
        related: List[frozenset] = []
        if old is not None:
            rels = self.registry.containing(old)
            related = [r.primes for r in rels]
        self.release(d, src)
        p = self.assign(d, dst)
        # re-register relationships with the new prime
        for primes in related:
            new_primes = {p if q == old else q for q in primes}
            if len(new_primes) >= 2:
                self.registry.register(new_primes)
        return p
