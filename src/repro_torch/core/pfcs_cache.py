"""PFCS multi-level cache front-end (PFCS §3, §5 Listing 1).

Combines the subsystems:

  * :class:`~repro_torch.core.assignment.PrimeAssigner`   — Algorithm 1
  * :class:`~repro_torch.core.composite.CompositeRegistry`— relationship store
  * :class:`~repro_torch.core.factorization.Factorizer`   — Algorithm 2
  * :class:`~repro_torch.core.prefetch.IntelligentPrefetcher` — §4.2

into a demand-access cache hierarchy with:

  * inclusive promote-on-hit / demote-on-evict level cascade,
  * relationship-aware replacement (victims are the coldest entries with
    the fewest live relationships — high-degree entries anchor prefetch
    value, so they are worth keeping),
  * deterministic relationship prefetch into a configurable level.

The class exposes the same ``access(key) -> (hit, level_name)`` contract
the simulator uses for the baselines, so Table 1 compares like for like.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, Hashable, Iterable, List, Optional, Sequence, Tuple

from .assignment import PrimeAssigner
from .composite import CompositeRegistry
from .factorization import Factorizer
from .prefetch import IntelligentPrefetcher
from .primes import CacheLevel, HierarchicalPrimeAllocator

__all__ = ["PFCSCache"]

DataID = Hashable


class _Level:
    """One cache level: recency-ordered resident set."""

    def __init__(self, name: str, capacity: int):
        self.name = name
        self.capacity = capacity
        self.entries: "OrderedDict[DataID, bool]" = OrderedDict()  # val=prefetched?

    def __contains__(self, k: DataID) -> bool:
        return k in self.entries

    def __len__(self) -> int:
        return len(self.entries)

    def touch(self, k: DataID) -> None:
        self.entries.move_to_end(k)

    def add(self, k: DataID, prefetched: bool = False) -> None:
        self.entries[k] = prefetched
        self.entries.move_to_end(k)

    def pop(self, k: DataID) -> Optional[bool]:
        return self.entries.pop(k, None)


class PFCSCache:
    """The paper's cache system, end to end."""

    def __init__(
        self,
        capacities: Sequence[Tuple[str, int]] = (("L1", 64), ("L2", 512), ("L3", 4096)),
        prefetch_budget: int = 8,
        prefetch_level: str = "auto",   # "auto": largest (last) level
        victim_window: int = 8,
        factorizer: Optional[Factorizer] = None,
        enable_prefetch: bool = True,
        prefetch_trigger: str = "miss",   # "miss" | "always"
    ):
        self.factorizer = factorizer or Factorizer()
        self.registry = CompositeRegistry(self.factorizer)
        self.assigner = PrimeAssigner(
            HierarchicalPrimeAllocator(), self.registry)
        self.prefetcher = IntelligentPrefetcher(self.assigner, prefetch_budget)
        self.levels: List[_Level] = [_Level(n, c) for n, c in capacities]
        self._level_idx = {lv.name: i for i, lv in enumerate(self.levels)}
        if prefetch_level == "auto":
            prefetch_level = self.levels[-1].name
        self.prefetch_level = prefetch_level
        self.victim_window = victim_window
        self.enable_prefetch = enable_prefetch
        self.prefetch_trigger = prefetch_trigger

        # stats hooks read by the simulator
        self.prefetches_issued = 0
        self.prefetch_targets: List[Tuple[DataID, DataID]] = []  # (trigger, target)

    # ------------------------------------------------------------------ #
    # relationship establishment (schema/catalog time)                    #
    # ------------------------------------------------------------------ #

    def register_relationship(self, keys: Iterable[DataID], kind: str = "generic",
                              weight: float = 1.0,
                              hint_level: int = CacheLevel.L3) -> None:
        """Establish a relationship: assign primes (Algorithm 1) and store
        the composite (§3.1).  ``hint_level`` picks the prime pool for
        first-seen elements; catalog-time registrations default to the
        large L3 range — Algorithm 1 promotes elements to hotter (smaller)
        primes once their observed access frequency warrants it."""
        primes = [self._prime_for(k, hint_level) for k in keys]
        uniq = set(primes)
        if len(uniq) >= 2:
            self.registry.register(uniq, kind=kind, weight=weight)

    def _prime_for(self, k: DataID, hint_level: int) -> int:
        p = self.assigner.prime_of(k)
        if p is None:
            p = self.assigner.assign(k, hint_level)
        return p

    # ------------------------------------------------------------------ #
    # demand path (Listing 1 lookup())                                    #
    # ------------------------------------------------------------------ #

    def access(self, key: DataID) -> Tuple[bool, Optional[str], bool]:
        """Demand access.

        Returns ``(hit, level_name, was_prefetched)`` where
        ``was_prefetched`` flags a hit on an entry a prefetch brought in
        that had not been demanded yet (prefetch usefulness accounting).
        """
        self.assigner.tracker.record(key)
        hit_level: Optional[str] = None
        was_prefetched = False
        for i, lv in enumerate(self.levels):
            if key in lv:
                hit_level = lv.name
                was_prefetched = bool(lv.entries[key])
                lv.entries[key] = False  # demanded now
                if i == 0:
                    lv.touch(key)
                else:  # promote to L1, cascading demotions
                    lv.pop(key)
                    self._insert(0, key, prefetched=False)
                break
        hit = hit_level is not None
        if not hit:
            self._insert(0, key, prefetched=False)
        # Prefetch throttle: 'miss' issues relationship prefetch only on
        # demand misses (standard prefetcher discipline — hits mean the
        # working set is already resident; re-prefetching on every hit
        # floods the backing store with soon-evicted lines).  'always' is
        # the paper's literal §4.2 wording; Table 1 reports 'miss'.
        if self.enable_prefetch and (
                self.prefetch_trigger == "always" or not hit
                or was_prefetched):
            self._prefetch_related(key)
        return hit, hit_level, was_prefetched

    # ------------------------------------------------------------------ #

    def _insert(self, level_idx: int, key: DataID, prefetched: bool) -> None:
        """Insert into level, demoting cascade victims down the hierarchy."""
        if level_idx >= len(self.levels):
            return  # fell out of the hierarchy
        lv = self.levels[level_idx]
        if key in lv:
            lv.touch(key)
            lv.entries[key] = lv.entries[key] and prefetched
            return
        lv.add(key, prefetched)
        while len(lv) > lv.capacity:
            victim, was_pf = self._select_victim(lv)
            self._insert(level_idx + 1, victim, was_pf)

    def _select_victim(self, lv: _Level) -> Tuple[DataID, bool]:
        """Relationship-aware replacement: among the ``victim_window``
        least-recent entries, evict the one with the lowest live
        relationship degree (ties -> older).  Pure LRU when window=1."""
        it = iter(lv.entries.items())
        window = []
        for _ in range(min(self.victim_window, len(lv.entries))):
            window.append(next(it))
        best_key, best_pf, best_deg = None, False, None
        for k, pf in window:
            p = self.assigner.prime_of(k)
            deg = self.registry.degree(p) if p is not None else 0
            if best_deg is None or deg < best_deg:
                best_key, best_pf, best_deg = k, pf, deg
        lv.pop(best_key)
        return best_key, best_pf

    def _prefetch_related(self, key: DataID) -> None:
        for dec in self.prefetcher.decide(key):
            if any(dec.target in lv for lv in self.levels):
                continue
            self.prefetches_issued += 1
            self.prefetch_targets.append((key, dec.target))
            self._insert(self._level_idx[self.prefetch_level], dec.target,
                         prefetched=True)

    # ------------------------------------------------------------------ #
    # introspection                                                       #
    # ------------------------------------------------------------------ #

    def resident_anywhere(self, key: DataID) -> bool:
        return any(key in lv for lv in self.levels)

    def level_of(self, key: DataID) -> Optional[str]:
        for lv in self.levels:
            if key in lv:
                return lv.name
        return None

    @property
    def factor_stats(self):
        return self.factorizer.stats
