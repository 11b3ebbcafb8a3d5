"""Intelligent prefetching engine (PFCS §4.2).

On access of element d with prime p, scan the composite registry for
multiples of p, factorize the hits, and prefetch the recovered related
elements.  Every prefetch target is *mathematically proven* related
(Theorem 1) — zero false-positive prefetch traffic.

Related-set computation is memoized against the registry version so the
scan + factorization cost is paid once per (prime, registry state), which
is also how the device path behaves (the divisibility kernel refreshes
candidate masks in batch when the registry changes, cf.
``repro_torch.kernels.ops.divisibility_scan``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Hashable, List, Optional, Set, Tuple

from .assignment import PrimeAssigner
from .composite import CompositeRegistry

__all__ = ["PrefetchDecision", "IntelligentPrefetcher"]

DataID = Hashable


@dataclass(frozen=True)
class PrefetchDecision:
    target: DataID
    trigger: DataID
    weight: float  # relationship weight x predicted access probability


class IntelligentPrefetcher:
    """Deterministic relationship-driven prefetcher."""

    def __init__(
        self,
        assigner: PrimeAssigner,
        budget_per_access: int = 8,
        min_weight: float = 0.0,
    ):
        self.assigner = assigner
        self.registry: CompositeRegistry = assigner.registry
        self.budget = budget_per_access
        self.min_weight = min_weight
        self._memo: Dict[int, Tuple[int, List[Tuple[DataID, float]]]] = {}

    def related_elements(self, d: DataID) -> List[Tuple[DataID, float]]:
        """All elements related to d with weights, via factorization."""
        p = self.assigner.prime_of(d)
        if p is None:
            return []
        ver = self.registry.version
        memo = self._memo.get(p)
        if memo is not None and memo[0] == ver:
            return memo[1]
        out: Dict[DataID, float] = {}
        for rel in self.registry.containing(p):
            for q in rel.primes:
                if q == p:
                    continue
                target = self.assigner.data_of(q)
                if target is not None:
                    out[target] = max(out.get(target, 0.0), rel.weight)
        ranked = sorted(out.items(), key=lambda kv: -kv[1])
        self._memo[p] = (ver, ranked)
        return ranked

    def decide(self, d: DataID) -> List[PrefetchDecision]:
        """Ranked, budget-limited prefetch decisions for an access to d."""
        decisions: List[PrefetchDecision] = []
        for target, w in self.related_elements(d):
            pw = w * (0.5 + 0.5 * self.assigner.tracker.predicted_frequency(target))
            if pw >= self.min_weight:
                decisions.append(PrefetchDecision(target, d, pw))
            if len(decisions) >= self.budget:
                break
        return decisions
