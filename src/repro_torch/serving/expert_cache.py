"""PFCS expert-weight cache for MoE serving (kimi-k2 / deepseek-v2; port
of ``repro.serving.expert_cache``).

Experts are data elements; HBM holds a subset (hot experts), host memory
the rest.  Each decode step's router output is a set of active experts;
PFCS encodes *co-activation* — the top-k set of a token batch — as a
composite over expert primes.  The registry accumulates the co-activation
structure of the workload, and on activation of expert e the divisibility
scan + factorization recovers exactly which experts historically co-fire
with e; those are prefetched host->HBM ahead of the expert all-to-all.

Zero false positives (Theorem 1) means no wasted host->HBM transfers on
unrelated experts — the transfers are the scarce resource when cold
experts live off-chip.

This scalar implementation is the bit-exact oracle for
:class:`~repro_torch.serving.expert_cache_vec.VectorizedExpertCache`:
every ``EXPERT_PARITY_COUNTERS`` entry, every per-expert tier decision,
the HBM LRU order, and the prefetch log must match under any
interleaving of ``observe_routing`` / ``activate`` / ``activate_batch``
(``tests/test_torch_moe.py`` holds both to the reference).  It runs no
kernel; ``device`` is where the vectorized twin's ``discover="kernel"``
runs its kernels.
"""

from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass
from typing import Dict, Iterable, List, Sequence, Set, Tuple

from repro_torch.core.assignment import PrimeAssigner
from repro_torch.core.composite import (CompositeRegistry, Relationship,
                                        encode_relationship)
from repro_torch.core.factorization import Factorizer
from repro_torch.core.primes import CacheLevel, HierarchicalPrimeAllocator
from repro_torch.device import resolve_device

__all__ = ["ExpertCache", "ExpertCacheStats", "EXPERT_PARITY_COUNTERS"]


#: the counters both expert-cache implementations must agree on
#: bit-for-bit (tests/test_torch_moe.py parity suite);
#: ``registry_scans`` is excluded — it counts discovery *work* and
#: differs by design between the scalar per-activation scan and the
#: vectorized table-driven path.
EXPERT_PARITY_COUNTERS = ("hits", "misses", "prefetches", "prefetch_hits",
                          "evictions")


@dataclass
class ExpertCacheStats:
    hits: int = 0
    misses: int = 0             # demand host->HBM transfer (stalls the step)
    prefetches: int = 0
    prefetch_hits: int = 0
    evictions: int = 0
    registry_scans: int = 0     # per-activation §4.2 divisibility scans

    @property
    def hit_rate(self) -> float:
        return self.hits / max(1, self.hits + self.misses)

    @property
    def prefetch_precision(self) -> float:
        return self.prefetch_hits / max(1, self.prefetches)

    def parity_tuple(self) -> Tuple[int, ...]:
        """The counters the vectorized cache must reproduce exactly."""
        return tuple(getattr(self, f) for f in EXPERT_PARITY_COUNTERS)


class ExpertCache:
    def __init__(self, n_experts: int, hbm_slots: int,
                 prefetch_budget: int = 4, max_group: int = 8,
                 device="cuda"):
        self._init_identity(n_experts, hbm_slots, prefetch_budget, max_group,
                            device)
        self.hbm: "OrderedDict[int, bool]" = OrderedDict()

    def _init_identity(self, n_experts: int, hbm_slots: int,
                       prefetch_budget: int, max_group: int,
                       device="cuda") -> None:
        """Expert identity, prime assignment, and co-activation registry —
        shared with the array-state implementation
        (``expert_cache_vec``), which replaces only the placement
        structures and the discovery path.  ``device`` is where the
        discovery kernels run (placement state stays on the host)."""
        self.device = resolve_device(device)
        if n_experts < 1:
            raise ValueError("n_experts must be >= 1")
        if hbm_slots < 1:
            raise ValueError("hbm_slots must be >= 1")
        self.n_experts = n_experts
        self.hbm_slots = hbm_slots
        self.prefetch_budget = prefetch_budget
        self.max_group = max_group
        self.factorizer = Factorizer()
        self.registry = CompositeRegistry(self.factorizer)
        self.assigner = self._make_assigner()
        for e in range(n_experts):
            self._assign_expert(e)
        self.stats = ExpertCacheStats()
        self._seen_groups: Set[frozenset] = set()
        #: every (source expert, prefetched expert) pair ever issued, in
        #: order — the zero-false-positive audit trail (Theorem 1 tests)
        self.prefetch_log: List[Tuple[int, int]] = []

    def _make_assigner(self) -> PrimeAssigner:
        """Prime-assignment backend (overridden by the multi-tenant
        cache, which routes each expert to its tenant's namespace —
        ``repro_torch.tenancy.qos``)."""
        return PrimeAssigner(HierarchicalPrimeAllocator(), self.registry)

    def _assign_expert(self, e: int) -> None:
        """Prime assignment for one expert (the multi-tenant cache binds
        the expert to its tenant's namespace first)."""
        self.assigner.assign(e, CacheLevel.L2)

    # ------------------------------------------------------------------ #
    # co-activation registration                                          #
    # ------------------------------------------------------------------ #

    def observe_routing(self, expert_sets: Iterable[Sequence[int]]
                        ) -> List[Relationship]:
        """Feed router top-k sets (e.g. aux['router_top_idx'] rows).

        Each new co-activation group is registered ONCE as a composite;
        returns the relationships that are new to the registry, in
        registration order (the vectorized cache maintains its co-fire
        table incrementally from exactly this list).

        Dedup happens at the *composite* level, not just on the raw
        frozenset: the ``max_group`` cap means two distinct router sets
        can collapse to the same capped group, and re-registering its
        composite would orphan the old ``Relationship``, inflate prime
        degrees, and bump the registry version (forcing the vectorized
        cache into needless table rebuilds) — the same duplicate class
        the chain-edge path dedupes
        (``PagedKVCache._register_chain_edges``).
        """
        new: List[Relationship] = []
        for s in expert_sets:
            grp = frozenset(int(e) for e in s)
            if len(grp) < 2 or grp in self._seen_groups:
                continue
            self._seen_groups.add(grp)
            # cap group size so composites stay chunk-friendly
            grp_l = sorted(grp)[: self.max_group]
            primes = {self.assigner.prime_of(e) for e in grp_l}
            primes.discard(None)
            if len(primes) < 2:
                continue
            # ALL chunks must be fresh (stricter than the chain-edge
            # `any`, where pairs are always single-chunk): a capped
            # top-k group spans several chunks, and a single colliding
            # chunk would overwrite that composite's relationship
            # mapping — orphaning the earlier group and reordering the
            # §4.2 scan's discoveries, which is exactly the divergence
            # the differential fuzz surfaced
            fresh = all(
                self.registry.relationship_of_composite(c) is None
                for c in encode_relationship(primes))
            if fresh:
                new.append(self.registry.register(primes,
                                                  kind="coactivation"))
        return new

    def coactivated(self, e: int) -> Set[int]:
        """The factorization-recovered co-fire set of expert e (§4.2 scan
        + Algorithm 2 decode) — the deterministic ground truth every
        prefetch decision must fall inside (Theorem 1: zero false
        positives)."""
        p = self.assigner.prime_of(int(e))
        if p is None:
            return set()
        out: Set[int] = set()
        for rel in self.registry.containing(p):
            for q in rel.primes:
                if q == p:
                    continue
                other = self.assigner.data_of(q)
                if other is not None:
                    out.add(other)
        return out

    # ------------------------------------------------------------------ #
    # placement                                                           #
    # ------------------------------------------------------------------ #

    def _evict(self) -> None:
        while len(self.hbm) > self.hbm_slots:
            self.hbm.popitem(last=False)
            self.stats.evictions += 1

    def _insert(self, e: int, prefetched: bool) -> None:
        self.hbm[e] = prefetched
        self.hbm.move_to_end(e)
        self._evict()

    def activate(self, experts: Sequence[int]) -> Dict[int, str]:
        """A decode step needs these experts.  Returns per-expert tier.
        Misses model a demand host->HBM weight transfer."""
        tiers: Dict[int, str] = {}
        for e in experts:
            e = int(e)
            if e in self.hbm:
                was_pf = self.hbm[e]
                self.hbm[e] = False
                self.hbm.move_to_end(e)
                self.stats.hits += 1
                if was_pf:
                    self.stats.prefetch_hits += 1
                tiers[e] = "hbm"
            else:
                self.stats.misses += 1
                self._insert(e, False)
                tiers[e] = "host"
        for e in experts:
            self._prefetch_coactivated(int(e))
        return tiers

    def activate_batch(self, expert_sets: Sequence[Sequence[int]]
                       ) -> List[Dict[int, str]]:
        """Activate a whole decode step's router output (one top-k set
        per token batch / MoE layer), in order.  The scalar
        implementation simply loops ``activate`` (one §4.2 registry scan
        per activated expert); the vectorized cache overrides this with
        table-driven bulk discovery — the serving engine always goes
        through this entry point."""
        return [self.activate(s) for s in expert_sets]

    def _prefetch_coactivated(self, e: int) -> None:
        p = self.assigner.prime_of(e)
        if p is None:
            return
        budget = self.prefetch_budget
        if budget <= 0:
            # budget 0 disables prefetch outright (the LRU-expert
            # baseline); the scan below used to run anyway and leak one
            # prefetch per scanned relationship — regression-tested in
            # tests/test_serving_moe.py
            return
        self.stats.registry_scans += 1
        for rel in self.registry.containing(p):
            for q in rel.primes:
                if q == p:
                    continue
                other = self.assigner.data_of(q)
                if other is None or other in self.hbm:
                    continue
                self._insert(other, True)
                self.stats.prefetches += 1
                self.prefetch_log.append((e, other))
                budget -= 1
                if budget <= 0:
                    return
