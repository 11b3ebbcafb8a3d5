"""Trace-driven multi-level cache simulation harness (PFCS §6).

Runs a trace through (a) baseline policy hierarchies (LRU/FIFO/2Q/ARC/
LIRS), (b) the semantic-prefetch system, and (c) PFCS, producing
:class:`~repro_torch.core.metrics.AccessStats` for the Table 1 / Fig. 2
benchmarks.

All hierarchies share the same level capacities and the same inclusive
promote-on-hit / demote-on-evict discipline so the only degrees of
freedom are replacement policy and relationship discovery — exactly the
comparison the paper draws.

``run_all_systems`` dispatches to the engine (:mod:`repro_torch.core.
engine`, one kernel launch per system on a card) by default, and
``fast_lru_hit_rate`` is the engine's LRU path; the scalar loops in this
module remain the cross-check oracle the engine is held against bit for
bit.
"""

from __future__ import annotations

from typing import Dict, Hashable, List, Optional, Sequence, Tuple

import numpy as np

from .metrics import AccessStats
from .pfcs_cache import PFCSCache
from .policies import CachePolicy, make_policy
from .semantic import SemanticRelationshipModel
from .traces import Trace

__all__ = [
    "DEFAULT_LEVELS", "simulate_baseline", "simulate_semantic",
    "simulate_pfcs", "run_all_systems", "fast_lru_hit_rate",
]

DEFAULT_LEVELS: Tuple[Tuple[str, int], ...] = (("L1", 64), ("L2", 512), ("L3", 4096))

_LEVEL_NAMES = ("L1", "L2", "L3", "MEM")


class _BaselineHierarchy:
    """Baseline system: ONE policy cache of total capacity + recency shadows.

    Composing stateful policies (ARC/LIRS) as literal stacked levels
    corrupts their internal recency/ghost state on promotion/demotion, so
    residency is decided by a single policy instance over the summed
    capacity — the policy's published behaviour.  Tier *attribution* for
    the latency/energy model uses policy-independent recency shadows:
    nested exact-LRU sets of sizes c1 < c1+c2 < ... ; a hit is served by
    the smallest shadow containing the key (the hierarchy keeps the most
    recent data closest).  Resident keys outside every shadow (prefetched
    or retained-cold, e.g. LIRS LIR blocks) are charged the MEM tier.
    """

    def __init__(self, policy: str, capacities: Sequence[Tuple[str, int]]):
        self.names = [name for name, _ in capacities]
        total = sum(cap for _, cap in capacities)
        self.policy = make_policy(policy, total)
        cum = 0
        self.shadows: List[Tuple[str, int, "OrderedDict"]] = []
        from collections import OrderedDict as _OD
        for name, cap in capacities:
            cum += cap
            self.shadows.append((name, cum, _OD()))
        self.prefetched: set = set()  # keys resident due to prefetch only

    def _touch_shadows(self, key) -> None:
        for _, cap, sh in self.shadows:
            if key in sh:
                sh.move_to_end(key)
            else:
                sh[key] = None
            while len(sh) > cap:
                sh.popitem(last=False)

    def _tier_of(self, key) -> str:
        for name, _, sh in self.shadows:
            if key in sh:
                return name
        return "MEM"

    def access(self, key) -> Tuple[bool, Optional[str], bool]:
        was_pf = key in self.prefetched
        self.prefetched.discard(key)
        resident = self.policy.contains(key)
        tier = self._tier_of(key) if resident else None
        self._touch_shadows(key)
        self.policy.access(key)  # updates policy state; admits on miss
        return resident, tier, was_pf

    def insert_prefetch(self, key, level_idx: int) -> None:
        if not self.policy.contains(key):
            self.policy.insert(key)
            self.prefetched.add(key)

    def contains(self, key) -> bool:
        return self.policy.contains(key)


def _finalize(stats: AccessStats, related: Dict[int, set],
              prefetch_pairs: List[Tuple[int, int]]) -> AccessStats:
    stats.prefetches_true = sum(
        1 for trig, tgt in prefetch_pairs if int(tgt) in related.get(int(trig), set())
    )
    return stats


# --------------------------------------------------------------------------- #
# baseline systems                                                            #
# --------------------------------------------------------------------------- #

def simulate_baseline(policy: str, trace: Trace,
                      capacities: Sequence[Tuple[str, int]] = DEFAULT_LEVELS
                      ) -> AccessStats:
    """Classic replacement policy, no relationship awareness."""
    h = _BaselineHierarchy(policy, capacities)
    stats = AccessStats(name=policy.upper())
    stats.hits_per_level = {n: 0 for n, _ in capacities}
    stats.hits_per_level["MEM"] = 0
    for key in trace.accesses:
        key = int(key)
        stats.demand_accesses += 1
        hit, lvl, _ = h.access(key)
        if hit:
            stats.hits_per_level[lvl] += 1
        else:
            stats.misses += 1
    return stats


def simulate_semantic(trace: Trace,
                      capacities: Sequence[Tuple[str, int]] = DEFAULT_LEVELS,
                      fp_rate: float = 0.12, fn_rate: float = 0.10,
                      prefetch_budget: int = 4, seed: int = 0,
                      prefetch_trigger: str = "miss") -> AccessStats:
    """LRU hierarchy + embedding-similarity prefetch (Table 1 row 4)."""
    h = _BaselineHierarchy("lru", capacities)
    model = SemanticRelationshipModel(
        trace.relationships, trace.n_keys, fp_rate=fp_rate, fn_rate=fn_rate,
        seed=seed)
    stats = AccessStats(name="SEMANTIC")
    stats.hits_per_level = {n: 0 for n, _ in capacities}
    stats.hits_per_level["MEM"] = 0
    related = trace.related_map()
    pf_level = max(0, len(capacities) - 2)
    pairs: List[Tuple[int, int]] = []
    for key in trace.accesses:
        key = int(key)
        stats.demand_accesses += 1
        hit, lvl, was_pf = h.access(key)
        if hit:
            stats.hits_per_level[lvl] += 1
            if was_pf:
                stats.prefetches_used += 1
        else:
            stats.misses += 1
        if prefetch_trigger != "always" and hit and not was_pf:
            continue
        for tgt in model.neighbors(key, budget=prefetch_budget):
            if not h.contains(tgt):
                h.insert_prefetch(tgt, pf_level)
                stats.prefetches_issued += 1
                stats.extra_backing_fetches += 1
                pairs.append((key, tgt))
    stats.embedding_ops = model.discovery_ops
    return _finalize(stats, related, pairs)


# --------------------------------------------------------------------------- #
# PFCS                                                                        #
# --------------------------------------------------------------------------- #

def simulate_pfcs(trace: Trace,
                  capacities: Sequence[Tuple[str, int]] = DEFAULT_LEVELS,
                  prefetch_budget: int = 4,
                  enable_prefetch: bool = True,
                  victim_window: int = 8,
                  prefetch_trigger: str = "miss") -> AccessStats:
    cache = PFCSCache(capacities, prefetch_budget=prefetch_budget,
                      enable_prefetch=enable_prefetch,
                      victim_window=victim_window,
                      prefetch_trigger=prefetch_trigger)
    for grp in trace.relationships:
        cache.register_relationship(grp, kind=trace.meta.get("kind", "generic"))

    stats = AccessStats(name="PFCS")
    stats.hits_per_level = {n: 0 for n, _ in capacities}
    related = trace.related_map()
    f0 = cache.factorizer.stats
    base = (f0.table_hits, f0.cache_hits, f0.trial_division, f0.pollard_rho)
    for key in trace.accesses:
        key = int(key)
        stats.demand_accesses += 1
        hit, lvl, was_pf = cache.access(key)
        if hit:
            stats.hits_per_level[lvl] += 1
            if was_pf:
                stats.prefetches_used += 1
        else:
            stats.misses += 1
    stats.prefetches_issued = cache.prefetches_issued
    stats.extra_backing_fetches = cache.prefetches_issued
    f1 = cache.factorizer.stats
    stats.factor_ops = {
        "table": f1.table_hits - base[0],
        "cache": f1.cache_hits - base[1],
        "trial": f1.trial_division - base[2],
        "rho": f1.pollard_rho - base[3],
    }
    return _finalize(stats, related, cache.prefetch_targets)


# --------------------------------------------------------------------------- #
# orchestration                                                               #
# --------------------------------------------------------------------------- #

def run_all_systems(trace: Trace,
                    capacities: Sequence[Tuple[str, int]] = DEFAULT_LEVELS,
                    systems: Sequence[str] = ("lru", "arc", "lirs", "semantic", "pfcs"),
                    seed: int = 0,
                    engine: str = "auto",
                    device="cuda") -> Dict[str, AccessStats]:
    """Run every requested system over one trace.

    ``engine`` selects the simulation backend:

      * ``"auto"`` (default) — the engine (:mod:`repro_torch.core.engine`)
        on ``device`` for every system it supports; the scalar reference
        loops otherwise.  The engine is bit-identical to the scalar
        oracles, so results do not depend on the backend — only
        wall-clock does.
      * ``"vectorized"`` — require the engine; raise for systems it
        cannot run (the semantic baseline consumes its noise RNG in
        miss order, which is inherently serial).
      * ``"scalar"`` — force the reference loops (the oracle path; no
        device is used).
    """
    if engine not in ("auto", "vectorized", "scalar"):
        raise ValueError(f"engine must be auto|vectorized|scalar, got {engine!r}")
    out: Dict[str, AccessStats] = {}
    vec_systems: List[str] = []
    for s in systems:
        if engine != "scalar":
            from .engine import VECTORIZED_SYSTEMS
            if s in VECTORIZED_SYSTEMS:
                vec_systems.append(s)
                continue
            if engine == "vectorized":
                raise ValueError(f"engine cannot simulate {s!r}")
        if s == "pfcs":
            out[s] = simulate_pfcs(trace, capacities)
        elif s == "semantic":
            out[s] = simulate_semantic(trace, capacities, seed=seed)
        else:
            out[s] = simulate_baseline(s, trace, capacities)
    if vec_systems:
        from .engine import simulate_trace as _vec_simulate
        for s in vec_systems:
            out[s] = _vec_simulate(trace, s, capacities, device=device)
    return out


# --------------------------------------------------------------------------- #
# exact LRU hit rate (the engine's LRU path)                                  #
# --------------------------------------------------------------------------- #

def fast_lru_hit_rate(accesses: np.ndarray, capacity: int,
                      device="cuda") -> float:
    """Exact LRU hit rate of one cache of ``capacity`` over ``accesses``,
    run by the engine's LRU scan on ``device``.

    Keys are taken as int32, as the reference takes them, and relabelled
    densely on the host (``np.unique``), which leaves LRU's hits as they
    are.  Only the key -1 is refused: the reference's scan marks an empty
    slot with it (``src/repro/core/simulator.py``), so there a -1 access
    "hits" every empty slot, a fault of the reference the port does not
    copy.  A trace past the scan's int32 stamps runs in segments: each
    opens with the cache's keys as the last left them, oldest first (into
    an empty cache, distinct keys: no hit, and the same LRU order), then
    takes as many accesses as the stamps allow."""
    import torch

    from repro_torch.device import resolve_device
    from repro_torch.kernels import engine
    from repro_torch.kernels.engine import baseline_scan

    from .engine.policies_vec import POLICY_TICKS

    dev = resolve_device(device)
    acc = np.asarray(accesses, dtype=np.int32).reshape(-1)
    if acc.size == 0:
        return 0.0
    if (acc == -1).any():
        raise ValueError(
            "fast_lru_hit_rate refuses the key -1: the reference's scan "
            "marks an empty slot with -1, so a -1 access hits every empty "
            "slot there")
    uniq, dense = np.unique(acc, return_inverse=True)
    dense = dense.astype(np.int32).reshape(-1)
    cap = int(capacity)
    longest = (engine.STAMP_SPACE - 1) // POLICY_TICKS
    if len(dense) > longest and cap >= longest:
        raise ValueError(f"capacity {cap} leaves no room in a "
                         f"{longest}-access segment")
    carried = np.zeros(0, dtype=np.int32)
    hits, at = 0, 0
    while at < len(dense):
        take = len(dense) - at if len(dense) <= longest else longest - cap
        seg = np.concatenate([carried, dense[at:at + take]])
        out = baseline_scan(torch.from_numpy(seg[None, :]).to(dev), "lru",
                            [cap], len(uniq))
        hits += int(out["hits"].sum())
        at += take
        pol = out["state"]["pol"]
        keys, stamps = pol["keys"][0].cpu().numpy(), pol["t"][0].cpu().numpy()
        held = keys != -1
        carried = keys[held][np.argsort(stamps[held], kind="stable")]
    return hits / len(acc)
