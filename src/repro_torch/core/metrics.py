"""Latency / power / speedup models and result containers (PFCS Table 1).

The container is CPU-only, so wall-clock numbers for a cache *hierarchy*
cannot be measured directly; hit rates and relationship accuracy are
measured exactly by simulation, while latency and energy are derived from
per-tier constants.  Constants follow standard published figures
(Hennessy & Patterson 6e [paper ref 1]; DRAM/IO energies from Horowitz,
ISSCC'14 keynote) and are explicit model parameters — change them here
and every benchmark re-derives.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional

__all__ = ["TierCosts", "DEFAULT_COSTS", "AccessStats", "derive_table1_row"]


@dataclass(frozen=True)
class TierCosts:
    """Per-access latency (ns) and energy (nJ) for each tier + overheads."""

    # hit service latencies, ns
    lat_l1: float = 1.0
    lat_l2: float = 4.0
    lat_l3: float = 20.0
    lat_mem: float = 100.0
    lat_backing: float = 10_000.0  # storage / remote node on full miss

    # energy per access, nJ
    en_l1: float = 0.5
    en_l2: float = 1.2
    en_l3: float = 5.0
    en_mem: float = 20.0
    en_backing: float = 1_000.0

    # PFCS factorization-stage costs, ns (paper §4.1 staging)
    lat_factor_table: float = 2.0      # precomputed SPF lookup
    lat_factor_cache: float = 3.0      # factorization-cache hit
    lat_factor_trial: float = 60.0     # vectorized trial division
    lat_factor_rho: float = 900.0      # Pollard rho tail
    en_factor: float = 0.05            # nJ per factorization op

    # semantic-cache embedding overhead, ns per discovery (paper §2.1:
    # "15-23% CPU utilization for embedding generation")
    lat_embedding: float = 450.0
    en_embedding: float = 8.0


DEFAULT_COSTS = TierCosts()


@dataclass
class AccessStats:
    """Counters produced by one simulation run."""

    name: str = ""
    demand_accesses: int = 0
    hits_per_level: Dict[str, int] = field(default_factory=dict)  # L1/L2/L3/MEM
    misses: int = 0  # served by backing store

    prefetches_issued: int = 0
    prefetches_used: int = 0      # prefetched entry later demanded while resident
    prefetches_true: int = 0      # prefetch target truly related (ground truth)

    factor_ops: Dict[str, int] = field(default_factory=dict)  # stage -> count
    embedding_ops: int = 0
    extra_backing_fetches: int = 0  # prefetch traffic to backing store

    # ------------------------------------------------------------------ #

    @property
    def hits(self) -> int:
        return sum(self.hits_per_level.values())

    @property
    def hit_rate(self) -> float:
        return self.hits / max(1, self.demand_accesses)

    @property
    def prefetch_precision(self) -> Optional[float]:
        """'Relationship accuracy' in Table 1: fraction of prefetch
        decisions whose target was truly related to the trigger."""
        if self.prefetches_issued == 0:
            return None
        return self.prefetches_true / self.prefetches_issued

    # -- derived latency / energy ----------------------------------------- #

    def total_latency_ns(self, costs: TierCosts = DEFAULT_COSTS) -> float:
        lat = {
            "L1": costs.lat_l1,
            "L2": costs.lat_l2,
            "L3": costs.lat_l3,
            "MEM": costs.lat_mem,
        }
        t = sum(self.hits_per_level.get(k, 0) * v for k, v in lat.items())
        t += self.misses * costs.lat_backing
        t += self.factor_ops.get("table", 0) * costs.lat_factor_table
        t += self.factor_ops.get("cache", 0) * costs.lat_factor_cache
        t += self.factor_ops.get("trial", 0) * costs.lat_factor_trial
        t += self.factor_ops.get("rho", 0) * costs.lat_factor_rho
        t += self.embedding_ops * costs.lat_embedding
        return t

    def avg_latency_ns(self, costs: TierCosts = DEFAULT_COSTS) -> float:
        return self.total_latency_ns(costs) / max(1, self.demand_accesses)

    def total_energy_nj(self, costs: TierCosts = DEFAULT_COSTS) -> float:
        en = {
            "L1": costs.en_l1,
            "L2": costs.en_l2,
            "L3": costs.en_l3,
            "MEM": costs.en_mem,
        }
        e = sum(self.hits_per_level.get(k, 0) * v for k, v in en.items())
        e += self.misses * costs.en_backing
        # Prefetch traffic: a *used* prefetch replaces the demand fetch that
        # would otherwise have happened (net-zero energy, off critical
        # path); only wasted prefetches burn extra backing-store energy.
        wasted = max(0, self.prefetches_issued - self.prefetches_used)
        e += wasted * costs.en_backing
        e += sum(self.factor_ops.values()) * costs.en_factor
        e += self.embedding_ops * costs.en_embedding
        return e

    def as_dict(self) -> Dict:
        return {
            "name": self.name,
            "demand_accesses": self.demand_accesses,
            "hit_rate": self.hit_rate,
            "hits_per_level": dict(self.hits_per_level),
            "misses": self.misses,
            "avg_latency_ns": self.avg_latency_ns(),
            "total_energy_nj": self.total_energy_nj(),
            "prefetch_precision": self.prefetch_precision,
            "prefetches_issued": self.prefetches_issued,
            "prefetches_used": self.prefetches_used,
        }


def derive_table1_row(stats: AccessStats, baseline: AccessStats,
                      costs: TierCosts = DEFAULT_COSTS) -> Dict:
    """Produce one Table-1-style row relative to a baseline system."""
    lat_s, lat_b = stats.avg_latency_ns(costs), baseline.avg_latency_ns(costs)
    en_s, en_b = stats.total_energy_nj(costs), baseline.total_energy_nj(costs)
    acc = stats.prefetch_precision
    return {
        "system": stats.name,
        "hit_rate_pct": 100.0 * stats.hit_rate,
        "latency_reduction_pct": 100.0 * (1.0 - lat_s / lat_b) if lat_b else 0.0,
        "power_reduction_pct": 100.0 * (1.0 - en_s / en_b) if en_b else 0.0,
        "relationship_accuracy_pct": None if acc is None else 100.0 * acc,
        "speedup": lat_b / lat_s if lat_s else float("inf"),
    }
