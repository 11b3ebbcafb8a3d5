"""PFCS host core: prime assignment (Algorithm 1), composite encoding,
host factorization (Algorithm 2), intelligent prefetching (§4.2), the
multi-level cache front-end, every baseline policy the paper compares
against, the latency / energy model and the trace-driven evaluation
harness behind Table 1 / Fig. 2, carried over from ``repro.core``; plus
:func:`state_from_arrays`, which rebuilds the assignment and the
registry from plain arrays.  The engine (:mod:`repro_torch.core.engine`)
runs the harness's systems on the card."""

from .assignment import AccessTracker, PrimeAssigner
from .composite import CompositeRegistry, Relationship, encode_relationship
from .factorization import PRECOMPUTED_LIMIT, FactorizationStats, Factorizer
from .metrics import DEFAULT_COSTS, AccessStats, TierCosts, derive_table1_row
from .pfcs_cache import PFCSCache
from .policies import (ARCCachePolicy, CachePolicy, FIFOCachePolicy,
                       LIRSCachePolicy, LRUCachePolicy, TwoQCachePolicy,
                       make_policy)
from .prefetch import IntelligentPrefetcher, PrefetchDecision
from .primes import (CacheLevel, HierarchicalPrimeAllocator, PrimePool,
                     is_prime, segmented_sieve, sieve_primes, spf_table)
from .semantic import SemanticRelationshipModel
from .simulator import (DEFAULT_LEVELS, fast_lru_hit_rate, run_all_systems,
                        simulate_baseline, simulate_pfcs, simulate_semantic)
from .state import state_from_arrays
from .traces import (Trace, db_join_trace, graph_walk_trace, hft_trace,
                     ml_epoch_trace, scan_trace, zipf_trace)

__all__ = [
    "CacheLevel", "HierarchicalPrimeAllocator", "PrimePool", "is_prime",
    "segmented_sieve", "sieve_primes", "spf_table",
    "Factorizer", "FactorizationStats", "PRECOMPUTED_LIMIT",
    "CompositeRegistry", "Relationship", "encode_relationship",
    "AccessTracker", "PrimeAssigner",
    "IntelligentPrefetcher", "PrefetchDecision", "PFCSCache",
    "ARCCachePolicy", "CachePolicy", "FIFOCachePolicy", "LIRSCachePolicy",
    "LRUCachePolicy", "TwoQCachePolicy", "make_policy",
    "SemanticRelationshipModel",
    "AccessStats", "TierCosts", "DEFAULT_COSTS", "derive_table1_row",
    "Trace", "db_join_trace", "graph_walk_trace", "hft_trace",
    "ml_epoch_trace", "scan_trace", "zipf_trace",
    "DEFAULT_LEVELS", "fast_lru_hit_rate", "run_all_systems",
    "simulate_baseline", "simulate_pfcs", "simulate_semantic",
    "state_from_arrays",
]
