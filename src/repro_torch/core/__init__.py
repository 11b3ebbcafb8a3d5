"""PFCS host core: prime assignment (Algorithm 1), composite encoding,
host factorization (Algorithm 2), intelligent prefetching (§4.2), the
multi-level cache front-end and the synthetic traces, carried over from
``repro.core``; plus :func:`state_from_arrays`, which rebuilds the
assignment and the registry from plain arrays."""

from .assignment import AccessTracker, PrimeAssigner
from .composite import CompositeRegistry, Relationship, encode_relationship
from .factorization import PRECOMPUTED_LIMIT, FactorizationStats, Factorizer
from .pfcs_cache import PFCSCache
from .prefetch import IntelligentPrefetcher, PrefetchDecision
from .primes import (CacheLevel, HierarchicalPrimeAllocator, PrimePool,
                     is_prime, segmented_sieve, sieve_primes, spf_table)
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
    "Trace", "db_join_trace", "graph_walk_trace", "hft_trace",
    "ml_epoch_trace", "scan_trace", "zipf_trace",
    "state_from_arrays",
]
