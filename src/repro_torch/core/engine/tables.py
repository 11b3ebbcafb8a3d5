"""Static discovery tables for the vectorized PFCS engine.

PFCS relationships are registered at schema/catalog time (the database
knows its FK constraints, the trainer its batch composition) and are
immutable while a trace replays.  Everything the oracle's
``IntelligentPrefetcher.decide`` computes per access is therefore a pure
function of the key, and collapses to three arrays:

    targets : (K, budget) int32 — weight-ranked prefetch targets, -1 pad
    truth   : (K, budget) bool  — target truly related (ground truth)
    degree  : (K,) int32        — live relationship degree (victim policy)

Two discovery backends build the SAME target table:

  * ``discover="host"``   — replays ``IntelligentPrefetcher.decide`` per
    distinct accessed key.  Charges the host factorizer's stage mix
    (table/cache/trial/rho) exactly as the scalar simulation would, so
    engine ``AccessStats.factor_ops`` match the oracle's.
  * ``discover="kernel"`` — bulk path through the discovery kernels on
    ``device`` (:func:`repro_torch.kernels.ops.divisibility_scan` for the
    §4.2 registry scan, :func:`repro_torch.kernels.ops.factorize_batch`
    for Algorithm 2 stage 1 decode), the registry-refresh deployment;
    the decoded factorizations seed the host factorization cache and the
    stage mix reflects the kernel doing the work (trial for each first
    decode, cache thereafter — the rho tail is subsumed by the kernel).

Both backends produce bit-identical target ORDER: candidates are
deduplicated in registry (composite-array) order and ranked by weight
with a stable sort — the exact iteration order of the oracle
(``tests/test_torch_serving.py`` holds both against the reference).
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

from repro_torch.device import resolve_device

from ..pfcs_cache import PFCSCache
from ..traces import Trace

__all__ = ["PFCSTables", "pfcs_tables", "related_bulk", "make_pfcs_cache",
           "successor_table"]


class PFCSTables(NamedTuple):
    """Precomputed engine inputs for one (trace, PFCS config) pair."""

    targets: np.ndarray          # (K, budget) int32, -1 padded
    truth: np.ndarray            # (K, budget) bool
    degree: np.ndarray           # (K,) int32
    factor_ops: Dict[str, int]   # stage -> op count (latency model input)
    cache: PFCSCache             # the registered host cache (introspection)


def make_pfcs_cache(trace: Trace,
                    capacities: Sequence[Tuple[str, int]],
                    prefetch_budget: int = 4,
                    victim_window: int = 8,
                    enable_prefetch: bool = True,
                    prefetch_trigger: str = "miss") -> PFCSCache:
    """Host cache with the trace's relationships registered — the same
    schema-time setup ``simulate_pfcs`` performs (prime assignment order
    and therefore every composite is identical)."""
    cache = PFCSCache(capacities, prefetch_budget=prefetch_budget,
                      enable_prefetch=enable_prefetch,
                      victim_window=victim_window,
                      prefetch_trigger=prefetch_trigger)
    for grp in trace.relationships:
        cache.register_relationship(grp, kind=trace.meta.get("kind", "generic"))
    return cache


def related_bulk(cache: PFCSCache, keys: Sequence[int],
                 chunk: int = 1024,
                 device="cuda") -> Dict[int, List[Tuple[int, float]]]:
    """Bulk relationship discovery through the discovery kernels.

    For every key with an assigned prime: divisibility-scan the live
    composite registry (§4.2), decode each matching composite with the
    batched trial-division kernel, and return the weight-ranked related
    elements — the device twin of
    ``IntelligentPrefetcher.related_elements``, with identical ordering.
    ``device`` is where the kernels run.
    """
    from repro_torch.kernels.ops import divisibility_scan, factorize_batch

    dev = resolve_device(device)

    registry = cache.registry
    assigner = cache.assigner
    arr = registry.composites_array()
    keyed = [(int(k), p) for k in keys
             if (p := assigner.prime_of(int(k))) is not None]
    if arr.size == 0 or not keyed:
        return {}

    # kernel pass 1: registry divisibility scan, chunked over query primes
    primes = np.asarray([p for _, p in keyed], dtype=np.int64)
    cand: List[np.ndarray] = []
    for lo in range(0, len(primes), chunk):
        cand.extend(divisibility_scan(arr, primes[lo:lo + chunk],
                                      device=dev))

    # kernel pass 2: decode every candidate composite once
    needed = sorted({int(i) for idxs in cand for i in idxs})
    factors_of: Dict[int, set] = {}
    if needed:
        comps = arr[np.asarray(needed)]
        pool = registry.primes_array()
        facs, residual = factorize_batch(comps, pool, device=dev)
        assert np.all(residual == 1), "registry composite escaped its pool"
        stats = cache.factorizer.stats
        for c, fs in zip(comps, facs):
            factors_of[int(c)] = set(fs)
            cache.factorizer.cache.put(int(c), tuple(sorted(fs)))
        # stage accounting: the kernel's trial division decodes each
        # composite once; every further (prime, composite) incidence is a
        # factorization-cache hit (DESIGN.md §3)
        incidences = sum(len(idxs) for idxs in cand)
        stats.trial_division += len(needed)
        stats.cache_hits += incidences - len(needed)
        stats.total += incidences

    out: Dict[int, List[Tuple[int, float]]] = {}
    for (k, p), idxs in zip(keyed, cand):
        ranked: Dict[int, float] = {}
        seen = set()
        for i in idxs:
            c = int(arr[int(i)])
            assert p in factors_of[c], "divisibility hit must contain p"
            rel = registry.relationship_of_composite(c)
            if rel is None or rel.rel_id in seen:
                continue
            seen.add(rel.rel_id)
            for q in rel.primes:     # same frozenset order as the oracle
                if q == p:
                    continue
                tgt = assigner.data_of(q)
                if tgt is not None:
                    ranked[tgt] = max(ranked.get(tgt, 0.0), rel.weight)
        out[k] = sorted(ranked.items(), key=lambda kv: -kv[1])
    return out


def successor_table(registry, assigner, data_ids: Sequence[int],
                    discover: str = "host",
                    chunk: int = 1024,
                    device="cuda") -> Dict[int, List[int]]:
    """Bulk successor-discovery table for chain-style registries.

    The serving paged-KV cache's prefetch loop
    (``repro_torch.serving.kv_cache.PagedKVCache._prefetch_successors``)
    walks, per touched page, every relationship containing the page's
    prime and collects the *other* members as prefetch candidates.  The
    candidate ORDER is the oracle's exact iteration order — composite
    registry (registration) order, deduplicated by relationship, then
    ``rel.primes`` iteration — and the list is deliberately NOT
    deduplicated by target: the dynamic residency check at touch time
    is what skips repeats, so repeats must survive into the table.

    ``device`` places the kernel work of ``discover="kernel"`` (the
    host backend runs no kernel).  Returns ``{data_id: [successor
    data_id, ...]}`` for every id that has an assigned prime (ids
    without one discover nothing — exactly the oracle's early return).
    """
    dev = resolve_device(device)
    keyed = [(int(d), p) for d in data_ids
             if (p := assigner.prime_of(int(d))) is not None]
    if discover == "host":
        out: Dict[int, List[int]] = {}
        for d, p in keyed:
            row: List[int] = []
            for rel in registry.containing(p):
                for q in rel.primes:
                    if q == p:
                        continue
                    succ = assigner.data_of(q)
                    if succ is not None:
                        row.append(succ)
            out[d] = row
        return out
    if discover != "kernel":
        raise ValueError(f"discover must be 'host' or 'kernel', "
                         f"got {discover!r}")

    from repro_torch.kernels.ops import (divisibility_scan,
                                         divisibility_scan_limbs,
                                         factorize_batch_exact)

    wide = getattr(registry, "wide", False)
    arr = registry.composites_view() if wide else registry.composites_array()
    if arr.size == 0 or not keyed:
        return {d: [] for d, _ in keyed}

    # kernel pass 1: registry divisibility scan, chunked over query primes
    # (wide registries scan their limb matrix with the limb kernel — the
    # same mask)
    primes = np.asarray([p for _, p in keyed], dtype=np.int64)
    scan_input = registry.limbs_array() if wide else arr
    scan = divisibility_scan_limbs if wide else divisibility_scan
    cand: List[np.ndarray] = []
    for lo in range(0, len(primes), chunk):
        cand.extend(scan(scan_input, primes[lo:lo + chunk], device=dev))

    # kernel pass 2: decode every candidate composite once (Theorem 1
    # check: the decoded factors must contain the query prime)
    needed = sorted({int(i) for idxs in cand for i in idxs})
    factors_of: Dict[int, set] = {}
    if needed:
        comps = arr[np.asarray(needed)]
        facs, residual = factorize_batch_exact(comps, registry.primes_array(),
                                               device=dev)
        assert all(int(r) == 1 for r in residual), \
            "registry composite escaped its pool"
        for c, fs in zip(comps, facs):
            factors_of[int(c)] = set(fs)

    out = {}
    for (d, p), idxs in zip(keyed, cand):
        row = []
        seen: set = set()
        for i in idxs:                        # ascending == registry order
            c = int(arr[int(i)])
            assert p in factors_of[c], "divisibility hit must contain p"
            rel = registry.relationship_of_composite(c)
            if rel is None or rel.rel_id in seen:
                continue
            seen.add(rel.rel_id)
            for q in rel.primes:              # oracle's frozenset order
                if q == p:
                    continue
                succ = assigner.data_of(q)
                if succ is not None:
                    row.append(succ)
        out[d] = row
    return out


def pfcs_tables(trace: Trace,
                capacities: Sequence[Tuple[str, int]],
                prefetch_budget: int = 4,
                victim_window: int = 8,
                enable_prefetch: bool = True,
                prefetch_trigger: str = "miss",
                discover: str = "host",
                n_keys: Optional[int] = None,
                device="cuda") -> PFCSTables:
    """Build the engine's discovery tables for one trace; ``device`` is
    where ``discover="kernel"`` runs its kernels."""
    dev = resolve_device(device)
    cache = make_pfcs_cache(trace, capacities, prefetch_budget,
                            victim_window, enable_prefetch, prefetch_trigger)
    K = int(n_keys if n_keys is not None else
            max(trace.n_keys, int(trace.accesses.max(initial=0)) + 1))
    B = max(1, int(prefetch_budget))
    targets = np.full((K, B), -1, dtype=np.int32)
    truth = np.zeros((K, B), dtype=bool)
    related = trace.related_map()

    f = cache.factorizer.stats
    base = (f.table_hits, f.cache_hits, f.trial_division, f.pollard_rho)

    if enable_prefetch:
        # first-occurrence order: the host factorizer's cofactor cache is
        # order-sensitive when composites share cofactors, and the scalar
        # oracle pays each key's discovery cost at its FIRST access
        acc = np.asarray(trace.accesses)
        _, first = np.unique(acc, return_index=True)
        distinct = [int(k) for k in acc[np.sort(first)]]
        if discover == "kernel":
            ranked_map = related_bulk(cache, distinct, device=dev)
            per_key = {k: [t for t, _ in ranked_map.get(k, [])][:B]
                       for k in distinct}
        elif discover == "host":
            per_key = {k: [d.target for d in cache.prefetcher.decide(k)][:B]
                       for k in distinct}
        else:
            raise ValueError(f"discover must be 'host' or 'kernel', "
                             f"got {discover!r}")
        for k, tgts in per_key.items():
            rel_k = related.get(k, ())
            for j, tgt in enumerate(tgts):
                targets[k, j] = int(tgt)
                truth[k, j] = int(tgt) in rel_k

    degree = np.zeros((K,), dtype=np.int32)
    for k in range(K):
        p = cache.assigner.prime_of(k)
        if p is not None:
            degree[k] = cache.registry.degree(p)

    f = cache.factorizer.stats
    factor_ops = {
        "table": f.table_hits - base[0],
        "cache": f.cache_hits - base[1],
        "trial": f.trial_division - base[2],
        "rho": f.pollard_rho - base[3],
    }
    return PFCSTables(targets, truth, degree, factor_ops, cache)
