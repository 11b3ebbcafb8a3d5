"""Benchmark cases of the port, after ``benchmarks/cases.py``.

:func:`case_scale` is the million-element wide-registry case: 1M data
elements through Algorithm 1's MEM pool, 10,000 chains 100 deep
registered as pairwise edges (about 990k composites) plus every 16th
chain as one whole-chain *group* relationship, whose 1024-bit chunks are
far beyond int64.  A sampled sub-universe is then verified against exact
Python-int arithmetic: the limb divisibility scan, the staged
factorization (zero false positives, Theorem 1) and the pairwise limb
gcd.  Every number it returns except the ``*_wall_s`` timings is a
deterministic counter, so the checked-in ``BENCH_case_scale.json`` of
the reference holds the port to the same registry and the same results.

The build and the verification are separate functions so that a caller
can keep the registry (``chip_smoke.py`` scans all of it on the card).
Times are host seconds (``time.perf_counter``); the kernel calls wait for
their results.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass
from typing import Dict, List

from repro_torch.core.assignment import PrimeAssigner
from repro_torch.core.composite import (CompositeRegistry,
                                        encode_relationship,
                                        n_limbs_for_bits, pack_limbs)
from repro_torch.core.primes import CacheLevel, HierarchicalPrimeAllocator
from repro_torch.device import resolve_device

__all__ = ["ScaleUniverse", "build_scale_universe", "verify_scale",
           "case_scale", "NEGATIVE_PRIMES", "SCALE_MAX_BITS", "GROUP_STRIDE"]

#: the registry's chunk width: 1024 bits, 32 limbs
SCALE_MAX_BITS = 1024
#: every GROUP_STRIDE-th chain is also registered as one group relationship
GROUP_STRIDE = 16

#: small primes the MEM pool never assigns (its primes start above 10**6):
#: query primes that must hit nothing
NEGATIVE_PRIMES = [2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37, 41, 43,
                   47, 53]


@dataclass
class ScaleUniverse:
    """The registry of :func:`case_scale` and its verification sample."""

    registry: CompositeRegistry
    assigner: PrimeAssigner
    prime_of: List[int]
    n_chains: int
    depth: int
    sample_chains: List[int]
    pool: List[int]          # member primes of the sampled chains
    sample: List[int]        # their edge composites and group chunks
    queries: List[int]       # every 7th pool prime + NEGATIVE_PRIMES
    assign_wall_s: float
    register_wall_s: float


def build_scale_universe(n_chains: int = 10_000, depth: int = 100,
                         n_verify_chains: int = 24) -> ScaleUniverse:
    """Assign ``n_chains * depth`` MEM primes, register each chain's
    pairwise edges and every ``GROUP_STRIDE``-th chain as a group, and
    pick the verification sample: half of the sampled chains carry a
    group relationship, half are edge-only."""
    registry = CompositeRegistry(max_bits=SCALE_MAX_BITS)
    assigner = PrimeAssigner(HierarchicalPrimeAllocator(), registry)
    t0 = time.perf_counter()
    prime_of = assigner.assign_many(range(n_chains * depth), CacheLevel.MEM)
    assign_wall = time.perf_counter() - t0

    t0 = time.perf_counter()
    for c in range(n_chains):
        row = prime_of[c * depth:(c + 1) * depth]
        registry.register_many(zip(row, row[1:]), kind="chain")
        if c % GROUP_STRIDE == 0:
            registry.register(row, kind="group")      # -> wide chunks
    register_wall = time.perf_counter() - t0

    half = n_verify_chains // 2
    sample_chains = (list(range(0, n_chains, GROUP_STRIDE)[:half])
                     + list(range(1, n_chains, GROUP_STRIDE)[:half]))
    pool = sorted({p for c in sample_chains
                   for p in prime_of[c * depth:(c + 1) * depth]})
    sample: List[int] = []
    for c in sample_chains:
        row = prime_of[c * depth:(c + 1) * depth]
        sample.extend(a * b for a, b in zip(row, row[1:]))
        if c % GROUP_STRIDE == 0:
            sample.extend(encode_relationship(row, SCALE_MAX_BITS))
    if not all(c in registry._by_composite for c in sample):
        raise AssertionError("sampled composites missing from the registry")
    return ScaleUniverse(registry, assigner, prime_of, n_chains, depth,
                         sample_chains, pool, sample,
                         pool[::7] + NEGATIVE_PRIMES, assign_wall,
                         register_wall)


def verify_scale(u: ScaleUniverse, device="cuda") -> Dict[str, object]:
    """The differential verification of :func:`case_scale` on ``device``
    (the limb scan, the staged factorization and the limb gcd, each
    against exact Python ints); raises on any disagreement, returns the
    case's report."""
    from repro_torch.kernels.ops import (divisibility_scan_limbs,
                                         factorize_batch_exact,
                                         gcd_batch_exact)

    dev = resolve_device(device)
    comps = u.registry.composites_list()
    wide = [c for c in comps if c.bit_length() > 63]
    if not wide:
        raise AssertionError("the case must hold composites beyond int64")
    L = n_limbs_for_bits(SCALE_MAX_BITS)
    sample, queries = u.sample, u.queries

    t0 = time.perf_counter()
    idx = divisibility_scan_limbs(pack_limbs(sample, L), queries, device=dev)
    scan_wall = time.perf_counter() - t0
    scan_hits = 0
    for j, q in enumerate(queries):
        want = [i for i, c in enumerate(sample) if c % q == 0]
        if list(idx[j]) != want:
            raise AssertionError(f"limb scan diverged at prime {q}")
        scan_hits += len(want)
    if any(len(idx[len(queries) - len(NEGATIVE_PRIMES) + k])
           for k in range(len(NEGATIVE_PRIMES))):
        raise AssertionError("a negative-control prime hit (Theorem 1)")

    t0 = time.perf_counter()
    factors, residual = factorize_batch_exact(sample, u.pool, device=dev)
    factor_wall = time.perf_counter() - t0
    false_pos = 0
    for c, fs, r in zip(sample, factors, residual):
        prod = 1
        for p in fs:
            false_pos += c % p != 0
            prod *= p
        if prod * int(r) != c or int(r) != 1:
            raise AssertionError("factor recovery must be exact, residual 1")
    if false_pos:
        raise AssertionError(f"{false_pos} false positives (Theorem 1)")

    # each sampled group chunk against its chain's first edge: the shared
    # primes rebuild the gcd exactly
    ga = [c for c in sample if c.bit_length() > 63]
    gb = [u.prime_of[c * u.depth] * u.prime_of[c * u.depth + 1]
          for c in u.sample_chains if c % GROUP_STRIDE == 0
          for _ in encode_relationship(
              u.prime_of[c * u.depth:(c + 1) * u.depth], SCALE_MAX_BITS)]
    gb = gb[:len(ga)]
    t0 = time.perf_counter()
    gs = gcd_batch_exact(ga, gb, u.pool, device=dev)
    gcd_wall = time.perf_counter() - t0
    if gs != [math.gcd(a, b) for a, b in zip(ga, gb)]:
        raise AssertionError("limb gcd diverged from exact host gcd")

    return dict(
        n_elements=len(u.prime_of), n_chains=u.n_chains,
        chain_depth=u.depth, registry_max_bits=SCALE_MAX_BITS, n_limbs=L,
        n_relationships=len(u.registry), n_composites=len(comps),
        n_wide_composites=len(wide),
        max_composite_bits=max(c.bit_length() for c in comps),
        max_prime=max(u.prime_of),
        verify=dict(
            n_verified=len(sample), n_query_primes=len(queries),
            scan_hits=scan_hits, factor_false_positives=false_pos,
            residual_all_one=True, gcd_pairs=len(gs),
            gcd_nontrivial=sum(1 for g in gs if g > 1)),
        assign_wall_s=u.assign_wall_s, register_wall_s=u.register_wall_s,
        scan_wall_s=scan_wall, factor_wall_s=factor_wall,
        gcd_wall_s=gcd_wall)


def case_scale(n_chains: int = 10_000, depth: int = 100,
               n_verify_chains: int = 24, device="cuda") -> Dict[str, object]:
    """``benchmarks/cases.py::case_scale`` on the port: defaults are the
    reference's published size (``n_verify_chains`` 24 is its smoke
    setting, the one ``BENCH_case_scale.json`` records)."""
    return verify_scale(build_scale_universe(n_chains, depth,
                                             n_verify_chains), device)
