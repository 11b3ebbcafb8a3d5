"""Multi-stage factorization engine (PFCS Algorithm 2).

Stage 0: precomputed SPF table for composites <= PRECOMPUTED_LIMIT (O(1)).
Stage 1: factorization cache lookup (LRU).
Stage 2: time-budgeted trial division with small primes (<= 70% of budget).
Stage 3: Pollard's rho (Brent variant) for the remaining cofactor.

The engine records per-stage counters so benchmarks can attribute latency
(the paper's Table 1 latency model charges each stage differently).

Host path uses exact Python integers (arbitrary precision); the batched
device path (int32/int64 tensors, CUDA kernels) lives in
``repro_torch.kernels``.
"""

from __future__ import annotations

import math
import time
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .primes import is_prime, sieve_primes, spf_table

__all__ = ["FactorizationStats", "Factorizer", "PRECOMPUTED_LIMIT"]

# Paper Algorithm 2 line 1: composites <= 10**6 hit the precomputed table.
PRECOMPUTED_LIMIT = 1_000_000


@dataclass
class FactorizationStats:
    """Per-stage hit counters (drives the latency/power models)."""

    table_hits: int = 0
    cache_hits: int = 0
    trial_division: int = 0
    pollard_rho: int = 0
    budget_exceeded: int = 0
    total: int = 0

    def as_dict(self) -> Dict[str, int]:
        return dict(
            table_hits=self.table_hits,
            cache_hits=self.cache_hits,
            trial_division=self.trial_division,
            pollard_rho=self.pollard_rho,
            budget_exceeded=self.budget_exceeded,
            total=self.total,
        )


class _LRUFactorCache:
    """LRU cache: composite -> sorted tuple of prime factors (w/ multiplicity)."""

    def __init__(self, capacity: int):
        self.capacity = capacity
        self._d: "OrderedDict[int, Tuple[int, ...]]" = OrderedDict()

    def get(self, c: int) -> Optional[Tuple[int, ...]]:
        v = self._d.get(c)
        if v is not None:
            self._d.move_to_end(c)
        return v

    def put(self, c: int, factors: Tuple[int, ...]) -> None:
        if c in self._d:
            self._d.move_to_end(c)
        self._d[c] = factors
        if len(self._d) > self.capacity:
            self._d.popitem(last=False)

    def __contains__(self, c: int) -> bool:
        return c in self._d

    def __len__(self) -> int:
        return len(self._d)


class Factorizer:
    """PFCS Algorithm 2: hierarchical relationship discovery.

    Parameters
    ----------
    precomputed_limit:
        Upper bound of the SPF table (paper: 10**6).
    cache_capacity:
        Entries in the factorization LRU cache.
    trial_prime_limit:
        Largest prime used in stage-2 trial division (paper: 1000, i.e.
        ``SmallPrimes[2, min(1000, sqrt(c))]``).
    """

    def __init__(
        self,
        precomputed_limit: int = PRECOMPUTED_LIMIT,
        cache_capacity: int = 1 << 16,
        trial_prime_limit: int = 1000,
    ):
        self.precomputed_limit = precomputed_limit
        self._spf = spf_table(precomputed_limit)
        self._small_primes = [int(p) for p in sieve_primes(trial_prime_limit)]
        self.cache = _LRUFactorCache(cache_capacity)
        self.stats = FactorizationStats()

    # ------------------------------------------------------------------ #
    # public API                                                         #
    # ------------------------------------------------------------------ #

    def factorize(self, c: int, time_budget_s: float = 0.05) -> Tuple[int, ...]:
        """Full prime factorization of ``c`` (sorted, with multiplicity).

        Deterministic and exact for any 64-bit composite; the time budget
        applies the paper's staged split (70% trial division, remainder
        Pollard rho).  On budget exhaustion the partial factorization is
        returned with the unfactored cofactor appended if it is prime,
        else factored best-effort (counted in ``budget_exceeded``).
        """
        self.stats.total += 1
        if c <= 1:
            return ()
        # Stage 0: precomputed SPF table ------------------------------------
        if c <= self.precomputed_limit:
            self.stats.table_hits += 1
            return self._factor_spf(c)
        # Stage 1: factorization cache --------------------------------------
        cached = self.cache.get(c)
        if cached is not None:
            self.stats.cache_hits += 1
            return cached
        # Stage 2: bounded trial division ------------------------------------
        t0 = time.perf_counter()
        factors: List[int] = []
        remaining = c
        trial_deadline = t0 + 0.7 * time_budget_s
        used_trial = False
        sqrt_c = math.isqrt(remaining)
        for p in self._small_primes:
            if p > sqrt_c or remaining == 1:
                break
            if remaining % p == 0:
                used_trial = True
                while remaining % p == 0:
                    factors.append(p)
                    remaining //= p
                sqrt_c = math.isqrt(remaining)
            if time.perf_counter() > trial_deadline:
                break
        if used_trial:
            self.stats.trial_division += 1
        # Stage 3: Pollard rho on the cofactor --------------------------------
        if remaining > 1:
            if remaining <= self.precomputed_limit:
                factors.extend(self._factor_spf(remaining))
            elif is_prime(remaining):
                factors.append(remaining)
            else:
                self.stats.pollard_rho += 1
                deadline = t0 + time_budget_s
                ok = self._pollard_recurse(remaining, factors, deadline)
                if not ok:
                    self.stats.budget_exceeded += 1
                    # graceful degradation result: do NOT cache — a partial
                    # factorization in the cache would later violate the
                    # zero-false-positive contract (Theorem 1) when served
                    # for a composite whose factors are known to a caller.
                    return tuple(sorted(factors))
        out = tuple(sorted(factors))
        self.cache.put(c, out)
        return out

    def factorize_batch(self, cs: Sequence[int], time_budget_s: float = 0.05) -> List[Tuple[int, ...]]:
        return [self.factorize(int(c), time_budget_s) for c in cs]

    def distinct_factors(self, c: int, **kw) -> Tuple[int, ...]:
        return tuple(sorted(set(self.factorize(c, **kw))))

    # ------------------------------------------------------------------ #
    # stages                                                              #
    # ------------------------------------------------------------------ #

    def _factor_spf(self, c: int) -> Tuple[int, ...]:
        out: List[int] = []
        spf = self._spf
        while c > 1:
            p = int(spf[c])
            out.append(p)
            c //= p
        return tuple(out)

    @staticmethod
    def _pollard_brent(n: int, seed: int = 1) -> int:
        """One non-trivial factor of composite n (Brent's improvement of
        Pollard's rho, Pollard 1975 [paper ref 5]). Deterministic seeds."""
        if n % 2 == 0:
            return 2
        # deterministic sequence of (y, c) trials
        for c in range(seed, seed + 64):
            y, m, g, r, q = 2 + c, 128, 1, 1, 1
            x = ys = y
            while g == 1:
                x = y
                for _ in range(r):
                    y = (y * y + c) % n
                k = 0
                while k < r and g == 1:
                    ys = y
                    for _ in range(min(m, r - k)):
                        y = (y * y + c) % n
                        q = q * abs(x - y) % n
                    g = math.gcd(q, n)
                    k += m
                r <<= 1
            if g == n:
                g = 1
                while g == 1:
                    ys = (ys * ys + c) % n
                    g = math.gcd(abs(x - ys), n)
            if g != n:
                return g
        raise ArithmeticError(f"pollard_brent failed for {n}")

    def _pollard_recurse(self, n: int, out: List[int], deadline: float) -> bool:
        """Fully factor n into ``out``. Returns False if budget ran out
        (best-effort factors still appended)."""
        stack = [n]
        ok = True
        while stack:
            m = stack.pop()
            if m == 1:
                continue
            if m <= self.precomputed_limit:
                out.extend(self._factor_spf(m))
                continue
            if is_prime(m):
                out.append(m)
                continue
            if time.perf_counter() > deadline:
                # graceful degradation (paper §7.2): keep composite as-is
                out.append(m)
                ok = False
                continue
            d = self._pollard_brent(m)
            stack.append(d)
            stack.append(m // d)
        return ok
