"""Prime generation and per-cache-level prime pools (PFCS §3.2–3.3).

The paper assigns each cache level a prime *range* trading factorization
cost against relationship expressiveness:

    L1   : small primes 2..997          (sub-ns factor-out; precomputed tables)
    L2   : medium primes 1_009..99_991
    L3   : large primes 100_003..999_983
    MEM  : primes >= 1_000_003          (generated lazily, segmented sieve)

``PrimePool`` hands out primes in ascending order (small primes are the
scarce, valuable resource — Algorithm 1 routes hot data here) and supports
the paper's LRU *recycling* path: on exhaustion, ``RecycleLRUPrimes``
reclaims the primes of the least-recently-used data elements
(10% of the pool per the pseudocode).

Everything here is exact host-side integer math (numpy sieves); the
batched device paths live in ``repro_torch.kernels``.
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "sieve_primes",
    "spf_table",
    "segmented_sieve",
    "is_prime",
    "CacheLevel",
    "LEVEL_PRIME_RANGES",
    "PrimePool",
    "HierarchicalPrimeAllocator",
]


# --------------------------------------------------------------------------
# Sieves
# --------------------------------------------------------------------------

def sieve_primes(limit: int) -> np.ndarray:
    """All primes <= limit (inclusive), via the sieve of Eratosthenes.

    Returns int64 array. O(limit log log limit); limit=10**7 takes ~0.1 s.
    """
    if limit < 2:
        return np.empty(0, dtype=np.int64)
    mask = np.ones(limit + 1, dtype=bool)
    mask[:2] = False
    for p in range(2, int(limit**0.5) + 1):
        if mask[p]:
            mask[p * p :: p] = False
    return np.nonzero(mask)[0].astype(np.int64)


def spf_table(limit: int) -> np.ndarray:
    """Smallest-prime-factor table for 0..limit.

    ``spf[n]`` is the smallest prime dividing n (spf[0]=spf[1]=0).  This is
    the paper's "precomputed factorization table" for composites <= 10**6
    (Algorithm 2, stage 0): repeated division by spf recovers the full
    factorization in O(log n).
    """
    spf = np.zeros(limit + 1, dtype=np.int64)
    if limit >= 2:
        # every even number's smallest factor is 2
        spf[2::2] = 2
        for p in range(3, int(limit**0.5) + 1, 2):
            if spf[p] == 0:  # p is prime
                sl = spf[p * p :: 2 * p]  # odd multiples only
                sl[sl == 0] = p
                spf[p * p :: 2 * p] = sl
        # remaining zeros (odd primes themselves)
        odd = np.arange(3, limit + 1, 2)
        rem = odd[spf[odd] == 0]
        spf[rem] = rem
    return spf


def segmented_sieve(lo: int, hi: int, base_primes: Optional[np.ndarray] = None) -> np.ndarray:
    """Primes in [lo, hi) via a segmented sieve (lazy MEM-level extension)."""
    if hi <= lo:
        return np.empty(0, dtype=np.int64)
    if base_primes is None:
        base_primes = sieve_primes(int(hi**0.5) + 1)
    mask = np.ones(hi - lo, dtype=bool)
    if lo == 0:
        mask[: min(2, hi - lo)] = False
    elif lo == 1:
        mask[0] = False
    for p in base_primes:
        p = int(p)
        if p * p >= hi:
            break
        start = max(p * p, ((lo + p - 1) // p) * p)
        mask[start - lo :: p] = False
        if lo <= p < hi:  # the prime itself stays prime
            mask[p - lo] = True
    return (np.nonzero(mask)[0] + lo).astype(np.int64)


_SMALL_PRIMES_FOR_MR = (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37)


def is_prime(n: int) -> bool:
    """Deterministic Miller–Rabin, exact for all n < 3.3 * 10**24."""
    if n < 2:
        return False
    for p in _SMALL_PRIMES_FOR_MR:
        if n % p == 0:
            return n == p
    d, s = n - 1, 0
    while d % 2 == 0:
        d //= 2
        s += 1
    for a in _SMALL_PRIMES_FOR_MR:
        x = pow(a, d, n)
        if x in (1, n - 1):
            continue
        for _ in range(s - 1):
            x = x * x % n
            if x == n - 1:
                break
        else:
            return False
    return True


# --------------------------------------------------------------------------
# Cache levels and pools
# --------------------------------------------------------------------------

class CacheLevel:
    """Symbolic cache-level ids, ordered hot -> cold (paper Fig. 1)."""

    L1 = 0
    L2 = 1
    L3 = 2
    MEM = 3

    ALL = (L1, L2, L3, MEM)
    NAMES = {L1: "L1", L2: "L2", L3: "L3", MEM: "MEM"}


# Paper §3.2 prime ranges per level. MEM is open-ended (lazy segments).
LEVEL_PRIME_RANGES: Dict[int, Tuple[int, Optional[int]]] = {
    CacheLevel.L1: (2, 997),
    CacheLevel.L2: (1_009, 99_991),
    CacheLevel.L3: (100_003, 999_983),
    CacheLevel.MEM: (1_000_003, None),
}


@dataclass
class PrimePool:
    """A pool of primes for one cache level (paper Algorithm 1, lines 7-11).

    Primes are allocated ascending (cheapest factorization first).  Freed
    primes return to a free-list and are re-used before fresh ones.  The
    pool can be lazily extended (MEM level) with a segmented sieve.
    """

    level: int
    lo: int
    hi: Optional[int]  # None => unbounded (lazy extension)
    initial_capacity: int = 4096

    _primes: List[int] = field(default_factory=list, repr=False)
    _next_idx: int = 0
    _free: List[int] = field(default_factory=list, repr=False)
    _allocated: set = field(default_factory=set, repr=False)
    _lazy_cursor: int = 0  # next sieve segment start (MEM level)

    def __post_init__(self) -> None:
        if self.hi is not None:
            self._primes = [int(p) for p in segmented_sieve(self.lo, self.hi + 1)]
        else:
            self._lazy_cursor = self.lo
            self._extend(self.initial_capacity)

    # -- internals ---------------------------------------------------------
    def _extend(self, at_least: int) -> None:
        """Lazily sieve more primes (MEM level only)."""
        if self.hi is not None:
            return
        got = 0
        seg = 1 << 16
        while got < at_least:
            new = segmented_sieve(self._lazy_cursor, self._lazy_cursor + seg)
            self._primes.extend(int(p) for p in new)
            got += len(new)
            self._lazy_cursor += seg
            seg = min(seg * 2, 1 << 22)

    # -- public API ---------------------------------------------------------
    @property
    def size(self) -> int:
        return len(self._primes)

    @property
    def n_allocated(self) -> int:
        return len(self._allocated)

    @property
    def n_available(self) -> int:
        avail = len(self._free) + (len(self._primes) - self._next_idx)
        return avail if self.hi is not None else int(1e18)

    def allocate(self) -> Optional[int]:
        """Next free prime, ascending; ``None`` when a bounded pool is dry."""
        if self._free:
            # smallest freed prime first — keeps hot-range density high
            p = min(self._free)
            self._free.remove(p)
            self._allocated.add(p)
            return p
        if self._next_idx >= len(self._primes):
            if self.hi is None:
                self._extend(self.initial_capacity)
            else:
                return None
        p = self._primes[self._next_idx]
        self._next_idx += 1
        self._allocated.add(p)
        return p

    def allocate_many(self, n: int) -> List[int]:
        """Batched :meth:`allocate`: the primes that ``n`` successive
        ``allocate()`` calls would return, in the same order (bounded
        pools return fewer when dry), with the same final allocation
        state.  The free-list is consumed smallest-first exactly as the
        scalar path does, then fresh primes come off the ascending
        cursor in one slice — this is the streamed-build fast path for
        million-element registries (``benchmarks.cases.case_scale``).
        """
        if n <= 0:
            return []
        out: List[int] = []
        if self._free:
            take = sorted(self._free)[:n]
            if len(take) == len(self._free):
                self._free.clear()
            else:
                for p in take:
                    self._free.remove(p)
            out.extend(take)
        want = n - len(out)
        if want > 0:
            if self.hi is None and len(self._primes) - self._next_idx < want:
                self._extend(want - (len(self._primes) - self._next_idx))
            fresh = self._primes[self._next_idx : self._next_idx + want]
            self._next_idx += len(fresh)
            out.extend(fresh)
        self._allocated.update(out)
        return out

    def free(self, p: int) -> None:
        """Return ``p`` to the free-list.  Double-frees and *foreign*
        primes (out of this pool's value range, or never allocated from
        it — e.g. another tenant namespace's prime) are no-ops: the
        ``_allocated`` guard is what keeps a double-free from planting
        the same prime on the free-list twice and handing it to two
        data elements (pinned in tests/test_pfcs_core.py)."""
        if not self.contains_range(p):
            return
        if p in self._allocated:
            self._allocated.remove(p)
            self._free.append(p)

    def contains_range(self, p: int) -> bool:
        return p >= self.lo and (self.hi is None or p <= self.hi)


class HierarchicalPrimeAllocator:
    """All four level pools behind one façade (paper Fig. 1)."""

    def __init__(self, ranges: Optional[Dict[int, Tuple[int, Optional[int]]]] = None):
        ranges = ranges or LEVEL_PRIME_RANGES
        self.pools: Dict[int, PrimePool] = {
            lvl: PrimePool(level=lvl, lo=lo, hi=hi) for lvl, (lo, hi) in ranges.items()
        }

    def pool(self, level: int) -> PrimePool:
        return self.pools[level]

    def allocate(self, level: int) -> Optional[int]:
        return self.pools[level].allocate()

    def allocate_many(self, level: int, n: int) -> List[int]:
        return self.pools[level].allocate_many(n)

    def free(self, level: int, p: int) -> None:
        """Free ``p``, routed to the pool whose range actually contains
        it.  Trusting a wrong ``level`` used to leak the prime silently
        (the range guard in ``PrimePool.free`` made the mis-routed call
        a no-op, so the prime was never reusable again) — audited and
        pinned in tests/test_pfcs_core.py."""
        owner = self.level_of_prime(p)
        self.pools[owner if owner in self.pools else level].free(p)

    def level_of_prime(self, p: int) -> int:
        for lvl, pool in self.pools.items():
            if pool.contains_range(p):
                return lvl
        return CacheLevel.MEM
