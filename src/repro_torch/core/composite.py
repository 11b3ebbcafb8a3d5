"""Composite relationship encoding & registry (PFCS §3.1, §4.2).

A relationship over data elements {d1..dk} with primes {p1..pk} is stored
as the composite c = Π pi.  The Fundamental Theorem of Arithmetic makes the
decoding (factorization) unique — Theorem 1's zero-false-positive
guarantee, which the test-suite checks as a machine property.

64-bit overflow management
--------------------------
The paper implicitly assumes composites fit machine words ("systems with
10**12 elements require primes within 64-bit ranges", §7.1).  Products of
many primes overflow regardless, so the registry *chunks* a k-ary
relationship into composites that each fit ``max_bits`` (default 62, so
int64 device kernels stay exact); all chunks share a relationship id.
Pairwise relationships — the dominant case in the paper's workloads
(FK pairs, feature pairs, instrument pairs) — always fit.

Multi-limb wide mode (DESIGN.md §11)
------------------------------------
``max_bits > 63`` switches the registry to the :class:`LimbComposite`
encoding: each chunk is stored exactly as ``ceil(max_bits / 32)``
little-endian 32-bit limbs, so a single chunk can hold a 100+-deep chain
composite without overflow and the former PR 6 "detect, never silent"
overflow guard becomes "represent, never raise".  Member primes must fit
``MAX_PRIME_BITS`` (31) bits so every limb x prime product in the limb
kernels stays inside a signed int64 word — a bound no pool prime ever
approaches (the 10**6-th prime is ~2**24).  Arithmetic stays exact
integer everywhere; Theorem 1's zero-false-positive guarantee is
untouched because chunk values are the same products of distinct primes,
merely re-encoded.

The registry also maintains the flat numpy array view of live composites
that the divisibility-scan kernel (``repro_torch.kernels.ops``)
consumes directly, and — in wide mode — the ``(N, L)`` int64 limb matrix
the limb kernels consume (``limbs_array``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, FrozenSet, Iterable, List, Optional, Sequence, Set, Tuple

import numpy as np

from .factorization import Factorizer

__all__ = ["encode_relationship", "CompositeRegistry", "Relationship",
           "LimbComposite", "LIMB_BITS", "LIMB_BASE", "MAX_PRIME_BITS",
           "MAX_COMPOSITE_BITS", "n_limbs_for_bits", "int_to_limbs",
           "limbs_to_int", "pack_limbs", "unpack_limbs"]

#: limb word width: 32-bit limbs held in int64 lanes keep every kernel
#: intermediate (limb * prime + carry, Horner-mod partial remainders)
#: provably inside a signed int64 — no float paths, no wraparound.
LIMB_BITS = 32
LIMB_BASE = 1 << LIMB_BITS
LIMB_MASK = LIMB_BASE - 1

#: primes must fit 31 bits so ``limb * p`` < 2**63 (see DESIGN.md §11);
#: the prime pools never mint anything close (10**6-th prime ~ 2**24).
MAX_PRIME_BITS = 31
MAX_PRIME_LIMIT = 1 << MAX_PRIME_BITS

#: sanity cap on chunk width (128 limbs) — wide enough for 150+-deep
#: chains of MEM-level primes in ONE chunk, small enough that a
#: misconfigured budget cannot allocate absurd limb matrices.
MAX_COMPOSITE_BITS = 4096


def n_limbs_for_bits(max_bits: int) -> int:
    """Limbs needed to hold any value < 2**max_bits."""
    return -(-int(max_bits) // LIMB_BITS)


def int_to_limbs(x: int, n_limbs: int) -> List[int]:
    """Little-endian 32-bit limb decomposition of a non-negative int."""
    x = int(x)
    if x < 0:
        raise ValueError(f"composites are positive, got {x}")
    out = []
    for _ in range(n_limbs):
        out.append(x & LIMB_MASK)
        x >>= LIMB_BITS
    if x:
        raise OverflowError(
            f"value needs more than {n_limbs} limbs ({n_limbs * LIMB_BITS} bits)")
    return out


def limbs_to_int(limbs: Sequence[int]) -> int:
    """Inverse of :func:`int_to_limbs` (exact Python int)."""
    x = 0
    for limb in reversed(list(limbs)):
        x = (x << LIMB_BITS) | (int(limb) & LIMB_MASK)
    return x


def pack_limbs(values: Sequence[int], n_limbs: int) -> np.ndarray:
    """Pack Python-int composites into the ``(N, L)`` int64 kernel matrix
    (each value's little-endian bytes read as 32-bit words; a negative or
    too wide value raises as :func:`int_to_limbs` does)."""
    width = n_limbs * (LIMB_BITS // 8)
    try:
        raw = b"".join(int(v).to_bytes(width, "little") for v in values)
    except OverflowError:
        for v in values:
            int_to_limbs(v, n_limbs)        # raises naming the fault
        raise
    return np.frombuffer(raw, dtype="<u4").reshape(
        len(values), n_limbs).astype(np.int64)


def unpack_limbs(arr: np.ndarray) -> List[int]:
    """Exact Python ints back out of an ``(N, L)`` limb matrix (each limb
    taken mod 2**32, as :func:`limbs_to_int` takes it)."""
    words = np.ascontiguousarray(np.asarray(arr).astype("<u4"))
    n = words.shape[0]
    width = words.shape[1] * (LIMB_BITS // 8)
    raw = words.tobytes()
    return [int.from_bytes(raw[i * width:(i + 1) * width], "little")
            for i in range(n)]


@dataclass(frozen=True)
class LimbComposite:
    """One composite as fixed-width little-endian 32-bit limbs.

    The scalar unit of the wide registry encoding: ``encode`` splits an
    exact Python-int chunk value into limbs, ``value`` reassembles it
    bit-exactly.  The registry's ``limbs_array()`` is the batched (N, L)
    form of this for the limb kernels.
    """

    limbs: Tuple[int, ...]

    @classmethod
    def encode(cls, value: int, n_limbs: int) -> "LimbComposite":
        return cls(tuple(int_to_limbs(value, n_limbs)))

    @property
    def value(self) -> int:
        return limbs_to_int(self.limbs)

    def __int__(self) -> int:
        return self.value

    @property
    def n_limbs(self) -> int:
        return len(self.limbs)


def encode_relationship(primes: Sequence[int], max_bits: int = 62) -> List[int]:
    """Chunk a multiset of primes into composites, each < 2**max_bits.

    This is the ONE canonical chunking point: the input multiset is
    sorted here (and only here), so the same multiset produces the same
    chunk tuple regardless of caller order — including duplicate-prime
    multisets, where ``sorted`` keeps every occurrence.  Callers must NOT
    pre-sort (``CompositeRegistry.register`` passes its frozenset
    straight through).

    Greedy first-fit keeps chunk count minimal for sorted input.  The
    boundary is inclusive on the value side and exclusive on the budget:
    a chunk product of exactly ``2**max_bits - 1`` is accepted, a prime
    of exactly ``2**max_bits`` is rejected.  Raises if any single prime
    alone exceeds the bound (cannot be represented), or — in wide
    (``max_bits > 63``) mode — exceeds the 31-bit kernel limb word (no
    pool prime ever does; see DESIGN.md §11).
    """
    limit = 1 << max_bits
    wide = max_bits > 63
    chunks: List[int] = []
    cur = 1
    for p in sorted(primes):
        if p <= 1:
            raise ValueError(f"not a prime: {p}")
        if p >= limit:
            raise ValueError(f"prime {p} exceeds {max_bits}-bit composite budget")
        if wide and p >= MAX_PRIME_LIMIT:
            raise ValueError(
                f"prime {p} exceeds the {MAX_PRIME_BITS}-bit kernel limb "
                f"word (limb arithmetic would overflow int64)")
        if cur * p >= limit:
            chunks.append(cur)
            cur = p
        else:
            cur *= p
    if cur > 1:
        chunks.append(cur)
    return chunks


@dataclass(frozen=True)
class Relationship:
    """One registered relationship (e.g. an FK edge or co-access group)."""

    rel_id: int
    primes: FrozenSet[int]
    composites: Tuple[int, ...]
    kind: str = "generic"
    weight: float = 1.0


class CompositeRegistry:
    """Live store of relationship composites with divisibility scanning.

    API mirrors the paper's use:
      * ``register(primes)``       — establish a relationship (composite(s))
      * ``related_to(p)``          — §4.2 intelligent prefetch: all primes
                                     co-occurring with p in any composite,
                                     recovered *by factorization*.
      * ``composites_array()``     — int64 view for the scan kernel.
    """

    def __init__(self, factorizer: Optional[Factorizer] = None, max_bits: int = 62):
        if not 1 < max_bits <= MAX_COMPOSITE_BITS:
            # max_bits <= 63 keeps every chunk inside one signed int64
            # kernel word (the flat composites_array() view); anything
            # wider flips the registry into multi-limb mode, where chunks
            # are exact (N, n_limbs) 32-bit-limb rows (limbs_array()) and
            # the cap only guards against absurd limb matrices.
            raise ValueError(
                f"max_bits must be in (1, {MAX_COMPOSITE_BITS}], "
                f"got {max_bits}")
        self.factorizer = factorizer or Factorizer()
        self.max_bits = max_bits
        #: wide mode: chunks may exceed int64 — consumers must use the
        #: limb matrix (limbs_array) or exact Python ints
        #: (composites_list / composites_view), never composites_array.
        self.wide = max_bits > 63
        #: limb rows wide enough for any value < 2**max_bits (also
        #: meaningful in narrow mode: the limb kernels are differential-
        #: fuzzed against the int64 path at every width)
        self.n_limbs = n_limbs_for_bits(max_bits)
        self._next_id = 0
        self._by_id: Dict[int, Relationship] = {}
        self._by_composite: Dict[int, int] = {}  # composite -> rel_id
        self._prime_degree: Dict[int, int] = {}  # prime -> #relationships
        self._dirty = True
        self._arr: np.ndarray = np.empty(0, dtype=np.int64)
        self._limbs: np.ndarray = np.empty((0, self.n_limbs), dtype=np.int64)
        self._limbs_version = -1
        self.version = 0  # bumped on every mutation (memoization key)

    # -- registration -------------------------------------------------------

    def register(self, primes: Iterable[int], kind: str = "generic", weight: float = 1.0) -> Relationship:
        pset = frozenset(int(p) for p in primes)
        if len(pset) < 2:
            raise ValueError("a relationship needs >= 2 distinct elements")
        # canonical chunking happens INSIDE encode_relationship (the one
        # sort) — passing the frozenset unsorted is deliberate.
        comps = tuple(encode_relationship(pset, self.max_bits))
        rel = Relationship(self._next_id, pset, comps, kind, weight)
        self._next_id += 1
        self._by_id[rel.rel_id] = rel
        for c in comps:
            self._by_composite[c] = rel.rel_id
        for p in pset:
            self._prime_degree[p] = self._prime_degree.get(p, 0) + 1
        self._dirty = True
        self.version += 1
        return rel

    def register_many(self, groups: Iterable[Iterable[int]],
                      kind: str = "generic",
                      weight: float = 1.0) -> List[Relationship]:
        """Batched :meth:`register`, bit-identical to the per-element loop.

        Same validation, same canonical chunking, same id sequence, and
        the same final ``version`` (bumped once per registration, so
        version-keyed memoizers observe the same epoch).  The speedup
        comes from hoisting the dict attribute lookups out of the hot
        loop and deferring the ``_next_id`` / ``version`` writebacks —
        the streamed-build path for million-composite registries
        (``benchmarks.cases.case_scale``).  If a group fails validation
        mid-batch, the completed prefix stays registered exactly as the
        scalar loop would leave it.
        """
        by_id = self._by_id
        by_comp = self._by_composite
        deg = self._prime_degree
        max_bits = self.max_bits
        limit = 1 << max_bits
        wide = self.wide
        rid = self._next_id
        out: List[Relationship] = []
        try:
            for primes in groups:
                pset = frozenset(map(int, primes))
                if len(pset) < 2:
                    raise ValueError(
                        "a relationship needs >= 2 distinct elements")
                if len(pset) == 2:
                    # pairwise fast path — the dominant case (FK pairs,
                    # chain edges): inline the two-prime chunking;
                    # identical chunk tuple, with invalid pairs deferred
                    # to the canonical encoder for the canonical error
                    a, b = pset
                    if a > b:
                        a, b = b, a
                    if a <= 1 or b >= limit or (wide
                                                and b >= MAX_PRIME_LIMIT):
                        encode_relationship(pset, max_bits)  # raises
                        raise AssertionError("unreachable")
                    ab = a * b
                    comps = (ab,) if ab < limit else (a, b)
                else:
                    comps = tuple(encode_relationship(pset, max_bits))
                rel = Relationship(rid, pset, comps, kind, weight)
                rid += 1
                by_id[rel.rel_id] = rel
                for c in comps:
                    by_comp[c] = rel.rel_id
                for p in pset:
                    deg[p] = deg.get(p, 0) + 1
                out.append(rel)
        finally:
            self._next_id = rid
            if out:
                self._dirty = True
                self.version += len(out)
        return out

    def unregister(self, rel_id: int) -> None:
        rel = self._by_id.pop(rel_id, None)
        if rel is None:
            return
        for c in rel.composites:
            self._by_composite.pop(c, None)
        for p in rel.primes:
            d = self._prime_degree.get(p, 0) - 1
            if d <= 0:
                self._prime_degree.pop(p, None)
            else:
                self._prime_degree[p] = d
        self._dirty = True
        self.version += 1

    def drop_prime(self, p: int) -> List[int]:
        """Remove every relationship involving prime p (prime recycling
        must purge stale composites or factorization would resurrect a
        recycled element — paper §7.2 'prime space management')."""
        doomed = [r.rel_id for r in self._by_id.values() if p in r.primes]
        for rid in doomed:
            self.unregister(rid)
        return doomed

    # -- queries -------------------------------------------------------------

    def __len__(self) -> int:
        return len(self._by_id)

    @property
    def n_composites(self) -> int:
        return len(self._by_composite)

    def degree(self, p: int) -> int:
        return self._prime_degree.get(p, 0)

    def primes_array(self) -> np.ndarray:
        """Sorted int64 array of every live member prime — the trial-
        division pool for the batched factorize kernel (engine bulk
        discovery, DESIGN.md §3)."""
        return np.fromiter(sorted(self._prime_degree), dtype=np.int64,
                           count=len(self._prime_degree))

    def composites_array(self) -> np.ndarray:
        """Flat int64 array of all live composites (kernel input).

        Narrow mode only — wide (multi-limb) chunks cannot fit int64;
        use :meth:`limbs_array` (kernels) or :meth:`composites_view` /
        :meth:`composites_list` (host) there.
        """
        if self.wide:
            raise OverflowError(
                "composites exceed int64 in wide (multi-limb) mode; use "
                "limbs_array() / composites_view() / composites_list()")
        if self._dirty:
            self._arr = np.fromiter(self._by_composite.keys(), dtype=np.int64,
                                    count=len(self._by_composite))
            self._dirty = False
        return self._arr

    def composites_list(self) -> List[int]:
        """All live composites as exact Python ints, registry order."""
        return [int(c) for c in self._by_composite]

    def composites_view(self) -> np.ndarray:
        """Registry-order composite array at whatever dtype is exact:
        the int64 kernel view in narrow mode, an object array of Python
        ints in wide mode.  Host-side consumers that only index / compare
        / take ``%`` (resharding, isolation audit) stay mode-agnostic."""
        if not self.wide:
            return self.composites_array()
        out = np.empty(len(self._by_composite), dtype=object)
        for i, c in enumerate(self._by_composite):
            out[i] = int(c)
        return out

    def limbs_array(self) -> np.ndarray:
        """``(N, n_limbs)`` int64 little-endian 32-bit-limb matrix of all
        live composites, registry (row) order matching
        :meth:`composites_view` — the wide-mode kernel input."""
        if self._limbs_version != self.version:
            self._limbs = pack_limbs(list(self._by_composite), self.n_limbs)
            self._limbs_version = self.version
        return self._limbs

    def relationship_of_composite(self, c: int) -> Optional[Relationship]:
        rid = self._by_composite.get(c)
        return self._by_id.get(rid) if rid is not None else None

    def containing(self, p: int) -> List[Relationship]:
        """All relationships whose composite is divisible by p.

        This is the paper's §4.2 scan: divisibility test over the registry,
        then *factorization* of the matching composites recovers the exact
        member set (not a reverse-index lookup — the correctness of the
        factorization path is the claim under test, and the scan is what
        the device kernel accelerates).
        """
        if self.wide:
            # exact Python-int modular scan (dict insertion order == the
            # registry order the narrow numpy path iterates in)
            hits: Sequence[int] = [c for c in self._by_composite if c % p == 0]
        else:
            arr = self.composites_array()
            if arr.size == 0:
                return []
            hits = arr[arr % p == 0]
        out: List[Relationship] = []
        seen: Set[int] = set()
        for c in hits:
            c = int(c)
            factors = self._factor_with_hint(c, p)
            assert p in factors, "divisibility hit must contain p (Theorem 1)"
            rid = self._by_composite[c]
            if rid not in seen:
                seen.add(rid)
                out.append(self._by_id[rid])
        return out

    def _factor_with_hint(self, c: int, p: int) -> Tuple[int, ...]:
        """Factor c given the known factor p from the divisibility scan.

        The scan *is* trial division by pool primes (Algorithm 2 stage 1):
        once p is known, the cofactor c//p is either 1, prime (pairwise
        relationship — the dominant case), or recursed through the full
        multi-stage factorizer.  Stage stats are charged accordingly.
        """
        from .primes import is_prime  # local import avoids cycle at module load

        cached = self.factorizer.cache.get(c)
        if cached is not None and p in cached:
            self.factorizer.stats.cache_hits += 1
            self.factorizer.stats.total += 1
            return tuple(sorted(set(cached)))
        q, r = divmod(c, p)
        assert r == 0
        self.factorizer.stats.total += 1
        self.factorizer.stats.trial_division += 1
        if q == 1:
            out = (p,)
        elif is_prime(q):
            out = (p, q)
        else:
            # generous budget: registry hits must decode exactly (partial
            # factorizations are never cached — see Factorizer.factorize)
            out = tuple(sorted({p, *self.factorizer.factorize(
                q, time_budget_s=1.0)}))
        self.factorizer.cache.put(c, out)
        return out

    def related_primes(self, p: int) -> Set[int]:
        """All primes deterministically related to p (excluding p)."""
        rel: Set[int] = set()
        for r in self.containing(p):
            for c in r.composites:
                for q in self.factorizer.distinct_factors(int(c)):
                    if q != p:
                        rel.add(q)
            # multi-chunk relationships: all member primes are related
            rel |= set(r.primes) - {p}
        return rel

    def limb_composite(self, c: int) -> LimbComposite:
        """The registry-width :class:`LimbComposite` encoding of one
        composite (a single row of :meth:`limbs_array`)."""
        return LimbComposite.encode(int(c), self.n_limbs)

    def decode(self, c: int) -> Tuple[int, ...]:
        """Factorize an arbitrary composite back to its member primes."""
        return self.factorizer.distinct_factors(int(c))
