"""Elastic re-striping plans and the per-shard registry slice index (port
of ``repro.sharding.reshard``).

The sharded discovery path (``core.engine.shard``) derives "which shard
scans which composite" from :meth:`PrimeSpacePartition.classify` on
every table refresh — an O(registry) walk that re-materializes metadata
the partition function already determines.  This module turns that
transient classification into a *maintained index*, :class:`ShardSlices`,
so elastic events can be answered incrementally:

* **Resize (re-stripe).**  A shard-count change swaps the
  :class:`~repro_torch.sharding.stripes.BlockStripes` modulus under the
  same contiguous block grid (the per-level width caps bind for the serving
  levels, so the grid is identical at 2 and 4 shards — only ``k %
  n_parts`` changes).  :meth:`ShardSlices.restripe` re-evaluates the
  owner of every *cached* chunk-prime tuple vectorially and emits a
  :class:`ReshardPlan` listing exactly the positions whose owner
  changed — the only registry slice entries that must move.  Nothing is
  re-read from the registry and no successor row is rebuilt.

* **Shard loss (recovery-as-refactorization).**  When a shard dies, its
  slice of the index is forgotten (:meth:`forget_shard`).  Recovery
  does NOT consult any surviving metadata for the lost positions:
  :meth:`recover` re-factorizes the surviving composite values through
  :func:`repro_torch.kernels.ops.factorize_batch_exact` — the same
  factorization kernel the discovery scan uses, on the cache's device —
  and reclassifies from the recovered prime factors alone.  By unique
  factorization (paper Theorem 1) the rebuilt index is bit-equal to one
  built from intact metadata; the chaos fuzz in
  ``tests/test_torch_elastic.py`` pins that against the reference.

**Chunk-level ownership.**  ``PrimeSpacePartition.classify`` labels a
position by ALL primes of its relationship; this index labels it by the
primes dividing *that chunk* (recoverable from the composite value
alone, which is what survives a shard loss).  The two produce identical
scan results: a prime's divisibility/gcd hits can only come from the
chunk that contains it, so routing each chunk to its own primes' owner
preserves every (query prime, position) hit pair.  For the serving
workload — pairwise chain edges, single-chunk relationships — the two
classifications coincide exactly.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["CROSS", "LOST", "ReshardPlan", "ShardSlices"]

#: Owner code: chunk's primes span shards; scanned via the gcd exchange.
CROSS = -1
#: Owner code: entry belonged to a dead shard; must be re-factorized.
LOST = -2


@dataclass(frozen=True)
class ReshardPlan:
    """Migration plan for one live shard-count change.

    ``moved`` lists exactly the registry positions whose owner changed
    under the new striping; everything else stays in place.  Composite
    chunks are int64, so the migrated payload is ``8 * len(moved)``
    bytes versus ``8 * total`` for a naive full re-shuffle — the
    benchmark gap ``case_elastic`` reports.
    """

    n_old: int
    n_new: int
    total: int                      # live composite chunks at plan time
    moved: Tuple[int, ...]          # positions whose owner changed
    dests: Tuple[int, ...]          # new owner per moved position

    @property
    def migrated_bytes(self) -> int:
        return 8 * len(self.moved)

    @property
    def full_rebuild_bytes(self) -> int:
        return 8 * self.total

    def describe(self) -> str:
        return (f"ReshardPlan({self.n_old}->{self.n_new}: "
                f"{len(self.moved)}/{self.total} chunks move, "
                f"{self.migrated_bytes}B vs {self.full_rebuild_bytes}B "
                f"full rebuild)")


class ShardSlices:
    """Maintained position -> owner index over a registry's composites.

    ``owner[pos]`` is a shard id (>= 0) for shard-local chunks,
    :data:`CROSS` for chunks whose primes span shards, or :data:`LOST`
    for entries forgotten with a dead shard.  ``sync`` keeps the index
    current incrementally (append-only registry growth classifies only
    the tail); ``local()``/``cross()`` export the exact position lists
    :func:`repro_torch.core.engine.shard.sharded_successor_table` consumes via
    its ``precomputed=`` argument.
    """

    def __init__(self, partition):
        self.partition = partition
        self.version: Optional[int] = None
        self._values = np.empty(0, np.int64)
        self._owner = np.empty(0, np.int32)
        self._primes: List[Tuple[int, ...]] = []

    # ------------------------------------------------------------------ #
    # classification                                                     #
    # ------------------------------------------------------------------ #

    def _owners_of(self, primes_list: Sequence[Tuple[int, ...]]
                   ) -> np.ndarray:
        """Vectorized chunk owner: single owning shard, else CROSS."""
        if not primes_list:
            return np.empty(0, np.int32)
        counts = np.fromiter((len(ps) for ps in primes_list), np.int64,
                             len(primes_list))
        flat = np.fromiter((q for ps in primes_list for q in ps), np.int64,
                           int(counts.sum()))
        owners = self.partition.owners(flat)
        out = np.full(len(primes_list), CROSS, np.int32)
        i = 0
        for j, c in enumerate(counts):
            seg = owners[i:i + c]
            i += c
            if c and bool((seg == seg[0]).all()):
                out[j] = seg[0]
        return out

    def _classify_tail(self, registry, arr: np.ndarray, lo: int) -> None:
        new_primes: List[Tuple[int, ...]] = []
        for pos in range(lo, arr.size):
            v = int(arr[pos])
            rel = registry.relationship_of_composite(v)
            if rel is None:                   # pragma: no cover - defensive
                new_primes.append(())
                continue
            # primes of THIS chunk — the ones recoverable from the value
            new_primes.append(tuple(q for q in sorted(rel.primes)
                                    if v % q == 0))
        self._primes.extend(new_primes)
        self._owner = np.concatenate(
            [self._owner, self._owners_of(new_primes)])

    def sync(self, registry) -> str:
        """Bring the index up to the registry's current version.

        Returns ``"noop"`` (already current), ``"append"`` (only the new
        tail was classified), or ``"rebuild"`` (in-place mutation —
        drops/unregisters — forced a full reclassification).
        """
        if self.version == registry.version:
            return "noop"
        arr = registry.composites_view()
        n_old = self._values.size
        if (arr.size >= n_old and n_old
                and np.array_equal(arr[:n_old], self._values)):
            mode = "append"
            self._values = arr.copy()
            self._classify_tail(registry, arr, n_old)
        else:
            mode = "rebuild" if n_old else "append"
            self._values = arr.copy()
            self._owner = np.empty(0, np.int32)
            self._primes = []
            self._classify_tail(registry, arr, 0)
        self.version = registry.version
        return mode

    # ------------------------------------------------------------------ #
    # exports for the sharded scan                                       #
    # ------------------------------------------------------------------ #

    def local(self) -> List[List[int]]:
        """Per-shard local position lists, ascending (= registry order)."""
        return [[int(p) for p in np.nonzero(self._owner == s)[0]]
                for s in range(self.partition.n_shards)]

    def cross(self) -> List[int]:
        return [int(p) for p in np.nonzero(self._owner == CROSS)[0]]

    # ------------------------------------------------------------------ #
    # elastic events                                                     #
    # ------------------------------------------------------------------ #

    def restripe(self, new_partition) -> ReshardPlan:
        """Re-own every cached entry under ``new_partition``; returns the
        migration plan (moved positions only — no registry re-read)."""
        if bool(np.any(self._owner == LOST)):
            raise RuntimeError("recover dead shards before resharding")
        old_owner = self._owner
        old_n = self.partition.n_shards
        self.partition = new_partition
        self._owner = self._owners_of(self._primes)
        moved = np.nonzero(self._owner != old_owner)[0]
        return ReshardPlan(
            n_old=old_n, n_new=new_partition.n_shards,
            total=int(old_owner.size),
            moved=tuple(int(p) for p in moved),
            dests=tuple(int(self._owner[p]) for p in moved))

    def forget_shard(self, shard: int) -> int:
        """Drop a dead shard's slice of the index (values survive — they
        are the replicated composite array; the *classification* dies).
        Returns the number of entries lost."""
        hit = np.nonzero(self._owner == shard)[0]
        self._owner[hit] = LOST
        for p in hit:
            self._primes[int(p)] = ()
        return int(hit.size)

    def recover(self, registry, device="cuda") -> Tuple[int, str]:
        """Rebuild lost entries purely by re-factorizing the surviving
        composite values through the factorization kernel on
        ``device``.

        If the registry mutated while the shard was dead (version or
        value drift), NO surviving classification is trusted: every
        position is re-factorized (mode ``"full"``); otherwise only the
        LOST positions are (mode ``"partial"``).  Returns
        ``(n_refactorized, mode)``.
        """
        from repro_torch.kernels.ops import factorize_batch_exact

        arr = registry.composites_view()
        stale = (self.version != registry.version
                 or arr.size != self._values.size
                 or not np.array_equal(arr, self._values))
        if stale:
            self._values = arr.copy()
            self._owner = np.full(arr.size, LOST, np.int32)
            self._primes = [()] * arr.size
            mode = "full"
        else:
            mode = "partial"
        lost = np.nonzero(self._owner == LOST)[0]
        if lost.size:
            pool = registry.primes_array()
            facs, residual = factorize_batch_exact(arr[lost], pool,
                                                   device=device)
            assert all(int(r) == 1 for r in residual), \
                "surviving composite escaped the prime pool (Theorem 1)"
            for pos, fs in zip(lost, facs):
                self._primes[int(pos)] = tuple(sorted(int(q) for q in fs))
            self._owner[lost] = self._owners_of(
                [self._primes[int(p)] for p in lost])
        self.version = registry.version
        return int(lost.size), mode

    # ------------------------------------------------------------------ #
    # verification                                                       #
    # ------------------------------------------------------------------ #

    def verify(self, registry) -> bool:
        """True iff the maintained index equals a from-scratch one."""
        fresh = ShardSlices(self.partition)
        fresh.sync(registry)
        return (bool(np.array_equal(fresh._owner, self._owner))
                and fresh._primes == self._primes)
