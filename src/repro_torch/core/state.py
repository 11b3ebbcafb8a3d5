"""PFCS state from plain arrays: the prime assignment and the composite
registry, rebuilt from numbers read out of another PFCS instance.

PFCS holds no weights; what it carries from one run to the next is the
data -> prime assignment (Algorithm 1), the prime pools it drew from,
and the composite registry.  :func:`state_from_arrays` rebuilds the
port's :class:`~repro_torch.core.assignment.PrimeAssigner` and
:class:`~repro_torch.core.composite.CompositeRegistry` from those
numbers, so the port can start from the state of any other instance
(``repro``'s included) and compute the same tables and kernel inputs on
it: the same composites in the same registry order, the same
relationship ids, and each ``Relationship.primes`` iterating in the
order given.  The access tracker and the host factorization cache start
empty; they decide no table, only later allocations of hot elements and
the factorizer's stage counts.
"""

from __future__ import annotations

import itertools
from typing import FrozenSet, Sequence, Tuple

import numpy as np

from .assignment import PrimeAssigner
from .composite import CompositeRegistry, Relationship, encode_relationship
from .primes import CacheLevel, HierarchicalPrimeAllocator

__all__ = ["state_from_arrays"]


def _frozenset_in_order(members: Sequence[int]) -> FrozenSet[int]:
    """A frozenset of ``members`` that iterates in exactly their order.

    Set iteration order follows the hash table, which depends on the
    order of insertion when hashes collide; the first insertion order
    (as given, reversed, then every permutation of a small set) that
    reproduces the wanted iteration order is used."""
    want = tuple(members)
    if len(set(want)) != len(want):
        raise ValueError(f"relationship members repeat: {want}")
    orders = itertools.chain([want, want[::-1]],
                             itertools.permutations(want)
                             if len(want) <= 7 else ())
    for order in orders:
        s = frozenset(order)
        if tuple(s) == want:
            return s
    raise ValueError(f"no frozenset iterates in the order {want}")


def state_from_arrays(*, data_ids, data_primes, data_levels, pool_next,
                      pool_free, rel_ids, rel_offsets, rel_members,
                      rel_weights, rel_kinds, composites, composite_rel,
                      next_rel_id: int, version: int = 0, epoch: int = 0,
                      max_bits: int = 62
                      ) -> Tuple[PrimeAssigner, CompositeRegistry]:
    """Build ``(assigner, registry)`` from plain arrays and ints.

    Assignment, in binding order: ``data_ids``, ``data_primes`` and
    ``data_levels`` (``(D,)`` each; a level is a ``CacheLevel``).
    Prime pools, one entry per level of ``CacheLevel.ALL``: ``pool_next``
    (how many primes each pool has handed out from its ascending cursor)
    and ``pool_free`` (the primes on each free-list).  Relationships, in
    registration order: ``rel_ids`` ``(R,)``, their member primes in
    iteration order as ``rel_members[rel_offsets[i]:rel_offsets[i+1]]``,
    ``rel_weights`` ``(R,)`` and ``rel_kinds`` (``R`` strings).  The
    registry: ``composites`` ``(N,)`` in registry order and
    ``composite_rel`` ``(N,)``, each composite's relationship id.
    ``next_rel_id``, ``version`` and ``epoch`` are the counters of the
    same names.  Raises ``ValueError`` when the arrays disagree (a
    composite that is not one of its relationship's chunks, a prime
    bound to two elements)."""
    registry = CompositeRegistry(max_bits=max_bits)
    offsets = np.asarray(rel_offsets, dtype=np.int64)
    members = np.asarray(rel_members, dtype=np.int64)
    ids = np.asarray(rel_ids, dtype=np.int64)
    if offsets.shape != (ids.size + 1,):
        raise ValueError(f"rel_offsets has shape {offsets.shape}, expected "
                         f"({ids.size + 1},)")
    for i, rid in enumerate(ids.tolist()):
        pset = _frozenset_in_order(
            members[offsets[i]:offsets[i + 1]].tolist())
        comps = tuple(encode_relationship(pset, max_bits))
        registry._by_id[rid] = Relationship(rid, pset, comps,
                                            str(rel_kinds[i]),
                                            float(rel_weights[i]))
        for p in pset:
            registry._prime_degree[p] = registry._prime_degree.get(p, 0) + 1
    for c, rid in zip(np.asarray(composites).tolist(),
                      np.asarray(composite_rel).tolist()):
        rel = registry._by_id.get(rid)
        if rel is None or c not in rel.composites:
            raise ValueError(f"composite {c} is not a chunk of relationship "
                             f"{rid}")
        registry._by_composite[c] = rid
    registry._next_id = int(next_rel_id)
    registry.version = int(version)

    allocator = HierarchicalPrimeAllocator()
    for level, n_next, free in zip(CacheLevel.ALL, pool_next, pool_free):
        pool = allocator.pools[level]
        n_next = int(n_next)
        if pool.hi is None and len(pool._primes) < n_next:
            pool._extend(n_next - len(pool._primes))
        free = [int(p) for p in free]
        pool._next_idx = n_next
        pool._free = free
        pool._allocated = set(pool._primes[:n_next]) - set(free)

    assigner = PrimeAssigner(allocator=allocator, registry=registry)
    for d, p, level in zip(np.asarray(data_ids).tolist(),
                           np.asarray(data_primes).tolist(),
                           np.asarray(data_levels).tolist()):
        if p in assigner._prime_to_data[level]:
            raise ValueError(f"prime {p} is bound twice at level {level}")
        assigner._data_to_prime[level][d] = p
        assigner._prime_to_data[level][p] = d
    assigner.epoch = int(epoch)
    return assigner, registry
