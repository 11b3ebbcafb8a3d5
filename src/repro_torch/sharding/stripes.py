"""Shared block-striping partitioner: contiguous value blocks dealt
round-robin to parts.

Two subsystems carve the PFCS prime space into *contiguous value blocks
striped round-robin*: the mesh-sharded discovery layer
(``core.engine.shard.PrimeSpacePartition`` — blocks -> shards, DESIGN.md
§6.1) and the multi-tenant namespace layer
(``tenancy.namespace.TenantNamespace`` — blocks -> tenants, DESIGN.md
§8.1).  Both need the same three properties:

  * **contiguity** — neighbouring values share a block, so Algorithm 1's
    ascending allocation keeps factorization locality inside one owner;
  * **striping** — consecutive blocks rotate owners, so ownership stays
    balanced even though allocation is ascending;
  * **pure O(1) ownership** — ``owner(value)`` is arithmetic on the
    value alone (no directory, no coordination), so any holder of a
    prime can classify any composite locally.

This module is that machinery, extracted so the two layers share one
implementation (and one set of block-width caps) instead of diverging
copies.  Ownership here is over *values*; the prime-space semantics
(which values are prime, what a block means for isolation) live with
the callers.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np

__all__ = ["BlockStripes", "LEVEL_BLOCK_CAPS"]


#: per-level value-block width caps, sized so a block holds on the order
#: of 10-100 primes near the level's range start (prime gaps ~ ln p) —
#: ownership then stripes at the granularity real workloads allocate at,
#: instead of one part swallowing the whole ascending-allocation prefix.
#: Keyed by ``core.primes.CacheLevel`` ids (kept as plain ints here so
#: this module stays import-cycle-free).
LEVEL_BLOCK_CAPS: Dict[int, int] = {
    0: 64,        # L1
    1: 512,       # L2
    2: 4_096,     # L3
    3: 1 << 16,   # MEM
}


class BlockStripes:
    """Deterministic owner function: value -> part id.

    Each bounded level range ``(lo, hi)`` is split into contiguous value
    blocks of width ``min((hi - lo + 1) // (n_parts * stripes_per_part),
    cap)`` (caps per level, see ``LEVEL_BLOCK_CAPS``); block ``k``
    belongs to part ``k % n_parts``.  An unbounded range (``hi is
    None``) uses the fixed cap width.  ``n_parts == 1`` degenerates to
    "part 0 owns everything".
    """

    def __init__(self, n_parts: int,
                 ranges: Dict[int, Tuple[int, Optional[int]]],
                 caps: Optional[Dict[int, int]] = None,
                 stripes_per_part: int = 8):
        if n_parts < 1:
            raise ValueError("n_parts must be >= 1")
        if stripes_per_part < 1:
            raise ValueError("stripes_per_part must be >= 1")
        caps = caps or LEVEL_BLOCK_CAPS
        self.n_parts = int(n_parts)
        self.stripes_per_part = int(stripes_per_part)
        self.ranges = dict(ranges)
        self._blocks: Dict[int, Tuple[int, int]] = {}   # level -> (lo, width)
        for lvl, (lo, hi) in self.ranges.items():
            if hi is None:
                self._blocks[lvl] = (lo, caps[lvl])
            else:
                width = max(1, min(
                    (hi - lo + 1) // (self.n_parts * self.stripes_per_part),
                    caps[lvl]))
                self._blocks[lvl] = (lo, width)

    # ------------------------------------------------------------------ #

    def level_of(self, v: int) -> int:
        """Range containing value ``v`` (values in no declared range fall
        to the last — open-ended — level, like primes between ranges)."""
        last = None
        for lvl, (lo, hi) in self.ranges.items():
            if v >= lo and (hi is None or v <= hi):
                return lvl
            last = lvl
        return last

    def owner(self, v: int) -> int:
        """Part owning value ``v`` — pure function, O(1), no state."""
        if self.n_parts == 1:
            return 0
        lo, width = self._blocks[self.level_of(int(v))]
        return ((int(v) - lo) // width) % self.n_parts

    def owners(self, values: Sequence[int]) -> np.ndarray:
        """Vectorized ``owner`` over an int array (membership tests over
        whole registries / sieve segments in one shot)."""
        v = np.asarray(values, dtype=np.int64).reshape(-1)
        out = np.zeros(v.shape, dtype=np.int32)
        if self.n_parts == 1 or v.size == 0:
            return out
        assigned = np.zeros(v.shape, dtype=bool)
        last = None
        for lvl, (lo, hi) in self.ranges.items():
            m = (~assigned) & (v >= lo)
            if hi is not None:
                m &= v <= hi
            blo, width = self._blocks[lvl]
            out[m] = ((v[m] - blo) // width) % self.n_parts
            assigned |= m
            last = lvl
        if not assigned.all():                 # gap values -> last level
            blo, width = self._blocks[last]
            m = ~assigned
            out[m] = ((v[m] - blo) // width) % self.n_parts
        return out

    def block_of(self, lvl: int) -> Tuple[int, int]:
        """(lo, width) of a level's block grid (introspection)."""
        return self._blocks[lvl]

    def describe(self) -> str:
        parts = [f"level{lvl}:block={w}"
                 for lvl, (_, w) in sorted(self._blocks.items())]
        return (f"BlockStripes(n_parts={self.n_parts}, "
                f"stripes={self.stripes_per_part}, {', '.join(parts)})")
