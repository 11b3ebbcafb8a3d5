"""Array-state MoE expert cache: the vectorized twin of ``ExpertCache``
(port of ``repro.serving.expert_cache_vec``).

The scalar cache (``expert_cache.py``, kept in the tree as the bit-exact
oracle) manages HBM expert residency through a Python ``OrderedDict``
and runs one §4.2 registry divisibility scan *per activated expert* —
the same scalar bottleneck the paged-KV twin removed from the serving
hot path.  This module applies the identical recipe to expert
co-activation:

**Fixed-shape array residency.**  HBM is ``hbm_slots`` slots of parallel
arrays — ``slot_expert`` (int32 expert id, ``EMPTY`` = -1), ``slot_t``
(int64 monotonic stamp; stamp order IS the oracle's ``OrderedDict``
order), ``slot_pf`` (bool, prefetched and not yet demanded).  Because
the expert universe is fixed at construction, the per-element side is a
single static ``slot_of`` int32 array (expert -> slot, -1 when the
weights live on the host: O(1) residency checks, no growth path).  LRU
eviction is one ``argmin`` over ``slot_t``; unique strictly-increasing
stamps make it select exactly the expert the oracle's
``popitem(last=False)`` evicts.

**Table-driven bulk co-fire discovery.**  The oracle's per-activation
registry scan collapses to a precomputed co-fire table — ``(E, W)``
int32 candidate rows in the oracle's exact iteration order (registry
order, then ``rel.primes``), padded with -1 and deliberately keeping
repeated targets (the dynamic residency check at activation time skips
them, exactly as the oracle's does).  Three maintenance modes, shared
with the paged-KV twin through
:func:`repro_torch.core.engine.successor_table`:

  * ``discover="incremental"`` (default) — group registration appends
    every member to every co-member's row in O(group²); the activation
    path performs ZERO registry scans.
  * ``discover="host"`` / ``"kernel"`` — rows are rebuilt in ONE bulk
    :func:`repro_torch.core.engine.successor_table` call per registry
    change, at the next ``activate_batch``; ``"kernel"`` routes the scan
    + decode through the ``divisibility_scan`` / ``factorize_batch``
    kernels (the flat mask and squarefree factorization) over the
    registry's chunked int64 composite arrays, on the cache's
    ``device``.

All three produce bit-identical rows (``tests/test_torch_moe.py``).
Co-activation groups live in the shared ``CompositeRegistry`` as chunked
int64 composite arrays (``encode_relationship``; a ``max_group`` top-k
set of L2 expert primes spans several < 2**62 chunks), which is exactly
the array the kernel backend scans.

Every ``ExpertCacheStats`` counter (except ``registry_scans``, which
counts discovery *work* and differs by design), every per-expert tier,
the HBM LRU order, and the prefetch log are bit-exact against the
scalar oracle under any interleaving of ``observe_routing`` /
``activate`` / ``activate_batch`` — enforced by the differential fuzz
suite in ``tests/test_torch_moe.py`` against the reference.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core.engine.tables import successor_table

from .expert_cache import ExpertCache

__all__ = ["VectorizedExpertCache"]

EMPTY = -1


class VectorizedExpertCache(ExpertCache):
    """Drop-in ``ExpertCache`` with array placement state and bulk
    co-fire discovery.  Expert identity, prime assignment, and the
    co-activation registry are shared with the oracle
    (``_init_identity``); only the placement structures and the
    discovery path change representation.
    """

    def __init__(self, n_experts: int, hbm_slots: int,
                 prefetch_budget: int = 4, max_group: int = 8,
                 discover: str = "incremental", device="cuda"):
        if discover not in ("incremental", "host", "kernel"):
            raise ValueError(f"discover must be 'incremental', 'host' or "
                             f"'kernel', got {discover!r}")
        self._init_identity(n_experts, hbm_slots, prefetch_budget, max_group,
                            device)
        self.discover = discover
        # HBM slot arrays
        s = hbm_slots
        self.slot_expert = np.full((s,), EMPTY, dtype=np.int32)
        self.slot_t = np.zeros((s,), dtype=np.int64)
        self.slot_pf = np.zeros((s,), dtype=np.bool_)
        self._n_occupied = 0
        self._clock = 0
        # per-expert residency (static shape: the universe is fixed)
        self.slot_of = np.full((n_experts,), EMPTY, dtype=np.int32)
        # co-fire table: (E, W) candidate rows, -1 padded
        self._succ = np.full((n_experts, max(4, max_group)), EMPTY,
                             dtype=np.int32)
        self._succ_len = np.zeros((n_experts,), dtype=np.int32)
        self._table_version = self.registry.version
        self.bulk_refreshes = 0

    # ------------------------------------------------------------------ #
    # co-fire table maintenance                                           #
    # ------------------------------------------------------------------ #

    def _succ_append(self, e: int, succ: int) -> None:
        n = int(self._succ_len[e])
        if n == self._succ.shape[1]:                      # widen columns
            pad = np.full(self._succ.shape, EMPTY, dtype=np.int32)
            self._succ = np.concatenate([self._succ, pad], axis=1)
        self._succ[e, n] = succ
        self._succ_len[e] = n + 1

    def observe_routing(self, expert_sets) -> List:
        # incremental maintenance is only sound if the rows were current
        # when registration started; an out-of-band registry mutation
        # (e.g. Algorithm-1 prime recycling dropping relationships)
        # leaves the version mismatched, and fast-forwarding past it
        # would mask the drop — leave the table stale instead so the
        # next activation forces a bulk rebuild
        was_current = self.registry.version == self._table_version
        new = super().observe_routing(expert_sets)
        if self.discover == "incremental" and was_current:
            # O(group²) row maintenance at registration time reproduces
            # the oracle's candidate order exactly: appending in
            # registration order IS registry order, and the inner walk
            # follows the same ``rel.primes`` iteration the oracle's
            # scan expands
            for rel in new:
                members = [(q, self.assigner.data_of(q))
                           for q in rel.primes]
                for q, e in members:
                    if e is None:
                        continue
                    for r, other in members:
                        if r == q or other is None:
                            continue
                        self._succ_append(e, other)
            self._table_version = self.registry.version
        return new

    def _sync_tables(self) -> None:
        """One bulk refresh when the registry changed since the last
        build (no-op in incremental mode, where rows are maintained at
        registration time)."""
        if self._table_version == self.registry.version:
            return
        self.refresh_tables()

    def refresh_tables(self, discover: Optional[str] = None) -> None:
        """Rebuild every co-fire row in ONE bulk discovery call (host
        replay or the discovery kernels on ``device`` over the chunked
        composite arrays)."""
        backend = discover or self.discover
        if backend == "incremental":
            backend = "host"   # bulk rebuild semantics == host replay
        rows = successor_table(self.registry, self.assigner,
                               range(self.n_experts), discover=backend,
                               device=self.device)
        self._succ.fill(EMPTY)
        self._succ_len.fill(0)
        for e, row in rows.items():
            for succ in row:
                self._succ_append(e, succ)
        self.bulk_refreshes += 1
        self._table_version = self.registry.version

    def successor_rows(self) -> Dict[int, List[int]]:
        """Current co-fire table as plain lists (tests/introspection)."""
        return {e: [int(x) for x in self._succ[e, :self._succ_len[e]]]
                for e in range(self.n_experts) if self._succ_len[e]}

    # ------------------------------------------------------------------ #
    # placement (array state machine)                                     #
    # ------------------------------------------------------------------ #

    def _tick(self) -> int:
        t = self._clock
        self._clock += 1
        return t

    def _insert(self, e: int, prefetched: bool) -> None:
        """Insert a non-resident expert into HBM; evict-LRU-first when
        full (identical to the oracle's add-then-evict for capacity
        >= 1, since the newest entry is never the eviction argmin)."""
        if self._n_occupied < self.hbm_slots:
            s = self._n_occupied
            self._n_occupied += 1
        else:
            s = int(np.argmin(self.slot_t))       # unique stamps: exact LRU
            victim = int(self.slot_expert[s])
            self.slot_of[victim] = EMPTY
            self.stats.evictions += 1
        self.slot_expert[s] = e
        self.slot_of[e] = s
        self.slot_t[s] = self._tick()
        self.slot_pf[s] = prefetched

    def _activate_one(self, experts: Sequence[int]) -> Dict[int, str]:
        tiers: Dict[int, str] = {}
        for e in experts:
            e = int(e)
            s = int(self.slot_of[e])
            if s >= 0:
                was_pf = bool(self.slot_pf[s])
                self.slot_pf[s] = False
                self.slot_t[s] = self._tick()
                self.stats.hits += 1
                if was_pf:
                    self.stats.prefetch_hits += 1
                tiers[e] = "hbm"
            else:
                self.stats.misses += 1
                self._insert(e, False)
                tiers[e] = "host"
        for e in experts:
            self._prefetch_row(int(e))
        return tiers

    def _prefetch_row(self, e: int) -> None:
        """Co-fire prefetch from the precomputed table — no registry
        scan, no factorization on the activation path."""
        budget = self.prefetch_budget
        if budget <= 0:
            return
        row = self._succ[e, :self._succ_len[e]]
        for succ in row:
            succ = int(succ)
            if self.slot_of[succ] >= 0:           # already HBM-resident
                continue
            self._insert(succ, True)
            self.stats.prefetches += 1
            self.prefetch_log.append((e, succ))
            budget -= 1
            if budget <= 0:
                return

    def activate(self, experts: Sequence[int]) -> Dict[int, str]:
        return self.activate_batch([experts])[0]

    def activate_batch(self, expert_sets: Sequence[Sequence[int]]
                       ) -> List[Dict[int, str]]:
        """Activate a whole decode step's router output.  Discovery for
        the entire batch is table gathers (plus at most one bulk table
        refresh); placement applies in submission order, which is what
        keeps every counter bit-exact against the oracle's sequential
        ``activate`` calls."""
        self._sync_tables()
        return [self._activate_one(s) for s in expert_sets]

    # ------------------------------------------------------------------ #
    # oracle-compatible views                                             #
    # ------------------------------------------------------------------ #

    @property
    def hbm(self) -> "OrderedDict[int, bool]":
        """HBM contents in exact LRU order (stamp order == the oracle's
        ``OrderedDict`` order) — read-only compatibility view."""
        order = np.argsort(self.slot_t[:self._n_occupied], kind="stable")
        return OrderedDict(
            (int(self.slot_expert[s]), bool(self.slot_pf[s]))
            for s in order)
