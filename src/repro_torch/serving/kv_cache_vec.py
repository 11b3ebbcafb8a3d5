"""Array-state paged KV cache: the vectorized twin of ``PagedKVCache``.

The scalar cache (``kv_cache.py``, kept in the tree as the bit-exact
oracle) manages HBM residency through a Python ``OrderedDict`` and runs
one §4.2 registry divisibility scan *per touched page* — the same
scalar bottleneck the trace-simulation engine removed from the
simulator (DESIGN.md §4).  This module applies the engine's recipe to
the serving hot path (DESIGN.md §5):

**Fixed-shape array page tables.**  HBM is ``hbm_pages`` slots of
parallel arrays — ``slot_page`` (int32 page id, ``EMPTY`` = -1),
``slot_t`` (int64 monotonic stamp; stamp order IS the oracle's
``OrderedDict`` order), ``slot_pf`` (bool, brought in by prefetch and
not yet demanded).  Per-page state is ``slot_of`` (page -> slot, -1
when not HBM-resident: O(1) hit detection) and ``in_host`` (host-tier
residency bitmap).  LRU eviction is one ``argmin`` over ``slot_t``;
because stamps are unique and strictly increasing, it selects exactly
the page the oracle's ``popitem(last=False)`` evicts.

**Table-driven bulk chain discovery.**  The oracle's per-touch registry
scan collapses to a precomputed successor table — ``(P, W)`` int32
candidate rows in the oracle's exact iteration order (registry order,
then ``rel.primes``), padded with -1 and deliberately keeping repeated
targets (the dynamic residency check at touch time skips them, exactly
as the oracle's does).  Three maintenance modes:

  * ``discover="incremental"`` (default) — chain-edge registration
    appends both endpoints to each other's rows in O(1); the touch path
    performs ZERO registry scans.
  * ``discover="host"`` / ``"kernel"`` — rows are rebuilt in ONE bulk
    :func:`repro_torch.core.engine.successor_table` call per registry
    change, at the next ``touch_batch``; ``"kernel"`` routes the scan +
    decode through the ``divisibility_scan`` / ``factorize_batch``
    kernels on ``device``.

All three produce bit-identical rows (``tests/test_serving.py``).

**Chain registry as composite arrays.**  Each request's page chain is
held as chunked int64 composite arrays (products of page primes, each
chunk < 2**62 — ``core.composite.encode_relationship``).  Shared-prefix
discovery between two requests is then a batched gcd over the chunk
cross-product (``repro_torch.kernels.ops.gcd_batch``) followed by one
``factorize_batch`` decode — exact by unique factorization: every
shared prime appears in exactly one chunk per side, so the union of
pairwise-gcd factors is exactly the shared page set (Theorem 1, zero
false sharing).

Every counter in ``PageStats`` (except ``registry_scans``, which counts
discovery *work* and differs by design) is bit-exact against the scalar
oracle under any interleaving of ``register_request`` / ``touch`` /
``touch_batch`` — enforced by ``tests/test_serving.py``.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from repro_torch.core.composite import encode_relationship
from repro_torch.core.engine.tables import successor_table
from repro_torch.kernels.ops import factorize_batch_exact, gcd_batch
from repro_torch.obs.trace import EV_PREFETCH

from .kv_cache import PagedKVCache

__all__ = ["VectorizedPagedKVCache"]

EMPTY = -1


class VectorizedPagedKVCache(PagedKVCache):
    """Drop-in ``PagedKVCache`` with array placement state and bulk
    discovery.  Page identity, prime assignment, and the chain/composite
    registry are shared with the oracle (``_init_identity``); only the
    placement structures and the discovery path change representation.
    """

    def __init__(self, hbm_pages: int = 1024, page_size: int = 16,
                 prefetch_budget: int = 4, discover: str = "incremental",
                 max_bits: int = 62, device="cuda"):
        if hbm_pages < 1:
            raise ValueError("hbm_pages must be >= 1")
        if discover not in ("incremental", "host", "kernel"):
            raise ValueError(f"discover must be 'incremental', 'host' or "
                             f"'kernel', got {discover!r}")
        self._init_identity(hbm_pages, page_size, prefetch_budget, max_bits,
                            device)
        self.discover = discover
        # HBM slot arrays (slot-array layout, DESIGN.md §5.1)
        s = hbm_pages
        self.slot_page = np.full((s,), EMPTY, dtype=np.int32)
        self.slot_t = np.zeros((s,), dtype=np.int64)
        self.slot_pf = np.zeros((s,), dtype=np.bool_)
        self._n_occupied = 0
        self._clock = 0
        # per-page arrays (grown on demand as pages are registered)
        self.slot_of = np.full((64,), EMPTY, dtype=np.int32)
        self.in_host = np.zeros((64,), dtype=np.bool_)
        # successor table: (P, W) candidate rows, -1 padded
        self._succ = np.full((64, 4), EMPTY, dtype=np.int32)
        self._succ_len = np.zeros((64,), dtype=np.int32)
        self._table_version = self.registry.version
        self.bulk_refreshes = 0
        # chain registry as composite arrays: request -> (int64 chunk
        # array, assigner epoch at build).  The epoch guards against
        # recycled primes: Algorithm-1 recycling can free a chain
        # page's prime and hand it to a NEW page, and a chunk array
        # built before the recycle would then gcd-match the new page's
        # chain — false sharing the scalar oracle (which reads primes
        # live) never reports.  A stale epoch forces a rebuild from the
        # live chain (regression-tested in tests/test_tenancy.py).
        self._chain_chunks: Dict[int, Tuple[np.ndarray, int]] = {}

    # ------------------------------------------------------------------ #
    # array growth                                                        #
    # ------------------------------------------------------------------ #

    def _ensure_pages(self, n: int) -> None:
        cur = self.slot_of.shape[0]
        if n <= cur:
            return
        new = max(n, 2 * cur)
        grow = new - cur
        self.slot_of = np.concatenate(
            [self.slot_of, np.full((grow,), EMPTY, dtype=np.int32)])
        self.in_host = np.concatenate(
            [self.in_host, np.zeros((grow,), dtype=np.bool_)])
        self._succ = np.concatenate(
            [self._succ, np.full((grow, self._succ.shape[1]), EMPTY,
                                 dtype=np.int32)])
        self._succ_len = np.concatenate(
            [self._succ_len, np.zeros((grow,), dtype=np.int32)])

    def _succ_append(self, page: int, succ: int) -> None:
        n = int(self._succ_len[page])
        if n == self._succ.shape[1]:                      # widen columns
            pad = np.full(self._succ.shape, EMPTY, dtype=np.int32)
            self._succ = np.concatenate([self._succ, pad], axis=1)
        self._succ[page, n] = succ
        self._succ_len[page] = n + 1

    # ------------------------------------------------------------------ #
    # registration (identity path shared with the oracle)                 #
    # ------------------------------------------------------------------ #

    def _register_chain_edges(self, pages: Sequence[int]
                              ) -> List[Tuple[int, int]]:
        self._ensure_pages(self._next_page)
        # incremental maintenance is only sound if the rows were current
        # when registration started; an out-of-band registry mutation
        # (e.g. Algorithm-1 prime recycling dropping relationships)
        # leaves the version mismatched, and fast-forwarding past it
        # would mask the drop — leave the table stale instead so the
        # next touch forces a bulk rebuild
        was_current = self.registry.version == self._table_version
        edges = super()._register_chain_edges(pages)
        if self.discover == "incremental" and was_current:
            # O(1) row maintenance: appending at edge-registration time
            # reproduces the oracle's candidate order exactly (registry
            # order IS registration order)
            for a, b in edges:
                self._succ_append(a, b)
                self._succ_append(b, a)
            self._table_version = self.registry.version
        return edges

    def register_request(self, req_id: int, tokens: Sequence[int]
                         ) -> List[int]:
        pages = super().register_request(req_id, tokens)
        self._build_chunks(req_id)
        return pages

    def _assigner_epoch(self) -> int:
        return getattr(self.assigner, "epoch", 0)

    def _build_chunks(self, req_id: int) -> np.ndarray:
        primes = [p for pid in self.chains.get(req_id, ())
                  if (p := self.assigner.prime_of(pid)) is not None]
        enc = encode_relationship(primes, self.registry.max_bits) \
            if primes else []
        chunks = np.asarray(enc, dtype=np.int64)
        self._chain_chunks[req_id] = (chunks, self._assigner_epoch())
        return chunks

    def _chunks_of(self, req_id: int) -> np.ndarray:
        """Live chunk array for a request — rebuilt when any prime
        release happened since it was cached (see ``_chain_chunks``)."""
        if req_id not in self.chains:
            return np.empty(0, dtype=np.int64)
        cached = self._chain_chunks.get(req_id)
        if cached is not None and cached[1] == self._assigner_epoch():
            return cached[0]
        return self._build_chunks(req_id)

    def release_request(self, req_id: int) -> None:
        super().release_request(req_id)
        self._chain_chunks.pop(req_id, None)

    # ------------------------------------------------------------------ #
    # bulk discovery table                                                #
    # ------------------------------------------------------------------ #

    def _sync_tables(self) -> None:
        """One bulk refresh when the registry changed since the last
        build (no-op in incremental mode, where rows are maintained at
        registration time)."""
        if self._table_version == self.registry.version:
            return
        self.refresh_tables()

    def refresh_tables(self, discover: Optional[str] = None) -> None:
        """Rebuild every successor row in ONE bulk discovery call
        (host replay or the discovery kernels)."""
        backend = discover or self.discover
        if backend == "incremental":
            backend = "host"   # bulk rebuild semantics == host replay
        rows = successor_table(self.registry, self.assigner,
                               range(self._next_page), discover=backend,
                               device=self.device)
        self._install_rows(rows)

    def _install_rows(self, rows: Dict[int, List[int]]) -> None:
        """Replace the whole successor table with freshly-built rows and
        stamp the registry version (shared by every bulk-rebuild
        backend, including the sharded one)."""
        self._succ.fill(EMPTY)
        self._succ_len.fill(0)
        for page, row in rows.items():
            for succ in row:
                self._succ_append(page, succ)
        self.bulk_refreshes += 1
        self._table_version = self.registry.version

    def successor_rows(self) -> Dict[int, List[int]]:
        """Current table as plain lists (tests/introspection)."""
        return {p: [int(x) for x in self._succ[p, :self._succ_len[p]]]
                for p in range(self._next_page) if self._succ_len[p]}

    # ------------------------------------------------------------------ #
    # placement (array state machine)                                     #
    # ------------------------------------------------------------------ #

    def _tick(self) -> int:
        t = self._clock
        self._clock += 1
        return t

    def _insert(self, pid: int, prefetched: bool) -> None:
        """Insert a non-resident page into HBM; evict-LRU-first when
        full (identical to the oracle's add-then-evict for capacity
        >= 1, since the newest entry is never the eviction argmin)."""
        self.in_host[pid] = False
        if self._n_occupied < self.hbm_capacity:
            s = self._n_occupied
            self._n_occupied += 1
        else:
            s = int(np.argmin(self.slot_t))       # unique stamps: exact LRU
            victim = int(self.slot_page[s])
            self.slot_of[victim] = EMPTY
            self.in_host[victim] = True
            self.stats.evictions += 1
            self._note_evict(victim)
        self.slot_page[s] = pid
        self.slot_of[pid] = s
        self.slot_t[s] = self._tick()
        self.slot_pf[s] = prefetched

    def _touch_one(self, pid: int) -> str:
        s = int(self.slot_of[pid])
        if s >= 0:
            was_pf = bool(self.slot_pf[s])
            self.slot_pf[s] = False
            self.slot_t[s] = self._tick()
            self.stats.hbm_hits += 1
            if was_pf:
                self.stats.prefetch_hits += 1
            tier = "hbm"
        elif self.in_host[pid]:
            self.stats.host_hits += 1
            self._insert(pid, False)
            tier = "host"
        else:
            self.stats.misses += 1
            self._insert(pid, False)
            tier = "new"
        self._prefetch_row(pid)
        return tier

    def _prefetch_row(self, pid: int) -> None:
        """Successor prefetch from the precomputed table — no registry
        scan, no factorization on the touch path."""
        budget = self.prefetch_budget
        if budget <= 0:
            return
        row = self._succ[pid, :self._succ_len[pid]]
        for succ in row:
            succ = int(succ)
            if self.slot_of[succ] >= 0:           # already HBM-resident
                continue
            if not (self._prefetch_allowed(pid, succ)
                    and self._can_insert(succ)):  # dedup hooks (base: True)
                continue
            self._insert(succ, True)
            self.stats.prefetches += 1
            self.prefetch_log.append((pid, succ))
            if self.obs is not None:
                self.obs.emit(EV_PREFETCH, page=pid, arg=succ)
            budget -= 1
            if budget <= 0:
                return

    def touch(self, req_id: int, page_idx: int) -> str:
        return self.touch_batch([(req_id, page_idx)])[0]

    def touch_batch(self, items: Sequence[Tuple[int, int]]) -> List[str]:
        """Demand-access a whole decode batch.  Discovery for the entire
        batch is table gathers (plus at most one bulk table refresh);
        placement applies in submission order, which is what keeps every
        counter bit-exact against the oracle's sequential ``touch``
        calls."""
        self._sync_tables()
        return [self._touch_one(self.chains[r][i]) for r, i in items]

    # ------------------------------------------------------------------ #
    # deterministic shared-prefix discovery (batched gcd kernel path)     #
    # ------------------------------------------------------------------ #

    def _shared_primes(self, gcds: np.ndarray,
                       pool: np.ndarray) -> Set[int]:
        """Decode pairwise chunk gcds into the shared prime set through
        the squarefree-factorization kernel."""
        gs = sorted({int(g) for g in gcds if int(g) > 1})
        if not gs:
            return set()
        facs, residual = factorize_batch_exact(gs, pool, device=self.device)
        assert all(int(r) == 1 for r in residual), \
            "chunk gcd escaped the chain pool"
        return {q for fs in facs for q in fs}

    def shared_prefix(self, req_a: int, req_b: int) -> List[int]:
        """Pages shared by two requests via batched gcd over the chunked
        chain composites — exact (unique factorization: each shared
        prime lives in exactly one chunk per side, so it appears in
        exactly one pairwise gcd)."""
        return self.shared_prefix_bulk([(req_a, req_b)])[(req_a, req_b)]

    def shared_prefix_bulk(self, pairs: Sequence[Tuple[int, int]]
                           ) -> Dict[Tuple[int, int], List[int]]:
        """Shared pages for many request pairs through ONE batched gcd
        call (all chunk cross-products concatenated), decoded by one
        squarefree-factorization call per pair."""
        blocks: List[Tuple[Tuple[int, int], np.ndarray, np.ndarray]] = []
        pools: List[List[int]] = []
        for ra, rb in pairs:
            ca, cb = self._chunks_of(ra), self._chunks_of(rb)
            blocks.append(((ra, rb), np.repeat(ca, cb.size),
                           np.tile(cb, ca.size)))
            pools.append([p for pid in self.chains.get(ra, [])
                          if (p := self.assigner.prime_of(pid)) is not None])
        flat_a = np.concatenate([a for _, a, _ in blocks]) if blocks \
            else np.empty(0, dtype=np.int64)
        flat_b = np.concatenate([b for _, _, b in blocks]) if blocks \
            else np.empty(0, dtype=np.int64)
        if not flat_a.size:
            gcds = np.empty(0, dtype=np.int64)
        else:
            gcds = gcd_batch(flat_a, flat_b, device=self.device)
        out: Dict[Tuple[int, int], List[int]] = {}
        lo = 0
        for ((ra, rb), aa, _), pool in zip(blocks, pools):
            g = gcds[lo:lo + aa.size]
            lo += aa.size
            shared = self._shared_primes(
                g, np.asarray(pool, dtype=np.int64)) if g.size else set()
            out[(ra, rb)] = sorted(
                pid for q in shared
                if (pid := self.assigner.data_of(int(q))) is not None)
        return out

    # ------------------------------------------------------------------ #
    # oracle-compatible views                                             #
    # ------------------------------------------------------------------ #

    @property
    def hbm(self) -> "OrderedDict[int, bool]":
        """HBM contents in exact LRU order (stamp order == the oracle's
        ``OrderedDict`` order) — read-only compatibility view."""
        order = np.argsort(self.slot_t[:self._n_occupied], kind="stable")
        return OrderedDict(
            (int(self.slot_page[s]), bool(self.slot_pf[s])) for s in order)

    @property
    def host(self) -> Set[int]:
        """Host-tier page set — read-only compatibility view."""
        return {int(p) for p in np.nonzero(self.in_host)[0]}
