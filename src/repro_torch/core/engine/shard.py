"""Prime-space partitioned PFCS discovery (port of
``repro.core.engine.shard``, flat registries).

**Prime-space partition.**  :class:`PrimeSpacePartition` carves every
cache level's prime range (``core.primes.LEVEL_PRIME_RANGES``) into
contiguous value blocks dealt round-robin to shards: each shard owns a
striped family of contiguous prime ranges.  Contiguity keeps each
block's factorization locality (neighbouring chain pages get
neighbouring primes under Algorithm 1's ascending allocation); striping
keeps ownership balanced even though allocation is ascending.  Ownership
is a pure O(1) function of the prime value — no directory, no
coordination — so every shard can classify any composite locally.

**Sharded registry classification.**  A relationship whose member
primes all fall in one shard's ranges is *shard-local*: its composite
chunks live only in that shard's registry slice and are scanned only
there.  A relationship straddling prime ranges (a chain edge whose two
page primes have different owners) is *cross-shard*: its chunks go to
the exchanged slice that every shard scans.  Classification preserves
the global registry (registration) order — the candidate-order contract
the serving cache's parity tests pin down.

**Per-shard bulk discovery.**  Successor rows are rebuilt per shard
through the divisibility-mask kernel: every shard scans its own
registry slice against its own query primes.  Cross-shard relationships
are resolved by a batched-gcd exchange: each shard computes the gcd of
its *query chunk products* (its owned query primes packed into < 2**62
composites) against every cross-shard composite.  A gcd > 1 decodes —
exactly, by unique factorization, through the squarefree-factorization
kernel — to the member primes the shard owns, so no per-query modulo
scan ever crosses shard boundaries.

Wide registries (``max_bits > 63``) run the same recipe on
``(.., L)`` limb rows through the limb kernels: the query chunks are
packed at the registry's own width, and the gcd exchange rebuilds each
gcd from the shard's deduplicated query primes (the primes its chunks
are made of).

This slice runs every shard on one device, as a per-shard loop over the
kernels — the path ``repro`` takes on a host with fewer devices than
shards, and bit-identical to its ``shard_map`` path.  The multi-device
exchange (``torch.distributed``) is still to port (ROADMAP.md A.8).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.obs.profile import kernel_scope
from repro_torch.sharding.stripes import BlockStripes

from ..composite import encode_relationship, limbs_to_int, pack_limbs
from ..primes import CacheLevel, LEVEL_PRIME_RANGES

__all__ = ["PrimeSpacePartition", "shard_mesh", "sharded_successor_table",
           "ShardScanReport"]


class PrimeSpacePartition:
    """Deterministic owner function: prime value -> shard id.

    Each bounded level range ``(lo, hi)`` is split into contiguous value
    blocks of width ``min((hi - lo + 1) // (n_shards * stripes_per_shard),
    cap)``; block ``k`` belongs to shard ``k % n_shards``.  The unbounded
    MEM range uses the fixed cap width.  ``n_shards == 1`` degenerates to
    "shard 0 owns everything" (the single-device mesh case).

    The block machinery itself — contiguous value blocks, round-robin
    striping, per-level width caps, vectorized ownership — is the shared
    :class:`repro_torch.sharding.stripes.BlockStripes` partitioner.
    """

    def __init__(self, n_shards: int, stripes_per_shard: int = 8):
        self.stripes = BlockStripes(n_shards, LEVEL_PRIME_RANGES,
                                    stripes_per_part=stripes_per_shard)
        self.n_shards = self.stripes.n_parts
        self.stripes_per_shard = self.stripes.stripes_per_part
        self._blocks: Dict[int, Tuple[int, int]] = self.stripes._blocks

    def _level_of(self, p: int) -> int:
        return self.stripes.level_of(p)

    def owner(self, p: int) -> int:
        """Shard owning prime ``p`` — pure function, O(1), no state."""
        return self.stripes.owner(p)

    def owners(self, primes: Sequence[int]) -> np.ndarray:
        return self.stripes.owners(primes)

    def classify(self, registry) -> Tuple[List[List[int]], List[int]]:
        """Split the live registry into per-shard-local and cross-shard
        composite *positions* (indices into ``registry.composites_array()``
        — global registration order, which both scan paths preserve).

        A relationship is local to shard ``s`` iff every member prime is
        owned by ``s``; otherwise every chunk of it is cross-shard.
        """
        arr = registry.composites_view()
        local: List[List[int]] = [[] for _ in range(self.n_shards)]
        cross: List[int] = []
        for pos in range(arr.size):
            rel = registry.relationship_of_composite(int(arr[pos]))
            if rel is None:                       # pragma: no cover - defensive
                continue
            owners = {self.owner(q) for q in rel.primes}
            if len(owners) == 1:
                local[owners.pop()].append(pos)
            else:
                cross.append(pos)
        return local, cross

    def describe(self) -> str:
        parts = [f"{CacheLevel.NAMES[lvl]}:block={w}"
                 for lvl, (_, w) in sorted(self._blocks.items())]
        return (f"PrimeSpacePartition(n_shards={self.n_shards}, "
                f"stripes={self.stripes_per_shard}, {', '.join(parts)})")


def shard_mesh(n_shards: int):
    """The device mesh for ``n_shards`` shards, or ``None`` when the
    shards run as a loop on one device.  The port has no multi-device
    exchange yet (ROADMAP.md A.8), so this is always ``None`` — the case
    ``repro`` takes when the host exposes fewer devices than shards."""
    if n_shards < 1:
        raise ValueError("n_shards must be >= 1")
    return None


def _pad_rows(rows: Sequence[np.ndarray], mult: int, fill: int,
              dtype=np.int64) -> np.ndarray:
    """Stack ragged 1-D arrays into (S, W), W bucketed to ``mult * 2**k``
    — power-of-two buckets bound the number of distinct compiled shapes
    as tables grow across refreshes."""
    need = max([r.shape[0] for r in rows] + [1])
    width = mult
    while width < need:
        width *= 2
    out = np.full((len(rows), width), fill, dtype=dtype)
    for i, r in enumerate(rows):
        out[i, :r.shape[0]] = r
    return out


@dataclass
class ShardScanReport:
    """Per-refresh work split (benchmark / introspection output)."""

    n_shards: int = 0
    used_shard_map: bool = False
    local_composites: List[int] = field(default_factory=list)
    cross_composites: int = 0
    queries_per_shard: List[int] = field(default_factory=list)
    gcd_pairs: int = 0


def _check_stacks(**stacks: np.ndarray) -> None:
    for name, arr in stacks.items():
        if arr.size and int(arr.min()) < 0:
            raise ValueError(f"{name} stack holds a negative value")


def _up(x: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x, dtype=np.int64)
                            ).to(device)


def _one_shard_scan(lc: torch.Tensor, qs: torch.Tensor, ck: torch.Tensor,
                    gathered_cross: torch.Tensor, *, n_chunks: int):
    """One shard's kernel work: local divisibility mask + cross gcds."""
    from repro_torch.kernels.factorize import divisibility_mask
    from repro_torch.kernels.gcd import gcd

    mask = divisibility_mask(lc, qs)
    # batched-gcd exchange: every query chunk x every cross composite
    x = gathered_cross.shape[0]
    g = gcd(ck.repeat_interleave(x), gathered_cross.repeat(n_chunks))
    return mask, g.reshape(n_chunks, x)


def _scan_sharded(local_c: np.ndarray, queries: np.ndarray,
                  chunks: np.ndarray, cross_c: np.ndarray,
                  device) -> Tuple[np.ndarray, np.ndarray]:
    """The per-shard kernel work: local divisibility masks + cross gcds.

    Inputs are (S, *) padded int64 stacks; returns ``(local_mask (S, C,
    Q), gcds (S, K, X))``.  Every shard runs in turn on ``device``
    against the whole cross-shard slice (what the all-gather of the
    multi-device path would hand each shard)."""
    _check_stacks(local=local_c, queries=queries, chunks=chunks,
                  cross=cross_c)
    S, C = local_c.shape
    K = chunks.shape[1]
    with kernel_scope("sharded_gcd_exchange", items=S * C):
        lc, qs, ck = (_up(x, device) for x in (local_c, queries, chunks))
        gathered = _up(cross_c.reshape(-1), device)
        masks, gs = [], []
        for s in range(S):
            m, g = _one_shard_scan(lc[s], qs[s], ck[s], gathered,
                                   n_chunks=K)
            masks.append(m)
            gs.append(g)
        return (torch.stack(masks).cpu().numpy(),
                torch.stack(gs).cpu().numpy())


# --------------------------------------------------------------------------- #
# multi-limb twin of the shard scan (wide registries)                          #
# --------------------------------------------------------------------------- #

def _pad_limb_stack(rows: Sequence[np.ndarray], mult: int, L: int,
                    width: Optional[int] = None) -> np.ndarray:
    """Stack ragged (n_i, L) limb matrices into (S, W, L); pad rows encode
    composite value 1 (match nothing) and W is bucketed to ``mult * 2**k``
    like :func:`_pad_rows`."""
    need = max([r.shape[0] for r in rows] + [1])
    if width is None:
        width = mult
        while width < need:
            width *= 2
    out = np.zeros((len(rows), width, L), dtype=np.int64)
    out[:, :, 0] = 1
    for i, r in enumerate(rows):
        if r.shape[0]:
            out[i, :r.shape[0], :] = r
    return out


def _one_shard_scan_limbs(lc: torch.Tensor, qs: torch.Tensor,
                          ck: torch.Tensor, pool: torch.Tensor,
                          gathered_cross: torch.Tensor, *, n_chunks: int):
    """One shard's limb-kernel work: local divisibility mask + cross gcds
    (the recipe of :func:`_one_shard_scan` on (.., L) limb rows; the gcd
    pool is the shard's own deduplicated, zero-padded query primes, which
    cover every common factor of its chunks)."""
    from repro_torch.kernels.factorize import divisibility_mask_limbs
    from repro_torch.kernels.gcd import gcd_limbs

    mask = divisibility_mask_limbs(lc, qs)
    x, L = gathered_cross.shape
    g = gcd_limbs(ck.repeat_interleave(x, dim=0),        # (K*X, L)
                  gathered_cross.repeat(n_chunks, 1), pool)
    return mask, g.reshape(n_chunks, x, L)


def _scan_sharded_limbs(local_c: np.ndarray, queries: np.ndarray,
                        chunks: np.ndarray, pools: np.ndarray,
                        cross_c: np.ndarray,
                        device) -> Tuple[np.ndarray, np.ndarray]:
    """Wide twin of :func:`_scan_sharded`: (S, C, L) local limb stacks,
    (S, K, L) query-chunk limbs, (S, X, L) cross slices and (S, P) gcd
    pools; returns ``(local_mask (S, C, Q), gcd limbs (S, K, X, L))``."""
    _check_stacks(local=local_c, queries=queries, chunks=chunks,
                  pools=pools, cross=cross_c)
    S, C, L = local_c.shape
    K = chunks.shape[1]
    with kernel_scope("sharded_gcd_exchange_limbs", items=S * C):
        lc, qs, ck, pl = (_up(x, device) for x in (local_c, queries, chunks,
                                                   pools))
        gathered = _up(cross_c.reshape(-1, L), device)
        masks, gs = [], []
        for s in range(S):
            m, g = _one_shard_scan_limbs(lc[s], qs[s], ck[s], pl[s],
                                         gathered, n_chunks=K)
            masks.append(m)
            gs.append(g)
        return (torch.stack(masks).cpu().numpy(),
                torch.stack(gs).cpu().numpy())


def sharded_successor_table(registry, assigner, data_ids: Sequence[int],
                            partition: PrimeSpacePartition,
                            mesh=None,
                            report: Optional[ShardScanReport] = None,
                            precomputed: Optional[Tuple[List[List[int]],
                                                        List[int]]] = None,
                            device="cuda",
                            ) -> Dict[int, List[int]]:
    """Partitioned twin of :func:`repro_torch.core.engine.successor_table`.

    Produces BIT-IDENTICAL rows (same candidates, same order — global
    registry order, deduplicated by relationship, expanded in
    ``rel.primes`` order) while splitting the scan work by prime
    ownership: each shard's divisibility scan touches only its local
    registry slice, and only cross-shard relationships ride the gcd
    exchange.

    ``precomputed`` optionally supplies the ``(local_pos, cross_pos)``
    registry split instead of the O(registry)
    :meth:`PrimeSpacePartition.classify` walk.  ``mesh`` must be ``None``
    (the shards run in turn on ``device``) until the multi-device
    exchange is ported.
    """
    dev = resolve_device(device)
    if mesh is not None:
        raise NotImplementedError("a multi-device mesh is not ported yet "
                                  "(ROADMAP.md A.8)")
    from repro_torch.kernels.ops import factorize_batch_exact

    S = partition.n_shards
    wide = getattr(registry, "wide", False)
    keyed = [(int(d), p) for d in data_ids
             if (p := assigner.prime_of(int(d))) is not None]
    arr = registry.composites_view()
    if arr.size == 0 or not keyed:
        return {d: [] for d, _ in keyed}

    # ---- partition state: registry slices and query routing ------------- #
    if precomputed is not None:
        local_pos, cross_pos = precomputed
    else:
        local_pos, cross_pos = partition.classify(registry)
    by_shard: List[List[Tuple[int, int]]] = [[] for _ in range(S)]
    for d, p in keyed:
        by_shard[partition.owner(p)].append((d, p))

    queries = _pad_rows([np.asarray([p for _, p in sh], dtype=np.int64)
                         for sh in by_shard], 512, 0)
    # query chunk products: each shard's owned query primes packed into
    # < 2**max_bits composites (2**62 when narrow) — the gcd exchange
    # payload (one wide chunk usually covers a shard's whole query set)
    chunk_bits = registry.max_bits if wide else 62
    chunk_vals: List[List[int]] = []
    for sh in by_shard:
        ps = {p for _, p in sh}
        chunk_vals.append(encode_relationship(ps, chunk_bits) if ps else [])
    # per-shard cross-slice width bucketed to powers of two, like every
    # other stack (the shapes the multi-device path compiles for)
    need = -(-max(len(cross_pos), 1) // S)
    per = 8
    while per < need:
        per *= 2

    # ---- kernel work ----------------------------------------------------- #
    if wide:
        limbs = registry.limbs_array()
        Lw = registry.n_limbs
        local_c = _pad_limb_stack(
            [limbs[np.asarray(pos, dtype=np.int64)]
             if pos else np.empty((0, Lw), np.int64)
             for pos in local_pos], 256, Lw)
        chunks = _pad_limb_stack([pack_limbs(cv, Lw) for cv in chunk_vals],
                                 1, Lw)
        # the gcd-reconstruction pool: each shard's deduplicated query
        # primes (zero-padded) — exactly the primes its chunks contain
        pools = _pad_rows([np.asarray(sorted({p for _, p in sh}),
                                      dtype=np.int64) for sh in by_shard],
                          512, 0)
        cross_limbs = (limbs[np.asarray(cross_pos, dtype=np.int64)]
                       if cross_pos else np.empty((0, Lw), np.int64))
        cross_sh = _pad_limb_stack(
            [cross_limbs[s * per:(s + 1) * per] for s in range(S)],
            1, Lw, width=per)
        mask, gcds = _scan_sharded_limbs(local_c, queries, chunks, pools,
                                         cross_sh, dev)
        n_gcd_pairs = int(chunks.shape[1] * S * per)
    else:
        local_c = _pad_rows([arr[np.asarray(pos, dtype=np.int64)]
                             if pos else np.empty(0, np.int64)
                             for pos in local_pos], 256, 1)
        chunks = _pad_rows([np.asarray(cv, dtype=np.int64)
                            for cv in chunk_vals], 1, 1)
        cross_arr = (arr[np.asarray(cross_pos, dtype=np.int64)]
                     if cross_pos else np.empty(0, np.int64))
        cross_sh = np.ones((S, per), dtype=np.int64)
        for s in range(S):
            sl = cross_arr[s * per:(s + 1) * per]
            cross_sh[s, :sl.shape[0]] = sl
        mask, gcds = _scan_sharded(local_c, queries, chunks, cross_sh, dev)
        n_gcd_pairs = int(chunks.shape[1] * cross_sh.size)

    if report is not None:
        report.n_shards = S
        report.used_shard_map = False
        report.local_composites = [len(p) for p in local_pos]
        report.cross_composites = len(cross_pos)
        report.queries_per_shard = [len(sh) for sh in by_shard]
        report.gcd_pairs = n_gcd_pairs

    # ---- decode the gcd exchange: which cross composites contain which
    # owned query primes (exact — unique factorization) ------------------- #
    cross_of_prime: Dict[int, List[int]] = {}
    for s in range(S):
        if not by_shard[s] or not cross_pos:
            continue
        pool = np.asarray(sorted({p for _, p in by_shard[s]}), dtype=np.int64)
        gs = gcds[s]                        # (K, X) or (K, X, L) limb rows
        if wide:
            # value > 1 iff limb 0 > 1 or any higher limb is nonzero
            hit_k, hit_x = np.nonzero((gs[..., 0] > 1)
                                      | (gs[..., 1:] != 0).any(axis=-1))
        else:
            hit_k, hit_x = np.nonzero(gs > 1)
        valid = hit_x < len(cross_pos)      # drop padding columns
        hit_k, hit_x = hit_k[valid], hit_x[valid]
        hit_vals = [limbs_to_int(gs[k, x]) if wide else int(gs[k, x])
                    for k, x in zip(hit_k, hit_x)]
        uniq = sorted(set(hit_vals))
        if not uniq:
            continue
        facs, residual = factorize_batch_exact(uniq, pool, device=dev)
        assert all(int(r) == 1 for r in residual), \
            "gcd escaped the shard's query pool"
        fac_of = {g: fs for g, fs in zip(uniq, facs)}
        for x, v in zip(hit_x, hit_vals):
            for q in fac_of[v]:
                cross_of_prime.setdefault(int(q), []).append(int(x))

    # ---- assemble rows in the oracle's exact order ---------------------- #
    out: Dict[int, List[int]] = {}
    for s in range(S):
        pos_map = local_pos[s]
        for col, (d, p) in enumerate(by_shard[s]):
            hits = [pos_map[i] for i in np.nonzero(mask[s, :len(pos_map),
                                                        col])[0]]
            hits.extend(cross_pos[x] for x in cross_of_prime.get(p, ()))
            row: List[int] = []
            seen: set = set()
            for pos in sorted(hits):        # ascending == registry order
                rel = registry.relationship_of_composite(int(arr[pos]))
                if rel is None or rel.rel_id in seen:
                    continue
                seen.add(rel.rel_id)
                for q in rel.primes:        # oracle's frozenset order
                    if q == p:
                        continue
                    succ = assigner.data_of(q)
                    if succ is not None:
                        row.append(succ)
            out[d] = row
    return out
