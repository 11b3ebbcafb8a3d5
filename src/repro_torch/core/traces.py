"""Workload trace generators (PFCS §6.1 workload diversity).

Each generator returns a :class:`Trace`: an access sequence over integer
keys plus the *ground-truth relationship groups* that exist in the
workload (FK edges, co-accessed feature rows, correlated instruments).
PFCS registers these relationships when they are established (the
database knows its FK constraints; the trainer knows its batch
composition; the trading system knows its correlation graph) and must
*re-discover* them deterministically at access time via factorization.
Baselines see only the raw access stream; the semantic baseline sees a
noisy approximation of the relationship graph.

Generators (mapped to the paper's §6 workloads):

  * ``db_join_trace``    — TPC-C/H-like order->customer->item FK joins
  * ``ml_epoch_trace``   — minibatch training epochs with shared feature rows
  * ``hft_trace``        — correlated-instrument market data bursts
  * ``zipf_trace``       — skewed key-value (web/CDN) traffic, no relationships
  * ``scan_trace``       — sequential scans (worst case for LRU)
  * ``graph_walk_trace`` — tunable relationship density (Fig. 2a x-axis)

All generators are deterministic given ``seed``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Sequence, Tuple

import numpy as np

__all__ = [
    "Trace", "db_join_trace", "ml_epoch_trace", "hft_trace",
    "zipf_trace", "scan_trace", "graph_walk_trace", "TRACES",
]


@dataclass
class Trace:
    name: str
    accesses: np.ndarray                     # (T,) int64 key per demand access
    relationships: List[Tuple[int, ...]]     # ground-truth related key groups
    n_keys: int
    meta: Dict = field(default_factory=dict)

    def __post_init__(self):
        self.accesses = np.asarray(self.accesses, dtype=np.int64)

    @property
    def length(self) -> int:
        return int(self.accesses.shape[0])

    def related_map(self) -> Dict[int, set]:
        """key -> set of truly-related keys (for prefetch precision)."""
        m: Dict[int, set] = {}
        for grp in self.relationships:
            for k in grp:
                m.setdefault(int(k), set()).update(int(g) for g in grp if g != k)
        return m


# --------------------------------------------------------------------------- #
# Database joins                                                              #
# --------------------------------------------------------------------------- #

def db_join_trace(
    n_orders: int = 8_000,
    n_customers: int = 1_000,
    n_items: int = 2_000,
    n_queries: int = 25_000,
    point_query_frac: float = 0.25,
    seed: int = 0,
) -> Trace:
    """OLTP-style trace: ``SELECT * FROM orders JOIN customers ...``.

    Key space: orders [0, n_orders), customers [n_orders, +n_customers),
    items (order lines) after that.  A join query touches an order row,
    then its customer row, then 1-3 item rows — the FK relationships the
    paper's motivating example (§2.1) wants discovered.
    """
    rng = np.random.default_rng(seed)
    cust_base = n_orders
    item_base = n_orders + n_customers

    order_customer = rng.integers(0, n_customers, size=n_orders)
    order_items = [
        rng.integers(0, n_items, size=rng.integers(1, 4)) for _ in range(n_orders)
    ]

    relationships: List[Tuple[int, ...]] = []
    for o in range(n_orders):
        grp = (o, cust_base + int(order_customer[o]),
               *(item_base + int(i) for i in order_items[o]))
        relationships.append(tuple(dict.fromkeys(grp)))

    # order popularity is zipfian (hot accounts)
    ranks = np.arange(1, n_orders + 1, dtype=np.float64)
    pop = 1.0 / ranks**0.9
    pop /= pop.sum()

    accesses: List[int] = []
    while len(accesses) < n_queries:
        o = int(rng.choice(n_orders, p=pop))
        if rng.random() < point_query_frac:
            accesses.append(o)  # point query: order only
            continue
        accesses.append(o)
        accesses.append(cust_base + int(order_customer[o]))
        for i in order_items[o]:
            accesses.append(item_base + int(i))
    n_keys = n_orders + n_customers + n_items
    return Trace("db_join", np.array(accesses[:n_queries]), relationships, n_keys,
                 meta=dict(kind="database", point_query_frac=point_query_frac))


# --------------------------------------------------------------------------- #
# ML training                                                                 #
# --------------------------------------------------------------------------- #

def ml_epoch_trace(
    n_samples: int = 6_000,
    n_feature_rows: int = 1_500,
    feats_per_sample: int = 3,
    batch_size: int = 32,
    n_epochs: int = 3,
    seed: int = 0,
) -> Trace:
    """Training epochs: shuffled sample order; each sample drags in its
    (sparse) feature-table rows — e.g. embedding rows shared across
    samples.  The sample->features map is the relationship set ("PFCS
    identified feature relationships", §6.3)."""
    rng = np.random.default_rng(seed)
    feat_base = n_samples
    sample_feats = rng.integers(0, n_feature_rows, size=(n_samples, feats_per_sample))

    relationships = [
        tuple(dict.fromkeys((s, *(feat_base + int(f) for f in sample_feats[s]))))
        for s in range(n_samples)
    ]

    accesses: List[int] = []
    for _ in range(n_epochs):
        order = rng.permutation(n_samples)
        for s in order:
            accesses.append(int(s))
            for f in sample_feats[s]:
                accesses.append(feat_base + int(f))
    return Trace("ml_epoch", np.array(accesses), relationships,
                 n_samples + n_feature_rows,
                 meta=dict(kind="ml", batch_size=batch_size))


# --------------------------------------------------------------------------- #
# High-frequency trading                                                      #
# --------------------------------------------------------------------------- #

def hft_trace(
    n_instruments: int = 3_000,
    n_corr_groups: int = 400,
    group_size: int = 5,
    n_events: int = 40_000,
    burst_prob: float = 0.85,
    seed: int = 0,
) -> Trace:
    """Market-data bursts: a tick on instrument i triggers reads of its
    correlated instruments (sector/ETF basket) — the §6.3 HFT case."""
    rng = np.random.default_rng(seed)
    groups = [tuple(int(x) for x in rng.choice(n_instruments, size=group_size,
                                               replace=False))
              for _ in range(n_corr_groups)]
    member_of: Dict[int, List[int]] = {}
    for gi, g in enumerate(groups):
        for k in g:
            member_of.setdefault(k, []).append(gi)

    # instrument popularity: heavy-tailed
    ranks = np.arange(1, n_instruments + 1, dtype=np.float64)
    pop = 1.0 / ranks**1.1
    pop /= pop.sum()

    accesses: List[int] = []
    while len(accesses) < n_events:
        i = int(rng.choice(n_instruments, p=pop))
        accesses.append(i)
        gids = member_of.get(i)
        if gids and rng.random() < burst_prob:
            g = groups[int(rng.choice(gids))]
            for k in g:
                if k != i:
                    accesses.append(k)
    return Trace("hft", np.array(accesses[:n_events]), groups, n_instruments,
                 meta=dict(kind="hft", burst_prob=burst_prob))


# --------------------------------------------------------------------------- #
# Relationship-free baselines                                                 #
# --------------------------------------------------------------------------- #

def zipf_trace(n_keys: int = 20_000, n_accesses: int = 40_000,
               alpha: float = 0.99, seed: int = 0) -> Trace:
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, n_keys + 1, dtype=np.float64)
    p = 1.0 / ranks**alpha
    p /= p.sum()
    acc = rng.choice(n_keys, size=n_accesses, p=p)
    return Trace("zipf", acc, [], n_keys, meta=dict(kind="kv", alpha=alpha))


def scan_trace(n_keys: int = 10_000, n_passes: int = 4, seed: int = 0) -> Trace:
    acc = np.tile(np.arange(n_keys, dtype=np.int64), n_passes)
    return Trace("scan", acc, [], n_keys, meta=dict(kind="scan"))


# --------------------------------------------------------------------------- #
# Tunable relationship density (Fig. 2a)                                      #
# --------------------------------------------------------------------------- #

def graph_walk_trace(
    n_keys: int = 10_000,
    relationship_density: float = 0.5,   # 0 = none, 1 = dense groups
    n_accesses: int = 40_000,
    max_group: int = 8,
    seed: int = 0,
) -> Trace:
    """Random walk over a relationship graph whose density is the Fig. 2a
    'workload complexity' axis.

    Keys are PARTITIONED into disjoint groups (each key belongs to at
    most one group — FK-like structure); ``relationship_density``
    controls (a) the fraction of the key space that is grouped, (b) the
    group size (2 -> max_group), and (c) how deterministically an access
    to a group member drags in the rest of the group.  Higher density =
    more of each access's future is relationship-determined = more a
    deterministic-discovery system can exploit (the paper's
    'relationship-heavy workloads').
    """
    rng = np.random.default_rng(seed)
    gsz = 2 + int(round(relationship_density * (max_group - 2)))
    covered = int(relationship_density * n_keys)
    perm = rng.permutation(n_keys)
    groups = [tuple(int(x) for x in perm[i:i + gsz])
              for i in range(0, max(0, covered - gsz), gsz)]
    member_of: Dict[int, int] = {}
    for gi, g in enumerate(groups):
        for k in g:
            member_of[k] = gi

    ranks = np.arange(1, n_keys + 1, dtype=np.float64)
    pop = 1.0 / ranks**0.8
    pop /= pop.sum()
    pop = pop[np.argsort(perm)]  # decouple popularity from group layout
    burst_p = 0.5 + 0.5 * relationship_density

    accesses: List[int] = []
    while len(accesses) < n_accesses:
        k = int(rng.choice(n_keys, p=pop))
        accesses.append(k)
        gi = member_of.get(k)
        if gi is not None and rng.random() < burst_p:
            for q in groups[gi]:
                if q != k:
                    accesses.append(q)
    return Trace(f"graph_walk_d{relationship_density:.2f}",
                 np.array(accesses[:n_accesses]), groups, n_keys,
                 meta=dict(kind="graph", density=relationship_density))


TRACES = {
    "db_join": db_join_trace,
    "ml_epoch": ml_epoch_trace,
    "hft": hft_trace,
    "zipf": zipf_trace,
    "scan": scan_trace,
    "graph_walk": graph_walk_trace,
}
