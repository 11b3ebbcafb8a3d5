"""Semantic-cache baseline (PFCS §2.1 / Table 1 'Semantic Cache').

Embedding-similarity relationship discovery: each key gets a random-
projection embedding of its true relationship neighborhood plus noise;
neighbor queries return cosine-similar keys.  This reproduces the
published failure modes the paper attributes to such systems:

  * false positives (2.3-15.7% in the paper) — similar-but-unrelated keys
    get prefetched, wasting cache space and backing-store bandwidth;
  * false negatives — some true relationships fall below the similarity
    threshold and are never prefetched;
  * per-discovery embedding compute charged by the latency model
    (paper: 15-23% CPU overhead for embedding generation).

The implementation is deterministic given ``seed``.
"""

from __future__ import annotations

from typing import Dict, Hashable, List, Sequence, Set, Tuple

import numpy as np

__all__ = ["SemanticRelationshipModel"]

DataID = Hashable


class SemanticRelationshipModel:
    """Approximate relationship oracle with tunable FP/FN rates."""

    def __init__(
        self,
        relationships: Sequence[Tuple[int, ...]],
        n_keys: int,
        embed_dim: int = 32,
        fp_rate: float = 0.12,   # fraction of returned neighbors that are false
        fn_rate: float = 0.10,   # fraction of true neighbors dropped
        seed: int = 0,
    ):
        self.rng = np.random.default_rng(seed)
        self.n_keys = n_keys
        self.fp_rate = fp_rate
        self.fn_rate = fn_rate
        self.embed_dim = embed_dim

        # true adjacency
        self._adj: Dict[int, Set[int]] = {}
        for grp in relationships:
            for k in grp:
                self._adj.setdefault(int(k), set()).update(
                    int(g) for g in grp if g != k)

        # random-projection embeddings: related keys pull together, noise
        # keeps similarity imperfect (the source of FP/FN behaviour).
        self._emb = self.rng.normal(size=(n_keys, embed_dim)).astype(np.float32)
        for k, nbrs in self._adj.items():
            if nbrs:
                centroid = self._emb[list(nbrs)].mean(axis=0)
                self._emb[k] = 0.6 * self._emb[k] + 0.4 * centroid
        norms = np.linalg.norm(self._emb, axis=1, keepdims=True)
        self._emb /= np.maximum(norms, 1e-6)

        self._memo: Dict[int, List[int]] = {}
        self.discovery_ops = 0  # embedding computations (charged by metrics)

    def neighbors(self, k: int, budget: int = 8) -> List[int]:
        """Approximate related keys: true neighbors minus FN, plus FP."""
        k = int(k)
        if k in self._memo:
            self.discovery_ops += 1  # similarity search still runs per query
            return self._memo[k]
        self.discovery_ops += 1
        true_nbrs = list(self._adj.get(k, ()))
        kept = [n for n in true_nbrs if self.rng.random() >= self.fn_rate]
        # false positives: cosine-similar but unrelated keys
        n_fp = int(np.ceil(len(kept) * self.fp_rate / max(1e-9, 1 - self.fp_rate)))
        if not kept and self._adj.get(k):
            n_fp = max(n_fp, 1)
        fps: List[int] = []
        if n_fp > 0:
            sims = self._emb @ self._emb[k]
            sims[k] = -np.inf
            for n in true_nbrs:
                sims[n] = -np.inf
            order = np.argpartition(-sims, min(n_fp, self.n_keys - 1))[: n_fp]
            fps = [int(x) for x in order]
        out = (kept + fps)[:budget]
        self._memo[k] = out
        return out

    def is_truly_related(self, a: int, b: int) -> bool:
        return int(b) in self._adj.get(int(a), set())
