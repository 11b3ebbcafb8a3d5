"""The one generator of client requests; a traffic mix is a JSON file of
its parameters under ``traffic/``.

The loop is closed: ``clients`` callers each send their next request as
soon as the previous one completes.  Every seed gives the fill the same
lengths in another order, and with ``antithetic`` every two later
requests the same tokens: two seeds then differ by where the lengths
fall, not by how much there is to do.

- The fill, one request a client, takes its lengths at the stratified
  quantiles of their distributions, permuted over the clients; its output
  lengths are those of the *residual* of the output distribution (the
  tokens a request already in progress still has to make), so
  completions, and the admissions they trigger, spread through the
  window from its start.
- Every later request draws each length from its whole distribution.
  With ``antithetic`` they come in pairs: a draw u, then lo + hi - u, so
  each request's length is still uniform over lo..hi while every pair
  holds the same number of tokens whatever the seed.

Parameters (all lengths in tokens, ranges inclusive):

``loop``            "closed" (the only kind generated)
``prefixes``        number of distinct system prefixes (shared pages)
``prefix_tokens``   length of each prefix
``prefix_zipf_s``   Zipf exponent of the prefixes' popularity (0: even)
``unique_tokens``   [lo, hi] tokens after the prefix, unique to a request
``output_tokens``   [lo, hi] output length, uniform
``antithetic``      later requests in antithetic pairs (default false)
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np

__all__ = ["Req", "ClosedLoop", "stratified", "residual_quantiles"]


@dataclass
class Req:
    prompt: List[int]
    max_new_tokens: int


def stratified(lo: int, hi: int, n: int) -> np.ndarray:
    """``n`` integers at the quantiles (i + 1/2) / n of the uniform
    distribution over ``lo..hi``."""
    q = (np.arange(n) + 0.5) / n
    return np.minimum(lo + np.floor(q * (hi - lo + 1)).astype(np.int64), hi)


def residual_quantiles(lo: int, hi: int, n: int) -> np.ndarray:
    """``n`` residual lengths at the quantiles (i + 1/2) / n of the
    tokens still due from a request caught in progress, when lengths are
    uniform over ``lo..hi``: P(r) is proportional to P(L >= r), r = 1..hi."""
    r = np.arange(1, hi + 1)
    surv = np.clip((hi - r + 1) / (hi - lo + 1), 0.0, 1.0)
    cdf = np.cumsum(surv) / surv.sum()
    q = (np.arange(n) + 0.5) / n
    return r[np.searchsorted(cdf, q)]


class ClosedLoop:
    """The requests of one run: ``fill()`` once, then ``next()`` each time
    a client's request completes.  Deterministic in ``seed``."""

    def __init__(self, mix: Dict, clients: int, vocab: int, seed: int):
        if mix.get("loop", "closed") != "closed":
            raise ValueError(f"only closed loops are generated, got "
                             f"{mix['loop']!r}")
        self.mix = mix
        self.clients = clients
        self.vocab = vocab
        self.rng = np.random.default_rng(int(seed))
        n_pre = int(mix["prefixes"])
        self.prefixes = [self._tokens(int(mix["prefix_tokens"]))
                         for _ in range(n_pre)]
        s = float(mix.get("prefix_zipf_s", 0.0))
        w = 1.0 / np.arange(1, n_pre + 1) ** s
        self.prefix_p = w / w.sum()
        self._queue: List[Tuple[int, int]] = []

    def _tokens(self, n: int) -> List[int]:
        return [int(t) for t in self.rng.integers(1, self.vocab, size=n)]

    def _make(self, unique: int, out: int) -> Req:
        pre = self.prefixes[int(self.rng.choice(len(self.prefixes),
                                                p=self.prefix_p))]
        return Req(pre + self._tokens(int(unique)), int(out))

    def fill(self) -> List[Req]:
        lo, hi = self.mix["unique_tokens"]
        olo, ohi = self.mix["output_tokens"]
        uniques = self.rng.permutation(stratified(lo, hi, self.clients))
        outs = self.rng.permutation(
            residual_quantiles(olo, ohi, self.clients))
        return [self._make(u, o) for u, o in zip(uniques, outs)]

    def next(self) -> Req:
        if not self._queue:
            (lo, hi), (olo, ohi) = (self.mix["unique_tokens"],
                                    self.mix["output_tokens"])
            u = int(self.rng.integers(lo, hi + 1))
            o = int(self.rng.integers(olo, ohi + 1))
            self._queue = [(u, o)]
            if self.mix.get("antithetic", False):
                self._queue.append((lo + hi - u, olo + ohi - o))
        return self._make(*self._queue.pop(0))
