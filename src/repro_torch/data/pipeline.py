"""Data pipeline: synthetic corpus, byte tokenizer, deterministic sharded
loader, and a PFCS-cached storage tier (port of ``repro.data.pipeline``,
which has no JAX in it: carried over with its imports rewritten).

The loader is host-count aware (``shard_index`` / ``shard_count``): every
host reads only its slice, deterministically from (seed, step) — so a
restarted or re-sharded (elastic) job reproduces the exact global batch
stream from any step, which together with the checkpoint manager gives
bit-identical resume.

The storage tier models a shard-file cache: mixture sampling makes shard
co-access structured (a mixture 'domain' pulls a correlated set of
shards); PFCS registers domain->shard relationships and prefetches the
shards a sampled domain is about to read.  ``ml_epoch_trace`` in
``repro_torch.core.traces`` is the micro version of this workload; here
it is wired to the real loader.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.pfcs_cache import PFCSCache

__all__ = ["ByteTokenizer", "SyntheticCorpus", "ShardedLoader"]


class ByteTokenizer:
    """Byte-level tokenizer with a few special tokens."""

    PAD, BOS, EOS = 256, 257, 258
    vocab_size = 259

    def encode(self, text: str, add_bos: bool = True) -> List[int]:
        ids = list(text.encode("utf-8"))
        return ([self.BOS] if add_bos else []) + ids

    def decode(self, ids: Sequence[int]) -> str:
        return bytes(i for i in ids if i < 256).decode("utf-8", "replace")


@dataclass
class SyntheticCorpus:
    """Deterministic mixture-of-domains token stream.

    Each domain d has a distinct unigram distribution (so training on it
    is learnable) and owns a set of shard files; sampling a sequence from
    d touches ~3 of its shards (the relationship structure PFCS caches).
    """

    vocab_size: int = 259
    n_domains: int = 8
    shards_per_domain: int = 16
    seed: int = 0

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        self.domain_logits = rng.normal(size=(self.n_domains, self.vocab_size))
        self.domain_shards = [
            list(range(d * self.shards_per_domain,
                       (d + 1) * self.shards_per_domain))
            for d in range(self.n_domains)
        ]

    @property
    def n_shards(self) -> int:
        return self.n_domains * self.shards_per_domain

    def sample_sequence(self, rng: np.random.Generator, seq_len: int
                        ) -> Tuple[np.ndarray, int, List[int]]:
        """Returns (tokens, domain, shards_touched)."""
        d = int(rng.integers(self.n_domains))
        logits = self.domain_logits[d]
        p = np.exp(logits - logits.max())
        p /= p.sum()
        toks = rng.choice(self.vocab_size, size=seq_len, p=p).astype(np.int32)
        shards = list(rng.choice(self.domain_shards[d], size=3, replace=False))
        return toks, d, [int(s) for s in shards]


class ShardedLoader:
    """Deterministic, restartable, host-sharded batch iterator."""

    def __init__(self, corpus: SyntheticCorpus, global_batch: int,
                 seq_len: int, shard_index: int = 0, shard_count: int = 1,
                 seed: int = 0, pfcs_cache: Optional[PFCSCache] = None):
        assert global_batch % shard_count == 0
        self.corpus = corpus
        self.global_batch = global_batch
        self.local_batch = global_batch // shard_count
        self.seq_len = seq_len
        self.shard_index = shard_index
        self.shard_count = shard_count
        self.seed = seed
        self.cache = pfcs_cache
        if self.cache is not None:
            # register domain -> shard relationships (the catalog)
            for d, shards in enumerate(corpus.domain_shards):
                self.cache.register_relationship(
                    [("domain", d)] + [("shard", s) for s in shards],
                    kind="dataset")

    def _rng_for(self, step: int, sample: int) -> np.random.Generator:
        key = hashlib.sha256(
            f"{self.seed}:{step}:{self.shard_index}:{sample}".encode()
        ).digest()
        return np.random.default_rng(int.from_bytes(key[:8], "little"))

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        """The exact local batch for ``step`` (same result on every call)."""
        toks = np.empty((self.local_batch, self.seq_len), np.int32)
        for i in range(self.local_batch):
            rng = self._rng_for(step, i)
            seq, domain, shards = self.corpus.sample_sequence(rng, self.seq_len)
            toks[i] = seq
            if self.cache is not None:
                self.cache.access(("domain", domain))
                for s in shards:
                    self.cache.access(("shard", s))
        return {"tokens": toks}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1
