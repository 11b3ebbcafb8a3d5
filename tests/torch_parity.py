"""Shared helpers of the port's parity tests (``tests/test_torch_*.py``).

:func:`registry_arrays` reads either package's cache as plain numpy, so
the tests compare state, not only counters; :func:`state_arrays` reads an
assigner and its registry as the arrays that
``repro_torch.core.state_from_arrays`` takes; :func:`kernel_inputs` makes
the kernels' test inputs from a seed; :func:`chip_smoke` loads the smoke
script, whose edge inputs the tests share.  (``tests/conftest.py`` makes
the reference importable under JAX 0.9.0.)
"""

from __future__ import annotations

import functools
import importlib.util
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np

__all__ = ["registry_arrays", "assert_registries_equal", "kernel_inputs",
           "first_primes", "state_arrays", "assert_state_arrays_equal",
           "BIG_PRIMES", "chip_smoke"]

BIG_PRIMES = np.array([1_000_003, 1_000_033, 1_000_037, 1_000_039,
                       999_983, 999_979], dtype=np.int64)


def first_primes(k):
    """The first ``k`` primes (k <= 550)."""
    sieve = np.ones(4000, dtype=bool)
    sieve[:2] = False
    for i in range(2, 64):
        sieve[i * i::i] = False
    return np.nonzero(sieve)[0][:k].astype(np.int64)


def kernel_inputs(n, p, dtype, seed):
    """Composites (products of pool primes, random values, 0 and 1) and a
    pool of ``p`` distinct primes (the registry invariant) padded with 0
    and 1."""
    rng = np.random.default_rng(seed)
    primes = first_primes(max(p - 3, 1))
    if dtype == np.int64:
        primes[-len(BIG_PRIMES):] = BIG_PRIMES[:len(primes)]
    k = rng.integers(1, 3, size=n)
    picks = rng.choice(primes, size=(n, 2))
    comps = np.where(np.arange(2)[None, :] < k[:, None], picks, 1).prod(1)
    hi = 2**31 - 1 if dtype == np.int32 else 2**62
    comps = np.where(rng.random(n) < 0.2, rng.integers(0, hi, size=n), comps)
    comps[:2] = [0, 1][:n]
    pool = np.concatenate([rng.permutation(primes), [0, 1, 0]])[:p]
    return comps.astype(dtype), pool.astype(dtype)


@functools.lru_cache(maxsize=None)
def chip_smoke():
    """``chip_smoke.py`` at the root of the checkout, as a module (it
    imports only numpy and torch at load time): the tests hold the flat
    kernels on the edge inputs it checks on the card."""
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def registry_arrays(cache) -> Dict[str, object]:
    """A paged-KV cache's PFCS state as numpy arrays: the composites in
    registry order, ``primes_array()``, the page -> prime map (0 for a
    page without a prime), and each composite's relationship's member
    primes in iteration order."""
    reg = cache.registry
    comps = reg.composites_array()
    page_prime = np.asarray(
        [cache.assigner.prime_of(pid) or 0
         for pid in range(cache._next_page)], dtype=np.int64)
    members: List[Tuple[int, ...]] = []
    for c in comps:
        rel = reg.relationship_of_composite(int(c))
        members.append(tuple(int(q) for q in rel.primes) if rel else ())
    return {"composites": np.asarray(comps, dtype=np.int64),
            "primes": np.asarray(reg.primes_array(), dtype=np.int64),
            "page_prime": page_prime,
            "members": members}


def assert_registries_equal(a, b) -> None:
    """Both caches hold the same registry, page primes and member order."""
    ra, rb = registry_arrays(a), registry_arrays(b)
    for key in ("composites", "primes", "page_prime"):
        np.testing.assert_array_equal(ra[key], rb[key], err_msg=key)
    assert ra["members"] == rb["members"]


def state_arrays(assigner) -> Dict[str, object]:
    """Either package's prime assignment, prime pools and composite
    registry as the keyword arguments of
    ``repro_torch.core.state_from_arrays`` (plain arrays and ints)."""
    reg = assigner.registry
    data = [(d, p, lvl) for lvl in sorted(assigner._data_to_prime)
            for d, p in assigner._data_to_prime[lvl].items()]
    rels = list(reg._by_id.values())
    members = [int(q) for r in rels for q in r.primes]
    pools = [assigner.allocator.pools[lvl]
             for lvl in sorted(assigner.allocator.pools)]
    comps = list(reg._by_composite.items())
    return {
        "data_ids": np.asarray([d for d, _, _ in data], dtype=np.int64),
        "data_primes": np.asarray([p for _, p, _ in data], dtype=np.int64),
        "data_levels": np.asarray([lvl for _, _, lvl in data],
                                  dtype=np.int64),
        "pool_next": np.asarray([pl._next_idx for pl in pools],
                                dtype=np.int64),
        "pool_free": [np.asarray(sorted(pl._free), dtype=np.int64)
                      for pl in pools],
        "rel_ids": np.asarray([r.rel_id for r in rels], dtype=np.int64),
        "rel_offsets": np.cumsum([0] + [len(r.primes) for r in rels]),
        "rel_members": np.asarray(members, dtype=np.int64),
        "rel_weights": np.asarray([r.weight for r in rels]),
        "rel_kinds": [r.kind for r in rels],
        "composites": np.asarray([c for c, _ in comps], dtype=np.int64),
        "composite_rel": np.asarray([r for _, r in comps], dtype=np.int64),
        "next_rel_id": reg._next_id,
        "version": reg.version,
        "epoch": assigner.epoch,
        "max_bits": reg.max_bits,
    }


def assert_state_arrays_equal(a, b) -> None:
    assert a.keys() == b.keys()
    for key in a:
        if key in ("pool_free", "rel_kinds"):
            assert [list(x) for x in a[key]] == [list(x) for x in b[key]], key
        else:
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)
