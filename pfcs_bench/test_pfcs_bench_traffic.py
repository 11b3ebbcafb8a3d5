"""The traffic generator: repeatable per seed, the same work for every
seed, each later length drawn from its whole distribution, and residual
fill lengths drawn from the right distribution."""

from collections import Counter

import numpy as np
import pytest

from pfcs_bench.loadgen import ClosedLoop, residual_quantiles, stratified

MIX = {"prefixes": 1, "prefix_tokens": 16, "prefix_zipf_s": 0.0,
       "unique_tokens": [0, 16], "output_tokens": [1024, 1792],
       "antithetic": True}


def _draw(seed, n_next=40, mix=MIX, clients=32):
    loop = ClosedLoop(mix, clients, 32_064, seed)
    return loop.fill() + [loop.next() for _ in range(n_next)]


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 11, 2**40 + 3])
def test_same_seed_same_requests(seed):
    a, b = _draw(seed), _draw(seed)
    assert [(r.prompt, r.max_new_tokens) for r in a] == \
        [(r.prompt, r.max_new_tokens) for r in b]


def test_seeds_differ_in_order_not_in_sizes():
    a, b = _draw(3, n_next=32), _draw(4, n_next=32)
    assert [r.prompt for r in a] != [r.prompt for r in b]
    # the fill: the same lengths, permuted
    for key in (lambda r: len(r.prompt), lambda r: r.max_new_tokens):
        assert sorted(map(key, a[:32])) == sorted(map(key, b[:32]))
        assert list(map(key, a[:32])) != list(map(key, b[:32]))
    # later requests: other lengths, the same tokens in every pair
    later_a, later_b = a[32:], b[32:]
    assert [len(r.prompt) for r in later_a] != \
        [len(r.prompt) for r in later_b]
    for reqs in (later_a, later_b):
        for x, y in zip(reqs[0::2], reqs[1::2]):
            assert len(x.prompt) + len(y.prompt) == 2 * 16 + 16
            assert x.max_new_tokens + y.max_new_tokens == 1024 + 1792


@pytest.mark.parametrize("antithetic", [False, True])
def test_later_lengths_take_the_whole_distribution(antithetic):
    mix = dict(MIX, antithetic=antithetic)
    reqs = _draw(11, n_next=4000, mix=mix)[32:]
    outs = np.array([r.max_new_tokens for r in reqs])
    uniq = np.array([len(r.prompt) - 16 for r in reqs])
    assert outs.min() < 1024 + 20 and outs.max() > 1792 - 20
    assert set(uniq) == set(range(17))
    # uniform: mean and spread of a uniform over the range
    assert abs(outs.mean() - 1408) < 12
    assert abs(outs.std() - 769 / 12 ** 0.5) < 8
    counts = np.bincount(uniq, minlength=17)
    assert counts.min() > 4000 / 17 * 0.75


def test_every_prompt_shares_the_prefix():
    reqs = _draw(5)
    pre = reqs[0].prompt[:16]
    assert all(r.prompt[:16] == pre for r in reqs)
    assert all(16 <= len(r.prompt) <= 32 for r in reqs)
    assert all(1024 <= r.max_new_tokens <= 1792 for r in reqs[32:])


def test_zipf_prefixes_favour_the_first():
    mix = dict(MIX, prefixes=4, prefix_tokens=32, prefix_zipf_s=1.1)
    reqs = _draw(9, n_next=400, mix=mix, clients=16)
    counts = Counter(tuple(r.prompt[:32]) for r in reqs)
    assert len(counts) == 4
    assert counts.most_common(1)[0][1] > len(reqs) / 4


def test_stratified_and_residual_quantiles():
    s = stratified(1024, 1792, 16)
    assert s.min() >= 1024 and s.max() <= 1792 and len(set(s)) == 16
    r = residual_quantiles(1024, 1792, 100_000)
    lo, hi = 1024, 1792
    # the residual's mean is E[L^2] / (2 E[L]) for lengths uniform on lo..hi
    ls = np.arange(lo, hi + 1)
    want = (ls.astype(float) ** 2).mean() / (2 * ls.mean())
    assert abs(r.mean() - want) / want < 0.01
    assert r.min() >= 1 and r.max() <= hi
