"""The port's kernels against the reference: plain PyTorch versions vs
``repro.kernels.ref`` and vs the Pallas kernels in interpret mode, the
``ops`` wrappers vs ``repro.kernels.ops``.  Integer kernels: every
comparison is exact.  The CUDA kernels are held against the same plain
versions on the card by ``tests/test_torch_gpu.py``."""

from torch_parity import BIG_PRIMES, chip_smoke, first_primes, kernel_inputs

import math
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import enable_x64

from hypothesis_compat import given, settings, st
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.factorize import (divisibility_mask_pallas,
                                     factorize_squarefree_pallas)
from repro.kernels.gcd import gcd_pallas
from repro_torch.kernels import factorize as tfac
from repro_torch.kernels import gcd as tgcd
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

PRIMES_SMALL = np.array(
    [2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37, 41, 43, 47, 53, 59, 61,
     67, 71, 73, 79, 83, 89, 97, 101, 103, 107, 109, 113], dtype=np.int64)

DTYPES = {np.int32: torch.int32, np.int64: torch.int64}


class _null:
    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False


def _x64(dtype):
    return enable_x64(True) if dtype == np.int64 else _null()


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


# --------------------------------------------------------------------------- #
# plain versions vs repro.kernels.ref                                          #
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("n,p", [(1, 1), (37, 5), (130, 33), (300, 70)])
@pytest.mark.parametrize("dtype", [np.int32, np.int64])
def test_plain_mask_and_factorize_match_ref(n, p, dtype):
    comps, primes = kernel_inputs(n, p, dtype, seed=n * 7 + p)
    with _x64(dtype):
        mref = np.asarray(jref.divisibility_mask_ref(jnp.asarray(comps),
                                                     jnp.asarray(primes)))
        fmref, rref = jref.factorize_squarefree_ref(jnp.asarray(comps),
                                                    jnp.asarray(primes))
    mask = tref.divisibility_mask_ref(_t(comps), _t(primes)).numpy()
    fmask, res = tref.factorize_squarefree_ref(_t(comps), _t(primes))
    np.testing.assert_array_equal(mask, mref)
    np.testing.assert_array_equal(fmask.numpy(), np.asarray(fmref))
    np.testing.assert_array_equal(res.numpy(), np.asarray(rref))
    assert res.dtype == DTYPES[dtype]


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
def test_plain_gcd_matches_ref(dtype):
    rng = np.random.default_rng(3)
    hi = 2**28 if dtype == np.int32 else 2**40
    a = rng.integers(0, hi, size=1000).astype(dtype)
    b = rng.integers(0, hi, size=1000).astype(dtype)
    a[:4], b[:4] = [0, 5, 0, 12], [7, 0, 0, 18]
    with _x64(dtype):
        g_ref = np.asarray(jref.gcd_ref(jnp.asarray(a), jnp.asarray(b)))
    g = tref.gcd_ref(_t(a), _t(b)).numpy()
    np.testing.assert_array_equal(g, g_ref)
    np.testing.assert_array_equal(g, np.gcd(a, b))


@given(comps=st.lists(st.integers(0, 2**40), min_size=1, max_size=40),
       primes=st.lists(st.integers(0, 5000), min_size=1, max_size=40))
@settings(max_examples=40, deadline=None)
def test_plain_versions_property(comps, primes):
    """Any non-negative int64 inputs: mask and gcd equal the reference;
    the residual too wherever the product of dividing pool values cannot
    overflow (true primes, as the registry pools are)."""
    c = np.asarray(comps, dtype=np.int64)
    p = np.asarray(primes, dtype=np.int64)
    with enable_x64(True):
        mref = np.asarray(jref.divisibility_mask_ref(jnp.asarray(c),
                                                     jnp.asarray(p)))
        g_ref = np.asarray(jref.gcd_ref(jnp.asarray(c),
                                        jnp.asarray(np.resize(p, c.size))))
    np.testing.assert_array_equal(
        tref.divisibility_mask_ref(_t(c), _t(p)).numpy(), mref)
    np.testing.assert_array_equal(
        tref.gcd_ref(_t(c), _t(np.resize(p, c.size))).numpy(), g_ref)
    prime_pool = np.asarray([q for q in set(primes) if q in set(
        int(x) for x in PRIMES_SMALL)] or [2], dtype=np.int64)
    with enable_x64(True):
        _, rref = jref.factorize_squarefree_ref(jnp.asarray(c),
                                                jnp.asarray(prime_pool))
    _, res = tref.factorize_squarefree_ref(_t(c), _t(prime_pool))
    np.testing.assert_array_equal(res.numpy(), np.asarray(rref))


# --------------------------------------------------------------------------- #
# plain versions (through the wrappers, CPU tensors) vs Pallas interpret      #
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("dtype", [np.int32, np.int64])
def test_wrappers_match_pallas_interpret(dtype):
    comps, primes = kernel_inputs(64, 256, dtype, seed=11)
    a, b = kernel_inputs(256, 256, dtype, seed=12)[0], np.resize(comps, 256)
    with _x64(dtype):
        mask_p = divisibility_mask_pallas(
            jnp.asarray(comps), jnp.asarray(primes), block_n=32,
            block_p=128, interpret=True)
        fmask_p, res_p = factorize_squarefree_pallas(
            jnp.asarray(comps), jnp.asarray(primes), block_n=32,
            block_p=128, interpret=True)
        g_p = gcd_pallas(jnp.asarray(a), jnp.asarray(b), block_n=128,
                         interpret=True)
    np.testing.assert_array_equal(
        tfac.divisibility_mask(_t(comps), _t(primes)).numpy(),
        np.asarray(mask_p))
    fmask, res = tfac.factorize_squarefree(_t(comps), _t(primes))
    np.testing.assert_array_equal(fmask.numpy(), np.asarray(fmask_p))
    np.testing.assert_array_equal(res.numpy(), np.asarray(res_p))
    np.testing.assert_array_equal(tgcd.gcd(_t(a), _t(b)).numpy(),
                                  np.asarray(g_p))


# --------------------------------------------------------------------------- #
# the flat kernels' arithmetic (csrc/divmask.cu, factorize.cu, gcd.cu),       #
# modelled in Python ints                                                     #
# --------------------------------------------------------------------------- #
# Each function below is written as the CUDA source writes it, on unsigned
# w-bit words (w = 32 for int32, 64 for int64) with the wraparound made
# explicit, so that the arithmetic the card runs is held against ``%``,
# ``//`` and ``math.gcd`` here; the kernels themselves run only on the card.

WIDTHS = (32, 64)


def _ctz(x):
    return (x & -x).bit_length() - 1          # __ffs(x) - 1, x != 0


def _inverse(q, w):
    """``inverse()``: q**-1 mod 2**w for odd q, from the seed (3 q) ^ 2 by
    3 (w = 32) or 4 (w = 64) Newton rounds x <- x (2 - q x)."""
    m = (1 << w) - 1
    x = (3 * q & m) ^ 2
    for _ in range(3 if w == 32 else 4):
        x = x * ((2 - q * x) & m) & m
    return x


def _entry_of(p, w):
    """``entry_of()``: (q**-1, q, 2**t - 1) with p = 2**t q, q odd."""
    t = _ctz(p)
    q = p >> t
    return _inverse(q, w), q, (1 << t) - 1


def _divides(entry, c, w):
    """``divides()``: the low t bits of c are zero and the high word of
    (c q**-1 mod 2**w) * q is zero."""
    qinv, q, low = entry
    x = c * qinv & ((1 << w) - 1)
    return ((c & low) | (x * q >> w)) == 0


def _divides_by_limit(entry, c, w):
    """The same test as a limit: c q**-1 mod 2**w <= floor((2**w - 1) /
    q), the form that needs one division per entry."""
    qinv, q, low = entry
    return c & low == 0 and c * qinv % (1 << w) <= ((1 << w) - 1) // q


def _divide_out(res, p, w):
    """``divide_out()``: ``(quotient, exact)``; the shift of res q**-1 when
    p divides res, else the floor division."""
    qinv, q, low = _entry_of(p, w)
    x = res * qinv & ((1 << w) - 1)
    if ((res & low) | (x * q >> w)) == 0:
        return x >> _ctz(p), True
    return res // p, False


def _factorize_model(comps, pool, w):
    """``factorize_kernel`` row by row: the mask from ``divides`` on the
    live entries (> 1), and the residual from each hit divided out in
    pool order (none for a residual of 0); also the floor divisions
    taken."""
    live = [(j, _entry_of(p, w)) for j, p in enumerate(pool) if p > 1]
    mask, residual, floors = [], [], 0
    for c in comps:
        hits = [j for j, e in live if _divides(e, c, w)]
        res = c
        if res:
            for j in hits:
                res, exact = _divide_out(res, pool[j], w)
                floors += not exact
        mask.append([j in hits for j in range(len(pool))])
        residual.append(res)
    return mask, residual, floors


def _odd_gcd32(u, v):
    """``odd_gcd32()``: u, v odd and below 2**32; ``(gcd, steps)``."""
    steps = 0
    while u != v and v != 1 and u != 1:
        lo, d = min(u, v), max(u, v) - min(u, v)
        u, v = lo, d >> _ctz(d)
        steps += 1
    return (1 if 1 in (u, v) else u), steps


def _redc_step(s, limb, m, mneg_inv):
    """``redc_step()``: (s + limb + k m) 2**-32, the low word cancelled."""
    t = s + limb
    k = (t & 0xFFFFFFFF) * mneg_inv & 0xFFFFFFFF
    assert (t + k * m) & 0xFFFFFFFF == 0
    return (t + k * m) >> 32


def _gcd_small(x, m):
    """``gcd_small()``: odd m < 2**31, odd x < 2**64; ``(gcd, steps,
    reduced)``, the wide side reduced by two Montgomery steps where it
    is far larger than m."""
    assert m & 1 and x & 1 and m < 2**31 and x < 2**64
    if m == 1:
        return 1, 0, False
    s, reduced = x & 0xFFFFFFFF, False
    if x >> 32 or x >> 8 >= m:
        mneg = -_inverse(m, 32) & 0xFFFFFFFF
        s = _redc_step(0, x & 0xFFFFFFFF, m, mneg)
        s = _redc_step(s, x >> 32, m, mneg)
        assert s <= m + 1 and s % m == x * pow(2, -64, m) % m
        if s in (0, m):
            return m, 0, True
        s >>= _ctz(s)
        reduced = True
    g, steps = _odd_gcd32(s, m)
    return g, steps, reduced


def _gcd_model(a, b, w):
    """``gcd_of()`` at width w: ``(gcd, 64-bit steps, 32-bit steps,
    reduced)``."""
    if a == 0 or b == 0:
        return a | b, 0, 0, False
    k = _ctz(a | b)
    u, v = a >> _ctz(a), b >> _ctz(b)
    wide = 0
    while min(u, v) >> 31:
        assert w == 64
        if u == v:
            return u << k, wide, 0, False
        lo, d = min(u, v), max(u, v) - min(u, v)
        u, v = lo, d >> _ctz(d)
        wide += 1
    g, narrow, reduced = _gcd_small(max(u, v), min(u, v))
    return g << k, wide, narrow, reduced


def _edge_values(w):
    top = (1 << (w - 1)) - 1                  # the type's largest value
    vals = {0, 1, 2, 3, 4, 6, 9, 2**30, 2**30 - 1, 2**31 - 2, 2**31 - 1,
            2_147_483_629, 65_521, 65_521 * 32_749, top, top - 1}
    if w == 64:
        vals |= {2**62, 2**62 + 2, 2**61 - 1, 3 * (2**61 - 1), 2**63 - 2,
                 2**40 * 3, *(int(q) for q in BIG_PRIMES),
                 int(np.prod(BIG_PRIMES[:3].astype(object)))}
    return sorted(v for v in vals if v <= top)


@pytest.mark.parametrize("w", WIDTHS)
def test_flat_inverse_by_newton(w):
    """q * q**-1 == 1 mod 2**w for odd q across the type and at its edges;
    the seed (3 q) ^ 2 is right to 5 bits, so one round fewer would not
    reach w for every q."""
    rng = np.random.default_rng(w)
    top = (1 << (w - 1)) - 1
    qs = [int(q) | 1 for q in rng.integers(1, top, size=20_000)]
    qs += [1, 3, 5, 2**31 - 1, 2_147_483_629, top, top - 2]
    for q in qs:
        assert q * _inverse(q, w) % (1 << w) == 1, q
    for q in range(1, 64, 2):
        assert q * ((3 * q) ^ 2) % 32 == 1
    assert any(q * _inverse(q, w // 2) % (1 << w) != 1 for q in qs)


@pytest.mark.parametrize("w", WIDTHS)
def test_flat_divisibility_model_on_edge_values(w):
    """Every edge value against every edge entry > 1: the division-free
    test, its limit form and ``%`` agree; on a hit the exact quotient is
    ``//``, and the shift path is taken exactly when p divides."""
    vals = _edge_values(w)
    for p in (v for v in vals if v > 1):
        e = _entry_of(p, w)
        for c in vals:
            want = c % p == 0
            assert _divides(e, c, w) == _divides_by_limit(e, c, w) == want, \
                (c, p)
            assert _divide_out(c, p, w) == (c // p, want), (c, p)


@pytest.mark.parametrize("w", WIDTHS)
@pytest.mark.parametrize("seed", range(2))
def test_flat_divisibility_model_on_random_draws(w, seed):
    """50,000 seeded draws per seed (10**5 per width): entries odd, even,
    powers of two and small, values across the type, half of them
    multiples of the entry; test, limit form and exact-or-floor division
    against ``%`` and ``//``."""
    rng = np.random.default_rng(100 * w + seed)
    top = (1 << (w - 1)) - 1
    n = 50_000
    kind = rng.integers(0, 4, size=n)
    ps = [int(x) for x in rng.integers(2, top, size=n, dtype=np.int64)]
    shifts = rng.integers(0, w - 2, size=n)
    smalls = rng.integers(2, 64, size=n)
    cs = [int(x) for x in rng.integers(0, top, size=n, dtype=np.int64)]
    hits = 0
    for i in range(n):
        p = ps[i]
        if kind[i] == 1:
            p = max(p >> int(rng.integers(0, w - 2)) & ~0xFF, 2)
        elif kind[i] == 2:
            p = 1 << int(shifts[i]) or 2
        elif kind[i] == 3:
            p = int(smalls[i])
        p = max(p, 2)
        c = cs[i]
        if i % 2:
            c = (c // p) * p
        e = _entry_of(p, w)
        want = c % p == 0
        assert _divides(e, c, w) == _divides_by_limit(e, c, w) == want, (c, p)
        assert _divide_out(c, p, w) == (c // p, want), (c, p)
        hits += want
    assert hits > n // 2 - n // 50


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
def test_flat_factorize_model_matches_plain_version(dtype):
    """The kernel's model equals the plain version (mask and residual) on
    the adversarial pools and on seeded registry-like inputs; the
    in-contract pools take no floor division, the out-of-contract one
    (a duplicate entry, 2 and 4, 3 and 9) takes some, and its residuals
    still equal c // prod."""
    w = 32 if dtype == np.int32 else 64
    cases = chip_smoke().adversarial_flat_inputs(DTYPES[dtype],
                                                 device="cpu")["factorize"]
    cases.append(tuple(_t(x) for x in kernel_inputs(300, 70, dtype, seed=5)))
    for i, (comps, pool) in enumerate(cases):
        mask, res, floors = _factorize_model(comps.tolist(), pool.tolist(),
                                             w)
        m_ref, r_ref = tref.factorize_squarefree_ref(comps, pool)
        np.testing.assert_array_equal(np.asarray(mask, bool), m_ref.numpy())
        assert res == r_ref.tolist()
        assert res == [c // math.prod(p for p, hit in zip(pool.tolist(), row)
                                      if hit) if c else 0
                       for c, row in zip(comps.tolist(), mask)]
        out_of_contract = len(set(p for p in pool.tolist() if p > 1)) < \
            sum(p > 1 for p in pool.tolist())
        assert (floors > 0) == out_of_contract, (i, floors)


def _walk_order(thread_bits, E):
    """``walk()``'s order of a row's hits: lane l reads the 16-bit masks of
    threads 8 l .. 8 l + 7 as four little-endian words; lanes with a hit
    in ballot order, then each word's set bits ascending."""
    words = [thread_bits[2 * i] | thread_bits[2 * i + 1] << 16
             for i in range(len(thread_bits) // 2)]
    order = []
    for src in range(32):
        for k in range(4):
            bits = words[4 * src + k]
            while bits:
                b = _ctz(bits)
                bits &= bits - 1
                order.append((8 * src + 2 * k + (b >> 4)) * E + (b & 15))
    return order


@pytest.mark.parametrize("E", [4, 8, 16])
def test_flat_mask_bytes_and_walk_order(E):
    """``store_mask()`` spreads each nibble of hit bits to four 0/1 bytes
    with one multiply; ``walk()`` visits a chunk's hits in pool order,
    at every entry count a thread may own."""
    for nib in range(16):
        spread = nib * 0x00204081 & 0x01010101 & 0xFFFFFFFF
        assert spread.to_bytes(4, "little") == bytes(
            (nib >> i) & 1 for i in range(4))
    rng = np.random.default_rng(E)
    for density in (0.0, 0.01, 0.2, 1.0):
        hit = rng.random(256 * E) < density
        thread_bits = [sum(int(hit[t * E + e]) << e for e in range(E))
                       for t in range(256)]
        assert _walk_order(thread_bits, E) == np.flatnonzero(hit).tolist()


@pytest.mark.parametrize("w", WIDTHS)
def test_flat_gcd_model(w):
    """The binary gcd's model against ``math.gcd``: consecutive Fibonacci
    pairs to the type's top (and swapped), 0 on either side and both,
    equal sides, a side of 1, the adversarial pairs and 20,000 seeded
    draws (half sharing a factor).  A step removes at least one bit, so
    no pair takes more than 2 w steps."""
    top = (1 << (w - 1)) - 1
    dtype = torch.int32 if w == 32 else torch.int64
    a, b = chip_smoke().adversarial_flat_inputs(dtype, device="cpu")["gcd"][0]
    pairs = list(zip(a.tolist(), b.tolist()))
    fib = chip_smoke().fibonacci_pairs(top)
    assert sum(fib[-1]) > top                 # the next term would overflow
    pairs += fib + [(y, x) for x, y in fib]
    rng = np.random.default_rng(w)
    xs = rng.integers(0, top, size=(20_000, 3), dtype=np.int64).tolist()
    for i, (x, y, s) in enumerate(xs):
        if i % 2:
            s = s % (1 << 20) + 1
            x, y = x // s * s, y // s * s
        pairs.append((x, y))
    reduced = 0
    for x, y in pairs:
        g, wide, narrow, red = _gcd_model(x, y, w)
        assert g == math.gcd(x, y), (x, y)
        assert wide + narrow <= 2 * w, (x, y)
        reduced += red
    assert reduced > 0
    assert _gcd_model(0, 0, w)[0] == 0 and _gcd_model(7, 0, w)[0] == 7


def test_flat_gcd_model_on_exchange_pairs():
    """Pairs as the sharded exchange makes them: query chunks (products
    of primes up to 2**62) against cross composites of two primes (about
    24 bits) and pads of 1.  The wide side is reduced by the Montgomery
    steps, after which no pair needs more than 2 * 32 binary steps, and
    every gcd equals ``math.gcd``."""
    rng = np.random.default_rng(5)
    primes = first_primes(550).tolist()
    chunks = []
    for _ in range(40):
        c = 1
        for q in rng.permutation(primes).tolist():
            if c * q >= 2**62:
                break
            c *= q
        chunks.append(c)
    cross = [int(rng.choice(primes)) * int(rng.choice(primes))
             for _ in range(60)] + [1, 1, 1]
    n_red = 0
    for a in chunks:
        for b in cross:
            g, wide, narrow, red = _gcd_model(a, b, 64)
            assert g == math.gcd(a, b), (a, b)
            assert wide == 0 and narrow <= 64
            n_red += red
    assert n_red > len(chunks) * 50


# The flat mask (``csrc/divmask.cu``) as the card runs it: the launch's
# layout, the branch each row takes and the store each row's span gets.

_M32, _M64 = (1 << 32) - 1, (1 << 64) - 1
#: the card's SM count that the launch sizes its grid by
_SMS = 132


def _small_entry(p):
    """``small_entry()``: an entry below 2**32 at int64, (q**-1 mod 2**64,
    q, 2**t - 1), the inverse lifted from the 32-bit one by one Newton
    round."""
    t = _ctz(p)
    q = p >> t
    x = _inverse(q, 32)
    return x * ((2 - q * x) & _M64) & _M64, q, (1 << t) - 1


def _narrow_divides(e, c):
    """``narrow_divides()``: c < 2**32, the 32-bit test on the low words."""
    qinv, q, low = e
    x = c * (qinv & _M32) & _M32
    return ((c & low) | (x * q >> 32)) == 0


def _wide_divides(e, c):
    """``wide_divides()``: the bits of (c q**-1 mod 2**64) * q above 2**64
    from two 32-bit products by q."""
    qinv, q, low = e
    x = c * qinv & _M64
    top = (x >> 32) * q + ((x & _M32) * q >> 32)
    assert top < 1 << 64
    return ((c & _M32 & low) | (top >> 32)) == 0


def _divmask_layout(n, np_, w):
    """``launch()``: (E, threads, chunks, rows) for an n x np_ mask."""
    E = (4 if np_ <= 1024 else 8 if np_ <= 2048 or w == 64 else 16)
    groups = -(-np_ // E)
    threads = 32
    while threads < 256 and threads < groups:
        threads *= 2
    chunks = -(-groups // threads)
    shift = 5
    while shift > 0 and chunks * -(-n // (1 << shift)) < _SMS:
        shift -= 1
    return E, threads, chunks, 1 << shift


def _divmask_model(comps, pool, w, offset=0):
    """``divmask_kernel`` thread by thread: ``(mask, tally)``.  The tally
    counts each row class a thread met (zero, one, narrow, wide, general),
    the threads that held an entry of 2**32 or more, and the vector and
    byte stores (a span is aligned when the mask byte at ``offset`` + its
    index is a multiple of E)."""
    n, np_ = len(comps), len(pool)
    E, threads, chunks, rows = _divmask_layout(n, np_, w)
    mask = [[False] * np_ for _ in range(n)]
    tally = dict.fromkeys(("zero", "one", "narrow", "wide", "general",
                           "big_threads", "vector", "bytes"), 0)
    for row0 in range(0, n, rows):
        live_rows = min(rows, n - row0)
        for chunk in range(chunks):
            js = [(chunk * threads + t) * E for t in range(threads)]
            ents = [pool[j:min(j + E, np_)] for j in js]
            for j0, es in zip(js, ents):
                if not es:
                    continue
                big = w == 64 and any(p >> 32 for p in es)
                tally["big_threads"] += big
                live = [p > 1 for p in es]
                safe = [p if p > 1 else 1 for p in es]
                if w == 32 or big:
                    consts = [_entry_of(p, w) for p in safe]
                else:
                    consts = [_small_entry(p) for p in safe]
                for r in range(row0, row0 + live_rows):
                    c = comps[r]
                    if c <= 1:
                        kind = "zero" if c == 0 else "one"
                        bits = live if c == 0 else [False] * len(es)
                    else:
                        if w == 32 or big:
                            kind = "general"
                            tests = [_divides(e, c, w) for e in consts]
                        elif c >> 32 == 0:
                            kind = "narrow"
                            tests = [_narrow_divides(e, c) for e in consts]
                        else:
                            kind = "wide"
                            tests = [_wide_divides(e, c) for e in consts]
                        bits = [ok and t for ok, t in zip(live, tests)]
                    tally[kind] += 1
                    aligned = (offset + r * np_ + j0) % E == 0
                    tally["vector" if len(es) == E and aligned
                          else "bytes"] += 1
                    mask[r][j0:j0 + len(es)] = bits
    return mask, tally


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
def test_flat_mask_model_on_adversarial_inputs(dtype):
    """The mask kernel's model equals ``%`` and the plain version on
    ``chip_smoke.adversarial_flat_inputs`` (type edges, powers of two,
    the largest primes below 2**31, pads 0 and 1, zero rows, entries of
    2**32 and more at int64), with each pool also one entry short (spans
    off their alignment, byte stores), and on registry-like inputs; at
    int64 every row class is met, the general test only by threads that
    hold an entry of 2**32 or more."""
    w = 32 if dtype == np.int32 else 64
    cases = chip_smoke().adversarial_flat_inputs(DTYPES[dtype],
                                                 device="cpu")["factorize"]
    cases += [(c, p[:-1]) for c, p in cases]
    cases.append(tuple(_t(x) for x in kernel_inputs(300, 70, dtype, seed=9)))
    total = dict.fromkeys(("zero", "one", "narrow", "wide", "general",
                           "big_threads", "vector", "bytes"), 0)
    for comps, pool in cases:
        cl, pl = comps.tolist(), pool.tolist()
        mask, tally = _divmask_model(cl, pl, w)
        assert mask == [[p > 1 and c % p == 0 for p in pl] for c in cl]
        np.testing.assert_array_equal(
            np.asarray(mask, bool).reshape(len(cl), len(pl)),
            tref.divisibility_mask_ref(comps, pool).numpy())
        big = any(p >> 32 for p in pl)
        assert (tally["big_threads"] > 0) == big
        assert (tally["general"] > 0) == (w == 32 or big)
        for k in total:
            total[k] += tally[k]
    assert min(total[k] for k in ("zero", "one", "vector", "bytes")) > 0
    assert (min(total["narrow"], total["wide"]) > 0) == (w == 64)


@pytest.mark.parametrize("w", WIDTHS)
@pytest.mark.parametrize("seed", range(2))
def test_flat_mask_model_on_random_draws(w, seed):
    """50,000 seeded (value, entry) draws per seed (10**5 per width):
    entries odd, even, powers of two, small, 0 and 1, and at int64 also
    of 2**32 and more; values narrow and wide, 0 and 1, half of them
    multiples of the entry.  The test the kernel picks for the pair (by
    the value's width and whether the entry is below 2**32) equals
    ``%``; then a 64 x 300 mask of such values and entries equals the
    plain version."""
    rng = np.random.default_rng(7 * w + seed)
    top = (1 << (w - 1)) - 1
    n = 50_000
    kind = rng.integers(0, 6, size=n)
    ps = [int(x) for x in rng.integers(2, top, size=n, dtype=np.int64)]
    cs = [int(x) for x in rng.integers(0, top, size=n, dtype=np.int64)]
    shifts = rng.integers(0, w - 2, size=n)
    narrow = rng.random(n) < 0.5
    classes = dict.fromkeys(("narrow", "wide", "general"), 0)
    for i in range(n):
        p = ps[i]
        if kind[i] == 1:
            p = max(p >> int(shifts[i]) & ~0xFF, 2)
        elif kind[i] == 2:
            p = 1 << int(shifts[i]) or 2
        elif kind[i] == 3:
            p = int(rng.integers(0, 64))
        elif kind[i] == 4 and w == 64:
            p = p & _M32 or 3
        c = cs[i] & _M32 if narrow[i] and w == 64 else cs[i]
        if i % 2 and p > 1:
            c = (c // p) * p
        elif i % 7 == 0:
            c = i % 2
        want = p > 1 and c % p == 0
        if p <= 1 or c <= 1:
            got = p > 1 and c == 0
        elif w == 32 or p >> 32:
            got, cls = _divides(_entry_of(p, w), c, w), "general"
        elif c >> 32 == 0:
            got, cls = _narrow_divides(_small_entry(p), c), "narrow"
        else:
            got, cls = _wide_divides(_small_entry(p), c), "wide"
        assert got == want, (c, p)
        if p > 1 and c > 1:
            classes[cls] += 1
    assert classes["general"] > 0
    assert (min(classes["narrow"], classes["wide"]) > 1000) == (w == 64)
    pool = [ps[i] if kind[i] != 4 or w == 32 else ps[i] & _M32
            for i in range(300)]
    pool[:3] = [0, 1, 2]
    comps = cs[:64]
    comps[:2] = [0, 1]
    comps[2:20] = [c // q * q for c, q in zip(comps[2:20], pool[5:23])]
    dtype = torch.int32 if w == 32 else torch.int64
    mask, _ = _divmask_model(comps, pool, w)
    np.testing.assert_array_equal(
        np.asarray(mask, bool),
        tref.divisibility_mask_ref(torch.tensor(comps, dtype=dtype),
                                   torch.tensor(pool, dtype=dtype)).numpy())


@pytest.mark.parametrize("w", WIDTHS)
def test_flat_mask_layout_fills_the_card(w):
    """At every shape the sharded refresh of ``case_batching``'s full trace
    gives the mask (256 x 512 to 4096 x 4096), the launch covers the pool
    with whole warps, gives every SM a block, and stores each row's span
    as whole vectors; a pool one entry short takes byte stores only at
    the ragged ends."""
    for n, np_ in [(256, 512), (512, 512), (512, 1024), (1024, 1024),
                   (1024, 2048), (2048, 2048), (2048, 4096), (4096, 4096)]:
        E, threads, chunks, rows = _divmask_layout(n, np_, w)
        assert threads % 32 == 0 and chunks * threads * E >= np_
        assert (chunks - 1) * threads * E < np_
        assert -(-n // rows) * chunks >= _SMS and 1 <= rows <= 32
        assert np_ % E == 0                   # every span whole and aligned


# --------------------------------------------------------------------------- #
# ops wrappers: padding, dtype pick, compaction — port vs reference           #
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("n,q,big", [(5, 3, False), (300, 40, False),
                                     (70, 9, True)])
def test_ops_match_reference(n, q, big):
    """Ragged sizes through both packages' ops (padding with 1 / 0, the
    int32/int64 pick at 2**31 - 1, host compaction)."""
    dtype = np.int64 if big else np.int32
    comps, primes = kernel_inputs(n, q, dtype, seed=n + q)
    comps, primes = comps.astype(np.int64), primes.astype(np.int64)
    scan = tops.divisibility_scan(comps, primes, device="cpu")
    scan_ref = jops.divisibility_scan(comps, primes)
    assert [list(x) for x in scan] == [list(x) for x in scan_ref]
    facs, res = tops.factorize_batch(comps, primes, device="cpu")
    facs_ref, res_ref = jops.factorize_batch(comps, primes)
    assert facs == facs_ref
    np.testing.assert_array_equal(res, res_ref)
    assert res.dtype == np.int64
    b = np.resize(primes * 3, n)
    g = tops.gcd_batch(comps, b, device="cpu")
    np.testing.assert_array_equal(g, jops.gcd_batch(comps, b))
    assert tops.factorize_batch_exact(comps, primes, device="cpu") == \
        jops.factorize_batch_exact(comps, primes)
    assert tops.gcd_batch_exact(comps, b, primes, device="cpu") == \
        jops.gcd_batch_exact(comps, b, primes)


@pytest.mark.parametrize("case", ["ragged", "int64", "compaction", "empty"])
def test_ops_reference_sweeps(case):
    """The reference's own wrapper sweeps (tests/test_kernels.py), run
    through the port on the CPU."""
    if case == "ragged":
        facs, resid = tops.factorize_batch([6, 35, 143, 101],
                                           [2, 3, 5, 7, 11, 13], device="cpu")
        assert facs == [[2, 3], [5, 7], [11, 13], []]
        assert list(resid) == [1, 1, 1, 101]
    elif case == "int64":
        big = 1_000_003 * 1_000_033
        facs, resid = tops.factorize_batch([big], [1_000_003, 1_000_033],
                                           device="cpu")
        assert facs[0] == [1_000_003, 1_000_033] and resid[0] == 1
    elif case == "compaction":
        idx = tops.divisibility_scan([6, 10, 15, 21], [2, 3, 5, 7],
                                     device="cpu")
        assert [list(i) for i in idx] == [[0, 1], [0, 2, 3], [1, 2], [3]]
    else:
        out = tops.divisibility_scan([], [3], device="cpu")
        assert len(out) == 1 and len(out[0]) == 0
        assert tops.gcd_batch([], [], device="cpu").size == 0
        assert tops.factorize_batch([], [2], device="cpu")[0] == []


@given(comps=st.lists(st.integers(0, 2**45), min_size=1, max_size=30),
       idx=st.lists(st.integers(0, len(PRIMES_SMALL) - 1), min_size=1,
                    max_size=12))
@settings(max_examples=12, deadline=None)
def test_ops_property_vs_reference(comps, idx):
    primes = [int(PRIMES_SMALL[i]) for i in idx] + [0, 1]
    assert [list(x) for x in tops.divisibility_scan(comps, primes,
                                                    device="cpu")] == \
        [list(x) for x in jops.divisibility_scan(comps, primes)]
    facs, res = tops.factorize_batch(comps, primes, device="cpu")
    facs_ref, res_ref = jops.factorize_batch(comps, primes)
    assert facs == facs_ref
    np.testing.assert_array_equal(res, res_ref)


# --------------------------------------------------------------------------- #
# input checks                                                                 #
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("bad,exc", [
    (lambda: tops.divisibility_scan([6, -1], [2], device="cpu"), ValueError),
    (lambda: tops.gcd_batch([4], [-2], device="cpu"), ValueError),
    (lambda: tops.factorize_batch_limbs(np.array([[-1, 1]]), [2],
                                        device="cpu"), ValueError),
    (lambda: tfac.divisibility_mask(torch.ones(3), torch.ones(3)), TypeError),
    (lambda: tfac.divisibility_mask(torch.ones(3, dtype=torch.int32),
                                    torch.ones(3, dtype=torch.int64)),
     ValueError),
    (lambda: tgcd.gcd(torch.arange(8)[::2], torch.arange(4)), ValueError),
])
def test_wrappers_reject_bad_input(bad, exc):
    with pytest.raises(exc):
        bad()


def test_cpu_tensors_do_not_count_launches():
    """A CPU tensor takes the plain version: no kernel, no launch."""
    from repro_torch.kernels import launch_counts
    before = launch_counts()
    tops.gcd_batch([12, 18], [8, 27], device="cpu")
    tops.divisibility_scan([6], [2], device="cpu")
    assert launch_counts() == before


# --------------------------------------------------------------------------- #
# the build (with a stand-in for nvcc: the real one runs on the card's host)  #
# --------------------------------------------------------------------------- #

_FAKE_NVCC = """#!/bin/sh
# stand-in for nvcc: keeps a temporary file in $TMPDIR while it "compiles"
# (longer for some sources), then checks it is still there
for last; do :; done
out=""; prev=""
for a in "$@"; do [ "$prev" = "-o" ] && out="$a"; prev="$a"; done
echo "ptxas info    : Used 8 registers" 
echo partial > "$TMPDIR/$$.s" || exit 3
case "$last" in *divmask*) ;; *) sleep 0.5 ;; esac
[ -f "$TMPDIR/$$.s" ] || { echo "can't open $TMPDIR/$$.s"; exit 1; }
echo lib > "$out"
"""


def test_build_all_runs_the_builds_side_by_side(tmp_path, monkeypatch):
    """One nvcc per source, started together, each with its own temporary
    directory (one build finishing early must not pull another's files
    away); each library lands under its hashed name with its log."""
    from repro_torch.kernels import KERNELS, build_all, cuda

    bindir = tmp_path / "bin"
    bindir.mkdir()
    nvcc = bindir / "nvcc"
    nvcc.write_text(_FAKE_NVCC)
    nvcc.chmod(0o755)
    monkeypatch.setenv("PATH", f"{bindir}{os.pathsep}{os.environ['PATH']}")
    monkeypatch.setattr(cuda, "build_dir", lambda: tmp_path / "build")
    (tmp_path / "build").mkdir()
    assert cuda.nvcc_path() == str(nvcc)
    build_all()
    for k in KERNELS.values():
        assert k.library_path().read_text() == "lib\n"
        assert "Used 8 registers" in k.build_log()
    assert sorted(p.name for p in (tmp_path / "build").iterdir()
                  if p.is_dir()) == []


def test_nvcc_lookup_names_every_place_tried(monkeypatch):
    from torch.utils import cpp_extension

    from repro_torch.kernels import cuda

    monkeypatch.setenv("PATH", "")
    monkeypatch.setenv("CUDA_HOME", "/nonexistent/cuda-home")
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setattr(cpp_extension, "CUDA_HOME", None)
    if os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("this host has a CUDA toolkit")
    with pytest.raises(RuntimeError) as err:
        cuda.nvcc_path()
    msg = str(err.value)
    for place in ("PATH", "/nonexistent/cuda-home/bin/nvcc",
                  "CUDA_PATH (unset)", "cpp_extension.CUDA_HOME (unset)",
                  "/usr/local/cuda/bin/nvcc"):
        assert place in msg, place


def test_build_dir_names_itself_when_it_cannot_be_made(tmp_path,
                                                       monkeypatch):
    """One build directory: when it cannot be created the error names it
    (no second place is tried)."""
    from repro_torch.kernels import cuda

    blocker = tmp_path / "not-a-dir"
    blocker.write_text("")
    monkeypatch.setattr(cuda, "BUILD_DIR", blocker / "build")
    with pytest.raises(RuntimeError) as err:
        cuda.build_dir()
    assert str(blocker / "build") in str(err.value)
    assert "cannot be created" in str(err.value)
    monkeypatch.setattr(cuda, "BUILD_DIR", tmp_path / "build")
    assert cuda.build_dir() == tmp_path / "build"
    assert (tmp_path / "build").is_dir()
