"""The port's wide (multi-limb) path against the reference: the plain
PyTorch limb versions vs the Pallas limb kernels in interpret mode, the
``ops`` limb wrappers and the ``*_exact`` dispatchers vs
``repro.kernels.ops``, wide successor tables (host, kernel, sharded),
wide serving caches, and ``case_scale`` at a reduced size vs the same
recipe on the reference's primitives.  The port runs with
``device="cpu"``.  Integer arithmetic: every comparison is exact."""

from torch_parity import first_primes

import itertools
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import enable_x64

from repro.core.assignment import PrimeAssigner as RefAssigner
from repro.core.composite import CompositeRegistry as RefRegistry
from repro.core.composite import encode_relationship as ref_encode
from repro.core.composite import pack_limbs as ref_pack_limbs
from repro.core.engine.shard import PrimeSpacePartition as RefPartition
from repro.core.engine.shard import \
    sharded_successor_table as ref_sharded_successor_table
from repro.core.engine.tables import successor_table as ref_successor_table
from repro.core.primes import CacheLevel as RefLevel
from repro.core.primes import HierarchicalPrimeAllocator as RefAllocator
from repro.kernels import ops as jops
from repro.kernels.factorize import (divisibility_mask_limbs_pallas,
                                     factorize_limbs_pallas)
from repro.kernels.gcd import gcd_limbs_pallas
from repro.serving.engine import make_kv_backend as ref_make_kv_backend
from repro_torch.cases import build_scale_universe, case_scale
from repro_torch.core import (CacheLevel, CompositeRegistry,
                              HierarchicalPrimeAllocator, PrimeAssigner)
from repro_torch.core.composite import pack_limbs, unpack_limbs
from repro_torch.core.engine.shard import (PrimeSpacePartition,
                                           sharded_successor_table)
from repro_torch.core.engine.tables import successor_table
from repro_torch.kernels import factorize as tfac
from repro_torch.kernels import gcd as tgcd
from repro_torch.kernels import launch_counts
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.serving.engine import make_kv_backend

# limb widths of 2, 3, 8 and 32 limbs
WIDTHS = (64, 96, 256, 1024)

#: primes < 2**31 that the pools below never hold
OUTSIDE = (2_147_483_647, 1_000_000_007)


def _pool(rng, p=512):
    """``p`` entries: distinct primes (small ones, ~1e6 and ~2**30), 13
    twice, and the pads 0, 1, 0 — shuffled."""
    primes = list(first_primes(p - 11))
    primes += [1_000_003, 1_000_033, 1_000_037, 999_983, 1_073_741_789,
               1_073_741_827, 2_147_483_629]
    primes = primes[:p - 4]
    primes += [primes[5], 0, 1, 0]
    return rng.permutation(np.asarray(primes, dtype=np.int64))


def _composites(rng, n, bits, pool):
    """Python ints < 2**bits: products of distinct pool primes, products
    with a squared prime (non-squarefree), random values, and 0 / 1."""
    live = [int(p) for p in pool if p > 1]
    out = []
    for i in range(n):
        kind = i % 4
        if kind == 3:
            v = 0
            for _ in range(-(-bits // 32)):
                v = (v << 32) | int(rng.integers(0, 2**32))
            out.append(v % (1 << bits))
            continue
        v = 1
        for q in rng.permutation(live):
            if (v * int(q)).bit_length() > bits - 1 or rng.random() < 0.4:
                continue
            v *= int(q)
        if kind == 2:
            sq = int(live[int(rng.integers(0, 40))]) ** 2
            if (v * sq).bit_length() < bits:
                v *= sq
        out.append(v)
    # 0, 1, a square times a prime, and a product holding the prime that
    # the pool lists twice
    out[:4] = [0, 1, 3 * 3 * 5, 13 * 7]
    return out


def _limb_inputs(bits, seed, n=256):
    rng = np.random.default_rng(seed)
    L = -(-bits // 32)
    pool = _pool(rng)
    a = _composites(rng, n, bits, pool)
    b = list(np.roll(np.asarray(a, dtype=object), 3))
    # pairs with a common prime the pool does not hold: the kernel's pool
    # product and math.gcd differ there
    for i in range(8, 16):
        q = OUTSIDE[i % 2]
        a[i] = q * (a[i] % (1 << (bits - 32)) or 1)
        b[i] = q * 3
    b[0], b[1] = 0, 7                         # a zero pair, a value-1 row
    return pack_limbs(a, L), pack_limbs(b, L), pool


def _pallas(fn, *arrays):
    with enable_x64(True):
        out = fn(*[jnp.asarray(x) for x in arrays])
        if isinstance(out, (tuple, list)):
            return tuple(np.asarray(o) for o in out)
        return np.asarray(out)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


# --------------------------------------------------------------------------- #
# plain versions vs the Pallas kernels (interpret mode), one block each       #
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("bits", WIDTHS)
def test_plain_limb_mask_matches_pallas(bits):
    a, _, pool = _limb_inputs(bits, seed=bits)
    want = _pallas(divisibility_mask_limbs_pallas, a, pool)
    got = tref.divisibility_mask_limbs_ref(_t(a), _t(pool)).numpy()
    np.testing.assert_array_equal(got, want)
    assert want[0].sum() == (pool > 1).sum()  # a zero row: every prime > 1
    assert not want[1].any()                  # value 1: none


@pytest.mark.parametrize("bits", WIDTHS)
def test_plain_limb_factorize_matches_pallas(bits):
    a, _, pool = _limb_inputs(bits, seed=bits + 1)
    mask, residual = _pallas(factorize_limbs_pallas, a, pool)
    m, r = tref.factorize_limbs_ref(_t(a), _t(pool))
    np.testing.assert_array_equal(m.numpy(), mask)
    np.testing.assert_array_equal(r.numpy(), residual)
    # a non-squarefree row keeps its repeated factor; a prime the pool
    # lists twice divides twice (floor division)
    assert unpack_limbs(residual[:4]) == [0, 1, 3, 0]


@pytest.mark.parametrize("bits", WIDTHS)
def test_plain_limb_gcd_matches_pallas(bits):
    a, b, pool = _limb_inputs(bits, seed=bits + 2)
    want = _pallas(gcd_limbs_pallas, a, b, pool)
    got = tref.gcd_limbs_ref(_t(a), _t(b), _t(pool)).numpy()
    np.testing.assert_array_equal(got, want)
    va, vb, g = unpack_limbs(a), unpack_limbs(b), unpack_limbs(want)
    # the zero pair: the product of every pool prime > 1, truncated
    assert g[0] == math.prod(int(p) for p in pool if p > 1) % (
        1 << (32 * a.shape[1]))
    assert g[1] == 1
    # a common prime outside the pool: not math.gcd
    assert any(g[i] != math.gcd(va[i], vb[i]) for i in range(8, 16))


def test_plain_limb_versions_on_empty_and_ragged_input():
    """Shapes the kernels are never given by ``ops`` (no padding): empty
    and ragged N and P, one limb."""
    pool = _t(np.array([2, 3, 0, 7, 1], dtype=np.int64))
    limbs = _t(pack_limbs([0, 1, 6, 21, 4, 2**32 - 1], 1))
    m = tref.divisibility_mask_limbs_ref(limbs, pool)
    assert m.shape == (6, 5) and m[2].tolist() == [True, True, False, False,
                                                   False]
    _, r = tref.factorize_limbs_ref(limbs, pool)
    assert unpack_limbs(r.numpy()) == [0, 1, 1, 1, 2, (2**32 - 1) // 3]
    g = tref.gcd_limbs_ref(limbs, _t(pack_limbs([5, 1, 3, 14, 2, 3], 1)),
                           pool)
    assert unpack_limbs(g.numpy()) == [1, 1, 3, 7, 2, 3]
    empty = limbs[:0]
    assert tref.divisibility_mask_limbs_ref(empty, pool).shape == (0, 5)
    assert tref.factorize_limbs_ref(empty, pool)[1].shape == (0, 1)
    assert tref.gcd_limbs_ref(empty, empty, pool).shape == (0, 1)
    assert tref.factorize_limbs_ref(limbs, pool[:0])[1].equal(limbs)


# --------------------------------------------------------------------------- #
# the limb kernels' arithmetic (csrc/limb_mod.cuh), modelled in Python ints   #
# --------------------------------------------------------------------------- #
# Each function below is written as the CUDA source writes it, with 32- and
# 64-bit wraparound made explicit, so that the arithmetic the card runs is
# held against ``%`` here; the kernels themselves run only on the card.

_M32, _M64 = (1 << 32) - 1, (1 << 64) - 1
_ZERO_ROW_TZ, _NEVER_TZ = _M32 - 1, _M32

#: the pool entries the card checks add: small and large powers of two, an
#: even composite, the largest prime below 2**31 and its neighbours
ADVERSARIAL_POOL = (2, 4, 6, 2**30, 2_147_483_647, 2_147_483_629)


def _entry_constants(p):
    """``pfcs::entry_constants``: {q, -q**-1 mod 2**32, t, p}; an entry
    <= 1 gets t = 2**32 - 1, above every row's trailing zero count."""
    if p <= 1:
        return (0, 0, _NEVER_TZ, 0)
    pp = p & _M32
    t = (pp & -pp).bit_length() - 1          # __ffs(pp) - 1
    q = pp >> t
    inv = q
    for _ in range(4):
        inv = (inv * ((2 - q * inv) & _M32)) & _M32
    return (q, -inv & _M32, t, pp)


def _redc_step(s, limb, q, qneg_inv):
    """``pfcs::redc_step``: REDC(s + limb) with no final correction."""
    t = (s + limb) & _M64
    m = ((t & _M32) * qneg_inv) & _M32
    return ((t + m * q) & _M64) >> 32 & _M32


def _fold_limb_slice(words, k0, n, tz):
    """``pfcs::fold_limb_slice`` for the 32 lanes' words of one slice."""
    nz = [k for k, v in enumerate(words) if v]
    if not nz:
        return n, tz
    n = k0 + nz[-1] + 1
    if tz == _ZERO_ROW_TZ:
        low = words[nz[0]]
        tz = 32 * (k0 + nz[0]) + (low & -low).bit_length() - 1
    return n, tz


def _row_counts(row):
    n, tz = 0, _ZERO_ROW_TZ
    for k0 in range(0, len(row), 32):
        n, tz = _fold_limb_slice(list(row[k0:k0 + 32]), k0, n, tz)
    return n, tz


def _residue(k, row, n):
    """The residue ``pfcs::residues4`` takes for one entry: the steps run
    for every entry, and stay <= q + 1 (<= 1 for q of 0 or 1)."""
    q, qinv = k[0], k[1]
    s = 0
    for j in range(n):
        s = _redc_step(s, row[j], q, qinv)
        assert s <= (q + 1 if q > 1 else 1)
    return s


def _entry_settles(k, s, tz):
    """``pfcs::entry_settles``: for q of 1 the residue is 0 or 1 = q."""
    q, _, t, _ = k
    return t <= tz and (s == 0 or s == q)


def _entry_divides(k, row, n, tz):
    """``pfcs::entry_divides``: the one-entry test of the gcd's second
    side; every intermediate ``s`` stays <= q + 1."""
    q, qinv, t, _ = k
    if t > tz:
        return False
    if q == 1:
        return True
    s = 0
    for j in range(n):
        s = _redc_step(s, row[j], q, qinv)
        assert s <= q + 1
    return s == 0 or s == q


def _mul_warp(g, q):
    """``mul_warp`` of gcd_limbs.cu: g <- g * q mod 2**(32 L), 32 limbs
    (lanes) at a time, the carries rippled by one addition of the
    generate and propagate masks."""
    below = 0
    for k0 in range(0, len(g), 32):
        v = [g[k] * q if k < len(g) else 0 for k in range(k0, k0 + 32)]
        hi = [x >> 32 for x in v]
        up = [below] + hi[:31]
        sums = [(x & _M32) + u for x, u in zip(v, up)]
        gen = sum(1 << lane for lane, x in enumerate(sums) if x >> 32)
        prop = sum(1 << lane for lane, x in enumerate(sums)
                   if x & _M32 == _M32)
        ripple = gen + (gen | prop)
        carries = (ripple & _M32) ^ gen ^ (gen | prop)
        for lane in range(32):
            if k0 + lane < len(g):
                g[k0 + lane] = ((sums[lane] & _M32)
                                + (carries >> lane & 1)) & _M32
        below = (hi[31] + (ripple >> 32)) & _M32


def _divmask_model(limbs, pool):
    consts = [_entry_constants(int(p)) for p in pool]
    out = np.zeros((len(limbs), len(pool)), dtype=bool)
    for i, row in enumerate(limbs.tolist()):
        n, tz = _row_counts(row)
        for j, k in enumerate(consts):
            out[i, j] = _entry_settles(k, _residue(k, row, n), tz)
    return out


def _gcd_model(a, b, pool):
    """gcd_limbs.cu over the pairs in order, as one warp takes them: the
    side whose mask is cached (a row equal to the last one tested in
    full), else a side equal to the previous pair's, else the side with
    fewer significant limbs, is tested against every entry; the other
    side only where it divides; common entries multiplied in pool order
    by the warp."""
    consts = [_entry_constants(int(p)) for p in pool]
    out = np.zeros_like(a)
    cached, mask, prev = None, None, (None, None)
    for i, (ra, rb) in enumerate(zip(a.tolist(), b.tolist())):
        (na, tza), (nb, tzb) = _row_counts(ra), _row_counts(rb)
        if cached is not None and cached in (ra, rb):
            a_first = ra == cached
        else:
            a_first = ra == prev[0] or (rb != prev[1] and na <= nb)
            first = (ra, na, tza) if a_first else (rb, nb, tzb)
            cached = first[0]
            mask = [_entry_settles(k, _residue(k, *first[:2]), first[2])
                    for k in consts]
        second = (rb, nb, tzb) if a_first else (ra, na, tza)
        prev = (ra, rb)
        g = [1] + [0] * (len(ra) - 1)
        for k, divides_first in zip(consts, mask):
            if divides_first and _entry_divides(k, *second):
                _mul_warp(g, k[3])
        out[i] = g
    return out


def _x_of(row):
    return sum(v << (32 * k) for k, v in enumerate(row))


def test_montgomery_constants_invert_every_odd_part():
    """-q**-1 mod 2**32 by four Newton rounds, for odd parts across
    [3, 2**31), and the split p = 2**t * q of even entries."""
    rng = np.random.default_rng(7)
    ps = [int(p) for p in rng.integers(2, 2**31, size=20_000)]
    for p in ps + list(ADVERSARIAL_POOL) + [3, 5, 2**31 - 1, 2**31 - 2]:
        q, qinv, t, pp = _entry_constants(p)
        assert pp == p and q << t == p and q & 1
        assert (q * qinv) & _M32 == _M32            # q * -q**-1 = -1
    assert _entry_constants(0) == _entry_constants(1) == (0, 0, _M32, 0)
    assert _entry_constants(2**30)[:3:2] == (1, 30)


@pytest.mark.parametrize("p", [2, 3, 4, 6, 9, 2**30, 2**31 - 1,
                               2_147_483_629, 3 * 2**29])
def test_montgomery_model_on_edge_limbs(p):
    """Every row of 1 to 3 limbs from {0, 1, 2**32 - 1}, and rows whose
    top or lowest nonzero limb is the last, a middle or the first:
    the model's answer equals ``x % p == 0``, and its residue is
    x * 2**(-32 n) mod q after the row's n significant limbs."""
    edge = (0, 1, _M32)
    rows = [list(r) for width in (1, 2, 3)
            for r in np.array(np.meshgrid(*[edge] * width)).T.reshape(-1,
                                                                     width)]
    rows += [[0] * k + [v] + [0] * (4 - k) for k in range(5)
             for v in (1, p, _M32, p << 1 & _M32)]
    rows += [[_M32] * 32, [0] * 31 + [p], [p] + [0] * 31]
    k = _entry_constants(p)
    q = k[0]
    for row in rows:
        row = [int(v) for v in row]
        x = _x_of(row)
        n, tz = _row_counts(row)
        assert n == -(-x.bit_length() // 32)
        assert tz == ((x & -x).bit_length() - 1 if x else _ZERO_ROW_TZ)
        assert _entry_divides(k, row, n, tz) == (x % p == 0)
        assert _entry_settles(k, _residue(k, row, n), tz) == (x % p == 0)
        if q > 1:
            s = 0
            for j in range(n):
                s = _redc_step(s, row[j], q, k[1])
            assert s % q == x * pow(2, -32 * n, q) % q


@pytest.mark.parametrize("seed", range(4))
def test_montgomery_model_on_random_draws(seed):
    """25,000 seeded draws per seed (10**5 in all): entries across [0,
    2**31) (odd, even, powers of two, 0 and 1), values of 1 to 4 limbs,
    half of them multiples of the entry; both of the model's tests (the
    one-entry loop and residue-then-settle) equal ``%``."""
    rng = np.random.default_rng(1000 + seed)
    n_draws = 25_000
    kind = rng.integers(0, 4, size=n_draws)
    ps = rng.integers(0, 2**31, size=n_draws)
    ps = np.where(kind == 1, ps & ~np.int64(0xFF), ps)          # even
    ps = np.where(kind == 2, 1 << rng.integers(0, 31, size=n_draws), ps)
    ps = np.where(kind == 3, rng.integers(0, 64, size=n_draws), ps)
    widths = rng.integers(1, 5, size=n_draws)
    words = rng.integers(0, 2**32, size=(n_draws, 4), dtype=np.uint64)
    hits = 0
    for i in range(n_draws):
        p = int(ps[i])
        x = _x_of([int(w) for w in words[i, :widths[i]]])
        if i % 2 and p > 1:
            x = (x * p) % (1 << (32 * 4))
        row = [(x >> (32 * k)) & _M32 for k in range(4)]
        n, tz = _row_counts(row)
        k = _entry_constants(p)
        want = p > 1 and x % p == 0
        assert _entry_divides(k, row, n, tz) == want, (p, x)
        assert _entry_settles(k, _residue(k, row, n), tz) == want, (p, x)
        hits += want
    assert hits > n_draws // 3


def _adversarial_limbs(n_limbs, pool, rng, n=24):
    """Rows the card checks add: all limbs 0xFFFFFFFF, rows whose top
    nonzero limb is the first, a middle one or the last, multiples of
    the adversarial entries, zero and value-1 rows."""
    L = n_limbs
    rows = [[_M32] * L, [0] * L, [1] + [0] * (L - 1)]
    for top in sorted({0, L // 2, L - 1}):
        rows.append([int(v) for v in rng.integers(0, 2**32, size=top)]
                    + [int(rng.integers(1, 2**32))] + [0] * (L - 1 - top))
    for p in ADVERSARIAL_POOL:
        x = p * int(rng.integers(1, 2**31)) << int(rng.integers(0, 3))
        rows.append([(x >> (32 * k)) & _M32 for k in range(L)])
    while len(rows) < n:
        x = math.prod(int(q) for q in rng.choice(pool[pool > 1], size=3))
        x %= 1 << (32 * L)
        rows.append([(x >> (32 * k)) & _M32 for k in range(L)])
    return np.asarray(rows, dtype=np.int64)


@pytest.mark.parametrize("n_limbs", [1, 4, 32, 33, 64])
def test_warp_multiply_model_matches_big_ints(n_limbs):
    """The warp's multiply equals g * q mod 2**(32 L) on values built to
    ripple carries: each limb, with odds 1/2, is chosen so that its low
    product word plus the high word from below is 0xFFFFFFFF (a carry
    coming in must pass on), and across the 32-limb slices."""
    rng = np.random.default_rng(n_limbs)
    top = 1 << (32 * n_limbs)
    passed = 0
    for _ in range(400):
        q = int(rng.integers(1, 2**30)) * 2 + 1
        q_inv = pow(q, -1, 1 << 32)
        g, hi = [], 0
        for _ in range(n_limbs):
            v = (int(rng.integers(0, 2**32)) if rng.random() < 0.5
                 else (_M32 - hi) * q_inv & _M32)
            g.append(v)
            hi = v * q >> 32
        want = _x_of(g) * q % top
        _mul_warp(g, q)
        assert _x_of(g) == want
        passed += 1
    assert passed == 400


@pytest.mark.parametrize("n_limbs", [2, 3, 8, 32])
def test_kernel_models_match_plain_versions(n_limbs):
    """The whole limb mask and limb gcd as the CUDA kernels compute them
    (significant limbs only, the cached or the shorter side first, lazy
    Montgomery, the product by the warp's carry ripple) equal the plain
    versions on the adversarial entries and rows, duplicates, pads and
    repeated rows included."""
    rng = np.random.default_rng(n_limbs)
    pool = np.asarray(list(ADVERSARIAL_POOL) + [3, 5, 7, 1_000_003, 13, 13,
                                                0, 1, 0], dtype=np.int64)
    pool = rng.permutation(pool)
    a = _adversarial_limbs(n_limbs, pool, rng)
    b = np.roll(a, 5, axis=0)
    b[1] = 0                                          # a zero pair
    b[3] = a[3] * 0                                   # a zero side only
    a[10:14] = a[9]                                   # a row repeated
    b[12] = a[9]                                      # a cached b side
    np.testing.assert_array_equal(
        _divmask_model(a, pool),
        tref.divisibility_mask_limbs_ref(_t(a), _t(pool)).numpy())
    np.testing.assert_array_equal(
        _gcd_model(a, b, pool),
        tref.gcd_limbs_ref(_t(a), _t(b), _t(pool)).numpy())


# The limb factorization's residual (csrc/factorize_limbs.cu): exact
# division by the odd part q, least significant limb first (Jebelean), a
# batch of up to 32 hits as a pipeline across a warp's lanes, the powers
# of two shifted out at the end of a batch, and, only where a hit of the
# batch no longer divides the running residual, the batch floor-divided
# by the same pipeline run from the most significant limb.

def _limbs_of(x, n_limbs):
    return [(x >> (32 * k)) & _M32 for k in range(n_limbs)]


def _hit_constants(p):
    """A hit's (q, q**-1 mod 2**32, t) from ``pfcs::entry_constants``."""
    q, qneg_inv, t, _ = _entry_constants(p)
    return q, -qneg_inv & _M32, t


def _exact_div(limbs, q, qinv):
    """One lane of ``exact_pipeline()``: ``(quotient limbs, final carry)``
    of the limbs divided by odd q; the carry is 0 exactly when q divides,
    and the quotient is then exact."""
    carry, out = 0, []
    for s in limbs:
        x = (s - carry) & _M32
        borrow = int(s < carry)
        out.append(x * qinv & _M32)
        carry = (out[-1] * q >> 32) + borrow
        assert carry <= q
    return out, carry


def _pipeline(cur, n, lanes):
    """``exact_pipeline()`` step by step: at step s lane h takes limb
    s - h from lane h - 1's output of the step before (the shuffle), lane
    0 from the residual; ``(the last lane's limbs, each lane's carry)``."""
    m = len(lanes)
    out, carry, result = [0] * 32, [0] * 32, [0] * n
    for s in range(n + m - 1):
        before = out[:]
        for lane in range(32):
            k = s - lane
            if lane == 0:
                inp = cur[k] if k < n else 0
            else:
                inp = before[lane - 1]
            if lane < m and 0 <= k < n:
                q, qinv = lanes[lane]
                x = (inp - carry[lane]) & _M32
                borrow = int(inp < carry[lane])
                out[lane] = x * qinv & _M32
                carry[lane] = (out[lane] * q >> 32) + borrow
                if lane == m - 1:
                    result[k] = out[lane]
    return result, carry[:m]


def _shift_out(limbs, n, T):
    """``shift_out()``: the n limbs shifted right by T bits, limb k from
    limbs k + T // 32 and the one above it."""
    w, b = T >> 5, T & 31
    out = list(limbs)
    for k in range(n):
        lo = limbs[k + w] if k + w < n else 0
        hi = limbs[k + w + 1] if k + w + 1 < n else 0
        out[k] = (lo >> b | hi << (32 - b)) & _M32 if b else lo
    return out


def _floor_pipeline(cur, n, ps):
    """``floor_pipeline()`` step by step: lane h floor-divides by hit h
    the limbs lane h - 1 passes it, most significant first, each step a
    64-by-32 division by the reciprocal floor((2**64 - 1) / p) with at
    most one correction; the last lane's limbs."""
    m = len(ps)
    mus = [_M64 // p for p in ps]
    out, rem, result = [0] * 32, [0] * 32, [0] * n
    for s in range(n + m - 1):
        before = out[:]
        for lane in range(min(m, 32)):
            j = s - lane
            if not 0 <= j < n:
                continue
            inp = cur[n - 1 - j] if lane == 0 else before[lane - 1]
            c = rem[lane] << 32 | inp
            assert c < ps[lane] << 32
            quo = c * mus[lane] >> 64
            r = c - quo * ps[lane]
            if r >= ps[lane]:
                r -= ps[lane]
                quo += 1
            assert r < ps[lane] and quo == c // ps[lane]
            out[lane], rem[lane] = quo, r
            if lane == m - 1:
                result[n - 1 - j] = quo
    return result


def _divide_batch(r, ps, tally):
    """``divide_batch()``: the residual ``r`` divided by the hits ``ps``
    (at most 32, in pool order).  The exact pipeline runs over them all;
    where every lane's carry is zero and the powers of two sum to at most
    the residual's trailing zero bits, its result is shifted by that sum;
    else the batch is floor-divided from the residual it started from."""
    consts = [_hit_constants(p) for p in ps]
    n = r["n"]
    out, carries = _pipeline(r["cur"], n, [(q, i) for q, i, _ in consts])
    T = sum(t for _, _, t in consts)
    exact = not any(carries) and T <= r["tz"]
    if not exact:
        out = _floor_pipeline(r["cur"], n, ps)
    tally["exact" if exact else "floor"] += 1
    other = r["other"]
    other[n:r["n_other"]] = [0] * max(r["n_other"] - n, 0)
    other[:n] = out
    assert not any(other[n:])
    r["cur"], r["other"] = (_shift_out(other, n, T) if exact else other,
                            r["cur"])
    r["n_other"] = n
    r["n"], r["tz"] = _row_counts(r["cur"])


def _factorize_limbs_model(limbs, pool):
    """``factorize_limbs_kernel``: the mask by the Montgomery test; each
    nonzero row divided by its hits piece by piece (1024 entries), in
    pool order, in batches of up to 32; ``(mask, residual, tally)``."""
    mask = _divmask_model(limbs, pool)
    residual = np.zeros_like(limbs)
    tally = {"exact": 0, "floor": 0, "batches": 0}
    for i, row in enumerate(limbs.tolist()):
        n, tz = _row_counts(row)
        r = {"cur": list(row), "other": [0] * len(row), "n": n, "tz": tz,
             "n_other": 0}
        for base in range(0, len(pool) if n else 0, 1024):
            hits = [int(pool[j]) for j in range(base, min(base + 1024,
                                                          len(pool)))
                    if mask[i, j]]
            for b0 in range(0, len(hits), 32):
                _divide_batch(r, hits[b0:b0 + 32], tally)
                tally["batches"] += 1
        residual[i] = r["cur"]
    return mask, residual, tally


_EDGE_ENTRIES = (2, 3, 4, 6, 9, 2**30, 2_147_483_647, 2_147_483_629,
                 1_000_003, 3 * 2**29)


@pytest.mark.parametrize("n_limbs", [1, 2, 3, 8, 32])
def test_exact_division_model_on_edge_limbs(n_limbs):
    """Every edge row (all limbs 0xFFFFFFFF, a top nonzero limb at limb 0,
    a middle one and the last, multiples of 2**30, 2147483647 and
    2147483629, 0 and 1) against every edge entry: shifting out 2**t and
    dividing by the odd part leaves carry 0 exactly when p divides, and
    then the quotient is ``//``; the multiple of p below the row always
    divides exactly."""
    rng = np.random.default_rng(n_limbs)
    rows = [r.tolist() for r in _adversarial_limbs(n_limbs, np.asarray(
        _EDGE_ENTRIES, dtype=np.int64), rng, n=16)]
    rows += [_limbs_of(2**30 * k, n_limbs) for k in (1, 3, 2_147_483_647)]
    top = 1 << (32 * n_limbs)
    exact = 0
    for p in _EDGE_ENTRIES:
        q, qinv, t = _hit_constants(p)
        assert q << t == p and q * qinv & _M32 == 1
        for row in rows:
            x = _x_of(row)
            for y in (x, x // p * p):
                n, tz = _row_counts(_limbs_of(y, n_limbs))
                quo, carry = _exact_div(_limbs_of(y >> t, n_limbs)[:n], q,
                                        qinv)
                divides = carry == 0 and t <= tz
                assert divides == (y % p == 0), (y, p)
                if divides:
                    assert _x_of(quo) == y // p < top
                    exact += 1
    assert exact > len(rows) * len(_EDGE_ENTRIES)


@pytest.mark.parametrize("seed", range(4))
def test_exact_division_model_on_random_draws(seed):
    """4,000 seeded draws per seed at 1 to 64 limbs: entries in [2, 2**31)
    (odd, even, powers of two), values random and their multiples of the
    entry; the exact division equals ``//`` on the multiples and keeps a
    carry on the others; a shift of the limbs equals ``>>``."""
    rng = np.random.default_rng(2000 + seed)
    for i in range(4000):
        n_limbs = int(rng.integers(1, 65))
        x = int.from_bytes(rng.bytes(4 * n_limbs), "little")
        p = int(rng.integers(2, 2**31))
        if i % 3 == 1:
            p &= ~0xFF
        elif i % 3 == 2:
            p = 1 << int(rng.integers(1, 31))
        p = max(p, 2)
        q, qinv, t = _hit_constants(p)
        for y in (x, x // p * p):
            quo, carry = _exact_div(_limbs_of(y >> t, n_limbs), q, qinv)
            if (y >> t) % q == 0:
                assert carry == 0 and _x_of(quo) == (y >> t) // q
            else:
                assert carry != 0
        T = int(rng.integers(0, 32 * n_limbs))
        assert _x_of(_shift_out(_limbs_of(x, n_limbs), n_limbs, T)) == x >> T


def test_exact_pipeline_model_equals_one_lane_after_another():
    """The pipeline's wavefront (lane h on limb s - h at step s) gives the
    same limbs and carries as dividing by each hit in turn, for 1 to 32
    hits over 1 to 40 limbs, exact and not."""
    rng = np.random.default_rng(11)
    primes = [int(x) for x in first_primes(400)[1:]]
    for _ in range(120):
        m = int(rng.integers(1, 33))
        n = int(rng.integers(1, 41))
        qs = [int(x) for x in rng.choice(primes, size=m)]
        x = int.from_bytes(rng.bytes(4 * n), "little")
        if rng.random() < 0.5:
            x = x // math.prod(qs) * math.prod(qs)
        lanes = [_hit_constants(q)[:2] for q in qs]
        data, carries = _limbs_of(x, n), []
        for q, qinv in lanes:
            data, c = _exact_div(data, q, qinv)
            carries.append(c)
        assert _pipeline(_limbs_of(x, n), n, lanes) == (data, carries)


def test_floor_pipeline_model_equals_floor_divisions():
    """The floor pipeline (lane h floor-divides by hit h, most significant
    limb first, by a reciprocal with one correction) gives c // p_0 //
    p_1 ... for 1 to 32 hits over 1 to 40 limbs, with hits at the edges
    (2, 4, 6, 2**30, the largest primes below 2**31, a hit twice) and rows
    of all-ones limbs."""
    rng = np.random.default_rng(12)
    for i in range(150):
        m = int(rng.integers(1, 33))
        n = int(rng.integers(1, 41))
        ps = [int(x) for x in rng.integers(2, 2**31, size=m)]
        ps[:3] = [_EDGE_ENTRIES[i % len(_EDGE_ENTRIES)], ps[-1], 2][:m]
        x = (int.from_bytes(rng.bytes(4 * n), "little") if i % 4
             else (1 << (32 * n)) - 1)
        want = x
        for p in ps:
            want //= p
        assert _x_of(_floor_pipeline(_limbs_of(x, n), n, ps)) == want


def _walk_inputs(n_limbs, n_rows, rng, duplicate=True):
    """Rows and a pool as ``chip_smoke.synthetic_limb_inputs`` makes them,
    fewer rows: 1016 distinct primes above 1000, 3, 5, the adversarial
    entries (2, 4, 6, 2**30, the largest primes below 2**31), pads, and
    (``duplicate``) the first entry twice; rows are products of up to 60
    distinct live entries, some times 9, random rows, 0, 1, 45 and edge
    rows."""
    bits = 32 * n_limbs
    primes = np.asarray([q for q in range(1001, 1 << 14, 2)
                         if all(q % d for d in range(3, int(q**0.5) + 1, 2))])
    pool = np.concatenate([rng.choice(primes, size=1016, replace=False),
                           [3, 5, *ADVERSARIAL_POOL, 0, 1, 0, 1, 0, 7]])
    if duplicate:
        pool[-1] = pool[0]
    pool = rng.permutation(pool).astype(np.int64)
    live = pool[pool > 1]
    vals = []
    for i in range(n_rows):
        if i % 5 == 4:
            vals.append(int.from_bytes(rng.bytes(4 * n_limbs), "little"))
            continue
        v = 1
        for q in rng.choice(live, size=int(rng.integers(1, 60)),
                            replace=False):
            if (v * int(q)).bit_length() < bits:
                v *= int(q)
        if i % 5 == 3 and (v * 9).bit_length() < bits:
            v *= 9
        vals.append(v)
    vals[:4] = [0, 1, 0, 45]
    edge = [_x_of(r) for r in
            _adversarial_limbs(n_limbs, pool, rng, n=12).tolist()]
    vals[6:6 + len(edge)] = edge
    return pack_limbs(vals[:n_rows], n_limbs), pool


@pytest.mark.parametrize("n_limbs", [2, 3, 8, 32])
def test_factorize_limbs_walk_model_matches_plain_version(n_limbs):
    """The limb factorization as the kernel computes it (Montgomery mask,
    hits per 1024-entry piece in batches of 32 in pool order, exact
    division where the batch divides the residual, floor division where
    it does not) equals the plain version on pools with a duplicate
    entry, 2 / 4 / 6 and rows times 9; those take floor batches, and a
    pool of distinct entries none."""
    rng = np.random.default_rng(40 + n_limbs)
    for duplicate in (True, False):
        limbs, pool = _walk_inputs(n_limbs, 48, rng, duplicate)
        if not duplicate:     # distinct primes only: the registry contract
            pool = np.where(np.isin(pool, [4, 6, 2**30]), 0, pool)
        mask, residual, tally = _factorize_limbs_model(limbs, pool)
        m_ref, r_ref = tref.factorize_limbs_ref(_t(limbs), _t(pool))
        np.testing.assert_array_equal(mask, m_ref.numpy())
        np.testing.assert_array_equal(residual, r_ref.numpy())
        assert tally["exact"] > 24 and tally["batches"] > 0
        assert (tally["floor"] > 0) == duplicate, tally


# --------------------------------------------------------------------------- #
# ops wrappers and the exact dispatchers vs repro.kernels.ops                  #
# --------------------------------------------------------------------------- #

def _wide_values(seed, n=40, bits=300):
    rng = np.random.default_rng(seed)
    primes = [int(p) for p in first_primes(200)[20:]] + [1_000_003, 999_983]
    vals = []
    for _ in range(n):
        v = 1
        for q in rng.choice(primes, size=int(rng.integers(1, 30)),
                            replace=False):
            if (v * int(q)).bit_length() < bits:
                v *= int(q)
        vals.append(v)
    return vals, primes


def test_ops_limb_wrappers_match_reference():
    vals, primes = _wide_values(0)
    qs = primes[::3] + [2, 3, 0]
    got = tops.divisibility_scan_limbs(vals, qs, device="cpu")
    want = jops.divisibility_scan_limbs(vals, qs)
    assert [list(x) for x in got] == [list(x) for x in want]
    limbs = pack_limbs(vals, 12)
    assert [list(x) for x in tops.divisibility_scan_limbs(
        limbs, qs, device="cpu")] == [list(x) for x in want]
    assert tops.factorize_batch_limbs(vals, primes[:90], device="cpu") == \
        jops.factorize_batch_limbs(vals, primes[:90])
    b = vals[5:] + vals[:5]
    assert tops.gcd_batch_limbs(vals, b, primes, device="cpu") == \
        jops.gcd_batch_limbs(vals, b, primes)
    assert tops.gcd_batch_limbs(vals, b, primes, device="cpu") == \
        [math.gcd(x, y) for x, y in zip(vals, b)]


@pytest.mark.parametrize("bits", [40, 63, 64, 200])
def test_exact_dispatchers_match_reference(bits):
    """Both branches: flat kernels while every value fits int64 (2**63 - 1
    included), limb kernels beyond."""
    vals, primes = _wide_values(bits, n=24, bits=bits)
    if bits == 63:
        vals[0] = 2**63 - 1
    b = vals[3:] + vals[:3]
    assert tops.factorize_batch_exact(vals, primes, device="cpu") == \
        jops.factorize_batch_exact(vals, primes)
    assert tops.gcd_batch_exact(vals, b, primes, device="cpu") == \
        jops.gcd_batch_exact(vals, b, primes)


def test_limb_wrappers_reject_bad_input_and_count_no_cpu_launch():
    before = launch_counts()
    with pytest.raises(ValueError, match="limb values"):
        tops.divisibility_scan_limbs(np.array([[1, 2**32]]), [3],
                                     device="cpu")
    with pytest.raises(ValueError, match="2\\*\\*31"):
        tops.factorize_batch_limbs([2**70], [2**31 + 11], device="cpu")
    with pytest.raises(ValueError, match="shape mismatch"):
        tops.gcd_batch_limbs(np.ones((2, 3), np.int64),
                             np.ones((2, 4), np.int64), [2], device="cpu")
    with pytest.raises(TypeError):
        tfac.divisibility_mask_limbs(torch.ones((2, 2), dtype=torch.int32),
                                     torch.ones(2, dtype=torch.int64))
    with pytest.raises(ValueError):
        tgcd.gcd_limbs(torch.ones((2, 2), dtype=torch.int64),
                       torch.ones((3, 2), dtype=torch.int64),
                       torch.ones(2, dtype=torch.int64))
    tops.gcd_batch_exact([2**70 * 3], [2**70 * 9], [3], device="cpu")
    assert launch_counts() == before
    assert tops.divisibility_scan_limbs([], [3], device="cpu")[0].size == 0
    assert tops.factorize_batch_limbs([], [3], device="cpu") == ([], [])
    assert tops.gcd_batch_limbs([], [], [3], device="cpu") == []


# --------------------------------------------------------------------------- #
# wide tables                                                                  #
# --------------------------------------------------------------------------- #

def _wide_registry(pkg):
    """The universe of the reference's wide table test: 40 MEM ids, one
    15-deep group relationship (wider than int64) and the chain edges."""
    if pkg == "ref":
        reg = RefRegistry(max_bits=640)
        assigner = RefAssigner(RefAllocator(), reg)
        mem = RefLevel.MEM
    else:
        reg = CompositeRegistry(max_bits=640)
        assigner = PrimeAssigner(HierarchicalPrimeAllocator(), reg)
        mem = CacheLevel.MEM
    ids = list(range(40))
    for d in ids:
        assigner.assign(d, mem)
    reg.register([assigner.prime_of(d) for d in ids[:15]], kind="group")
    for a, b in zip(ids, ids[1:]):
        reg.register({assigner.prime_of(a), assigner.prime_of(b)},
                     kind="chain")
    return reg, assigner, ids


def test_wide_successor_tables_match_reference():
    reg, assigner, ids = _wide_registry("port")
    rreg, rassigner, _ = _wide_registry("ref")
    assert reg.composites_list() == rreg.composites_list()
    np.testing.assert_array_equal(reg.limbs_array(), rreg.limbs_array())
    want = ref_successor_table(rreg, rassigner, ids, discover="host")
    assert want == ref_successor_table(rreg, rassigner, ids,
                                       discover="kernel")
    for discover in ("host", "kernel"):
        assert successor_table(reg, assigner, ids, discover=discover,
                               device="cpu") == want, discover


@pytest.mark.parametrize("n_shards", [2, 4])
def test_wide_sharded_successor_table_matches_reference(n_shards):
    reg, assigner, ids = _wide_registry("port")
    rreg, rassigner, _ = _wide_registry("ref")
    want = ref_sharded_successor_table(rreg, rassigner, ids,
                                       RefPartition(n_shards), mesh=None)
    got = sharded_successor_table(reg, assigner, ids,
                                  PrimeSpacePartition(n_shards),
                                  device="cpu")
    assert got == want == ref_successor_table(rreg, rassigner, ids,
                                              discover="host")


# --------------------------------------------------------------------------- #
# wide serving                                                                 #
# --------------------------------------------------------------------------- #

def _drive(make, kv, **kw):
    """The drive of the reference's wide serving parity test."""
    c = make(kv, hbm_pages=24, page_size=4, prefetch_budget=4, **kw)
    rng = np.random.default_rng(1)
    for r in range(8):
        toks = [int(t) for t in rng.integers(0, 40, size=rng.integers(8, 30))]
        if r % 2 == 0:
            toks[:8] = list(range(8))
        c.register_request(r, toks)
    items = []
    for _ in range(120):
        r = int(rng.integers(0, 8))
        n = len(c.chains.get(r, ()))
        if n:
            items.append((r, int(rng.integers(0, n))))
    tiers = c.touch_batch(items)
    return (c.stats.parity_tuple(), tiers, tuple(c.prefetch_log),
            c.shared_prefix(0, 2))


@pytest.mark.parametrize("max_bits", [128, 1024])
@pytest.mark.parametrize("kv", ["vec", "scalar", "sharded"])
def test_wide_serving_matches_reference(kv, max_bits):
    extra = {"mesh": None} if kv == "sharded" else {}
    want = _drive(ref_make_kv_backend, kv, max_bits=max_bits, **extra)
    assert want == _drive(ref_make_kv_backend, "scalar")   # width-free
    assert _drive(make_kv_backend, kv, max_bits=max_bits,
                  device="cpu") == want


@pytest.mark.parametrize("kv", ["vec", "sharded"])
def test_wide_shared_prefix_takes_the_limb_gcd(kv):
    """A 40-page shared run: the chain chunks exceed int64, so the shared
    prefix goes through the limb gcd; the pages equal the reference's."""
    def drive(make, **kw):
        c = make(kv, hbm_pages=64, page_size=1, prefetch_budget=0,
                 max_bits=1024, **kw)
        shared = list(range(40))
        c.register_request(0, shared + [100, 101])
        c.register_request(1, shared + [200])
        c.register_request(2, [300, 301, 302])
        return c

    ref = drive(ref_make_kv_backend,
                **({"mesh": None} if kv == "sharded" else {}))
    port = drive(make_kv_backend, device="cpu")
    assert port._chunks_of(0).dtype == object
    assert max(int(x) for x in port._chunks_of(0)).bit_length() > 63
    want = ref.shared_prefix(0, 1)
    assert len(want) == 40
    assert port.shared_prefix(0, 1) == want
    assert port.shared_prefix_bulk([(0, 1), (0, 2), (1, 0)]) == \
        ref.shared_prefix_bulk([(0, 1), (0, 2), (1, 0)])


# --------------------------------------------------------------------------- #
# case_scale at a reduced size vs the reference's primitives                   #
# --------------------------------------------------------------------------- #

def _ref_case_scale(n_chains, depth, n_verify_chains=24, max_bits=1024,
                    group_stride=16):
    """``benchmarks/cases.py::case_scale``'s recipe at any size, written
    out on the reference's primitives (its Pallas kernels in interpret
    mode)."""
    registry = RefRegistry(max_bits=max_bits)
    assigner = RefAssigner(RefAllocator(), registry)
    prime_of = assigner.assign_many(range(n_chains * depth), RefLevel.MEM)
    for c in range(n_chains):
        row = prime_of[c * depth:(c + 1) * depth]
        registry.register_many(zip(row, row[1:]), kind="chain")
        if c % group_stride == 0:
            registry.register(row, kind="group")
    comps = registry.composites_list()
    wide = [c for c in comps if c.bit_length() > 63]
    sample_chains = ([c for c in range(0, n_chains, group_stride)
                      [:n_verify_chains // 2]]
                     + [c for c in range(1, n_chains, group_stride)
                        [:n_verify_chains // 2]])
    pool = sorted({p for c in sample_chains
                   for p in prime_of[c * depth:(c + 1) * depth]})
    negatives = [2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37, 41, 43, 47, 53]
    sample = []
    for c in sample_chains:
        row = prime_of[c * depth:(c + 1) * depth]
        sample.extend(a * b for a, b in zip(row, row[1:]))
        if c % group_stride == 0:
            sample.extend(ref_encode(row, max_bits))
    L = -(-max_bits // 32)
    queries = pool[::7] + negatives
    idx = jops.divisibility_scan_limbs(ref_pack_limbs(sample, L), queries)
    scan_hits = sum(len(ix) for ix in idx)
    factors, residual = jops.factorize_batch_exact(sample, pool)
    false_pos = sum(c % p != 0 for c, fs in zip(sample, factors) for p in fs)
    ga = [c for c in sample if c.bit_length() > 63]
    gb = [prime_of[c * depth] * prime_of[c * depth + 1]
          for c in sample_chains if c % group_stride == 0
          for _ in range(len(ref_encode(prime_of[c * depth:(c + 1) * depth],
                                        max_bits)))][:len(ga)]
    gs = jops.gcd_batch_exact(ga, gb, pool)
    out = dict(
        n_elements=len(prime_of), n_chains=n_chains, chain_depth=depth,
        registry_max_bits=max_bits, n_limbs=L,
        n_relationships=len(registry), n_composites=len(comps),
        n_wide_composites=len(wide),
        max_composite_bits=max(c.bit_length() for c in comps),
        max_prime=max(prime_of),
        verify=dict(
            n_verified=len(sample), n_query_primes=len(queries),
            scan_hits=scan_hits, factor_false_positives=false_pos,
            residual_all_one=all(int(r) == 1 for r in residual),
            gcd_pairs=len(gs), gcd_nontrivial=sum(1 for g in gs if g > 1)))
    return out, registry, idx, factors, gs


def _registry_state(reg):
    return (list(reg._by_composite.items()),
            [(r.rel_id, tuple(r.primes), r.kind, r.weight, r.composites)
             for r in reg._by_id.values()],
            reg.version, reg.limbs_array())


def test_case_scale_reduced_matches_reference_recipe():
    n_chains, depth = 160, 20
    want, rreg, _, _, _ = _ref_case_scale(n_chains, depth)
    got = case_scale(n_chains, depth, device="cpu")
    assert {k: v for k, v in got.items() if not k.endswith("_wall_s")} == \
        want
    assert got["n_wide_composites"] > 0
    assert got["verify"]["scan_hits"] > 0
    assert got["verify"]["gcd_nontrivial"] > 0
    universe = build_scale_universe(n_chains, depth)
    a, b = _registry_state(universe.registry), _registry_state(rreg)
    assert a[:3] == b[:3]
    np.testing.assert_array_equal(a[3], b[3])


def test_case_scale_defaults_are_the_published_size():
    import inspect

    sig = inspect.signature(case_scale).parameters
    assert (sig["n_chains"].default, sig["depth"].default,
            sig["n_verify_chains"].default) == (10_000, 100, 24)
    u = build_scale_universe(n_chains=32, depth=6, n_verify_chains=4)
    assert len(u.prime_of) == 192 and u.queries[-16:] == [
        2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37, 41, 43, 47, 53]
