"""The port's wide (multi-limb) path against the reference: the plain
PyTorch limb versions vs the Pallas limb kernels in interpret mode, the
``ops`` limb wrappers and the ``*_exact`` dispatchers vs
``repro.kernels.ops``, wide successor tables (host, kernel, sharded),
wide serving caches, and ``case_scale`` at a reduced size vs the same
recipe on the reference's primitives.  The port runs with
``device="cpu"``.  Integer arithmetic: every comparison is exact."""

from torch_parity import first_primes

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
