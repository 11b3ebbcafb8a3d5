"""The port on the card: each CUDA kernel (flat and multi-limb) against
its plain PyTorch version on the same card inputs, the ``ops`` wrappers
and the sharded serving path, narrow and wide, on ``"cuda"`` against
``"cpu"``.  Every test is marked
``gpu`` and skips when CUDA is absent; on a card run them with
``PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py``
(this file imports no JAX, so it runs where only the port is
installed)."""

from torch_parity import chip_smoke, kernel_inputs, registry_arrays

import numpy as np
import pytest
import torch

from repro_torch import cases
from repro_torch.core.composite import pack_limbs
from repro_torch.kernels import factorize, gcd, launch_counts, ops, ref
from repro_torch.serving.engine import ServingEngine


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "False)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [np.int32, np.int64])
@pytest.mark.parametrize("n,p", [(1, 1), (37, 300), (1000, 517),
                                 (4099, 1030)])
def test_cuda_kernels_match_plain(cuda_device, dtype, n, p):
    comps, primes = kernel_inputs(n, p, dtype, seed=n + p)
    c = torch.from_numpy(comps).to(cuda_device)
    q = torch.from_numpy(primes).to(cuda_device)
    assert torch.equal(factorize.divisibility_mask(c, q),
                       ref.divisibility_mask_ref(c, q))
    for x, y in zip(factorize.factorize_squarefree(c, q),
                    ref.factorize_squarefree_ref(c, q)):
        assert torch.equal(x, y)
    b = torch.roll(c, 1)
    assert torch.equal(gcd.gcd(c, b), ref.gcd_ref(c, b))
    assert torch.equal(gcd.gcd(c, b), torch.gcd(c, b))
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_cuda_wrappers_count_launches_and_check_inputs(cuda_device):
    before = launch_counts()
    ops.gcd_batch([12, 18], [8, 27], device="cuda")
    ops.divisibility_scan([6, 10], [2, 5], device="cuda")
    ops.factorize_batch([6, 10], [2, 5], device="cuda")
    after = launch_counts()
    flat = ("divisibility_mask", "factorize_squarefree", "gcd")
    assert {k: after[k] - before[k] for k in before} == {
        k: int(k in flat) for k in before}
    empty = torch.empty(0, dtype=torch.int64, device=cuda_device)
    assert gcd.gcd(empty, empty).numel() == 0
    assert launch_counts() == after
    with pytest.raises(TypeError):
        gcd.gcd(torch.ones(4, device=cuda_device),
                torch.ones(4, device=cuda_device))
    with pytest.raises(ValueError):
        gcd.gcd(torch.arange(4, device=cuda_device),
                torch.arange(4))


@pytest.mark.gpu
@pytest.mark.parametrize("n,q", [(5, 3), (300, 40), (2000, 700)])
def test_cuda_ops_match_cpu(cuda_device, n, q):
    comps, primes = kernel_inputs(n, q, np.int64, seed=n)
    b = np.resize(primes * 3, n)
    for fn, args in ((ops.divisibility_scan, (comps, primes)),
                     (ops.factorize_batch, (comps, primes)),
                     (ops.gcd_batch, (comps, b))):
        got, want = fn(*args, device="cuda"), fn(*args, device="cpu")
        assert repr(got) == repr(want), fn.__name__


#: the shapes the sharded refresh of ``case_batching``'s full trace gives
#: the flat factorization (rows, pool entries) and the gcd (pairs)
BATCHING_FULL_FACTORIZE = [
    (256, 512), (256, 1024), (512, 1024), (512, 1536), (768, 1536),
    (512, 2048), (768, 2048), (512, 2560), (768, 2560), (1024, 2560),
    (768, 3072), (1024, 3072), (1280, 3072), (1024, 3584), (1280, 3584)]
BATCHING_FULL_GCD = [1 << k for k in range(12, 22)]


def _registry_like(n, p, dtype, seed):
    """``n`` composites (products of one to three distinct pool primes
    that fit ``dtype``, a fifth random values, and 0 and 1) and a pool of
    ``p - 3`` distinct primes below 50,000 padded with 0, 1 and 0."""
    rng = np.random.default_rng(seed)
    sieve = np.ones(50_000, dtype=bool)
    sieve[:2] = False
    for i in range(2, 224):
        sieve[i * i::i] = False
    primes = rng.choice(np.nonzero(sieve)[0], size=p - 3, replace=False)
    top = 2**31 - 1 if dtype == np.int32 else 2**62
    comps = []
    for _ in range(n):
        v = 1
        for q in rng.choice(primes, size=int(rng.integers(1, 4)),
                            replace=False):
            if v * int(q) <= top:
                v *= int(q)
        comps.append(v)
    comps = np.where(rng.random(n) < 0.2, rng.integers(0, top, size=n),
                     comps)
    comps[:2] = [0, 1]
    pool = np.concatenate([primes, [0, 1, 0]])
    return comps.astype(dtype), pool.astype(dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [np.int32, np.int64])
@pytest.mark.parametrize("n,p", BATCHING_FULL_FACTORIZE)
def test_cuda_factorize_at_batching_full_shapes(cuda_device, dtype, n, p):
    comps, primes = _registry_like(n, p, dtype, seed=n * p)
    c = torch.from_numpy(comps).to(cuda_device)
    q = torch.from_numpy(primes).to(cuda_device)
    for x, y in zip(factorize.factorize_squarefree(c, q),
                    ref.factorize_squarefree_ref(c, q)):
        assert torch.equal(x, y)
    # a row span that is not aligned to the kernel's vector stores
    for x, y in zip(factorize.factorize_squarefree(c, q[:p - 5]),
                    ref.factorize_squarefree_ref(c, q[:p - 5])):
        assert torch.equal(x, y)
    torch.cuda.synchronize()


#: the shapes the same refresh gives the flat mask (rows, pool entries)
BATCHING_FULL_MASK = [(256, 512), (512, 512), (512, 1024), (1024, 1024),
                      (1024, 2048), (2048, 2048), (2048, 4096), (4096, 4096)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [np.int32, np.int64])
@pytest.mark.parametrize("n,p", BATCHING_FULL_MASK)
def test_cuda_mask_at_batching_full_shapes(cuda_device, dtype, n, p):
    """Registry-like rows (products of pool primes, a fifth random, so
    wide at int64, and 0 and 1), also with every third row a pad of 1 as
    the serving path pads; and the same pool five entries short, so that
    the row spans are off the vector stores' alignment."""
    comps, primes = _registry_like(n, p, dtype, seed=n * p + 1)
    c = torch.from_numpy(comps).to(cuda_device)
    q = torch.from_numpy(primes).to(cuda_device)
    padded = c.clone()
    padded[::3] = 1
    for rows in (c, padded):
        for pool in (q, q[:p - 5]):
            assert torch.equal(factorize.divisibility_mask(rows, pool),
                               ref.divisibility_mask_ref(rows, pool))
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [np.int32, np.int64])
@pytest.mark.parametrize("n", BATCHING_FULL_GCD)
def test_cuda_gcd_at_batching_full_shapes(cuda_device, dtype, n):
    """Pairs as the sharded exchange makes them (each query chunk against
    every cross composite, pads of 1), and the same arrays one element
    off their 16-byte alignment."""
    comps, _ = _registry_like(max(n // 64, 8), 67, dtype, seed=n)
    cross = torch.from_numpy(comps).to(cuda_device)
    chunks = cross[:max(n // cross.numel(), 1)]
    a = chunks.repeat_interleave(cross.numel())[:n].contiguous()
    b = cross.repeat(chunks.numel())[:n].contiguous()
    b[::7] = 1
    want = ref.gcd_ref(a, b)
    assert torch.equal(gcd.gcd(a, b), want)
    assert torch.equal(gcd.gcd(a[1:], b[1:]), want[1:])
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
def test_cuda_flat_kernels_on_adversarial_inputs(cuda_device, dtype):
    """The edges of the flat kernels' arithmetic that ``chip_smoke.py``
    checks (largest values, powers of two, the largest primes below
    2**31, large int64 primes), an out-of-contract pool (a duplicate
    entry, 2 and 4, 3 and 9) and gcd chains (consecutive Fibonacci pairs,
    zeros, equal sides, a side of 1, off 16-byte alignment): every kernel
    equals its plain version."""
    inputs = chip_smoke().adversarial_flat_inputs(dtype, device=cuda_device)
    for c, q in inputs["factorize"]:
        assert torch.equal(factorize.divisibility_mask(c, q),
                           ref.divisibility_mask_ref(c, q))
        for x, y in zip(factorize.factorize_squarefree(c, q),
                        ref.factorize_squarefree_ref(c, q)):
            assert torch.equal(x, y)
    for x, y in inputs["gcd"]:
        assert torch.equal(gcd.gcd(x, y), ref.gcd_ref(x, y))
    torch.cuda.synchronize()


#: entries at the edges of the limb kernels' arithmetic: powers of two,
#: an even composite, the largest primes below 2**31
ADVERSARIAL_POOL = [2, 4, 6, 2**30, 2_147_483_647, 2_147_483_629]


def _adversarial_rows(n_limbs, rng):
    """All limbs 0xFFFFFFFF, a top nonzero limb at limb 0, a middle limb
    and limb L - 1, and multiples of the even and largest entries."""
    top = 1 << (32 * n_limbs)
    out = [top - 1]
    for k in sorted({0, n_limbs // 2, n_limbs - 1}):
        out.append(int(rng.integers(1, 2**32)) << (32 * k)
                   | int.from_bytes(rng.bytes(4 * k), "little"))
    out += [2**30 * 2_147_483_647 * 3, 6 * 2_147_483_629 * 5,
            4 * 2_147_483_647, 2**30]
    return [v % top for v in out]


def _limb_inputs(n, p, n_limbs, seed):
    """Limb rows (products of pool primes, a squared factor, random rows,
    0 and 1) and a pool of distinct primes with one repeat and the pads
    0 and 1; from 16 rows and entries on, also the adversarial entries
    and rows."""
    rng = np.random.default_rng(seed)
    _, primes = kernel_inputs(1, max(p, 8), np.int64, seed)
    live = [int(q) for q in primes if q > 1]
    edge = ADVERSARIAL_POOL if p >= 16 else []
    pool = np.asarray(live[:max(p - 3 - len(edge), 1)] + edge
                      + [live[0], 0, 1], np.int64)[:p]
    vals = []
    for i in range(n):
        if i % 4 == 3:
            vals.append(int.from_bytes(rng.bytes(4 * n_limbs), "little"))
            continue
        v = 1
        for q in rng.permutation(live)[:int(rng.integers(1, 40))]:
            if (v * int(q)).bit_length() < 32 * n_limbs:
                v *= int(q)
        vals.append(v * 4 if (v * 4).bit_length() < 32 * n_limbs else v)
    vals[:2] = [0, 1][:n]
    if n >= 16:
        rows = _adversarial_rows(n_limbs, rng)
        vals[2:2 + len(rows)] = rows
    return pack_limbs(vals, n_limbs), pool


@pytest.mark.gpu
@pytest.mark.parametrize("n_limbs", [2, 3, 8, 32])
@pytest.mark.parametrize("n,p", [(1, 1), (37, 300), (1000, 517)])
def test_cuda_limb_kernels_match_plain(cuda_device, n_limbs, n, p):
    limbs, pool = _limb_inputs(n, p, n_limbs, seed=n + p + n_limbs)
    c = torch.from_numpy(limbs).to(cuda_device)
    q = torch.from_numpy(pool).to(cuda_device)
    assert torch.equal(factorize.divisibility_mask_limbs(c, q),
                       ref.divisibility_mask_limbs_ref(c, q))
    for x, y in zip(factorize.factorize_limbs(c, q),
                    ref.factorize_limbs_ref(c, q)):
        assert torch.equal(x, y)
    b = torch.roll(c, 1, dims=0)
    assert torch.equal(gcd.gcd_limbs(c, b, q), ref.gcd_limbs_ref(c, b, q))
    # every row against every one of the first eight, in the order the
    # sharded exchange pairs them (runs of pairs sharing their a row)
    pairs = torch.arange(8 * n, device=cuda_device)
    ra, rb = c[pairs // 8].contiguous(), c[pairs % min(n, 8)].contiguous()
    assert torch.equal(gcd.gcd_limbs(ra, rb, q), ref.gcd_limbs_ref(ra, rb, q))
    assert torch.equal(gcd.gcd_limbs(rb, ra, q), ref.gcd_limbs_ref(rb, ra, q))
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("n_limbs", [3, 32])
def test_cuda_limb_kernels_on_large_pools(cuda_device, n_limbs):
    """Pools wider than the kernels hold at once: the mask takes 9000
    entries in column pieces of 4096 (one row per tile) and the gcd in
    chunks reloaded per pair; both equal their plain versions, runs of
    pairs sharing a row included."""
    rng = np.random.default_rng(n_limbs)
    sieve = np.ones(1 << 17, dtype=bool)
    sieve[:2] = False
    for i in range(2, 363):
        sieve[i * i::i] = False
    primes = np.nonzero(sieve)[0]
    pool = np.concatenate([rng.choice(primes, size=8988, replace=False),
                           ADVERSARIAL_POOL, [0, 1, 0, 1, 0, 1]])
    pool = rng.permutation(pool).astype(np.int64)
    live = [int(x) for x in pool if x > 1]
    vals = []
    for _ in range(300):
        v = 1
        for q in rng.choice(live, size=int(rng.integers(1, 12))):
            if (v * int(q)).bit_length() < 32 * n_limbs:
                v *= int(q)
        vals.append(v)
    vals[:2] = [0, 1]
    vals[2:2 + 8] = _adversarial_rows(n_limbs, rng)
    c = torch.from_numpy(pack_limbs(vals, n_limbs)).to(cuda_device)
    q = torch.from_numpy(pool).to(cuda_device)
    assert torch.equal(factorize.divisibility_mask_limbs(c, q),
                       ref.divisibility_mask_limbs_ref(c, q))
    pairs = torch.arange(4 * 300, device=cuda_device)
    ra, rb = c[pairs // 4].contiguous(), c[pairs % 300].contiguous()
    assert torch.equal(gcd.gcd_limbs(ra, rb, q), ref.gcd_limbs_ref(ra, rb, q))
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("n_limbs", [2, 3, 8, 32])
def test_cuda_factorize_limbs_on_adversarial_rows(cuda_device, n_limbs):
    """``chip_smoke.py``'s limb inputs: rows that are products of up to 60
    pool entries (some times 9), random rows, 0, 1, 45 and the edge rows;
    a pool with a duplicate entry, 2, 4 and 6, 2**30 and the largest
    primes below 2**31 (the floor branch), the same pool without the
    duplicate and the even entries but 2 (exact divisions only), and
    ragged row and pool counts (one entry into the second piece of
    1024)."""
    inputs = chip_smoke().synthetic_limb_inputs(
        n_limbs, np.random.default_rng(n_limbs))
    c, pool = inputs["factorize_limbs"]
    distinct = torch.where(torch.isin(pool, torch.tensor(
        [4, 6, 2**30, int(pool[0])], device=cuda_device)), 0, pool)
    for rows in (c, c[:37], c[:1]):
        for q in (pool, distinct, pool[:1025], pool[:5]):
            for x, y in zip(factorize.factorize_limbs(rows, q),
                            ref.factorize_limbs_ref(rows, q)):
                assert torch.equal(x, y)
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_cuda_factorize_limbs_at_scale_shape(cuda_device):
    """``case_scale``'s decode shape: 2560 rows of 32 limbs against 2560
    entries, rows products of distinct pool primes from one limb up to
    1023 bits (a chain's chunks), zero and value-1 rows."""
    rng = np.random.default_rng(2560)
    sieve = np.ones(1 << 22, dtype=bool)
    sieve[:2] = False
    for i in range(2, 2049):
        sieve[i * i::i] = False
    pool = np.concatenate([rng.choice(np.nonzero(sieve)[0], size=2557,
                                      replace=False), [0, 1, 0]])
    pool = rng.permutation(pool).astype(np.int64)
    live = [int(x) for x in pool if x > 1]
    vals = []
    for i in range(2560):
        top, v = int(rng.integers(32, 1024)), 1
        for q in rng.choice(live, size=60, replace=False):
            if (v * int(q)).bit_length() < top:
                v *= int(q)
        vals.append(v)
    vals[:2] = [0, 1]
    c = torch.from_numpy(pack_limbs(vals, 32)).to(cuda_device)
    q = torch.from_numpy(pool).to(cuda_device)
    for x, y in zip(factorize.factorize_limbs(c, q),
                    ref.factorize_limbs_ref(c, q)):
        assert torch.equal(x, y)
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_cuda_limb_ops_match_cpu(cuda_device):
    before = launch_counts()
    limbs, pool = _limb_inputs(300, 200, 8, seed=3)
    vals = [int.from_bytes(r.astype("<u4").tobytes(), "little")
            for r in limbs]
    b = vals[7:] + vals[:7]
    for fn, args in ((ops.divisibility_scan_limbs, (limbs, pool)),
                     (ops.factorize_batch_limbs, (vals, pool)),
                     (ops.gcd_batch_limbs, (vals, b, pool))):
        got, want = fn(*args, device="cuda"), fn(*args, device="cpu")
        assert repr(got) == repr(want), fn.__name__
    after = launch_counts()
    assert all(after[k] == before[k] + 1 for k in
               ("divisibility_mask_limbs", "factorize_limbs", "gcd_limbs"))


@pytest.mark.gpu
@pytest.mark.parametrize("max_bits", [62, 1024])
def test_cuda_sharded_serving_matches_cpu(cuda_device, max_bits):
    def run(device):
        rng = np.random.default_rng(0)
        eng = ServingEngine(None, None, max_batch=16, page_size=16,
                            hbm_pages=24, kv="sharded", prefetch_budget=4,
                            reread_window=2, shards=2, max_bits=max_bits,
                            device=device)
        groups = [list(rng.integers(0, 30_000, size=64)) for _ in range(6)]
        for r in range(48):
            tail = list(rng.integers(0, 30_000,
                                     size=int(rng.integers(48, 129))))
            eng.submit(groups[r % len(groups)] + tail, max_new_tokens=8)
        eng.run_until_idle()
        return eng

    before = launch_counts()
    card = run("cuda")
    launched = {k: v - before[k] for k, v in launch_counts().items()}
    host = run("cpu")
    path = (["divisibility_mask", "factorize_squarefree", "gcd"]
            if max_bits == 62 else
            ["divisibility_mask_limbs", "factorize_squarefree", "gcd_limbs"])
    assert min(launched[k] for k in path) > 0, launched
    assert card.pages.stats.parity_tuple() == host.pages.stats.parity_tuple()
    assert card.pages.prefetch_log == host.pages.prefetch_log
    assert card.pages.successor_rows() == host.pages.successor_rows()
    assert card.pages.last_scan == host.pages.last_scan
    assert card.pages.last_scan.cross_composites > 0
    if max_bits == 62:
        ra, rb = registry_arrays(card.pages), registry_arrays(host.pages)
        assert ra["members"] == rb["members"]
        np.testing.assert_array_equal(ra["composites"], rb["composites"])
    else:
        assert card.pages.registry.composites_list() == \
            host.pages.registry.composites_list()


# --------------------------------------------------------------------------- #
# the Table-1 engine's kernels                                               #
# --------------------------------------------------------------------------- #

TABLE1_CAPS = (("L1", 64), ("L2", 256), ("L3", 2048))
ENGINE_SYSTEMS = ["lru", "fifo", "2q", "arc", "lirs", "pfcs"]
ENGINE_FIELDS = ("hits_per_level", "misses", "demand_accesses",
                 "prefetches_issued", "prefetches_used", "prefetches_true")


def _engine_fields(st):
    return tuple(getattr(st, f) for f in ENGINE_FIELDS)


def _shortened_table1(length):
    """The Table-1 workloads at ``benchmarks/table1.py``'s configuration,
    each trace cut to its first ``length`` accesses (key space and
    relationships unchanged)."""
    from repro_torch.core import Trace

    cs = chip_smoke()
    out = []
    for gen, kw in cases.table1_workloads().values():
        tr = cs._make_trace(gen, seed=0, **kw)
        out.append(Trace(name=tr.name, accesses=tr.accesses[:length],
                         relationships=tr.relationships, n_keys=tr.n_keys,
                         meta=tr.meta))
    return out


def _oracle(system, tr, caps, **kw):
    from repro_torch.core import simulate_baseline, simulate_pfcs

    if system == "pfcs":
        return simulate_pfcs(tr, caps, **kw)
    return simulate_baseline(system, tr, caps)


@pytest.mark.gpu
@pytest.mark.parametrize("system", ENGINE_SYSTEMS)
def test_cuda_engine_at_table1_caps(cuda_device, system):
    """Shortened Table-1 traces (one batch, ragged: 1500, 1200, 900
    accesses) at Table-1 capacities: the kernel equals the scalar oracle
    on every trace, and the plain loop on the CPU counter for counter,
    final state included (PFCS with kernel-built tables)."""
    from repro_torch.core.engine import simulate_batch
    from repro_torch.kernels import engine

    trs = _shortened_table1(1500)
    for tr, n in zip(trs, (1500, 1200, 900)):
        tr.accesses = tr.accesses[:n]
    got = simulate_batch(trs, system, TABLE1_CAPS, device="cuda",
                         discover="kernel")
    for tr, st in zip(trs, got):
        assert _engine_fields(st) == _engine_fields(
            _oracle(system, tr, TABLE1_CAPS))
    if system == "pfcs":
        return
    cs = chip_smoke()
    acc, n_keys = cs.batch_inputs(trs)
    caps = [c for _, c in TABLE1_CAPS]
    kern = engine.baseline_scan(acc.to(cuda_device), system, caps, n_keys)
    plain = engine.baseline_scan(acc.cpu(), system, caps, n_keys)
    torch.cuda.synchronize()
    assert cs.tree_diff(plain, kern) == []


@pytest.mark.gpu
def test_cuda_engine_edge_cases(cuda_device, monkeypatch):
    """``chip_smoke.py``'s ``engine_check`` on the card (ragged check
    batch, PFCS's variants, capacity 1, ARC's p swing), then the same
    cases against the scalar oracles."""
    cs = chip_smoke()
    monkeypatch.setattr(cs, "DEVICE", "cuda")
    ctx = cs.Context()
    out = cs.phase_engine_check(ctx)
    assert out["held_at_capacity_1"]["2q"] == 2
    assert out["arc_p_range"] == [0.0, 16.0]

    from repro_torch.core import Trace
    from repro_torch.core.engine import simulate_batch

    trs = cs.check_traces()
    for system in ENGINE_SYSTEMS:
        for st, tr in zip(simulate_batch(trs, system, cs.CHECK_CAPS,
                                         device="cuda"), trs):
            assert _engine_fields(st) == _engine_fields(
                _oracle(system, tr, cs.CHECK_CAPS))
    for kw in (dict(victim_window=100), dict(enable_prefetch=False),
               dict(prefetch_trigger="always")):
        for st, tr in zip(simulate_batch(trs, "pfcs", cs.CHECK_CAPS,
                                         device="cuda", **kw), trs):
            assert _engine_fields(st) == _engine_fields(
                _oracle("pfcs", tr, cs.CHECK_CAPS, **kw))
    swing = cs.arc_swing_accesses(16)
    tr = Trace(name="swing", accesses=swing, relationships=[],
               n_keys=int(swing.max()) + 1)
    for caps in ((("L1", 4), ("L2", 12)), (("ONE", 1),)):
        for system in ENGINE_SYSTEMS:
            st = simulate_batch([tr], system, caps, device="cuda")[0]
            assert _engine_fields(st) == _engine_fields(
                _oracle(system, tr, caps))


@pytest.mark.gpu
def test_cuda_engine_launches_once_per_batch(cuda_device):
    from repro_torch.core.engine import simulate_batch

    trs = chip_smoke().check_traces(200)
    before = launch_counts()
    simulate_batch(trs, "lirs", TABLE1_CAPS, device="cuda")
    simulate_batch(trs, "pfcs", TABLE1_CAPS, device="cuda")
    after = launch_counts()
    assert after["engine_baseline"] - before["engine_baseline"] == 1
    assert after["engine_pfcs"] - before["engine_pfcs"] == 1


@pytest.mark.gpu
def test_cuda_engine_refuses_a_layout_it_does_not_know(cuda_device):
    """The engine kernels take each state array's offset from the
    wrapper's layout and refuse, before any launch, a table whose length
    is not their policy's (baseline: its outputs and its own arrays) or 4
    per level and 10 (PFCS): here the outputs alone."""
    import ctypes

    from repro_torch.kernels import engine

    arc = engine._offsets(engine.baseline_layout("arc", 8, 4))
    two = engine._offsets(engine.pfcs_layout([4, 8], 4))
    placed = (ctypes.c_int * 2)(0, -1)
    before = launch_counts()
    with pytest.raises(RuntimeError, match="engine_baseline"):
        engine.ENGINE_BASELINE.launch(
            cuda_device, 0, 1, 1, engine.POLICY_IDS["lru"], 0, 1, 8, 0, 0,
            0, 4, 0, 32, engine.baseline_kinds("arc")[:len(arc)].encode(),
            ctypes.addressof(arc), len(arc), placed, 0, 0, 0)
    with pytest.raises(RuntimeError, match="engine_pfcs"):
        engine.ENGINE_PFCS.launch(
            cuda_device, 0, 1, 1, 0, 1, 4, 4, 4, 8, 0, 0, 0, 0, 0, 32,
            engine.pfcs_kinds(2)[:len(two)].encode(), ctypes.addressof(two),
            len(two), placed, 0, 0)
    assert launch_counts() == before
    assert list(placed) == [0, -1]


@pytest.mark.gpu
@pytest.mark.parametrize("system", ENGINE_SYSTEMS)
def test_cuda_engine_state_placements(cuda_device, system):
    """Each engine kernel equals its plain loop with its state in shared
    memory (the check batch), with the per-key arrays in global memory (a
    key space past shared memory) and with every array in global memory
    (levels past shared memory), and says where it kept it; on the check
    batch at its full length (every policy evicting at capacity 96) each
    placement asked for equals the same plain loop."""
    from repro_torch.kernels import engine

    cs = chip_smoke()
    for traces, levels, mode in (
            (cs.check_traces(200), cs.CHECK_CAPS, "shared"),
            (cs.spread_traces(cs.check_traces(120)), cs.CHECK_CAPS,
             "keys global"),
            (cs.check_traces(120), cs.GLOBAL_CAPS, "global")):
        caps = [c for _, c in levels]
        acc, n_keys = cs.batch_inputs(traces)
        if system == "pfcs":
            args = (acc, caps, n_keys, 4, 8, True, False,
                    *cs.pfcs_table_inputs(traces, levels, n_keys))
            kern, plain = engine.pfcs_scan(*args), engine.pfcs_scan_ref(*args)
        else:
            args = (acc, system, caps, n_keys)
            kern = engine.baseline_scan(*args)
            plain = engine.baseline_scan_ref(*args)
        torch.cuda.synchronize()
        assert cs.tree_diff(plain, kern) == []
        assert kern["placement"]["mode"] == mode
    traces = cs.check_traces()
    caps = [c for _, c in cs.CHECK_CAPS]
    acc, n_keys = cs.batch_inputs(traces)
    if system == "pfcs":
        args = (acc, caps, n_keys, 4, 8, True, False,
                *cs.pfcs_table_inputs(traces, cs.CHECK_CAPS, n_keys))
        scan, plain = engine.pfcs_scan, engine.pfcs_scan_ref(*args)
    else:
        args = (acc, system, caps, n_keys)
        scan, plain = engine.baseline_scan, engine.baseline_scan_ref(*args)
    for mode in ("shared", "keys global", "global"):
        kern = scan(*args, placement=mode)
        torch.cuda.synchronize()
        assert cs.tree_diff(plain, kern) == [], mode
        assert kern["placement"]["mode"] == mode


# --------------------------------------------------------------------------- #
# the model zoo: the card against the host's CPU on the same parameters       #
# --------------------------------------------------------------------------- #

MODEL_ARCHS = ["qwen2.5-3b", "gemma-2b", "qwen3-32b", "phi3-medium-14b",
               "phi-3-vision-4.2b", "kimi-k2-1t-a32b", "deepseek-v2-236b"]


def _model_pair(arch, cuda_device, **replace):
    from repro_torch.configs import get_smoke
    from repro_torch.models import build_model

    cfg = get_smoke(arch).replace(**replace)
    card, host = build_model(cfg, device="cuda"), build_model(cfg,
                                                              device="cpu")
    params = card.init_params(0)
    return card, params, host, chip_smoke().params_copy(params, "cpu")


def _model_batch(cfg, seed=0, b=2, s=64):
    rng = np.random.default_rng(seed)
    if cfg.family == "vlm":
        n = cfg.frontend.n_positions
        return {"tokens": torch.from_numpy(rng.integers(
                    0, cfg.vocab_size, (b, s - n))),
                "patches": torch.from_numpy(rng.normal(size=(
                    b, n, cfg.frontend.feature_dim)).astype(np.float32))}
    return {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                                    (b, s)))}


def _on(batch, device):
    return {k: v.to(device) for k, v in batch.items()}


@pytest.mark.gpu
@pytest.mark.parametrize("arch", MODEL_ARCHS)
def test_cuda_models_match_cpu(cuda_device, arch):
    """Each ported arch's float32 smoke model on the card: train logits,
    prefill logits and cache, and eight teacher-forced decode steps
    within 1e-4 of the host's CPU on the same parameters, the argmax
    tokens and the router indices equal."""
    card, params, host, h_params = _model_pair(arch, cuda_device)
    batch = _model_batch(card.cfg)
    for fn in ("train_logits", "prefill"):
        got = getattr(card, fn)(params, _on(batch, "cuda"))
        want = getattr(host, fn)(h_params, batch)
        torch.testing.assert_close(got[0].cpu(), want[0], rtol=1e-4,
                                   atol=1e-4)
    router = card.cfg.moe is not None
    dec = "decode_step_router" if router else "decode_step"
    cc, hc = card.init_cache(2, 16), host.init_cache(2, 16)
    toks = batch["tokens"]
    for t in range(8):
        got = getattr(card, dec)(params, {"tokens": toks[:, t:t + 1].cuda()},
                                 cc)
        want = getattr(host, dec)(h_params, {"tokens": toks[:, t:t + 1]}, hc)
        cc, hc = got[1], want[1]
        torch.testing.assert_close(got[0].cpu(), want[0], rtol=1e-4,
                                   atol=1e-4)
        assert torch.equal(got[0].argmax(-1).cpu(), want[0].argmax(-1))
        if router:
            assert torch.equal(got[2].cpu(), want[2])
    for key in hc:
        torch.testing.assert_close(cc[key].cpu(), hc[key], rtol=1e-4,
                                   atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["qwen2.5-3b", "kimi-k2-1t-a32b"])
def test_cuda_model_engine_matches_cpu(cuda_device, arch):
    """``ServingEngine`` with a model (``kv="sharded"``; the MoE one with
    its expert tier) on the card and on the host's CPU: the same tokens,
    page counters, expert counters and prefetch log."""
    import dataclasses

    card, params, host, h_params = _model_pair(arch, cuda_device)
    moe = "vec" if card.cfg.moe else None
    runs = []
    for model, p, dev in ((card, params, "cuda"), (host, h_params, "cpu")):
        eng = ServingEngine(model, p, max_batch=3, max_seq=64, page_size=8,
                            hbm_pages=10, kv="sharded", moe=moe, device=dev)
        for i in range(5):
            eng.submit(list(range(10)) + [30 + i, 40 + i], max_new_tokens=4)
        done = eng.run_until_idle()
        runs.append(({r.req_id: r.generated for r in done},
                     dataclasses.asdict(eng.pages.stats),
                     eng.experts and (dataclasses.asdict(eng.experts.stats),
                                      eng.experts.prefetch_log)))
    assert runs[0] == runs[1]
    assert len(runs[0][0]) == 5


@pytest.mark.gpu
def test_cuda_int8_mla_cache_matches_cpu(cuda_device):
    """The int8 latent cache on the card against the host's: int8 entries
    equal or one apart (at least 99.9% equal), logits within 1e-3."""
    card, params, host, h_params = _model_pair(
        "deepseek-v2-236b", cuda_device, kv_cache_dtype="int8")
    cc, hc = card.init_cache(2, 16), host.init_cache(2, 16)
    toks = _model_batch(card.cfg, s=12)["tokens"]
    for t in range(12):
        lc, cc = card.decode_step(params, {"tokens": toks[:, t:t + 1].cuda()},
                                  cc)
        lh, hc = host.decode_step(h_params, {"tokens": toks[:, t:t + 1]}, hc)
        torch.testing.assert_close(lc.cpu(), lh, rtol=1e-3, atol=1e-3)
    diff = (cc["latent"].cpu().int() - hc["latent"].int()).abs()
    assert int(diff.max()) <= 1 and float((diff == 0).float().mean()) >= 0.999
