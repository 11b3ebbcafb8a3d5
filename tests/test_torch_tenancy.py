"""The port's multi-tenant QoS tier (``repro_torch.tenancy``) on the CPU
against the reference's (``repro.tenancy``).

  * **Namespace laws** — vectorized membership, the tenants' allocators
    (prime for prime), the isolation checker's report and the weighted
    quotas equal the reference's; the bad inputs raise as there.
  * **Differential parity** — ``tests/test_tenancy.py``'s pinned
    tenant mixes through both packages' scalar, vectorized and (1 and 2
    shard) sharded tenanted caches: every touch's tier, the global and
    per-tenant counters, the LRU order, the host set, the prefetch logs
    and the occupancy equal each other and the reference's, with
    ``assert_isolated`` after every op.
  * **Quota semantics** — one tenant equals the untenanted cache, a
    tenant past its quota evicts only its own pages, per-tenant prefetch
    budgets, prime recycling kept inside a namespace, and the stale-chunk
    regression after a recycle.
  * **Expert tenancy** and the engines' ``tenants=`` mode (parity with
    the reference, ``tenant_stats``, bad usage).
  * **Chaos** — ``tests/test_elastic.py``'s and
    ``tests/test_serving_batching.py``'s tenanted chaos schedules, with
    the isolation checker after every event or tick.
  * **Wide** — tenancy over a 128-bit registry.

The port runs with ``device="cpu"`` (the kernels' plain versions).
"""

import torch_parity  # noqa: F401

import numpy as np
import pytest

from strategies import (ArrivalSpec, ElasticEventSpec, ExpertWorkloadSpec,
                        TenantMixSpec, apply_elastic_event,
                        build_expert_sets, build_failure_schedule,
                        build_poisson_arrivals, build_tenant_requests,
                        drive_slots, drive_tenants)
from repro.core.composite import CompositeRegistry as RefRegistry
from repro.core.primes import HierarchicalPrimeAllocator as RefAllocator
from repro.serving import slots as ref_slots
from repro.serving.engine import ServingEngine as RefEngine
from repro.serving.kv_cache_vec import VectorizedPagedKVCache as RefVec
import repro.tenancy as R
from repro.tenancy.qos import \
    TenantedElasticShardedPagedKVCache as RefTenantedElastic
from repro_torch import tenancy as P
from repro_torch.core.composite import CompositeRegistry
from repro_torch.core.primes import CacheLevel, LEVEL_PRIME_RANGES
from repro_torch.serving import slots
from repro_torch.serving.engine import ServingEngine, make_kv_backend
from repro_torch.serving.kv_cache import PARITY_COUNTERS, PagedKVCache
from repro_torch.serving.kv_cache_vec import VectorizedPagedKVCache
from repro_torch.tenancy.namespace import TenantAssigner
from repro_torch.tenancy.qos import TenantedElasticShardedPagedKVCache

CPU = dict(device="cpu")


def _state(kv):
    """A tenanted paged-KV cache's comparable state."""
    q = kv.qos
    return (tuple(getattr(kv.stats, f) for f in PARITY_COUNTERS),
            tuple(kv.hbm.items()), frozenset(kv.host),
            tuple(kv.prefetch_log),
            tuple(tuple(getattr(s, f) for f in PARITY_COUNTERS)
                  for s in q.tenant_stats),
            tuple(tuple(log) for log in q.tenant_logs),
            tuple(int(x) for x in q.occupancy),
            tuple(int(x) for x in q.quota))


# --------------------------------------------------------------------------- #
# namespace laws                                                              #
# --------------------------------------------------------------------------- #

def test_namespace_membership_and_allocators_equal_the_reference():
    """Membership over every level's range (and the gaps) is the
    reference's and its scalar form; each tenant's allocator hands out
    the reference's primes, disjoint across tenants; the 1-tenant
    allocator is the global one."""
    rng = np.random.default_rng(0)
    vals = np.concatenate([
        rng.integers(2, 1000, size=50), rng.integers(1009, 100_000, size=50),
        rng.integers(100_003, 1_000_000, size=50),
        rng.integers(1_000_003, 3_000_000, size=50),
        np.asarray([998, 1000, 1])])
    for n in (1, 3, 4):
        ns, ref = P.TenantNamespace(n), R.TenantNamespace(n)
        got = ns.tenant_of_values(vals)
        assert got.dtype == np.int32
        assert got.tolist() == ref.tenant_of_values(vals).tolist()
        assert got.tolist() == [ns.tenant_of_value(int(v)) for v in vals]
        assert (ns.is_member(n - 1, vals) == (got == n - 1)).all()
        assert ns.describe() == ref.describe()
    ns, ref = P.TenantNamespace(4, shared=True), R.TenantNamespace(
        4, shared=True)
    assert (ns.n_parts, ns.shared_part) == (ref.n_parts, ref.shared_part) \
        == (5, 4)
    primes = []
    for t in range(ns.n_parts):
        a, b = ns.make_allocator(t), ref.make_allocator(t)
        for lvl in CacheLevel.ALL:
            got = [a.allocate(lvl) for _ in range(12)]
            assert got == [b.allocate(lvl) for _ in range(12)]
            assert (ns.tenant_of_values(got) == t).all()
            primes += got
    assert len(set(primes)) == len(primes)
    one, glob = P.TenantNamespace(1).make_allocator(0), RefAllocator()
    for lvl in CacheLevel.ALL:
        assert [one.allocate(lvl) for _ in range(32)] == \
            [glob.allocate(lvl) for _ in range(32)]
    with pytest.raises(ValueError):
        P.TenantNamespace(0)
    with pytest.raises(ValueError):
        P.TenantNamespace(4).make_allocator(4)


def test_isolation_checker_report_equals_the_reference():
    """On the same relationships the port's checker gives the reference's
    report, green then (after a cross-tenant relationship) red."""
    reports = []
    for pkg, reg in ((P, CompositeRegistry()), (R, RefRegistry())):
        ns = pkg.TenantNamespace(2)
        a0, a1 = ns.make_allocator(0), ns.make_allocator(1)
        p0 = [a0.allocate(CacheLevel.L2) for _ in range(6)]
        p1 = [a1.allocate(CacheLevel.L2) for _ in range(6)]
        for i in range(0, 6, 2):
            reg.register({p0[i], p0[i + 1]})
            reg.register({p1[i], p1[i + 1]})
        good = ns.check_isolation(reg, pairwise_gcd=True)
        ns.assert_isolated(reg)
        reg.register({p0[0], p1[0]})
        bad = ns.check_isolation(reg, pairwise_gcd=True)
        with pytest.raises(AssertionError):
            ns.assert_isolated(reg)
        reports.append([(r.ok, r.n_relationships, r.n_composites,
                         r.per_tenant, r.violations, r.coprime_pairs_checked,
                         r.n_shared) for r in (good, bad)])
    assert reports[0] == reports[1]
    assert reports[0][0][0] and reports[0][0][5] == 9
    assert not reports[0][1][0]


def test_quotas_and_configs_equal_the_reference():
    for cap, pri in ((10, [3, 1, 1]), (4, [100, 1, 1, 1]), (17, [5, 2, 1]),
                     (7, [1000, 1, 1]), (128, [4, 1, 1, 1, 1, 1, 1, 1])):
        assert P.weighted_quotas(cap, pri) == R.weighted_quotas(cap, pri)
    for bad in ((2, [1, 1, 1]), (4, [1, 0]), (4, [])):
        with pytest.raises(ValueError):
            P.weighted_quotas(*bad)
    cfg = P.TenantQoSConfig.weighted(12, [2, 1, 1], prefetch_budget=3)
    ref = R.TenantQoSConfig.weighted(12, [2, 1, 1], prefetch_budget=3)
    assert (cfg.hbm_quota, cfg.prefetch_budget, cfg.priority) == \
        (ref.hbm_quota, ref.prefetch_budget, ref.priority)
    for bad in (P.TenantQoSConfig(2, (8, 8), (1, 1), (1, 1)),
                P.TenantQoSConfig(2, (8,), (1, 1), (1, 1)),
                P.TenantQoSConfig(2, (4, 4), (1, -1), (1, 1)),
                P.TenantQoSConfig(2, (4, 4), (1, 1), (1, 1), shared_quota=5)):
        with pytest.raises(ValueError):
            bad.validate(12)
    with pytest.raises(ValueError):
        P.TenantedVectorizedPagedKVCache(hbm_pages=4, qos=8, **CPU)
    with pytest.raises(ValueError):
        P.TenantedVectorizedPagedKVCache(
            hbm_pages=8, qos=2, namespace=P.TenantNamespace(3), **CPU)
    assert np.allclose(
        P.qos.refcount_weighted_shares([2, 1], [{0: 1, 1: 1}, {1: 3}]),
        R.qos.refcount_weighted_shares([2, 1], [{0: 1, 1: 1}, {1: 3}]))


def test_assigner_introspection():
    ns = P.TenantNamespace(2)
    assert ns.stripes.block_of(CacheLevel.L2)[1] >= 1
    ta = TenantAssigner(ns, CompositeRegistry())
    with pytest.raises(KeyError):
        ta.assign("unbound", CacheLevel.L2)
    ta.release("unbound", CacheLevel.L2)
    assert ta.tenant_of("unbound") is None
    assert ta.data_of(1009) is None
    assert ta.epoch == 0
    kv = P.TenantedVectorizedPagedKVCache(hbm_pages=8, page_size=4, qos=2,
                                          **CPU)
    kv.register_request(0, list(range(8)), tenant=1)
    kv.touch(0, 0)
    assert len(kv.tenant_hit_rates()) == 2
    with pytest.raises(ValueError):
        kv.register_request(1, [1, 2, 3], tenant=2)
    pages = kv.register_request(2, [1, 2, 3, 4, 5], tenant=1)
    assert all(kv.tenant_of_page(p) == 1 for p in pages)
    assert not set(pages) & set(kv.register_request(3, [1, 2, 3, 4, 5],
                                                    tenant=0))
    assert kv.register_request(4, [1, 2, 3, 4, 5], tenant=1) == pages


# --------------------------------------------------------------------------- #
# differential parity, against each other and the reference                   #
# --------------------------------------------------------------------------- #

#: ``tests/test_tenancy.py``'s pinned cases
_PINNED = [
    (TenantMixSpec(seed=3, n_tenants=1, n_requests=8, n_touches=90), 8, 3),
    (TenantMixSpec(seed=5, n_tenants=4, n_requests=10, n_touches=100), 4, 2),
    (TenantMixSpec(seed=7, n_tenants=2, n_requests=12, n_touches=120,
                   hot_tenant=True), 6, 2),
    (TenantMixSpec(seed=9, n_tenants=3, n_requests=10, n_touches=80,
                   scanner_tenant=True), 9, 2),
    (TenantMixSpec(seed=11, n_tenants=2, n_requests=9, n_touches=90,
                   cross_prefix=True, drop_primes=True), 8, 3),
]
_PIN_IDS = ["degenerate-1", "quota-1page", "hot-exhaustion", "scanner",
            "cross-prefix-drops"]


def _differential(spec, hbm, budget, shards=()):
    ops = build_tenant_requests(spec)
    T = spec.n_tenants
    kw = dict(hbm_pages=hbm, page_size=4, prefetch_budget=budget, qos=T)
    caches = {"scalar": P.TenantedPagedKVCache(**kw, **CPU),
              "vec": P.TenantedVectorizedPagedKVCache(**kw, **CPU),
              "ref_scalar": R.TenantedPagedKVCache(**kw),
              "ref_vec": R.TenantedVectorizedPagedKVCache(**kw)}
    for n in shards:
        caches[f"shard{n}"] = P.TenantedShardedPagedKVCache(
            n_shards=n, **kw, **CPU)

    def isolated(kv):
        kv.namespace.assert_isolated(kv.registry)

    tiers = {name: drive_tenants(kv, ops, step_hook=isolated
                                 if name == "vec" else None)
             for name, kv in caches.items()}
    want = _state(caches["ref_scalar"])
    for name, kv in caches.items():
        assert tiers[name] == tiers["ref_scalar"], name
        assert _state(kv) == want, name
        assert kv.cross_tenant_prefetches() == 0, name
        assert (kv.qos.occupancy <= kv.qos.quota).all(), name
    assert caches["vec"].stats.registry_scans == 0
    for n in shards:
        kv = caches[f"shard{n}"]
        assert (kv.aggregate_shard_stats().parity_tuple()
                == kv.stats.parity_tuple())
    return caches


@pytest.mark.parametrize("spec,hbm,budget", _PINNED, ids=_PIN_IDS)
def test_pinned_tenant_mixes_equal_the_reference(spec, hbm, budget):
    _differential(spec, hbm, budget)


@pytest.mark.parametrize("spec,hbm,budget", [_PINNED[2], _PINNED[3]],
                         ids=["hot-exhaustion", "scanner"])
def test_tenancy_composes_with_sharded(spec, hbm, budget):
    """Tenant namespaces x the prime-space partitioned cache (1 and 2
    shards, its refreshes through the mask and gcd exchange): parity,
    per-tenant accounting and per-shard aggregation hold."""
    caches = _differential(spec, hbm, budget, shards=(1, 2))
    assert caches["shard2"].bulk_refreshes > 0


# --------------------------------------------------------------------------- #
# quota semantics                                                             #
# --------------------------------------------------------------------------- #

class _Untenanted:
    """Drives an untenanted cache with tenant-tagged ops (1 tenant)."""

    def __init__(self, kv):
        self._kv = kv

    def register_request(self, rid, tokens, tenant=0):
        assert tenant == 0
        return self._kv.register_request(rid, tokens)

    def __getattr__(self, name):
        return getattr(self._kv, name)


def test_one_tenant_equals_untenanted_cache():
    ops = build_tenant_requests(TenantMixSpec(seed=13, n_tenants=1,
                                              n_requests=10, n_touches=120))
    a = VectorizedPagedKVCache(hbm_pages=8, page_size=4, prefetch_budget=3,
                               **CPU)
    b = P.TenantedVectorizedPagedKVCache(hbm_pages=8, page_size=4,
                                         prefetch_budget=3, qos=1, **CPU)
    c = R.TenantedVectorizedPagedKVCache(hbm_pages=8, page_size=4,
                                         prefetch_budget=3, qos=1)
    ta = drive_tenants(_Untenanted(a), ops)
    assert drive_tenants(b, ops) == ta == drive_tenants(c, ops)
    assert a.stats.parity_tuple() == b.stats.parity_tuple()
    assert list(a.hbm.items()) == list(b.hbm.items())
    assert a.host == b.host and a.prefetch_log == b.prefetch_log
    assert b.qos.tenant_stats[0].parity_tuple() == b.stats.parity_tuple()
    assert _state(b) == _state(c)


def test_quota_exhaustion_confines_evictions():
    """A tenant far past its quota evicts only its own pages, as in the
    reference: the bystander's pages stay resident, every eviction is
    charged to the churning tenant."""
    states = []
    for pkg, kw in ((P, CPU), (R, {})):
        kv = pkg.TenantedVectorizedPagedKVCache(
            hbm_pages=8, page_size=4, prefetch_budget=2,
            qos=pkg.TenantQoSConfig(2, (2, 6), (2, 2), (1, 3)), **kw)
        kv.register_request(100, list(range(12)), tenant=1)
        for j in range(3):
            kv.touch(100, j)
        resident = [pid for pid in kv.chains[100] if pid in kv.hbm]
        assert len(resident) == 3
        for r in range(25):
            kv.register_request(r, [1000 + 4 * r + k for k in range(4)],
                                tenant=0)
            kv.touch(r, 0)
            assert kv.qos.occupancy[0] <= 2
            assert all(pid in kv.hbm for pid in resident)
        assert kv.stats.evictions >= 23
        assert kv.qos.tenant_stats[0].evictions == kv.stats.evictions
        assert kv.qos.tenant_stats[1].evictions == 0
        states.append(_state(kv))
    assert states[0] == states[1]


def test_scanner_cannot_thrash_the_hot_tenant():
    """``case_tenancy``'s protection A/B on both packages."""
    from repro_torch.cases import tenancy_protection

    protected = tenancy_protection(True, device="cpu")
    shared = tenancy_protection(False, device="cpu")
    assert shared < 0.2 and protected > 0.85
    assert (protected, shared) == (0.8666666666666667, 0.0)


def test_per_tenant_prefetch_budget_enforced():
    cfgs = {P: P.TenantQoSConfig(2, (6, 6), (0, 3), (1, 1)),
            R: R.TenantQoSConfig(2, (6, 6), (0, 3), (1, 1))}
    states = []
    for pkg, kw in ((P, CPU), (R, {})):
        for cls in (pkg.TenantedPagedKVCache,
                    pkg.TenantedVectorizedPagedKVCache):
            kv = cls(hbm_pages=12, page_size=4, prefetch_budget=4,
                     qos=cfgs[pkg], **kw)
            kv.register_request(0, list(range(32)), tenant=0)
            kv.register_request(1, list(range(100, 132)), tenant=1)
            kv.touch(0, 0)
            kv.touch(1, 0)
            assert not kv.qos.tenant_logs[0] and kv.qos.tenant_logs[1]
            assert kv.qos.tenant_stats[0].prefetches == 0
            assert kv.qos.tenant_stats[1].prefetches == len(
                kv.qos.tenant_logs[1])
            assert kv.cross_tenant_prefetches() == 0
            states.append(_state(kv))
    assert len(set(states)) == 1


def test_shared_prefix_after_prime_recycle_matches_oracle():
    """The stale-chunk regression: a prime freed by recycling and given
    to a new page must not gcd-match the old chain."""
    a = PagedKVCache(hbm_pages=8, page_size=4, **CPU)
    b = VectorizedPagedKVCache(hbm_pages=8, page_size=4, **CPU)
    c = RefVec(hbm_pages=8, page_size=4)
    for kv in (a, b, c):
        kv.register_request(0, [1, 2, 3, 4])
        kv.assigner.release(0, CacheLevel.L2)
        kv.register_request(1, [9, 9, 9, 9])
    assert a.assigner.prime_of(1) == b.assigner.prime_of(1) \
        == c.assigner.prime_of(1)
    assert a.shared_prefix(0, 1) == b.shared_prefix(0, 1) == \
        c.shared_prefix(0, 1) == []


def test_noisy_tenant_recycling_stays_in_its_namespace():
    """A tenant exhausting its pools recycles its own LRU elements only;
    the other tenant's bindings survive; scalar, vec and the reference's
    vec agree on tiers, counters, LRU order and prefetch log."""
    ranges = {CacheLevel.L1: (2, 13), CacheLevel.L2: (17, 97),
              CacheLevel.L3: (101, 199), CacheLevel.MEM: (211, None)}
    caches = [
        P.TenantedPagedKVCache(hbm_pages=8, page_size=4, prefetch_budget=2,
                               qos=2, namespace=P.TenantNamespace(
                                   2, ranges=ranges), **CPU),
        P.TenantedVectorizedPagedKVCache(
            hbm_pages=8, page_size=4, prefetch_budget=2, qos=2,
            namespace=P.TenantNamespace(2, ranges=ranges), **CPU),
        R.TenantedVectorizedPagedKVCache(
            hbm_pages=8, page_size=4, prefetch_budget=2, qos=2,
            namespace=R.TenantNamespace(2, ranges=ranges))]
    tiers = []
    for kv in caches:
        kv.register_request(1000, list(range(500, 516)), tenant=1)
        quiet = {pid: kv.assigner.prime_of(pid) for pid in kv.chains[1000]}
        t = []
        for r in range(30):
            for k in range(6):
                kv.assigner.per_tenant[0].tracker.record(kv._next_page + k)
                kv.assigner.per_tenant[0].tracker.record(kv._next_page + k)
            kv.register_request(r, [r * 40 + k for k in range(16)],
                                tenant=0)
            t.extend(kv.touch_batch([(r, j)
                                     for j in range(len(kv.chains[r]))]))
        tiers.append(t)
        assert kv.assigner.per_tenant[0].stats.recycle_events > 0
        assert kv.assigner.per_tenant[1].stats.recycle_events == 0
        assert {pid: kv.assigner.prime_of(pid)
                for pid in kv.chains[1000]} == quiet
        kv.namespace.assert_isolated(kv.registry)
    assert tiers[0] == tiers[1] == tiers[2]
    assert _state(caches[0]) == _state(caches[1]) == _state(caches[2])


# --------------------------------------------------------------------------- #
# the tenanted expert tier                                                    #
# --------------------------------------------------------------------------- #

def _expert_state(ec):
    return (ec.stats.parity_tuple(), tuple(ec.hbm.items()),
            tuple(ec.prefetch_log), ec.cross_tenant_groups,
            tuple(tuple(log) for log in ec.qos.tenant_logs),
            tuple(int(x) for x in ec.qos.occupancy))


def test_expert_tenancy_equals_the_reference():
    """Scalar and vectorized tenanted expert caches: tiers, counters, LRU
    order, prefetch and per-tenant logs equal each other and the
    reference's; router sets spanning tenants are split; the registry
    stays isolated; every prefetch target co-fires with its source."""
    batches = build_expert_sets(ExpertWorkloadSpec(
        seed=2, n_experts=24, n_steps=50, batch=3, group_size=5,
        n_groups=10, oversize_every=4))
    caches = [P.TenantedExpertCache(24, hbm_slots=9, prefetch_budget=3,
                                    qos=3, **CPU),
              P.TenantedVectorizedExpertCache(24, hbm_slots=9,
                                              prefetch_budget=3, qos=3,
                                              **CPU),
              R.TenantedExpertCache(24, hbm_slots=9, prefetch_budget=3,
                                    qos=3)]
    tiers = []
    for ec in caches:
        t = []
        for batch in batches:
            ec.observe_routing(batch)
            t.extend(tuple(sorted(d.items()))
                     for d in ec.activate_batch(batch))
        tiers.append(t)
        ec.namespace.assert_isolated(ec.registry)
        assert ec.cross_tenant_prefetches() == 0
        assert (ec.qos.occupancy <= ec.qos.quota).all()
        assert ec.qos.tenant_stats is None
    assert tiers[0] == tiers[1] == tiers[2]
    assert _expert_state(caches[0]) == _expert_state(caches[1]) \
        == _expert_state(caches[2])
    assert caches[0].cross_tenant_groups > 0
    for src, tgt in caches[0].prefetch_log:
        assert tgt in caches[0].coactivated(src)


def test_expert_quota_one_slot_and_custom_mapping():
    sets = [(0, 1, 2), (4, 5, 6), (2, 3), (6, 7), (0, 1), (5, 4)]
    caches = [P.TenantedExpertCache(8, hbm_slots=2, prefetch_budget=2,
                                    qos=2, **CPU),
              P.TenantedVectorizedExpertCache(8, hbm_slots=2,
                                              prefetch_budget=2, qos=2,
                                              **CPU),
              R.TenantedVectorizedExpertCache(8, hbm_slots=2,
                                              prefetch_budget=2, qos=2)]
    for ec in caches:
        ec.observe_routing(sets)
        ec.activate_batch(sets)
        assert (ec.qos.occupancy <= 1).all()
    assert _expert_state(caches[0]) == _expert_state(caches[1]) \
        == _expert_state(caches[2])
    mapping = [0, 1, 0, 1, 0, 1]
    ec = P.TenantedExpertCache(6, hbm_slots=4, prefetch_budget=2, qos=2,
                               tenant_of_expert=mapping, **CPU)
    assert ec.tenant_of_expert.tolist() == mapping
    ec.observe_routing([(0, 2, 4), (1, 3)])
    ec.activate_batch([(0, 2), (1, 3)])
    ec.namespace.assert_isolated(ec.registry)
    for bad in ([0, 1], [0, 1, 2, 0, 1, 5]):
        with pytest.raises(ValueError):
            P.TenantedExpertCache(6, hbm_slots=4, qos=2,
                                  tenant_of_expert=bad, **CPU)


# --------------------------------------------------------------------------- #
# the engines' tenants= mode                                                  #
# --------------------------------------------------------------------------- #

def _tenant_engine(eng, n_req=24, seed=0, tenants=3):
    rng = np.random.default_rng(seed)
    for r in range(n_req):
        eng.submit(list(rng.integers(0, 500, size=int(rng.integers(8, 48)))),
                   max_new_tokens=6, tenant=r % tenants)
    return sorted(((r.req_id, tuple(r.generated))
                   for r in eng.run_until_idle()))


@pytest.mark.parametrize("kv", ["vec", "scalar", "sharded", "elastic"])
def test_engine_tenants_mode_equals_the_reference(kv):
    """``ServingEngine(tenants=3)`` over each backend gives the
    reference's tokens, counters, per-tenant stats and prefetch log;
    per-tenant stats partition the totals; with ``moe=`` the tenanted
    expert tier takes the tenant count."""
    cfg = dict(max_batch=8, page_size=8, hbm_pages=24, prefetch_budget=3,
               reread_window=2, tenants=3, moe="vec", moe_experts=12,
               moe_slots=6)
    port = ServingEngine(None, None, kv=kv, **cfg, **CPU)
    ref = RefEngine(None, None, kv=kv, **cfg,
                    **({"mesh": None} if kv in ("sharded", "elastic")
                       else {}))
    assert _tenant_engine(port) == _tenant_engine(ref)
    assert _state(port.pages) == _state(ref.pages)
    assert port.experts.stats.parity_tuple() == \
        ref.experts.stats.parity_tuple()
    assert isinstance(port.experts, P.TenantedVectorizedExpertCache)
    assert port.experts.qos_config.n_tenants == 3
    pages = port.pages
    assert pages.cross_tenant_prefetches() == 0
    pages.namespace.assert_isolated(pages.registry)
    for f in PARITY_COUNTERS:
        assert sum(getattr(s, f) for s in pages.qos.tenant_stats) \
            == getattr(pages.stats, f), f


def test_engine_tenants_mode_rejects_bad_usage():
    eng = ServingEngine(None, None, max_batch=4, hbm_pages=16, **CPU)
    with pytest.raises(ValueError):
        eng.submit([1, 2, 3], tenant=1)
    with pytest.raises(ValueError):
        ServingEngine(None, None, max_batch=4, hbm_pages=16, kv="magic",
                      tenants=2, **CPU)
    eng2 = ServingEngine(None, None, max_batch=4, hbm_pages=16, tenants=2,
                         **CPU)
    with pytest.raises(ValueError):
        eng2.submit([1, 2, 3], tenant=2)
    assert not eng2.queue
    eng2.submit([1, 2, 3], max_new_tokens=2, tenant=1)
    assert len(eng2.run_until_idle()) == 1
    m = slots.SlotMachine(max_batch=2, kv="vec", **CPU)
    with pytest.raises(ValueError):
        m.submit([1, 2], tenant=1)
    mt = slots.SlotMachine(max_batch=2, kv="vec", tenants=2, **CPU)
    with pytest.raises(ValueError):
        mt.submit([1, 2], tenant=5)


def test_engine_tenants_step_reports_tenant_stats():
    eng = ServingEngine(None, None, max_batch=4, page_size=8, hbm_pages=16,
                        tenants=2, **CPU)
    eng.submit(list(range(24)), max_new_tokens=3, tenant=1)
    out = {}
    while eng.queue or any(s is not None for s in eng.slots):
        out = eng.step()
    assert len(out["tenant_stats"]) == 2
    st1 = out["tenant_stats"][1]
    assert st1.hbm_hits + st1.host_hits + st1.misses > 0
    m = slots.SlotMachine(max_batch=2, page_size=4, tenants=2, **CPU)
    m.submit(list(range(12)), max_new_tokens=2, tenant=1)
    assert len(m.step()["tenant_stats"]) == 2


# --------------------------------------------------------------------------- #
# chaos with tenancy: isolation through every elastic event                   #
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("spec,espec", [
    (TenantMixSpec(seed=9, n_tenants=2, n_requests=10, n_touches=100,
                   hot_tenant=True),
     ElasticEventSpec(seed=21, n_events=5, defer=True)),
    (TenantMixSpec(seed=23, n_tenants=4, n_requests=12, n_touches=80,
                   scanner_tenant=True, cross_prefix=True),
     ElasticEventSpec(seed=8, n_events=4, resize=True, drop=True)),
], ids=["hot-defer", "scanner-resize-drop"])
def test_tenanted_elastic_chaos_equals_the_reference(spec, espec):
    """``tests/test_elastic.py``'s tenanted chaos schedules: the port's
    tenanted elastic cache equals the uninterrupted scalar oracle and the
    reference's elastic cache, per tenant too, with the isolation checker
    after every event and every op."""
    ops = build_tenant_requests(spec)
    schedule = build_failure_schedule(espec, len(ops))
    kw = dict(hbm_pages=12, page_size=4, prefetch_budget=2,
              qos=spec.n_tenants)
    oracle = P.TenantedPagedKVCache(**kw, **CPU)
    port = TenantedElasticShardedPagedKVCache(n_shards=2, **kw, **CPU)
    ref = RefTenantedElastic(n_shards=2, **kw)

    def event(kv, ev):
        apply_elastic_event(kv, ev)
        kv.namespace.assert_isolated(kv.registry)

    def hook(kv):
        kv.namespace.assert_isolated(kv.registry)

    t0 = drive_tenants(oracle, ops, schedule=schedule)
    t1 = drive_tenants(port, ops, step_hook=hook, schedule=schedule,
                       on_event=event)
    t2 = drive_tenants(ref, ops, schedule=schedule, on_event=event)
    assert t0 == t1 == t2
    assert _state(port) == _state(oracle) == _state(ref)
    assert port.cross_tenant_prefetches() == 0
    assert port.stats.registry_scans == 0


def test_slot_chaos_with_tenancy_isolation_every_tick():
    """``tests/test_serving_batching.py``'s tenanted chaos: the port's
    ``SlotMachine`` on ``kv="elastic"`` under kills and resizes equals
    its ``SlotOracle`` on ``kv="vec"`` and the reference's machine, with
    ``assert_isolated`` after every tick."""
    spec = ArrivalSpec(seed=31, n_requests=20, rate=1.5, n_tenants=2,
                       max_prompt=18, max_new=8)
    espec = ElasticEventSpec(seed=2, n_events=4, kill=True, resize=True)
    arrivals = build_poisson_arrivals(spec)
    schedule = build_failure_schedule(espec, 200)
    cfg = dict(max_batch=4, page_size=4, hbm_pages=32, prefetch_budget=2,
               reread_window=2, prefill_tokens=12, preempt_wait=3,
               tenants=2)

    def hook(eng):
        eng.pages.namespace.assert_isolated(eng.pages.registry)

    engines = [slots.SlotMachine(kv="elastic", **cfg, **CPU),
               slots.SlotOracle(kv="vec", **cfg, **CPU),
               ref_slots.SlotMachine(kv="elastic", **cfg)]
    logs = [drive_slots(e, arrivals, schedule=schedule, step_hook=hook)
            for e in engines]
    assert logs[0] == logs[1] == logs[2]
    states = [(_state(e.pages), e.ticks, e.preemptions, e.resumes,
               tuple((r.first_tick, r.done_tick, r.preemptions,
                      tuple(r.generated)) for r in e.requests))
              for e in engines]
    assert states[0] == states[1] == states[2]
    m = engines[0]
    for t in range(2):
        assert m.pages.qos.tenant_stats[t].prefetches == len(
            m.pages.qos.tenant_logs[t])


# --------------------------------------------------------------------------- #
# wide registries                                                             #
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("kv", ["vec", "sharded"])
def test_wide_tenancy_composes(kv):
    """Tenancy over a 128-bit registry (``tests/test_limbs.py``'s case):
    no cross-tenant prefetch, pairwise isolation, and the narrow run's
    state."""
    states = []
    for max_bits in (62, 128):
        t = make_kv_backend(kv, hbm_pages=32, page_size=4,
                            prefetch_budget=4, tenants=2, max_bits=max_bits,
                            **CPU)
        assert t.registry.wide == (max_bits > 63)
        t.register_request(0, list(range(20)), tenant=0)
        t.register_request(1, list(range(20)), tenant=1)
        tiers = t.touch_batch([(0, 0), (1, 0), (0, 3), (1, 3)])
        assert t.cross_tenant_prefetches() == 0
        assert t.namespace.check_isolation(t.registry, pairwise_gcd=True).ok
        states.append((tiers, _state(t)))
    assert states[0] == states[1]


def test_tenancy_exports_match_the_reference():
    assert P.__all__ == R.__all__
    assert LEVEL_PRIME_RANGES == R.namespace.LEVEL_PRIME_RANGES
