"""The port's cross-tenant copy-on-write dedup (``repro_torch.serving.
dedup``) on the CPU against the reference's (``repro.serving.dedup``).

  * **Differential parity** — ``tests/test_dedup.py``'s pinned
    shared-prompt tenant mixes through the port's scalar oracle and its
    vectorized, sharded (1 and 2 shards) and elastic dedup caches and
    through the reference's oracle: every touch's tier, every
    ``DEDUP_COUNTERS`` entry, the LRU order, the host set, the prefetch
    and per-tenant logs, per-tenant stats, ``dedup_state()`` (refcount
    maps, prefix runs, probes, aged pages) and ``charged_shares()`` equal,
    with the isolation theorem and the refcount invariants checked after
    every op; the elastic cache also under a resize, a kill and a
    recovery mid-run; and at 128 bits, where the admission probes take
    the limb gcd.
  * **Refcount lifecycle** — a referenced shared page is never evicted,
    pinned shared pages, age-out with the deferred prime recycle and its
    ``EV_AGE_OUT`` events, copy-on-write with a fresh private prime, the
    refcount-weighted charge, and the content-key collision regression,
    each equal to the reference.
  * **Slot machines** — ``SlotMachine`` against ``SlotOracle`` across
    backends with dedup, the admission prefill skip, and the engines'
    ``dedup=`` plumbing, against the reference.

The port runs with ``device="cpu"`` (the kernels' plain versions).
"""

import torch_parity  # noqa: F401

import numpy as np
import pytest

from strategies import (ArrivalSpec, TenantMixSpec, build_poisson_arrivals,
                        build_tenant_requests, drive_slots, drive_tenants)
from repro import obs as ref_obs
from repro.serving import dedup as R
from repro.serving import slots as ref_slots
from repro.serving.engine import ServingEngine as RefEngine
from repro_torch.obs import EV_AGE_OUT, EV_COW, EV_DEDUP_HIT, Observability
from repro_torch.serving import dedup as P
from repro_torch.serving import slots
from repro_torch.serving.engine import ServingEngine, make_kv_backend
from repro_torch.serving.kv_cache import PARITY_COUNTERS, PagedKVCache
from repro_torch.tenancy.qos import (TenantedPagedKVCache,
                                     refcount_weighted_shares)

CPU = dict(device="cpu")


def _state(kv):
    """A dedup cache's comparable state."""
    q = kv.qos
    return (tuple(getattr(kv.stats, f) for f in P.DEDUP_COUNTERS),
            tuple(kv.hbm.items()), frozenset(kv.host),
            tuple(kv.prefetch_log), kv.dedup_state(),
            tuple(float(x) for x in kv.charged_shares()),
            tuple(tuple(getattr(s, f) for f in PARITY_COUNTERS)
                  for s in q.tenant_stats),
            tuple(tuple(log) for log in q.tenant_logs),
            tuple(int(x) for x in q.occupancy), int(q.shared_occupancy))


def _check_invariants(kv):
    """``tests/test_dedup.py``'s step-boundary invariants."""
    kv.namespace.assert_isolated(kv.registry)
    q = kv.qos
    assert 0 <= q.shared_occupancy <= q.shared_quota
    total = 0
    for pid, per_tenant in kv._tenant_refs.items():
        r = kv.ref_of(pid)
        assert r == sum(per_tenant.values()) > 0
        total += r
        p = kv.assigner.prime_of(pid)
        assert p is not None
        assert kv.namespace.tenant_of_value(p) == kv.shared_part, pid
    assert total == sum(len(v) for v in kv._req_shared.values())
    for rid, pids in kv._req_shared.items():
        assert kv.dedup_prefix[rid] == len(pids)
        assert list(kv.chains[rid][:len(pids)]) == pids


#: ``tests/test_dedup.py``'s pinned cases
_PINNED = [
    (TenantMixSpec(seed=2, n_tenants=2, n_requests=10, n_touches=110,
                   cross_prefix=True), 24, 3),
    (TenantMixSpec(seed=4, n_tenants=4, n_requests=12, n_touches=100,
                   cross_prefix=True), 6, 2),
    (TenantMixSpec(seed=6, n_tenants=2, n_requests=12, n_touches=130,
                   cross_prefix=True, hot_tenant=True), 9, 2),
    (TenantMixSpec(seed=8, n_tenants=3, n_requests=10, n_touches=90,
                   cross_prefix=True, scanner_tenant=True), 9, 3),
    (TenantMixSpec(seed=10, n_tenants=2, n_requests=9, n_touches=80,
                   cross_prefix=True, release=False), 8, 0),
]
_PIN_IDS = ["baseline", "tight-quota", "hot-tenant", "scanner-cow",
            "no-budget-no-release"]


def _differential(spec, hbm, budget, shards=(), elastic=False,
                  max_bits=62):
    ops = build_tenant_requests(spec)
    kw = dict(hbm_pages=hbm, page_size=4, prefetch_budget=budget,
              qos=spec.n_tenants, max_bits=max_bits)
    caches = {"scalar": P.DedupOracle(**kw, **CPU),
              "vec": P.DedupVectorizedPagedKVCache(**kw, **CPU),
              "ref": R.DedupOracle(**kw)}
    for n in shards:
        caches[f"shard{n}"] = P.DedupShardedPagedKVCache(n_shards=n, **kw,
                                                         **CPU)
    if elastic:
        caches["elastic"] = P.DedupElasticShardedPagedKVCache(n_shards=2,
                                                              **kw, **CPU)
    tiers = {name: drive_tenants(kv, ops, step_hook=_check_invariants
                                 if name in ("scalar", "vec") else None)
             for name, kv in caches.items()}
    want = _state(caches["ref"])
    for name, kv in caches.items():
        assert tiers[name] == tiers["ref"], name
        assert _state(kv) == want, name
        assert kv.cross_tenant_prefetches() == 0, name
    for n in shards:
        kv = caches[f"shard{n}"]
        assert (kv.aggregate_shard_stats().parity_tuple()
                == kv.stats.parity_tuple())
    return caches


@pytest.mark.parametrize("spec,hbm,budget", _PINNED, ids=_PIN_IDS)
def test_pinned_dedup_mixes_equal_the_reference(spec, hbm, budget):
    _differential(spec, hbm, budget)


@pytest.mark.parametrize("spec,hbm,budget", [_PINNED[0], _PINNED[3]],
                         ids=["baseline", "scanner-cow"])
def test_dedup_composes_with_sharded_and_elastic(spec, hbm, budget):
    """Dedup x the partitioned cache (1 and 2 shards) and x the elastic
    cache, their refreshes through the mask, gcd and factorization:
    parity with the reference and per-shard aggregation hold."""
    caches = _differential(spec, hbm, budget, shards=(1, 2), elastic=True)
    assert caches["shard2"].bulk_refreshes > 0


def test_dedup_elastic_chaos_mid_run_equals_the_reference():
    """A resize, a kill and a recovery mid-workload move shard striping
    only: the port's elastic dedup cache equals the uninterrupted oracle
    and the reference's elastic dedup cache under the same events."""
    spec, hbm, budget = _PINNED[2]
    ops = build_tenant_requests(spec)
    kw = dict(hbm_pages=hbm, page_size=4, prefetch_budget=budget,
              qos=spec.n_tenants)
    third = len(ops) // 3
    schedule = {third: [("resize", 3)],
                2 * third: [("kill", 1), ("recover", 1)]}

    def fire(kv, ev):
        if ev[0] == "resize":
            kv.resize(ev[1])
        elif ev[0] == "kill":
            kv.fail_shard(ev[1])
        else:
            kv.recover_shard(ev[1])

    oracle = P.DedupOracle(**kw, **CPU)
    port = P.DedupElasticShardedPagedKVCache(**kw, **CPU)
    ref = R.DedupElasticShardedPagedKVCache(**kw)
    ta = drive_tenants(oracle, ops)
    tb = drive_tenants(port, ops, schedule=schedule, on_event=fire,
                       step_hook=_check_invariants)
    tc = drive_tenants(ref, ops, schedule=schedule, on_event=fire)
    assert ta == tb == tc
    assert _state(port) == _state(oracle) == _state(ref)
    assert port.n_shards == 3 and port.recoveries >= 1


def test_wide_dedup_probes_take_the_limb_gcd(monkeypatch):
    """At ``max_bits`` 128 the admission probes route through the limb
    gcd (``gcd_batch_limbs``, its plain version here) and parity with the
    reference holds, equal to the narrow run."""
    import repro_torch.serving.kv_cache_vec as kv_vec

    spec, hbm, budget = _PINNED[0]
    calls = []
    orig = kv_vec.gcd_batch_limbs

    def counted(*a, **k):
        calls.append(len(a[0]))
        return orig(*a, **k)

    monkeypatch.setattr(kv_vec, "gcd_batch_limbs", counted)
    wide = _differential(spec, hbm, budget, max_bits=128)
    assert wide["vec"].registry.wide and wide["vec"].dedup_probes > 0
    assert calls
    narrow = _differential(spec, hbm, budget)
    assert _state(narrow["vec"]) == _state(wide["vec"])


# --------------------------------------------------------------------------- #
# refcount lifecycle                                                          #
# --------------------------------------------------------------------------- #

def _lifecycle_drive(kv, ops):
    """``tests/test_dedup.py``'s replay: a shared page that left HBM was
    unreferenced at the previous boundary unless this op dropped its
    references; COW never rewrites a live composite except through the
    deferred age-out flush."""
    live, prev, composites_before = [], {}, set()
    for op in ops:
        kind, dropped = op[0], set()
        if kind == "register":
            _, rid, tenant, tokens = op
            if rid in kv.chains:
                dropped = set(kv._req_shared.get(rid, ()))
            kv.register_request(rid, list(tokens), tenant=tenant)
            live.append(rid)
            now = set(kv.registry._by_composite)
            aged = {p for _, p in kv.dedup_aged if p > 0}
            for c in composites_before - now:
                assert any(c % p == 0 for p in aged)
            composites_before = now
        elif kind == "touch":
            if live:
                rid = live[op[1] % len(live)]
                chain = kv.chains.get(rid) or ()
                if chain:
                    kv.touch(rid, op[2] % len(chain))
        elif kind == "sweep":
            if live:
                rid = live[op[1] % len(live)]
                chain = kv.chains.get(rid) or ()
                if chain:
                    kv.touch_batch([(rid, j) for j in range(len(chain))])
        elif kind == "release":
            if live:
                rid = live.pop(0)
                dropped = set(kv._req_shared.get(rid, ()))
                kv.release_request(rid)
        for pid, r in prev.items():
            assert not (r > 0 and not kv._resident(pid)
                        and pid not in dropped), pid
        prev = {pid: kv.ref_of(pid) for pid in kv._tenant_refs
                if kv._resident(pid)}
        _check_invariants(kv)


@pytest.mark.parametrize("spec,hbm,budget", _PINNED, ids=_PIN_IDS)
def test_refcount_lifecycle_equals_the_reference(spec, hbm, budget):
    ops = build_tenant_requests(spec)
    states = []
    for cls, kw in ((P.DedupOracle, CPU), (P.DedupVectorizedPagedKVCache,
                                           CPU), (R.DedupOracle, {})):
        kv = cls(hbm_pages=hbm, page_size=4, prefetch_budget=budget,
                 qos=spec.n_tenants, **kw)
        _lifecycle_drive(kv, ops)
        states.append(_state(kv))
    assert states[0] == states[1] == states[2]


def test_referenced_shared_pages_are_pinned():
    states = []
    for cls, kw in ((P.DedupOracle, CPU), (P.DedupVectorizedPagedKVCache,
                                           CPU),
                    (R.DedupVectorizedPagedKVCache, {})):
        kv = cls(hbm_pages=9, page_size=2, prefetch_budget=0, qos=2, **kw)
        assert kv.qos_config.shared_quota == 3
        prompt = list(range(10))
        kv.register_request(0, prompt + [100, 101], tenant=0)
        kv.register_request(1, prompt + [200, 201], tenant=1)
        shared = kv._req_shared[1]
        assert len(shared) == 5 and kv.stats.dedup_promotions == 5
        kv.touch_batch([(1, j) for j in range(5)])
        resident = [pid for pid in shared if kv._resident(pid)]
        assert len(resident) == 3 and kv.qos.shared_occupancy == 3
        host_shared = [pid for pid in shared if not kv._resident(pid)]
        kv.touch_batch([(1, shared.index(host_shared[0]))])
        assert [pid for pid in shared if kv._resident(pid)] == resident
        kv.release_request(0)
        kv.release_request(1)
        fresh = [p + 500 for p in prompt]
        kv.register_request(2, fresh + [300, 301], tenant=0)
        kv.register_request(3, fresh + [400, 401], tenant=1)
        ev0 = kv.stats.evictions
        kv.touch_batch([(3, j) for j in range(5)])
        assert kv.stats.evictions > ev0 and kv.qos.shared_occupancy == 3
        states.append(_state(kv))
    assert states[0] == states[1] == states[2]


def test_zero_ref_shared_page_ages_out_and_recycles_prime():
    """Evicting a zero-ref shared page ages it out of the content map at
    once and releases its prime at the next registration, with its
    ``EV_AGE_OUT`` event; the twins and the reference agree on the
    audit trail, the state and the event stream."""
    runs = []
    for cls, ob, kw in ((P.DedupOracle, Observability, CPU),
                        (P.DedupVectorizedPagedKVCache, Observability, CPU),
                        (R.DedupVectorizedPagedKVCache,
                         ref_obs.Observability, {})):
        kv = cls(hbm_pages=9, page_size=2, prefetch_budget=0, qos=2, **kw)
        kv.obs = obs = ob()
        prompt = list(range(10))
        kv.register_request(0, prompt + [100, 101], tenant=0)
        kv.register_request(1, prompt + [200, 201], tenant=1)
        shared = list(kv._req_shared[1])
        kv.touch_batch([(1, j) for j in range(5)])
        kv.release_request(0)
        kv.release_request(1)
        fresh = [p + 500 for p in prompt]
        kv.register_request(2, fresh + [300, 301], tenant=0)
        kv.register_request(3, fresh + [400, 401], tenant=1)
        kv.touch_batch([(3, j) for j in range(5)])
        aged = dict(kv.dedup_aged)
        assert aged
        for pid, prime in aged.items():
            assert pid in shared and prime > 0
            assert not kv._resident(pid) and pid not in kv.host
            assert pid not in kv._shared_users
        assert not set(aged) & set(kv._global_content.values())
        assert [e.page for e in obs.trace.events()
                if e.kind == EV_AGE_OUT] == [pid for pid, _ in kv.dedup_aged]
        assert kv._aged_pending
        assert all(kv.assigner.prime_of(pid) is not None for pid in aged)
        kv.register_request(4, prompt + [999], tenant=0)
        assert not kv._aged_pending
        assert all(kv.assigner.prime_of(pid) is None for pid in aged)
        assert not set(kv.chains[4]) & set(aged)
        kv.namespace.assert_isolated(kv.registry)
        runs.append((sorted(kv.dedup_aged), _state(kv),
                     [tuple(e) for e in obs.trace.events()]))
    assert runs[0][:2] == runs[1][:2] == runs[2][:2]
    assert runs[1][2] == runs[2][2]
    kinds = {e[0] for e in runs[1][2]}
    assert {EV_AGE_OUT, EV_COW} <= kinds


def test_cow_allocates_fresh_prime_composites_untouched():
    states = []
    for cls, kw in ((P.DedupOracle, CPU), (R.DedupOracle, {})):
        kv = cls(hbm_pages=24, page_size=2, prefetch_budget=2, qos=3, **kw)
        prefix = [1, 2, 3, 4]
        kv.register_request(0, prefix + [10, 11], tenant=0)
        kv.register_request(1, prefix + [20, 21], tenant=1)
        shared = list(kv._req_shared[1])
        assert len(shared) == 2
        shared_primes = {pid: kv.assigner.prime_of(pid) for pid in shared}
        before = set(kv.registry._by_composite)
        cow = kv.stats.cow_copies
        kv.register_request(2, prefix + [30, 31], tenant=2)
        assert kv.stats.cow_copies == cow + 1
        chain = kv.chains[2]
        assert list(chain[:2]) == shared
        p = kv.assigner.prime_of(chain[2])
        assert p not in shared_primes.values()
        assert kv.namespace.tenant_of_value(p) == 2
        assert {pid: kv.assigner.prime_of(pid) for pid in shared} \
            == shared_primes
        assert before <= set(kv.registry._by_composite)
        assert kv.namespace.check_isolation(kv.registry,
                                            pairwise_gcd=True).ok
        states.append((_state(kv), sorted(kv.registry._by_composite)))
    assert states[0] == states[1]


def test_charged_shares_refcount_weighted():
    assert np.allclose(refcount_weighted_shares([2, 1], [{0: 1, 1: 1},
                                                         {1: 3}]), [2.5, 2.5])
    shares = []
    for cls, kw in ((P.DedupVectorizedPagedKVCache, CPU),
                    (R.DedupVectorizedPagedKVCache, {})):
        kv = cls(hbm_pages=12, page_size=2, prefetch_budget=2, qos=2, **kw)
        kv.register_request(0, [1, 2, 3, 4, 50], tenant=0)
        kv.register_request(1, [1, 2, 3, 4, 60], tenant=1)
        kv.touch_batch([(0, j) for j in range(3)]
                       + [(1, j) for j in range(3)])
        occ, refs = kv.qos.occupancy, kv.shared_page_refs()
        assert refs and all(set(r) == {1} for r in refs)
        assert np.allclose(kv.charged_shares(),
                           [occ[0], occ[1] + len(refs)])
        kv.register_request(2, [1, 2, 3, 4, 70], tenant=0)
        kv.touch_batch([(2, j) for j in range(3)])
        both = [r for r in kv.shared_page_refs() if set(r) == {0, 1}]
        assert both and all(r == {0: 1, 1: 1} for r in both)
        shares.append([float(x) for x in kv.charged_shares()])
    assert shares[0] == shares[1]


def test_content_key_hash_collision_regression():
    """``(-1,)`` and ``(-2,)`` collide under ``hash``; distinct content
    still gets distinct pages in the plain, tenanted and dedup caches."""
    assert hash((-1,)) == hash((-2,))
    kv = PagedKVCache(hbm_pages=8, page_size=1, **CPU)
    kv.register_request(0, [-1])
    kv.register_request(1, [-2])
    assert kv.chains[0][0] != kv.chains[1][0]
    assert kv.shared_prefix(0, 1) == [] and kv.stats.shared_prefix_pages == 0
    t = TenantedPagedKVCache(hbm_pages=8, page_size=1, qos=2, **CPU)
    t.register_request(0, [-1], tenant=0)
    t.register_request(1, [-2], tenant=0)
    assert t.chains[0][0] != t.chains[1][0]
    d = P.DedupOracle(hbm_pages=9, page_size=1, qos=2, **CPU)
    d.register_request(0, [-1], tenant=0)
    d.register_request(1, [-2], tenant=1)
    assert d.chains[0][0] != d.chains[1][0]
    assert d.stats.dedup_hits == d.stats.dedup_promotions == 0
    d.register_request(2, [-1], tenant=1)
    assert d.stats.dedup_promotions == 1


# --------------------------------------------------------------------------- #
# slot machines and the engine                                                #
# --------------------------------------------------------------------------- #

_SLOT_SPEC = ArrivalSpec(seed=5, n_requests=18, rate=1.5, max_prompt=24,
                         max_new=8, shared_pool=16, n_tenants=2)
_SLOT_CFG = dict(max_batch=4, page_size=4, hbm_pages=27, prefetch_budget=2,
                 reread_window=2, prefill_tokens=12, preempt_wait=3,
                 tenants=2, dedup=True)


def _slot_state(eng):
    return (tuple(eng.tier_log),
            tuple(getattr(eng.pages.stats, f) for f in P.DEDUP_COUNTERS),
            eng.pages.dedup_state(), eng.ticks, eng.preemptions, eng.resumes,
            tuple((r.state, r.first_tick, r.done_tick, r.ttft(), r.tpot(),
                   tuple(r.generated)) for r in eng.requests))


@pytest.mark.parametrize("kv_m,kv_o", [("vec", "scalar"),
                                       ("sharded", "vec"),
                                       ("elastic", "scalar")])
def test_slot_machine_dedup_equals_the_reference(kv_m, kv_o):
    """``SlotMachine`` and ``SlotOracle`` with dedup across backends:
    tier logs, ``DEDUP_COUNTERS``, the twin state and every request's
    timings (the prefill skip included) equal each other and the
    reference's machine."""
    arrivals = build_poisson_arrivals(_SLOT_SPEC)
    m = slots.SlotMachine(kv=kv_m, **_SLOT_CFG, **CPU)
    o = slots.SlotOracle(kv=kv_o, **_SLOT_CFG, **CPU)
    r = ref_slots.SlotMachine(kv=kv_m, **_SLOT_CFG)
    for eng in (m, o, r):
        drive_slots(eng, arrivals)
    assert _slot_state(m) == _slot_state(o) == _slot_state(r)
    assert all(rq.state == "done" for rq in m.requests)
    assert m.pages.stats.dedup_hits > 0
    assert m.pages.cross_tenant_prefetches() == 0


def test_slot_machine_dedup_skips_shared_prefill():
    """A request whose prompt is an already-shared prefix finishes its
    prefill in fewer ticks with dedup than without, in both machines,
    as in the reference."""
    arrivals = [(0, tuple(list(range(24)) + [100 + i]), 2, i % 2)
                for i in range(4)]
    ttft = {}
    for dedup in (False, True):
        for pkg, kw in ((slots, CPU), (ref_slots, {})):
            for cls in ("SlotMachine", "SlotOracle"):
                m = getattr(pkg, cls)(max_batch=4, page_size=4,
                                      hbm_pages=27, prefetch_budget=2,
                                      prefill_tokens=8, tenants=2,
                                      dedup=dedup, **kw)
                drive_slots(m, arrivals)
                ttft.setdefault(dedup, set()).add(
                    tuple(r.ttft() for r in m.requests))
    assert len(ttft[False]) == len(ttft[True]) == 1
    assert sum(*ttft[True]) < sum(*ttft[False])


def test_engine_dedup_plumbing_and_validation():
    with pytest.raises(ValueError, match="dedup"):
        make_kv_backend("vec", hbm_pages=8, page_size=4, prefetch_budget=2,
                        dedup=True, **CPU)
    with pytest.raises(ValueError):
        make_kv_backend("nope", hbm_pages=8, page_size=4, prefetch_budget=2,
                        tenants=2, dedup=True, **CPU)
    for kv, cls in (("vec", P.DedupVectorizedPagedKVCache),
                    ("scalar", P.DedupOracle),
                    ("sharded", P.DedupShardedPagedKVCache),
                    ("elastic", P.DedupElasticShardedPagedKVCache)):
        assert type(make_kv_backend(kv, hbm_pages=12, page_size=4,
                                    prefetch_budget=2, tenants=2,
                                    dedup=True, **CPU)) is cls
    states = []
    for eng in (ServingEngine(kv="vec", hbm_pages=12, page_size=4,
                              tenants=2, dedup=True, **CPU),
                RefEngine(kv="vec", hbm_pages=12, page_size=4, tenants=2,
                          dedup=True)):
        ob = Observability() if isinstance(eng, ServingEngine) else \
            ref_obs.Observability()
        eng.pages.obs = ob
        prompt = list(range(12))
        eng.submit(prompt + [50], max_new_tokens=2, tenant=0)
        eng.submit(prompt + [60], max_new_tokens=2, tenant=1)
        eng.submit(prompt + [70], max_new_tokens=2, tenant=0)
        eng.run_until_idle()
        kvc = eng.pages
        assert kvc.stats.dedup_promotions > 0
        assert kvc.namespace.check_isolation(kvc.registry,
                                             pairwise_gcd=True).ok
        states.append((_state(kvc), [tuple(e) for e in ob.trace.events()]))
    assert states[0] == states[1]
    assert EV_DEDUP_HIT in {e[0] for e in states[0][1]}
