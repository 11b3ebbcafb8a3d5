"""The port's elastic serving (``repro_torch.serving.elastic``,
``sharding/reshard.py``, ``training/elastic.py``) on the CPU against the
reference.

  * The reference's pinned chaos schedules (``tests/test_elastic.py``) run
    through both packages: the port's elastic cache ends bit-exact with
    the uninterrupted scalar oracle AND with the reference's elastic
    cache — tiers, ``PARITY_COUNTERS``, the LRU order, the host set, the
    prefetch log, every reshard plan (moved positions, destinations,
    bytes) and every recovery report.
  * Recovery by re-factorization: a dead shard's rows rebuilt equal a
    from-scratch table; a registry mutated while a shard was dead forces
    a full re-factorization (mode ``"full"``), as in the reference.
  * Reshard plans move exactly the changed owners; a resize round trip
    restores ownership; the slice index's sync modes.
  * ``ElasticController`` on an injected clock takes the reference's
    events; the copied fleet planner answers as the reference's.
  * ``ServingEngine`` and the slot machines with ``kv="elastic"`` and a
    chaos schedule equal the reference's and the scalar engines'.

The port runs with ``device="cpu"`` (the kernels' plain versions).
"""

import torch_parity  # noqa: F401

import numpy as np
import pytest

from strategies import (ArrivalSpec, ElasticEventSpec, KVWorkloadSpec,
                        apply_elastic_event, apply_kv_ops,
                        build_failure_schedule, build_kv_ops,
                        build_poisson_arrivals, drive_slots)
from repro.serving import slots as ref_slots
from repro.serving.elastic import ElasticController as RefController
from repro.serving.elastic import \
    ElasticShardedPagedKVCache as RefElastic
from repro.serving.engine import ServingEngine as RefEngine
from repro.training import elastic as ref_training
from repro_torch.core.engine import successor_table
from repro_torch.core.engine.shard import PrimeSpacePartition
from repro_torch.serving import slots
from repro_torch.serving.elastic import (ElasticController,
                                         ElasticShardedPagedKVCache)
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.kv_cache import PARITY_COUNTERS, PagedKVCache
from repro_torch.sharding.reshard import CROSS, LOST, ShardSlices
from repro_torch.training import elastic as training
from repro_torch.training.elastic import ManualClock


def _state(kv):
    return (tuple(getattr(kv.stats, f) for f in PARITY_COUNTERS),
            tuple(kv.hbm.items()), frozenset(kv.host),
            tuple(kv.prefetch_log))


def _plans(kv):
    return [(p.n_old, p.n_new, p.total, p.moved, p.dests, p.migrated_bytes,
             p.full_rebuild_bytes) for p in kv.reshard_log]


def _reports(kv):
    return [(r.shard, r.mode, r.refactorized, r.rows_rebuilt, r.pages,
             r.reread_bytes) for r in kv.recovery_log]


def _assert_recovery_invariant(kv) -> None:
    """The last recovery's rebuilt rows equal ``successor_table`` from
    scratch on exactly those pages."""
    if not kv.recovery_log or kv.dead_shards:
        return
    rep = kv.recovery_log[-1]
    fresh = successor_table(kv.registry, kv.assigner, rep.pages,
                            discover="host", device="cpu")
    for d in rep.pages:
        assert [int(x) for x in kv._succ[d, :kv._succ_len[d]]] == \
            fresh.get(d, []), (rep.shard, d)


# the reference's pinned chaos cases (tests/test_elastic.py)
_PINNED = [
    (KVWorkloadSpec(seed=5, n_requests=10, n_touches=100),
     ElasticEventSpec(seed=1, n_events=4, resize=False, defer=True), 4, 2),
    (KVWorkloadSpec(seed=7, n_requests=12, n_touches=120, sweeps=2),
     ElasticEventSpec(seed=2, n_events=6, kill=False), 8, 3),
    (KVWorkloadSpec(seed=11, n_requests=9, n_touches=90, release=True),
     ElasticEventSpec(seed=3, n_events=5, drop=True), 1, 2),
    (KVWorkloadSpec(seed=13, n_requests=10, n_touches=100),
     ElasticEventSpec(seed=4, n_events=4, kill=False, resize=False,
                      drop=True), 4, 2),
]


@pytest.mark.parametrize("spec,espec,hbm,budget", _PINNED,
                         ids=["kill-defer", "resize-storm", "kill+drop",
                              "drop-only"])
def test_chaos_pinned_equals_the_oracle_and_the_reference(spec, espec, hbm,
                                                          budget):
    ops = build_kv_ops(spec)
    schedule = build_failure_schedule(espec, len(ops))

    def event(kv, ev):
        apply_elastic_event(kv, ev)
        if ev[0] == "kill" and not ev[2]:
            assert not kv.dead_shards
            if isinstance(kv, ElasticShardedPagedKVCache):
                _assert_recovery_invariant(kv)
        if ev[0] == "resize":
            assert kv.n_shards == ev[1] and len(kv.shard_stats) == ev[1]

    kw = dict(hbm_pages=hbm, page_size=4, prefetch_budget=budget)
    oracle = PagedKVCache(device="cpu", **kw)
    port = ElasticShardedPagedKVCache(n_shards=2, device="cpu", **kw)
    ref = RefElastic(n_shards=2, **kw)
    tiers = [apply_kv_ops(kv, ops, schedule=schedule,
                          on_event=None if kv is oracle else event)
             for kv in (oracle, port, ref)]
    assert tiers[1] == tiers[0] == tiers[2]
    assert _state(port) == _state(oracle) == _state(ref)
    assert port.stats.registry_scans == 0
    for kv in (port, ref):
        kv._sync_tables()
    assert _plans(port) == _plans(ref)
    assert _reports(port) == _reports(ref)
    assert port.recoveries == ref.recoveries
    assert not port.dead_shards
    _assert_recovery_invariant(port)
    assert (port.aggregate_shard_stats().parity_tuple()
            == port.stats.parity_tuple())
    port.slices.sync(port.registry)
    assert port.slices.verify(port.registry)
    assert port.successor_rows() == ref.successor_rows()


# --------------------------------------------------------------------------- #
# recovery by re-factorization                                                #
# --------------------------------------------------------------------------- #

def _populated(cls, n_shards=2, tokens_per_req=160, n_req=6, **kw):
    kv = cls(hbm_pages=16, page_size=4, prefetch_budget=2,
             n_shards=n_shards, **kw)
    rng = np.random.default_rng(17)
    shared = list(rng.integers(0, 4000, size=24))
    for r in range(n_req):
        tail = list(rng.integers(0, 4000, size=tokens_per_req))
        kv.register_request(r, shared[:int(rng.integers(0, 24))] + tail)
    kv.touch_batch([(0, j) for j in range(8)])
    return kv


def _port(**kw):
    return _populated(ElasticShardedPagedKVCache, device="cpu", **kw)


def test_recovery_rebuilds_exactly_the_dead_shards_rows():
    """Kill each shard in turn: its rows are wiped, rebuilt equal to a
    from-scratch table, and each report equals the reference's."""
    kv, ref = _port(), _populated(RefElastic)
    baseline = kv.successor_rows()
    assert baseline == ref.successor_rows()
    for s in range(kv.n_shards):
        dead = set(kv._owned_pages(s))
        assert dead and kv.fail_shard(s) == ref.fail_shard(s) > 0
        assert all(kv._succ_len[d] == 0 for d in dead)
        rep = kv.recover_shard(s)
        ref.recover_shard(s)
        assert rep.mode == "partial" and set(rep.pages) <= dead
        _assert_recovery_invariant(kv)
        assert kv.successor_rows() == baseline
        assert kv.slices.verify(kv.registry)
    assert _reports(kv) == _reports(ref)


def test_recovery_after_registry_mutation_refactorizes_everything():
    """A registry mutated while a shard is dead forces mode ``"full"``:
    every composite is re-factorized, and the table equals a
    from-scratch one and the reference's."""
    kv, ref = _port(), _populated(RefElastic)
    for c in (kv, ref):
        c.fail_shard(0)
        c.register_request(99, list(range(5000, 5080)))
        c.touch(99, 0)                               # failover on demand
    assert not kv.dead_shards
    rep = kv.recovery_log[-1]
    assert rep.mode == "full"
    assert rep.refactorized == kv.registry.composites_array().size
    assert _reports(kv) == _reports(ref)
    fresh = successor_table(kv.registry, kv.assigner, range(kv._next_page),
                            discover="host", device="cpu")
    assert kv.successor_rows() == {d: r for d, r in fresh.items() if r}
    assert kv.successor_rows() == ref.successor_rows()


def test_recovery_refactorizes_through_the_kernel_wrapper(monkeypatch):
    """Recovery decodes the lost composites through
    ``factorize_batch_exact`` on the cache's device."""
    from repro_torch.kernels import ops

    seen = []
    orig = ops.factorize_batch_exact

    def spy(comps, pool, device="cuda"):
        seen.append((len(list(comps)), str(device)))
        return orig(comps, pool, device=device)

    monkeypatch.setattr(ops, "factorize_batch_exact", spy)
    kv = _port()
    lost = kv.fail_shard(1)
    kv.recover_shard(1)
    assert (lost, "cpu") in seen


def test_fail_shard_validates_and_is_idempotent():
    kv = _port()
    with pytest.raises(ValueError):
        kv.fail_shard(5)
    with pytest.raises(ValueError):
        kv.recover_shard(0)
    kv.fail_shard(1)
    assert kv.fail_shard(1) == 0
    kv.recover_shard(1)


# --------------------------------------------------------------------------- #
# reshard plans and the slice index                                           #
# --------------------------------------------------------------------------- #

def test_reshard_plan_moves_exactly_the_changed_owners():
    kv, ref = _port(tokens_per_req=400), _populated(RefElastic,
                                                    tokens_per_req=400)
    kv.slices.sync(kv.registry)
    before = np.array(kv.slices._owner, copy=True)
    plan = kv.resize(4)
    ref.resize(4)
    assert set(plan.moved) == set(
        int(p) for p in np.nonzero(before != kv.slices._owner)[0])
    assert plan.moved and 0 < plan.migrated_bytes < plan.full_rebuild_bytes
    assert plan.describe() == ref.reshard_log[-1].describe()
    assert _plans(kv) == _plans(ref)
    assert kv.slices.verify(kv.registry)


def test_resize_round_trip_restores_ownership_and_keeps_rows():
    kv = _port(tokens_per_req=400)
    kv.slices.sync(kv.registry)
    rows = kv.successor_rows()
    own2 = np.array(kv.slices._owner, copy=True)
    up = kv.resize(4)
    assert kv.n_shards == 4 and kv.successor_rows() == rows
    down = kv.resize(2)
    assert np.array_equal(kv.slices._owner, own2)
    assert set(down.moved) == set(up.moved)
    assert (kv.aggregate_shard_stats().parity_tuple()
            == kv.stats.parity_tuple())


def test_resize_takes_no_explicit_mesh():
    """One card runs the shards as a loop: an explicit mesh raises,
    naming the ROADMAP item that ports it."""
    kv = _port()
    with pytest.raises(NotImplementedError, match="ROADMAP.md A.8"):
        kv.resize(4, mesh=object())
    assert kv.resize(4, mesh=None).n_new == 4 and kv.mesh is None


def test_restripe_refuses_with_a_dead_shard():
    kv = _port()
    kv.slices.sync(kv.registry)
    kv.slices.forget_shard(0)
    with pytest.raises(RuntimeError):
        kv.slices.restripe(PrimeSpacePartition(4))


def test_shard_slices_sync_modes_and_owners_equal_the_reference():
    from repro.sharding.reshard import ShardSlices as RefSlices

    kv, ref = _port(), _populated(RefElastic)
    sl, rsl = ShardSlices(kv.partition), RefSlices(ref.partition)
    assert sl.sync(kv.registry) == rsl.sync(ref.registry) == "append"
    assert sl.sync(kv.registry) == "noop"
    for c in (kv, ref):
        c.register_request(50, list(range(7000, 7040)))
    assert sl.sync(kv.registry) == rsl.sync(ref.registry) == "append"
    for c in (kv, ref):
        c.registry.drop_prime(int(c.registry.primes_array()[0]))
    assert sl.sync(kv.registry) == rsl.sync(ref.registry) == "rebuild"
    assert sl.verify(kv.registry)
    assert np.array_equal(sl._owner, rsl._owner) and sl._primes == rsl._primes
    assert sl.local() == rsl.local() and sl.cross() == rsl.cross()
    assert set(np.unique(sl._owner)) <= set(range(kv.n_shards)) | {CROSS}
    assert LOST not in sl._owner


# --------------------------------------------------------------------------- #
# the fleet controller on an injected clock                                   #
# --------------------------------------------------------------------------- #

def _events(events):
    return [(e["kind"], e.get("node"), e.get("shard"),
             e["report"].refactorized if e.get("report") else None,
             e["reshard"].moved if "reshard" in e else None)
            for e in events]


def test_controller_heartbeat_expiry_equals_the_reference():
    """Two silent nodes are recovered and the fleet resized down, a
    rejoin resizes back up: the events equal the reference's."""
    out = []
    for ctl_cls, cache, clk in (
            (ElasticController, _port(n_shards=4), ManualClock()),
            (RefController, _populated(RefElastic, n_shards=4),
             ref_training.ManualClock())):
        ctl = ctl_cls(cache, clock=clk, heartbeat_timeout_s=10.0)
        clk.advance(5.0)
        ctl.heartbeat()
        steps = [ctl.tick()]
        clk.advance(11.0)
        ctl.heartbeat(0)
        ctl.heartbeat(1)
        steps.append(ctl.tick())
        ctl.join(2)
        steps.append(ctl.tick())
        ctl.join(3)
        steps.append(ctl.tick())
        out.append(([_events(s) for s in steps], cache.n_shards,
                    ctl.fleet.healthy_nodes))
    assert out[0] == out[1]
    steps, n_shards, healthy = out[0]
    assert [k for k, *_ in steps[1]].count("recover") == 2
    assert steps[3][0][0] == "resize" and n_shards == 4


def test_controller_straggler_eviction_equals_the_reference():
    out = []
    for ctl_cls, cache, clk in (
            (ElasticController, _port(n_shards=4), ManualClock()),
            (RefController, _populated(RefElastic, n_shards=4),
             ref_training.ManualClock())):
        ctl = ctl_cls(cache, clock=clk, heartbeat_timeout_s=1e9,
                      straggler_threshold=1.5, evict_after=3)
        events = []
        for step in range(16):
            clk.advance(1.0)
            for n in (0, 1, 2):
                ctl.monitor.tick(n)
            if step % 4 == 3:
                ctl.monitor.tick(3)
            ctl.heartbeat()
            events.append(_events(ctl.tick()))
        out.append((events, cache.n_shards, sorted(ctl.fleet.healthy_nodes),
                    sorted(cache.dead_shards)))
    assert out[0] == out[1]
    assert 3 not in out[0][2] and out[0][1] == 2 and out[0][3] == []


@pytest.mark.parametrize("healthy", range(1, 10))
def test_fleet_planner_equals_the_reference(healthy):
    """The copied planner picks the reference's mesh for each healthy
    count (the shard ladder the controller resizes along)."""
    got = training.ElasticPlanner(model_axis=1, base_data_axis=4,
                                  base_pods=1, global_batch=4).plan(healthy)
    want = ref_training.ElasticPlanner(model_axis=1, base_data_axis=4,
                                       base_pods=1,
                                       global_batch=4).plan(healthy)
    assert vars(got) == vars(want)


# --------------------------------------------------------------------------- #
# the engines with kv="elastic"                                               #
# --------------------------------------------------------------------------- #

def _engine_workload(eng, elastic: bool):
    rng = np.random.default_rng(3)
    shared = list(rng.integers(0, 3000, size=48))
    for _ in range(20):
        tail = list(rng.integers(0, 3000, size=int(rng.integers(8, 32))))
        eng.submit(shared[:int(rng.integers(0, 48))] + tail,
                   max_new_tokens=4)
    done, step = [], 0
    while eng.queue or any(s is not None for s in eng.slots):
        if elastic and step == 2:
            eng.resize(4)
        if elastic and step == 4:
            assert eng.fail_shard(1) is not None
        if elastic and step == 6:
            eng.fail_shard(0, recover=False)
            eng.resize(2)
        before = list(eng.slots)
        eng.step()
        done.extend(s for s in before if s is not None and s.state == "done")
        step += 1
    return [(r.req_id, tuple(r.generated))
            for r in sorted(done, key=lambda r: r.req_id)]


def test_engine_elastic_hooks_equal_the_scalar_engine_and_the_reference():
    kw = dict(max_batch=8, page_size=8, hbm_pages=24, reread_window=2,
              shards=2)
    port = ServingEngine(None, None, kv="elastic", device="cpu", **kw)
    scalar = ServingEngine(None, None, kv="scalar", device="cpu", **kw)
    ref = RefEngine(None, None, kv="elastic", **kw)
    gen = [_engine_workload(port, True), _engine_workload(scalar, False),
           _engine_workload(ref, True)]
    assert gen[0] == gen[1] == gen[2]
    assert _state(port.pages) == _state(scalar.pages) == _state(ref.pages)
    assert _plans(port.pages) == _plans(ref.pages)
    assert _reports(port.pages) == _reports(ref.pages)
    assert port.pages.recoveries >= 2
    with pytest.raises(ValueError):
        scalar.resize(4)
    with pytest.raises(ValueError):
        scalar.fail_shard(0)


@pytest.mark.parametrize("cls", ["SlotMachine", "SlotOracle"])
def test_slot_machines_under_chaos_equal_the_reference(cls):
    """A slot machine with ``kv="elastic"`` under a kill / resize
    schedule keeps the tier log of the uninterrupted ``kv="vec"`` run,
    and its plans and recoveries equal the reference machine's."""
    from repro_torch.obs import Observability, trace_diff
    from repro import obs as ref_obs

    arrivals = build_poisson_arrivals(ArrivalSpec(seed=9, n_requests=24,
                                                  rate=1.5, max_prompt=30,
                                                  shared_pool=12))
    schedule = build_failure_schedule(ElasticEventSpec(seed=6, n_events=8),
                                      40)
    cfg = dict(max_batch=4, page_size=4, hbm_pages=16, prefetch_budget=2,
               reread_window=2, prefill_tokens=12, preempt_wait=3)
    port_obs, ref_o = Observability(), ref_obs.Observability()
    port = getattr(slots, cls)(kv="elastic", obs=port_obs, device="cpu",
                               **cfg)
    vec = getattr(slots, cls)(kv="vec", device="cpu", **cfg)
    ref = getattr(ref_slots, cls)(kv="elastic", obs=ref_o, **cfg)
    logs = [drive_slots(port, arrivals, schedule=schedule),
            drive_slots(vec, arrivals),
            drive_slots(ref, arrivals, schedule=schedule)]
    assert logs[0] == logs[1] == logs[2]
    assert _plans(port.pages) and _plans(port.pages) == _plans(ref.pages)
    assert _reports(port.pages) == _reports(ref.pages)
    assert trace_diff(port_obs.trace, ref_o.trace) is None
    with pytest.raises(ValueError):
        vec.resize(4)
