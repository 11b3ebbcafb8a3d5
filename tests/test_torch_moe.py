"""The port's MoE expert tier (``repro_torch.serving.expert_cache`` and
``expert_cache_vec``) on the CPU against the reference.

The reference's pinned differential cases (``tests/test_serving_moe.py``)
replay through the port's scalar cache, its vectorized cache under each
discovery backend (``incremental``, ``host``, ``kernel``: the flat mask
and factorization wrappers) and the reference's scalar oracle: per-set
tiers, ``EXPERT_PARITY_COUNTERS``, the prefetch log, the LRU order and
the co-fire table are equal.  Then the regression cases, the engines'
``moe=`` tier against the reference's, and the synthetic router.

The port runs with ``device="cpu"`` (the kernels' plain versions).
"""

import torch_parity  # noqa: F401

import numpy as np
import pytest

from strategies import (ArrivalSpec, ExpertWorkloadSpec, build_expert_sets,
                        build_poisson_arrivals, drive_expert, drive_slots)
from repro.core.engine import successor_table as ref_successor_table
from repro.serving import slots as ref_slots
from repro.serving.engine import ServingEngine as RefEngine
from repro.serving.engine import \
    synthetic_router_groups as ref_synthetic_router_groups
from repro.serving.expert_cache import ExpertCache as RefExpertCache
from repro.serving.expert_cache_vec import \
    VectorizedExpertCache as RefVecExpertCache
from repro_torch.core.engine import successor_table
from repro_torch.core.primes import CacheLevel
from repro_torch.serving import slots
from repro_torch.serving.engine import (ServingEngine, make_expert_backend,
                                        synthetic_router_groups)
from repro_torch.serving.expert_cache import (EXPERT_PARITY_COUNTERS,
                                              ExpertCache)
from repro_torch.serving.expert_cache_vec import VectorizedExpertCache

# the reference's pinned cases (tests/test_serving_moe.py)
_PINNED = [
    (ExpertWorkloadSpec(seed=3, n_experts=24, n_steps=40), 1, 3, 8),
    (ExpertWorkloadSpec(seed=5, n_experts=40, group_size=12,
                        oversize_every=4), 8, 2, 4),
    (ExpertWorkloadSpec(seed=7, n_experts=32, repeat_hot=True,
                        n_groups=4), 4, 4, 8),
    (ExpertWorkloadSpec(seed=9, n_experts=36, disjoint=True,
                        group_size=6), 6, 1, 8),
    (ExpertWorkloadSpec(seed=11, n_experts=16, group_size=9, batch=6),
     2, 4, 8),
]
_IDS = ["hbm1", "overflow", "repeat", "disjoint", "budget"]


def _view(ec):
    return (tuple(getattr(ec.stats, f) for f in EXPERT_PARITY_COUNTERS),
            tuple(ec.prefetch_log), tuple(ec.hbm.items()))


@pytest.mark.parametrize("discover", ["incremental", "host", "kernel"])
@pytest.mark.parametrize("spec,slots_,budget,max_group", _PINNED, ids=_IDS)
def test_pinned_cases_equal_the_reference(spec, slots_, budget, max_group,
                                          discover):
    batches = build_expert_sets(spec)
    kw = dict(hbm_slots=slots_, prefetch_budget=budget, max_group=max_group)
    ref = RefExpertCache(spec.n_experts, **kw)
    oracle = ExpertCache(spec.n_experts, device="cpu", **kw)
    vec = VectorizedExpertCache(spec.n_experts, discover=discover,
                                device="cpu", **kw)
    tiers = [drive_expert(ec, batches) for ec in (ref, oracle, vec)]
    assert tiers[0] == tiers[1] == tiers[2]
    assert _view(ref) == _view(oracle) == _view(vec)
    assert oracle.stats.registry_scans == ref.stats.registry_scans
    assert vec.stats.registry_scans == 0
    if discover != "incremental" and len(vec.registry):
        assert vec.bulk_refreshes > 0


def test_cofire_table_backends_agree_with_the_reference():
    """Incremental rows, a host rebuild, a kernel rebuild (through the
    flat mask and factorization wrappers) and the reference's kernel
    table are the same rows."""
    spec = ExpertWorkloadSpec(seed=5, n_experts=48, group_size=10,
                              oversize_every=3)
    vec = VectorizedExpertCache(48, hbm_slots=8, prefetch_budget=3,
                                device="cpu")
    ref = RefVecExpertCache(48, hbm_slots=8, prefetch_budget=3)
    drive_expert(vec, build_expert_sets(spec))
    drive_expert(ref, build_expert_sets(spec))
    inc = vec.successor_rows()
    experts = range(48)
    host = {k: v for k, v in successor_table(
        vec.registry, vec.assigner, experts, discover="host",
        device="cpu").items() if v}
    kern = {k: v for k, v in successor_table(
        vec.registry, vec.assigner, experts, discover="kernel",
        device="cpu").items() if v}
    want = {k: v for k, v in ref_successor_table(
        ref.registry, ref.assigner, experts, discover="kernel").items() if v}
    assert inc == host == kern == want == ref.successor_rows()
    vec.refresh_tables(discover="kernel")
    assert vec.successor_rows() == inc and vec.bulk_refreshes == 1


def test_kernel_discovery_launches_the_flat_mask_and_factorization(
        monkeypatch):
    """``discover="kernel"`` rebuilds its rows through
    ``divisibility_scan`` and ``factorize_batch_exact`` on the cache's
    device."""
    from repro_torch.kernels import ops

    calls = []
    for name in ("divisibility_scan", "factorize_batch_exact"):
        orig = getattr(ops, name)

        def spy(*a, _orig=orig, _name=name, device="cuda"):
            calls.append((_name, str(device)))
            return _orig(*a, device=device)

        monkeypatch.setattr(ops, name, spy)
    vec = VectorizedExpertCache(32, hbm_slots=4, discover="kernel",
                                device="cpu")
    vec.observe_routing([(0, 1, 2), (2, 3, 4)])
    vec.activate_batch([(0,)])
    assert set(calls) == {("divisibility_scan", "cpu"),
                          ("factorize_batch_exact", "cpu")}


def test_capped_duplicate_groups_register_once():
    ec = ExpertCache(32, hbm_slots=8, max_group=4, device="cpu")
    ec.observe_routing([(0, 1, 2, 3, 9)])
    v = ec.registry.version
    assert ec.observe_routing([(0, 1, 2, 3, 17)]) == []
    assert len(ec.registry) == 1 and ec.registry.version == v
    assert ec.registry.degree(ec.assigner.prime_of(0)) == 1
    vec = VectorizedExpertCache(32, hbm_slots=8, max_group=4, device="cpu")
    vec.observe_routing([(0, 1, 2, 3, 9)])
    rows = vec.successor_rows()
    vec.observe_routing([(0, 1, 2, 3, 17)])
    vec.activate_batch([(0,)])
    assert vec.successor_rows() == rows and vec.bulk_refreshes == 0


def test_chunk_collision_across_distinct_groups_is_skipped():
    ec = ExpertCache(48, hbm_slots=8, max_group=8, device="cpu")
    ec.observe_routing([tuple(range(8))])
    rel = ec.registry.relationship_of_composite(
        ec.registry.composites_array()[0])
    assert len(rel.composites) >= 2
    first = sorted(q for q in rel.primes if rel.composites[0] % q == 0)
    clash = tuple(ec.assigner.data_of(q) for q in first) + (40,)
    before = len(ec.registry)
    assert ec.observe_routing([clash]) == []
    assert len(ec.registry) == before


def test_budget_zero_disables_prefetch_entirely():
    for cls in (ExpertCache, VectorizedExpertCache):
        ec = cls(16, hbm_slots=4, prefetch_budget=0, device="cpu")
        ec.observe_routing([(0, 1, 2, 3)])
        for _ in range(5):
            ec.activate([0, 1, 2, 3])
        assert ec.stats.prefetches == ec.stats.registry_scans == 0
        assert ec.prefetch_log == []


def test_bad_configs_raise():
    with pytest.raises(ValueError):
        ExpertCache(8, hbm_slots=0, device="cpu")
    with pytest.raises(ValueError):
        ExpertCache(0, hbm_slots=4, device="cpu")
    with pytest.raises(ValueError):
        VectorizedExpertCache(8, hbm_slots=4, discover="magic", device="cpu")
    with pytest.raises(ValueError):
        make_expert_backend("magic", moe_experts=8, moe_slots=2,
                            moe_prefetch_budget=1, device="cpu")
    assert make_expert_backend(None, moe_experts=8, moe_slots=2,
                               moe_prefetch_budget=1) is None
    # tenants= is ported: it picks the tenant-partitioned expert cache
    from repro_torch.tenancy import TenantedVectorizedExpertCache

    tenanted = make_expert_backend("vec", moe_experts=8, moe_slots=2,
                                   moe_prefetch_budget=1, tenants=2,
                                   device="cpu")
    assert isinstance(tenanted, TenantedVectorizedExpertCache)
    with pytest.raises(ValueError):
        make_expert_backend("magic", moe_experts=8, moe_slots=2,
                            moe_prefetch_budget=1, tenants=2, device="cpu")


@pytest.mark.parametrize("discover", ["incremental", "kernel"])
def test_out_of_band_prime_drop_forces_a_rebuild(discover):
    def run(ec):
        ec.observe_routing([(0, 1, 2), (2, 3, 4), (5, 6, 7)])
        ec.activate_batch([(0, 2), (5,)])
        ec.assigner.release(2, CacheLevel.L2)
        ec.observe_routing([(8, 9, 10)])
        ec.activate_batch([(0, 2), (8,)])
        return _view(ec)

    ref = run(RefExpertCache(24, hbm_slots=6, prefetch_budget=2))
    vec = VectorizedExpertCache(24, hbm_slots=6, prefetch_budget=2,
                                discover=discover, device="cpu")
    assert run(vec) == ref
    assert run(ExpertCache(24, hbm_slots=6, prefetch_budget=2,
                           device="cpu")) == ref
    assert vec.bulk_refreshes >= 1


# --------------------------------------------------------------------------- #
# the engines' MoE tier                                                       #
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("moe", ["vec", "scalar"])
def test_engine_moe_tier_equals_the_reference(moe):
    kw = dict(max_batch=6, page_size=8, hbm_pages=18, moe=moe,
              moe_experts=48, moe_slots=8, moe_topk=4, moe_groups=12)

    def run(eng):
        rng = np.random.default_rng(1)
        for _ in range(14):
            eng.submit(list(rng.integers(0, 30_000,
                                         size=int(rng.integers(16, 40)))),
                       max_new_tokens=5)
        done = eng.run_until_idle()
        return ([(r.req_id, tuple(r.generated)) for r in done],
                _view(eng.experts), eng.pages.stats.parity_tuple())

    port = ServingEngine(None, None, device="cpu", **kw)
    got = run(port)
    assert got == run(RefEngine(None, None, **kw))
    assert port.experts.stats.hits > 0
    step = port.step()
    assert step == {"live": 0}


@pytest.mark.parametrize("cls", ["SlotMachine", "SlotOracle"])
def test_slot_machine_moe_tier_equals_the_reference(cls):
    arrivals = build_poisson_arrivals(ArrivalSpec(seed=2, n_requests=16,
                                                  rate=1.5, max_new=8))
    kw = dict(max_batch=4, page_size=4, hbm_pages=16, prefill_tokens=12,
              preempt_wait=3, moe="vec", moe_experts=40, moe_slots=6,
              moe_topk=4, moe_groups=10)
    port = getattr(slots, cls)(device="cpu", **kw)
    ref = getattr(ref_slots, cls)(**kw)
    assert drive_slots(port, arrivals) == drive_slots(ref, arrivals)
    assert _view(port.experts) == _view(ref.experts)
    assert port.experts.stats.hits > 0


@pytest.mark.parametrize("experts,topk,groups,seed",
                         [(64, 4, 16, 0), (256, 8, 32, 3), (5, 8, 1, 1)])
def test_synthetic_router_groups_equal_the_reference(experts, topk, groups,
                                                     seed):
    assert synthetic_router_groups(experts, topk, groups, seed) == \
        ref_synthetic_router_groups(experts, topk, groups, seed)
