"""The port's Table-1 engine on the CPU (the step functions run as a Python
loop, ``device="cpu"``) against the reference's scalar oracles, and the
host modules it brings (``policies``, ``metrics``, ``semantic``,
``simulator``) against the reference's.

Every counter is compared exactly: per-level hits, misses, demand
accesses and the three prefetch counters.  The traces are the reference
suite's own builders (``tests/strategies.py``), made by the reference and
handed to the port as plain arrays.  ``tests/test_torch_engine_ref.py``
holds the same engine against the reference's JAX engine and its final
states."""

from torch_parity import chip_smoke

import numpy as np
import pytest
import torch

from strategies import adversarial_trace, trace_zoo
import repro.core as R
from repro.core.engine import pfcs_tables as ref_pfcs_tables
from repro_torch.core import (Trace, derive_table1_row, fast_lru_hit_rate,
                              make_policy, run_all_systems,
                              simulate_baseline, simulate_pfcs,
                              simulate_semantic)
from repro_torch.core.engine import (VECTORIZED_SYSTEMS, PFCSTables,
                                     pfcs_tables, simulate_batch,
                                     simulate_trace, sweep)
from repro_torch.core.engine.hierarchy import build_hierarchy
from repro_torch.core.engine.pfcs_vec import build_pfcs
from repro_torch.kernels import engine as kengine

CAPS = (("L1", 8), ("L2", 24), ("L3", 64))
#: trace length of the covering set (the reference suite's is 1200)
T = 600
POLICIES = ["lru", "fifo", "2q", "arc", "lirs"]
COUNTERS = ("hits_per_level", "misses", "demand_accesses",
            "prefetches_issued", "prefetches_used", "prefetches_true",
            "extra_backing_fetches")


def port(tr) -> Trace:
    """The reference's trace as the port's, from its plain arrays."""
    return Trace(name=tr.name, accesses=np.asarray(tr.accesses),
                 relationships=[tuple(g) for g in tr.relationships],
                 n_keys=tr.n_keys, meta=dict(tr.meta))


def assert_same(a, b, *, factor_ops=False):
    for field in COUNTERS:
        assert getattr(a, field) == getattr(b, field), field
    assert a.name == b.name and a.hit_rate == b.hit_rate
    if factor_ops:
        assert a.factor_ops == b.factor_ops


def pfcs_traces(length=T):
    return [R.db_join_trace(n_orders=150, n_customers=40, n_items=80,
                            n_queries=length, seed=3),
            R.graph_walk_trace(n_keys=300, relationship_density=0.7,
                               n_accesses=length, seed=4),
            R.zipf_trace(n_keys=400, n_accesses=length, seed=5)]


# --------------------------------------------------------------------------- #
# the engine against the scalar oracles                                       #
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("policy", POLICIES)
def test_baseline_equals_reference_oracle(policy):
    """The covering set in one batch; each trace's counters equal the
    reference's ``simulate_baseline`` and the port's own."""
    zoo = trace_zoo(T)
    got = simulate_batch([port(tr) for tr in zoo], policy, CAPS,
                         device="cpu")
    for tr, st in zip(zoo, got):
        assert_same(R.simulate_baseline(policy, tr, CAPS), st)
        assert_same(simulate_baseline(policy, port(tr), CAPS), st)


def test_pfcs_equals_reference_oracle():
    """PFCS with host discovery reproduces the oracle's counters and its
    factorization stage mix."""
    trs = pfcs_traces()
    got = simulate_batch([port(tr) for tr in trs], "pfcs", CAPS,
                         device="cpu")
    for tr, st in zip(trs, got):
        assert_same(R.simulate_pfcs(tr, CAPS), st, factor_ops=True)
        assert_same(simulate_pfcs(port(tr), CAPS), st, factor_ops=True)


@pytest.mark.parametrize("caps", [
    (("L1", 3), ("L2", 29), ("L3", 7)),     # unequal, non-monotone tiers
    (("ONLY", 16),),                        # a single level
], ids=["unequal-tiers", "single-level"])
@pytest.mark.parametrize("policy", POLICIES + ["pfcs"])
def test_tier_attribution_matches_oracle(policy, caps):
    """The shadow-rank tier attribution (and PFCS's levels) at tier sizes
    that are not ascending, and with one level."""
    total = sum(c for _, c in caps)
    trs = [R.zipf_trace(n_keys=200, n_accesses=500, seed=11),
           adversarial_trace(length=500, capacity=total, seed=3)]
    got = simulate_batch([port(tr) for tr in trs], policy, caps,
                         device="cpu")
    for tr, st in zip(trs, got):
        want = (R.simulate_pfcs(tr, caps) if policy == "pfcs"
                else R.simulate_baseline(policy, tr, caps))
        assert_same(want, st)


@pytest.mark.parametrize("kw", [
    dict(prefetch_budget=2, victim_window=1),
    dict(enable_prefetch=False),
    dict(prefetch_trigger="always", prefetch_budget=8),
    dict(victim_window=100),                # wider than every level's C+1
], ids=["budget2-window1", "no-prefetch", "always-budget8", "window100"])
def test_pfcs_variant_flags_match_oracle(kw):
    tr = R.graph_walk_trace(n_keys=300, relationship_density=0.5,
                            n_accesses=T, seed=6)
    assert_same(R.simulate_pfcs(tr, CAPS, **kw),
                simulate_trace(port(tr), "pfcs", CAPS, device="cpu", **kw))


@pytest.mark.parametrize("system", VECTORIZED_SYSTEMS)
def test_ragged_batch_equals_single_traces(system):
    """Shorter traces are padded with no-op steps: each trace of a ragged
    batch gives what it gives alone, and its own demand count."""
    trs = [port(R.zipf_trace(n_keys=300, n_accesses=n, seed=s))
           for s, n in ((0, 450), (1, 600), (2, 250))]
    batch = simulate_batch(trs, system, CAPS, device="cpu")
    assert len(batch) == len(trs)
    for tr, st in zip(trs, batch):
        assert st.demand_accesses == tr.length
        assert_same(simulate_trace(tr, system, CAPS, device="cpu"), st)


@pytest.mark.parametrize("policy", POLICIES)
def test_twoq_and_every_policy_at_capacity_one(policy):
    """One slot in all: 2Q holds two keys (its clamp of kin and km to at
    least 1 each, as the reference does), and the engine equals the
    reference's oracle there too."""
    caps = (("ONE", 1),)
    keys = [0, 1, 0, 2, 1, 1, 3, 0, 2, 2, 0, 1]
    tr = R.Trace(name="cap1", accesses=np.asarray(keys * 5),
                 relationships=[], n_keys=4)
    assert_same(R.simulate_baseline(policy, tr, caps),
                simulate_trace(port(tr), policy, caps, device="cpu"))
    ref, mine = R.make_policy(policy, 1), make_policy(policy, 1)
    for k in [0, 1, 0]:
        assert ref.access(k) == mine.access(k)
    assert len(mine) == len(ref) == (2 if policy == "2q" else 1)


def test_engine_checks_its_inputs(monkeypatch):
    tr = port(R.zipf_trace(n_keys=100, n_accesses=200, seed=0))
    with pytest.raises(ValueError, match="cannot simulate"):
        simulate_trace(tr, "semantic", CAPS, device="cpu")
    # the scans' stamp guard, its limit cut to this trace: 4 ticks an
    # access for a baseline, 3 levels + budget 4 for PFCS
    monkeypatch.setattr(kengine, "STAMP_SPACE", 4 * tr.length)
    with pytest.raises(ValueError, match="int32 stamp space"):
        simulate_trace(tr, "lru", CAPS, device="cpu")
    with pytest.raises(ValueError, match="int32 stamp space"):
        simulate_trace(tr, "pfcs", CAPS, device="cpu")
    # (fast_lru_hit_rate runs such a trace in segments)
    assert (fast_lru_hit_rate(tr.accesses, 8, device="cpu")
            == R.fast_lru_hit_rate(tr.accesses, 8))
    monkeypatch.setattr(kengine, "STAMP_SPACE", 7 * tr.length + 1)
    assert simulate_trace(tr, "pfcs", CAPS, device="cpu").demand_accesses \
        == tr.length
    monkeypatch.undo()
    small = pfcs_tables(tr, CAPS, n_keys=50, device="cpu")
    with pytest.raises(ValueError, match="rebuild with n_keys"):
        simulate_trace(tr, "pfcs", CAPS, tables=small, device="cpu")
    tb = pfcs_tables(tr, CAPS, prefetch_budget=2, device="cpu")
    with pytest.raises(ValueError, match="matching prefetch_budget"):
        simulate_trace(tr, "pfcs", CAPS, tables=tb, device="cpu")
    other = pfcs_tables(tr, CAPS, n_keys=150, device="cpu")
    with pytest.raises(ValueError, match="disagree"):
        simulate_batch([tr, tr], "pfcs", CAPS, tables=[tb, other],
                       device="cpu")


def test_sweep_runs_every_cell():
    trs = [port(tr) for tr in trace_zoo(300)[:2]]
    cfgs = [CAPS, (("L1", 4), ("L2", 12))]
    out = sweep(trs, ["lru", "arc"], cfgs, device="cpu")
    assert sorted(out) == [("arc", 0), ("arc", 1), ("lru", 0), ("lru", 1)]
    for (system, ci), stats in out.items():
        for tr, st in zip(trs, stats):
            assert_same(simulate_baseline(system, tr, cfgs[ci]), st)


# --------------------------------------------------------------------------- #
# discovery tables                                                            #
# --------------------------------------------------------------------------- #

def test_tables_equal_reference_arrays():
    """The host and kernel backends (the flat kernels' plain versions on
    the CPU) build the reference's arrays, and the engine gives the same
    counters on the port's own tables and on the reference's arrays."""
    ref_tr = R.db_join_trace(n_orders=150, n_customers=40, n_items=80,
                             n_queries=T, seed=8)
    tr = port(ref_tr)
    ref_host = ref_pfcs_tables(ref_tr, CAPS, discover="host")
    host = pfcs_tables(tr, CAPS, discover="host", device="cpu")
    kern = pfcs_tables(tr, CAPS, discover="kernel", device="cpu")
    for tb in (host, kern):
        np.testing.assert_array_equal(tb.targets, ref_host.targets)
        np.testing.assert_array_equal(tb.truth, ref_host.truth)
        np.testing.assert_array_equal(tb.degree, ref_host.degree)
    assert host.factor_ops == ref_host.factor_ops
    from_arrays = PFCSTables(ref_host.targets, ref_host.truth,
                             ref_host.degree, dict(ref_host.factor_ops),
                             None)
    want = R.simulate_pfcs(ref_tr, CAPS)
    for tb in (host, kern, from_arrays):
        st = simulate_trace(tr, "pfcs", CAPS, tables=tb, device="cpu")
        assert_same(want, st)


def test_kernel_discovery_counts_like_the_reference():
    """``discover="kernel"`` charges the reference's stage mix for the
    kernel path (trial per decoded composite, cache per further hit)."""
    pytest.importorskip("jax")
    ref_tr = R.graph_walk_trace(n_keys=120, relationship_density=0.8,
                                n_accesses=300, seed=9)
    ref = ref_pfcs_tables(ref_tr, CAPS, discover="kernel")
    mine = pfcs_tables(port(ref_tr), CAPS, discover="kernel", device="cpu")
    np.testing.assert_array_equal(mine.targets, ref.targets)
    assert mine.factor_ops == ref.factor_ops


# --------------------------------------------------------------------------- #
# the state layouts the kernels share with the step functions                #
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("policy", POLICIES)
def test_baseline_layout_is_the_step_state(policy):
    """The kernel's scratch layout names every array of the step
    functions' state, in the order the kernel writes them, with its
    length (ARC's float64 p is the kernel's separate output)."""
    caps = [8, 24, 64]
    state, _ = build_hierarchy(policy, [(str(i), c) for i, c in
                                        enumerate(caps)], 50, 2, "cpu")
    want = [(path, t.shape[1] if t.dim() > 1 else 1)
            for path, t in chip_smoke().state_leaves(state) if path != ("pol", "p")]
    got = kengine.baseline_layout(policy, sum(caps), 50)
    assert sorted(got) == sorted(want)
    assert got[:2] == [(("shk",), 96), (("sht",), 96)]


def test_pfcs_layout_is_the_step_state():
    state, _, _ = build_pfcs([("a", 3), ("b", 5)], 40, 4, 8, True, False, 2,
                             "cpu")
    want = [(path, t.shape[1]) for path, t in chip_smoke().state_leaves(
        {"levels": state["levels"], "where": state["where"]})]
    assert kengine.pfcs_layout([3, 5], 40) == want


@pytest.mark.parametrize("scan", ["baseline", "pfcs"])
def test_scans_refuse_traces_past_the_int32_stamps(scan):
    """At the real limit, on a (1, T) view of one key that holds no
    trace: 2**29 accesses of 4 ticks (a baseline) or 2**31 / 7 of 3
    levels + budget 4 (PFCS) are refused for every caller; one access
    fewer passes the guard and stops at the next check."""
    def run(length):
        acc = torch.zeros((1, 1), dtype=torch.int32).expand(1, length)
        if scan == "baseline":
            return kengine.baseline_scan(acc, "lru", [8, 24, 64], 1)
        tables = (torch.zeros((1, 1, 4), dtype=torch.int32),
                  torch.zeros((1, 1, 4), dtype=torch.bool),
                  torch.zeros((1, 1), dtype=torch.int32))
        return kengine.pfcs_scan(acc, [8, 24, 64], 1, 4, 8, True, False,
                                 *tables)

    limit = 2**29 if scan == "baseline" else -(-2**31 // 7)
    with pytest.raises(ValueError, match="int32 stamp space"):
        run(limit)
    with pytest.raises(ValueError, match="contiguous"):
        run(limit - 1)


def test_scan_wrappers_check_their_inputs():
    acc = torch.tensor([[0, 1, 2, -1]], dtype=torch.int32)
    out = kengine.baseline_scan(acc, "lru", [2], 3)
    assert out["visits"] is None and out["demand"].tolist() == [3]
    with pytest.raises(TypeError):
        kengine.baseline_scan(acc.long(), "lru", [2], 3)
    with pytest.raises(ValueError, match="key universe"):
        kengine.baseline_scan(acc, "lru", [2], 2)
    with pytest.raises(ValueError, match="levels"):
        kengine.baseline_scan(acc, "lru", [2] * 9, 3)
    with pytest.raises(ValueError, match="unknown policy"):
        kengine.baseline_scan(acc, "mru", [2], 3)
    tgt = torch.full((1, 3, 2), -1, dtype=torch.int32)
    truth = torch.zeros((1, 3, 2), dtype=torch.bool)
    deg = torch.zeros((1, 3), dtype=torch.int32)
    out = kengine.pfcs_scan(acc, [2], 3, 2, 8, True, False, tgt, truth, deg)
    assert out["miss"].tolist() == [3]
    with pytest.raises(ValueError, match="do not fit"):
        kengine.pfcs_scan(acc, [2], 3, 3, 8, True, False, tgt, truth, deg)
    with pytest.raises(ValueError, match="outside the key universe"):
        kengine.pfcs_scan(acc, [2], 3, 2, 8, True, False, tgt + 4, truth,
                          deg)
    with pytest.raises(TypeError):
        kengine.pfcs_scan(acc, [2], 3, 2, 8, True, False, tgt, truth.int(),
                          deg)


# --------------------------------------------------------------------------- #
# the host modules                                                            #
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("policy", POLICIES)
def test_policies_equal_reference(policy):
    """Each scalar policy answers every access, membership and length as
    the reference's, prefetch-style inserts included."""
    rng = np.random.default_rng(7)
    ref, mine = R.make_policy(policy, 12), make_policy(policy, 12)
    for step, k in enumerate(rng.integers(0, 40, size=800).tolist()):
        if step % 7 == 3:
            ref.insert(k)
            mine.insert(k)
        else:
            assert ref.access(k) == mine.access(k)
        assert ref.contains(k) == mine.contains(k)
        assert len(ref) == len(mine)


def test_semantic_and_table1_rows_equal_reference():
    """``simulate_semantic`` with the same seed, and ``derive_table1_row``
    of every system against LRU, give the reference's numbers."""
    ref_tr = R.db_join_trace(n_orders=150, n_customers=40, n_items=80,
                             n_queries=T, seed=12)
    tr = port(ref_tr)
    ref_sem = R.simulate_semantic(ref_tr, CAPS, seed=3)
    sem = simulate_semantic(tr, CAPS, seed=3)
    assert_same(ref_sem, sem)
    assert sem.embedding_ops == ref_sem.embedding_ops
    ref_lru = R.simulate_baseline("lru", ref_tr, CAPS)
    lru = simulate_trace(tr, "lru", CAPS, device="cpu")
    pfcs = simulate_trace(tr, "pfcs", CAPS, device="cpu")
    ref_pfcs = R.simulate_pfcs(ref_tr, CAPS)
    for ref_st, st in ((ref_lru, lru), (ref_sem, sem), (ref_pfcs, pfcs)):
        assert derive_table1_row(st, lru) == R.derive_table1_row(ref_st,
                                                                 ref_lru)
        assert st.as_dict() == ref_st.as_dict()


def test_run_all_systems_backends_agree():
    tr = port(R.db_join_trace(n_orders=150, n_customers=40, n_items=80,
                              n_queries=T, seed=7))
    auto = run_all_systems(tr, CAPS, systems=("lru", "pfcs"), device="cpu")
    scal = run_all_systems(tr, CAPS, systems=("lru", "pfcs"),
                           engine="scalar")
    for s in ("lru", "pfcs"):
        assert_same(auto[s], scal[s])
    with pytest.raises(ValueError):
        run_all_systems(tr, CAPS, systems=("semantic",), engine="vectorized",
                        device="cpu")


def test_fast_lru_hit_rate_equals_reference():
    """The engine's LRU path gives the reference's jitted LRU hit rate."""
    pytest.importorskip("jax")
    acc = R.zipf_trace(n_keys=300, n_accesses=T, seed=2).accesses
    for cap in (1, 16, 64):
        assert (fast_lru_hit_rate(acc, cap, device="cpu")
                == R.fast_lru_hit_rate(acc, cap))
    assert fast_lru_hit_rate(np.zeros(0, dtype=np.int64), 4,
                             device="cpu") == 0.0


@pytest.mark.parametrize("cap", [1, 7, 32])
def test_fast_lru_hit_rate_on_any_int32_key(cap):
    """Keys down to -2**31 and up to 2**31 - 1 (all but -1), relabelled
    densely on the host: the reference's hit rate."""
    rng = np.random.default_rng(cap)
    pool = np.concatenate([[-2**31, -2**31 + 1, -2, 0, 2**31 - 1],
                           rng.integers(-2**31, 2**31 - 1, size=40)])
    pool = pool[pool != -1]
    acc = pool[rng.zipf(1.3, size=500) % len(pool)].astype(np.int64)
    assert (fast_lru_hit_rate(acc, cap, device="cpu")
            == R.fast_lru_hit_rate(acc, cap))


def test_fast_lru_hit_rate_refuses_the_empty_marker():
    """-1 marks an empty slot in the reference's scan, where a -1 access
    hits every empty slot; the port refuses it and says why."""
    with pytest.raises(ValueError, match="empty slot"):
        fast_lru_hit_rate(np.array([3, -1, 3]), 2, device="cpu")


@pytest.mark.parametrize("cap", [1, 5, 12])
def test_fast_lru_hit_rate_in_segments(cap, monkeypatch):
    """Past the stamp space the trace runs in segments, the LRU's keys and
    order carried from one to the next: the reference's hit rate (the
    stamp space cut to 4 x 40 ticks, so that 600 accesses take 17 to 22
    segments)."""
    monkeypatch.setattr(kengine, "STAMP_SPACE", 4 * 40)
    acc = R.zipf_trace(n_keys=60, n_accesses=600, seed=cap).accesses
    acc = acc.astype(np.int64) * 7919 - 2**30     # sparse, negative keys
    assert (fast_lru_hit_rate(acc, cap, device="cpu")
            == R.fast_lru_hit_rate(acc, cap))
    calls = []
    orig = kengine.baseline_scan

    def counted(*a, **kw):
        calls.append(a[0].shape[1])
        return orig(*a, **kw)

    monkeypatch.setattr(kengine, "baseline_scan", counted)
    fast_lru_hit_rate(acc, cap, device="cpu")
    assert len(calls) > 1 and max(calls) <= 39
