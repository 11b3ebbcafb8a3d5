"""The port's Table-1 engine (plain version, ``device="cpu"``) against the
reference's JAX engine (``repro.core.engine``): its counters at one shape
per system, the PFCS counters on the reference's own discovery tables
handed over as plain arrays, and the final state after a trace, array by
array (keys, stamps, ARC's float64 ``p`` bit for bit, LIRS's per-key
arrays, PFCS's levels and residency index)."""

from torch_parity import chip_smoke

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import enable_x64

from strategies import adversarial_trace
import repro.core as R
from repro.core.engine import pfcs_tables as ref_pfcs_tables
from repro.core.engine import simulate_trace as ref_simulate_trace
from repro.core.engine.hierarchy import build_hierarchy as ref_hierarchy
from repro.core.engine.pfcs_vec import build_pfcs as ref_build_pfcs
from repro_torch.core import Trace
from repro_torch.core.engine import PFCSTables, simulate_trace
from repro_torch.kernels.engine import baseline_scan, pfcs_scan

CAPS = (("L1", 8), ("L2", 24), ("L3", 64))
T = 400
POLICIES = ["lru", "fifo", "2q", "arc", "lirs"]


def port(tr) -> Trace:
    return Trace(name=tr.name, accesses=np.asarray(tr.accesses),
                 relationships=[tuple(g) for g in tr.relationships],
                 n_keys=tr.n_keys, meta=dict(tr.meta))


def counters(st):
    return (st.hits_per_level, st.misses, st.demand_accesses,
            st.prefetches_issued, st.prefetches_used, st.prefetches_true)


def assert_state_equal(ref, mine, path=""):
    """Every array of the reference's final state equals the port's (one
    batch row), floats by their bits."""
    if isinstance(ref, dict):
        assert sorted(ref) == sorted(mine), path
        for k in ref:
            assert_state_equal(ref[k], mine[k], f"{path}/{k}")
    elif isinstance(ref, tuple):
        for i, (a, b) in enumerate(zip(ref, mine)):
            assert_state_equal(a, b, f"{path}/{i}")
    else:
        a = np.asarray(ref)
        b = mine[0].numpy() if mine.dim() else mine.numpy()
        if a.dtype == np.float64:
            np.testing.assert_array_equal(a.view(np.int64),
                                          b.view(np.int64), err_msg=path)
        else:
            np.testing.assert_array_equal(a.astype(np.int64),
                                          b.astype(np.int64), err_msg=path)


@pytest.mark.parametrize("system", POLICIES + ["pfcs"])
def test_engine_equals_reference_engine(system):
    tr = (R.db_join_trace(n_orders=150, n_customers=40, n_items=80,
                          n_queries=T, seed=2) if system == "pfcs"
          else R.zipf_trace(n_keys=400, n_accesses=T, seed=1))
    want = ref_simulate_trace(tr, system, CAPS)
    got = simulate_trace(port(tr), system, CAPS, device="cpu")
    assert counters(got) == counters(want)
    assert got.factor_ops == want.factor_ops


def test_engine_on_reference_tables():
    """The reference's discovery tables, handed over as plain arrays, give
    the reference engine's counters on the port's engine."""
    tr = R.graph_walk_trace(n_keys=300, relationship_density=0.7,
                            n_accesses=T, seed=4)
    tb = ref_pfcs_tables(tr, CAPS, prefetch_budget=3)
    mine = PFCSTables(np.asarray(tb.targets), np.asarray(tb.truth),
                      np.asarray(tb.degree), dict(tb.factor_ops), None)
    want = ref_simulate_trace(tr, "pfcs", CAPS, prefetch_budget=3, tables=tb)
    got = simulate_trace(port(tr), "pfcs", CAPS, prefetch_budget=3,
                         tables=mine, device="cpu")
    assert counters(got) == counters(want)


def _ref_baseline_state(policy, caps, n_keys, acc):
    with enable_x64(True):
        state, step = ref_hierarchy(policy, caps, n_keys)

        def body(s, inp):
            key, t = inp
            return step(s, key, t * 4)[0], ()

        s, _ = jax.lax.scan(body, state,
                            (jnp.asarray(acc, jnp.int32),
                             jnp.arange(len(acc), dtype=jnp.int32)))
        return jax.tree_util.tree_map(np.asarray, s)


@pytest.mark.parametrize("trace", ["arc-swing", "adversarial"])
@pytest.mark.parametrize("policy", POLICIES)
def test_final_state_equals_reference(policy, trace):
    """After a trace, the port's state is the reference's: slot keys and
    stamps, the shadow, ARC's p bit for bit, LIRS's status, stack and
    queue stamps, residency and counts.  ``chip_smoke.py``'s swing trace
    drives ARC's p to 0 and to c and leaves it at a fraction with a
    rounding history; the eviction-adversarial trace drives LIRS through
    its demotes."""
    caps = (("L1", 4), ("L2", 12))
    if trace == "arc-swing":
        acc = chip_smoke().arc_swing_accesses(16).astype(np.int32)
    else:
        acc = np.asarray(adversarial_trace(length=T, capacity=16,
                                           seed=5).accesses, dtype=np.int32)
    n_keys = int(acc.max()) + 1
    want = _ref_baseline_state(policy, caps, n_keys, acc)
    got = baseline_scan(torch.from_numpy(acc[None, :]), policy,
                        [c for _, c in caps], n_keys)["state"]
    assert_state_equal(want, got)
    if policy == "arc" and trace == "arc-swing":
        assert float(want["pol"]["p"]) == 3.247619047619046


def test_pfcs_final_state_equals_reference():
    """PFCS's levels (keys, stamps, prefetched flags, degrees), its
    residency index and its counters after a trace, on the reference's
    tables."""
    tr = R.db_join_trace(n_orders=150, n_customers=40, n_items=80,
                         n_queries=T, seed=6)
    tb = ref_pfcs_tables(tr, CAPS)
    acc = np.asarray(tr.accesses, dtype=np.int32)
    n_keys = tb.targets.shape[0]
    with enable_x64(True):
        state, micro, step = ref_build_pfcs(CAPS, n_keys, 4, 8, True, False)
        tgt, truth, deg = (jnp.asarray(x) for x in (tb.targets, tb.truth,
                                                    tb.degree))

        def body(s, inp):
            key, t = inp
            return step(s, key, t * micro, tgt, truth, deg), ()

        s, _ = jax.lax.scan(body, state,
                            (jnp.asarray(acc),
                             jnp.arange(len(acc), dtype=jnp.int32)))
        want = jax.tree_util.tree_map(np.asarray, s)

    def t(x, dtype):
        return torch.from_numpy(np.asarray(x).astype(dtype)[None])

    got = pfcs_scan(torch.from_numpy(acc[None, :]), [c for _, c in CAPS],
                    n_keys, 4, 8, True, False, t(tb.targets, np.int32),
                    t(tb.truth, bool), t(tb.degree, np.int32))
    assert_state_equal(want["levels"], got["state"]["levels"], "levels")
    assert_state_equal(want["where"], got["state"]["where"], "where")
    assert_state_equal(want["stats"], {k: got[k] for k in want["stats"]},
                       "stats")


@pytest.mark.parametrize("workload", ["db_join", "ml_epoch", "hft"])
def test_table1_pfcs_counters_are_the_reference_oracles(workload):
    """``chip_smoke.py``'s ``TABLE1_PFCS``, which the ``table1`` phase
    holds every PFCS trace of the card's run to, is the reference's
    scalar oracle ``simulate_pfcs`` on the reference's traces of each
    trial, at ``benchmarks/table1.py``'s configuration; the port's
    generators give the same traces."""
    cs = chip_smoke()
    gen, kw = cs.TABLE1_WORKLOADS[workload]
    want = []
    for seed in range(cs.TABLE1_TRIALS):
        tr = getattr(R, gen)(seed=seed, **kw)
        assert np.array_equal(np.asarray(tr.accesses),
                              cs._make_trace(gen, seed=seed, **kw).accesses)
        st = R.simulate_pfcs(tr, cs.TABLE1_CAPS)
        want.append((tuple(st.hits_per_level.values()), st.misses,
                     st.demand_accesses, st.prefetches_issued,
                     st.prefetches_used, st.prefetches_true))
    assert cs.TABLE1_PFCS[workload] == want


@pytest.mark.parametrize("system", ["lru", "fifo", "2q", "arc", "lirs",
                                    "pfcs"])
def test_global_counts_are_the_reference_oracles(system):
    """``chip_smoke.py``'s ``GLOBAL_COUNTS``, which ``engine_check`` holds
    its long batch (every array in global memory, more keys than slots) to,
    are the reference's scalar oracles on the same traces."""
    cs = chip_smoke()
    want = []
    for tr in cs.global_traces():
        ref = R.Trace(tr.name, np.asarray(tr.accesses), tr.relationships,
                      tr.n_keys)
        st = (R.simulate_pfcs(ref, cs.GLOBAL_CAPS) if system == "pfcs"
              else R.simulate_baseline(system, ref, cs.GLOBAL_CAPS))
        want.append(cs.oracle_counters(st))
    assert cs.GLOBAL_COUNTS[system] == want
