"""The port's serving path on the CPU against the reference: the PFCS
discovery tables, successor tables, state rebuilt from the reference's
arrays, shared-prefix discovery, the ``ServingEngine`` at
``case_serving``'s smoke configuration with every cache backend, the
sharded ``SlotMachine`` on a reduced ``case_batching`` trace, and the
launcher.  The port runs with ``device="cpu"`` (the kernels' plain
versions); the reference runs its Pallas kernels in interpret mode."""

from torch_parity import (assert_registries_equal,
                          assert_state_arrays_equal, registry_arrays,
                          state_arrays)

import dataclasses
import json
import os

import numpy as np
import pytest

from repro.core import db_join_trace as ref_db_join_trace
from repro.core import graph_walk_trace as ref_graph_walk_trace
from repro.core.engine.tables import make_pfcs_cache as ref_make_pfcs_cache
from repro.core.engine.tables import pfcs_tables as ref_pfcs_tables
from repro.core.engine.tables import related_bulk as ref_related_bulk
from repro.core.engine.tables import successor_table as ref_successor_table
from repro.launch import serve as ref_serve
from repro.serving.engine import ServingEngine as RefEngine
from repro.serving.kv_cache_vec import VectorizedPagedKVCache as RefVec
from repro.serving.slots import SlotMachine as RefSlotMachine
from repro_torch.core import (CacheLevel, db_join_trace, graph_walk_trace,
                              state_from_arrays)
from repro_torch.core.engine.shard import (PrimeSpacePartition,
                                           sharded_successor_table)
from repro_torch.core.engine.tables import (make_pfcs_cache, pfcs_tables,
                                            related_bulk, successor_table)
from repro_torch.launch import serve
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.kv_cache_vec import VectorizedPagedKVCache
from repro_torch.serving.slots import (SlotMachine, SlotOracle,
                                       poisson_arrival_ticks)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _requests(n, seed=0, shared=12, key_space=60):
    rng = np.random.default_rng(seed)
    pool = list(rng.integers(0, key_space, size=shared))
    out = []
    for _ in range(n):
        k = int(rng.integers(1, shared + 1))
        tail = [int(x) for x in rng.integers(0, key_space,
                                             size=int(rng.integers(2, 20)))]
        out.append(pool[:k] + tail)
    return out


def _filled_caches(n_req=24):
    port = VectorizedPagedKVCache(hbm_pages=16, page_size=4, device="cpu")
    ref = RefVec(hbm_pages=16, page_size=4)
    for rid, toks in enumerate(_requests(n_req)):
        port.register_request(rid, toks)
        ref.register_request(rid, toks)
    return port, ref


# --------------------------------------------------------------------------- #
# PFCS discovery tables (trace side)                                          #
# --------------------------------------------------------------------------- #

CAPS = (("L1", 8), ("L2", 24), ("L3", 64))


@pytest.mark.parametrize("discover", ["host", "kernel"])
def test_pfcs_tables_match_reference(discover):
    """Targets (order included), ground truth, degrees and the
    factorizer's stage counts equal the reference's, under either
    discovery backend, and the two backends agree."""
    kw = dict(n_orders=150, n_customers=40, n_items=80, n_queries=1200,
              seed=8)
    port = pfcs_tables(db_join_trace(**kw), CAPS, discover=discover,
                       device="cpu")
    ref = ref_pfcs_tables(ref_db_join_trace(**kw), CAPS, discover=discover)
    for key in ("targets", "truth", "degree"):
        np.testing.assert_array_equal(getattr(port, key), getattr(ref, key),
                                      err_msg=key)
    assert port.factor_ops == ref.factor_ops
    assert (port.targets >= 0).any()
    if discover == "kernel":
        host = pfcs_tables(db_join_trace(**kw), CAPS, discover="host",
                           device="cpu")
        np.testing.assert_array_equal(port.targets, host.targets)


def test_related_bulk_matches_reference_and_prefetcher():
    kw = dict(n_keys=300, relationship_density=0.8, n_accesses=1200, seed=9)
    cache = make_pfcs_cache(graph_walk_trace(**kw), CAPS)
    ref_cache = ref_make_pfcs_cache(ref_graph_walk_trace(**kw), CAPS)
    keys = sorted({int(k) for k in np.unique(
        graph_walk_trace(**kw).accesses)})
    bulk = related_bulk(cache, keys, device="cpu")
    assert bulk == ref_related_bulk(ref_cache, keys)
    assert any(bulk.values())
    for k in keys:
        assert bulk.get(k, []) == cache.prefetcher.related_elements(k), k


# --------------------------------------------------------------------------- #
# state rebuilt from the reference's arrays                                   #
# --------------------------------------------------------------------------- #

def test_state_from_arrays_round_trips_reference_registry():
    """The reference cache's assignment, pools and registry, read out as
    plain arrays, rebuild a port state that reads back the same arrays,
    builds the same successor rows as the reference on its own state,
    and hands out the same primes next."""
    _, ref = _filled_caches()
    arrays = state_arrays(ref.assigner)
    assert arrays["composites"].size > 0
    assigner, registry = state_from_arrays(**arrays)
    assert assigner.registry is registry
    assert_state_arrays_equal(state_arrays(assigner), arrays)
    ids = range(ref._next_page)
    want = ref_successor_table(ref.registry, ref.assigner, ids,
                               discover="kernel")
    assert any(want.values())
    for discover in ("host", "kernel"):
        assert successor_table(registry, assigner, ids, discover=discover,
                               device="cpu") == want, discover
    for level in CacheLevel.ALL:
        assert assigner.assign(10_000 + level, level) == \
            ref.assigner.assign(10_000 + level, level)


def test_state_from_arrays_rejects_inconsistent_arrays():
    _, ref = _filled_caches(6)
    arrays = state_arrays(ref.assigner)
    arrays["composites"] = arrays["composites"] + 1
    with pytest.raises(ValueError, match="not a chunk"):
        state_from_arrays(**arrays)


# --------------------------------------------------------------------------- #
# successor tables and shared prefixes                                        #
# --------------------------------------------------------------------------- #

def test_successor_table_host_kernel_and_reference_agree():
    """Rows — order and repeats included — equal across the port's host
    and kernel backends, the sharded table, and the reference's host and
    Pallas-interpret kernel backends."""
    port, ref = _filled_caches()
    assert_registries_equal(port, ref)
    ids = range(port._next_page)
    rows = {
        "host": successor_table(port.registry, port.assigner, ids,
                                discover="host", device="cpu"),
        "kernel": successor_table(port.registry, port.assigner, ids,
                                  discover="kernel", device="cpu"),
        "sharded2": sharded_successor_table(
            port.registry, port.assigner, ids, PrimeSpacePartition(2),
            device="cpu"),
        "ref_host": ref_successor_table(ref.registry, ref.assigner, ids,
                                        discover="host"),
        "ref_kernel": ref_successor_table(ref.registry, ref.assigner, ids,
                                          discover="kernel"),
    }
    assert any(rows["host"].values())
    for name, r in rows.items():
        assert r == rows["ref_host"], name


def test_shared_prefix_bulk_matches_reference():
    port, ref = _filled_caches()
    pairs = [(a, b) for a in range(0, 24, 3) for b in range(1, 24, 5)
             if a != b]
    got = port.shared_prefix_bulk(pairs)
    assert got == ref.shared_prefix_bulk(pairs)
    assert any(got.values())
    for a, b in pairs[:6]:
        assert port.shared_prefix(a, b) == got[(a, b)]


# --------------------------------------------------------------------------- #
# ServingEngine at case_serving's smoke configuration                         #
# --------------------------------------------------------------------------- #

def _run_engine(cls, kv, budget, **kw):
    rng = np.random.default_rng(0)
    eng = cls(None, None, max_batch=16, page_size=16, hbm_pages=24, kv=kv,
              prefetch_budget=budget, reread_window=2, shards=2, **kw)
    groups = [list(rng.integers(0, 30_000, size=64)) for _ in range(6)]
    for r in range(48):
        tail = list(rng.integers(0, 30_000, size=int(rng.integers(48, 129))))
        eng.submit(groups[r % len(groups)] + tail, max_new_tokens=8)
    done = eng.run_until_idle()
    assert len(done) == 48
    return eng


@pytest.mark.parametrize("kv,budget,bench_key", [
    ("vec", 4, "pfcs_vec"), ("scalar", 4, "pfcs_scalar"),
    ("sharded", 4, "pfcs_shard2"), ("vec", 0, "lru")])
def test_engine_matches_reference_and_bench(kv, budget, bench_key):
    port = _run_engine(ServingEngine, kv, budget, device="cpu")
    ref = _run_engine(RefEngine, kv, budget)
    ps, rs = port.pages.stats, ref.pages.stats
    assert ps.parity_tuple() == rs.parity_tuple()
    assert ps.registry_scans == rs.registry_scans
    assert port.pages.prefetch_log == ref.pages.prefetch_log
    assert list(port.pages.hbm.items()) == list(ref.pages.hbm.items())
    assert port.peak_live == ref.peak_live
    assert_registries_equal(port.pages, ref.pages)
    if kv != "scalar":
        assert port.pages.successor_rows() == ref.pages.successor_rows()
    if kv == "sharded":
        assert dataclasses.asdict(port.pages.last_scan) == \
            dataclasses.asdict(ref.pages.last_scan)
        assert port.pages.last_scan.cross_composites > 0
        assert port.pages.shard_load() == ref.pages.shard_load()
    bench = json.load(open(os.path.join(ROOT, "BENCH_case_serving.json")))
    for key in ("hbm_hit_rate", "prefetch_hit_rate", "registry_scans"):
        if bench_key in bench[key]:
            assert getattr(ps, key) == bench[key][bench_key], key


def test_registry_arrays_reads_both_packages():
    port, ref = _filled_caches(6)
    ra = registry_arrays(port)
    assert ra["composites"].size == len(ra["members"]) > 0
    assert all(len(m) == 2 for m in ra["members"])
    assert (ra["page_prime"] > 0).all()
    assert registry_arrays(ref)["members"] == ra["members"]


# --------------------------------------------------------------------------- #
# SlotMachine with kv="sharded" on a reduced case_batching trace              #
# --------------------------------------------------------------------------- #

def _batching_trace(n_req=160):
    """``case_batching``'s trace shape (60% burst + Poisson tail, shared
    32-token prefixes, ragged tails and decode demands), cut to size."""
    rng = np.random.default_rng(0)
    ticks = poisson_arrival_ticks(n_req, rate=24.0, seed=0, burst_frac=0.6,
                                  silence_ticks=2)
    groups = [list(rng.integers(0, 30_000, size=48))
              for _ in range(max(1, n_req // 64))]
    out = []
    for i, t in enumerate(ticks):
        tail = list(rng.integers(0, 30_000, size=int(rng.integers(8, 33))))
        out.append((int(t), groups[i % len(groups)][:32] + tail,
                    int(rng.integers(4, 9))))
    return out


def _run_slots(cls, arrivals, **kw):
    cfg = dict(max_batch=16, page_size=16, hbm_pages=32, kv="sharded",
               prefetch_budget=4, reread_window=2, prefill_tokens=128,
               policy="continuous", preempt_wait=6)
    cfg.update(kw)
    eng = cls(**cfg)
    for t, prompt, new in arrivals:
        eng.submit(prompt, max_new_tokens=new, arrival=t)
    eng.run_until_idle(max_ticks=1_000_000)
    return eng


def test_sharded_slot_machine_matches_reference():
    arrivals = _batching_trace()
    port = _run_slots(SlotMachine, arrivals, device="cpu")
    oracle = _run_slots(SlotOracle, arrivals, device="cpu")
    ref = _run_slots(RefSlotMachine, arrivals)
    for other in (oracle, ref):
        assert port.pages.stats.parity_tuple() == \
            other.pages.stats.parity_tuple()
        assert port.tier_log == other.tier_log
        assert port.pages.prefetch_log == other.pages.prefetch_log
        assert [(r.first_tick, r.done_tick, r.preemptions)
                for r in port.requests] == \
            [(r.first_tick, r.done_tick, r.preemptions)
             for r in other.requests]
        assert port.latency_report() == other.latency_report()
    assert port.preemptions > 0 and port.pages.bulk_refreshes > 1
    assert_registries_equal(port.pages, ref.pages)


def test_launcher_matches_reference(capsys):
    argv = ["--null-model", "--kv", "sharded", "--max-batch", "8",
            "--requests", "12", "--max-new", "6"]
    out = serve.main(argv + ["--device", "cpu"])
    ref = ref_serve.main(argv)
    capsys.readouterr()
    for key in ("tok_per_s", "device"):
        out.pop(key, None)
        ref.pop(key, None)
    assert out == ref
    assert out["completed"] == 12


@pytest.mark.parametrize("config", ["slot_vec", "slot_oracle", "lockstep",
                                    "lru"])
def test_case_batching_smoke_matches_bench(config):
    """``case_batching``'s smoke run (1200 open-loop requests, 64 slots)
    through the port gives every deterministic key of
    ``BENCH_case_batching.json``."""
    cls, policy, budget, wait = {
        "slot_vec": (SlotMachine, "continuous", 4, 6),
        "slot_oracle": (SlotOracle, "continuous", 4, 6),
        "lockstep": (SlotMachine, "lockstep", 4, None),
        "lru": (SlotMachine, "continuous", 0, 6)}[config]
    eng = _run_slots(cls, _batching_trace(1200), max_batch=64, hbm_pages=96,
                     kv="vec", prefill_tokens=256, policy=policy,
                     prefetch_budget=budget, preempt_wait=wait,
                     device="cpu")
    rep = eng.latency_report()
    rep.update(hbm_hit_rate=eng.pages.stats.hbm_hit_rate,
               prefetch_hit_rate=eng.pages.stats.prefetch_hit_rate)
    bench = json.load(open(os.path.join(ROOT, "BENCH_case_batching.json")))
    for key, want in bench[config].items():
        if key == "wall_s":
            continue
        got = rep[key]
        if isinstance(want, dict):
            got = {str(q): v for q, v in got.items()}
        assert got == want, key
