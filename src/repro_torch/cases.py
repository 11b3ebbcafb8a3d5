"""Benchmark cases of the port, after ``benchmarks/cases.py``: each
``case_*`` runs the reference's configuration through the port's
entry points on ``device`` (default ``"cuda"``), makes the reference's
asserts, and returns the reference's dict; :func:`bench_payload` turns
that dict into the keys of the reference's ``BENCH_case_*.json``, and
the runner writes them:

    python -m repro_torch.cases --out bench_torch [--full] [--cases ...]
        [--device cuda|cpu]
    python tools/check_bench_regression.py --baseline <copies of the
        checked-in BENCH_case_*.json> --fresh bench_torch

* :func:`case_serving` — ``ServingEngine`` (``model=None``) over the
  paged-KV caches: vectorized, scalar oracle, LRU, sharded.
* :func:`case_batching` — open-loop Poisson arrivals through
  ``SlotMachine`` / ``SlotOracle``, continuous against lockstep and LRU.
* :func:`case_elastic` — a resize storm and shard kills under load,
  against the uninterrupted scalar oracle.
* :func:`case_moe` — the MoE expert tier over a router schedule, the
  engine's synthetic-router load generator and, at full size, a MoE
  smoke model's real router feeding the engine's expert tier.
* :func:`case_tenancy` — one engine serving a hot, cold and scanner
  tenants under weighted quotas, vec against the scalar oracle per tenant.
* :func:`case_dedup` — shared system prompts across tenants through the
  slot machine with copy-on-write dedup, against its scalar oracle and a
  run without dedup.
* :func:`case_scale` — the wide registry (below).
* :func:`run_table1` — ``benchmarks/table1.py::run``: the paper's Table 1
  over the trace engine (not a runner case: it writes no BENCH file).

Five cases are also split into the pieces ``chip_smoke.py`` drives on
the card (``serving_run``; ``batching_trace``, ``batching_run``,
``check_batching`` and ``batching_report``; ``moe_schedule``,
``moe_run``, ``moe_real_router_engine`` and ``real_router_report``;
``tenancy_run`` and ``check_tenancy``; ``dedup_trace``, ``dedup_run`` and
``check_dedup``).

:func:`case_scale` is the million-element wide-registry case: 1M data
elements through Algorithm 1's MEM pool, 10,000 chains 100 deep
registered as pairwise edges (about 990k composites) plus every 16th
chain as one whole-chain *group* relationship, whose 1024-bit chunks are
far beyond int64.  A sampled sub-universe is then verified against exact
Python-int arithmetic: the limb divisibility scan, the staged
factorization (zero false positives, Theorem 1) and the pairwise limb
gcd.  Every number it returns except the ``*_wall_s`` timings is a
deterministic counter, so the checked-in ``BENCH_case_scale.json`` of
the reference holds the port to the same registry and the same results.

The build and the verification are separate functions so that a caller
can keep the registry (``chip_smoke.py`` scans all of it on the card).
Times are host seconds (``time.perf_counter``); the kernel calls wait for
their results.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.assignment import PrimeAssigner
from repro_torch.core.composite import (CompositeRegistry,
                                        encode_relationship,
                                        n_limbs_for_bits, pack_limbs)
from repro_torch.core.primes import CacheLevel, HierarchicalPrimeAllocator
from repro_torch.device import resolve_device
from repro_torch.obs import profile
from repro_torch.obs.telemetry import Progress

__all__ = ["ScaleUniverse", "build_scale_universe", "verify_scale",
           "case_scale", "NEGATIVE_PRIMES", "SCALE_MAX_BITS", "GROUP_STRIDE",
           "case_serving", "serving_run", "case_batching", "BATCHING_CONFIGS",
           "batching_trace", "batching_run", "check_batching",
           "batching_report", "case_elastic", "case_moe", "MoESchedule",
           "moe_schedule", "moe_run", "MOE_REAL_ROUTER_ARCH",
           "moe_real_router_engine", "real_router_report", "case_tenancy",
           "tenancy_config",
           "tenancy_run", "tenancy_protection", "check_tenancy",
           "TENANCY_TRAIL",
           "case_dedup", "DedupTrace", "dedup_trace", "dedup_run",
           "check_dedup", "DEDUP_PAGE_MB", "run_table1", "table1_workloads",
           "TABLE1_CAPS", "TABLE1_SYSTEMS", "TABLE1_PAPER", "bench_payload",
           "CASES", "DEFAULT_OUT", "run_case", "main"]

#: the registry's chunk width: 1024 bits, 32 limbs
SCALE_MAX_BITS = 1024
#: every GROUP_STRIDE-th chain is also registered as one group relationship
GROUP_STRIDE = 16

#: small primes the MEM pool never assigns (its primes start above 10**6):
#: query primes that must hit nothing
NEGATIVE_PRIMES = [2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37, 41, 43,
                   47, 53]


@dataclass
class ScaleUniverse:
    """The registry of :func:`case_scale` and its verification sample."""

    registry: CompositeRegistry
    assigner: PrimeAssigner
    prime_of: List[int]
    n_chains: int
    depth: int
    sample_chains: List[int]
    pool: List[int]          # member primes of the sampled chains
    sample: List[int]        # their edge composites and group chunks
    queries: List[int]       # every 7th pool prime + NEGATIVE_PRIMES
    assign_wall_s: float
    register_wall_s: float
    build_rate: Dict[str, object]   # the registry loop's Progress summary


def build_scale_universe(n_chains: int = 10_000, depth: int = 100,
                         n_verify_chains: int = 24) -> ScaleUniverse:
    """Assign ``n_chains * depth`` MEM primes, register each chain's
    pairwise edges and every ``GROUP_STRIDE``-th chain as a group, and
    pick the verification sample: half of the sampled chains carry a
    group relationship, half are edge-only."""
    registry = CompositeRegistry(max_bits=SCALE_MAX_BITS)
    assigner = PrimeAssigner(HierarchicalPrimeAllocator(), registry)
    t0 = time.perf_counter()
    prime_of = assigner.assign_many(range(n_chains * depth), CacheLevel.MEM)
    assign_wall = time.perf_counter() - t0

    t0 = time.perf_counter()
    prog = Progress(n_chains, label="register chains", quiet=True)
    for c in range(n_chains):
        row = prime_of[c * depth:(c + 1) * depth]
        registry.register_many(zip(row, row[1:]), kind="chain")
        if c % GROUP_STRIDE == 0:
            registry.register(row, kind="group")      # -> wide chunks
        prog.advance()
    build_rate = prog.finish()
    register_wall = time.perf_counter() - t0

    half = n_verify_chains // 2
    sample_chains = (list(range(0, n_chains, GROUP_STRIDE)[:half])
                     + list(range(1, n_chains, GROUP_STRIDE)[:half]))
    pool = sorted({p for c in sample_chains
                   for p in prime_of[c * depth:(c + 1) * depth]})
    sample: List[int] = []
    for c in sample_chains:
        row = prime_of[c * depth:(c + 1) * depth]
        sample.extend(a * b for a, b in zip(row, row[1:]))
        if c % GROUP_STRIDE == 0:
            sample.extend(encode_relationship(row, SCALE_MAX_BITS))
    if not all(c in registry._by_composite for c in sample):
        raise AssertionError("sampled composites missing from the registry")
    return ScaleUniverse(registry, assigner, prime_of, n_chains, depth,
                         sample_chains, pool, sample,
                         pool[::7] + NEGATIVE_PRIMES, assign_wall,
                         register_wall, build_rate)


def verify_scale(u: ScaleUniverse, device="cuda") -> Dict[str, object]:
    """The differential verification of :func:`case_scale` on ``device``
    (the limb scan, the staged factorization and the limb gcd, each
    against exact Python ints); raises on any disagreement, returns the
    case's report with the reference's ``obs`` block: the registry
    loop's rate and the kernel wrappers' launch ledger (collected here,
    the ledger's earlier state restored after)."""
    dev = resolve_device(device)
    with profile.profiling():
        out = _verify_scale(u, dev)
        launches = profile.summary()
    out["obs"] = dict(registry_build=u.build_rate, kernel_launches=launches)
    return out


def _verify_scale(u: ScaleUniverse, dev) -> Dict[str, object]:
    from repro_torch.kernels.ops import (divisibility_scan_limbs,
                                         factorize_batch_exact,
                                         gcd_batch_exact)

    comps = u.registry.composites_list()
    wide = [c for c in comps if c.bit_length() > 63]
    if not wide:
        raise AssertionError("the case must hold composites beyond int64")
    L = n_limbs_for_bits(SCALE_MAX_BITS)
    sample, queries = u.sample, u.queries

    t0 = time.perf_counter()
    idx = divisibility_scan_limbs(pack_limbs(sample, L), queries, device=dev)
    scan_wall = time.perf_counter() - t0
    scan_hits = 0
    for j, q in enumerate(queries):
        want = [i for i, c in enumerate(sample) if c % q == 0]
        if list(idx[j]) != want:
            raise AssertionError(f"limb scan diverged at prime {q}")
        scan_hits += len(want)
    if any(len(idx[len(queries) - len(NEGATIVE_PRIMES) + k])
           for k in range(len(NEGATIVE_PRIMES))):
        raise AssertionError("a negative-control prime hit (Theorem 1)")

    t0 = time.perf_counter()
    factors, residual = factorize_batch_exact(sample, u.pool, device=dev)
    factor_wall = time.perf_counter() - t0
    false_pos = 0
    for c, fs, r in zip(sample, factors, residual):
        prod = 1
        for p in fs:
            false_pos += c % p != 0
            prod *= p
        if prod * int(r) != c or int(r) != 1:
            raise AssertionError("factor recovery must be exact, residual 1")
    if false_pos:
        raise AssertionError(f"{false_pos} false positives (Theorem 1)")

    # each sampled group chunk against its chain's first edge: the shared
    # primes rebuild the gcd exactly
    ga = [c for c in sample if c.bit_length() > 63]
    gb = [u.prime_of[c * u.depth] * u.prime_of[c * u.depth + 1]
          for c in u.sample_chains if c % GROUP_STRIDE == 0
          for _ in encode_relationship(
              u.prime_of[c * u.depth:(c + 1) * u.depth], SCALE_MAX_BITS)]
    gb = gb[:len(ga)]
    t0 = time.perf_counter()
    gs = gcd_batch_exact(ga, gb, u.pool, device=dev)
    gcd_wall = time.perf_counter() - t0
    if gs != [math.gcd(a, b) for a, b in zip(ga, gb)]:
        raise AssertionError("limb gcd diverged from exact host gcd")

    return dict(
        n_elements=len(u.prime_of), n_chains=u.n_chains,
        chain_depth=u.depth, registry_max_bits=SCALE_MAX_BITS, n_limbs=L,
        n_relationships=len(u.registry), n_composites=len(comps),
        n_wide_composites=len(wide),
        max_composite_bits=max(c.bit_length() for c in comps),
        max_prime=max(u.prime_of),
        verify=dict(
            n_verified=len(sample), n_query_primes=len(queries),
            scan_hits=scan_hits, factor_false_positives=false_pos,
            residual_all_one=True, gcd_pairs=len(gs),
            gcd_nontrivial=sum(1 for g in gs if g > 1)),
        assign_wall_s=u.assign_wall_s, register_wall_s=u.register_wall_s,
        scan_wall_s=scan_wall, factor_wall_s=factor_wall,
        gcd_wall_s=gcd_wall)


def case_scale(n_chains: int = 10_000, depth: int = 100,
               n_verify_chains: int = 24, device="cuda") -> Dict[str, object]:
    """``benchmarks/cases.py::case_scale`` on the port: defaults are the
    reference's published size (``n_verify_chains`` 24 is its smoke
    setting, the one ``BENCH_case_scale.json`` records)."""
    return verify_scale(build_scale_universe(n_chains, depth,
                                             n_verify_chains), device)


# --------------------------------------------------------------------------- #
# serving: case_serving                                                       #
# --------------------------------------------------------------------------- #

def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def serving_run(kv: str, budget: int, smoke: bool = False,
                n_shards: int = 2, max_bits: int = 62,
                device="cuda") -> Tuple[Dict[str, object], Dict[str, object]]:
    """One ``case_serving`` engine run (``ServingEngine``, ``model=None``,
    the shared-prefix request mix of seed 0): ``(report, trail)``, the
    trail holding the parity counters, every touch's tier and the
    prefetch log.  The wall leaves out the tier recording (reported on
    its own as ``tier_record_s``) and waits for the card."""
    from repro_torch.serving.engine import ServingEngine

    dev = resolve_device(device)
    # HBM is sized BELOW the live working set (live slots x reread
    # window) on purpose: the regime where placement decides everything
    c = (dict(n_req=48, max_batch=16, max_new=8, hbm=24, shared_tok=64,
              window=2) if smoke else
         dict(n_req=256, max_batch=128, max_new=32, hbm=384, shared_tok=128,
              window=4))
    rng = np.random.default_rng(0)
    eng = ServingEngine(None, None, max_batch=c["max_batch"], page_size=16,
                        hbm_pages=c["hbm"], kv=kv, prefetch_budget=budget,
                        reread_window=c["window"], shards=n_shards,
                        max_bits=max_bits, device=dev)
    tiers: List[str] = []
    record_s = [0.0]

    def record(items, touch=eng.pages.touch_batch):
        out = touch(items)
        t = time.perf_counter()
        tiers.extend(out)
        record_s[0] += time.perf_counter() - t
        return out

    eng.pages.touch_batch = record
    groups = [list(rng.integers(0, 30_000, size=c["shared_tok"]))
              for _ in range(max(1, c["n_req"] // 8))]
    for r in range(c["n_req"]):
        tail = list(rng.integers(0, 30_000, size=int(rng.integers(48, 129))))
        eng.submit(groups[r % len(groups)] + tail,
                   max_new_tokens=c["max_new"])
    _sync(dev)
    t0 = time.perf_counter()
    done = eng.run_until_idle()
    _sync(dev)
    wall = time.perf_counter() - t0 - record_s[0]
    toks = sum(len(r.generated) for r in done)
    ttfts = [r.first_token_t - r.submit_t for r in done
             if r.first_token_t is not None]
    st = eng.pages.stats
    out = dict(kv=kv, max_bits=max_bits, completed=len(done), wall_s=wall,
               tier_record_s=record_s[0], tok_per_s=toks / max(wall, 1e-9),
               req_per_s=len(done) / max(wall, 1e-9),
               mean_ttft_s=float(np.mean(ttfts)) if ttfts else 0.0,
               peak_concurrency=eng.peak_live,
               hbm_hit_rate=st.hbm_hit_rate,
               prefetch_hit_rate=st.prefetch_hit_rate,
               registry_scans=st.registry_scans,
               bulk_refreshes=getattr(eng.pages, "bulk_refreshes", None),
               parity=st.parity_tuple())
    if kv == "sharded":
        scan = eng.pages.last_scan
        out.update(shards=n_shards, used_shard_map=scan.used_shard_map,
                   local_composites=list(scan.local_composites),
                   cross_composites=scan.cross_composites,
                   queries_per_shard=list(scan.queries_per_shard),
                   gcd_pairs=scan.gcd_pairs,
                   shard_load=eng.pages.shard_load(),
                   shard_agg_parity=eng.pages.aggregate_shard_stats()
                   .parity_tuple())
    trail = {"parity": st.parity_tuple(), "tiers": tiers,
             "prefetch_log": list(eng.pages.prefetch_log)}
    return out, trail


def case_serving(smoke: bool = False, shards=None, max_bits: int = 62,
                 device="cuda") -> Dict[str, object]:
    """``benchmarks/cases.py::case_serving`` on the port: the same request
    mix through ``pfcs_vec`` (vectorized cache), ``pfcs_scalar`` (the
    oracle), ``lru`` (prefetch off) and ``pfcs_shard{N}`` for each shard
    count of ``shards`` (default 1/2/4, smoke 2), with the reference's
    asserts: every cache's counters equal the oracle's, per-shard stats
    aggregate to the total, no per-page registry scan on the vectorized
    paths, and (full size) 100+ concurrent requests a step.  Returns the
    reference's dict (each run's report without its parity tuples, and
    ``vec_vs_scalar_speedup``); :func:`bench_payload` gives the keys of
    ``BENCH_case_serving.json``."""
    if shards is None:
        shards = (2,) if smoke else (1, 2, 4)
    kw = dict(smoke=smoke, max_bits=max_bits, device=device)
    res = {"pfcs_vec": serving_run("vec", 4, **kw)[0],
           "pfcs_scalar": serving_run("scalar", 4, **kw)[0],
           "lru": serving_run("vec", 0, **kw)[0]}
    for n in shards:
        res[f"pfcs_shard{n}"] = serving_run("sharded", 4, n_shards=n,
                                            **kw)[0]
    oracle = res["pfcs_scalar"]["parity"]
    if res["pfcs_vec"]["parity"] != oracle:
        raise AssertionError("vectorized serving cache diverged from the "
                             "scalar oracle")
    if res["pfcs_vec"]["registry_scans"]:
        raise AssertionError("vectorized touch path performed a per-page "
                             "registry scan")
    for n in shards:
        r = res[f"pfcs_shard{n}"]
        if r["parity"] != oracle:
            raise AssertionError(f"sharded cache ({n} shards) diverged from "
                                 f"the scalar oracle")
        if r["shard_agg_parity"] != r["parity"]:
            raise AssertionError(f"per-shard stats ({n} shards) do not "
                                 f"aggregate to the total")
        if r["registry_scans"]:
            raise AssertionError("sharded touch path performed a per-page "
                                 "registry scan")
    if not smoke and res["pfcs_vec"]["peak_concurrency"] < 100:
        raise AssertionError("load benchmark must sustain >= 100 concurrent "
                             "requests/step")
    out = {k: {kk: vv for kk, vv in v.items()
               if kk not in ("parity", "shard_agg_parity")}
           for k, v in res.items()}
    out["vec_vs_scalar_speedup"] = (res["pfcs_scalar"]["wall_s"]
                                    / max(res["pfcs_vec"]["wall_s"], 1e-9))
    return out


# --------------------------------------------------------------------------- #
# serving: case_batching                                                      #
# --------------------------------------------------------------------------- #

#: ``case_batching``'s engines: config -> (engine class name, admission
#: policy, prefetch budget, preempt wait)
BATCHING_CONFIGS = {
    "slot_vec": ("SlotMachine", "continuous", 4, 6),
    "slot_oracle": ("SlotOracle", "continuous", 4, 6),
    "lockstep": ("SlotMachine", "lockstep", 4, None),
    "lru": ("SlotMachine", "continuous", 0, 6),
}


def batching_trace(smoke: bool, n_requests: Optional[int] = None):
    """``case_batching``'s arrival trace and engine sizes: a 60% burst
    front plus a Poisson tail, 32-token shared prefixes, ragged tails and
    decode demands: ``(arrivals, sizes)``, ``arrivals`` as ``(tick,
    prompt, max_new)``.  ``n_requests`` replaces the configuration's
    request count (1200 smoke, 4000 full) in the same recipe."""
    from repro_torch.serving.slots import poisson_arrival_ticks

    if smoke:
        n_req, max_batch, rate, hbm, prefill_tok = 1200, 64, 24.0, 96, 256
    else:
        n_req, max_batch, rate, hbm, prefill_tok = 4000, 128, 48.0, 256, 1024
    n_req = n_requests or n_req
    rng = np.random.default_rng(0)
    ticks = poisson_arrival_ticks(n_req, rate=rate, seed=0, burst_frac=0.6,
                                  silence_ticks=2)
    groups = [list(rng.integers(0, 30_000, size=48))
              for _ in range(max(1, n_req // 64))]
    arrivals = []
    for i, t in enumerate(ticks):
        tail = list(rng.integers(0, 30_000, size=int(rng.integers(8, 33))))
        arrivals.append((int(t), groups[i % len(groups)][:32] + tail,
                         int(rng.integers(4, 9))))
    return arrivals, dict(max_batch=max_batch, hbm_pages=hbm,
                          prefill_tokens=prefill_tok)


def batching_run(arrivals, sizes, config: str, kv: str = "vec",
                 max_bits: int = 62, device="cuda"):
    """One ``case_batching`` engine (``config`` a key of
    :data:`BATCHING_CONFIGS`) over the trace: ``(report, trail)``, the
    report the slot machine's latency report with the wall and hit
    rates, the trail its parity counters, prefetch log, tier log and
    every request's tick timings."""
    from repro_torch.serving import slots

    dev = resolve_device(device)
    cls, policy, budget, wait = BATCHING_CONFIGS[config]
    eng = getattr(slots, cls)(page_size=16, kv=kv, prefetch_budget=budget,
                              reread_window=2, policy=policy,
                              preempt_wait=wait, shards=2,
                              max_bits=max_bits, device=dev, **sizes)
    for t, prompt, new in arrivals:
        eng.submit(prompt, max_new_tokens=new, arrival=t)
    _sync(dev)
    t0 = time.perf_counter()
    eng.run_until_idle(max_ticks=1_000_000)
    _sync(dev)
    wall = time.perf_counter() - t0
    rep = eng.latency_report()
    rep.update(wall_s=wall, tok_per_s=rep["tokens"] / max(wall, 1e-9),
               hbm_hit_rate=eng.pages.stats.hbm_hit_rate,
               prefetch_hit_rate=eng.pages.stats.prefetch_hit_rate)
    trail = {"parity": eng.pages.stats.parity_tuple(),
             "prefetch_log": list(eng.pages.prefetch_log),
             "tier_log": eng.tier_log,
             "timings": [(r.first_tick, r.done_tick, r.preemptions)
                         for r in eng.requests]}
    return rep, trail


def case_batching(smoke: bool = False, device="cuda") -> Dict[str, object]:
    """``benchmarks/cases.py::case_batching`` on the port: one open-loop
    Poisson trace through ``slot_vec``, ``slot_oracle``, ``lockstep`` and
    ``lru``, with the reference's asserts (machine and oracle bit-exact on
    counters, tiers, prefetches and every request's timings; continuous
    beats lockstep on goodput; 1k+ peak in-flight).  Returns the
    reference's dict; :func:`bench_payload` gives the keys of
    ``BENCH_case_batching.json``."""
    arrivals, sizes = batching_trace(smoke)
    runs = {config: batching_run(arrivals, sizes, config, device=device)
            for config in BATCHING_CONFIGS}
    check_batching(runs)
    return batching_report({c: rep for c, (rep, _) in runs.items()})


def check_batching(runs: Dict[str, tuple]) -> None:
    """``case_batching``'s asserts over ``{config: (report, trail)}``."""
    (v, vt), (o, ot) = runs["slot_vec"], runs["slot_oracle"]
    for key in ("parity", "tier_log", "prefetch_log", "timings"):
        if vt[key] != ot[key]:
            raise AssertionError(f"slot machine diverged from the slot "
                                 f"oracle: {key}")
    if ((v["ticks"], v["preemptions"], v["resumes"])
            != (o["ticks"], o["preemptions"], o["resumes"])):
        raise AssertionError("slot machine ticks / preemptions / resumes "
                             "diverged from the oracle")
    if (v["goodput_tok_per_tick"]
            <= runs["lockstep"][0]["goodput_tok_per_tick"]):
        raise AssertionError("continuous batching must beat the lockstep "
                             "gate on goodput")
    if v["peak_in_flight"] < 1000:
        raise AssertionError("load benchmark must reach 1k+ concurrent "
                             "in-flight requests")


def batching_report(reps: Dict[str, dict]) -> Dict[str, object]:
    out = {k: dict(r) for k, r in reps.items()}
    out["goodput_vs_lockstep"] = (
        reps["slot_vec"]["goodput_tok_per_tick"]
        / max(reps["lockstep"]["goodput_tok_per_tick"], 1e-9))
    return out


# --------------------------------------------------------------------------- #
# elastic: case_elastic                                                       #
# --------------------------------------------------------------------------- #

def case_elastic(smoke: bool = False, device="cuda") -> Dict[str, object]:
    """``benchmarks/cases.py::case_elastic`` on the port: the same request
    stream through the scalar oracle uninterrupted and through
    ``kv="elastic"`` under a resize storm (2 <-> 4 shards every third
    step), a kill with timed recovery every fourth step and one deferred
    kill at step 5 (failover on demand), with the reference's asserts: tokens,
    ``PARITY_COUNTERS``, the LRU order, the prefetch log and the
    aggregate shard stats equal to the oracle's, no registry scan, some
    block moved and less migrated than a full rebuild, two or more
    recoveries with a partial one.  Recovery latency is host seconds
    around each ``fail_shard`` (which recovers through the kernels on
    ``device`` and waits for them)."""
    from repro_torch.serving.engine import ServingEngine

    dev = resolve_device(device)
    if smoke:
        n_req, max_batch, max_new = 64, 16, 8
        hbm, shared_tok, window = 24, 64, 2
    else:
        n_req, max_batch, max_new = 192, 64, 16
        hbm, shared_tok, window = 128, 96, 3

    def build(kv: str) -> ServingEngine:
        rng = np.random.default_rng(0)
        eng = ServingEngine(None, None, max_batch=max_batch, page_size=8,
                            hbm_pages=hbm, kv=kv, prefetch_budget=4,
                            reread_window=window, shards=2, device=dev)
        groups = [list(rng.integers(0, 30_000, size=shared_tok))
                  for _ in range(max(1, n_req // 8))]
        for r in range(n_req):
            tail = list(rng.integers(0, 30_000,
                                     size=int(rng.integers(48, 129))))
            eng.submit(groups[r % len(groups)] + tail,
                       max_new_tokens=max_new)
        return eng

    def drain(eng: ServingEngine, chaos: bool):
        done, step, recovery_s = [], 0, []
        _sync(dev)
        t0 = time.perf_counter()
        while eng.queue or any(s is not None for s in eng.slots):
            if chaos:
                if step % 3 == 2:               # resize storm: 2 <-> 4
                    eng.resize(4 if eng.pages.n_shards == 2 else 2)
                if step % 4 == 1:               # kill + timed recovery
                    t1 = time.perf_counter()
                    eng.fail_shard(step % eng.pages.n_shards)
                    _sync(dev)
                    recovery_s.append(time.perf_counter() - t1)
                if step == 5:                   # failover on demand
                    eng.fail_shard(0, recover=False)
            before = list(eng.slots)
            eng.step()
            done.extend(r for r in before
                        if r is not None and r.state == "done")
            step += 1
        _sync(dev)
        return done, time.perf_counter() - t0, recovery_s

    oracle = build("scalar")
    done_o, wall_o, _ = drain(oracle, chaos=False)
    eng = build("elastic")
    done_e, wall_e, recovery_s = drain(eng, chaos=True)

    def key(rs):
        return [(r.req_id, tuple(r.generated))
                for r in sorted(rs, key=lambda r: r.req_id)]

    pages, st_e, st_o = eng.pages, eng.pages.stats, oracle.pages.stats
    if key(done_e) != key(done_o):
        raise AssertionError("elastic chaos run diverged from the "
                             "uninterrupted oracle")
    if st_e.parity_tuple() != st_o.parity_tuple():
        raise AssertionError("elastic counters diverged from the scalar "
                             "oracle")
    if list(pages.hbm.items()) != list(oracle.pages.hbm.items()):
        raise AssertionError("elastic LRU order diverged from the oracle")
    if pages.prefetch_log != oracle.pages.prefetch_log:
        raise AssertionError("elastic prefetch log diverged from the oracle")
    if st_e.registry_scans:
        raise AssertionError("elastic touch path scanned the registry")
    if pages.aggregate_shard_stats().parity_tuple() != st_e.parity_tuple():
        raise AssertionError("per-shard stats do not aggregate to the total")
    plans = pages.reshard_log
    migrated = sum(p.migrated_bytes for p in plans)
    full_rebuild = sum(p.full_rebuild_bytes for p in plans)
    moved = sum(len(p.moved) for p in plans)
    if not plans or moved <= 0:
        raise AssertionError("resize storm never moved a block")
    if migrated >= full_rebuild:
        raise AssertionError("incremental migration must beat the naive "
                             "full rebuild")
    reports = pages.recovery_log
    if pages.recoveries < 2 or not any(r.mode == "partial"
                                       for r in reports):
        raise AssertionError("too few recoveries, or none partial")
    return dict(
        wall_s_oracle=wall_o, wall_s_elastic=wall_e,
        tok_per_s=sum(len(r.generated) for r in done_e) / max(wall_e, 1e-9),
        n_resizes=len(plans), n_recoveries=pages.recoveries,
        moved_blocks=moved, migrated_bytes=migrated,
        full_rebuild_bytes=full_rebuild,
        migrated_ratio=migrated / max(full_rebuild, 1),
        recovery_latency_mean_s=float(np.mean(recovery_s)),
        recovery_latency_max_s=float(np.max(recovery_s)),
        refactorized=sum(r.refactorized for r in reports),
        rows_rebuilt=sum(r.rows_rebuilt for r in reports),
        hbm_hit_rate=st_e.hbm_hit_rate,
        prefetch_hit_rate=st_e.prefetch_hit_rate)


# --------------------------------------------------------------------------- #
# MoE: case_moe                                                               #
# --------------------------------------------------------------------------- #

@dataclass
class MoESchedule:
    """``case_moe``'s expert universe and router schedule."""

    n_experts: int
    hot_experts: int
    slots: int
    topk: int
    steps: int
    batch: int
    hot: List[Tuple[int, ...]]     # the routed co-firing groups
    cold: List[Tuple[int, ...]]    # other layers' structure, never routed
    schedule: List[List[Tuple[int, ...]]]
    eng_requests: int
    eng_batch: int


def moe_schedule(smoke: bool) -> MoESchedule:
    """The expert universe (smoke: 256 experts, 64 hot, 16 HBM slots,
    top-4, 150 steps of 4 sets; full: 4096, 256, 64, top-8, 1000 x 8),
    its hot and cold groups and the router schedule, from seed 0."""
    if smoke:
        E, hot_e, slots, topk, steps, B = 256, 64, 16, 4, 150, 4
        eng_req, eng_batch = 24, 8
    else:
        E, hot_e, slots, topk, steps, B = 4096, 256, 64, 8, 1000, 8
        eng_req, eng_batch = 96, 32
    rng = np.random.default_rng(0)
    perm = rng.permutation(hot_e)
    hot = [tuple(int(e) for e in perm[i:i + topk])
           for i in range(0, hot_e - topk + 1, topk)]
    cold = [tuple(range(i, i + topk))
            for i in range(hot_e, E - topk + 1, topk)]
    schedule = [[hot[int(rng.integers(len(hot)))] for _ in range(B)]
                for _ in range(steps)]
    return MoESchedule(E, hot_e, slots, topk, steps, B, hot, cold, schedule,
                       eng_req, eng_batch)


def moe_run(ms: MoESchedule, cache) -> Dict[str, object]:
    """Replay the schedule through one expert cache: the cold groups
    registered first, then per step one ``observe_routing`` and two
    ``activate_batch`` waves (each set's head expert, then its tail)."""
    cache.observe_routing(ms.cold)
    _sync(cache.device)
    t0 = time.perf_counter()
    for batch in ms.schedule:
        cache.observe_routing(batch)
        cache.activate_batch([g[:1] for g in batch])
        cache.activate_batch([g[1:] for g in batch])
    _sync(cache.device)
    wall = time.perf_counter() - t0
    s = cache.stats
    return dict(wall_s=wall,
                activations_per_s=ms.steps * ms.batch * ms.topk
                / max(wall, 1e-9),
                hbm_hit_rate=s.hit_rate, demand_misses=s.misses,
                prefetch_precision=s.prefetch_precision,
                registry_scans=s.registry_scans, parity=s.parity_tuple(),
                prefetch_log=tuple(cache.prefetch_log))


#: the arch whose smoke model feeds ``case_moe``'s real-router block
MOE_REAL_ROUTER_ARCH = "kimi-k2-1t-a32b"


def moe_real_router_engine(model, params, device="cuda", max_seq: int = 96,
                           n_requests: int = 4, max_new: int = 4):
    """``case_moe``'s real-router block on one model: ``ServingEngine``
    with ``max_batch=2``, page size 8 and the vectorized expert tier (4
    slots, prefetch budget 4), fed ``n_requests`` prompts
    ``range(12) + [20 + i]``, run until idle.  Returns the engine; every
    decode step's router top-k sets (live slots x MoE layers) went into
    its expert cache."""
    from repro_torch.serving.engine import ServingEngine

    eng = ServingEngine(model, params, max_batch=2, max_seq=max_seq,
                        page_size=8, moe="vec", moe_slots=4,
                        moe_prefetch_budget=4, device=device)
    for i in range(n_requests):
        eng.submit(list(range(12)) + [20 + i], max_new_tokens=max_new)
    eng.run_until_idle()
    return eng


def real_router_report(cfg, eng) -> Dict[str, object]:
    """The reference's ``engine_real_router`` dict of a finished
    :func:`moe_real_router_engine`: the expert tier's hit rate,
    prefetches and precision, and the prefetches outside the
    factorization-recovered co-fire set of their trigger (Theorem 1 says
    none)."""
    ec = eng.experts
    rs = ec.stats
    false_pos = sum(1 for src, tgt in ec.prefetch_log
                    if tgt not in ec.coactivated(src))
    return dict(arch=cfg.name, n_experts=cfg.moe.n_experts,
                expert_hit_rate=rs.hit_rate, prefetches=rs.prefetches,
                prefetch_precision=rs.prefetch_precision,
                false_positive_prefetches=false_pos)


def case_moe(smoke: bool = False, real_router: Optional[bool] = None,
             device="cuda") -> Dict[str, object]:
    """``benchmarks/cases.py::case_moe`` on the port: the schedule through
    ``pfcs_vec``, ``pfcs_scalar`` and ``lru`` (prefetch off), with the
    reference's asserts (vec and scalar equal on counters and prefetch
    log, no registry scan on the vectorized path, no prefetch under
    LRU), then the engine's synthetic-router load generator
    (``engine_loadgen``) and, with ``real_router`` (default: full size,
    as in the reference), the ``kimi-k2-1t-a32b`` smoke model's router
    feeding the expert tier (``engine_real_router``, random parameters
    from a generator seeded 0), with the reference's Theorem-1 assert."""
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.expert_cache import ExpertCache
    from repro_torch.serving.expert_cache_vec import VectorizedExpertCache

    if real_router is None:
        real_router = not smoke
    dev = resolve_device(device)
    ms = moe_schedule(smoke)
    budget = ms.topk - 1

    def run(cls, b):
        return moe_run(ms, cls(ms.n_experts, hbm_slots=ms.slots,
                               prefetch_budget=b, device=dev))

    res = {"pfcs_vec": run(VectorizedExpertCache, budget),
           "pfcs_scalar": run(ExpertCache, budget),
           "lru": run(VectorizedExpertCache, 0)}
    v, o = res["pfcs_vec"], res["pfcs_scalar"]
    if v["parity"] != o["parity"]:
        raise AssertionError("vectorized expert cache diverged from the "
                             "scalar oracle")
    if v["prefetch_log"] != o["prefetch_log"]:
        raise AssertionError("vectorized expert cache issued different "
                             "prefetches")
    if v["registry_scans"]:
        raise AssertionError("vectorized activation path performed a "
                             "per-expert registry scan")
    if res["lru"]["prefetch_log"] != ():
        raise AssertionError("LRU (budget 0) prefetched")

    eng = ServingEngine(None, None, max_batch=ms.eng_batch, page_size=16,
                        hbm_pages=ms.eng_batch * 3, moe="vec",
                        moe_experts=ms.hot_experts, moe_slots=ms.slots,
                        moe_topk=ms.topk, moe_groups=len(ms.hot),
                        device=dev)
    rng = np.random.default_rng(1)
    for _ in range(ms.eng_requests):
        eng.submit(list(rng.integers(0, 30_000,
                                     size=int(rng.integers(16, 64)))),
                   max_new_tokens=8)
    _sync(dev)
    t0 = time.perf_counter()
    done = eng.run_until_idle()
    _sync(dev)
    wall = time.perf_counter() - t0
    es = eng.experts.stats
    res["engine_loadgen"] = dict(
        completed=len(done),
        tok_per_s=sum(len(r.generated) for r in done) / max(wall, 1e-9),
        expert_hit_rate=es.hit_rate, expert_misses=es.misses,
        prefetch_precision=es.prefetch_precision,
        registry_scans=es.registry_scans)
    if real_router:
        from repro_torch.configs import get_smoke
        from repro_torch.models import build_model

        cfg = get_smoke(MOE_REAL_ROUTER_ARCH)
        model = build_model(cfg, device=dev)
        reng = moe_real_router_engine(model, model.init_params(0), dev)
        res["engine_real_router"] = real_router_report(cfg, reng)
        if res["engine_real_router"]["false_positive_prefetches"]:
            raise AssertionError("Theorem 1 violated on live router "
                                 "traffic")
    out = {k: {kk: vv for kk, vv in r.items()
               if kk not in ("parity", "prefetch_log")}
           for k, r in res.items()}
    out["vec_vs_scalar_speedup"] = (o["wall_s"] / max(v["wall_s"], 1e-9))
    return out


# --------------------------------------------------------------------------- #
# multi-tenant QoS: case_tenancy                                              #
# --------------------------------------------------------------------------- #

def tenancy_config(smoke: bool) -> Dict[str, object]:
    """``case_tenancy``'s sizes: one hot tenant (weight 4), ``n_cold``
    cold ones and one scanner (weight 1 each); requests per class, new
    tokens per class, the scanner's prompt and the shared-prefix length."""
    if smoke:
        return dict(n_cold=2, hbm=32, max_batch=16, hot_req=12, cold_req=6,
                    scan_req=8, hot_new=8, cold_new=16, scan_new=12,
                    scan_prompt=192, shared_tok=48)
    return dict(n_cold=6, hbm=128, max_batch=64, hot_req=48, cold_req=8,
                scan_req=16, hot_new=8, cold_new=48, scan_new=24,
                scan_prompt=512, shared_tok=96)


def tenancy_run(kv: str, smoke: bool = False, shards: int = 2,
                max_bits: int = 62, device="cuda") -> Dict[str, object]:
    """One ``case_tenancy`` engine run: ``ServingEngine`` (``model=None``)
    with ``tenants=`` the weighted QoS configuration, the mixed-tenant
    requests of seed 0 submitted round-robin by tenant.  Returns the
    reference's run dict (wall, per-tenant rates, hit rates, TTFTs,
    evictions, quotas, the parity tuples, the prefetch log, ``_pages``)
    and, beside it, every touch's tier (``tiers``), the per-tenant
    prefetch logs and the occupancy.  The wall waits for the card."""
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.tenancy import TenantQoSConfig

    dev = resolve_device(device)
    c = tenancy_config(smoke)
    T = c["n_cold"] + 2
    hot, scanner = 0, T - 1
    # the hot tenant earns a weighted share; the scanner gets a cold
    # tenant's share: QoS is the contract, not the workload's appetite
    cfg = TenantQoSConfig.weighted(c["hbm"], [4] + [1] * c["n_cold"] + [1],
                                   prefetch_budget=4)
    eng = ServingEngine(None, None, max_batch=c["max_batch"], page_size=16,
                        hbm_pages=c["hbm"], kv=kv, prefetch_budget=4,
                        reread_window=2, tenants=cfg, shards=shards,
                        max_bits=max_bits, device=dev)
    tiers: List[str] = []

    def record(items, touch=eng.pages.touch_batch):
        out = touch(items)
        tiers.extend(out)
        return out

    eng.pages.touch_batch = record
    rng = np.random.default_rng(0)
    groups = [list(rng.integers(0, 30_000, size=c["shared_tok"]))
              for _ in range(4)]
    reqs = []
    for _ in range(c["hot_req"]):           # zipf-hot shared prefixes
        g = groups[min(int(rng.zipf(1.5)) - 1, 3)]
        tail = list(rng.integers(0, 30_000, size=int(rng.integers(16, 50))))
        reqs.append((hot, g + tail, c["hot_new"]))
    for t in range(1, 1 + c["n_cold"]):     # sparse unique traffic
        for _ in range(c["cold_req"]):
            reqs.append((t, list(rng.integers(
                0, 30_000, size=int(rng.integers(24, 80)))), c["cold_new"]))
    for i in range(c["scan_req"]):          # adversarial long chains
        base = 100_000 + i * c["scan_prompt"]
        reqs.append((scanner, list(range(base, base + c["scan_prompt"])),
                     c["scan_new"]))
    # round-robin interleave by tenant so every class is always live
    by_t = {t: [r for r in reqs if r[0] == t] for t in range(T)}
    t_of = {}
    while any(by_t.values()):
        for t in range(T):
            if by_t[t]:
                tt, prompt, new = by_t[t].pop(0)
                t_of[eng.submit(prompt, max_new_tokens=new, tenant=tt)] = tt
    _sync(dev)
    t0 = time.perf_counter()
    done = eng.run_until_idle()
    _sync(dev)
    wall = time.perf_counter() - t0
    toks = [0] * T
    ttfts: List[List[float]] = [[] for _ in range(T)]
    # first submit .. last completion: a starved tenant finishes late, so
    # its completion rate drops (tokens / wall would be blind to it)
    span_lo, span_hi = [float("inf")] * T, [0.0] * T
    for r in done:
        t = t_of[r.req_id]
        toks[t] += len(r.generated)
        span_lo[t] = min(span_lo[t], r.submit_t)
        span_hi[t] = max(span_hi[t], r.done_t or r.submit_t)
        if r.first_token_t is not None:
            ttfts[t].append(r.first_token_t - r.submit_t)
    q = eng.pages.qos
    return dict(
        wall_s=wall, completed=len(done),
        tenant_tok_per_s=[tk / max(hi - lo, 1e-9)
                          for tk, lo, hi in zip(toks, span_lo, span_hi)],
        tenant_hit_rate=[s.hbm_hit_rate for s in q.tenant_stats],
        tenant_pf_precision=[s.prefetch_hit_rate for s in q.tenant_stats],
        tenant_mean_ttft_ms=[float(np.mean(tt)) * 1e3 if tt else 0.0
                             for tt in ttfts],
        tenant_evictions=[s.evictions for s in q.tenant_stats],
        cross_tenant_prefetches=eng.pages.cross_tenant_prefetches(),
        occupancy_ok=bool((q.occupancy <= q.quota).all()),
        quota=[int(x) for x in q.quota],
        parity=eng.pages.stats.parity_tuple(),
        tenant_parity=[s.parity_tuple() for s in q.tenant_stats],
        prefetch_log=tuple(eng.pages.prefetch_log),
        registry_scans=eng.pages.stats.registry_scans,
        tiers=tiers, tenant_logs=[list(x) for x in q.tenant_logs],
        occupancy=[int(x) for x in q.occupancy], _pages=eng.pages)


#: what :func:`tenancy_run` returns beside the reference's run dict
TENANCY_TRAIL = ("parity", "tenant_parity", "prefetch_log", "tiers",
                 "tenant_logs", "occupancy")


def tenancy_protection(tenanted: bool, device="cuda") -> float:
    """The hot working set (4 pages) against a scanner sweeping 24 pages
    every step: the hot tenant's hit rate with per-tenant quotas (4 + 4
    of 8 pages) or in one shared, untenanted cache of 8 pages."""
    from repro_torch.serving.kv_cache_vec import VectorizedPagedKVCache
    from repro_torch.tenancy import (TenantQoSConfig,
                                     TenantedVectorizedPagedKVCache)

    if tenanted:
        kv = TenantedVectorizedPagedKVCache(
            hbm_pages=8, page_size=4, prefetch_budget=0,
            qos=TenantQoSConfig(2, (4, 4), (0, 0), (1, 1)), device=device)
        kv.register_request(0, list(range(16)), tenant=0)
        kv.register_request(1, list(range(100, 196)), tenant=1)
    else:
        kv = VectorizedPagedKVCache(hbm_pages=8, page_size=4,
                                    prefetch_budget=0, device=device)
        kv.register_request(0, list(range(16)))
        kv.register_request(1, list(range(100, 196)))
    hits = total = 0
    for i in range(30):
        hits += kv.touch(0, i % 4) == "hbm"
        total += 1
        kv.touch_batch([(1, j) for j in range(len(kv.chains[1]))])
    return hits / total


def case_tenancy(smoke: bool = False, device="cuda") -> Dict[str, object]:
    """``benchmarks/cases.py::case_tenancy`` on the port: one engine serves
    a hot tenant (zipf-popular shared prefixes), ``n_cold`` sparse cold
    tenants and an adversarial scanner at equal token demand, through
    ``pfcs_vec`` and ``pfcs_scalar``, with the reference's asserts:
    vec and scalar bit-exact globally and per tenant (counters, prefetch
    logs), no registry scan on the vectorized path, zero cross-tenant
    prefetches, occupancy within quota, and ``check_isolation`` over the
    final registry (pairwise gcds at the smoke size).  Returns the
    reference's dict (each run without its parity tuples and logs, the
    fairness ratio, the isolation counts and the quota-vs-shared
    protection A/B); :func:`bench_payload` gives the keys of
    ``BENCH_case_tenancy.json``."""
    dev = resolve_device(device)
    res = {"pfcs_vec": tenancy_run("vec", smoke, device=dev),
           "pfcs_scalar": tenancy_run("scalar", smoke, device=dev)}
    return check_tenancy(res, smoke, device=dev)


def check_tenancy(res: Dict[str, dict], smoke: bool,
                  device="cuda") -> Dict[str, object]:
    """``case_tenancy``'s asserts over its two runs (``pfcs_vec``,
    ``pfcs_scalar``, as :func:`tenancy_run` returns them), then its
    protection A/B on ``device``: the case's returned dict."""
    v, o = res["pfcs_vec"], res["pfcs_scalar"]
    for key, what in (("parity", "tenanted vectorized cache diverged from "
                                 "the scalar oracle"),
                      ("tenant_parity", "per-tenant stats diverged between "
                                        "vec and scalar"),
                      ("prefetch_log", "tenanted caches issued different "
                                       "prefetches")):
        if v[key] != o[key]:
            raise AssertionError(what)
    if v["registry_scans"]:
        raise AssertionError("tenanted vectorized touch path performed a "
                             "registry scan")
    for name, r in res.items():
        if r["cross_tenant_prefetches"]:
            raise AssertionError(f"{name}: cross-tenant prefetch issued")
        if not r["occupancy_ok"]:
            raise AssertionError(f"{name}: quota exceeded")
    pages = v["_pages"]
    rep = pages.namespace.check_isolation(pages.registry, pairwise_gcd=smoke)
    if not rep.ok:
        raise AssertionError(f"isolation violated: {rep.violations}")
    rates = v["tenant_tok_per_s"]
    fairness = max(rates) / max(min(rates), 1e-9)
    hot_quota = tenancy_protection(True, device=device)
    hot_shared = tenancy_protection(False, device=device)
    n_cold = tenancy_config(smoke)["n_cold"]
    names = (["hot"] + [f"cold{i}" for i in range(1, 1 + n_cold)]
             + ["scanner"])
    out = {k: {kk: vv for kk, vv in r.items()
               if kk not in TENANCY_TRAIL + ("_pages",)}
           for k, r in res.items()}
    out.update(fairness_ratio=fairness, tenant_names=names,
               isolation_composites=rep.n_composites,
               coprime_pairs_checked=rep.coprime_pairs_checked,
               protection=dict(quota_hit=hot_quota, shared_hit=hot_shared))
    return out


# --------------------------------------------------------------------------- #
# cross-tenant COW dedup: case_dedup                                          #
# --------------------------------------------------------------------------- #

#: nominal KV megabytes per page: 4 tokens x (K+V) x 4096 hidden x fp16 (a
#: fixed scale factor, not a measurement)
DEDUP_PAGE_MB = 4 * 2 * 4096 * 2 / 2**20


@dataclass
class DedupTrace:
    """``case_dedup``'s arrivals ``(tick, prompt, max_new, tenant)``, its
    tenant count and HBM pages."""

    n_tenants: int
    hbm: int
    arrivals: List[Tuple[int, List[int], int, int]]


def dedup_trace(smoke: bool) -> DedupTrace:
    """Every user of every tenant resends one of two system prompts
    verbatim plus a short unique suffix (seed 0): smoke 3 tenants x 4
    requests, 30 HBM pages, 32-token prompts; full 6 x 10, 84 pages, 64
    tokens; request ``i`` (tenant ``i % tenants``) arrives at tick
    ``i // tenants``."""
    if smoke:
        T, req_per_tenant, hbm, sys_tok, max_new = 3, 4, 30, 32, 6
    else:
        T, req_per_tenant, hbm, sys_tok, max_new = 6, 10, 84, 64, 8
    n_prompts = 2
    rng = np.random.default_rng(0)
    prompts = [list(rng.integers(0, 30_000, size=sys_tok))
               for _ in range(n_prompts)]
    arrivals = []
    for i in range(T * req_per_tenant):
        sysp = prompts[(i // T) % n_prompts]
        tail = list(rng.integers(0, 30_000, size=int(rng.integers(4, 13))))
        arrivals.append((i // T, sysp + tail, max_new, i % T))
    return DedupTrace(T, hbm, arrivals)


def dedup_run(tr: DedupTrace, engine: str, kv: str, dedup: bool,
              shards: int = 2, max_bits: int = 62,
              device="cuda") -> Dict[str, object]:
    """One ``case_dedup`` slot-machine run (``engine`` ``"SlotMachine"``
    or ``"SlotOracle"``; 8 slots, 4-token pages, prefetch budget 2,
    8-token prefill chunks, ``tenants=`` the trace's tenant count): the
    reference's run dict (latency report, charged HBM pages per user,
    unique pages, ``DEDUP_COUNTERS``, the tier log, ``_pages``; with
    dedup its twin state, probes and shared occupancy) and every
    request's tick timings (``timings``).  The wall waits for the card."""
    from repro_torch.serving import slots
    from repro_torch.serving.dedup import DEDUP_COUNTERS

    dev = resolve_device(device)
    eng = getattr(slots, engine)(
        max_batch=8, page_size=4, hbm_pages=tr.hbm, prefetch_budget=2,
        reread_window=2, prefill_tokens=8, kv=kv, tenants=tr.n_tenants,
        dedup=dedup, shards=shards, max_bits=max_bits, device=dev)
    for arrival, prompt, new, t in tr.arrivals:
        eng.submit(list(prompt), max_new_tokens=new, tenant=t,
                   arrival=arrival)
    _sync(dev)
    t0 = time.perf_counter()
    eng.run_until_idle()
    _sync(dev)
    wall = time.perf_counter() - t0
    rep = eng.latency_report()
    pages = eng.pages
    per_user = [float(x) for x in (pages.charged_shares() if dedup
                                   else pages.qos.occupancy)]
    out = dict(
        wall_s=wall, completed=rep["completed"], ticks=rep["ticks"],
        ttft_ticks=rep["ttft_ticks"], tpot_ticks=rep["tpot_ticks"],
        hbm_pages_per_user=per_user,
        hbm_mb_per_user=[x * DEDUP_PAGE_MB for x in per_user],
        mean_pages_per_user=float(np.mean(per_user)),
        unique_pages=int(pages._next_page),
        counters={f: getattr(pages.stats, f) for f in DEDUP_COUNTERS},
        cross_tenant_prefetches=pages.cross_tenant_prefetches(),
        tier_log=tuple(eng.tier_log),
        timings=[(r.first_tick, r.done_tick, r.preemptions)
                 for r in eng.requests],
        _pages=pages)
    if dedup:
        out.update(dedup_state=pages.dedup_state(),
                   dedup_probes=int(pages.dedup_probes),
                   shared_occupancy=int(pages.qos.shared_occupancy))
    return out


def case_dedup(smoke: bool = False, device="cuda") -> Dict[str, object]:
    """``benchmarks/cases.py::case_dedup`` on the port: the shared-system-
    prompt trace through ``dedup_vec`` (``SlotMachine``, ``kv="vec"``),
    ``dedup_scalar`` (``SlotOracle``, the scalar dedup oracle) and
    ``nodedup_vec``, with the reference's asserts: the dedup machine
    bit-exact against the oracle (``DEDUP_COUNTERS``, tier log, refcount
    state), hits, promotions and copies-on-write all above 0, zero
    cross-tenant prefetches, every request completed, ``check_isolation``
    green with shared composites, and dedup strictly lowering the mean
    charged HBM pages per user and the median TTFT.  Every admission with
    a live co-referencing request runs the gcd probe (``shared_prefix``:
    the batched gcd and the squarefree factorization on ``device``).
    Returns the reference's dict; :func:`bench_payload` gives the keys
    of ``BENCH_case_dedup.json``."""
    dev = resolve_device(device)
    tr = dedup_trace(smoke)
    res = {"dedup_vec": dedup_run(tr, "SlotMachine", "vec", True, device=dev),
           "dedup_scalar": dedup_run(tr, "SlotOracle", "scalar", True,
                                     device=dev),
           "nodedup_vec": dedup_run(tr, "SlotMachine", "vec", False,
                                    device=dev)}
    return check_dedup(res, tr, smoke)


def check_dedup(res: Dict[str, dict], tr: DedupTrace,
                smoke: bool) -> Dict[str, object]:
    """``case_dedup``'s asserts over its three runs (``dedup_vec``,
    ``dedup_scalar``, ``nodedup_vec``, as :func:`dedup_run` returns them;
    their pages, tier logs and timings are dropped from ``res``): the
    case's returned dict."""
    a, b, nd = res["dedup_vec"], res["dedup_scalar"], res["nodedup_vec"]
    for key, what in (("counters", "dedup slot machine diverged from the "
                                   "scalar dedup oracle"),
                      ("tier_log", "dedup tier logs diverged"),
                      ("dedup_state", "dedup refcount state diverged")):
        if a[key] != b[key]:
            raise AssertionError(what)
    for key in ("dedup_hits", "dedup_promotions", "cow_copies"):
        if a["counters"][key] <= 0:
            raise AssertionError(f"dedup run had no {key}")
    for name, r in res.items():
        if r["cross_tenant_prefetches"]:
            raise AssertionError(f"{name}: cross-tenant prefetch issued")
        if r["completed"] != len(tr.arrivals):
            raise AssertionError(f"{name}: {r['completed']} of "
                                 f"{len(tr.arrivals)} requests completed")
    # the headline claims: dedup strictly lowers both the charged HBM
    # footprint per user and the median TTFT
    if a["mean_pages_per_user"] >= nd["mean_pages_per_user"]:
        raise AssertionError("dedup failed to reduce charged HBM pages per "
                             "user")
    if a["ttft_ticks"][50] >= nd["ttft_ticks"][50]:
        raise AssertionError("dedup failed to reduce median TTFT")
    pages = a["_pages"]
    rep = pages.namespace.check_isolation(pages.registry, pairwise_gcd=smoke)
    if not rep.ok:
        raise AssertionError(f"isolation violated: {rep.violations}")
    if rep.n_shared <= 0:
        raise AssertionError("dedup run must produce shared composites")
    for r in res.values():
        for key in ("_pages", "tier_log", "timings"):
            r.pop(key)
    hbm_saving = 1 - a["mean_pages_per_user"] / nd["mean_pages_per_user"]
    ttft_saving = 1 - a["ttft_ticks"][50] / max(nd["ttft_ticks"][50], 1e-9)
    return dict(res, hbm_saving=hbm_saving, ttft_saving=ttft_saving,
                n_shared_composites=rep.n_shared, page_mb=DEDUP_PAGE_MB)


# --------------------------------------------------------------------------- #
# Table 1: run_table1                                                         #
# --------------------------------------------------------------------------- #

#: ``benchmarks/table1.py``'s level capacities and systems (lines 27-28)
TABLE1_CAPS = (("L1", 64), ("L2", 256), ("L3", 2048))
TABLE1_SYSTEMS = ("lru", "arc", "lirs", "semantic", "pfcs")
#: the paper's Table 1 (``benchmarks/table1.py``'s ``PAPER``)
TABLE1_PAPER = {
    "lru": dict(hit=87.3, lat=0.0, pow=0.0, acc=None),
    "arc": dict(hit=91.2, lat=12.1, pow=6.8, acc=None),
    "lirs": dict(hit=92.4, lat=15.7, pow=8.2, acc=None),
    "semantic": dict(hit=94.1, lat=22.3, pow=11.5, acc=86.4),
    "pfcs": dict(hit=98.9, lat=41.2, pow=38.1, acc=100.0),
}


def table1_workloads(scale: float = 1.0) -> Dict[str, Tuple[str, dict]]:
    """``benchmarks/table1.py``'s workloads (lines 40-55): generator name
    in ``repro_torch.core.traces`` and its arguments but the seed;
    ``scale`` stretches trace length only (the key space stays fixed)."""
    return {
        "db_join": ("db_join_trace", dict(
            n_orders=4000, n_customers=600, n_items=1200,
            n_queries=int(20000 * scale))),
        "ml_epoch": ("ml_epoch_trace", dict(
            n_samples=2500, n_feature_rows=600,
            n_epochs=max(1, int(round(3 * scale))))),
        "hft": ("hft_trace", dict(
            n_instruments=2500, n_corr_groups=350,
            n_events=int(20000 * scale))),
    }


def _agg(values) -> Tuple[float, float]:
    a = np.asarray(list(values), dtype=np.float64)
    return float(a.mean()), float(a.std(ddof=1)) if len(a) > 1 else 0.0


def run_table1(n_trials: int = 5, seed0: int = 0, device="cuda",
               trace_scale: float = 1.0,
               systems: Tuple[str, ...] = TABLE1_SYSTEMS,
               discover: str = "host") -> Dict[str, object]:
    """``benchmarks/table1.py::run`` on the port: each workload's
    ``n_trials`` traces (seeds ``seed0``...) through every system, the
    engine's systems with one ``simulate_batch`` launch per workload (on a
    card, one engine kernel launch), PFCS's tables built by
    ``pfcs_tables`` with ``discover`` (``"host"``, as ``run`` builds them;
    ``"kernel"`` runs the flat mask and factorization kernels on
    ``device`` and gives the same counters but no Pollard-rho count in
    ``factor_ops``, as in the reference), the semantic baseline by its
    scalar simulator, then ``derive_table1_row`` of each trial against
    LRU (``systems`` must hold ``"lru"``).  Returns the
    reference's table: per system ``hit``, ``lat``, ``pow`` as (mean,
    std), ``acc``, ``speedup`` and ``paper`` (None for a system the paper
    does not list), ``_wall_s`` (host seconds per workload and system,
    PFCS's table build included) and ``_trace_scale``; and ``_runs``, per
    workload the traces, PFCS's tables, their build seconds and each
    system's ``AccessStats`` and engine wall (``wall_s``, without the
    table build), in run order."""
    from repro_torch.core import (derive_table1_row, simulate_semantic,
                                  traces as trace_gens)
    from repro_torch.core.engine import (VECTORIZED_SYSTEMS, pfcs_tables,
                                         simulate_batch)
    from repro_torch.core.engine.batch import key_space

    if "lru" not in systems:
        raise ValueError("Table 1's rows are relative to LRU: systems must "
                         "hold 'lru'")
    dev = resolve_device(device)
    rows = {s: {"hit": [], "lat": [], "pow": [], "acc": [], "speed": []}
            for s in systems}
    wall: Dict[str, float] = {}
    runs: Dict[str, dict] = {}
    for wname, (gen, kw) in table1_workloads(trace_scale).items():
        traces = [getattr(trace_gens, gen)(seed=seed0 + t, **kw)
                  for t in range(n_trials)]
        tables, table_s = None, 0.0
        per_system, walls = {}, {}
        for s in systems:
            if s == "pfcs":
                n_keys = key_space(traces)
                t0 = time.perf_counter()
                tables = [pfcs_tables(tr, TABLE1_CAPS, discover=discover,
                                      n_keys=n_keys, device=dev)
                          for tr in traces]
                _sync(dev)
                table_s = time.perf_counter() - t0
            _sync(dev)
            t0 = time.perf_counter()
            if s in VECTORIZED_SYSTEMS:
                stats = simulate_batch(traces, s, TABLE1_CAPS, device=dev,
                                       tables=tables if s == "pfcs"
                                       else None)
            elif s == "semantic":
                stats = [simulate_semantic(tr, TABLE1_CAPS, seed=seed0 + t)
                         for t, tr in enumerate(traces)]
            else:
                raise ValueError(f"Table 1 has no system {s!r}")
            _sync(dev)
            walls[s] = time.perf_counter() - t0
            per_system[s] = stats
            wall[f"{wname}.{s}"] = walls[s] + (table_s if s == "pfcs"
                                               else 0.0)
        runs[wname] = dict(traces=traces, tables=tables, table_s=table_s,
                           stats=per_system, wall_s=walls)
        for t in range(n_trials):
            base = per_system["lru"][t]
            for s in systems:
                row = derive_table1_row(per_system[s][t], base)
                rows[s]["hit"].append(row["hit_rate_pct"])
                rows[s]["lat"].append(row["latency_reduction_pct"])
                rows[s]["pow"].append(row["power_reduction_pct"])
                rows[s]["speed"].append(row["speedup"])
                if row["relationship_accuracy_pct"] is not None:
                    rows[s]["acc"].append(row["relationship_accuracy_pct"])
    table: Dict[str, object] = {}
    for s in systems:
        r = rows[s]
        table[s] = dict(hit=_agg(r["hit"]), lat=_agg(r["lat"]),
                        pow=_agg(r["pow"]),
                        acc=_agg(r["acc"])[0] if r["acc"] else None,
                        speedup=_agg(r["speed"])[0],
                        paper=TABLE1_PAPER.get(s))
    table["_wall_s"] = wall
    table["_trace_scale"] = trace_scale
    table["_runs"] = runs
    return table


# --------------------------------------------------------------------------- #
# BENCH_*.json payloads and the runner                                        #
# --------------------------------------------------------------------------- #

def bench_payload(name: str, out: Dict[str, object]) -> Dict[str, object]:
    """What the reference's ``save_bench`` writes for case ``name``
    (``"case_serving"``, ...) from the case's returned dict: the keys
    ``tools/check_bench_regression.py`` compares."""
    if name == "case_serving":
        runs = {k: v for k, v in out.items() if isinstance(v, dict)}
        payload = {key: {k: r[key] for k, r in runs.items()}
                   for key in ("wall_s", "tok_per_s", "hbm_hit_rate",
                               "prefetch_hit_rate", "registry_scans")}
        payload["vec_vs_scalar_speedup"] = out["vec_vs_scalar_speedup"]
        return payload
    if name == "case_batching":
        return {config: dict(
            completed=r["completed"], tokens=r["tokens"], ticks=r["ticks"],
            goodput_tok_per_tick=r["goodput_tok_per_tick"],
            ttft_ticks={str(q): x for q, x in r["ttft_ticks"].items()},
            tpot_ticks={str(q): x for q, x in r["tpot_ticks"].items()},
            preemptions=r["preemptions"], resumes=r["resumes"],
            peak_in_flight=r["peak_in_flight"],
            hbm_hit_rate=r["hbm_hit_rate"],
            prefetch_hit_rate=r["prefetch_hit_rate"], wall_s=r["wall_s"])
            for config, r in out.items() if isinstance(r, dict)}
    if name == "case_moe":
        caches = ("pfcs_vec", "pfcs_scalar", "lru")
        payload = {key: {k: out[k][key] for k in caches}
                   for key in ("hbm_hit_rate", "demand_misses",
                               "prefetch_precision", "registry_scans")}
        payload["engine_loadgen"] = {
            k: out["engine_loadgen"][k]
            for k in ("completed", "expert_hit_rate", "expert_misses",
                      "prefetch_precision", "registry_scans")}
        payload["vec_vs_scalar_speedup"] = out["vec_vs_scalar_speedup"]
        return payload
    if name == "case_tenancy":
        v = out["pfcs_vec"]
        payload = {k: v[k] for k in ("tenant_hit_rate", "tenant_evictions",
                                     "cross_tenant_prefetches", "completed",
                                     "registry_scans", "quota")}
        payload.update(isolation_composites=out["isolation_composites"],
                       protection=dict(out["protection"]))
        return payload
    if name == "case_dedup":
        a, nd = out["dedup_vec"], out["nodedup_vec"]
        return {
            "counters": dict(a["counters"]),
            "dedup_state_refs": {str(k): v for k, v in
                                 a["dedup_state"]["refs"].items()},
            "dedup_probes": a["dedup_probes"],
            "shared_occupancy": a["shared_occupancy"],
            "hbm_pages_per_user_dedup": a["hbm_pages_per_user"],
            "hbm_pages_per_user_nodedup": nd["hbm_pages_per_user"],
            "unique_pages": {"dedup": a["unique_pages"],
                             "nodedup": nd["unique_pages"]},
            "ttft_ticks": {k: {str(q): x for q, x in r["ttft_ticks"].items()}
                           for k, r in (("dedup", a), ("nodedup", nd))},
            "completed": a["completed"],
            "n_shared_composites": out["n_shared_composites"]}
    if name in ("case_elastic", "case_scale"):
        return dict(out)
    raise ValueError(f"no BENCH payload for {name!r}")


#: the runner's cases, in run order
CASES = ("serving", "batching", "elastic", "moe", "tenancy", "dedup",
         "scale")
#: the runner's default output directory (gitignored)
DEFAULT_OUT = "bench_torch"


def run_case(case: str, full: bool, device="cuda") -> Dict[str, object]:
    """One case at its smoke size (``full``: the published one, with
    ``case_moe``'s real-router block on, as the reference runs it)."""
    smoke = not full
    if case == "serving":
        return case_serving(smoke=smoke, device=device)
    if case == "batching":
        return case_batching(smoke=smoke, device=device)
    if case == "elastic":
        return case_elastic(smoke=smoke, device=device)
    if case == "moe":
        return case_moe(smoke=smoke, device=device)
    if case == "tenancy":
        return case_tenancy(smoke=smoke, device=device)
    if case == "dedup":
        return case_dedup(smoke=smoke, device=device)
    if case == "scale":
        return case_scale(n_verify_chains=24 if smoke else 64,
                          device=device)
    raise ValueError(f"unknown case {case!r}; choose from {CASES}")


def main(argv=None) -> int:
    """``python -m repro_torch.cases --out DIR [--full] [--cases ...]
    [--device ...]``: runs the cases and writes ``BENCH_case_<name>.json``
    into ``DIR``, which ``tools/check_bench_regression.py --baseline
    <copies of the checked-in files> --fresh DIR`` compares."""
    import argparse
    import json
    from pathlib import Path

    ap = argparse.ArgumentParser(description=main.__doc__)
    ap.add_argument("--out", default=DEFAULT_OUT,
                    help=f"output directory (default {DEFAULT_OUT}/)")
    ap.add_argument("--full", action="store_true",
                    help="the published sizes instead of the smoke ones "
                         "(the checked-in files are the smoke sizes')")
    ap.add_argument("--cases", nargs="+", choices=CASES, default=list(CASES))
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (the default) or 'cpu' for the kernels' "
                         "plain versions")
    args = ap.parse_args(argv)
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    for case in args.cases:
        t0 = time.perf_counter()
        out = run_case(case, args.full, device=args.device)
        name = f"case_{case}"
        path = out_dir / f"BENCH_{name}.json"
        path.write_text(json.dumps(bench_payload(name, out), indent=1,
                                   default=float, sort_keys=True) + "\n")
        print(f"{name}: {time.perf_counter() - t0:.2f} s -> {path}",
              flush=True)
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
