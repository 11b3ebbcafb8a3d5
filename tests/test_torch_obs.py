"""The port's observability layer (``repro_torch.obs``) on the CPU against
the reference's (``repro.obs``).

  * **Event streams** — the same arrival trace through the port's and the
    reference's ``SlotMachine`` / ``SlotOracle`` with ``kv="vec"``,
    ``"scalar"``, ``"sharded"`` and ``"elastic"`` gives streams that
    ``trace_diff`` finds identical (kinds, lanes and order), across the
    packages and across the twins.
  * **Inertness** — ``obs=None``, a zero-capacity tracer and a live
    tracer leave the port's placement byte-identical, and equal to the
    reference's.
  * **Dedup streams** — the reference's dedup backends (``kv="vec"`` and
    ``"scalar"`` with ``tenants=2, dedup=True``) on a two-tenant trace:
    the ``EV_DEDUP_HIT`` / ``EV_DEDUP_PROMOTE`` / ``EV_COW`` streams, and a
    drive that ages shared pages out (``EV_AGE_OUT``), equal the
    reference's under ``trace_diff``; tracing stays inert.
  * **Telemetry** — the gauge rings and histograms of a slot-machine run
    and of a ``ServingEngine`` run equal the reference's.
  * **Kernel ledger** — every wrapper (and the per-shard gcd exchange)
    records the reference's ``calls`` and ``items`` for the same inputs,
    and the ledger's calls equal the wrappers' launch counts.
  * **Export** — ``Observability.export_json`` goes through
    ``tools/trace_view.py`` unchanged.

The port runs with ``device="cpu"`` (the kernels' plain versions).
"""

import torch_parity  # noqa: F401

import json
import sys
from pathlib import Path

import numpy as np
import pytest

from strategies import ArrivalSpec, build_poisson_arrivals, drive_slots
from repro import obs as ref_obs
from repro.kernels import ops as ref_ops
from repro.serving import slots as ref_slots
from repro.serving.engine import ServingEngine as RefEngine
from repro.serving.kv_cache_sharded import ShardedPagedKVCache as RefSharded
from repro_torch import obs
from repro_torch.kernels import ops
from repro_torch.obs import (EV_AGE_OUT, EV_COW, EV_DEDUP_HIT,
                             EV_DEDUP_PROMOTE, EV_GCD_EXCHANGE, EV_RECOVERY,
                             Observability, attach, profile, trace_diff)
from repro_torch.obs.telemetry import Progress, StreamingHist, Telemetry
from repro_torch.obs.trace import EventTracer
from repro_torch.serving import slots
from repro_torch.serving.elastic import ElasticShardedPagedKVCache
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.kv_cache import PARITY_COUNTERS
from repro_torch.serving.kv_cache_sharded import ShardedPagedKVCache

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))

from trace_view import convert  # noqa: E402

#: the reference's golden run (tests/test_obs.py)
GOLDEN_SPEC = ArrivalSpec(seed=5, n_requests=10, rate=1.2, max_prompt=16,
                          max_new=6, shared_pool=8)
SWEEP_SPEC = ArrivalSpec(seed=11, n_requests=18, rate=1.6, burst_frac=0.2,
                         max_prompt=22, max_new=8, shared_pool=12)
CFG = dict(max_batch=4, page_size=4, hbm_pages=24, prefetch_budget=2,
           reread_window=2, prefill_tokens=12, preempt_wait=3)
KVS = ("vec", "scalar", "sharded", "elastic")
TWINS = ("SlotMachine", "SlotOracle")


#: a two-tenant trace sharing prompt prefixes across tenants (the dedup
#: slot-machine case of ``tests/test_dedup.py``)
DEDUP_SPEC = ArrivalSpec(seed=5, n_requests=18, rate=1.5, max_prompt=24,
                         max_new=8, shared_pool=16, n_tenants=2)
#: the reference's dedup backends (``tests/test_obs.py``'s sweep)
DEDUP_KVS = ("vec", "scalar")


def _drive(pkg, cls, kv, spec, ob, dedup=False):
    kw = dict(device="cpu") if pkg is slots else {}
    if dedup:
        kw.update(tenants=2, dedup=True)
    eng = getattr(pkg, cls)(kv=kv, obs=ob, **CFG, **kw)
    drive_slots(eng, build_poisson_arrivals(spec))
    return eng


def _placement(eng):
    return (tuple(getattr(eng.pages.stats, f) for f in PARITY_COUNTERS),
            tuple(eng.tier_log), tuple(eng.pages.hbm.items()),
            frozenset(eng.pages.host), tuple(eng.pages.prefetch_log),
            tuple(tuple(r.generated) for r in eng.requests),
            tuple((r.first_tick, r.done_tick, r.preemptions)
                  for r in eng.requests))


# --------------------------------------------------------------------------- #
# event streams                                                               #
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("cls", TWINS)
@pytest.mark.parametrize("kv", KVS)
def test_event_streams_equal_the_reference(cls, kv):
    """The port's stream equals the reference's for the same drive, event
    for event, and the port's twins agree with each other."""
    port = Observability(trace_capacity=8192)
    ref = ref_obs.Observability(trace_capacity=8192)
    _drive(slots, cls, kv, GOLDEN_SPEC, port)
    _drive(ref_slots, cls, kv, GOLDEN_SPEC, ref)
    assert port.trace.total > 0
    assert trace_diff(port.trace, ref.trace) is None
    other = Observability(trace_capacity=8192)
    _drive(slots, TWINS[1 - TWINS.index(cls)], kv, GOLDEN_SPEC, other)
    assert trace_diff(port.trace, other.trace) is None


def test_trace_diff_finds_a_changed_lane():
    """A stream that differs from the reference's in one lane of one
    event is found at that event."""
    port = Observability(trace_capacity=8192)
    ref = ref_obs.Observability(trace_capacity=8192)
    _drive(slots, "SlotMachine", "vec", GOLDEN_SPEC, port)
    _drive(ref_slots, "SlotMachine", "vec", GOLDEN_SPEC, ref)
    port.trace.buf[7, 4] += 1                        # the page lane
    i, a, b = trace_diff(port.trace, ref.trace)
    assert i == 7 and a.page == b.page + 1


# --------------------------------------------------------------------------- #
# inertness                                                                   #
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("cls", TWINS)
@pytest.mark.parametrize("kv", KVS)
def test_tracing_is_inert_and_placement_equals_the_reference(cls, kv):
    """obs=None, a zero-capacity tracer and a live tracer with telemetry
    give the same placement, equal to the reference's; the zero-capacity
    tracer counts what the live one records."""
    base = _placement(_drive(slots, cls, kv, SWEEP_SPEC, None))
    zero = Observability(trace_capacity=0, telemetry=False)
    live = Observability(trace_capacity=4096)
    assert _placement(_drive(slots, cls, kv, SWEEP_SPEC, zero)) == base
    eng = _drive(slots, cls, kv, SWEEP_SPEC, live)
    assert _placement(eng) == base
    assert live.trace.total > 0 and zero.trace.total == live.trace.total
    assert live.telemetry.ticks_seen == eng.ticks
    assert _placement(_drive(ref_slots, cls, kv, SWEEP_SPEC, None)) == base


# --------------------------------------------------------------------------- #
# dedup streams                                                               #
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("cls", TWINS)
@pytest.mark.parametrize("kv", DEDUP_KVS)
def test_dedup_event_streams_equal_the_reference(cls, kv):
    """With ``tenants=2, dedup=True`` the port's stream, with its dedup
    hits, promotions and copies-on-write, equals the reference's and the
    other twin's."""
    port = Observability(trace_capacity=8192)
    ref = ref_obs.Observability(trace_capacity=8192)
    _drive(slots, cls, kv, DEDUP_SPEC, port, dedup=True)
    _drive(ref_slots, cls, kv, DEDUP_SPEC, ref, dedup=True)
    kinds = {e.kind for e in port.trace.events()}
    assert {EV_DEDUP_HIT, EV_DEDUP_PROMOTE, EV_COW} <= kinds
    assert trace_diff(port.trace, ref.trace) is None
    other = Observability(trace_capacity=8192)
    _drive(slots, TWINS[1 - TWINS.index(cls)], kv, DEDUP_SPEC, other,
           dedup=True)
    assert trace_diff(port.trace, other.trace) is None


@pytest.mark.parametrize("cls", TWINS)
@pytest.mark.parametrize("kv", DEDUP_KVS)
def test_dedup_tracing_is_inert(cls, kv):
    """The inertness sweep over the dedup backends: ``obs=None``, a
    zero-capacity and a live tracer place alike, as the reference does."""
    base = _placement(_drive(slots, cls, kv, DEDUP_SPEC, None, dedup=True))
    zero = Observability(trace_capacity=0, telemetry=False)
    live = Observability(trace_capacity=4096)
    assert _placement(_drive(slots, cls, kv, DEDUP_SPEC, zero,
                             dedup=True)) == base
    eng = _drive(slots, cls, kv, DEDUP_SPEC, live, dedup=True)
    assert _placement(eng) == base
    assert live.trace.total == zero.trace.total > 0
    assert eng.pages.dedup_state()["probes"] > 0
    assert _placement(_drive(ref_slots, cls, kv, DEDUP_SPEC, None,
                             dedup=True)) == base


@pytest.mark.parametrize("kv", DEDUP_KVS)
def test_age_out_stream_equals_the_reference(kv):
    """Shared pages whose references are gone are evicted by new shared
    content and age out: the stream with its ``EV_AGE_OUT`` events equals
    the reference's."""
    from repro.serving.engine import make_kv_backend as ref_backend
    from repro_torch.serving.engine import make_kv_backend

    traces = []
    for make, ob, kw in ((make_kv_backend, Observability(), {"device":
                                                             "cpu"}),
                         (ref_backend, ref_obs.Observability(), {})):
        c = make(kv, hbm_pages=9, page_size=2, prefetch_budget=0, tenants=2,
                 dedup=True, **kw)
        c.obs = ob
        prompt = list(range(10))
        c.register_request(0, prompt + [100, 101], tenant=0)
        c.register_request(1, prompt + [200, 201], tenant=1)
        c.touch_batch([(1, j) for j in range(5)])
        c.release_request(0)
        c.release_request(1)
        fresh = [p + 500 for p in prompt]
        c.register_request(2, fresh + [300, 301], tenant=0)
        c.register_request(3, fresh + [400, 401], tenant=1)
        c.touch_batch([(3, j) for j in range(5)])
        c.register_request(4, prompt + [999], tenant=0)
        traces.append(ob.trace)
    assert EV_AGE_OUT in {e.kind for e in traces[0].events()}
    assert trace_diff(traces[0], traces[1]) is None


# --------------------------------------------------------------------------- #
# telemetry                                                                   #
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("kv", ["vec", "sharded", "elastic"])
def test_slot_telemetry_equals_the_reference(kv):
    """Gauge rings (queue depth, phase mix, cache counters, the sharded
    caches' scan slices) and histograms of a slot-machine run equal the
    reference's."""
    port = Observability(telemetry_capacity=64)
    ref = ref_obs.Observability(telemetry_capacity=64)
    _drive(slots, "SlotMachine", kv, SWEEP_SPEC, port)
    _drive(ref_slots, "SlotMachine", kv, SWEEP_SPEC, ref)
    got, want = port.telemetry.export(), ref.telemetry.export()
    assert got == want
    if kv != "vec":
        assert "scan_slice_peak" in got["gauges"]


@pytest.mark.parametrize("kv", ["vec", "sharded"])
def test_engine_telemetry_and_events_equal_the_reference(kv):
    """``ServingEngine.step`` snapshots the engine every step, as the
    reference's does; its gauges and its events equal the reference's."""
    def run(cls, ob, **kw):
        rng = np.random.default_rng(4)
        eng = cls(None, None, max_batch=4, page_size=4, hbm_pages=12,
                  kv=kv, reread_window=2, obs=ob, **kw)
        shared = list(rng.integers(0, 500, size=12))
        for _ in range(10):
            eng.submit(shared[:int(rng.integers(0, 12))]
                       + list(rng.integers(0, 500, size=8)),
                       max_new_tokens=3)
        eng.run_until_idle()
        return eng

    port, ref = Observability(), ref_obs.Observability()
    eng = run(ServingEngine, port, device="cpu")
    run(RefEngine, ref)
    assert port.telemetry.ticks_seen == eng.steps > 0
    assert port.telemetry.export() == ref.telemetry.export()
    assert trace_diff(port.trace, ref.trace) is None


def test_telemetry_primitives_match_the_reference():
    """The copied histogram, gauge ring and progress reporter answer as
    the reference's do."""
    values = [0, 1, 1, 2, 3, 7, 8, 100, 4096]
    h, rh = StreamingHist(), ref_obs.StreamingHist()
    for v in values:
        h.add(v)
        rh.add(v)
    assert h.summary() == rh.summary()
    assert [h.quantile(q) for q in (0.0, 0.5, 0.99)] == \
        [rh.quantile(q) for q in (0.0, 0.5, 0.99)]
    t, rt = Telemetry(capacity=4), ref_obs.Telemetry(capacity=4)
    for i in range(10):
        t.gauge("x", i, tick=i)
        rt.gauge("x", i, tick=i)
        t.observe("lat", i)
        rt.observe("lat", i)
    assert t.export() == rt.export()
    p = Progress(5, label="b", quiet=True)
    for _ in range(5):
        p.advance()
    rep = p.finish()
    assert rep["n"] == 5 and rep["label"] == "b" and rep["per_s"] > 0


# --------------------------------------------------------------------------- #
# kernel ledger                                                               #
# --------------------------------------------------------------------------- #

_C = [6, 10, 15, 77, 2 * 3 * 5 * 7, 1]
_P = [2, 3, 5, 7, 11]
_WIDE = [3 * 2**70, 5 * 2**64 + 5, 7 * 11 * 13]
WRAPPERS = {
    "divisibility_scan": (lambda m, **kw: m.divisibility_scan(_C, _P, **kw)),
    "factorize_batch": (lambda m, **kw: m.factorize_batch(_C, _P, **kw)),
    "gcd_batch": (lambda m, **kw: m.gcd_batch([12, 18, 35], [8, 27, 14],
                                              **kw)),
    "divisibility_scan_limbs": (lambda m, **kw: m.divisibility_scan_limbs(
        _WIDE, [2, 3, 5, 7, 11], **kw)),
    "factorize_batch_limbs": (lambda m, **kw: m.factorize_batch_limbs(
        _WIDE, [2, 3, 5, 7, 11, 13], **kw)),
    "gcd_batch_limbs": (lambda m, **kw: m.gcd_batch_limbs(
        _WIDE, [3 * 2**65, 5, 77], [2, 3, 5, 7, 11, 13], **kw)),
}
#: the CUDA kernel each wrapper launches once a call
LAUNCHES = {"divisibility_scan": "divisibility_mask",
            "factorize_batch": "factorize_squarefree",
            "gcd_batch": "gcd",
            "divisibility_scan_limbs": "divisibility_mask_limbs",
            "factorize_batch_limbs": "factorize_limbs",
            "gcd_batch_limbs": "gcd_limbs"}


def _ledger(mod, fn, **kw):
    mod.reset()
    with mod.profiling():
        for _ in range(2):
            fn(**kw)
    return {k: (v["calls"], v["items"]) for k, v in mod.summary().items()}


@pytest.mark.parametrize("name", sorted(WRAPPERS))
def test_wrapper_ledger_equals_the_reference(name):
    """Each wrapper records the reference's name, calls and items."""
    call = WRAPPERS[name]
    got = _ledger(profile, lambda: call(ops, device="cpu"))
    want = _ledger(ref_obs.profile, lambda: call(ref_ops))
    assert got == want and got[name][0] == 2
    assert not profile.enabled()


def _sharded_refresh(pkg_cache, ob_profile, max_bits, **kw):
    cache = pkg_cache(hbm_pages=16, page_size=4, n_shards=2,
                      max_bits=max_bits, **kw)
    rng = np.random.default_rng(2)
    shared = [int(x) for x in rng.integers(0, 300, size=16)]
    for r in range(6):
        cache.register_request(r, shared[:int(rng.integers(0, 16))]
                               + [int(x) for x in rng.integers(0, 300,
                                                               size=30)])
    ob_profile.reset()
    with ob_profile.profiling():
        cache.refresh_tables()
    return {k: (v["calls"], v["items"])
            for k, v in ob_profile.summary().items()}


@pytest.mark.parametrize("max_bits", [62, 128])
def test_gcd_exchange_ledger_equals_the_reference(max_bits):
    """A sharded refresh records ``sharded_gcd_exchange`` (or its limb
    twin) and the decode's ``factorize_batch`` with the reference's
    calls and items."""
    got = _sharded_refresh(ShardedPagedKVCache, profile, max_bits,
                           device="cpu", mesh=None)
    want = _sharded_refresh(RefSharded, ref_obs.profile, max_bits, mesh=None)
    assert got == want
    exch = ("sharded_gcd_exchange" if max_bits == 62
            else "sharded_gcd_exchange_limbs")
    assert got[exch][0] == 1


@pytest.mark.parametrize("kv", ["sharded", "elastic"])
def test_ledger_calls_equal_launch_counts(monkeypatch, kv):
    """Over a sharded (an elastic, with a shard killed and recovered at
    the end) slot-machine run the ledger's calls equal the launches its
    wrappers made: the plain versions are counted as launches here, as a
    card run counts its kernels; the gcd exchange launches the mask and
    the gcd once a shard."""
    from repro_torch import kernels
    from repro_torch.kernels import factorize, gcd

    for mod, attr, name in ((factorize, "divisibility_mask_ref",
                             "divisibility_mask"),
                            (factorize, "factorize_squarefree_ref",
                             "factorize_squarefree"),
                            (gcd, "gcd_ref", "gcd")):
        orig = getattr(mod, attr)

        def counted(*a, _orig=orig, _name=name):
            kernels.KERNELS[_name].launches += 1
            return _orig(*a)

        monkeypatch.setattr(mod, attr, counted)
    kernels.reset_launch_counts()
    with profile.profiling():
        eng = _drive(slots, "SlotMachine", kv, SWEEP_SPEC, None)
        if kv == "elastic":
            eng.fail_shard(0)
        led = {k: v["calls"] for k, v in profile.summary().items()}
    n = kernels.launch_counts()
    exch = led["sharded_gcd_exchange"] * eng.pages.n_shards
    assert n["divisibility_mask"] == exch + led.get("divisibility_scan", 0)
    assert n["gcd"] == exch + led.get("gcd_batch", 0)
    assert n["factorize_squarefree"] == led.get("factorize_batch", 0)
    assert kv == "sharded" or n["factorize_squarefree"] > 0


def test_kernel_scope_contract():
    """Disabled, a scope records nothing; ``profiling`` collects and
    restores the previous state; the region is a
    ``torch.profiler.record_function`` of the scope's name."""
    import torch

    profile.reset()
    assert not profile.enabled()
    with profile.kernel_scope("noop", items=3):
        pass
    assert profile.summary() == {}
    with profile.profiling():
        with profile.kernel_scope("k", items=5):
            pass
        with profile.kernel_scope("k", items=5):
            pass
    assert not profile.enabled()
    assert profile.summary()["k"]["calls"] == 2
    assert profile.summary()["k"]["items"] == 10
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]) as prof:
        ops.gcd_batch([12], [8], device="cpu")
    assert "gcd_batch" in {e.key for e in prof.key_averages()}


# --------------------------------------------------------------------------- #
# cache events and the export                                                 #
# --------------------------------------------------------------------------- #

def test_cache_events_equal_the_reference():
    """A sharded refresh emits one gcd-exchange event a shard and an
    elastic recovery one recovery event, lane for lane the reference's."""
    from repro.serving.elastic import \
        ElasticShardedPagedKVCache as RefElastic

    def run(sharded, elastic, ob, attach_to, **kw):
        cache = sharded(hbm_pages=16, page_size=4, n_shards=2, mesh=None,
                        **kw)
        attach_to(cache, ob)
        cache.register_request(0, list(range(40)))
        cache.refresh_tables()
        el = elastic(hbm_pages=16, page_size=4, n_shards=2, **kw)
        el.obs = ob
        el.register_request(0, list(range(40)))
        el.touch(0, 0)
        el.fail_shard(1)
        el.recover_shard(1)

    port, ref = Observability(), ref_obs.Observability()
    run(ShardedPagedKVCache, ElasticShardedPagedKVCache, port, attach,
        device="cpu")
    run(RefSharded, RefElastic, ref, ref_obs.attach)
    kinds = [e.kind for e in port.trace.events()]
    assert kinds.count(EV_GCD_EXCHANGE) == 2 and EV_RECOVERY in kinds
    assert trace_diff(port.trace, ref.trace) is None


def test_export_goes_through_trace_view(tmp_path):
    """The port's export has the reference's schema and converts to a
    Chrome trace with instant, counter, span and metadata events."""
    port = Observability(trace_capacity=8192)
    eng = _drive(slots, "SlotMachine", "elastic", GOLDEN_SPEC, port)
    profile.reset()
    with profile.profiling():
        ops.gcd_batch([12, 18], [8, 27], device="cpu")
    path = tmp_path / "obs.json"
    port.export_json(path)
    payload = json.loads(path.read_text())
    ref = ref_obs.Observability(trace_capacity=8192)
    _drive(ref_slots, "SlotMachine", "elastic", GOLDEN_SPEC, ref)
    want = json.loads(json.dumps(ref.export()))
    assert payload["schema"] == want["schema"]
    assert payload["trace"] == want["trace"]
    assert payload["telemetry"]["ticks_seen"] == eng.ticks
    assert payload["kernel_launches"]["gcd_batch"]["items"] == 2
    chrome = convert(payload)
    assert {"i", "C", "X", "M"} <= {e["ph"] for e in chrome["traceEvents"]}
    assert len([e for e in chrome["traceEvents"] if e["ph"] == "i"]) == \
        len(port.trace.events())


def test_the_package_reexports_the_reference_names():
    """``repro_torch.obs`` exports what ``repro.obs`` does, and the
    tracer is the port's own class."""
    assert set(obs.__all__) == set(ref_obs.__all__)
    assert obs.EventTracer is EventTracer
    assert obs.EVENT_NAMES == ref_obs.EVENT_NAMES
