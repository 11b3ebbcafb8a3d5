"""The port's boundaries: it imports neither JAX nor the reference, its
entry points default to the card and raise without one, the parts of
the reference it does not have yet raise ``NotImplementedError`` naming
the ROADMAP.md item that ports them (wide registries no longer do), and
``chip_smoke.py`` exits non-zero without a card and names the phase
that failed."""

import torch_parity  # noqa: F401

import json
import os
import subprocess
import sys

import pytest
import torch

from repro_torch.core.engine.shard import (PrimeSpacePartition,
                                           sharded_successor_table)
from repro_torch.core import (db_join_trace, fast_lru_hit_rate,
                              run_all_systems)
from repro_torch.core.engine import simulate_batch, simulate_trace, sweep
from repro_torch.core.engine.tables import (make_pfcs_cache, pfcs_tables,
                                            related_bulk, successor_table)
from repro_torch.kernels import ops
from repro_torch.launch import serve
from repro_torch.serving.engine import ServingEngine, make_kv_backend
from repro_torch.serving.kv_cache import PagedKVCache
from repro_torch.serving.kv_cache_sharded import ShardedPagedKVCache
from repro_torch.serving.kv_cache_vec import VectorizedPagedKVCache
from repro_torch.serving.slots import SlotMachine, SlotOracle

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")

_IMPORT_ALL = """
import importlib, pkgutil, sys
sys.modules["jax"] = sys.modules["repro"] = None   # importing either raises
import chip_smoke
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m, mod in sys.modules.items() if mod is not None
             and (m == "jax" or m.startswith("jax.") or m == "repro"
                  or m.startswith("repro.")))
print(len(names), bad)
assert not bad, bad
assert len(names) >= 20, names
engine = {"repro_torch.core." + m for m in (
    "metrics", "policies", "semantic", "simulator", "engine.layout",
    "engine.policies_vec", "engine.hierarchy", "engine.pfcs_vec",
    "engine.batch")} | {"repro_torch.kernels.engine"}
assert engine <= set(names), sorted(engine - set(names))
"""


def test_port_imports_no_jax_and_no_reference():
    """Every ``repro_torch`` module and ``chip_smoke`` import in a process
    where ``import jax`` and ``import repro`` raise, the trace engine's
    modules among them."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([SRC, ROOT]))
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr + out.stdout


def _cache(cls):
    return lambda **kw: cls(hbm_pages=4, **kw)


ENTRY_POINTS = {
    "ServingEngine": lambda **kw: ServingEngine(None, None, **kw),
    "SlotMachine": lambda **kw: SlotMachine(**kw),
    "SlotOracle": lambda **kw: SlotOracle(**kw),
    "make_kv_backend": lambda **kw: make_kv_backend(
        "sharded", hbm_pages=4, page_size=4, prefetch_budget=1, **kw),
    "PagedKVCache": _cache(PagedKVCache),
    "VectorizedPagedKVCache": _cache(VectorizedPagedKVCache),
    "ShardedPagedKVCache": _cache(ShardedPagedKVCache),
    "successor_table": lambda **kw: successor_table(
        *_registry(), [0], discover="kernel", **kw),
    "sharded_successor_table": lambda **kw: sharded_successor_table(
        *_registry(), [0], PrimeSpacePartition(2), **kw),
    "pfcs_tables": lambda **kw: pfcs_tables(
        _trace(), (("L1", 4),), discover="kernel", **kw),
    "related_bulk": lambda **kw: related_bulk(
        make_pfcs_cache(_trace(), (("L1", 4),)), [0, 1, 2], **kw),
    "divisibility_scan": lambda **kw: ops.divisibility_scan([6], [2], **kw),
    "factorize_batch": lambda **kw: ops.factorize_batch([6], [2], **kw),
    "gcd_batch": lambda **kw: ops.gcd_batch([6], [4], **kw),
    "simulate_batch": lambda **kw: simulate_batch(
        [_trace()], "pfcs", (("L1", 4),), **kw),
    "simulate_trace": lambda **kw: simulate_trace(
        _trace(), "arc", (("L1", 4),), **kw),
    "sweep": lambda **kw: sweep([_trace()], ["lirs"], [(("L1", 4),)], **kw),
    "run_all_systems": lambda **kw: run_all_systems(
        _trace(), (("L1", 4),), systems=("lru",), **kw),
    "fast_lru_hit_rate": lambda **kw: fast_lru_hit_rate([1, 2, 1], 2, **kw),
    "launch.serve": lambda **kw: serve.main(
        ["--null-model", "--requests", "2"]
        + (["--device", kw["device"]] if kw else [])),
}


def _trace():
    return db_join_trace(n_orders=10, n_customers=4, n_items=8,
                         n_queries=40, seed=0)


def _registry():
    cache = PagedKVCache(hbm_pages=4, page_size=2, device="cpu")
    cache.register_request(0, [1, 2, 3, 4, 5])
    return cache.registry, cache.assigner


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_default_device_needs_a_card(name, monkeypatch, capsys):
    """Without CUDA, the default device raises RuntimeError; the same call
    with device="cpu" runs."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ENTRY_POINTS[name]()
    ENTRY_POINTS[name](device="cpu")
    capsys.readouterr()


NOT_PORTED = {
    "kv=elastic": (lambda: ServingEngine(None, None, kv="elastic",
                                         device="cpu"), "A.9"),
    "tenants": (lambda: ServingEngine(None, None, tenants=2, device="cpu"),
                "A.11"),
    "dedup": (lambda: SlotMachine(dedup=True, device="cpu"), "A.12"),
    "moe": (lambda: SlotMachine(moe="vec", device="cpu"), "A.10"),
    "model": (lambda: ServingEngine(object(), None, device="cpu"), "A.14"),
    "mesh": (lambda: ShardedPagedKVCache(mesh=object(), device="cpu"),
             "A.8"),
    "resize": (lambda: SlotMachine(kv="sharded", device="cpu").resize(4),
               "A.9"),
    "fail_shard": (lambda: ServingEngine(None, None, kv="sharded",
                                         device="cpu").fail_shard(0), "A.9"),
    "serve model": (lambda: serve.main(["--device", "cpu"]), "A.14"),
}


@pytest.mark.parametrize("name", sorted(NOT_PORTED))
def test_unported_features_raise(name):
    fn, item = NOT_PORTED[name]
    with pytest.raises(NotImplementedError, match=f"ROADMAP.md {item}"):
        fn()


def test_wide_registries_are_ported():
    """A wide registry (``max_bits > 63``) no longer raises: the cache
    registers a request in multi-limb mode and touches its pages."""
    cache = VectorizedPagedKVCache(max_bits=128, device="cpu")
    pages = cache.register_request(0, list(range(64)))
    assert cache.registry.wide and cache.registry.n_limbs == 4
    assert len(pages) == 4
    assert cache.touch_batch([(0, 0), (0, 0)]) == ["new", "hbm"]


# --------------------------------------------------------------------------- #
# chip_smoke.py                                                               #
# --------------------------------------------------------------------------- #

def _chip_smoke():
    sys.path.insert(0, ROOT)
    try:
        import chip_smoke
    finally:
        sys.path.remove(ROOT)
    return chip_smoke


#: what a ported package exports beyond the reference's ``__all__``
PORT_ADDITIONS = {
    "core": {"state_from_arrays"},
    "core.engine": {"ShardScanReport"},
    "kernels": {"KERNELS", "build_all", "launch_counts",
                "reset_launch_counts", "engine", "factorize", "gcd", "ref"},
    "serving": {"make_kv_backend"},
}
#: the reference's exports the port does not have yet, by the ROADMAP.md
#: queue A item that ports them (``obs``: the whole package, A.13)
NOT_YET = {
    "obs": "A.13",
    "serving": {
        "A.9": {"ElasticController", "ElasticShardedPagedKVCache",
                "RecoveryReport"},
        "A.10": {"EXPERT_PARITY_COUNTERS", "ExpertCache", "ExpertCacheStats",
                 "VectorizedExpertCache"},
        "A.12": {"DEDUP_COUNTERS", "DedupElasticShardedPagedKVCache",
                 "DedupOracle", "DedupShardedPagedKVCache",
                 "DedupVectorizedPagedKVCache"},
    },
}


@pytest.mark.parametrize("package", ["core", "core.engine", "kernels",
                                     "obs", "serving"])
def test_package_exports_match_the_reference(package):
    """Each ported package's ``__all__`` is the reference's, apart from the
    named additions and the names whose ROADMAP item is still open; every
    name it lists imports."""
    import importlib

    ref = importlib.import_module(f"repro.{package}")
    port = importlib.import_module(f"repro_torch.{package}")
    ref_all = set(ref.__all__)
    port_all = set(getattr(port, "__all__", ()))
    missing = NOT_YET.get(package, {})
    if isinstance(missing, str):          # the package is not ported yet
        assert not port_all, (package, missing)
    else:
        assert ref_all - port_all == set().union(*missing.values())
    assert port_all - ref_all == PORT_ADDITIONS.get(package, set())
    assert all(hasattr(port, name) for name in port_all)


def test_kernels_export_the_limb_wrappers():
    """The import ``benchmarks/cases.py`` makes of the reference works
    against the port."""
    from repro_torch.kernels import (divisibility_scan_limbs,
                                     factorize_batch_limbs, gcd_batch_limbs)

    assert (divisibility_scan_limbs, factorize_batch_limbs,
            gcd_batch_limbs) == (ops.divisibility_scan_limbs,
                                 ops.factorize_batch_limbs,
                                 ops.gcd_batch_limbs)


def test_chip_smoke_needs_a_card(monkeypatch, capsys):
    """Without a card ``main()`` exits non-zero and prints no result."""
    chip_smoke = _chip_smoke()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert chip_smoke.main() != 0
    out = capsys.readouterr()
    assert out.out == ""
    assert "is_available() is False" in out.err


def test_chip_smoke_names_the_failed_phase(monkeypatch, capsys):
    """A phase that raises ends the run with one JSON line on stdout that
    names the phase and the error, and exit code 1; no later phase runs
    and no ``ok`` line is printed."""
    chip_smoke = _chip_smoke()
    ran = []

    def ok(ctx):
        ran.append("first")
        return {"fine": True}

    def broken(ctx):
        raise RuntimeError("forced failure")

    def never(ctx):
        ran.append("never")
        return {}

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(chip_smoke, "PHASES", [
        ("first", ok), ("broken", broken), ("never", never)])
    assert chip_smoke.main() == 1
    lines = capsys.readouterr().out.strip().splitlines()
    assert ran == ["first"]
    assert json.loads(lines[0])["phase"] == "first"
    last = json.loads(lines[-1])
    assert last["phase"] == "broken"
    assert last["error"] == "RuntimeError: forced failure"
    assert "forced failure" in last["traceback"]
    assert not any('"ok"' in ln for ln in lines)


def test_chip_smoke_fails_without_the_port(tmp_path):
    """Copied alone into an empty directory, the script fails: without a
    card at the device check, with one at the port's import."""
    alone = tmp_path / "chip_smoke.py"
    alone.write_text(open(os.path.join(ROOT, "chip_smoke.py")).read())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, str(alone)], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_chip_smoke_bench_phases_on_cpu(monkeypatch):
    """The script's ``case_serving`` smoke phase, run on the CPU with the
    plain versions, reproduces ``BENCH_case_serving.json`` through the
    same comparison (``tools/check_bench_regression.py``), and that
    comparison fails on a drifted key."""
    chip_smoke = _chip_smoke()
    monkeypatch.setattr(chip_smoke, "DEVICE", "cpu")
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    out = chip_smoke.phase_serving_smoke(chip_smoke.Context())
    assert out["registry_scans"]["pfcs_scalar"] == 768
    drifted = {k: dict(v) for k, v in out.items() if isinstance(v, dict)}
    drifted["hbm_hit_rate"]["pfcs_vec"] = 0.25
    assert chip_smoke.bench_failures("BENCH_case_serving.json", drifted)


def test_chip_smoke_adversarial_flat_inputs_on_cpu(monkeypatch):
    """The flat kernels' edge inputs ``kernel_check`` adds hold for the
    plain versions at both widths (each within its type, the residual
    defined), include the out-of-contract pool and the Fibonacci chains,
    and a kernel wrong on them fails ``check_exact``."""
    chip_smoke = _chip_smoke()
    from repro_torch.kernels import ref

    monkeypatch.setattr(chip_smoke, "DEVICE", "cpu")
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    for dtype in (torch.int32, torch.int64):
        adv = chip_smoke.adversarial_flat_inputs(dtype)
        assert len(adv["factorize"]) == (2 if dtype == torch.int32 else 3)
        for args in adv["factorize"]:
            for name in ("divisibility_mask", "factorize_squarefree"):
                assert chip_smoke.check_exact(name, args)[0] == 0
        a, b = adv["gcd"][0]
        top = torch.iinfo(dtype).max
        last = chip_smoke.fibonacci_pairs(top)[-1]
        assert sum(last) > top and last in zip(a.tolist(), b.tolist())
        for args in adv["gcd"]:
            assert chip_smoke.check_exact("gcd", args)[0] == 0
        assert adv["gcd"][2][0].data_ptr() % 16 != 0     # off alignment
    dup = chip_smoke.adversarial_flat_inputs(torch.int32)["factorize"][1]
    assert ref.factorize_squarefree_ref(*dup)[1].tolist()[:6] == [0] * 6

    def wrong_residual(c, p):
        mask, res = ref.factorize_squarefree_ref(c, p)
        return mask, res + (c == 2**31 - 1).to(res.dtype)

    monkeypatch.setattr(chip_smoke, "kernel_pair",
                        lambda name: (wrong_residual,
                                      ref.factorize_squarefree_ref))
    with pytest.raises(AssertionError):
        chip_smoke.check_exact("factorize_squarefree", dup)


def _captured_inputs():
    """Inputs of two shapes for gcd and one for each other kernel, keyed
    as ``chip_smoke.Capture`` keys them."""
    c = torch.tensor([0, 1, 6, 35, 77, 30], dtype=torch.int64)
    p = torch.tensor([2, 3, 5, 7, 0], dtype=torch.int64)
    a = torch.tensor([12, 18, 0, 7, 9, 100, 81, 64], dtype=torch.int64)
    b = torch.tensor([8, 27, 5, 0, 6, 75, 54, 48], dtype=torch.int64)

    def key(*args):
        return ("int64", tuple(tuple(t.shape) for t in args))

    return {"divisibility_mask": {key(c, p): (c, p)},
            "factorize_squarefree": {key(c, p): (c, p)},
            "gcd": {key(a, b): (a, b), key(a[:4], b[:4]): (a[:4], b[:4])}}


def test_chip_smoke_checks_every_shape_a_path_gave(monkeypatch):
    """``check_path`` holds each kernel against its plain version at every
    captured shape, not only the largest: a gcd that is wrong only at the
    smaller shape fails, and a kernel the path never launched fails."""
    chip_smoke = _chip_smoke()
    from repro_torch.kernels import ref

    monkeypatch.setattr(chip_smoke, "DEVICE", "cpu")
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    launches = {name: 2 for name in chip_smoke.FLAT}
    rows = chip_smoke.check_path("t", launches, _captured_inputs(),
                                 timed=False)
    assert {r["name"]: r["shapes_checked"] for r in rows} == {
        "divisibility_mask": 1, "factorize_squarefree": 1, "gcd": 2}
    assert all(r["also_exact_as"] == ["int32"] for r in rows)

    pairs = {name: chip_smoke.kernel_pair(name) for name in launches}

    def wrong_when_small(x, y):
        g = ref.gcd_ref(x, y)
        return g + 1 if x.numel() < 8 else g

    pairs["gcd"] = (wrong_when_small, ref.gcd_ref)
    monkeypatch.setattr(chip_smoke, "kernel_pair", pairs.__getitem__)
    with pytest.raises(AssertionError, match="gcd torch.int64: kernel != plain"):
        chip_smoke.check_path("t", launches, _captured_inputs(),
                              timed=False)
    with pytest.raises(AssertionError, match="not launched"):
        chip_smoke.check_path("t", dict(launches, gcd=0),
                              _captured_inputs(), timed=False)


def test_chip_smoke_mask_lines_report_row_classes(monkeypatch):
    """The flat mask's path line gives the share of its rows of 2**32 or
    more and of 0 or 1, over every captured shape weighted by its
    launches, and the largest pool entry; int32 rows are never wide."""
    chip_smoke = _chip_smoke()
    monkeypatch.setattr(chip_smoke, "DEVICE", "cpu")
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    inputs = _captured_inputs()
    c = torch.tensor([2**40, 3 * 2**32, 0, 15], dtype=torch.int64)
    p = torch.tensor([3, 5, 2**33, 1], dtype=torch.int64)
    small = next(iter(inputs["divisibility_mask"]))
    big = ("int64", ((4,), (4,)))
    inputs["divisibility_mask"][big] = (c, p)
    counts = {name: {k: 1 for k in seen} for name, seen in inputs.items()}
    counts["divisibility_mask"][big] = 3
    launches = {name: sum(v.values()) for name, v in counts.items()}
    rows = chip_smoke.check_path("t", launches, inputs, timed=False,
                                 shape_launches=counts)
    mask = next(r for r in rows if r["name"] == "divisibility_mask")
    # the 6-row shape once (2 of its rows 0 or 1), the 4-row one 3 times
    assert mask["rows_at_least_2_32_share"] == pytest.approx(6 / 18)
    assert mask["rows_0_or_1_share"] == pytest.approx(5 / 18)
    assert mask["max_pool_entry"] == 2**33
    assert all("max_pool_entry" not in r for r in rows
               if r["name"] != "divisibility_mask")
    narrow = chip_smoke.mask_row_classes(
        {small: tuple(x.int() for x in inputs["divisibility_mask"][small])},
        {})
    assert narrow["rows_at_least_2_32_share"] == 0
    assert narrow["max_pool_entry"] == 7


def test_chip_smoke_limb_lines_report_row_classes():
    """The limb factorization's path line gives its rows by significant
    limbs and the most dividing entries of any row."""
    chip_smoke = _chip_smoke()
    limbs = torch.tensor([[0, 0, 0], [15, 0, 0], [1, 2, 0], [30, 0, 5]],
                         dtype=torch.int64)
    pool = torch.tensor([5, 3, 2, 0, 1], dtype=torch.int64)
    out = chip_smoke.limb_row_classes({("int64", ((4, 3), (5,))):
                                       (limbs, pool)})
    assert out["rows_by_significant_limbs"] == {"0": 1, "1": 1, "2": 1,
                                                "3": 1}
    assert out["max_hits_per_row"] == 3       # the zero row: 5, 3 and 2


def test_chip_smoke_busy_bound_needs_every_launch_inside(monkeypatch):
    """The measured upper bound on the card's busy share is the kernel
    calls' seconds over wall only while every launch fell inside those
    calls; the graph-replay figure is an estimate from each kernel's
    launches at each shape times that shape's graph time, null without a
    graph time."""
    chip_smoke = _chip_smoke()
    launches = {name: 3 for name in chip_smoke.FLAT}
    rows = [{"name": name, "device_ms": 6.0} for name in chip_smoke.FLAT]
    seconds = {"refresh_s": 4.0, "kernel_calls_s": 1.0,
               "kernel_calls_launches": 9}
    split = chip_smoke.time_split(10.0, seconds, launches, rows)
    assert split["device_busy_upper_share"] == 0.1
    assert split["launches_outside_kernel_calls"] == 0
    assert split["device_busy_graph_est_s"] == pytest.approx(0.018)
    assert split["device_ms_by_kernel"] == dict.fromkeys(chip_smoke.FLAT,
                                                         6.0)
    assert split["refresh_host_python_s"] == 3.0
    split = chip_smoke.time_split(
        10.0, dict(seconds, kernel_calls_launches=8), launches,
        rows[:2] + [{"name": "gcd", "device_ms": None}])
    assert split["device_busy_upper_share"] is None
    assert split["launches_outside_kernel_calls"] == 1
    assert split["device_busy_graph_est_s"] is None


def test_chip_smoke_times_every_shape_a_path_launched(monkeypatch):
    """``check_path`` with the launches at each shape times every shape
    that launched (not only the largest), sums launches x graph ms into
    the kernel's ``device_ms`` and launches x (graph - bound) into
    ``gap_ms``, skips shapes that never launched, and fails when the
    launches by shape do not add up to the kernel's count."""
    chip_smoke = _chip_smoke()
    monkeypatch.setattr(chip_smoke, "DEVICE", "cpu")
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    inputs = _captured_inputs()
    keys = list(inputs["gcd"])
    counts = {"divisibility_mask": {k: 2 for k in inputs["divisibility_mask"]},
              "factorize_squarefree": {k: 2 for k in
                                       inputs["factorize_squarefree"]},
              "gcd": {keys[0]: 3, keys[1]: 0}}
    launches = {"divisibility_mask": 2, "factorize_squarefree": 2, "gcd": 3}
    monkeypatch.setattr(chip_smoke, "graph_ms", lambda fn, **kw: 2.0)
    monkeypatch.setattr(chip_smoke, "loop_ms", lambda fn, **kw: 1.0)
    rows = chip_smoke.check_path("t", launches, inputs,
                                 shape_launches=counts)
    by = {r["name"]: r for r in rows}
    assert [s["launches"] for s in by["gcd"]["shapes"]] == [3]
    assert by["gcd"]["device_ms"] == 6.0
    assert by["gcd"]["gap_ms"] == pytest.approx(
        3 * (2.0 - by["gcd"]["shapes"][0]["bound_ms"]))
    assert by["divisibility_mask"]["device_ms"] == 4.0
    counts["gcd"][keys[1]] = 1
    with pytest.raises(AssertionError, match="launches by shape"):
        chip_smoke.check_path("t", launches, inputs, shape_launches=counts)


class _Event:
    """A stand-in for ``torch.cuda.Event`` on the CPU (times read 0)."""

    def __init__(self, **kw):
        pass

    def record(self):
        pass

    def elapsed_time(self, other):
        return 0.0


def test_chip_smoke_full_scan_checks_on_cpu(monkeypatch):
    """``scale_full_scan`` on a small ``case_scale`` registry, on the CPU:
    the mask equals its plain version, no false positive, the sampled
    primes' hits equal the exact host scan; a mask wrong in one row
    fails the phase."""
    chip_smoke = _chip_smoke()
    from repro_torch import kernels
    from repro_torch.cases import build_scale_universe
    from repro_torch.kernels import factorize

    monkeypatch.setattr(chip_smoke, "DEVICE", "cpu")
    monkeypatch.setattr(chip_smoke, "FULL_SCAN_CHUNK", 500)
    monkeypatch.setattr(chip_smoke, "loop_ms", lambda fn, **kw: 0.0)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    ctx = chip_smoke.Context()
    ctx.universe = build_scale_universe(n_chains=64, depth=20)
    plain = factorize.divisibility_mask_limbs

    def counted(limbs, primes):
        kernels.KERNELS["divisibility_mask_limbs"].launches += 1
        return plain(limbs, primes)

    monkeypatch.setattr(factorize, "divisibility_mask_limbs", counted)
    out = chip_smoke.phase_scale_full_scan(ctx)
    assert out["false_positives"] == 0 and out["exact_primes"] == 8
    assert out["hits"] > 0 and out["launches"]["divisibility_mask_limbs"] == 1
    assert out["shape"] == [[len(ctx.universe.registry.composites_list()), 32],
                            [len(ctx.universe.queries)]]

    def wrong(limbs, primes):
        mask = counted(limbs, primes)
        mask[700, 0] = ~mask[700, 0]
        return mask

    monkeypatch.setattr(factorize, "divisibility_mask_limbs", wrong)
    with pytest.raises(AssertionError, match="rows 500:1000"):
        chip_smoke.phase_scale_full_scan(ctx)


def test_chip_smoke_limb_bound_counts_needed_steps():
    """The limb kernels' operation counts take only the steps these
    inputs need: Montgomery steps over each row's significant limbs (none
    for a zero row, none for an entry settled by its power of two), short
    division over the residual's, the gcd's full test on the shorter or
    the cached side, the other side only where that one is divisible, and
    its multiply over the product's limbs."""
    chip_smoke = _chip_smoke()
    from repro_torch.kernels import ref

    def rows(*values):
        return torch.tensor([[(v >> (32 * k)) & 0xFFFFFFFF for k in range(4)]
                             for v in values], dtype=torch.int64)

    a, b = rows(0, 1, 6, 3 << 40), rows(0, 1, 3, 1 << 41)
    pool = torch.tensor([2, 3, 0, 1], dtype=torch.int64)
    assert chip_smoke.significant_limbs(a).tolist() == [0, 1, 1, 2]
    assert chip_smoke.trailing_zero_bits(a).tolist() == [128, 0, 1, 40]
    mask = ref.divisibility_mask_limbs_ref(a, pool)
    # Montgomery steps: 3 (odd part 3) x (0 + 1 + 1 + 2) limbs; 2 is a
    # power of two, settled by the trailing zero bits alone
    assert chip_smoke.limb_work("divisibility_mask_limbs", (a, pool),
                                (mask,))[1] == 4
    # + divisions: 6 by 2 then 3 (1 + 1), 3 * 2**40 by 2 then 3 (2 + 2)
    outs = ref.factorize_limbs_ref(a, pool)
    assert chip_smoke.limb_work("factorize_limbs", (a, pool), outs)[1] == 10
    # + b tests by 3 where a is divisible: 0 + 1 + 2 limbs; + multiplies:
    # 2 common entries for the zero pair, 1 for each of the last two
    g = ref.gcd_limbs_ref(a, b, pool)
    assert chip_smoke.limb_work("gcd_limbs", (a, b, pool), (g,))[1] == 11
    # each pair tests its shorter side first: 3 * 2**96 (4 limbs) against
    # 3 (1 limb) tests 3 against all of 3, 5, 7 (3 steps), then only 3
    # against the long side (4 steps), then multiplies once; a-first would
    # take 3 x 4 + 1 steps
    a, b = rows(3 << 96), rows(3)
    pool = torch.tensor([3, 5, 7], dtype=torch.int64)
    g = ref.gcd_limbs_ref(a, b, pool)
    assert chip_smoke.limb_work("gcd_limbs", (a, b, pool), (g,))[1] == 8
    assert chip_smoke.limb_work("gcd_limbs", (b, a, pool), (g,))[1] == 8
    # a row repeated on consecutive pairs is tested in full once: 6 against
    # 3, 5, 7 (3 steps), then only 3 against each b (1 step each), and one
    # multiply for the common 3 of the last pair
    a, b = rows(6, 6, 6), rows(5, 7, 3)
    g = ref.gcd_limbs_ref(a, b, pool)
    assert chip_smoke.gcd_first_sides(a, b)[1].tolist() == [True, False,
                                                           False]
    assert chip_smoke.limb_work("gcd_limbs", (a, b, pool), (g,))[1] == 7
    # even entries: 12 = 4 x 3 runs a pass only on the rows with at least
    # 2 trailing zero bits (12: 1 limb, 7 * 2**30: 2 limbs; not 6, and the
    # zero row needs none); 2**30 never does
    a = rows(12, 6, 2**30 * 7, 0)
    pool = torch.tensor([12, 2**30], dtype=torch.int64)
    assert chip_smoke.horner_steps(a, pool) == 1 + 2


def test_chip_smoke_wide_paths_name_their_kernels(monkeypatch):
    """A wide path must launch the limb scan and the limb gcd: a run that
    did not launch one fails ``check_path``, and a kernel launched but
    not captured fails too."""
    chip_smoke = _chip_smoke()
    monkeypatch.setattr(chip_smoke, "DEVICE", "cpu")
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    limbs = torch.tensor([[6, 0], [35, 0], [1, 0]], dtype=torch.int64)
    pool = torch.tensor([2, 3, 5, 7, 0], dtype=torch.int64)
    key = ("int64", ((3, 2), (5,)))
    gkey = ("int64", ((3, 2), (3, 2), (5,)))
    inputs = {"divisibility_mask_limbs": {key: (limbs, pool)},
              "gcd_limbs": {gkey: (limbs, limbs.roll(1, 0), pool)}}
    launches = dict.fromkeys(chip_smoke.PORTED, 0)
    launches.update(divisibility_mask_limbs=4, gcd_limbs=4)
    rows = chip_smoke.check_path("wide", launches, inputs, timed=False,
                                 required=["divisibility_mask_limbs",
                                           "gcd_limbs"])
    assert [r["name"] for r in rows] == ["divisibility_mask_limbs",
                                         "gcd_limbs"]
    with pytest.raises(AssertionError, match="not launched"):
        chip_smoke.check_path("wide", launches, inputs, timed=False,
                              required=chip_smoke.WIDE_SHARDED)
    with pytest.raises(AssertionError, match="uncaptured"):
        chip_smoke.check_path("wide", dict(launches, factorize_limbs=1),
                              inputs, timed=False,
                              required=["divisibility_mask_limbs"])


# --------------------------------------------------------------------------- #
# chip_smoke.py: the trace engine's phases                                   #
# --------------------------------------------------------------------------- #

def _count_plain_launches(monkeypatch, names):
    """On the CPU the wrappers run their plain versions and count no
    launch; count each as one, as a card run would."""
    from repro_torch import kernels
    from repro_torch.kernels import engine, factorize

    plain = {"divisibility_mask": (factorize, "divisibility_mask_ref"),
             "factorize_squarefree": (factorize, "factorize_squarefree_ref"),
             "engine_baseline": (engine, "baseline_scan_ref"),
             "engine_pfcs": (engine, "pfcs_scan_ref")}
    for name in names:
        mod, attr = plain[name]
        orig = getattr(mod, attr)

        def counted(*a, _orig=orig, _name=name, **kw):
            kernels.KERNELS[_name].launches += 1
            return _orig(*a, **kw)

        monkeypatch.setattr(mod, attr, counted)


def _cpu_smoke(monkeypatch):
    chip_smoke = _chip_smoke()
    monkeypatch.setattr(chip_smoke, "DEVICE", "cpu")
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(chip_smoke, "graph_ms", lambda fn, **kw: 0.0)
    monkeypatch.setattr(chip_smoke, "loop_ms", lambda fn, **kw: 0.0)
    monkeypatch.setattr(chip_smoke, "mask_write_ms", lambda m: 0.0)
    return chip_smoke


def test_chip_smoke_engine_check_on_cpu(monkeypatch):
    """``engine_check`` on the CPU at 120-access traces: every check runs
    (the plain version on both sides), each shared-memory batch also in
    the two other placements, 2Q holds two keys at capacity 1 and every
    other policy one, the swing trace drives ARC's p to 0 and to c, every
    system runs on the placement batches (a key space of 60,000, and
    levels of 20,000 slots) and on the long batch (here cut short, its
    counters those of the port's scalar oracles), whose counters must
    equal ``GLOBAL_COUNTS``, and the check batch's times feed the
    ``kernels`` line."""
    chip_smoke = _cpu_smoke(monkeypatch)
    from repro_torch.core import simulate_baseline, simulate_pfcs

    monkeypatch.setattr(chip_smoke, "CHECK_LENGTH", 120)
    monkeypatch.setattr(chip_smoke, "PLACEMENT_LENGTH", 40)
    short = chip_smoke.check_traces(90)[:2]
    monkeypatch.setattr(chip_smoke, "global_traces", lambda: short)
    counts = {s: [chip_smoke.oracle_counters(
        simulate_baseline(s, tr, chip_smoke.GLOBAL_CAPS)) for tr in short]
        for s in chip_smoke.BASELINES}
    counts["pfcs"] = [chip_smoke.oracle_counters(
        simulate_pfcs(tr, chip_smoke.GLOBAL_CAPS)) for tr in short]
    monkeypatch.setattr(chip_smoke, "GLOBAL_COUNTS", counts)
    ctx = chip_smoke.Context()
    out = chip_smoke.phase_engine_check(ctx)
    assert len(out["checks"]) == 28
    assert out["placements_checked"] == {"shared": 16, "keys global": 6,
                                         "global": 6}
    assert out["placements_asked"] == 32
    assert all(list(c["also_exact_in"]) == ["keys global", "global"]
               for c in out["checks"][:16])
    assert list(out["global_batch"]["systems"]) == list(
        chip_smoke.BASELINES) + ["pfcs"]
    counts["lirs"] = [[*counts["lirs"][0][:-1], 0], counts["lirs"][1]]
    with pytest.raises(AssertionError, match="global batch lirs"):
        chip_smoke.global_check()
    wide = [c for c in out["checks"] if "keys global" in c["check"]]
    assert all(" 60000 keys" in c["check"] for c in wide)
    deep = [c for c in out["checks"] if c["check"].endswith(", global")]
    assert all("[8, 24, 20000]" in c["check"] for c in deep)
    # (the plain version, on the CPU, keeps its state nowhere in particular)
    assert all(c["placement"] is None for c in out["checks"])
    assert all(c["max_abs_err"] == 0 for c in out["checks"])
    assert out["held_at_capacity_1"] == {"lru": 1, "fifo": 1, "2q": 2,
                                         "arc": 1, "lirs": 1}
    assert out["arc_p_range"] == [0.0, 16.0]
    assert 0.0 < out["arc_p_end"] < 16.0
    assert ctx.engine_check["engine_baseline"]["systems"] == list(
        chip_smoke.BASELINES)
    assert ctx.engine_check["engine_pfcs"]["shape"] == [4, 120]


def test_chip_smoke_engine_check_fails_on_a_wrong_kernel(monkeypatch):
    """A kernel that differs from its plain version in one counter, or in
    the last bit of ARC's p, fails ``check_engine``."""
    chip_smoke = _cpu_smoke(monkeypatch)
    from repro_torch.kernels import engine

    acc = torch.tensor([[0, 1, 0, 2, 3, 1]], dtype=torch.int32)
    args = (acc, "arc", [1, 2], 4)
    assert chip_smoke.check_engine("engine_baseline", args)["max_abs_err"] == 0
    orig = engine.baseline_scan

    def off_by_one(*a):
        out = orig(*a)
        out["miss"] = out["miss"] + 1
        return out

    monkeypatch.setattr(engine, "baseline_scan", off_by_one)
    with pytest.raises(AssertionError, match="/miss"):
        chip_smoke.check_engine("engine_baseline", args)

    def p_last_bit(*a):
        out = orig(*a)
        p = out["state"]["pol"]["p"]
        out["state"]["pol"]["p"] = (p.view(torch.int64) ^ 1).view(
            torch.float64)
        return out

    monkeypatch.setattr(engine, "baseline_scan", p_last_bit)
    with pytest.raises(AssertionError, match="/state/pol/p"):
        chip_smoke.check_engine("engine_baseline", args)


def test_chip_smoke_table1_on_cpu(monkeypatch):
    """``table1`` on the CPU with the workloads cut small: every system's
    counters equal the scalar oracles' (PFCS's, every trial, as
    ``TABLE1_PFCS`` records them), the engine kernels launch once a
    system and workload, the flat mask and factorization launch (PFCS's
    kernel discovery) and are held against their plain versions, every
    engine call has its bound, and a seed-0 count or a recorded PFCS
    counter that is off fails the phase."""
    chip_smoke = _cpu_smoke(monkeypatch)
    _count_plain_launches(monkeypatch, ["divisibility_mask",
                                        "factorize_squarefree",
                                        "engine_baseline", "engine_pfcs"])
    small = {"db_join": ("db_join_trace", dict(
        n_orders=300, n_customers=60, n_items=120, n_queries=300)),
             "hft": ("hft_trace", dict(n_instruments=200, n_corr_groups=30,
                                       n_events=300))}
    monkeypatch.setattr(chip_smoke, "TABLE1_WORKLOADS", small)
    monkeypatch.setattr(chip_smoke, "TABLE1_TRIALS", 2)
    monkeypatch.setattr(chip_smoke, "TABLE1_CAPS",
                        (("L1", 8), ("L2", 16), ("L3", 64)))
    monkeypatch.setattr(chip_smoke, "TABLE1_SEED0", {})
    from repro_torch.core import simulate_baseline, simulate_pfcs

    pfcs = {w: [chip_smoke.pfcs_counters(simulate_pfcs(
        chip_smoke._make_trace(gen, seed=s, **kw), chip_smoke.TABLE1_CAPS))
        for s in range(2)] for w, (gen, kw) in small.items()}
    monkeypatch.setattr(chip_smoke, "TABLE1_PFCS", pfcs)
    ctx = chip_smoke.Context()
    lines = []
    monkeypatch.setattr(chip_smoke, "emit", lines.append)
    out = chip_smoke.phase_table1(ctx)
    assert out["launches"]["engine_baseline"] == 10
    assert out["launches"]["engine_pfcs"] == 2
    assert out["flat_kernels_exact"] == ["divisibility_mask",
                                         "factorize_squarefree"]
    assert ctx.engine_path["engine_pfcs"]["launches"] == 2
    assert all(ctx.engine_path[n]["path_bound_ms"] > 0
               for n in chip_smoke.ENGINE)
    assert set(out["engine_ptxas"]) == set(chip_smoke.ENGINE)
    rows = [r for ln in lines if ln["phase"] == "table1_workload"
            for r in ln["systems"].values()]
    assert len(rows) == 12
    # the serial step's latency: kernel ms over the longest trace's steps
    assert all(r["ns_per_step"] == r["kernel_ms"] * 1e6 / 300
               and r["placement"] is None for r in rows)

    tr = chip_smoke._make_trace("hft_trace", seed=0, **small["hft"][1])
    lru = simulate_baseline("lru", tr, chip_smoke.TABLE1_CAPS)
    monkeypatch.setattr(chip_smoke, "TABLE1_SEED0", {
        "hft": {"lru": (lru.hits + 1, lru.demand_accesses)}})
    with pytest.raises(AssertionError, match="seed-0 hits"):
        chip_smoke.phase_table1(chip_smoke.Context())
    monkeypatch.setattr(chip_smoke, "TABLE1_SEED0", {})
    hits, *rest = pfcs["hft"][1]
    pfcs["hft"][1] = (hits, *rest[:-1], rest[-1] + 1)
    with pytest.raises(AssertionError, match="hft pfcs: counters"):
        chip_smoke.phase_table1(chip_smoke.Context())


def test_chip_smoke_table1_times_on_cpu(monkeypatch):
    """``--compare-engine``'s worker on the CPU with the workloads cut
    small: this tree's port, each (workload, system) the least of two
    launches, its seed-0 hits held to ``TABLE1_SEED0`` (one off fails)."""
    chip_smoke = _cpu_smoke(monkeypatch)
    small = {"hft": ("hft_trace", dict(n_instruments=200, n_corr_groups=30,
                                       n_events=300))}
    monkeypatch.setattr(chip_smoke, "TABLE1_WORKLOADS", small)
    monkeypatch.setattr(chip_smoke, "TABLE1_TRIALS", 1)
    monkeypatch.setattr(chip_smoke, "TABLE1_CAPS",
                        (("L1", 8), ("L2", 16), ("L3", 64)))
    monkeypatch.setattr(sys, "path", list(sys.path))
    from repro_torch.core import simulate_baseline, simulate_pfcs

    tr = chip_smoke._make_trace("hft_trace", seed=0, **small["hft"][1])
    seed0 = {s: simulate_baseline(s, tr, chip_smoke.TABLE1_CAPS)
             for s in chip_smoke.BASELINES}
    seed0["pfcs"] = simulate_pfcs(tr, chip_smoke.TABLE1_CAPS)
    seed0 = {"hft": {s: (st.hits, st.demand_accesses)
                     for s, st in seed0.items()}}
    monkeypatch.setattr(chip_smoke, "TABLE1_SEED0", seed0)
    ms = chip_smoke.table1_times(chip_smoke.ROOT)
    assert sorted(ms) == sorted(f"hft/{s}" for s in
                                chip_smoke.BASELINES + ("pfcs",))
    seed0["hft"]["arc"] = (seed0["hft"]["arc"][0] + 1, 300)
    with pytest.raises(AssertionError, match="hft arc seed-0 hits"):
        chip_smoke.table1_times(chip_smoke.ROOT)


def test_chip_smoke_engine_work_counts_the_algorithm(monkeypatch):
    """The engine kernels' bounds count the algorithm's reads, not the
    kernel's: a PFCS run's inserts and evictions per level, derived from
    its counters and final occupancy, equal those the plain step makes
    (counted in its ``_add`` / ``_evict``) on a ragged batch with
    prefetch; a baseline's words follow the replay by hand on a small
    LRU trace; and neither depends on the ``visits`` a kernel reports."""
    chip_smoke = _chip_smoke()
    from repro_torch.core.engine import pfcs_vec
    from repro_torch.kernels import engine

    from repro_torch.core.engine.batch import (key_space, stack_accesses,
                                               stack_tables)

    caps = [3, 5, 9]
    traces = chip_smoke.check_traces(150)
    acc, n_keys = stack_accesses(traces, "cpu"), key_space(traces)
    levels = tuple((str(i), c) for i, c in enumerate(caps))
    tables = stack_tables([pfcs_tables(tr, levels, n_keys=n_keys,
                                       device="cpu") for tr in traces],
                          "cpu")
    counted = {"add": torch.zeros((len(caps), len(traces)), dtype=torch.long),
               "evict": torch.zeros((len(caps), len(traces)),
                                    dtype=torch.long)}
    add, evict = pfcs_vec._add, pfcs_vec._evict

    def level_of(lv):
        return caps.index(lv["keys"].shape[1] - 1)

    def counting_add(lv, k, tick, pf, dg, do):
        counted["add"][level_of(lv)] += do.long()
        return add(lv, k, tick, pf, dg, do)

    def counting_evict(lv, cap, window, do):
        counted["evict"][caps.index(cap)] += do.long()
        return evict(lv, cap, window, do)

    monkeypatch.setattr(pfcs_vec, "_add", counting_add)
    monkeypatch.setattr(pfcs_vec, "_evict", counting_evict)
    out = engine.pfcs_scan(acc, caps, n_keys, 4, 8, True, False, *tables)
    moves = chip_smoke.pfcs_level_moves(out, caps, True)
    for l, (inserts, evictions) in enumerate(moves):
        assert inserts.tolist() == counted["add"][l].tolist()
        assert evictions.tolist() == counted["evict"][l].tolist()
    assert counted["evict"].sum() > 0

    # LRU over one level of 2 on 0, 1, 0, 2: the shadow reads 2+2 words
    # for a new key and 2+4 for a key it holds; the policy 2 on a hit
    # and 4 on a miss
    assert chip_smoke.baseline_work("lru", [0, 1, 0, 2], [2], 3) == (
        4 + 4 + 6 + 4) + (4 + 4 + 2 + 4)
    call = {"name": "engine_baseline", "args": (acc, "lirs", caps, n_keys),
            "out": engine.baseline_scan(acc, "lirs", caps, n_keys)}
    again = dict(call, out=dict(call["out"], visits=torch.full(
        (len(traces),), 10**9, dtype=torch.int64)))
    first = chip_smoke.engine_bound(call)
    assert first == chip_smoke.engine_bound(again) and first["work"] > 0
