"""The port's boundaries: it imports neither JAX nor the reference, its
entry points default to the card and raise without one, the parts of
the reference it does not have yet raise ``NotImplementedError`` naming
the ROADMAP.md item that ports them, and ``chip_smoke.py`` exits
non-zero without a card and names the phase that failed."""

import torch_parity  # noqa: F401

import json
import os
import subprocess
import sys

import pytest
import torch

from repro_torch.core.engine.shard import (PrimeSpacePartition,
                                           sharded_successor_table)
from repro_torch.core import db_join_trace
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
"""


def test_port_imports_no_jax_and_no_reference():
    """Every ``repro_torch`` module and ``chip_smoke`` import in a process
    where ``import jax`` and ``import repro`` raise."""
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
    "wide": (lambda: VectorizedPagedKVCache(max_bits=128, device="cpu"),
             "A.7"),
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
    launches = {name: 2 for name in chip_smoke.PORTED}
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


def test_chip_smoke_busy_bound_needs_every_launch_inside(monkeypatch):
    """The measured upper bound on the card's busy share is the kernel
    calls' seconds over wall only while every launch fell inside those
    calls; the graph-replay figure is an estimate, null without a graph
    time."""
    chip_smoke = _chip_smoke()
    launches = {name: 3 for name in chip_smoke.PORTED}
    rows = [{"name": name, "graph_ms": 2.0} for name in chip_smoke.PORTED]
    seconds = {"refresh_s": 4.0, "kernel_calls_s": 1.0,
               "kernel_calls_launches": 9}
    split = chip_smoke.time_split(10.0, seconds, launches, rows)
    assert split["device_busy_upper_share"] == 0.1
    assert split["launches_outside_kernel_calls"] == 0
    assert split["device_busy_graph_est_s"] == pytest.approx(0.018)
    assert split["refresh_host_python_s"] == 3.0
    split = chip_smoke.time_split(
        10.0, dict(seconds, kernel_calls_launches=8), launches,
        rows[:2] + [{"name": "gcd", "graph_ms": None}])
    assert split["device_busy_upper_share"] is None
    assert split["launches_outside_kernel_calls"] == 1
    assert split["device_busy_graph_est_s"] is None
