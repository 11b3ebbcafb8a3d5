"""The port's benchmark cases (``repro_torch.cases``) and their runner on
the CPU: ``python -m repro_torch.cases`` writes ``case_serving``,
``case_batching``, ``case_elastic``, ``case_moe``, ``case_tenancy`` and
``case_dedup`` at their smoke configurations, and
``tools/check_bench_regression.py`` passes them against copies of the
checked-in ``BENCH_case_*.json`` (and fails a drifted key).  At full
size, the reference's ``case_elastic``, ``case_moe`` (synthetic router),
``case_tenancy`` and ``case_dedup`` give the counters ``chip_smoke.py``
holds the card to, and so does the port.  ``run_table1`` uses
``benchmarks/table1.py``'s configuration and gives its rows.

The port runs with ``device="cpu"`` (the kernels' plain versions).
"""

import torch_parity

import json
import os
import shutil
import sys

import pytest

from repro_torch import cases

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE_CASES = ("serving", "batching", "elastic", "moe", "tenancy", "dedup")


def _gate():
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    try:
        import check_bench_regression
    finally:
        sys.path.remove(os.path.join(ROOT, "tools"))
    return check_bench_regression


@pytest.fixture(scope="module")
def fresh(tmp_path_factory):
    """The runner's output directory after one CPU run of the six smoke
    cases."""
    out = tmp_path_factory.mktemp("bench_torch")
    assert cases.main(["--out", str(out), "--device", "cpu",
                       "--cases", *SMOKE_CASES]) == 0
    return out


def test_runner_output_passes_the_gate(fresh, tmp_path):
    """The regression gate over copies of the checked-in files and the
    runner's directory passes; with one counter drifted it fails."""
    gate = _gate()
    base = tmp_path / "baseline"
    base.mkdir()
    for case in SMOKE_CASES:
        shutil.copy(os.path.join(ROOT, f"BENCH_case_{case}.json"), base)
    assert sorted(p.name for p in fresh.iterdir()) == sorted(
        f"BENCH_case_{c}.json" for c in SMOKE_CASES)
    assert gate.run_gate(base, fresh) == 0
    drifted = tmp_path / "drifted"
    shutil.copytree(fresh, drifted)
    path = drifted / "BENCH_case_elastic.json"
    payload = json.loads(path.read_text())
    payload["refactorized"] += 1
    path.write_text(json.dumps(payload))
    assert gate.run_gate(base, drifted) == 1


@pytest.mark.parametrize("case", SMOKE_CASES)
def test_each_case_reproduces_its_checked_in_file(fresh, case):
    """``compare_case`` finds no failure and the port's file has every
    deterministic key of the reference's and no other."""
    gate = _gate()
    name = f"BENCH_case_{case}.json"
    with open(os.path.join(ROOT, name)) as f:
        base = json.load(f)
    got = json.loads((fresh / name).read_text())
    failures, notes = gate.compare_case(name, base, got, rel_tol=0.0)
    assert failures == [] and notes == []


def test_case_moe_real_router_names_its_roadmap_item():
    """The real-router block, once ROADMAP.md A.14's missing MoE model,
    runs: the ``kimi-k2-1t-a32b`` smoke model's router feeds the engine's
    expert tier with no false-positive prefetch (Theorem 1), it is on by
    default at full size only, and the rest of A.14 (the hybrid family
    among them) builds."""
    from repro_torch.configs import get_smoke
    from repro_torch.models import build_model

    out = cases.case_moe(smoke=True, real_router=True, device="cpu")
    rr = out["engine_real_router"]
    assert rr["arch"] == "kimi-k2-smoke" and rr["n_experts"] == 8
    assert rr["false_positive_prefetches"] == 0 and rr["prefetches"] > 0
    assert "engine_real_router" not in cases.case_moe(smoke=True,
                                                      device="cpu")
    zamba = build_model(get_smoke("zamba2-7b"), device="cpu")
    assert zamba.cfg.family == "hybrid" and zamba.device.type == "cpu"


def test_bench_payload_names_each_case():
    with pytest.raises(ValueError):
        cases.bench_payload("case_unknown", {})
    with pytest.raises(ValueError):
        cases.run_case("unknown", full=False, device="cpu")


# --------------------------------------------------------------------------- #
# the full configurations: chip_smoke.py's recorded counters                  #
# --------------------------------------------------------------------------- #

@pytest.fixture()
def reference_cases(monkeypatch):
    """``benchmarks/cases.py`` with its file writers off (a full-size
    run must not overwrite the checked-in smoke files); what ``save_bench``
    would have written is kept in ``ref_cases.written`` by case name, as
    the JSON file would hold it."""
    monkeypatch.syspath_prepend(ROOT)
    from benchmarks import cases as ref_cases

    written = {}
    monkeypatch.setattr(ref_cases, "save_json", lambda *a, **k: None)
    monkeypatch.setattr(ref_cases, "save_bench",
                        lambda name, payload: written.__setitem__(
                            name, _as_json(payload)))
    monkeypatch.setattr(ref_cases, "written", written, raising=False)
    return ref_cases


def _as_json(payload):
    return json.loads(json.dumps(payload, default=float, sort_keys=True))


def _holds(want, got):
    """Every key of ``want`` (nested) has its value in ``got``."""
    return all(_holds(v, got[k]) if isinstance(v, dict) else got[k] == v
               for k, v in want.items())


def test_elastic_full_counters_are_the_references(reference_cases):
    """The reference's full ``case_elastic`` (16 resizes, 13 recoveries,
    ...) gives ``chip_smoke.ELASTIC_FULL``, and the port's gives the
    same."""
    smoke = torch_parity.chip_smoke()
    assert _holds(smoke.ELASTIC_FULL,
                  reference_cases.case_elastic(smoke=False))
    assert _holds(smoke.ELASTIC_FULL,
                  cases.case_elastic(smoke=False, device="cpu"))


def test_moe_full_counters_are_the_references(reference_cases):
    """The reference's full ``case_moe`` with the synthetic router gives
    ``chip_smoke.MOE_FULL``, and the port's gives the same."""
    smoke = torch_parity.chip_smoke()
    assert _holds(smoke.MOE_FULL, reference_cases.case_moe(
        smoke=False, real_router=False))
    assert _holds(smoke.MOE_FULL, cases.case_moe(
        smoke=False, real_router=False, device="cpu"))


@pytest.mark.parametrize("case", ["tenancy", "dedup"])
def test_tenancy_and_dedup_full_counters_are_the_references(
        reference_cases, case):
    """The reference's full ``case_tenancy`` / ``case_dedup`` write the
    BENCH keys ``chip_smoke.TENANCY_FULL`` / ``DEDUP_FULL`` record (the
    dedup ones with ``dedup_hits`` 896 and ``cow_copies`` 58), and the
    port's full cases give the same keys."""
    smoke = torch_parity.chip_smoke()
    want = {"tenancy": smoke.TENANCY_FULL, "dedup": smoke.DEDUP_FULL}[case]
    getattr(reference_cases, f"case_{case}")(smoke=False)
    assert reference_cases.written[f"case_{case}"] == want
    out = getattr(cases, f"case_{case}")(smoke=False, device="cpu")
    assert _as_json(cases.bench_payload(f"case_{case}", out)) == want


def test_table1_configuration_is_the_references(monkeypatch):
    """``run_table1``'s levels, systems and paper values are
    ``benchmarks/table1.py``'s, and its workloads give the reference's
    traces at full length and at a twentieth (seeds 0 and 1)."""
    import numpy as np

    import repro.core as R

    monkeypatch.syspath_prepend(ROOT)
    from benchmarks import table1

    assert cases.TABLE1_CAPS == table1.CAPS
    assert cases.TABLE1_SYSTEMS == table1.SYSTEMS
    assert cases.TABLE1_PAPER == table1.PAPER
    from repro_torch.core import traces

    for scale in (1.0, 0.05):
        ref = table1._workloads(scale)
        port = cases.table1_workloads(scale)
        assert list(port) == list(ref)
        for name, (gen, kw) in port.items():
            for seed in (0, 1):
                want = ref[name](seed)
                got = getattr(traces, gen)(seed=seed, **kw)
                assert np.array_equal(np.asarray(want.accesses),
                                      got.accesses), (name, scale, seed)
                assert want.n_keys == got.n_keys
                assert getattr(R, gen).__name__ == gen


@pytest.mark.parametrize("discover", ["host", "kernel"])
def test_run_table1_gives_the_references_rows(monkeypatch, discover):
    """``run_table1`` at two trials of small workloads (the same cut
    applied to both packages' configuration) gives
    ``benchmarks/table1.py::run``'s rows for every system: hit rate,
    latency and power reductions (mean, std), accuracy, speedup and the
    paper's values.  With ``discover="kernel"`` the counters are the
    same and only PFCS's factorization-op count, which the latency and
    power rows read, follows the reference's kernel discovery."""
    import jax
    import jax.experimental

    import repro.core as R

    monkeypatch.setattr(jax.experimental, "enable_x64", jax.enable_x64,
                        raising=False)
    monkeypatch.syspath_prepend(ROOT)
    from benchmarks import table1

    small = {"db_join": ("db_join_trace", dict(
        n_orders=300, n_customers=60, n_items=120, n_queries=300)),
             "ml_epoch": ("ml_epoch_trace", dict(
                 n_samples=120, n_feature_rows=40, n_epochs=1)),
             "hft": ("hft_trace", dict(n_instruments=200, n_corr_groups=30,
                                       n_events=300))}
    monkeypatch.setattr(cases, "table1_workloads", lambda scale=1.0: small)
    monkeypatch.setattr(table1, "_workloads", lambda scale: {
        w: (lambda seed, g=gen, k=kw: getattr(R, g)(seed=seed, **k))
        for w, (gen, kw) in small.items()})
    monkeypatch.setattr(table1, "save_json", lambda *a, **k: None)
    ref = table1.run(n_trials=2)
    got = cases.run_table1(2, 0, "cpu", discover=discover)
    systems = cases.TABLE1_SYSTEMS
    assert [k for k in got if not k.startswith("_")] == list(systems)
    if discover == "host":
        assert {s: got[s] for s in systems} == {s: ref[s] for s in systems}
    else:
        assert all(got[s] == ref[s] for s in systems if s != "pfcs")
        assert got["pfcs"]["hit"] == ref["pfcs"]["hit"]
        assert got["pfcs"]["acc"] == ref["pfcs"]["acc"]
    assert set(got["_wall_s"]) == set(ref["_wall_s"])
    run = got["_runs"]["hft"]
    assert len(run["traces"]) == 2 and len(run["tables"]) == 2
    assert set(run["stats"]) == set(systems)
    with pytest.raises(ValueError, match="lru"):
        cases.run_table1(1, 0, "cpu", systems=("arc",))


def test_case_scale_returns_the_references_obs_block():
    """``verify_scale`` reports the reference's ``obs`` block: the
    registry loop's rate and one ledger entry for each limb wrapper, with
    the items the reference records (the sample, the sample, the group
    pairs), the ledger's earlier state restored."""
    from repro_torch.obs import profile

    u = cases.build_scale_universe(n_chains=64, depth=20)
    out = cases.verify_scale(u, device="cpu")
    assert not profile.enabled()
    led = out["obs"]["kernel_launches"]
    n, pairs = len(u.sample), out["verify"]["gcd_pairs"]
    assert {k: (v["calls"], v["items"]) for k, v in led.items()} == {
        "divisibility_scan_limbs": (1, n), "factorize_batch_limbs": (1, n),
        "gcd_batch_limbs": (1, pairs)}
    with open(os.path.join(ROOT, "BENCH_case_scale.json")) as f:
        ref = json.load(f)["obs"]
    assert set(led) == set(ref["kernel_launches"])
    assert set(out["obs"]["registry_build"]) == set(ref["registry_build"])
    assert out["obs"]["registry_build"]["n"] == 64
