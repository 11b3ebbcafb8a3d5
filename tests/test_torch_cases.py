"""The port's benchmark cases (``repro_torch.cases``) and their runner on
the CPU: ``python -m repro_torch.cases`` writes ``case_serving``,
``case_batching``, ``case_elastic`` and ``case_moe`` at their smoke
configurations, and ``tools/check_bench_regression.py`` passes them
against copies of the checked-in ``BENCH_case_*.json`` (and fails a
drifted key).  At full size, the reference's ``case_elastic`` and
``case_moe`` (synthetic router) give the counters ``chip_smoke.py``
holds the card to, and so does the port.

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
SMOKE_CASES = ("serving", "batching", "elastic", "moe")


def _gate():
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    try:
        import check_bench_regression
    finally:
        sys.path.remove(os.path.join(ROOT, "tools"))
    return check_bench_regression


@pytest.fixture(scope="module")
def fresh(tmp_path_factory):
    """The runner's output directory after one CPU run of the four smoke
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
    """The real-router block needs a MoE model: it raises, naming
    ROADMAP.md A.14, at full size by default and when asked for."""
    with pytest.raises(NotImplementedError, match="ROADMAP.md A.14"):
        cases.case_moe(smoke=True, real_router=True, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP.md A.14"):
        cases.case_moe(smoke=False, device="cpu")


def test_bench_payload_names_each_case():
    with pytest.raises(ValueError):
        cases.bench_payload("case_tenancy", {})
    with pytest.raises(ValueError):
        cases.run_case("dedup", full=False, device="cpu")


# --------------------------------------------------------------------------- #
# the full configurations: chip_smoke.py's recorded counters                  #
# --------------------------------------------------------------------------- #

@pytest.fixture()
def reference_cases(monkeypatch):
    """``benchmarks/cases.py`` with its file writers off (a full-size
    run must not overwrite the checked-in smoke files)."""
    monkeypatch.syspath_prepend(ROOT)
    from benchmarks import cases as ref_cases

    monkeypatch.setattr(ref_cases, "save_json", lambda *a, **k: None)
    monkeypatch.setattr(ref_cases, "save_bench", lambda *a, **k: None)
    return ref_cases


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
