"""``BENCHMARK.json`` against the benchmark's contract, the files it names,
and the rule that nothing here imports JAX or the JAX package."""

import ast
import json
import re
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level_keys_and_sizes():
    assert set(BENCH) == KEYS
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= BENCH["run_seconds"] <= 51
    assert all(_line(w) for w in BENCH["command"])
    assert len(BENCH["command"]) <= 32
    for p in BENCH["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p)
        assert not p.startswith("/") and ".." not in p


def test_check_fits_its_budget_with_24_cells():
    runs = 2 + 14 * 24
    need = runs * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200
    assert need <= 43200


def test_configs():
    assert 1 <= len(BENCH["configs"]) <= 24
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["why"])
        assert _line(c["source"]) and c["source"].startswith("https://")
        f = ROOT / c["file"]
        assert f.is_file() and f.parent == HERE / "configs"
        data = json.loads(f.read_text())
        assert data["name"] == c["name"] and data["source"] == c["source"]
        assert data["reduced"] == c["reduced"]
        assert (f.with_suffix(".py")).is_file()   # its plain reference
        used = [w for w in BENCH["workloads"] if w["config"] == c["name"]]
        assert used


@pytest.mark.parametrize("group", ["end_to_end", "per_layer"])
def test_metrics(group):
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH[group]:
        allowed = {"name", "unit", "better", "source", "workloads"} | (
            {"bound"} if group == "end_to_end" else {"layer", "moves"})
        assert set(m) <= allowed and NAME.match(m["name"])
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", [])) <= cells
        if group == "end_to_end":
            assert m["source"] in ("host_clock", "device_trace")
            assert 0 < m["bound"] <= 0.25
        else:
            assert m["source"] in ("device_trace", "program_span",
                                   "program_counter", "host_clock")
            assert m["moves"] in e2e and _line(m["layer"])
            assert (HERE / "metrics" / f"{m['name']}.py").is_file()
    assert "setup_s" in e2e


def test_cells():
    names = [w["name"] for w in BENCH["workloads"]]
    assert len(names) == len(set(names))
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(
        1, len(names) // 4)
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and _line(w["why"])
        assert (HERE / "traffic" / f"{w['traffic']}.json").is_file()
        listed = lambda m: w["name"] in m.get("workloads", [w["name"]])
        e2e = [m for m in BENCH["end_to_end"] if listed(m)]
        assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
        assert any(listed(m) for m in BENCH["per_layer"])
        # a per-layer metric moves an end-to-end metric its cell reports
        reported = {m["name"] for m in e2e}
        for m in BENCH["per_layer"]:
            assert not listed(m) or m["moves"] in reported, (w["name"], m)


def test_nothing_imports_jax_or_the_jax_package():
    bad = {"jax", "jaxlib", "flax", "repro"}
    for path in HERE.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                tops = [a.name.split(".")[0] for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                tops = [node.module.split(".")[0]]
            else:
                continue
            assert not set(tops) & bad, (path, tops)


def test_main_refuses_without_a_card(capsys):
    import torch

    from pfcs_bench import run
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert run.main(["--workload", "phi3m.reason", "--seed", "1",
                     "--seconds", "1"]) != 0
    assert capsys.readouterr().out == ""
