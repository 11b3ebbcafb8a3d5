"""Each cell driven end to end on the CPU with its configuration's smoke
sizes; the comparison that decides ``correct`` seeing planted faults and
the float8 control; the page oracle against the port's own oracle; and
the yardstick's arithmetic against hand counts."""

import json
import sys
import time

import numpy as np
import pytest
import torch

from pfcs_bench import arith, reference, run

CELLS = [w["name"] for w in json.loads(
    (run.ROOT / "BENCHMARK.json").read_text())["workloads"]]
MIX = {"output_tokens": [6, 14]}
SEED = 2**31 + 77
#: engine steps in a CPU test's window: a fixed count, not a time, so a
#: loaded host serves as many tokens as an idle one
STEPS = 24


def _run(cell, trace=False, **kw):
    torch.set_num_threads(1)
    return run.run_cell(cell, SEED, 1e9, trace, device="cpu", smoke=True,
                        mix_override=MIX, t_start=time.perf_counter(),
                        steps=STEPS, **kw)


def _limits(cell):
    cfg = run.load_cell(cell)["config"]
    return cfg["smoke"]["limits"]


@pytest.fixture(autouse=True)
def _smoke_limits(monkeypatch):
    """At smoke sizes the model is float32 on both sides: its own limit."""
    real = run.load_cell

    def load(name):
        spec = real(name)
        spec["config"]["limits"] = spec["config"]["smoke"]["limits"]
        return spec
    monkeypatch.setattr(run, "load_cell", load)


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_cell_runs_correct_on_cpu(cell, trace):
    loaded = {k.split(".")[0] for k in sys.modules}   # other tests' imports
    res = _run(cell, trace)
    assert res["correct"], res["checks"]
    assert res["attempted"] > res["device"]["count"] and res["failed"] == 0
    assert res["checks"]["kernel_mismatches"]["launches"] > 0
    assert res["checks"]["logit_gap"]["tokens"] > 50
    rows = res["context_rows"]
    assert 1 <= rows["min"] <= rows["mean"] <= rows["max"] <= 128
    assert set(res["forbidden_modules"]) <= loaded
    assert list(res)[-1] == "checks"
    listed = run.load_cell(cell)["per_layer" if trace else "end_to_end"]
    want = {m["name"] for m in listed}
    got = set(res["metrics"])
    # device-trace metrics need a card; the rest are read on the CPU too
    assert got <= want and got >= {m["name"] for m in listed
                                   if m["source"] != "device_trace"}


def _state_unchanged(eng):
    fn = eng._decode

    def decode(params, batch, cache):
        keep = {k: v.clone() for k, v in cache.items()}
        logits = fn(params, batch, cache)[0]
        for k, v in keep.items():
            cache[k].copy_(v)
        return logits, keep
    eng._decode = decode


def _half_batch(eng):
    fn = eng._decode

    def decode(params, batch, cache):
        out = fn(params, batch, cache)
        b = out[0].shape[0]
        out[0][b // 2:] = out[0][:b - b // 2]
        return out
    eng._decode = decode


def _token_altered(eng):
    step, vocab = eng.step, eng.model.cfg.vocab_size
    n = [0]

    def altered():
        out = step()
        n[0] += 1
        live = [r for r in eng.slots if r is not None]
        if n[0] % 3 == 0 and live and live[0].generated:
            live[0].generated[-1] = (live[0].generated[-1] + 1) % vocab
        return out
    eng.step = altered


def _touch_dropped(eng):
    fn = eng.pages.touch_batch
    eng.pages.touch_batch = lambda items: fn(list(items)[:-1])


FAULTS = {"state_unchanged": (_state_unchanged, "logit_gap"),
          "half_batch": (_half_batch, "logit_gap"),
          "token_altered": (_token_altered, "logit_gap"),
          "touch_dropped": (_touch_dropped, "page_tier_mismatches")}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", CELLS)
def test_planted_fault_is_not_correct(cell, fault):
    plant, number = FAULTS[fault]
    res = _run(cell, break_program=plant)
    assert not res["correct"]
    c = res["checks"][number]
    assert c["value"] > c["limit"], res["checks"]


@pytest.mark.parametrize("cell", CELLS[:1])
def test_kernel_fault_is_not_correct(cell, monkeypatch):
    fac = sys.modules["repro_torch.kernels.factorize"]
    real = fac.divisibility_mask_ref

    def flipped(c, p):
        out = real(c, p).clone()
        out[0, 0] = ~out[0, 0]
        return out
    monkeypatch.setattr(fac, "divisibility_mask_ref", flipped)
    res = _run(cell)
    assert not res["correct"]
    assert res["checks"]["kernel_mismatches"]["value"] > 0


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_the_limit(cell):
    """The reference with float8 weights, put in the program's place, is
    judged by the harness's own comparison and comes out not correct: it
    reads past each number's limit that the program meets."""
    res = _run(cell, control=True)
    assert res["correct"] and res["control_correct"] is False
    limited = [k for k, v in res["checks"].items()
               if "limit" in v and k in _limits(cell)]
    assert limited == list(_limits(cell))
    for k in limited:
        assert res["checks"][k]["value"] <= res["checks"][k]["limit"]
        ctl = res["checks"]["control_" + k]
        assert ctl["limit"] == res["checks"][k]["limit"]
        assert ctl["value"] > ctl["limit"], (k, res["checks"])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_page_oracle_matches_the_port(seed):
    from repro_torch.serving import make_kv_backend
    rng = np.random.default_rng(seed)
    prog = make_kv_backend("sharded", hbm_pages=12, page_size=4,
                           prefetch_budget=2, shards=2, device="cpu")
    ora = reference.PageOracle(12, 4, 2)
    prefixes = [list(rng.integers(1, 50, 8)) for _ in range(3)]
    tiers, live = [], []
    for rid in range(40):
        toks = prefixes[rid % 3] + list(rng.integers(1, 50,
                                                     rng.integers(0, 9)))
        prog.register_request(rid, toks)
        ora.register(rid, toks)
        live.append(rid)
        if len(live) > 5:
            gone = live.pop(int(rng.integers(0, len(live))))
            prog.release_request(gone)
            ora.release(gone)
        items = [(r, j) for r in live for j in range(len(ora.chains[r]))]
        tiers += prog.touch_batch(items)
        for r, j in items:
            ora.touch(r, j)
    assert tiers == ora.tiers
    assert [tuple(x) for x in prog.prefetch_log] == ora.prefetch_log
    assert {k: getattr(prog.stats, k) for k in reference.PAGE_COUNTERS} \
        == ora.stats
    assert ora.stats["evictions"] > 0 and ora.stats["prefetches"] > 0


def test_kernel_references_match_the_port_on_cpu():
    from repro_torch.kernels import ref as port
    g = torch.Generator().manual_seed(3)
    c = torch.randint(1, 2**40, (300,), generator=g)
    p = torch.tensor([0, 1, 2, 3, 5, 7, 11, 13, 2**31 - 1] + [0] * 3)
    assert torch.equal(reference.divisibility_mask(c, p),
                       port.divisibility_mask_ref(c, p))
    for a, b in zip(reference.factorize_squarefree(c, p),
                    port.factorize_squarefree_ref(c, p)):
        assert torch.equal(a, b)
    d = torch.randint(0, 2**40, (300,), generator=g)
    assert torch.equal(reference.gcd(c, d), port.gcd_ref(c, d))


def test_cache_positions_follow_the_engine():
    """Calls 0-2 advance; 3-4 are another slot's prefill (no advance); a
    row of 3 makes call 5 write past the end, onto the last row."""
    ln, vis = reference.cache_positions([1, 1, 1, 0, 0, 1, 1], rows=4)
    assert list(ln) == [0, 1, 2, 3, 3, 3, 4]
    assert vis[5].tolist() == [1, 1, 1, 0, 0, 1, 0]
    assert vis[4].tolist() == [1, 1, 1, 0, 1, 0, 0]
    # call 6 (length 4) lands on row 3 too: it replaces call 5 there
    assert vis[6].tolist() == [1, 1, 1, 0, 0, 0, 1]


def test_arithmetic_hand_counts():
    assert arith.pfcs_kernel_work("divisibility_mask", (256, 512), 8) == \
        ((256 + 512) * 8 + 256 * 512, 256 * 512)
    assert arith.pfcs_kernel_work("factorize_squarefree", (256, 512), 4,
                                  hits=7) == \
        ((256 + 512) * 4 + 256 * 512 + 256 * 4, 256 * 512 + 7)
    assert arith.euclid_steps([12, 7, 5], [8, 0, 5]) == 2 + 0 + 1
    assert arith.pfcs_kernel_work("gcd", (1024,), 8, euclid=9) == \
        (3 * 1024 * 8, 9)
    by, fl = arith.decode_attention_work([3, 5], 4, 2, 16, 2, 2)
    assert (by, fl) == (2 * 8 * 2 * 16 * 2 + 2 * 2 * 4 * 16 * 2,
                        4 * 4 * 16 * 8)
    assert arith.bound_s(3.35e12, 0, 1.0) == 1.0


@pytest.mark.parametrize("cell", CELLS)
def test_matmul_params_hand_count(cell):
    """Smoke sizes, where every shared block is applied once: the weights
    a token multiplies by are every matrix of the model but the
    embedding."""
    from repro_torch.models import build_model
    spec = run.load_cell(cell)
    cfg, m = run.program_config(spec["config"], smoke=True)
    ref = run._load_py(run.HERE / "configs" / f"{spec['cell']['config']}.py")
    tree = build_model(cfg, device="cpu").param_specs()
    want = sum(p.numel() for n, p in tree.named_parameters()
               if p.dim() >= 2 and n != "embed.table")
    assert ref.matmul_params(m) == want
    if spec["cell"]["config"] == "phi3-medium-14b":
        assert want == 2 * (64 * 8 * 16 + 4 * 16 * 64 + 3 * 64 * 128) \
            + 512 * 64


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_the_card(cell, card):
    res = run.run_cell(cell, SEED, 5.0, False, t_start=time.perf_counter())
    assert res["correct"], res["checks"]
