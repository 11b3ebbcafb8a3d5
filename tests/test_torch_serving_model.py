"""``ServingEngine`` with a model: the port's (``repro_torch.serving.engine``
with a ``repro_torch.models`` model) on the CPU against the reference's
engine serving the same smoke model on the same parameters (converted by
``params_from_reference``).

Every request's generated tokens and every ``PageStats`` counter are
equal under ``kv="vec"``, ``"scalar"`` and ``"sharded"``; the page
counters also equal the port's own ``model=None`` run of the same
prompts (paging never reads the tokens).  The real-router block (the
``kimi-k2`` and ``deepseek-v2`` smoke models feeding the expert tier,
as ``tests/test_serving_moe.py`` drives the reference) gives the same
expert counters, prefetch log and tokens, with no false-positive
prefetch; a model without a router is refused under ``moe=``; and the
port's launcher with ``--arch qwen2.5-3b`` gives the reference
launcher's keys and page counters.
"""

import torch_parity

import dataclasses

import pytest
import torch

from repro.serving.engine import ServingEngine as RefEngine
from repro_torch.cases import moe_real_router_engine, real_router_report
from repro_torch.launch import serve
from repro_torch.serving.engine import ServingEngine
from torch_parity import launcher_pair, model_pair, serve_pair

#: the engine's configuration for the dense model (small HBM: pages evict)
ENGINE_KW = torch_parity.ENGINE_KW


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the smoke shapes gain nothing from more, and
    the suite's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("kv", ["vec", "scalar", "sharded"])
def test_engine_serves_the_references_tokens(kv):
    """The same prompts through both packages' engines with the same
    ``qwen2.5-3b`` smoke parameters: every request completes with the
    same greedy tokens, every ``PageStats`` counter is equal, and the page
    counters equal the port's ``model=None`` run (all but
    ``registry_scans``)."""
    serve_pair("qwen2.5-3b", kv)


def test_engine_cache_len_tracks_each_slot():
    """After a request's prefill the other slots' lengths are unchanged
    (the decode step advances all, the fix-up takes the others back), and
    each tick advances every slot by one."""
    _, _, tm, tp = model_pair("qwen2.5-3b")
    eng = ServingEngine(tm, tp, device="cpu", **ENGINE_KW)
    eng.submit([1, 2, 3], max_new_tokens=4)
    eng.submit([4, 5, 6, 7, 8], max_new_tokens=4)
    eng.step()
    assert eng.cache["len"].tolist() == [4, 6, 1]
    eng.step()
    assert eng.cache["len"].tolist() == [5, 7, 2]


@pytest.mark.parametrize("arch", ["kimi-k2-1t-a32b", "deepseek-v2-236b"],
                         ids=["attn", "mla"])
def test_real_router_feeds_the_expert_tier(arch):
    """``case_moe``'s real-router block on the reference's engine and the
    port's, the same parameters: equal tokens, expert counters and
    prefetch log, router traffic and prefetches, every prefetched expert
    inside its trigger's co-fire set (Theorem 1), no registry scan."""
    rm, rp, tm, tp = model_pair(arch)
    ref = RefEngine(rm, rp, max_batch=2, max_seq=64, page_size=8,
                    moe="vec", moe_slots=4, moe_prefetch_budget=4)
    for i in range(3):
        ref.submit(list(range(12)) + [20 + i], max_new_tokens=3)
    ref_done = ref.run_until_idle()
    eng = moe_real_router_engine(tm, tp, "cpu", max_seq=64, n_requests=3,
                                 max_new=3)
    assert eng.experts.n_experts == tm.cfg.moe.n_experts
    assert dataclasses.asdict(eng.experts.stats) == \
        dataclasses.asdict(ref.experts.stats)
    assert eng.experts.prefetch_log == ref.experts.prefetch_log
    assert dataclasses.asdict(eng.pages.stats) == \
        dataclasses.asdict(ref.pages.stats)
    assert sorted(len(r.generated) for r in ref_done) == [3, 3, 3]
    rep = real_router_report(tm.cfg, eng)
    st = eng.experts.stats
    assert st.hits + st.misses > 0 and st.prefetches > 0
    assert rep["false_positive_prefetches"] == 0
    assert st.registry_scans == 0


def test_routerless_model_refused_under_moe():
    """A dense model has no ``decode_step_router``: ``moe=`` raises at
    construction."""
    _, _, tm, tp = model_pair("qwen2.5-3b")
    with pytest.raises(ValueError, match="router"):
        ServingEngine(tm, tp, max_batch=2, max_seq=32, moe="vec",
                      device="cpu")


def test_launcher_serves_the_smoke_model():
    """``--arch qwen2.5-3b --device cpu`` (no ``--null-model``) serves the
    smoke model through ``ServingEngine``: the reference launcher's keys
    (and ``device``), every request completed, the page counters equal
    the reference launcher's on the same prompt recipe."""
    got = launcher_pair("qwen2.5-3b")
    assert got["completed"] == 16 and got["decode_tokens"] == 16 * 24


def test_launcher_model_needs_a_card_by_default(monkeypatch):
    """Without CUDA the launcher's default device raises before serving."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--arch", "qwen2.5-3b", "--requests", "1"])
