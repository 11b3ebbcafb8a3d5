"""The port's xLSTM blocks and stack (``repro_torch.models.xlstm`` and
``hybrid``'s xLSTM half) on the CPU against the reference's
(``repro.models.xlstm`` / ``hybrid``).

The mLSTM on the same numpy inputs: the parallel form, the chunked form
at a sequence four chunks long (the smoke model's 64 positions never
leave the parallel fallback), the recurrence run over the sequence, the
``-1e30`` start of the running maximum and the ``max(|q . n|, exp(-m))``
denominators; the sLSTM step.  The xlstm smoke model on the reference's
parameters (``params_from_reference``): ``train_logits``, ``prefill``
and its fresh state (ROADMAP.md queue C item 5), eight teacher-forced
decode steps with their states within ``1e-4``, also with a chunk that
the train forward crosses; the bfloat16 model's greedy tokens; the block
schedule at the published depth.  Then ``ServingEngine`` under ``vec`` /
``scalar`` / ``sharded`` and the launcher with ``--arch xlstm-1.3b``
against the reference's.
"""

import torch_parity  # noqa: F401

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.models import hybrid as ref_hybrid
from repro.models import xlstm as ref_xlstm
from repro_torch import configs
from repro_torch.models import build_model, hybrid, xlstm
from torch_parity import (BF16_JIT, BF16_TOL, TOL, assert_trees_close,
                          greedy_pair, launcher_pair, model_batches,
                          model_pair, serve_pair)

ARCH = "xlstm-1.3b"
B, S, STEPS = 2, 64, 8


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the smoke shapes gain nothing from more, and
    the suite's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def close(ref, port, **tol):
    np.testing.assert_allclose(port.detach().float().numpy(),
                               np.asarray(ref, np.float32), **(tol or TOL))


def mlstm_inputs(s=64, h=2, hd=8, seed=0):
    """q, k, v and the raw gates; the input gates spread wide enough that
    the stabiliser moves."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(2, s, h, hd)).astype(np.float32)
               for _ in range(3))
    ig = (3.0 * rng.normal(size=(2, s, h))).astype(np.float32)
    fg = (2.0 + rng.normal(size=(2, s, h))).astype(np.float32)
    return q, k, v, ig, fg


def test_mlstm_forms_match():
    """The parallel form and the chunked form over four chunks equal the
    reference's and each other; the recurrence from the initial state
    (``m = -1e30``) gives the same outputs and the reference's state."""
    arrays = mlstm_inputs()
    r = [jnp.asarray(a) for a in arrays]
    t = [torch.from_numpy(a) for a in arrays]
    ref = ref_xlstm.mlstm_parallel(*r)
    close(ref, xlstm.mlstm_parallel(*t))
    close(ref_xlstm.mlstm_chunked(*r, chunk=16), xlstm.mlstm_chunked(
        *t, chunk=16))
    close(ref, xlstm.mlstm_chunked(*t, chunk=16))
    h, hd = arrays[0].shape[2], arrays[0].shape[3]
    rst = {"C": jnp.zeros((2, h, hd, hd)), "n": jnp.zeros((2, h, hd)),
           "m": jnp.full((2, h), -1e30)}
    tst = {"C": torch.zeros((2, h, hd, hd)), "n": torch.zeros((2, h, hd)),
           "m": torch.full((2, h), xlstm.M_INIT)}
    for i in range(arrays[0].shape[1]):
        ry, rst = ref_xlstm.mlstm_recurrent_step(rst, *(a[:, i] for a in r))
        ty, tst = xlstm.mlstm_recurrent_step(tst, *(a[:, i] for a in t))
        close(ry, ty)
        close(ref[:, i], ty, rtol=1e-3, atol=1e-3)
    assert_trees_close(rst, tst)


def test_mlstm_denominator_floor():
    """Queries orthogonal to every key: ``|q . n|`` is zero and the
    denominator is ``exp(-m)``, in every form, as the reference's."""
    q, k, v, ig, fg = mlstm_inputs(s=32)
    k[..., 1:] = 0.0
    q[..., 0] = 0.0
    r = [jnp.asarray(a) for a in (q, k, v, ig, fg)]
    t = [torch.from_numpy(a) for a in (q, k, v, ig, fg)]
    got = xlstm.mlstm_chunked(*t, chunk=8)
    assert float(got.abs().max()) == 0.0
    close(ref_xlstm.mlstm_chunked(*r, chunk=8), got)
    close(ref_xlstm.mlstm_parallel(*r), xlstm.mlstm_parallel(*t))


def test_slstm_step_matches():
    """The sLSTM step from the initial state (``m = -1e30``) and from a
    drawn one, on the reference's parameters."""
    rcfg, cfg = ref_configs.get_smoke(ARCH), configs.get_smoke(ARCH)
    rp = jax.tree.map(lambda a: np.asarray(a, np.float32),
                      ref_xlstm.init_slstm(jax.random.PRNGKey(3), rcfg))
    tp = jax.tree.map(torch.from_numpy, rp)
    rng = np.random.default_rng(3)
    h, hd = cfg.n_heads, cfg.d_model // cfg.n_heads
    st = ref_xlstm.slstm_init_state(rcfg, B)
    carries = [tuple(np.asarray(st[k]) for k in "hcnm"),
               tuple(rng.normal(size=(B, h, hd)).astype(np.float32)
                     for _ in range(4))]
    for carry in carries:
        gx = rng.normal(size=(B, h, 4 * hd)).astype(np.float32)
        rc, ry = ref_xlstm.slstm_step(tuple(map(jnp.asarray, carry)),
                                      jnp.asarray(gx), rp, rcfg)
        tc, ty = xlstm.slstm_step(tuple(map(torch.from_numpy, carry)),
                                  torch.from_numpy(gx), tp)
        close(ry, ty)
        assert_trees_close(list(rc), list(tc))


#: the model-level variants: the smoke configuration, and an attention
#: chunk of 16 so that the mLSTM train forward takes the chunked form
VARIANTS = {"smoke": (), "chunk16": (("attn_chunk", 16),)}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_train_logits_prefill_and_decode_match(variant):
    """``train_logits`` (logits, aux), ``prefill`` (last logits and its
    fresh state), ``init_cache`` and eight teacher-forced decode steps
    (logits, argmax, every state) equal the reference's, and the decode
    logits the train forward's at the same position."""
    rm, rp, tm, tp = model_pair(ARCH, replace=VARIANTS[variant])
    rb, tb = model_batches(tm.cfg, B, S)
    rl, raux = jax.jit(rm.train_logits)(rp, rb)
    tl, taux = tm.train_logits(tp, tb)
    close(rl, tl)
    assert (np.asarray(rl).argmax(-1) == tl.numpy().argmax(-1)).all()
    assert_trees_close(raux, taux)
    rlast, rcache = jax.jit(rm.prefill)(rp, rb)
    tlast, tcache = tm.prefill(tp, tb)
    close(rlast, tlast)
    assert_trees_close(rcache, tcache)
    fresh = tm.init_cache(B, S)
    for kind in ("m", "s"):
        assert all(torch.equal(fresh[kind][k], tcache[kind][k])
                   for k in fresh[kind])
    assert tcache["len"].tolist() == [S, S]
    rcache, tcache = rm.init_cache(B, 16), tm.init_cache(B, 16)
    assert_trees_close(rcache, tcache)
    rdec = jax.jit(rm.decode_step)
    toks = np.asarray(rb["tokens"])
    for t in range(STEPS):
        tok = toks[:, t:t + 1]
        rl_t, rcache = rdec(rp, {"tokens": jnp.asarray(tok)}, rcache)
        tl_t, tcache = tm.decode_step(tp, {"tokens": torch.from_numpy(tok)},
                                      tcache)
        close(rl_t, tl_t)
        close(rl[:, t], tl_t[:, 0], rtol=2e-4, atol=2e-4)
    assert_trees_close(rcache, tcache)


def test_bfloat16_greedy_decode_matches():
    """The bfloat16 smoke model: twelve greedy decode steps pick the same
    tokens with float32 logits within ``BF16_TOL`` of the reference
    compiled without excess precision (a bfloat16 rounding edge apart);
    the gates and the sLSTM bias stay float32 while a norm's scale takes
    the model's dtype."""
    rm, rp, tm, tp = model_pair(ARCH, "bfloat16")
    cell = tp["m_stack"][0]["cell"]
    assert cell["wq"].dtype == torch.bfloat16
    assert cell["w_igate"].dtype == torch.float32
    assert tp["s_blocks"][0]["cell"]["bias"].dtype == torch.float32
    assert tp["s_blocks"][0]["ln"]["scale"].dtype == torch.bfloat16
    for rl, tl in greedy_pair(rm, rp, tm, tp, 12, **BF16_JIT):
        close(rl, tl, **BF16_TOL)


@pytest.mark.parametrize("arch_depth", [(ARCH, None), (ARCH, 8), (ARCH, 4),
                                        (ARCH, 9)])
def test_block_schedule(arch_depth):
    """``_xlstm_runs`` equals the reference's at the published depth (48
    blocks: six runs of seven mLSTM then one sLSTM) and cut ones; the
    cache stacks one state per block of each kind."""
    arch, depth = arch_depth
    rcfg, cfg = ref_configs.get_config(arch), configs.get_config(arch)
    if depth is not None:
        rcfg, cfg = rcfg.replace(n_layers=depth), cfg.replace(n_layers=depth)
    runs = hybrid._xlstm_runs(cfg)
    assert runs == ref_hybrid._xlstm_runs(rcfg)
    n_m, n_s = hybrid._xlstm_counts(cfg)
    assert n_m + n_s == cfg.n_layers
    cache = build_model(cfg, device="cpu").init_cache(1, 4, device="meta")
    assert cache["m"]["C"].shape[0] == n_m
    assert cache["s"]["h"].shape[0] == max(n_s, 1)
    if depth is None:
        assert runs == [("m", 7), ("s", 1)] * 6


@pytest.mark.parametrize("kv", ["vec", "scalar", "sharded"])
def test_engine_serves_the_references_tokens(kv):
    """The xlstm smoke model through both packages' engines: the same
    tokens and ``PageStats``, the page counters equal to the
    ``model=None`` run's."""
    serve_pair(ARCH, kv)


def test_launcher_serves_xlstm():
    """``--arch xlstm-1.3b`` serves through the engine with the reference
    launcher's keys and page counters."""
    got = launcher_pair(ARCH, "--requests", "6", "--max-new", "6")
    assert got["completed"] == 6 and got["decode_tokens"] == 36
