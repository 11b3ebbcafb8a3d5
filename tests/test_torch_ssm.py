"""The port's Mamba-2 block and the zamba2 hybrid (``repro_torch.models.ssm``
and ``hybrid``'s zamba half) on the CPU against the reference's
(``repro.models.ssm`` / ``hybrid``).

The SSD core on the same numpy inputs at ``n_groups`` 1, 2 and 4 (the
smoke configuration's 1 cannot tell ``jnp.repeat`` from a tile; the
published ``zamba2-7b`` has 2): ``ssd_chunked`` against the reference's
and against the port's own ``ssd_recurrent_step`` run over the sequence,
the chunk assert, ``softplus`` past PyTorch's threshold.  The zamba2
smoke model on the reference's parameters (``params_from_reference``):
``train_logits``, ``prefill`` and its cache, eight teacher-forced decode
steps with their caches within ``1e-4``, at ``n_groups`` 1 and 2 and
over two SSD chunks; the bfloat16 model's greedy tokens; the shared-block
schedule at the published depth; the prefill's initial states (the
reference's, ROADMAP.md queue C item 5).  Then ``ServingEngine`` under
``vec`` / ``scalar`` / ``sharded`` and the launcher with ``--arch
zamba2-7b`` against the reference's.
"""

import torch_parity  # noqa: F401

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.models import hybrid as ref_hybrid
from repro.models import ssm as ref_ssm
from repro_torch import configs
from repro_torch.models import build_model, hybrid, ssm
from torch_parity import (BF16_JIT, BF16_TOL, TOL, assert_trees_close,
                          greedy_pair, launcher_pair, model_batches,
                          model_pair, serve_pair)

ARCH = "zamba2-7b"
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


def ssd_inputs(groups, s=64, h=8, p=4, n=6, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(2, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.normal(size=(2, s, h)))).astype(np.float32)
    a = -np.exp(rng.normal(size=h)).astype(np.float32)
    bm = rng.normal(size=(2, s, groups, n)).astype(np.float32)
    cm = rng.normal(size=(2, s, groups, n)).astype(np.float32)
    return x, dt, a, bm, cm


def recurrence(x, dt, a, bm, cm):
    """The port's ``ssd_recurrent_step`` over the whole sequence."""
    b, s, h, p = x.shape
    state = torch.zeros((b, h, bm.shape[-1], p))
    ys = []
    for t in range(s):
        y, state = ssm.ssd_recurrent_step(state, x[:, t], dt[:, t], a,
                                          bm[:, t], cm[:, t])
        ys.append(y)
    return torch.stack(ys, 1)


@pytest.mark.parametrize("groups", [1, 2, 4])
def test_ssd_chunked_matches_reference_and_recurrence(groups):
    """``ssd_chunked`` over four chunks equals the reference's and the
    port's recurrence, whose step equals the reference's step; head
    ``h`` reads group ``h // (H / G)``."""
    arrays = ssd_inputs(groups)
    ref = ref_ssm.ssd_chunked(*map(jnp.asarray, arrays), chunk=16)
    tx = [torch.from_numpy(a) for a in arrays]
    got = ssm.ssd_chunked(*tx, chunk=16)
    close(ref, got)
    close(ref, recurrence(*tx))
    x, dt, a, bm, cm = arrays
    s0 = np.random.default_rng(1).normal(size=(2, 8, 6, 4)).astype(
        np.float32)
    ry, rs = ref_ssm.ssd_recurrent_step(jnp.asarray(s0), x[:, 5], dt[:, 5],
                                        a, bm[:, 5], cm[:, 5])
    ty, ts = ssm.ssd_recurrent_step(torch.from_numpy(s0), *(
        torch.from_numpy(v) for v in (x[:, 5], dt[:, 5], a, bm[:, 5],
                                      cm[:, 5])))
    close(ry, ty)
    close(rs, ts)
    # head h reads group h // (H / G): the groups repeated, not tiled
    hg = 8 // groups
    per_head = [torch.from_numpy(np.repeat(v, hg, axis=2)) for v in (bm, cm)]
    close(ref, ssm.ssd_chunked(*tx[:3], *per_head, chunk=16))
    if groups > 1:
        tiled = [torch.from_numpy(np.tile(v, (1, 1, hg, 1))) for v in (bm, cm)]
        assert not torch.allclose(ssm.ssd_chunked(*tx[:3], *tiled, chunk=16),
                                  got, atol=1e-2)


def test_ssd_chunked_needs_whole_chunks():
    """``S % chunk != 0`` fails the reference's assert, and the port's."""
    arrays = [torch.from_numpy(a) for a in ssd_inputs(1, s=40)]
    with pytest.raises(AssertionError):
        ssm.ssd_chunked(*arrays, chunk=16)


def test_softplus_is_jax_softplus():
    """``jax.nn.softplus`` (``logaddexp(x, 0)``) at inputs on both sides
    of PyTorch's threshold of 20 and at the extremes, within float32's
    last place (XLA flushes the subnormal result at -100 to zero); in
    float32 PyTorch's thresholded ``softplus`` agrees as closely."""
    x = np.array([-100.0, -30.0, -1.0, 0.0, 1e-3, 5.0, 19.9, 20.0, 20.1,
                  30.0, 100.0, 3e38], np.float32)
    want = np.asarray(jax.nn.softplus(jnp.asarray(x)))
    for got in (ssm.softplus(torch.from_numpy(x)),
                torch.nn.functional.softplus(torch.from_numpy(x))):
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-7, atol=1e-37)


@pytest.mark.parametrize("groups", [1, 2, 4])
def test_mamba2_block_matches(groups):
    """The block's train path over two chunks and eight decode steps from
    the initial state, on the reference's parameters."""
    rcfg, cfg = (c.replace(ssm=dataclasses.replace(c.ssm, n_groups=groups))
                 for c in (ref_configs.get_smoke(ARCH),
                           configs.get_smoke(ARCH)))
    rp = jax.tree.map(lambda a: np.asarray(a, np.float32),
                      ref_ssm.init_mamba2(jax.random.PRNGKey(groups), rcfg))
    tp = jax.tree.map(torch.from_numpy, rp)
    x = np.random.default_rng(groups).normal(
        size=(B, S, cfg.d_model)).astype(np.float32)
    close(ref_ssm.mamba2_block_train(jnp.asarray(x), rp, rcfg),
          ssm.mamba2_block_train(torch.from_numpy(x), tp, cfg))
    rst = ref_ssm.mamba2_init_state(rcfg, B, jnp.float32)
    tst = ssm.mamba2_init_state(cfg, B, torch.float32, "cpu")
    for t in range(STEPS):
        ry, rst = ref_ssm.mamba2_block_decode(jnp.asarray(x[:, t:t + 1]), rp,
                                              rcfg, rst)
        ty, tst = ssm.mamba2_block_decode(torch.from_numpy(x[:, t:t + 1]),
                                          tp, cfg, tst)
        close(ry, ty)
    assert_trees_close(rst, tst)


#: the model-level variants: the smoke configuration, two SSM groups, and
#: a chunk of 16 so that the train forward crosses four chunks
VARIANTS = {"smoke": (), "groups2": (("ssm", "n_groups", 2),),
            "chunk16": (("ssm", "chunk_size", 16),)}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_train_logits_prefill_and_decode_match(variant):
    """``train_logits`` (logits, aux), ``prefill`` (last logits and the
    whole cache), ``init_cache`` and eight teacher-forced decode steps
    (logits, argmax, caches) equal the reference's."""
    rm, rp, tm, tp = model_pair(ARCH, nested=VARIANTS[variant])
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
    the ``ssm`` state stays float32."""
    rm, rp, tm, tp = model_pair(ARCH, "bfloat16")
    assert tp["mamba_layers"][0]["mix"]["in_proj"].dtype == torch.bfloat16
    assert tp["mamba_layers"][0]["mix"]["A_log"].dtype == torch.float32
    assert tm.init_cache(B, 4)["ssm"].dtype == torch.float32
    for rl, tl in greedy_pair(rm, rp, tm, tp, 12, **BF16_JIT):
        assert tl.dtype == torch.float32
        close(rl, tl, **BF16_TOL)


def test_shared_block_schedule_at_published_depth():
    """At 81 layers every 6: 13 full groups and a rest of 3, so 13
    shared-block applications alternating the two blocks, as the
    reference's; the cache holds one K/V per application."""
    rcfg, cfg = ref_configs.get_config(ARCH), configs.get_config(ARCH)
    assert hybrid._zamba_groups(cfg) == ref_hybrid._zamba_groups(rcfg) \
        == [6] * 13 + [3]
    assert hybrid.n_attn_applications(cfg) == \
        ref_hybrid.n_attn_applications(rcfg) == 13
    cache = build_model(cfg, device="cpu").init_cache(1, 2, device="meta")
    assert cache["k"].shape[0] == 13 and cache["ssm"].shape[0] == 81
    assert cache["ssm"].dtype == torch.float32


def test_prefill_returns_the_initial_states():
    """``zamba_prefill`` returns zero ``conv`` / ``ssm`` states and
    ``len`` at the prompt's length, as the reference's (queue C item 5):
    a decode step from its cache is not the train forward's next
    position."""
    rm, rp, tm, tp = model_pair(ARCH)
    rb, tb = model_batches(tm.cfg, B, S)
    _, cache = tm.prefill(tp, tb)
    assert float(cache["conv"].abs().max()) == 0.0
    assert float(cache["ssm"].abs().max()) == 0.0
    assert cache["len"].tolist() == [S, S]
    assert_trees_close(jax.jit(rm.prefill)(rp, rb)[1], cache)


@pytest.mark.parametrize("kv", ["vec", "scalar", "sharded"])
def test_engine_serves_the_references_tokens(kv):
    """The zamba2 smoke model through both packages' engines: the same
    tokens and ``PageStats``, the page counters equal to the
    ``model=None`` run's."""
    serve_pair(ARCH, kv)


def test_launcher_serves_zamba2():
    """``--arch zamba2-7b`` serves through the engine with the reference
    launcher's keys and page counters."""
    got = launcher_pair(ARCH, "--requests", "6", "--max-new", "6")
    assert got["completed"] == 6 and got["decode_tokens"] == 36
