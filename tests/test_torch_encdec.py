"""The port's encoder-decoder (``repro_torch.models.encdec``, the seamless
backbone) on the CPU against the reference's (``repro.models.encdec``).

The seamless smoke model on the reference's parameters
(``params_from_reference``) and the same frame features and tokens:
``encode``, ``train_logits``, ``prefill`` (last logits and the whole
cache, the cross K/V over the encoder's length), ``init_cache`` (the
cross K/V zeros of ``max_len`` rows, as the reference's facade makes
them) and eight teacher-forced decode steps with their caches within
``1e-4``; decode steps from the prefill's cache against the train
forward; the bfloat16 model's greedy tokens; the shape-only specs of the
published configuration.  Then ``ServingEngine`` under ``vec`` /
``scalar`` / ``sharded`` (the decoder cross-attends over zeros, as the
reference's engine does) and the launcher with ``--arch
seamless-m4t-large-v2`` against the reference's.
"""

import torch_parity  # noqa: F401

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.models import build_model as ref_build_model
from repro.models import encdec as ref_encdec
from repro_torch import configs
from repro_torch.models import build_model, encdec
from repro_torch.models.convert import reference_layout
from torch_parity import (BF16_JIT, BF16_TOL, TOL, assert_trees_close,
                          greedy_pair, launcher_pair, model_batches,
                          model_pair, serve_pair)

ARCH = "seamless-m4t-large-v2"
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


def test_encode_train_logits_and_prefill_match():
    """``encode``, ``train_logits`` (logits, aux) and ``prefill`` (last
    logits; self and cross K/V, ``len``) equal the reference's."""
    rm, rp, tm, tp = model_pair(ARCH)
    rb, tb = model_batches(tm.cfg, B, S)
    close(ref_encdec.encode(rp, rm.cfg, rb["features"]),
          encdec.encode(tp, tm.cfg, tb["features"]))
    rl, raux = jax.jit(rm.train_logits)(rp, rb)
    tl, taux = tm.train_logits(tp, tb)
    close(rl, tl)
    assert (np.asarray(rl).argmax(-1) == tl.numpy().argmax(-1)).all()
    assert_trees_close(raux, taux)
    rlast, rcache = jax.jit(rm.prefill)(rp, rb)
    tlast, tcache = tm.prefill(tp, tb)
    close(rlast, tlast)
    assert_trees_close(rcache, tcache)


def test_teacher_forced_decode_matches():
    """``init_cache`` (cross K/V zeros of ``max_len`` rows) and eight
    teacher-forced decode steps: logits, argmax and caches equal the
    reference's."""
    rm, rp, tm, tp = model_pair(ARCH)
    rcache, tcache = rm.init_cache(B, 16), tm.init_cache(B, 16)
    assert tuple(tcache["xk"].shape) == (2, B, 16, 4, 16)
    assert_trees_close(rcache, tcache)
    toks = np.asarray(model_batches(tm.cfg, B, S, seed=1)[0]["tokens"])
    rdec = jax.jit(rm.decode_step)
    for t in range(STEPS):
        tok = toks[:, t:t + 1]
        rl, rcache = rdec(rp, {"tokens": jnp.asarray(tok)}, rcache)
        tl, tcache = tm.decode_step(tp, {"tokens": torch.from_numpy(tok)},
                                    tcache)
        close(rl, tl)
        assert (np.asarray(rl).argmax(-1) == tl.numpy().argmax(-1)).all()
    assert_trees_close(rcache, tcache)


def test_decode_from_the_prefill_cache():
    """The prefill's cache (its cross K/V over the encoder's frames) grown
    to more rows: decode steps continue the train forward within 2e-4,
    in both packages alike."""
    rm, rp, tm, tp = model_pair(ARCH)
    rb, tb = model_batches(tm.cfg, B, S)
    n = 56
    full = tm.train_logits(tp, tb)[0]
    _, small = tm.prefill(tp, {"features": tb["features"],
                               "tokens": tb["tokens"][:, :n]})
    _, rsmall = jax.jit(rm.prefill)(rp, {"features": rb["features"],
                                         "tokens": rb["tokens"][:, :n]})
    cache = dict(small, k=torch.zeros((2, B, S, 4, 16)),
                 v=torch.zeros((2, B, S, 4, 16)))
    cache["k"][:, :, :n], cache["v"][:, :, :n] = small["k"], small["v"]
    rcache = dict(rsmall, k=jnp.asarray(cache["k"].numpy()),
                  v=jnp.asarray(cache["v"].numpy()))
    rdec = jax.jit(rm.decode_step)
    for t in range(n, S):
        tok = tb["tokens"][:, t:t + 1]
        tl, cache = tm.decode_step(tp, {"tokens": tok}, cache)
        rl, rcache = rdec(rp, {"tokens": jnp.asarray(tok.numpy())}, rcache)
        close(rl, tl)
        if t + 1 < S:
            close(full[:, t].numpy(), tl[:, 0], rtol=2e-4, atol=2e-4)


def test_bfloat16_greedy_decode_matches():
    """The bfloat16 smoke model: twelve greedy decode steps pick the same
    tokens with float32 logits within ``BF16_TOL`` of the reference
    compiled without excess precision."""
    rm, rp, tm, tp = model_pair(ARCH, "bfloat16")
    assert tp["dec_layers"][0]["cross_attn"]["wq"].dtype == torch.bfloat16
    for rl, tl in greedy_pair(rm, rp, tm, tp, 12, **BF16_JIT):
        assert tl.dtype == torch.float32
        close(rl, tl, **BF16_TOL)


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from _leaves(tree[key], prefix + (key,))
    elif isinstance(tree, (list, tuple)):
        for i, value in enumerate(tree):
            yield from _leaves(value, prefix + (i,))
    else:
        yield prefix, tuple(tree.shape), str(tree.dtype).replace("torch.",
                                                                 "")


@pytest.mark.parametrize("arch", ["zamba2-7b", "xlstm-1.3b", ARCH])
def test_specs_match_on_full_configs(arch):
    """On the published configuration of each family this slice adds, the
    port's ``param_specs`` ("meta" tensors, stacked back into the
    reference's layout) have the shapes and dtypes of the reference's
    ``jax.eval_shape`` leaves, and so do the cache and input specs."""
    rm = ref_build_model(ref_configs.get_config(arch))
    tm = build_model(configs.get_config(arch), device="cpu")
    port = tm.param_specs()
    assert all(p.device.type == "meta" for p in port.parameters())
    assert list(_leaves(reference_layout(tm.cfg, port))) == \
        list(_leaves(rm.param_specs()))
    shape = ref_configs.SHAPES[2]
    assert list(_leaves(tm.cache_specs(shape))) == \
        list(_leaves(rm.cache_specs(shape)))
    for shp in ref_configs.SHAPES[:3]:
        assert list(_leaves(tm.input_specs(shp))) == \
            list(_leaves(rm.input_specs(shp)))


@pytest.mark.parametrize("kv", ["vec", "scalar", "sharded"])
def test_engine_serves_the_references_tokens(kv):
    """The seamless smoke model through both packages' engines: the same
    tokens and ``PageStats``, the page counters equal to the
    ``model=None`` run's."""
    eng = serve_pair(ARCH, kv)
    assert float(eng.cache["xk"].abs().max()) == 0.0


def test_launcher_serves_seamless():
    """``--arch seamless-m4t-large-v2`` serves through the engine with the
    reference launcher's keys and page counters."""
    got = launcher_pair(ARCH, "--requests", "6", "--max-new", "6")
    assert got["completed"] == 6 and got["decode_tokens"] == 36
