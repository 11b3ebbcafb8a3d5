"""The port's model zoo (``repro_torch.models``, ``repro_torch.configs``) on
the CPU against the reference's (``repro.models``).

Every transformer arch the port has — dense GQA with QKV bias
(``qwen2.5-3b``), MQA with GeGLU and tied embeddings (``gemma-2b``),
qk-norm (``qwen3-32b``), plain GQA (``phi3-medium-14b``), the VLM patch
prefix (``phi-3-vision-4.2b``), MoE (``kimi-k2-1t-a32b``) and MLA + MoE
(``deepseek-v2-236b``) — runs its float32 smoke configuration on the
reference's parameters (converted by ``params_from_reference``) and the
same numpy inputs from a seed: ``train_logits``, ``prefill`` and its
cache, ``init_cache`` and eight teacher-forced decode steps agree within
``rtol = atol = 1e-4`` with equal argmax tokens, and the routers pick the
same experts; in bfloat16, twelve greedy decode steps pick the same
tokens with float32 logits within 1e-4.  Then ``apply_moe`` where tokens drop, chunked attention,
the clamped cache write, the int8 MLA cache, the analytic parameter
counts and the parameter shapes of the full configurations.
"""

import torch_parity  # noqa: F401

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.models import attention as ref_attention
from repro.models import build_model as ref_build_model
from repro.models import model_zoo as ref_zoo
from repro.models import moe as ref_moe
from repro_torch import configs
from repro_torch.models import attention, build_model, count_params_analytic
from repro_torch.models import moe
from repro_torch.models.convert import params_from_reference, reference_layout

ARCHS = ["qwen2.5-3b", "gemma-2b", "qwen3-32b", "phi3-medium-14b",
         "phi-3-vision-4.2b", "kimi-k2-1t-a32b", "deepseek-v2-236b"]
TOL = dict(rtol=1e-4, atol=1e-4)
B, S, STEPS = 2, 64, 8


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the smoke shapes gain nothing from more, and
    the suite's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


@functools.lru_cache(maxsize=None)
def pair(arch, **replace):
    """(reference model, its params, port model, the same params), both
    packages' smoke configuration of ``arch`` with ``replace`` applied."""
    rcfg = ref_configs.get_smoke(arch).replace(**replace)
    cfg = configs.get_smoke(arch).replace(**replace)
    rm = ref_build_model(rcfg)
    rp = rm.init_params(jax.random.PRNGKey(0))
    tm = build_model(cfg, device="cpu")
    return rm, rp, tm, params_from_reference(cfg, _np(rp), "cpu")


@functools.lru_cache(maxsize=None)
def pair_bf16(arch):
    """:func:`pair` of the bfloat16 smoke configuration: the float32
    pair's reference parameters cast leaf by leaf to the dtypes of the
    reference's bfloat16 init (its router stays float32)."""
    rm32, rp32, _, _ = pair(arch)
    rm = ref_build_model(rm32.cfg.replace(dtype="bfloat16"))
    dtypes = jax.eval_shape(rm.init_params, jax.random.PRNGKey(0))
    rp = jax.tree.map(lambda a, s: a.astype(s.dtype), rp32, dtypes)
    cfg = configs.get_smoke(arch).replace(dtype="bfloat16")
    tm = build_model(cfg, device="cpu")
    return rm, rp, tm, params_from_reference(cfg, _np(rp), "cpu")


def batches(cfg, seed=0):
    """The same batch for both packages: (jax dict, torch dict)."""
    rng = np.random.default_rng(seed)
    if cfg.family == "vlm":
        n = cfg.frontend.n_positions
        toks = rng.integers(0, cfg.vocab_size, (B, S - n)).astype(np.int32)
        pat = rng.normal(size=(B, n, cfg.frontend.feature_dim)).astype(
            np.float32)
        return ({"tokens": jnp.asarray(toks), "patches": jnp.asarray(pat)},
                {"tokens": torch.from_numpy(toks),
                 "patches": torch.from_numpy(pat)})
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    return {"tokens": jnp.asarray(toks)}, {"tokens": torch.from_numpy(toks)}


def close(ref, port, **tol):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref),
                               **(tol or TOL))


def caches_close(ref, port, **tol):
    assert sorted(ref) == sorted(port)
    for key in ref:
        assert tuple(ref[key].shape) == tuple(port[key].shape), key
        assert str(ref[key].dtype) == str(port[key].dtype).replace(
            "torch.", ""), key
        close(ref[key], port[key], **tol)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_logits_and_prefill_match(arch):
    """``train_logits`` (logits, aux loss, loss mask, targets) and
    ``prefill`` (last logits and the whole cache) equal the reference's."""
    rm, rp, tm, tp = pair(arch)
    rb, tb = batches(rm.cfg)
    rl, raux = jax.jit(rm.train_logits)(rp, rb)
    tl, taux = tm.train_logits(tp, tb)
    close(rl, tl)
    assert (np.asarray(rl).argmax(-1) == tl.numpy().argmax(-1)).all()
    close(raux["aux_loss"], taux["aux_loss"])
    for key in ("loss_mask", "targets"):
        np.testing.assert_array_equal(np.asarray(raux[key]),
                                      taux[key].numpy())
    rlast, rcache = jax.jit(rm.prefill)(rp, rb)
    tlast, tcache = tm.prefill(tp, tb)
    close(rlast, tlast)
    caches_close(rcache, tcache)


@pytest.mark.parametrize("arch", ARCHS)
def test_teacher_forced_decode_matches(arch):
    """``init_cache`` and eight teacher-forced decode steps: logits,
    argmax tokens, caches and (MoE) router indices equal the
    reference's."""
    rm, rp, tm, tp = pair(arch)
    rcache, tcache = rm.init_cache(B, 16), tm.init_cache(B, 16)
    caches_close(rcache, tcache)
    toks = np.array(batches(rm.cfg, seed=1)[0]["tokens"])
    router = rm.cfg.moe is not None
    rdec = jax.jit(rm.decode_step_router if router else rm.decode_step)
    tdec = tm.decode_step_router if router else tm.decode_step
    for t in range(STEPS):
        tok = toks[:, t:t + 1]
        rout = rdec(rp, {"tokens": jnp.asarray(tok)}, rcache)
        tout = tdec(tp, {"tokens": torch.from_numpy(tok)}, tcache)
        rcache, tcache = rout[1], tout[1]
        close(rout[0], tout[0])
        assert (np.asarray(rout[0]).argmax(-1)
                == tout[0].numpy().argmax(-1)).all()
        if router:
            assert tout[2].dtype == torch.int32
            np.testing.assert_array_equal(np.asarray(rout[2]),
                                          tout[2].numpy())
    caches_close(rcache, tcache)


#: bfloat16 parity: the reference compiled without XLA's excess precision
#: (its CPU compiler otherwise keeps some bfloat16 intermediates in
#: float32, a rounding the reference's code does not ask for), so both
#: packages round where the code says.  The logits are float32 in both:
#: greedy decode within TOL (a logit rounded to bfloat16 is up to 2**-9 of
#: itself off, ten times TOL at the smoke models' logits), and training
#: logits, over 128 positions where a bfloat16 rounding of another
#: summation order may flip, within bfloat16's epsilon
BF16_JIT = dict(compiler_options={"xla_allow_excess_precision": False})
BF16_TOL = dict(rtol=2.0 ** -7, atol=2.0 ** -7)


@pytest.mark.parametrize("arch", ARCHS)
def test_bfloat16_greedy_decode_matches(arch):
    """The bfloat16 smoke model on the reference's parameters: twelve
    greedy decode steps pick the same tokens (and experts) with float32
    logits within ``TOL`` of the reference's, whose float32 products
    (``preferred_element_type``: the GLU, the logits) the port does not
    round; ``train_logits`` within bfloat16's epsilon, argmax equal."""
    rm, rp, tm, tp = pair_bf16(arch)
    assert tp["embed"]["table"].dtype == torch.bfloat16
    rb, tb = batches(rm.cfg)
    rl = np.asarray(jax.jit(rm.train_logits, **BF16_JIT)(rp, rb)[0])
    tl = tm.train_logits(tp, tb)[0]
    assert tl.dtype == torch.float32
    close(rl, tl, **BF16_TOL)
    assert (rl.argmax(-1) == tl.numpy().argmax(-1)).all()
    router = rm.cfg.moe is not None
    rdec = jax.jit(rm.decode_step_router if router else rm.decode_step,
                   **BF16_JIT)
    tdec = tm.decode_step_router if router else tm.decode_step
    rcache, tcache = rm.init_cache(B, 16), tm.init_cache(B, 16)
    tok = np.array([[1], [2]], np.int32)
    for _ in range(12):
        rout = rdec(rp, {"tokens": jnp.asarray(tok)}, rcache)
        tout = tdec(tp, {"tokens": torch.from_numpy(tok)}, tcache)
        rcache, tcache = rout[1], tout[1]
        assert tout[0].dtype == torch.float32
        close(rout[0], tout[0])
        if router:
            np.testing.assert_array_equal(np.asarray(rout[2]),
                                          tout[2].numpy())
        tok = np.asarray(rout[0]).argmax(-1).astype(np.int32).reshape(B, 1)
        np.testing.assert_array_equal(tok, tout[0].numpy().argmax(-1)
                                      .reshape(B, 1))


def _moe_inputs(cfg, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(2, 32, cfg.d_model)).astype(np.float32)
    p = _np(ref_moe.init_moe(jax.random.PRNGKey(seed), cfg))
    tp = jax.tree.map(torch.from_numpy, p)
    return x, p, tp


@pytest.mark.parametrize("combine", ["scatter", "gather"])
def test_apply_moe_drops_the_same_tokens(combine):
    """With a capacity factor small enough that experts overflow, the
    port keeps the same (token, choice) pairs as the reference's sort
    (derived here from its router indices) and gives the same outputs,
    router indices and aux values, under both combines."""
    cfg, rcfg = (c.replace(moe_combine=combine, moe=dataclasses.replace(
        c.moe, capacity_factor=0.25)) for c in (
            configs.get_smoke("kimi-k2-1t-a32b"),
            ref_configs.get_smoke("kimi-k2-1t-a32b")))
    x, p, tp = _moe_inputs(cfg)
    rout, raux = ref_moe.apply_moe(jnp.asarray(x), p, rcfg)
    tout, taux = moe.apply_moe(torch.from_numpy(x), tp, cfg)
    close(rout, tout)
    idx = np.asarray(raux["router_top_idx"])
    np.testing.assert_array_equal(idx, taux["router_top_idx"].numpy())
    # the reference's keep mask from its router indices: a stable sort by
    # expert, each (token, choice) kept while its rank is under capacity
    cap = ref_moe._capacity(idx.shape[0], rcfg.moe)
    flat = idx.reshape(-1)
    order = np.argsort(flat, kind="stable")
    counts = np.bincount(flat, minlength=cfg.moe.n_experts)
    starts = np.cumsum(counts) - counts
    keep = np.empty(flat.shape, bool)
    keep[order] = np.arange(flat.size) - starts[flat[order]] < cap
    assert not keep.all()
    np.testing.assert_array_equal(keep.reshape(idx.shape),
                                  taux["keep"].numpy())
    np.testing.assert_array_equal(np.asarray(raux["expert_load"]),
                                  taux["expert_load"].numpy())
    for key in ("dropped_frac", "moe_aux_loss"):
        close(raux[key], taux[key])
    assert float(taux["dropped_frac"]) > 0


@pytest.mark.parametrize("act", ["swiglu", "geglu", "gelu", "relu"])
def test_layers_match(act):
    """The shared layers no arch's smoke model reaches with every option:
    ``layer_norm``, ``rms_norm`` and ``apply_ffn`` under each activation
    (``gelu`` the tanh approximation, as ``jax.nn.gelu``), and interleaved
    RoPE at large positions."""
    from repro.models import layers as ref_layers
    from repro_torch.models import layers

    rng = np.random.default_rng(7)
    x = rng.normal(size=(2, 5, 32)).astype(np.float32)
    norm = {"scale": rng.normal(size=32).astype(np.float32),
            "bias": rng.normal(size=32).astype(np.float32)}
    tnorm = {k: torch.from_numpy(v) for k, v in norm.items()}
    for fn in ("layer_norm", "rms_norm"):
        close(getattr(ref_layers, fn)(jnp.asarray(x), norm),
              getattr(layers, fn)(torch.from_numpy(x), tnorm))
    ffn = _np(ref_layers.init_ffn(jax.random.PRNGKey(1), 32, 48, act,
                                  jnp.float32))
    close(ref_layers.apply_ffn(jnp.asarray(x), ffn, act),
          layers.apply_ffn(torch.from_numpy(x),
                           {k: torch.from_numpy(v) for k, v in ffn.items()},
                           act))
    q = rng.normal(size=(2, 5, 3, 16)).astype(np.float32)
    pos = np.array([[0, 1, 7, 4095, 100_000]] * 2, np.int32)
    close(ref_layers.apply_rope(jnp.asarray(q), jnp.asarray(pos), 1e6),
          layers.apply_rope(torch.from_numpy(q), torch.from_numpy(pos), 1e6))


def test_top_k_takes_the_lower_index_on_ties():
    """Equal router probabilities: the lower expert index first, as
    ``jax.lax.top_k`` orders them."""
    probs = np.array([[0.1, 0.3, 0.3, 0.3], [0.25, 0.25, 0.25, 0.25]],
                     np.float32)
    _, ref_idx = jax.lax.top_k(jnp.asarray(probs), 3)
    _, idx = moe.top_k(torch.from_numpy(probs), 3)
    np.testing.assert_array_equal(np.asarray(ref_idx), idx.numpy())
    assert idx.tolist() == [[1, 2, 3], [0, 1, 2]]


def test_attention_chunked_at_two_chunks():
    """``S = 2 x attn_chunk`` takes the chunked loop (each query block
    against the whole key axis) and equals the reference's scan; a length
    that is not a multiple falls back to full attention in both."""
    rng = np.random.default_rng(3)
    chunk = 64
    for s in (2 * chunk, 2 * chunk - 8):
        q = rng.normal(size=(2, s, 4, 16)).astype(np.float32)
        k = rng.normal(size=(2, s, 2, 16)).astype(np.float32)
        v = rng.normal(size=(2, s, 2, 16)).astype(np.float32)
        ref = ref_attention.attention_chunked(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), chunk=chunk)
        got = attention.attention_chunked(
            torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
            chunk=chunk)
        close(ref, got)
        close(ref, attention.attention_full(
            torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v)))


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "deepseek-v2-236b"],
                         ids=["attn", "mla"])
def test_cache_write_past_the_end_is_clamped(arch):
    """A decode step whose ``len`` is at or past the cache's end writes
    the last row, as ``dynamic_update_slice`` clamps its start; logits
    and caches equal the reference's, and nothing raises."""
    rm, rp, tm, tp = pair(arch)
    rcache, tcache = rm.init_cache(B, 4), tm.init_cache(B, 4)
    lens = np.array([4, 7], np.int32)
    rcache = dict(rcache, len=jnp.asarray(lens))
    tcache = dict(tcache, len=torch.from_numpy(lens))
    tok = np.array([[5], [9]], np.int32)
    rdec = rm.decode_step_router if rm.cfg.moe else rm.decode_step
    tdec = tm.decode_step_router if tm.cfg.moe else tm.decode_step
    rout = jax.jit(rdec)(rp, {"tokens": jnp.asarray(tok)}, rcache)
    tout = tdec(tp, {"tokens": torch.from_numpy(tok)}, tcache)
    close(rout[0], tout[0])
    caches_close(rout[1], tout[1])
    first = "latent" if rm.cfg.mla else "k"
    assert float(tout[1][first][:, :, -1].abs().sum()) > 0
    assert tout[1]["len"].tolist() == [5, 8]


def test_int8_mla_cache_matches():
    """``kv_cache_dtype="int8"``: twelve teacher-forced decode steps give
    logits within 1e-3 of the reference's, int8 entries equal or one
    apart (a quotient on a rounding edge) with at least 99.9% equal, and
    scales within float tolerance."""
    rm, rp, tm, tp = pair("deepseek-v2-236b", kv_cache_dtype="int8")
    rcache, tcache = rm.init_cache(B, 16), tm.init_cache(B, 16)
    assert tcache["latent"].dtype == torch.int8
    toks = np.random.default_rng(0).integers(
        0, rm.cfg.vocab_size, (B, 12)).astype(np.int32)
    rdec = jax.jit(rm.decode_step)
    for t in range(12):
        tok = toks[:, t:t + 1]
        rl, rcache = rdec(rp, {"tokens": jnp.asarray(tok)}, rcache)
        tl, tcache = tm.decode_step(tp, {"tokens": torch.from_numpy(tok)},
                                    tcache)
        close(rl, tl, rtol=1e-3, atol=1e-3)
    ref8 = np.asarray(rcache["latent"]).astype(np.int32)
    got8 = tcache["latent"].numpy().astype(np.int32)
    assert np.abs(ref8 - got8).max() <= 1
    assert (ref8 == got8).mean() >= 0.999
    close(rcache["latent_scale"], tcache["latent_scale"])
    close(rcache["rope"], tcache["rope"])


@pytest.mark.parametrize("arch", sorted(ref_configs.ARCH_IDS))
def test_param_counts_match(arch):
    """``count_params_analytic`` (total and active) on every full
    configuration, the ``ArchConfig`` methods included."""
    ref_cfg, cfg = ref_configs.get_config(arch), configs.get_config(arch)
    assert cfg == configs.get_config(arch) and cfg.name == ref_cfg.name
    for active in (False, True):
        assert count_params_analytic(cfg, active) == \
            ref_zoo.count_params_analytic(ref_cfg, active)
    assert cfg.param_count() == ref_cfg.param_count()
    assert cfg.active_param_count() == ref_cfg.active_param_count()


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from _leaves(tree[key], prefix + (key,))
    else:
        yield prefix, tuple(tree.shape), str(tree.dtype).replace("torch.",
                                                                 "")


@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_match_on_full_configs(arch):
    """On the full configuration, the port's ``param_specs`` ("meta"
    tensors, stacked back into the reference's layout) have the shapes
    and dtypes of the reference's ``jax.eval_shape`` leaves; the cache
    and input specs too."""
    rm = ref_build_model(ref_configs.get_config(arch))
    tm = build_model(configs.get_config(arch), device="cpu")
    ref_specs = rm.param_specs()
    port = tm.param_specs()
    assert all(p.device.type == "meta" for p in port.parameters())
    layout = reference_layout(tm.cfg, port)
    assert list(_leaves(layout)) == list(_leaves(ref_specs))
    shape = ref_configs.SHAPES[2]
    assert list(_leaves(tm.cache_specs(shape))) == \
        list(_leaves(rm.cache_specs(shape)))
    for shp in ref_configs.SHAPES[:3]:
        assert list(_leaves(tm.input_specs(shp))) == \
            list(_leaves(rm.input_specs(shp)))


def test_reference_layout_round_trips():
    """``reference_layout`` inverts ``params_from_reference``."""
    _, rp, tm, tp = pair("deepseek-v2-236b")
    back = reference_layout(tm.cfg, tp)
    want = _np(rp)
    assert list(_leaves(back)) == [
        (k, s, "float32") for k, s, _ in _leaves(want)]
    for (k, _, _), a in zip(_leaves(back), _flat(back)):
        np.testing.assert_array_equal(a.numpy(), _get(want, k))


def _flat(tree):
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from _flat(tree[key])
    else:
        yield tree


def _get(tree, path):
    for key in path:
        tree = tree[key]
    return tree


def test_build_model_needs_a_card_by_default(monkeypatch):
    """Without CUDA, the default device raises; ``device="cpu"`` builds."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_model(configs.get_smoke("qwen2.5-3b"))
    assert build_model(configs.get_smoke("qwen2.5-3b"),
                       device="cpu").device.type == "cpu"
