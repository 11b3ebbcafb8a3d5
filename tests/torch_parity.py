"""Shared helpers of the port's parity tests (``tests/test_torch_*.py``).

:func:`registry_arrays` reads either package's cache as plain numpy, so
the tests compare state, not only counters; :func:`state_arrays` reads an
assigner and its registry as the arrays that
``repro_torch.core.state_from_arrays`` takes; :func:`kernel_inputs` makes
the kernels' test inputs from a seed; :func:`chip_smoke` loads the smoke
script, whose edge inputs the tests share; :func:`model_pair`,
:func:`model_batches`, :func:`assert_trees_close` and :func:`serve_pair`
hold both packages' models and engines on one set of parameters;
:func:`train_pair`, :func:`train_batches`, :func:`clone_state` and
:func:`assert_leaves_rel` their train states.
(``tests/conftest.py`` makes the reference importable under JAX 0.9.0.)
"""

from __future__ import annotations

import functools
import importlib.util
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np
import pytest

__all__ = ["registry_arrays", "assert_registries_equal", "kernel_inputs",
           "first_primes", "state_arrays", "assert_state_arrays_equal",
           "BIG_PRIMES", "chip_smoke", "model_pair", "model_batches",
           "assert_trees_close", "greedy_pair", "serve_pair", "launcher_pair",
           "TOL", "BF16_JIT", "BF16_TOL", "clone_state", "train_batches",
           "train_pair", "port_layout_np", "assert_leaves_rel", "LR",
           "ref_step_and_grads", "assert_train_metrics",
           "assert_params_near", "check_train_step", "one_torch_thread"]

BIG_PRIMES = np.array([1_000_003, 1_000_033, 1_000_037, 1_000_039,
                       999_983, 999_979], dtype=np.int64)


def first_primes(k):
    """The first ``k`` primes (k <= 550)."""
    sieve = np.ones(4000, dtype=bool)
    sieve[:2] = False
    for i in range(2, 64):
        sieve[i * i::i] = False
    return np.nonzero(sieve)[0][:k].astype(np.int64)


def kernel_inputs(n, p, dtype, seed):
    """Composites (products of pool primes, random values, 0 and 1) and a
    pool of ``p`` distinct primes (the registry invariant) padded with 0
    and 1."""
    rng = np.random.default_rng(seed)
    primes = first_primes(max(p - 3, 1))
    if dtype == np.int64:
        primes[-len(BIG_PRIMES):] = BIG_PRIMES[:len(primes)]
    k = rng.integers(1, 3, size=n)
    picks = rng.choice(primes, size=(n, 2))
    comps = np.where(np.arange(2)[None, :] < k[:, None], picks, 1).prod(1)
    hi = 2**31 - 1 if dtype == np.int32 else 2**62
    comps = np.where(rng.random(n) < 0.2, rng.integers(0, hi, size=n), comps)
    comps[:2] = [0, 1][:n]
    pool = np.concatenate([rng.permutation(primes), [0, 1, 0]])[:p]
    return comps.astype(dtype), pool.astype(dtype)


@functools.lru_cache(maxsize=None)
def chip_smoke():
    """``chip_smoke.py`` at the root of the checkout, as a module (it
    imports only numpy and torch at load time): the tests hold the flat
    kernels on the edge inputs it checks on the card."""
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def registry_arrays(cache) -> Dict[str, object]:
    """A paged-KV cache's PFCS state as numpy arrays: the composites in
    registry order, ``primes_array()``, the page -> prime map (0 for a
    page without a prime), and each composite's relationship's member
    primes in iteration order."""
    reg = cache.registry
    comps = reg.composites_array()
    page_prime = np.asarray(
        [cache.assigner.prime_of(pid) or 0
         for pid in range(cache._next_page)], dtype=np.int64)
    members: List[Tuple[int, ...]] = []
    for c in comps:
        rel = reg.relationship_of_composite(int(c))
        members.append(tuple(int(q) for q in rel.primes) if rel else ())
    return {"composites": np.asarray(comps, dtype=np.int64),
            "primes": np.asarray(reg.primes_array(), dtype=np.int64),
            "page_prime": page_prime,
            "members": members}


def assert_registries_equal(a, b) -> None:
    """Both caches hold the same registry, page primes and member order."""
    ra, rb = registry_arrays(a), registry_arrays(b)
    for key in ("composites", "primes", "page_prime"):
        np.testing.assert_array_equal(ra[key], rb[key], err_msg=key)
    assert ra["members"] == rb["members"]


def state_arrays(assigner) -> Dict[str, object]:
    """Either package's prime assignment, prime pools and composite
    registry as the keyword arguments of
    ``repro_torch.core.state_from_arrays`` (plain arrays and ints)."""
    reg = assigner.registry
    data = [(d, p, lvl) for lvl in sorted(assigner._data_to_prime)
            for d, p in assigner._data_to_prime[lvl].items()]
    rels = list(reg._by_id.values())
    members = [int(q) for r in rels for q in r.primes]
    pools = [assigner.allocator.pools[lvl]
             for lvl in sorted(assigner.allocator.pools)]
    comps = list(reg._by_composite.items())
    return {
        "data_ids": np.asarray([d for d, _, _ in data], dtype=np.int64),
        "data_primes": np.asarray([p for _, p, _ in data], dtype=np.int64),
        "data_levels": np.asarray([lvl for _, _, lvl in data],
                                  dtype=np.int64),
        "pool_next": np.asarray([pl._next_idx for pl in pools],
                                dtype=np.int64),
        "pool_free": [np.asarray(sorted(pl._free), dtype=np.int64)
                      for pl in pools],
        "rel_ids": np.asarray([r.rel_id for r in rels], dtype=np.int64),
        "rel_offsets": np.cumsum([0] + [len(r.primes) for r in rels]),
        "rel_members": np.asarray(members, dtype=np.int64),
        "rel_weights": np.asarray([r.weight for r in rels]),
        "rel_kinds": [r.kind for r in rels],
        "composites": np.asarray([c for c, _ in comps], dtype=np.int64),
        "composite_rel": np.asarray([r for _, r in comps], dtype=np.int64),
        "next_rel_id": reg._next_id,
        "version": reg.version,
        "epoch": assigner.epoch,
        "max_bits": reg.max_bits,
    }


def assert_state_arrays_equal(a, b) -> None:
    assert a.keys() == b.keys()
    for key in a:
        if key in ("pool_free", "rel_kinds"):
            assert [list(x) for x in a[key]] == [list(x) for x in b[key]], key
        else:
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)


# --------------------------------------------------------------------------- #
# the model zoo: both packages on one set of parameters                       #
# --------------------------------------------------------------------------- #

#: float32 parity of logits, caches and states
TOL = dict(rtol=1e-4, atol=1e-4)
#: the reference compiled without XLA's excess precision (its CPU compiler
#: otherwise keeps some bfloat16 intermediates in float32), so both
#: packages round where the code says
BF16_JIT = dict(compiler_options={"xla_allow_excess_precision": False})
#: bfloat16 logits: both packages' float32 matmuls sum in their own
#: orders, so a value on a bfloat16 rounding edge may round to the
#: neighbouring bfloat16 in one of them (one place, 2**-8 of the value)
BF16_TOL = dict(rtol=2.0 ** -7, atol=2.0 ** -7)


def _configs(arch: str, dtype: str, nested: tuple, replace: tuple):
    """Both packages' smoke configurations of ``arch`` with ``replace``
    ((field, value) pairs) and ``nested`` ((field, subfield, value):
    a field of a nested config such as ``ssm``) applied."""
    import dataclasses

    from repro import configs as ref_configs
    from repro_torch import configs

    out = []
    for pkg in (ref_configs, configs):
        cfg = pkg.get_smoke(arch).replace(dtype=dtype, **dict(replace))
        for field, sub, value in nested:
            cfg = cfg.replace(**{field: dataclasses.replace(
                getattr(cfg, field), **{sub: value})})
        out.append(cfg)
    return out


def _np_tree(tree):
    import jax

    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


@functools.lru_cache(maxsize=None)
def model_pair(arch: str, dtype: str = "float32", nested: tuple = (),
               replace: tuple = ()):
    """(reference model, its params, port model, the same params) of the
    smoke configuration of ``arch`` (see :func:`_configs`).  In bfloat16
    the reference's parameters are the float32 pair's cast leaf by leaf to
    the dtypes of its bfloat16 init (float32 leaves stay float32)."""
    import jax

    from repro.models import build_model as ref_build_model
    from repro_torch.models import build_model
    from repro_torch.models.convert import params_from_reference

    rcfg, cfg = _configs(arch, dtype, nested, replace)
    rm = ref_build_model(rcfg)
    if dtype == "float32":
        rp = rm.init_params(jax.random.PRNGKey(0))
    else:
        rp32 = model_pair(arch, "float32", nested, replace)[1]
        specs = jax.eval_shape(rm.init_params, jax.random.PRNGKey(0))
        rp = jax.tree.map(lambda a, s: a.astype(s.dtype), rp32, specs)
    tm = build_model(cfg, device="cpu")
    return rm, rp, tm, params_from_reference(cfg, _np_tree(rp), "cpu")


def model_batches(cfg, b: int, s: int, seed: int = 0):
    """The same batch for both packages, (jax dict, torch dict): tokens,
    and the audio family's frame features (``S_enc = s``)."""
    import jax.numpy as jnp
    import torch

    rng = np.random.default_rng(seed)
    arrays = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(
        np.int32)}
    if cfg.family == "audio":
        arrays["features"] = rng.normal(
            size=(b, s, cfg.frontend.feature_dim)).astype(np.float32)
    return ({k: jnp.asarray(v) for k, v in arrays.items()},
            {k: torch.from_numpy(v) for k, v in arrays.items()})


def assert_trees_close(ref, port, path: str = "", **tol) -> None:
    """Nested dicts (and lists) of arrays: the same keys, shapes and
    dtypes, the values within ``tol`` (:data:`TOL` by default)."""
    if isinstance(ref, dict):
        assert sorted(ref) == sorted(port), path
        for key in ref:
            assert_trees_close(ref[key], port[key], f"{path}/{key}", **tol)
        return
    if isinstance(ref, (list, tuple)):
        assert len(ref) == len(port), path
        for i, (a, b) in enumerate(zip(ref, port)):
            assert_trees_close(a, b, f"{path}[{i}]", **tol)
        return
    assert tuple(ref.shape) == tuple(port.shape), path
    assert str(ref.dtype) == str(port.dtype).replace("torch.", ""), path
    np.testing.assert_allclose(port.detach().float().numpy(),
                               np.asarray(ref, np.float32),
                               err_msg=path, **(tol or TOL))


def greedy_pair(rm, rp, tm, tp, steps: int, b: int = 2, max_len: int = 16,
                **jit):
    """``steps`` greedy decode steps from ``init_cache`` in both packages
    from tokens ``1..b``: yields (reference logits, port logits) each
    step; the next token is the reference's argmax, which must equal the
    port's."""
    import jax
    import jax.numpy as jnp
    import torch

    rdec = jax.jit(rm.decode_step, **jit)
    rcache, tcache = rm.init_cache(b, max_len), tm.init_cache(b, max_len)
    tok = np.arange(1, b + 1, dtype=np.int32).reshape(b, 1)
    for _ in range(steps):
        rl, rcache = rdec(rp, {"tokens": jnp.asarray(tok)}, rcache)
        tl, tcache = tm.decode_step(tp, {"tokens": torch.from_numpy(tok)},
                                    tcache)
        yield rl, tl
        tok = np.asarray(rl).argmax(-1).astype(np.int32).reshape(b, 1)
        np.testing.assert_array_equal(
            tok, tl.numpy().argmax(-1).reshape(b, 1))


#: the serving engines' configuration for the model families (a small
#: HBM, so pages evict)
ENGINE_KW = dict(max_batch=3, max_seq=64, page_size=8, hbm_pages=10,
                 prefetch_budget=2)


def serving_prompts(vocab: int, n: int = 7, shared: int = 20):
    """The launcher's recipe: a shared prefix, then 4-11 tokens each."""
    rng = np.random.default_rng(0)
    prefix = [int(t) for t in rng.integers(0, vocab, size=shared)]
    return [prefix + [int(t) for t in rng.integers(
        0, vocab, size=int(rng.integers(4, 12)))] for _ in range(n)]


def _serve(eng, prompts, max_new):
    for prompt in prompts:
        eng.submit(prompt, max_new_tokens=max_new)
    return {r.req_id: list(r.generated) for r in eng.run_until_idle()}


def serve_pair(arch: str, kv: str, max_new: int = 5):
    """The same prompts through the reference's ``ServingEngine`` and the
    port's on one set of the arch's smoke parameters, and through the
    port's ``model=None`` engine: asserts every request completes with
    the same tokens in both, every ``PageStats`` counter equal, and the
    page counters (all but ``registry_scans``) equal to the ``model=None``
    run's; returns the port's engine."""
    import dataclasses

    from repro.serving.engine import ServingEngine as RefEngine
    from repro_torch.serving.engine import ServingEngine

    rm, rp, tm, tp = model_pair(arch)
    prompts = serving_prompts(tm.cfg.vocab_size)
    ref = RefEngine(rm, rp, kv=kv, **ENGINE_KW)
    eng = ServingEngine(tm, tp, kv=kv, device="cpu", **ENGINE_KW)
    want, got = _serve(ref, prompts, max_new), _serve(eng, prompts, max_new)
    assert len(got) == len(prompts) and got == want
    assert all(len(toks) == max_new for toks in got.values())
    stats = dataclasses.asdict(eng.pages.stats)
    assert stats == dataclasses.asdict(ref.pages.stats)
    assert stats["evictions"] > 0 and stats["shared_prefix_pages"] > 0
    null = ServingEngine(None, None, kv="vec", device="cpu", **ENGINE_KW)
    _serve(null, prompts, max_new)
    stub = dataclasses.asdict(null.pages.stats)
    stats.pop("registry_scans"), stub.pop("registry_scans")
    assert stats == stub
    assert eng.steps == ref.steps == null.steps
    return eng


#: the launcher's page keys, which paging alone decides
LAUNCHER_PAGE_KEYS = ("completed", "decode_tokens", "peak_concurrency",
                      "hbm_hit_rate", "prefetches", "prefetch_hits",
                      "shared_prefix_pages", "registry_scans")


def launcher_pair(arch: str, *extra: str):
    """Both packages' launchers with ``--arch arch`` (the port's on the
    CPU): the reference's keys and ``device``, every request completed,
    the page counters equal; returns the port's output."""
    import contextlib
    import io

    from repro.launch import serve as ref_serve
    from repro_torch.launch import serve

    with contextlib.redirect_stdout(io.StringIO()):
        want = ref_serve.main(["--arch", arch, *extra])
        got = serve.main(["--arch", arch, "--device", "cpu", *extra])
    assert set(got) == set(want) | {"device"}
    assert got["front_end"] == "engine" and got["device"] == "cpu"
    assert ({k: got[k] for k in LAUNCHER_PAGE_KEYS}
            == {k: want[k] for k in LAUNCHER_PAGE_KEYS})
    return got


# --------------------------------------------------------------------------- #
# training: both packages' train states on one set of values                  #
# --------------------------------------------------------------------------- #

@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op torch thread for the module that imports this fixture:
    the smoke shapes gain nothing from more, and the suite's workers
    share the cores (eight threads in each of six workers make a small
    train step tens of times slower)."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def clone_state(state):
    """A copy of the port's ``TrainState``, whose train step updates its
    argument in place."""
    import copy

    from repro_torch.training.tree import tree_map

    return type(state)(copy.deepcopy(state.params),
                       tree_map(lambda t: t.clone(), state.opt_state),
                       state.step.clone())


def train_batches(cfg, b: int = 2, s: int = 64, seed: int = 0):
    """``tests/test_models.py``'s batch of ``cfg``'s family, (jax dict,
    torch dict): tokens, the audio family's frame features, the VLM's
    patches (``s`` positions in all)."""
    import jax.numpy as jnp
    import torch

    rng = np.random.default_rng(seed)
    if cfg.family == "audio":
        arrays = {"features": rng.normal(
                      size=(b, s, cfg.frontend.feature_dim)).astype(
                          np.float32),
                  "tokens": rng.integers(0, cfg.vocab_size, size=(b, s))
                  .astype(np.int32)}
    elif cfg.family == "vlm":
        n = cfg.frontend.n_positions
        arrays = {"tokens": rng.integers(0, cfg.vocab_size, size=(b, s - n))
                  .astype(np.int32),
                  "patches": rng.normal(
                      size=(b, n, cfg.frontend.feature_dim)).astype(
                          np.float32)}
    else:
        arrays = {"tokens": rng.integers(0, cfg.vocab_size, size=(b, s))
                  .astype(np.int32)}
    return ({k: jnp.asarray(v) for k, v in arrays.items()},
            {k: torch.from_numpy(v) for k, v in arrays.items()})


def train_pair(arch: str, optimizer: str = "adamw", dtype: str = "float32",
               replace: tuple = (), ref_state=None, nested: tuple = ()):
    """(reference model, its ``TrainState``, port model, the port's
    ``TrainState`` carried across by ``train_state_from_reference``):
    the reference's state is ``ref_state`` or a fresh one on
    :func:`model_pair`'s parameters (``optimizer``'s init, step 0)."""
    import jax.numpy as jnp

    from repro.training.optimizer import make_optimizer
    from repro.training.train_loop import TrainState
    from repro_torch.models.convert import train_state_from_reference

    rm, rp, tm, _ = model_pair(arch, dtype, nested, replace)
    if ref_state is None:
        ref_state = TrainState(rp, make_optimizer(optimizer).init(rp),
                               jnp.zeros((), jnp.int32))
    port = train_state_from_reference(
        tm.cfg, _np_tree(ref_state.params), _np_tree(ref_state.opt_state),
        int(ref_state.step), optimizer, "cpu")
    return rm, ref_state, tm, port


def port_layout_np(cfg, tree):
    """A reference tree (jax arrays) as float32 numpy in the port's
    per-layer layout."""
    from repro_torch.models.convert import _port_layout

    return _port_layout(cfg, _np_tree(tree))


def assert_leaves_rel(ref, port, tol: float, path: str = "") -> None:
    """Every leaf of ``port`` (tensors) within ``tol`` times the largest
    magnitude of the leaf at the same place of ``ref`` (numpy, the same
    structure) of it; the same keys and shapes, and NaN at the same
    places (zamba2's gradients, ROADMAP.md queue C item 6)."""
    from repro_torch.training.tree import leaves_with_path

    got = list(leaves_with_path(port))
    want = list(leaves_with_path(ref))
    assert [p for p, _ in got] == [p for p, _ in want], path
    for (p, t), (_, a) in zip(got, want):
        a = np.asarray(a, np.float32)
        b = t.detach().float().numpy()
        assert a.shape == b.shape, (path, p)
        nan = np.isnan(a)
        np.testing.assert_array_equal(np.isnan(b), nan, err_msg=str(p))
        a, b = a[~nan], b[~nan]
        err = float(np.abs(a - b).max()) if a.size else 0.0
        scale = float(np.abs(a).max()) if a.size else 0.0
        assert err <= tol * max(scale, 1e-30), (path, p, err, scale)


LR = 1e-3
METRICS = ("loss", "ce", "aux_loss", "grad_norm", "lr")


def ref_step_and_grads(rm, **kw):
    """The reference's jitted train step with its loss's gradients on the
    same inputs (one compile)."""
    import jax

    from repro.training.train_loop import make_loss_fn as ref_loss_fn
    from repro.training.train_loop import (
        make_train_step as ref_make_train_step)

    step = ref_make_train_step(rm, **kw)
    grad = jax.value_and_grad(ref_loss_fn(rm), has_aux=True)

    def both(state, batch):
        _, g = grad(state.params, batch)
        new, metrics = step(state, batch)
        return new, metrics, g
    return jax.jit(both)


def assert_train_metrics(got, want, tol=1e-4):
    for key in METRICS:
        np.testing.assert_allclose(float(got[key]), float(want[key]),
                                   rtol=tol, atol=tol, err_msg=key)


def assert_params_near(cfg, want, got, lr):
    """Every parameter within two learning rates of the reference's."""
    from repro_torch.training.tree import leaves

    for a, p in zip(leaves(port_layout_np(cfg, want)), leaves(got)):
        np.testing.assert_allclose(p.detach().float().numpy(), a, rtol=0,
                                   atol=2.0 * lr * (1 + 1e-3))


#: zamba2's smoke model with SSD chunks of 4 (S 64 or 32 still divides):
#: three steps of log-decay stay far below ``exp``'s overflow, so its
#: gradients are finite in both packages
ZAMBA2_FINITE = (("ssm", "chunk_size", 4),)


def check_train_step(arch: str, nested: tuple = (),
                     finite: bool = True) -> None:
    """One train step of ``arch``'s smoke model (``nested`` applied as in
    :func:`model_pair`) in both packages from one carried-across state
    (the test files' docstrings say what is held); ``finite``: whether
    every gradient is finite (else NaN at the same places in both)."""
    import torch

    from repro_torch.training.train_loop import (loss_and_grads,
                                                 make_loss_fn,
                                                 make_train_step)
    from repro_torch.training.tree import leaves

    rm, rstate, tm, state = train_pair(arch, nested=nested)
    jb, tb = train_batches(tm.cfg)
    kw = dict(lr=LR, warmup=0, total_steps=10)
    new, want, rgrads = ref_step_and_grads(rm, **kw)(rstate, jb)
    before = clone_state(state)
    loss, parts, grads = loss_and_grads(make_loss_fn(tm), state.params, tb)
    assert_leaves_rel(port_layout_np(tm.cfg, rgrads), grads, 1e-4, arch)
    # the reference's SSD chunk overflows where it masks, so zamba2's
    # smoke gradients are NaN in both packages (ROADMAP.md queue C item 6)
    assert finite == all(bool(torch.isfinite(g).all())
                         for g in leaves(grads)), arch
    out, got = make_train_step(tm, **kw)(state, tb)
    assert out is state and int(state.step) == 1 == int(new.step)
    assert_train_metrics(got, want)
    np.testing.assert_allclose(float(loss), float(want["loss"]), rtol=1e-4)
    assert_params_near(tm.cfg, new.params, state.params, LR)
    assert any(not torch.equal(a, b) for a, b in
               zip(leaves(before.params), leaves(state.params))), arch
    assert all(p.requires_grad and p.grad is None
               for p in leaves(state.params))
