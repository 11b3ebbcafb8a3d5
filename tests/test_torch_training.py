"""The port's training substrate (``repro_torch.training``,
``repro_torch.data``) on the CPU against the reference's.

The reference's 16 non-elastic cases of ``tests/test_training_infra.py``
(optimizers, checkpoints, compression, the data pipeline) run on the
port; then parity on the same inputs: the loader's token streams at
several steps and shards and the PFCS data tier's prefetch count exactly,
``quantize`` (equal int8 ``q``, scale and residual within 1e-7
relative), ``cosine_schedule`` and ``clip_by_global_norm``, and one
update of each optimizer on a carried-across train state of the qwen and
deepseek smoke models (Adafactor in the reference's stacked layout)
within 1e-6, a bfloat16 AdamW update within one bfloat16 ulp; the
checkpoint's manifest (keys, file names, shapes, dtypes, checksums)
equal to the reference's for a float32 state, bfloat16 bit patterns
round-tripped, the async snapshot taken before ``save`` returns.
"""

import torch_parity  # noqa: F401

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.pfcs_cache import PFCSCache as RefPFCSCache
from repro.data import pipeline as ref_pipeline
from repro.training import checkpoint as ref_checkpoint
from repro.training import compression as ref_compression
from repro.training import optimizer as ref_optimizer
from repro.training.train_loop import TrainState as RefTrainState
from repro_torch.core.pfcs_cache import PFCSCache
from repro_torch.data.pipeline import (ByteTokenizer, ShardedLoader,
                                       SyntheticCorpus)
from repro_torch.models.convert import reference_groups
from repro_torch.training import TrainState
from repro_torch.training.checkpoint import CheckpointManager
from repro_torch.training.compression import (compress_tree,
                                              decompress_tree,
                                              init_residuals, quantize,
                                              roundtrip_error)
from repro_torch.training.optimizer import (adafactor, adamw,
                                            clip_by_global_norm,
                                            cosine_schedule, make_optimizer,
                                            sgdm)
from repro_torch.training.tree import leaves, tree_map
from torch_parity import (_np_tree, assert_leaves_rel, clone_state,
                          port_layout_np, train_pair)
from torch_parity import one_torch_thread  # noqa: F401


# --------------------------------------------------------------------------- #
# the reference's cases: optimizers                                           #
# --------------------------------------------------------------------------- #

def _quad_problem(opt, steps=300, lr=0.05):
    """Minimize ||x - t||^2; any reasonable optimizer converges."""
    t = torch.from_numpy(np.random.default_rng(0).normal(size=(4, 8))).to(
        torch.float32)
    params = {"w": torch.zeros((4, 8), dtype=torch.float32)}
    state = opt.init(params)
    for _ in range(steps):
        g = {"w": 2 * (params["w"] - t)}
        params, state = opt.update(g, params, state, torch.tensor(lr))
    return float(torch.mean((params["w"] - t) ** 2))


def test_adamw_converges():
    assert _quad_problem(adamw(weight_decay=0.0)) < 1e-3


def test_adafactor_converges():
    assert _quad_problem(adafactor()) < 1e-2


def test_sgdm_converges():
    assert _quad_problem(sgdm(), lr=0.01) < 1e-3


def test_adamw_first_step_is_lr_sized():
    opt = adamw(weight_decay=0.0)
    p = {"w": torch.ones((3,), dtype=torch.float32)}
    s = opt.init(p)
    g = {"w": torch.tensor([1.0, -1.0, 0.5])}
    before = p["w"].clone()
    p2, _ = opt.update(g, p, s, torch.tensor(0.1))
    # bias-corrected first Adam step = lr * sign(g)
    np.testing.assert_allclose((before - p2["w"]).numpy(),
                               [0.1, -0.1, 0.1], rtol=1e-4)


def test_clip_by_global_norm():
    g = {"a": torch.full((10,), 10.0)}
    clipped, norm = clip_by_global_norm(g, 1.0)
    assert float(norm) > 1.0
    assert abs(float(torch.linalg.norm(clipped["a"])) - 1.0) < 1e-5


def test_cosine_schedule_shape():
    lr = cosine_schedule(1e-3, warmup=10, total=100)
    assert float(lr(torch.tensor(0))) == 0.0
    assert abs(float(lr(torch.tensor(10))) - 1e-3) < 1e-9
    assert float(lr(torch.tensor(100))) < 1e-6


# --------------------------------------------------------------------------- #
# the reference's cases: checkpointing                                        #
# --------------------------------------------------------------------------- #

def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {"layer": {"w": torch.from_numpy(rng.normal(size=(8, 4))).to(
                          torch.float32),
                      "b": torch.from_numpy(rng.normal(size=(4,))).to(
                          torch.float32)},
            "step": torch.tensor(7, dtype=torch.int32)}


def test_checkpoint_roundtrip(tmp_path):
    mgr = CheckpointManager(tmp_path)
    tree = _tree()
    mgr.save(5, tree)
    target = tree_map(torch.zeros_like, tree)
    restored = mgr.restore(target, step=5, verify=True)
    for a, b in zip(leaves(tree), leaves(restored)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_checkpoint_latest_and_retention(tmp_path):
    mgr = CheckpointManager(tmp_path, keep_last=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, _tree(s))
    assert mgr.latest_step() == 4
    assert mgr.all_steps() == [3, 4]        # pruned to keep_last


def test_checkpoint_ignores_partial_tmp(tmp_path):
    mgr = CheckpointManager(tmp_path)
    mgr.save(1, _tree())
    # simulate a crash mid-write: orphan .tmp directory
    (tmp_path / "step_00000002.tmp").mkdir()
    (tmp_path / "step_00000002.tmp" / "garbage.npy").write_bytes(b"xx")
    assert mgr.latest_step() == 1           # partial write invisible


def test_checkpoint_async(tmp_path):
    mgr = CheckpointManager(tmp_path)
    mgr.save(9, _tree(), blocking=False)
    mgr.wait()
    assert mgr.latest_step() == 9


def test_checkpoint_shape_mismatch_raises(tmp_path):
    mgr = CheckpointManager(tmp_path)
    mgr.save(1, _tree())
    bad = {"layer": {"w": torch.zeros((9, 4)), "b": torch.zeros((4,))},
           "step": torch.tensor(0, dtype=torch.int32)}
    with pytest.raises(ValueError):
        mgr.restore(bad, step=1)


# --------------------------------------------------------------------------- #
# the reference's cases: gradient compression                                 #
# --------------------------------------------------------------------------- #

def test_compression_roundtrip_error_small():
    rng = np.random.default_rng(0)
    grads = {"w": torch.from_numpy(rng.normal(size=(64, 64))).to(
        torch.float32)}
    res = init_residuals(grads)
    err = roundtrip_error(grads, res)
    assert err < 0.01                        # int8: <1% L2 error per step


def test_error_feedback_accumulates():
    """Residual carries quantization error: sum of dequantized updates
    converges to the true gradient sum."""
    rng = np.random.default_rng(1)
    g = torch.from_numpy(rng.normal(size=(32,))).to(torch.float32)
    grads = {"w": g}
    res = init_residuals(grads)
    total = torch.zeros_like(g)
    for _ in range(50):
        qt, res = compress_tree(grads, res)
        total = total + decompress_tree(qt)["w"]
    np.testing.assert_allclose((total / 50).numpy(), g.numpy(), rtol=0,
                               atol=0.02)


# --------------------------------------------------------------------------- #
# the reference's cases: data pipeline                                        #
# --------------------------------------------------------------------------- #

def test_loader_deterministic_restart():
    corpus = SyntheticCorpus()
    l1 = ShardedLoader(corpus, global_batch=8, seq_len=32)
    l2 = ShardedLoader(corpus, global_batch=8, seq_len=32)
    np.testing.assert_array_equal(l1.batch_at(17)["tokens"],
                                  l2.batch_at(17)["tokens"])


def test_loader_shards_disjoint_streams():
    corpus = SyntheticCorpus()
    a = ShardedLoader(corpus, 8, 32, shard_index=0, shard_count=2)
    b = ShardedLoader(corpus, 8, 32, shard_index=1, shard_count=2)
    assert not np.array_equal(a.batch_at(0)["tokens"],
                              b.batch_at(0)["tokens"])


def test_byte_tokenizer_roundtrip():
    tok = ByteTokenizer()
    s = "PFCS: café ≠ cache"
    assert tok.decode(tok.encode(s)) == s


# --------------------------------------------------------------------------- #
# parity: data                                                                #
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("shards", [(0, 1), (0, 2), (1, 2), (3, 4)])
def test_loader_streams_equal_the_reference(shards):
    """The same token streams at several steps, for each shard."""
    index, count = shards
    kw = dict(shard_index=index, shard_count=count, seed=3)
    ours = ShardedLoader(SyntheticCorpus(vocab_size=259, seed=1), 8, 48,
                         **kw)
    ref = ref_pipeline.ShardedLoader(
        ref_pipeline.SyntheticCorpus(vocab_size=259, seed=1), 8, 48, **kw)
    for step in (0, 1, 7, 60, 119, 1000):
        got, want = ours.batch_at(step), ref.batch_at(step)
        assert got.keys() == want.keys()
        np.testing.assert_array_equal(got["tokens"], want["tokens"])
        assert got["tokens"].dtype == np.int32


def test_pfcs_data_tier_prefetches_equal_the_reference():
    """``--pfcs-data``'s shard cache: the same prefetch count, prefetch
    log and resident sets after the same batches."""
    caps = (("L1", 8), ("L2", 32), ("L3", 64))
    ours, ref = PFCSCache(capacities=caps), RefPFCSCache(capacities=caps)
    lo = ShardedLoader(SyntheticCorpus(vocab_size=259), 4, 128,
                       pfcs_cache=ours)
    lr = ref_pipeline.ShardedLoader(ref_pipeline.SyntheticCorpus(
        vocab_size=259), 4, 128, pfcs_cache=ref)
    for step in range(40):
        lo.batch_at(step)
        lr.batch_at(step)
    assert ours.prefetches_issued == ref.prefetches_issued > 0
    assert ours.prefetch_targets == ref.prefetch_targets
    assert ([list(lv.entries) for lv in ours.levels]
            == [list(lv.entries) for lv in ref.levels])


# --------------------------------------------------------------------------- #
# parity: compression, schedule, clip                                         #
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_quantize_equals_the_reference(seed):
    rng = np.random.default_rng(seed)
    g = rng.normal(size=(33, 17)).astype(np.float32) * 10 ** seed
    r = rng.normal(size=(33, 17)).astype(np.float32) * 1e-2
    q, s, res = quantize(torch.from_numpy(g), torch.from_numpy(r))
    rq, rs, rres = ref_compression.quantize(jnp.asarray(g), jnp.asarray(r))
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    assert q.dtype == torch.int8
    np.testing.assert_allclose(float(s), float(rs), rtol=1e-7)
    np.testing.assert_allclose(res.numpy(), np.asarray(rres), rtol=1e-7,
                               atol=1e-7 * float(np.abs(rres).max()))


def test_cosine_schedule_equals_the_reference():
    for base, warm, total in ((1e-3, 10, 100), (3e-4, 1, 6), (1e-3, 12, 120),
                              (5e-4, 0, 50)):
        ours, ref = (cosine_schedule(base, warm, total),
                     ref_optimizer.cosine_schedule(base, warm, total))
        for step in range(0, total + 3):
            got = ours(torch.tensor(step, dtype=torch.int32))
            want = ref(jnp.asarray(step, jnp.int32))
            assert got.dtype == torch.float32
            # near the end 1 + cos(pi * prog) cancels: the two cosines'
            # float32 roundings differ by an ulp of 1 (times base / 2)
            np.testing.assert_allclose(float(got), float(want), rtol=1e-6,
                                       atol=1e-7 * base)


@pytest.mark.parametrize("max_norm", [0.5, 1.0, 1e3])
def test_clip_by_global_norm_equals_the_reference(max_norm):
    rng = np.random.default_rng(4)
    tree = {"a": rng.normal(size=(16, 8)).astype(np.float32),
            "b": {"c": rng.normal(size=(5,)).astype(np.float32)}}
    ref, rnorm = ref_optimizer.clip_by_global_norm(
        jax.tree.map(jnp.asarray, tree), max_norm)
    ours, norm = clip_by_global_norm(   # in place: on copies of the arrays
        tree_map(lambda a: torch.tensor(a), tree), max_norm)
    np.testing.assert_allclose(float(norm), float(rnorm), rtol=1e-6)
    assert_leaves_rel(_np_tree(ref), ours, 1e-6)


# --------------------------------------------------------------------------- #
# parity: one optimizer update on a carried-across train state                #
# --------------------------------------------------------------------------- #

def _grads_like(params, seed):
    """A random gradient tree shaped like the reference's ``params``."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda p: jnp.asarray(
        rng.normal(size=p.shape).astype(np.float32) * 1e-2, p.dtype), params)


def _one_update(arch, opt_name, dtype="float32"):
    """The reference's state after one update (from its init), carried
    across; then a second update with other gradients in both packages.
    Returns (reference params, state, port state, the port's config)."""
    rm, rstate, tm, _ = train_pair(arch, opt_name, dtype)
    update = jax.jit(ref_optimizer.make_optimizer(opt_name).update)
    lr = jnp.asarray(1e-2, jnp.float32)
    p1, s1 = update(_grads_like(rstate.params, 1), rstate.params,
                         rstate.opt_state, lr)
    _, _, _, port = train_pair(arch, opt_name, dtype, ref_state=RefTrainState(
        p1, s1, jnp.asarray(1, jnp.int32)))
    g2 = _grads_like(p1, 2)
    p2, s2 = update(g2, p1, s1, lr)
    grads = tree_map(lambda a: torch.tensor(a, dtype=torch.float32),
                     port_layout_np(tm.cfg, g2))
    grads = tree_map(lambda g, p: g.to(p.dtype), grads, port.params)
    make_optimizer(opt_name, tm.cfg).update(
        grads, port.params, port.opt_state, torch.tensor(1e-2))
    return p2, s2, port, tm.cfg


@pytest.mark.parametrize("opt_name", ["adamw", "adafactor", "sgdm"])
@pytest.mark.parametrize("arch", ["qwen2.5-3b", "deepseek-v2-236b"])
def test_optimizer_update_equals_the_reference(arch, opt_name):
    """Parameters and optimizer state after an update from a carried-across
    state within 1e-6 of each leaf's largest magnitude; Adafactor's state
    in the reference's stacked layout (``(L, d)`` norm scales factored)."""
    p2, s2, port, cfg = _one_update(arch, opt_name)
    assert_leaves_rel(port_layout_np(cfg, p2), port.params, 1e-6, "params")
    assert int(port.opt_state["count"]) == int(s2["count"]) == 2
    if opt_name == "adafactor":
        assert_leaves_rel(_np_tree(s2["s"]), port.opt_state["s"], 1e-6, "s")
        stacked = port.opt_state["s"]["dense_layers"]["ln_attn"]["scale"]
        assert set(stacked) == {"vr", "vc"}          # (L, d): factored
    else:
        for key in ("m", "v") if opt_name == "adamw" else ("mom",):
            assert_leaves_rel(port_layout_np(cfg, s2[key]),
                              port.opt_state[key], 1e-6, key)


def test_bfloat16_adamw_update_within_one_ulp():
    """A bfloat16 model's AdamW update: float32 moments, parameters cast
    back to bfloat16, each within one bfloat16 ulp of the reference's."""
    p2, s2, port, cfg = _one_update("qwen2.5-3b", "adamw", "bfloat16")
    assert all(p.dtype == torch.bfloat16 for p in leaves(port.params))
    assert all(m.dtype == torch.float32 for m in leaves(port.opt_state["m"]))
    want = port_layout_np(cfg, p2)
    for (p, a) in zip(leaves(port.params), leaves(want)):
        got = p.detach().float().numpy()
        ulp = np.abs(a) * 2.0 ** -7 + 1e-30
        assert np.all(np.abs(got - a) <= ulp)
    assert_leaves_rel(port_layout_np(cfg, s2["v"]), port.opt_state["v"],
                      1e-6, "v")


def test_adafactor_groups_are_the_reference_stacks():
    """``reference_groups`` puts each per-layer leaf in the stack of the
    reference's tree it came from, in layer order; ``shared_blocks`` and
    ``s_blocks`` stay one leaf per block."""
    from repro_torch.configs import get_smoke
    from repro_torch.models import build_model
    from repro_torch.training.tree import leaves_with_path

    for arch, stacks in (("deepseek-v2-236b", ("dense_layers",
                                               "moe_layers")),
                         ("zamba2-7b", ("mamba_layers",)),
                         ("xlstm-1.3b", ("m_stack",))):
        cfg = get_smoke(arch)
        params = build_model(cfg, device="cpu").param_specs()
        paths = [p for p, _ in leaves_with_path(params)]
        groups = reference_groups(cfg)
        seen = []
        for path, idx in leaves_with_path(
                groups, is_leaf=lambda x: type(x) is tuple):
            if path[0] in stacks:
                assert isinstance(idx, tuple) and len(idx) > 0, path
                layers = [paths[i][1] for i in idx]
                assert layers == sorted(layers), path
                seen += idx
            else:
                assert isinstance(idx, int), path
                seen.append(idx)
        assert sorted(seen) == list(range(len(paths))), arch


def test_adafactor_needs_the_config_for_a_model():
    """Adafactor without the model's ``cfg`` would update the port's
    per-layer leaves one by one (other numbers than the reference's):
    on a ``ParamTree`` it raises; a plain tree of tensors is its own
    grouping."""
    from repro_torch.configs import get_smoke
    from repro_torch.models import build_model

    params = build_model(get_smoke("qwen2.5-3b"), device="cpu").param_specs()
    with pytest.raises(ValueError, match="make_optimizer"):
        make_optimizer("adafactor").init(params)
    state = make_optimizer("adafactor", get_smoke("qwen2.5-3b")).init(params)
    assert set(state["s"]["dense_layers"]["ln_attn"]["scale"]) == {"vr",
                                                                   "vc"}
    plain = {"w": torch.zeros(3, 4), "b": [torch.zeros(4)]}
    assert set(adafactor().init(plain)["s"]["b"][0]) == {"v"}


# --------------------------------------------------------------------------- #
# checkpoint format                                                           #
# --------------------------------------------------------------------------- #

def _state_pair(seed=0):
    """The same small float32 train state in both packages (AdamW state
    after one update, so m and v are not zero)."""
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(6, 3)).astype(np.float32)
    b = rng.normal(size=(3,)).astype(np.float32)
    g = {"b": rng.normal(size=(3,)).astype(np.float32),
         "w": rng.normal(size=(6, 3)).astype(np.float32)}
    ropt = ref_optimizer.adamw()
    rp = {"w": jnp.asarray(w), "b": jnp.asarray(b)}
    rp, rs = ropt.update(jax.tree.map(jnp.asarray, g), rp, ropt.init(rp),
                         jnp.asarray(1e-2))
    ref = RefTrainState(rp, rs, jnp.asarray(1, jnp.int32))
    t = lambda a: torch.from_numpy(np.asarray(a).copy())  # noqa: E731
    ours = TrainState({"w": t(rp["w"]), "b": t(rp["b"])},
                      {"m": {"w": t(rs["m"]["w"]), "b": t(rs["m"]["b"])},
                       "v": {"w": t(rs["v"]["w"]), "b": t(rs["v"]["b"])},
                       "count": t(rs["count"])},
                      torch.tensor(1, dtype=torch.int32))
    return ref, ours


def test_checkpoint_manifest_equals_the_reference(tmp_path):
    """A float32 train state: the same leaf paths, file names, shapes,
    dtypes and checksums as the reference writes (``treedef`` is each
    package's own)."""
    ref, ours = _state_pair()
    ref_checkpoint.CheckpointManager(tmp_path / "ref").save(3, ref)
    CheckpointManager(tmp_path / "port").save(3, ours)
    mf = [json.loads((tmp_path / d / "step_00000003" / "manifest.json")
                     .read_text()) for d in ("ref", "port")]
    assert mf[0]["step"] == mf[1]["step"] == 3
    assert mf[0]["leaves"] == mf[1]["leaves"]
    assert sorted(mf[1]["leaves"]) == [
        "opt_state/count", "opt_state/m/b", "opt_state/m/w",
        "opt_state/v/b", "opt_state/v/w", "params/b", "params/w", "step"]
    for d in ("ref", "port"):
        assert (tmp_path / d / "LATEST").read_text() == "3"
    for meta in mf[1]["leaves"].values():
        np.testing.assert_array_equal(
            np.load(tmp_path / "port" / "step_00000003" / meta["file"]),
            np.load(tmp_path / "ref" / "step_00000003" / meta["file"]))


def test_checkpoint_bfloat16_bits_round_trip(tmp_path):
    """bfloat16 leaves stored as their 16-bit patterns, named
    ``bfloat16`` in the manifest, checked and restored bit for bit."""
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.normal(size=(7, 5)).astype(np.float32)).to(
        torch.bfloat16)
    x[0, :3] = torch.tensor([float("inf"), -0.0, 1e-40])
    tree = {"x": x, "y": torch.arange(4, dtype=torch.int32)}
    mgr = CheckpointManager(tmp_path)
    mgr.save(2, tree)
    meta = json.loads((tmp_path / "step_00000002" / "manifest.json")
                      .read_text())["leaves"]["x"]
    assert meta["dtype"] == "bfloat16" and meta["shape"] == [7, 5]
    stored = np.load(tmp_path / "step_00000002" / meta["file"])
    assert stored.dtype == np.uint16
    target = tree_map(torch.zeros_like, tree)
    mgr.restore(target, verify=True)
    assert target["x"].dtype == torch.bfloat16
    assert torch.equal(target["x"].view(torch.int16), x.view(torch.int16))
    assert torch.equal(target["y"], tree["y"])
    (tmp_path / "step_00000002" / meta["file"]).write_bytes(
        (tmp_path / "step_00000002" / meta["file"]).read_bytes()[:-2]
        + b"\x00\x01")
    with pytest.raises(IOError, match="checksum"):
        mgr.restore(target, verify=True)
    with pytest.raises(ValueError, match="dtype"):
        mgr.restore({"x": torch.zeros((7, 5)), "y": tree["y"]})


def test_checkpoint_async_snapshot_is_a_copy(tmp_path):
    """``save(blocking=False)`` copies before it returns: an in-place
    update right after it does not reach the checkpoint."""
    mgr = CheckpointManager(tmp_path)
    tree = _tree()
    want = tree_map(torch.clone, tree)
    mgr.save(4, tree, blocking=False)
    for t in leaves(tree):
        t.add_(1)
    mgr.wait()
    got = mgr.restore(tree_map(torch.zeros_like, tree), step=4, verify=True)
    for a, b in zip(leaves(want), leaves(got)):
        assert torch.equal(a, b)


def test_checkpoint_restores_a_train_state_in_place(tmp_path):
    """A port train state saved and restored into another one of the
    same model (its own tensors)."""
    _, _, _, port = train_pair("qwen2.5-3b")
    mgr = CheckpointManager(tmp_path)
    mgr.save(1, port)
    other = clone_state(port)
    for t in leaves(other):
        with torch.no_grad():
            t.zero_()
    params = list(leaves(other.params))
    out = mgr.restore(other, verify=True)
    assert out is other and list(leaves(out.params))[0] is params[0]
    for a, b in zip(leaves(port), leaves(other)):
        assert torch.equal(a, b)
    assert all(p.requires_grad for p in leaves(other.params))
