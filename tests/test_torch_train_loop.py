"""Training end to end on the CPU: the reference's integration cases on
the port, the launcher, the entry points' devices, and rehearsals of
``chip_smoke.py``'s three training phases at the smoke widths.

``tests/test_integration.py::test_training_reduces_loss`` and
``::test_checkpoint_resume_bit_identical`` run on the port (the resume
check restores into the state the step has since updated in place).
``repro_torch.launch.train`` prints the reference launcher's keys (and
``device``) with the same PFCS data-tier prefetch count, resumes from
its last checkpoint bit for bit, and runs ``examples/train_lm.py``'s default
argument list (``chip_smoke.TRAIN_LM_ARGS``) with fewer steps.
``init_params`` stays gradient-free (serving builds no autograd graph);
``init_train_state``'s parameters ask for gradients; ``abstract_train_
state`` is ``"meta"`` tensors shaped as the real one.  The phases
``train_check``, ``train_full`` and ``launcher_train`` run on the CPU
with ``chip_smoke.model_config`` giving smoke configurations; a
tolerance no difference can meet fails ``train_check``.  The checks of a
bit-identical resume run under ``torch.use_deterministic_algorithms``:
on several CPU threads the embedding gather's backward adds in an order
that varies from run to run.
"""

import torch_parity  # noqa: F401

import contextlib
import importlib.util
import io
import os
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke
from repro_torch.data.pipeline import ShardedLoader, SyntheticCorpus
from repro_torch.launch import train
from repro_torch.models import build_model
from repro_torch.models.convert import train_state_from_reference
from repro_torch.serving.engine import ServingEngine
from repro_torch.training.checkpoint import CheckpointManager
from repro_torch.training.train_loop import (TrainState,
                                             abstract_train_state,
                                             init_train_state,
                                             make_train_step)
from repro_torch.training.tree import leaves, leaves_with_path
from torch_parity import clone_state, one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _batch(loader, i):
    return {k: torch.from_numpy(v) for k, v in loader.batch_at(i).items()}


@pytest.fixture
def deterministic():
    """The embedding gather's backward (``index_put_`` accumulating) adds
    in an order that varies from run to run on several CPU threads, so
    the bit-identical checks run under deterministic algorithms."""
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(was)


# --------------------------------------------------------------------------- #
# the reference's integration cases                                           #
# --------------------------------------------------------------------------- #

def test_training_reduces_loss():
    """A few hundred steps on the synthetic corpus must reduce CE."""
    cfg = get_smoke("qwen2.5-3b").replace(vocab_size=259)
    model = build_model(cfg, device="cpu")
    loader = ShardedLoader(SyntheticCorpus(vocab_size=259), global_batch=8,
                           seq_len=64)
    state = init_train_state(model, 0)
    step = make_train_step(model, lr=1e-3, warmup=10, total_steps=150)
    losses = []
    for i in range(150):
        state, m = step(state, _batch(loader, i))
        losses.append(float(m["loss"]))
    first = np.mean(losses[:10])
    last = np.mean(losses[-10:])
    assert last < first - 0.05, (first, last)


def test_checkpoint_resume_bit_identical(tmp_path, deterministic):
    """Restart from a checkpoint reproduces the exact same next step
    (deterministic loader keyed on step + atomic checkpoint)."""
    cfg = get_smoke("gemma-2b").replace(vocab_size=259)
    model = build_model(cfg, device="cpu")
    loader = ShardedLoader(SyntheticCorpus(vocab_size=259), global_batch=4,
                           seq_len=32)
    step = make_train_step(model, lr=1e-3, warmup=0, total_steps=50)
    mgr = CheckpointManager(tmp_path)

    state = init_train_state(model, 1)
    for i in range(5):
        state, _ = step(state, _batch(loader, i))
    mgr.save(5, state)
    cont, m_cont = step(clone_state(state), _batch(loader, 5))

    restored = mgr.restore(state, step=5)
    resumed, m_res = step(TrainState(*restored), _batch(loader, 5))
    assert float(m_cont["loss"]) == float(m_res["loss"])
    for a, b in zip(leaves(cont.params), leaves(resumed.params)):
        assert torch.equal(a, b)


# --------------------------------------------------------------------------- #
# parameters, states, devices                                                 #
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("arch", ["qwen2.5-3b", "zamba2-7b"])
def test_init_params_stays_gradient_free(arch):
    """Serving's parameters ask for no gradient, so a decode step outside
    ``torch.no_grad`` builds no graph; the train state's ask for one."""
    model = build_model(get_smoke(arch), device="cpu")
    params = model.init_params(0)
    assert not any(p.requires_grad for p in leaves(params))
    eng = ServingEngine(model, params, max_batch=2, max_seq=32, page_size=8,
                        hbm_pages=8, device="cpu")
    eng.submit(list(range(6)), max_new_tokens=2)
    assert len(eng.run_until_idle()) == 1
    cache = model.init_cache(1, 8)
    logits, _ = model.decode_step(params, {"tokens": torch.zeros(
        (1, 1), dtype=torch.int32)}, cache)
    assert not logits.requires_grad and logits.grad_fn is None
    state = init_train_state(model, 0)
    assert all(p.requires_grad for p in leaves(state.params))


@pytest.mark.parametrize("arch,opt", [("qwen2.5-3b", "adamw"),
                                      ("deepseek-v2-236b", "adafactor"),
                                      ("xlstm-1.3b", "sgdm")])
def test_abstract_train_state_is_the_real_ones_shapes(arch, opt):
    cfg = get_smoke(arch).replace(optimizer=opt)
    model = build_model(cfg, device="cpu")
    real, spec = init_train_state(model, 0), abstract_train_state(model)
    got = [(p, tuple(t.shape), t.dtype) for p, t in leaves_with_path(spec)]
    want = [(p, tuple(t.shape), t.dtype) for p, t in leaves_with_path(real)]
    assert got == want
    assert all(t.device.type == "meta" for t in leaves(spec))
    if opt == "adafactor":     # the reference's stacked layout
        s = real.opt_state["s"]["moe_layers"]["moe"]["w_gate"]
        n_moe = cfg.n_layers - cfg.moe.first_dense_layers
        assert tuple(s["vr"].shape)[0] == n_moe


ENTRY_POINTS = {
    "launch.train": lambda **kw: train.main(
        ["--arch", "qwen2.5-3b", "--smoke", "--steps", "8", "--batch", "4",
         "--seq", "32", "--lr", "1e-2", "--ckpt-every", "0", "--ckpt-dir",
         kw.pop("_dir")]
        + (["--device", kw["device"]] if kw else [])),
    "init_train_state": lambda **kw: init_train_state(build_model(
        get_smoke("qwen2.5-3b"), **{k: v for k, v in kw.items()
                                    if k != "_dir"}), 0),
    "train_state_from_reference": lambda **kw: _carried(**kw),
}


def _carried(_dir, **kw):
    cfg = get_smoke("gemma-2b")
    state = init_train_state(build_model(cfg, device="cpu"), 0)
    from repro_torch.models.convert import reference_layout

    def np_tree(tree):
        return {k: np_tree(v) if isinstance(v, dict) else v.detach().numpy()
                for k, v in tree.items()}
    ref = np_tree(reference_layout(cfg, state.params))
    return train_state_from_reference(
        cfg, ref, {"m": ref, "v": ref, "count": 0}, 0, "adamw", **kw)


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_training_entry_points_need_a_card(name, monkeypatch, tmp_path,
                                           capsys):
    """Without CUDA the default device raises ``RuntimeError``; the same
    call with ``device="cpu"`` runs."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ENTRY_POINTS[name](_dir=str(tmp_path))
    ENTRY_POINTS[name](_dir=str(tmp_path), device="cpu")
    capsys.readouterr()


# --------------------------------------------------------------------------- #
# the launcher                                                                #
# --------------------------------------------------------------------------- #

def _run(main, argv):
    with contextlib.redirect_stdout(io.StringIO()) as out:
        got = main(argv)
    return got, out.getvalue()


def test_launcher_matches_the_reference_launcher(tmp_path):
    """Both launchers on the qwen smoke model with ``--pfcs-data``: the
    reference's keys (the port adds ``device``) and the same prefetch
    count of the PFCS data tier."""
    from repro.launch import train as ref_train

    argv = ["--arch", "qwen2.5-3b", "--smoke", "--steps", "16", "--batch",
            "8", "--seq", "64", "--lr", "3e-3", "--ckpt-every", "8",
            "--pfcs-data"]
    want, _ = _run(ref_train.main, argv + ["--ckpt-dir",
                                           str(tmp_path / "ref")])
    got, text = _run(train.main, argv + ["--ckpt-dir",
                                         str(tmp_path / "port"),
                                         "--device", "cpu"])
    assert set(got) == set(want) | {"device"} and got["device"] == "cpu"
    assert got["pfcs_shard_prefetches"] == want["pfcs_shard_prefetches"] > 0
    assert got["steps"] == 16 and got["last_loss"] < got["first_loss"]
    assert text.strip().splitlines()[-1].startswith('{"first_loss"')
    mgr = CheckpointManager(tmp_path / "port" / "qwen2.5-smoke")
    assert mgr.all_steps() == [8, 16]


def test_launcher_resume_is_bit_identical(tmp_path, deterministic):
    """``--resume`` after the last checkpoint went missing continues from
    step 12 and ends in the uninterrupted run's train state, bit for
    bit."""
    import shutil

    argv = ["--arch", "qwen2.5-3b", "--smoke", "--steps", "24", "--batch",
            "8", "--seq", "64", "--lr", "1e-2", "--ckpt-every", "12",
            "--ckpt-dir", str(tmp_path), "--device", "cpu"]
    first, _ = _run(train.main, argv)
    mgr = CheckpointManager(tmp_path / "qwen2.5-smoke")
    assert mgr.all_steps() == [12, 24]
    model = build_model(get_smoke("qwen2.5-3b").replace(vocab_size=259),
                        device="cpu")
    end = mgr.restore(init_train_state(model, 1), step=24, verify=True)
    shutil.rmtree(mgr.dir / "step_00000024")
    (mgr.dir / "LATEST").unlink()
    again, text = _run(train.main, argv + ["--resume"])
    assert "resumed from step 12" in text
    assert again["last_loss"] == first["last_loss"]
    resumed = mgr.restore(init_train_state(model, 2), step=24, verify=True)
    for a, b in zip(leaves(end), leaves(resumed)):
        assert torch.equal(a, b)


def test_train_lm_default_args_are_chip_smokes():
    """``examples/train_lm.py`` hands the launcher
    ``chip_smoke.TRAIN_LM_ARGS`` by default."""
    import repro.launch.train as ref_train

    spec = importlib.util.spec_from_file_location(
        "train_lm", os.path.join(ROOT, "examples", "train_lm.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    seen = []
    module.train_main = lambda argv: seen.append(argv)
    argv, sys.argv = sys.argv, ["train_lm.py"]
    try:
        module.main()
    finally:
        sys.argv = argv
    assert seen == [list(_chip_smoke().TRAIN_LM_ARGS)]
    assert ref_train.main is not None


# --------------------------------------------------------------------------- #
# chip_smoke.py's training phases on the CPU                                  #
# --------------------------------------------------------------------------- #

def _chip_smoke():
    sys.path.insert(0, ROOT)
    try:
        import chip_smoke
    finally:
        sys.path.remove(ROOT)
    return chip_smoke


def _cpu_smoke(monkeypatch):
    """``chip_smoke`` on the CPU with the smoke configurations in place of
    the published ones (the full widths need the card)."""
    chip_smoke = _chip_smoke()
    monkeypatch.setattr(chip_smoke, "DEVICE", "cpu")
    monkeypatch.setattr(chip_smoke, "model_config",
                        lambda arch, **cut: chip_smoke.cut_config(
                            get_smoke(arch), **cut))
    return chip_smoke


def test_chip_smoke_train_check_on_cpu(monkeypatch):
    """``train_check`` at the smoke widths (both sides the CPU): every
    metric, gradient and update equal; a tolerance below zero fails it,
    naming a leaf."""
    chip_smoke = _cpu_smoke(monkeypatch)
    out = chip_smoke.phase_train_check(chip_smoke.Context())
    assert out["allow_tf32"] is False and out["config"]["n_layers"] == 2
    assert out["config"]["batch"] == 2 and out["config"]["seq"] == 64
    assert set(out["updates"]) == {"adamw", "adafactor", "sgdm"}
    assert all(u["params"] <= chip_smoke.TRAIN_UPDATE_TOL
               for u in out["updates"].values())
    assert out["accum"]["grads"] <= chip_smoke.TRAIN_TOL
    assert np.isfinite(out["loss"]) and out["loss"] == out["host_loss"]
    monkeypatch.setattr(chip_smoke, "TRAIN_TOL", -1.0)
    with pytest.raises(AssertionError, match="rel err"):
        chip_smoke.phase_train_check(chip_smoke.Context())


def test_chip_smoke_train_full_on_cpu(monkeypatch):
    """``train_full`` with the qwen smoke model: six steps with falling
    loss, a time per step, the learning rate 0 at step 0."""
    chip_smoke = _cpu_smoke(monkeypatch)
    monkeypatch.setitem(chip_smoke.TRAIN_FULL, "seq", 64)
    out = chip_smoke.phase_train_full(chip_smoke.Context())
    assert len(out["losses"]) == len(out["step_ms"]) == 6
    assert out["lrs"][0] == 0.0 and out["lrs"][1] == pytest.approx(3e-4)
    assert np.mean(out["losses"][-2:]) < out["losses"][0]
    assert out["ms_per_step"] > 0 and out["tokens_per_s"] > 0
    assert out["config"]["optimizer"] == "adamw"


def test_chip_smoke_launcher_train_on_cpu(monkeypatch, tmp_path,
                                         deterministic):
    """``launcher_train`` with ``TRAIN_LM_ARGS`` cut to 24 steps (a
    checkpoint every 12): the launcher's keys, the resume from step 12
    bit for bit, the bfloat16 round trip."""
    chip_smoke = _cpu_smoke(monkeypatch)
    args = list(chip_smoke.TRAIN_LM_ARGS)
    args[args.index("--steps") + 1] = "24"
    args[args.index("--ckpt-every") + 1] = "12"
    monkeypatch.setattr(chip_smoke, "TRAIN_LM_ARGS", tuple(args))
    monkeypatch.setattr(chip_smoke, "TRAIN_CKPT", str(tmp_path))
    out = chip_smoke.phase_launcher_train(chip_smoke.Context())
    got = out["launcher"]
    assert set(chip_smoke.LAUNCHER_TRAIN_KEYS) <= set(got)
    assert got["steps"] == 24 and got["device"] == "cpu"
    assert out["resumed_from"] == 12
    assert out["resumed_loss"] == got["last_loss"] < got["first_loss"]
    assert "bfloat16" in out["bf16_manifest_dtypes"]
