"""The port's train step on the CPU against the reference's for the
hybrid (zamba2), recurrent (xLSTM) and encoder-decoder (seamless) archs
(the decoder-only ones are in ``tests/test_torch_train_step.py``, which
says what ``tests/torch_parity.py::check_train_step`` holds), and
``cfg.remat`` in every family.

zamba2's smoke gradients hold NaN at the same places in both packages:
the reference's SSD chunk (``src/repro/models/ssm.py:127-130``) takes
``exp`` of the masked upper triangle, which overflows where the
``where`` drops it, and the backward pass multiplies that infinity by
zero (ROADMAP.md queue C item 6, mirrored on purpose).  With chunks of 4
(``torch_parity.ZAMBA2_FINITE``) nothing overflows: there every gradient
is finite and held to the reference's like the other archs'.

``remat="full"`` (the published configurations' setting) runs each
layer body under ``torch.utils.checkpoint`` where the reference runs
``jax.checkpoint``: the transformer's layers, zamba2's Mamba-2 layers,
the xLSTM stack's mLSTM blocks, both encoder-decoder stacks; gradients
within 1e-4 of the reference's with ``remat="full"`` and equal to the
port's own with ``remat="none"``, all finite (zamba2 with chunks of 4).
"""

import torch_parity  # noqa: F401

import jax
import pytest
import torch
import torch.utils.checkpoint

from repro.training.train_loop import make_loss_fn as ref_loss_fn
from repro_torch.training.train_loop import loss_and_grads, make_loss_fn
from repro_torch.training.tree import leaves
from torch_parity import (ZAMBA2_FINITE, assert_leaves_rel,
                          check_train_step, port_layout_np, train_batches,
                          train_pair)
from torch_parity import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("arch", ["zamba2-7b", "xlstm-1.3b",
                                  "seamless-m4t-large-v2"])
def test_train_step_equals_the_reference(arch):
    check_train_step(arch, finite=arch != "zamba2-7b")


def test_zamba2_finite_train_step_equals_the_reference():
    """zamba2 where nothing overflows: every gradient finite, and the
    Mamba-2 backward (dt / ``A_log``, the conv, the gate, the B / C
    projections, the SSD chunks and the carried state) held leaf by
    leaf to the reference's within 1e-4."""
    check_train_step("zamba2-7b", ZAMBA2_FINITE)


#: each family's remat="full" bodies in one smoke train forward
REMAT_BODIES = {
    "qwen2.5-3b": lambda cfg: cfg.n_layers,
    "zamba2-7b": lambda cfg: cfg.n_layers,
    "xlstm-1.3b": lambda cfg: cfg.n_layers - cfg.n_layers
    // cfg.xlstm.slstm_every,
    "seamless-m4t-large-v2": lambda cfg: (cfg.encdec.n_encoder_layers
                                          + cfg.encdec.n_decoder_layers),
}


@pytest.mark.parametrize("arch", sorted(REMAT_BODIES))
def test_remat_full_gradients(arch, monkeypatch):
    replace = (("remat", "full"),)
    nested = ZAMBA2_FINITE if arch == "zamba2-7b" else ()
    rm, rstate, tm, state = train_pair(arch, replace=replace, nested=nested)
    _, _, tm_none, state_none = train_pair(arch, nested=nested)
    jb, tb = train_batches(tm.cfg, s=32)
    (_, _), rgrads = jax.jit(jax.value_and_grad(
        ref_loss_fn(rm), has_aux=True))(rstate.params, jb)
    calls = []
    plain = torch.utils.checkpoint.checkpoint

    def counted(fn, *args, **kw):
        calls.append(fn.__name__)
        assert kw == {"use_reentrant": False}
        return plain(fn, *args, **kw)
    monkeypatch.setattr(torch.utils.checkpoint, "checkpoint", counted)
    loss, _, grads = loss_and_grads(make_loss_fn(tm), state.params, tb)
    assert len(calls) == REMAT_BODIES[arch](tm.cfg), calls
    assert all(bool(torch.isfinite(g).all()) for g in leaves(grads)), arch
    assert_leaves_rel(port_layout_np(tm.cfg, rgrads), grads, 1e-4, arch)
    calls.clear()
    loss0, _, grads0 = loss_and_grads(make_loss_fn(tm_none),
                                      state_none.params, tb)
    assert calls == []
    assert float(loss) == float(loss0)
    for a, b in zip(leaves(grads), leaves(grads0)):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7,
                                   equal_nan=True)
