"""The port's train step (``repro_torch.training.train_loop``) on the CPU
against the reference's: the decoder-only transformer archs here, the
hybrid, recurrent and encoder-decoder ones in
``tests/test_torch_train_families.py`` (the two files split the ten
``ARCH_IDS``; ``tests/torch_parity.py::check_train_step`` is the check).

Each smoke configuration (``tests/test_models.py``'s batch: B 2 x S 64,
the VLM's patches, the audio family's frames) takes one train step from
a train state carried across from the reference's
(``train_state_from_reference``): loss and metrics within 1e-4, every
gradient leaf within 1e-4 of its largest magnitude, the step counter at
1, and every parameter within two learning rates of the reference's
(AdamW's first update is about ``lr * sign(g)``, so a gradient element
near zero that rounds apart in the two packages may move a parameter the
other way).  Then ``accum_steps=2`` against the reference's microbatch
scan: the accumulated, clipped gradients that each package's step hands
its optimizer, leaf by leaf, and against the port's own full batch.
"""

import torch_parity  # noqa: F401

import jax
import pytest
import torch

from repro.configs import ARCH_IDS
from repro_torch.training.optimizer import Optimizer, make_optimizer
from repro_torch.training.train_loop import (loss_and_grads, make_loss_fn,
                                             make_train_step)
from repro_torch.training.tree import leaves, tree_map
from torch_parity import (LR, _np_tree, assert_leaves_rel,
                          assert_params_near, assert_train_metrics,
                          check_train_step, port_layout_np, train_batches,
                          train_pair)
from torch_parity import one_torch_thread  # noqa: F401

FAMILIES = ("zamba2-7b", "xlstm-1.3b", "seamless-m4t-large-v2")


@pytest.mark.parametrize("arch", [a for a in ARCH_IDS if a not in FAMILIES])
def test_train_step_equals_the_reference(arch):
    check_train_step(arch)


def ref_step_seeing_grads(rm, **kw):
    """The reference's jitted train step with its AdamW wrapped so that
    the state it returns also holds the gradients the update was given
    (after the microbatch scan and the clip); its state is
    ``{"opt": AdamW's, "grads": ...}``."""
    import jax

    from repro.training.optimizer import Optimizer as RefOptimizer
    from repro.training.optimizer import make_optimizer as ref_make_optimizer
    from repro.training.train_loop import make_train_step as ref_train_step

    adamw = ref_make_optimizer("adamw")

    def update(grads, params, state, lr):
        params, opt = adamw.update(grads, params, state["opt"], lr)
        return params, {"opt": opt, "grads": grads}
    return jax.jit(ref_train_step(rm, RefOptimizer(adamw.init, update), **kw))


def port_adamw_seeing_grads(seen: dict) -> Optimizer:
    """The port's AdamW, keeping a copy of each update's gradients in
    ``seen["grads"]``."""
    adamw = make_optimizer("adamw")

    def update(grads, params, state, lr):
        seen["grads"] = tree_map(lambda g: g.clone(), grads)
        return adamw.update(grads, params, state, lr)
    return Optimizer(adamw.init, update)


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "kimi-k2-1t-a32b"])
def test_accumulated_step_equals_the_reference(arch):
    """``accum_steps=2`` (two microbatches of the batch of 4; the MoE's
    routing per microbatch): the gradients each package's step hands its
    optimizer, accumulated over the microbatches and clipped, within 1e-4
    of each leaf's largest magnitude of the reference's scan; metrics
    within 1e-4, parameters within two learning rates; for the dense
    model the port's accumulated gradients within 1e-5 of its full
    batch's (whose loss is a mean over equal microbatches)."""
    import jax.numpy as jnp

    rm, rstate, tm, state = train_pair(arch)
    jb, tb = train_batches(tm.cfg, b=4, s=32, seed=1)
    kw = dict(lr=LR, warmup=0, total_steps=10, accum_steps=2)
    rstate = rstate._replace(opt_state={
        "opt": rstate.opt_state,
        "grads": jax.tree.map(jnp.zeros_like, rstate.params)})
    new, want = ref_step_seeing_grads(rm, **kw)(rstate, jb)
    loss_fn = make_loss_fn(tm)
    _, _, g2 = loss_and_grads(loss_fn, state.params, tb, accum_steps=2)
    assert all(g.dtype == torch.float32 for g in leaves(g2))
    if arch == "qwen2.5-3b":
        _, _, g1 = loss_and_grads(loss_fn, state.params, tb)
        assert_leaves_rel(_np_tree({"g": [g.numpy() for g in leaves(g1)]}),
                          {"g": leaves(g2)}, 1e-5)
    seen = {}
    _, got = make_train_step(tm, port_adamw_seeing_grads(seen), **kw)(
        state, tb)
    assert all(bool(torch.isfinite(g).all()) for g in leaves(seen["grads"]))
    assert_leaves_rel(port_layout_np(tm.cfg, new.opt_state["grads"]),
                      seen["grads"], 1e-4, arch)
    assert_train_metrics(got, want)
    assert_params_near(tm.cfg, new.params, state.params, LR)
