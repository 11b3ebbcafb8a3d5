"""Train-step factory: loss, backward, clip, optimizer, microbatching
(port of ``repro.training.train_loop``).

``make_train_step(model, ...)`` returns ``train_step(state, batch) ->
(state, metrics)``.  ``TrainState`` bundles params + optimizer state +
step counter.  The reference's step is a pure function that ``jit``
compiles with the state donated; the port's runs eagerly and updates the
state in place (parameters, optimizer state and step), so one train
state is alive at a time, and returns it.  A caller that needs the state
from before a step clones it first.

Cross-entropy is computed in float32 with next-token targets from the
model's aux (``targets`` / ``loss_mask`` — the VLM masks image positions,
enc-dec targets are decoder tokens).

Microbatch gradient accumulation (``accum_steps > 1``) loops over batch
slices and sums their float32 gradients: memory for activations drops by
the accumulation factor while the optimizer sees the full-batch gradient.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import torch

from repro_torch.models.model_zoo import Model

from .optimizer import (Optimizer, clip_by_global_norm, cosine_schedule,
                        make_optimizer)
from .tree import leaves, tree_map

F32 = torch.float32

__all__ = ["TrainState", "cross_entropy", "make_loss_fn", "loss_and_grads",
           "make_train_step", "init_train_state", "abstract_train_state"]


class TrainState(NamedTuple):
    params: Any
    opt_state: Any
    step: torch.Tensor


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                  mask: torch.Tensor) -> torch.Tensor:
    """Next-token CE.  logits (B,S,V) f32; targets/mask (B,S)."""
    lg = logits[:, :-1, :]
    tg = targets[:, 1:]
    mk = mask[:, 1:] & mask[:, :-1]
    logz = torch.logsumexp(lg, dim=-1)
    gold = torch.gather(lg, -1, tg[..., None].long())[..., 0]
    nll = (logz - gold) * mk
    return nll.sum() / torch.clamp(mk.sum(), min=1)


def make_loss_fn(model: Model):
    def loss_fn(params, batch):
        logits, aux = model.train_logits(params, batch)
        ce = cross_entropy(logits, aux["targets"], aux["loss_mask"])
        total = ce + aux.get("aux_loss", 0.0)
        return total, {"ce": ce, "aux": aux.get("aux_loss", 0.0)}
    return loss_fn


def _grads(loss: torch.Tensor, params: List[torch.Tensor]
           ) -> List[torch.Tensor]:
    """d loss / d params; zeros for a parameter the loss does not reach
    (as ``jax.grad`` gives)."""
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    return [torch.zeros_like(p) if g is None else g
            for g, p in zip(grads, params)]


def loss_and_grads(loss_fn: Callable, params, batch: Dict,
                   accum_steps: int = 1):
    """(loss, {"ce", "aux"}, gradients as a tree shaped like ``params``):
    the reference's ``value_and_grad`` of the loss, or with
    ``accum_steps > 1`` its scan over microbatches (the batch split along
    its first axis), whose gradients are summed in float32 and averaged,
    and whose ``ce`` is the mean total loss, as the reference's is."""
    flat = leaves(params)
    if accum_steps == 1:
        loss, parts = loss_fn(params, batch)
        grads = _grads(loss, flat)
        loss, parts = loss.detach(), {k: torch.as_tensor(v).detach()
                                      for k, v in parts.items()}
    else:
        mbs = {k: v.reshape(accum_steps, v.shape[0] // accum_steps,
                            *v.shape[1:]) for k, v in batch.items()}
        grads = [torch.zeros(p.shape, dtype=F32, device=p.device)
                 for p in flat]
        dev = flat[0].device
        loss = torch.zeros((), dtype=F32, device=dev)
        aux = torch.zeros((), dtype=F32, device=dev)
        for i in range(accum_steps):
            l, parts = loss_fn(params, {k: v[i] for k, v in mbs.items()})
            for acc, g in zip(grads, _grads(l, flat)):
                acc.add_(g.to(F32))
            loss = loss + l.detach()
            aux = aux + torch.as_tensor(parts["aux"]).detach()
        for g in grads:
            g.div_(accum_steps)
        loss = loss / accum_steps
        parts = {"ce": loss, "aux": aux / accum_steps}
    it = iter(grads)
    return loss, parts, tree_map(lambda _: next(it), params)


def make_train_step(model: Model,
                    optimizer: Optional[Optimizer] = None,
                    lr: float = 3e-4,
                    warmup: int = 100,
                    total_steps: int = 10_000,
                    max_grad_norm: float = 1.0,
                    accum_steps: int = 1) -> Callable:
    cfg = model.cfg
    opt = optimizer if optimizer is not None else make_optimizer(
        cfg.optimizer, cfg)
    lr_fn = cosine_schedule(lr, warmup, total_steps)
    loss_fn = make_loss_fn(model)

    def train_step(state: TrainState, batch: Dict
                   ) -> Tuple[TrainState, Dict]:
        loss, parts, grads = loss_and_grads(loss_fn, state.params, batch,
                                            accum_steps)
        grads, gnorm = clip_by_global_norm(grads, max_grad_norm)
        lr_now = lr_fn(state.step)
        opt.update(grads, state.params, state.opt_state, lr_now)
        del grads
        state.step.add_(1)
        metrics = {"loss": loss, "ce": parts["ce"], "aux_loss": parts["aux"],
                   "grad_norm": gnorm, "lr": lr_now}
        return state, metrics

    return train_step


def init_train_state(model: Model, rng,
                     optimizer: Optional[Optimizer] = None) -> TrainState:
    """Parameters from ``model.init_params(rng)`` asking for gradients,
    the optimizer's state, step 0 (int32), all on the model's device."""
    opt = optimizer if optimizer is not None else make_optimizer(
        model.cfg.optimizer, model.cfg)
    params = model.init_params(rng).requires_grad_(True)
    return TrainState(params, opt.init(params),
                      torch.zeros((), dtype=torch.int32,
                                  device=model.device))


def abstract_train_state(model: Model,
                         optimizer: Optional[Optimizer] = None
                         ) -> TrainState:
    """Shape-only TrainState (``"meta"`` tensors: no allocation)."""
    opt = optimizer if optimizer is not None else make_optimizer(
        model.cfg.optimizer, model.cfg)
    params = model.param_specs()
    return TrainState(params, opt.init(params),
                      torch.zeros((), dtype=torch.int32, device="meta"))
