"""Optimizers: AdamW, Adafactor (factored second moment), SGD-momentum
(port of ``repro.training.optimizer``).

Self-contained (neither ``torch.optim`` nor a fused kernel: the
reference's arithmetic on tensors).  Each optimizer is a pair of
functions ``(init, update)`` over parameter trees
(:mod:`repro_torch.training.tree`); the state layouts are the
reference's:

  * AdamW     — m, v in float32 with the parameter's shape; an int32
    count.  ``update`` computes ``(m/bc1) / (sqrt(v/bc2) + eps) + wd*p``
    and ``p - lr*step`` in float32 and casts back to the parameter's
    dtype (``torch.optim.AdamW`` decays first and places ``eps``
    elsewhere).
  * Adafactor — factored v_row/v_col for rank>=2 tensors, full v for
    vectors; the update clipped by its RMS.  Both depend on the
    reference's layer stacking, so with a model's ``cfg``
    (:func:`make_optimizer`) the port's per-layer leaves are grouped by
    the reference's stacks (``models/convert.py::reference_groups``): a
    norm's ``(d,)`` scales make one ``(L, d)`` leaf, which is factored,
    and the clip takes one mean over the stack.  The state is kept in
    that stacked layout, keyed by the reference's paths.
  * SGDM      — a single float32 momentum buffer.

Unlike the reference's pure functions, ``update`` writes the new
parameters and state into the tensors it is given (the reference's
launcher donates them to ``jit``; at 3.4 B parameters two train states
would not fit beside each other) and returns them.
``cosine_schedule`` and global-norm clipping included.
"""

from __future__ import annotations

import itertools
import math
from typing import Any, Callable, NamedTuple, Tuple

import torch

from repro_torch.models.layers import ParamTree

from .tree import leaves, tree_map, zeros_like

F32 = torch.float32
Params = Any

__all__ = ["Optimizer", "cosine_schedule", "global_norm",
           "clip_by_global_norm", "adamw", "adafactor", "sgdm",
           "OPTIMIZERS", "make_optimizer"]


class Optimizer(NamedTuple):
    init: Callable[[Params], Any]
    update: Callable[[Params, Params, Any, torch.Tensor], Tuple[Params, Any]]
    # update(grads, params, state, lr) -> (params, state), both in place


def _device(params) -> torch.device:
    return leaves(params)[0].device


def _count(params) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32, device=_device(params))


def cosine_schedule(base_lr: float, warmup: int, total: int
                    ) -> Callable[[torch.Tensor], torch.Tensor]:
    """Linear warmup from 0, then a half cosine to 0 at ``total``: a
    float32 0-d tensor of the step (0 at step 0)."""
    def lr(step):
        step = torch.as_tensor(step).to(F32)
        warm = base_lr * step / max(1, warmup)
        prog = torch.clamp((step - warmup) / max(1, total - warmup), 0.0, 1.0)
        cos = 0.5 * base_lr * (1.0 + torch.cos(math.pi * prog))
        return torch.where(step < warmup, warm, cos)
    return lr


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(l.to(F32) ** 2) for l in leaves(tree)))


@torch.no_grad()
def clip_by_global_norm(grads, max_norm: float):
    """Scales ``grads`` in place (in float32, cast back to each leaf's
    dtype) so their global norm is at most ``max_norm``; returns
    (grads, the norm before clipping)."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    for g in leaves(grads):
        g.copy_(g.to(F32).mul_(scale))
    return grads, norm


# --------------------------------------------------------------------------- #
# AdamW                                                                       #
# --------------------------------------------------------------------------- #

def adamw(b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.1) -> Optimizer:
    def init(params):
        return {"m": zeros_like(params), "v": zeros_like(params),
                "count": _count(params)}

    @torch.no_grad()
    def update(grads, params, state, lr):
        count = state["count"].add_(1)
        c = count.to(F32)
        bc1 = 1.0 - torch.pow(b1, c)
        bc2 = 1.0 - torch.pow(b2, c)
        for g, p, m, v in zip(leaves(grads), leaves(params),
                              leaves(state["m"]), leaves(state["v"])):
            g = g.to(F32)
            m.mul_(b1).add_(g, alpha=1 - b1)
            v.mul_(b2).addcmul_(g, g, value=1 - b2)
            del g
            step = (m / bc1).div_((v / bc2).sqrt_().add_(eps))
            step.add_(p, alpha=weight_decay)
            p.copy_(p.to(F32).sub(step.mul_(lr)))
        return params, state

    return Optimizer(init, update)


# --------------------------------------------------------------------------- #
# Adafactor (Shazeer & Stern 2018), factored second moment                    #
# --------------------------------------------------------------------------- #

def _stacked(node) -> bool:
    """A stacked leaf of a groups tree: the tuple of its per-layer leaves'
    indices (the parameter trees themselves hold no tuples)."""
    return type(node) is tuple


def adafactor(eps: float = 1e-30, clip_threshold: float = 1.0,
              decay_exp: float = 0.8, weight_decay: float = 0.0,
              groups: Any = None) -> Optimizer:
    """``groups``: the tree of the leaves the reference updates, each leaf
    the index of a parameter leaf in ``leaves(params)`` or the tuple of
    the indices of the per-layer leaves it stacks
    (``models/convert.py::reference_groups``, which
    :func:`make_optimizer` passes for a model's ``cfg``).  Without it each
    leaf of a plain tree of tensors is a group of its own; a model's
    parameters (a ``ParamTree``) need it."""

    def _groups(params):
        if groups is not None:
            return groups
        if isinstance(params, ParamTree):
            raise ValueError("Adafactor on a model's parameters stacks them "
                             "as the reference does: make_optimizer("
                             "'adafactor', cfg)")
        count = itertools.count()
        return tree_map(lambda _: next(count), params)

    def _gather(flat, idx):
        if _stacked(idx):
            return torch.stack([flat[i].to(F32) for i in idx], 0)
        return flat[idx].to(F32)

    def init(params):
        flat, dev = leaves(params), _device(params)

        def st(idx):
            shape = ((len(idx),) + tuple(flat[idx[0]].shape) if _stacked(idx)
                     else tuple(flat[idx].shape))
            if len(shape) >= 2:     # factored
                return {"vr": torch.zeros(shape[:-1], dtype=F32, device=dev),
                        "vc": torch.zeros(shape[:-2] + shape[-1:], dtype=F32,
                                          device=dev)}
            return {"v": torch.zeros(shape, dtype=F32, device=dev)}
        return {"s": tree_map(st, _groups(params), is_leaf=_stacked),
                "count": _count(params)}

    @torch.no_grad()
    def update(grads, params, state, lr):
        count = state["count"].add_(1)
        c = count.to(F32)
        beta2 = 1.0 - torch.pow(c, -decay_exp)
        flat_g, flat_p = leaves(grads), leaves(params)

        def one(idx, s):
            g = _gather(flat_g, idx)
            g2 = g * g + eps
            if "vr" in s:
                vr = s["vr"].mul_(beta2).add_((1 - beta2) * g2.mean(-1))
                vc = s["vc"].mul_(beta2).add_((1 - beta2) * g2.mean(-2))
                denom = torch.clamp(vr.mean(-1, keepdim=True), min=eps)
                vhat = (vr[..., None] / denom[..., None]) * vc[..., None, :]
                u = g / torch.sqrt(vhat + eps)
            else:
                v = s["v"].mul_(beta2).add_((1 - beta2) * g2)
                u = g / torch.sqrt(v + eps)
            del g, g2
            # update clipping (RMS)
            rms_u = torch.sqrt(torch.mean(u * u) + eps)
            u = u / torch.clamp(rms_u / clip_threshold, min=1.0)
            p = _gather(flat_p, idx)
            new = p - lr * (u + weight_decay * p)
            if _stacked(idx):
                for j, i in enumerate(idx):
                    flat_p[i].copy_(new[j])
            else:
                flat_p[idx].copy_(new)
        tree_map(one, _groups(params), state["s"], is_leaf=_stacked)
        return params, state

    return Optimizer(init, update)


# --------------------------------------------------------------------------- #
# SGD + momentum                                                              #
# --------------------------------------------------------------------------- #

def sgdm(momentum: float = 0.9, weight_decay: float = 0.0) -> Optimizer:
    def init(params):
        return {"mom": zeros_like(params), "count": _count(params)}

    @torch.no_grad()
    def update(grads, params, state, lr):
        for g, p, m in zip(leaves(grads), leaves(params),
                           leaves(state["mom"])):
            g = g.to(F32) + weight_decay * p.to(F32)
            m.mul_(momentum).add_(g)
            p.copy_(p.to(F32) - lr * m)
        state["count"].add_(1)
        return params, state

    return Optimizer(init, update)


OPTIMIZERS = {"adamw": adamw, "adafactor": adafactor, "sgdm": sgdm}


def make_optimizer(name: str, cfg=None, **kw) -> Optimizer:
    """The optimizer ``name``; with a model's ``cfg``, Adafactor updates
    the reference's stacked leaves (the other two are elementwise)."""
    if name == "adafactor" and cfg is not None:
        from repro_torch.models.convert import reference_groups

        kw.setdefault("groups", reference_groups(cfg))
    return OPTIMIZERS[name](**kw)
