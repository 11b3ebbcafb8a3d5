"""Parameters across the two layouts: the reference's pytree (layers
stacked along a leading axis: the transformer's ``dense_layers`` then
``moe_layers``, zamba2's ``mamba_layers``, the xLSTM stack's ``m_stack``,
the encoder-decoder's ``enc_layers`` and ``dec_layers``) and the port's
:class:`~repro_torch.models.layers.ParamTree` (one module per layer: the
transformer's in ``params["layers"]``, the other families' in a list
under the reference's key; the reference's own lists, ``shared_blocks``
and ``s_blocks``, stay lists).

``params_from_reference`` takes the reference's parameters as nested
dicts (and lists) of float32 numpy arrays (a bfloat16 leaf passes
through float32 exactly), so nothing here imports JAX; each leaf takes
the dtype of the leaf at the same path of the port's own parameters
(``"meta"`` tensors of the family's init), so a float32 leaf of the
reference (the router, Mamba-2's ``A_log`` / ``D`` / ``dt_bias``, the
mLSTM gates, the sLSTM's ``bias``) stays float32 whatever the model's
dtype, and a leaf of the same name elsewhere takes the model's.
``reference_layout`` is its inverse, the port's parameters stacked back
into the reference's tree; ``reference_groups`` says which of the port's
leaves make each of the reference's (Adafactor's layout).
``train_state_from_reference`` carries a whole train state across, the
optimizer's float32 state included.
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch
from torch import nn

from repro_torch.device import resolve_device

from .layers import ParamTree
from .model_zoo import init_fn
from .transformer import n_dense_layers

__all__ = ["params_from_reference", "reference_layout", "reference_groups",
           "train_state_from_reference"]

#: the transformer's stacked keys, merged into ``layers`` in this order
_TRANSFORMER_STACKS = ("dense_layers", "moe_layers")
#: the other families' stacked keys, each kept as a list of layers
_STACKS = {"hybrid": ("mamba_layers",), "ssm": ("m_stack",),
           "audio": ("enc_layers", "dec_layers")}


def _transformer(cfg) -> bool:
    return cfg.family not in _STACKS


def _stack_len(tree) -> int:
    for value in tree.values():
        return (_stack_len(value) if isinstance(value, dict)
                else len(value))
    return 0


def _index(tree: Dict[str, Any], i: int) -> Dict[str, Any]:
    return {key: (_index(value, i) if isinstance(value, dict) else value[i])
            for key, value in tree.items()}


def _unstack(tree: Dict[str, Any]) -> List[Dict[str, Any]]:
    return [_index(tree, i) for i in range(_stack_len(tree))]


def _port_layout(cfg, tree: Dict[str, Any]) -> Dict[str, Any]:
    """The reference's tree regrouped into the port's layout (leaves
    untouched)."""
    if _transformer(cfg):
        out = {k: v for k, v in tree.items() if k not in _TRANSFORMER_STACKS}
        out["layers"] = [lp for key in _TRANSFORMER_STACKS if key in tree
                         for lp in _unstack(tree[key])]
        return out
    stacks = _STACKS[cfg.family]
    return {k: (_unstack(v) if k in stacks else v) for k, v in tree.items()}


def _cast(spec, tree, device, path: str, dtype=None):
    """``tree``'s numpy leaves as tensors with the dtype of ``spec``'s at
    the same path (or ``dtype``); raises ``ValueError`` where the
    structures differ."""
    if isinstance(spec, nn.ModuleList):
        if not isinstance(tree, (list, tuple)) or len(tree) != len(spec):
            n = len(tree) if isinstance(tree, (list, tuple)) else "no"
            raise ValueError(f"{path}: {n} layers in the tree, "
                             f"{len(spec)} in the model")
        return [_cast(s, t, device, f"{path}[{i}]", dtype)
                for i, (s, t) in enumerate(zip(spec, tree))]
    if isinstance(spec, ParamTree):
        if not isinstance(tree, dict) or sorted(tree) != sorted(spec.keys()):
            got = sorted(tree) if isinstance(tree, dict) else type(tree)
            raise ValueError(f"{path}: keys {got} in the tree, "
                             f"{sorted(spec.keys())} in the model")
        return {key: _cast(spec[key], tree[key], device, f"{path}/{key}",
                           dtype)
                for key in tree}
    t = torch.from_numpy(np.array(tree, dtype=np.float32))
    if tuple(t.shape) != tuple(spec.shape):
        raise ValueError(f"{path}: shape {tuple(t.shape)} in the tree, "
                         f"{tuple(spec.shape)} in the model")
    return t.to(device=device, dtype=dtype or spec.dtype)


def params_from_reference(cfg, tree: Dict[str, Any],
                          device="cuda") -> ParamTree:
    """The port's parameters on ``device`` from the reference's tree of
    float32 numpy arrays: the stacked layers split into per-layer
    modules, in layer order, each leaf in the dtype the port's init gives
    it (``cfg.dtype``, or float32 where the reference keeps float32)."""
    dev = resolve_device(device)
    spec = init_fn(cfg)(None, cfg, "meta")
    return ParamTree(_cast(spec, _port_layout(cfg, tree), dev, cfg.name))


def _as_tree(module):
    if isinstance(module, nn.ModuleList):
        return [_as_tree(m) for m in module]
    if isinstance(module, ParamTree):
        return {key: _as_tree(module[key]) for key in module.keys()}
    return module.data


def _stack(trees: List[Dict[str, Any]], stack) -> Dict[str, Any]:
    return {key: (_stack([t[key] for t in trees], stack)
                  if isinstance(trees[0][key], dict)
                  else stack([t[key] for t in trees]))
            for key in trees[0]}


def _regroup(cfg, tree: Dict[str, Any], stack) -> Dict[str, Any]:
    """The port's tree regrouped into the reference's: each stacked key's
    per-layer leaves joined by ``stack`` (a list of leaves, in layer
    order)."""
    if not _transformer(cfg):
        stacks = _STACKS[cfg.family]
        return {k: (_stack(v, stack) if k in stacks else v)
                for k, v in tree.items()}
    tree = dict(tree)
    layers = tree.pop("layers")
    n_dense = n_dense_layers(cfg)
    for key, part in zip(_TRANSFORMER_STACKS,
                         (layers[:n_dense], layers[n_dense:])):
        if part:
            tree[key] = _stack(part, stack)
    return tree


def reference_layout(cfg, params: ParamTree) -> Dict[str, Any]:
    """``params`` as the reference's tree of tensors: the per-layer
    modules stacked along a leading axis (works on ``"meta"`` parameters,
    ``Model.param_specs``)."""
    return _regroup(cfg, _as_tree(params), lambda xs: torch.stack(xs, 0))


def reference_groups(cfg) -> Dict[str, Any]:
    """The reference's tree of ``cfg``'s parameters with each leaf
    replaced by the index of the port's leaf it is in
    ``repro_torch.training.tree.leaves(params)``, or, for a stacked leaf,
    by the tuple of the indices of the per-layer leaves it stacks, in
    layer order: how Adafactor (``training/optimizer.py``) groups the
    port's leaves."""
    import itertools

    from repro_torch.training.tree import tree_map

    count = itertools.count()
    index = tree_map(lambda _: next(count), init_fn(cfg)(None, cfg, "meta"))
    return _regroup(cfg, index, tuple)


# --------------------------------------------------------------------------- #
# train states                                                                #
# --------------------------------------------------------------------------- #

def _tensors(tree, device):
    """A tree of numpy arrays (dicts, lists) as float32 tensors."""
    if isinstance(tree, dict):
        return {k: _tensors(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tensors(v, device) for v in tree]
    return torch.from_numpy(np.array(tree, dtype=np.float32)).to(device)


def _int32(x, device) -> torch.Tensor:
    return torch.tensor(int(np.asarray(x)), dtype=torch.int32, device=device)


def train_state_from_reference(cfg, params: Dict[str, Any],
                               opt_state: Dict[str, Any], step,
                               optimizer: str, device="cuda"):
    """The port's ``TrainState`` from the reference's, its leaves as
    numpy arrays (float32 or int): the parameters as
    :func:`params_from_reference` gives them (asking for gradients, as
    ``init_train_state``'s do); AdamW's ``m`` / ``v`` and SGD-momentum's
    ``mom`` in float32, unstacked like the parameters; Adafactor's ``s``
    in float32 in the reference's stacked layout (the port's Adafactor
    keeps it so); ``count`` and ``step`` int32."""
    from repro_torch.training.train_loop import TrainState

    dev = resolve_device(device)
    port = params_from_reference(cfg, params, dev).requires_grad_(True)
    spec = init_fn(cfg)(None, cfg, "meta")
    state: Dict[str, Any] = {"count": _int32(opt_state["count"], dev)}
    if optimizer == "adafactor":
        state["s"] = _tensors(opt_state["s"], dev)
    else:
        for key in {"adamw": ("m", "v"), "sgdm": ("mom",)}[optimizer]:
            state[key] = _cast(spec, _port_layout(cfg, opt_state[key]), dev,
                               f"{cfg.name}:{key}", torch.float32)
    return TrainState(port, state, _int32(step, dev))
