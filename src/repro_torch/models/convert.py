"""Parameters across the two layouts: the reference's pytree (layers
stacked along a leading axis, ``dense_layers`` then ``moe_layers``) and
the port's :class:`~repro_torch.models.layers.ParamTree` (one module per
layer in ``params["layers"]``).

``params_from_reference`` takes the reference's parameters as nested
dicts of float32 numpy arrays (a bfloat16 leaf passes through float32
exactly), so nothing here imports JAX; ``reference_layout`` is its
inverse, the port's parameters stacked back into the reference's tree.
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

from repro_torch.device import resolve_device

from .layers import F32, ParamTree, _dtype
from .transformer import n_dense_layers

__all__ = ["params_from_reference", "reference_layout"]

#: leaves the reference keeps in float32 whatever the model's dtype
_F32_LEAVES = ("router",)


def _leaf(key: str, a, dtype, device) -> torch.Tensor:
    t = torch.from_numpy(np.array(a, dtype=np.float32))
    return t.to(device=device, dtype=F32 if key in _F32_LEAVES else dtype)


def _tree(tree: Dict[str, Any], dtype, device, index=None) -> Dict:
    out = {}
    for key, value in tree.items():
        if isinstance(value, dict):
            out[key] = _tree(value, dtype, device, index)
        else:
            out[key] = _leaf(key, value if index is None else value[index],
                             dtype, device)
    return out


def _stack_len(tree: Dict[str, Any]) -> int:
    for value in tree.values():
        return (_stack_len(value) if isinstance(value, dict)
                else len(value))
    return 0


def params_from_reference(cfg, tree: Dict[str, Any],
                          device="cuda") -> ParamTree:
    """The port's parameters in ``cfg.dtype`` (the router in float32) on
    ``device`` from the reference's tree of float32 numpy arrays: the
    stacked ``dense_layers`` / ``moe_layers`` split into the per-layer
    modules, in layer order."""
    dev = resolve_device(device)
    dt = _dtype(cfg.dtype)
    out: Dict[str, Any] = {}
    for key, value in tree.items():
        if key in ("dense_layers", "moe_layers"):
            continue
        out[key] = (_tree(value, dt, dev) if isinstance(value, dict)
                    else _leaf(key, value, dt, dev))
    layers: List[Dict] = []
    for key in ("dense_layers", "moe_layers"):
        if key in tree:
            stack = tree[key]
            layers += [_tree(stack, dt, dev, i)
                       for i in range(_stack_len(stack))]
    if len(layers) != cfg.n_layers:
        raise ValueError(f"{len(layers)} layers in the tree, "
                         f"{cfg.n_layers} in {cfg.name}")
    out["layers"] = layers
    return ParamTree(out)


def _as_dict(module) -> Dict[str, Any]:
    return {key: (_as_dict(module[key])
                  if isinstance(module[key], ParamTree) else module[key].data)
            for key in module.keys()}


def _stack(trees: List[Dict[str, Any]]) -> Dict[str, Any]:
    return {key: (_stack([t[key] for t in trees])
                  if isinstance(trees[0][key], dict)
                  else torch.stack([t[key] for t in trees], 0))
            for key in trees[0]}


def reference_layout(cfg, params: ParamTree) -> Dict[str, Any]:
    """``params`` as the reference's tree of tensors: the per-layer
    modules stacked into ``dense_layers`` and ``moe_layers`` (works on
    ``"meta"`` parameters, ``Model.param_specs``)."""
    out = {key: (_as_dict(params[key]) if isinstance(params[key], ParamTree)
                 else params[key].data)
           for key in params.keys() if key != "layers"}
    layers = [_as_dict(lp) for lp in params["layers"]]
    n_dense = n_dense_layers(cfg)
    if layers[:n_dense]:
        out["dense_layers"] = _stack(layers[:n_dense])
    if layers[n_dense:]:
        out["moe_layers"] = _stack(layers[n_dense:])
    return out
