"""Random weights drawn by the benchmark from the seed, on the device, in
the dtype they are served in, in a few large calls: one standard-normal
draw over a single flat buffer per dtype, then each leaf scaled in place.

The leaves and their shapes are the program's (its parameter tree built
on ``"meta"``); the values are the benchmark's own, so the reference can
be handed the same numbers.  Scales, by leaf name:

- ``*.scale`` (norms), ``D``: ones; ``conv_b``, ``dt_bias``, biases: zeros;
- ``A_log``: log(1..16) spread over the heads (decay rates 1 to 16);
- ``embed.table``, ``unembed``: N(0, 0.02^2);
- ``conv_w``: N(0, 0.5^2); every other matrix: N(0, 1 / fan_in), fan_in
  the product of every axis but the last (the axes a product contracts).
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

_DRAW = 1 << 28            # elements per normal_ call


def _scale(name: str, shape) -> float:
    leaf = _leaf(name)
    if name in ("embed.table", "unembed"):
        return 0.02
    if leaf == "conv_w":
        return 0.5
    return 1.0 / math.sqrt(max(1, math.prod(shape[:-1])))


_ONES = ("scale", "D")
_ZEROS = ("conv_b", "dt_bias", "bq", "bk", "bv")


def _leaf(name: str) -> str:
    return name.rsplit(".", 1)[-1]


def _constant(name: str, shape, dtype, device) -> torch.Tensor:
    leaf = _leaf(name)
    if leaf in _ONES:
        return torch.ones(shape, dtype=dtype, device=device)
    if leaf in _ZEROS:
        return torch.zeros(shape, dtype=dtype, device=device)
    return torch.log(torch.linspace(1.0, 16.0, math.prod(shape),
                                    dtype=torch.float32, device=device)
                     ).reshape(shape).to(dtype)


def make_weights(meta_tree, seed: int, device) -> Tuple[object, Dict]:
    """``(tree, flat)``: the program's parameter tree filled with the seed's
    draws, and the same tensors by dotted name for the reference."""
    from torch import nn

    named = list(meta_tree.named_parameters())
    gen = torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))
    flat: Dict[str, torch.Tensor] = {}
    by_dtype: Dict[torch.dtype, list] = {}
    for name, p in named:
        by_dtype.setdefault(p.dtype, []).append((name, p))
    for dt, leaves in by_dtype.items():
        drawn = [(n, p) for n, p in leaves
                 if _leaf(n) not in _ONES + _ZEROS + ("A_log",)]
        total = sum(p.numel() for _, p in drawn)
        buf = torch.empty(total, dtype=dt, device=device)
        for i in range(0, total, _DRAW):
            buf[i:i + _DRAW].normal_(generator=gen)
        off = 0
        for n, p in drawn:
            t = buf[off:off + p.numel()].view(p.shape)
            off += p.numel()
            t.mul_(_scale(n, p.shape))
            flat[n] = t
        for n, p in leaves:
            if n not in flat:
                flat[n] = _constant(n, p.shape, dt, device)

    def build(module, prefix: str):
        out = {}
        for key in module.keys():
            child = module[key]
            name = prefix + key
            if isinstance(child, nn.Parameter):
                out[key] = flat[name]
            elif isinstance(child, nn.ModuleList):
                out[key] = [build(c, f"{name}.{i}.")
                            for i, c in enumerate(child)]
            else:
                out[key] = build(child, name + ".")
        return out

    return type(meta_tree)(build(meta_tree, "")), flat
