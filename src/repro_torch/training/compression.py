"""Error-feedback int8 gradient compression for the data-parallel axis
(port of ``repro.training.compression``).

At 1000+ nodes the DP all-reduce of bf16 gradients dominates the step for
small-per-chip-batch regimes.  This module implements 1-bit-Adam-style
error-feedback quantization adapted to int8:

    q = round(clip(g / scale)) with per-tensor scale = max|g| / 127
    residual' = g - q * scale           (carried to the next step)

The quantize/dequantize pair wraps the gradient *before* the all-reduce;
error feedback keeps the optimizer trajectory unbiased in the long run
(Karimireddy et al., 2019).  4x wire-size reduction on the slowest links.

All functions are pure tree transforms over tensors
(:mod:`repro_torch.training.tree`); ``round`` rounds half to even, as
``jnp.round`` does.
"""

from __future__ import annotations

from typing import Any, Tuple

import torch

from .tree import leaves, tree_map, zeros_like

F32 = torch.float32

__all__ = ["init_residuals", "quantize", "dequantize", "compress_tree",
           "decompress_tree", "roundtrip_error"]


def init_residuals(params: Any) -> Any:
    return zeros_like(params)


def quantize(g: torch.Tensor, residual: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (int8 q, f32 scale scalar, new residual)."""
    gf = g.to(F32) + residual
    scale = torch.clamp(torch.max(torch.abs(gf)), min=1e-12) / 127.0
    q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
    new_residual = gf - q.to(F32) * scale
    return q, scale, new_residual


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(F32) * scale


def compress_tree(grads: Any, residuals: Any) -> Tuple[Any, Any]:
    """Quantize every leaf; returns ((q, scale) tree, residual tree)."""
    out = [quantize(g, r) for g, r in zip(leaves(grads), leaves(residuals))]
    qs, rs = iter([(q, s) for q, s, _ in out]), iter([r for _, _, r in out])
    return (tree_map(lambda _: next(qs), grads),
            tree_map(lambda _: next(rs), grads))


def _is_pair(x) -> bool:
    return isinstance(x, tuple) and not hasattr(x, "_fields")


def decompress_tree(qtree: Any) -> Any:
    return tree_map(lambda qs: dequantize(*qs), qtree, is_leaf=_is_pair)


def roundtrip_error(grads: Any, residuals: Any) -> float:
    """Diagnostic: relative L2 error of one compress/decompress pass."""
    qt, _ = compress_tree(grads, residuals)
    back = decompress_tree(qt)
    num = sum(torch.sum((a.to(F32) - b) ** 2)
              for a, b in zip(leaves(grads), leaves(back)))
    den = sum(torch.sum(a.to(F32) ** 2) for a in leaves(grads))
    return float(torch.sqrt(num / torch.clamp(den, min=1e-30)))
