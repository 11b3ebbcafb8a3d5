"""Shared model layers: norms, rotary embeddings, FFN variants, embeddings
(port of ``repro.models.layers``).

Parameters are nested dicts of tensors while they are made (the
``init_*`` helpers) and a :class:`ParamTree` module once assembled; the
``apply_*`` functions index either by key, as the reference indexes its
dict pytrees.  Where the reference asks a matmul for a float32 result
(``preferred_element_type``) and casts it back to the inputs' dtype, the
port multiplies in that dtype (a bfloat16 matmul accumulates in float32
and rounds once, as the cast does); where it keeps the float32 result
(the GLU's gate and up, the logits), the port multiplies float32 copies
of the operands, whose products are exact, so nothing is rounded to
bfloat16 (:func:`mm`, :func:`unembed`).
"""

from __future__ import annotations

import functools
import math
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

Params = Dict[str, Any]

F32 = torch.float32

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


def _dtype(name: str) -> torch.dtype:
    return _DTYPES[name]


class ParamTree(nn.Module):
    """A nested dict of tensors as a module: each dict becomes a child
    ``ParamTree``, each list an ``nn.ModuleList`` of them, each tensor a
    parameter that asks for no gradient (the port runs forwards only).
    ``tree[key]`` and ``key in tree`` read it as the reference reads its
    dict pytree."""

    def __init__(self, tree: Dict[str, Any]):
        super().__init__()
        for key, value in tree.items():
            if isinstance(value, dict):
                self.add_module(key, ParamTree(value))
            elif isinstance(value, (list, tuple)):
                self.add_module(key, nn.ModuleList(
                    ParamTree(v) for v in value))
            else:
                self.register_parameter(
                    key, nn.Parameter(value, requires_grad=False))

    def __getitem__(self, key: str):
        return getattr(self, key)

    def __contains__(self, key: str) -> bool:
        return key in self._parameters or key in self._modules

    def keys(self):
        return list(self._parameters) + list(self._modules)


# --------------------------------------------------------------------------- #
# init helpers                                                                #
# --------------------------------------------------------------------------- #

def truncated_normal(shape, generator: torch.Generator,
                     device) -> torch.Tensor:
    """Float32 standard normal truncated to [-2, 2], drawn by inverting
    the normal CDF on a uniform draw (``jax.random.truncated_normal``'s
    distribution; the streams differ).  On ``"meta"``: the shape only."""
    if torch.device(device).type == "meta":
        return torch.empty(shape, dtype=F32, device="meta")
    lo = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))
    hi = 0.5 * (1.0 + math.erf(2.0 / math.sqrt(2.0)))
    t = torch.empty(shape, dtype=F32, device=device)
    t.uniform_(2.0 * lo - 1.0, 2.0 * hi - 1.0, generator=generator)
    t.erfinv_().mul_(math.sqrt(2.0)).clamp_(-2.0, 2.0)
    return t


def dense_init(gen: torch.Generator, shape, dtype, device,
               scale: Optional[float] = None) -> torch.Tensor:
    """Truncated-normal fan-in init."""
    if scale is None:
        fan_in = shape[0] if len(shape) >= 2 else 1
        scale = 1.0 / math.sqrt(max(1, fan_in))
    return (truncated_normal(shape, gen, device) * scale).to(dtype)


def embed_init(gen: torch.Generator, shape, dtype, device) -> torch.Tensor:
    t = torch.empty(shape, dtype=F32, device=device)
    if t.device.type != "meta":
        t.normal_(generator=gen)
    return (t * 0.02).to(dtype)


# --------------------------------------------------------------------------- #
# norms                                                                       #
# --------------------------------------------------------------------------- #

def init_rmsnorm(dim: int, dtype, device) -> Params:
    return {"scale": torch.ones((dim,), dtype=dtype, device=device)}


def rms_norm(x: torch.Tensor, p, eps: float = 1e-6) -> torch.Tensor:
    """``x * rsqrt(mean(x**2) + eps) * scale`` computed in float32 and
    cast back to ``x``'s dtype: PyTorch's ``rms_norm`` takes half and
    bfloat16 inputs through float32 itself."""
    return F.rms_norm(x, (x.shape[-1],), p["scale"], eps)


def init_layernorm(dim: int, dtype, device) -> Params:
    return {"scale": torch.ones((dim,), dtype=dtype, device=device),
            "bias": torch.zeros((dim,), dtype=dtype, device=device)}


def layer_norm(x: torch.Tensor, p, eps: float = 1e-6) -> torch.Tensor:
    xf = x.to(F32)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, correction=0)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * p["scale"].to(F32) + p["bias"].to(F32)).to(x.dtype)


# --------------------------------------------------------------------------- #
# rotary position embedding                                                   #
# --------------------------------------------------------------------------- #

def rope_frequencies(head_dim: int, theta: float, device) -> torch.Tensor:
    """(head_dim/2,) inverse frequencies."""
    exps = torch.arange(0, head_dim, 2, dtype=F32, device=device) / head_dim
    return 1.0 / (theta ** exps)


@functools.lru_cache(maxsize=64)
def _frequencies(head_dim: int, theta: float, device: str) -> torch.Tensor:
    return rope_frequencies(head_dim, theta, device)


def rope_table(positions: torch.Tensor, head_dim: int,
               theta: float) -> torch.Tensor:
    """``cos + i sin`` of the rotation angles, complex64 (..., S, 1, D/2):
    what :func:`apply_rope` computes for ``positions``, made once where
    many heads' tensors share the positions (every layer of a decode
    step)."""
    inv = _frequencies(head_dim, float(theta), str(positions.device))
    ang = positions[..., None].to(F32) * inv              # (..., S, D/2)
    return torch.polar(torch.ones_like(ang), ang)[..., None, :]


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               table: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Rotate interleaved pairs ``(x1, x2) = (x[..., 0::2], x[..., 1::2])``
    (not the half-split ``rotate_half``) to ``(x1 cos - x2 sin, x1 sin +
    x2 cos)`` in float32: the pairs as complex numbers times ``cos + i
    sin``.  x: (..., S, H, D), positions: broadcastable to (..., S);
    ``table``: their :func:`rope_table`."""
    rot = table if table is not None else rope_table(positions, x.shape[-1],
                                                     theta)
    pairs = x.to(F32).contiguous().reshape(*x.shape[:-1], -1, 2)
    out = torch.view_as_real(torch.view_as_complex(pairs) * rot)
    return out.reshape(x.shape).to(x.dtype)


# --------------------------------------------------------------------------- #
# FFN                                                                         #
# --------------------------------------------------------------------------- #

def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default, the tanh approximation."""
    return F.gelu(x, approximate="tanh")


_ACTS = {
    "silu": F.silu,
    "gelu": gelu,
    "relu": F.relu,
}


def dense(x: torch.Tensor, w: torch.Tensor, n: int = 1) -> torch.Tensor:
    """``jnp.einsum(..., preferred_element_type=float32).astype(x.dtype)``
    of the einsum that contracts the last ``n`` axes of ``x`` with the
    first ``n`` of ``w`` (``"bsd,dhk->bshk"``: n = 1; ``"bshk,hkd->bsd"``:
    n = 2), as one matmul in the inputs' dtype, which rounds once from its
    float32 accumulation."""
    lead, k = x.shape[:x.dim() - n], math.prod(w.shape[:n])
    return (x.reshape(*lead, k) @ w.reshape(k, -1)).reshape(*lead,
                                                           *w.shape[n:])


def mm(x: torch.Tensor, w: torch.Tensor, n: int = 1) -> torch.Tensor:
    """:func:`dense` with an unrounded float32 result
    (``preferred_element_type=float32`` kept as it is): the product of
    float32 copies of the operands."""
    return dense(x.to(F32), w.to(F32), n)


def init_ffn(gen, d_model: int, d_ff: int, act: str, dtype,
             device) -> Params:
    if act in ("swiglu", "geglu"):
        return {
            "w_gate": dense_init(gen, (d_model, d_ff), dtype, device),
            "w_up": dense_init(gen, (d_model, d_ff), dtype, device),
            "w_down": dense_init(gen, (d_ff, d_model), dtype, device),
        }
    return {
        "w_up": dense_init(gen, (d_model, d_ff), dtype, device),
        "w_down": dense_init(gen, (d_ff, d_model), dtype, device),
    }


def apply_ffn(x: torch.Tensor, p, act: str) -> torch.Tensor:
    if act in ("swiglu", "geglu"):
        gate = F.silu if act == "swiglu" else gelu
        g = gate(mm(x, p["w_gate"]))
        u = mm(x, p["w_up"])
        h = (g * u).to(x.dtype)
    else:
        h = _ACTS[act](mm(x, p["w_up"])).to(x.dtype)
    return dense(h, p["w_down"])


# --------------------------------------------------------------------------- #
# embeddings / unembedding                                                    #
# --------------------------------------------------------------------------- #

def init_embedding(gen, vocab: int, d_model: int, dtype, device) -> Params:
    return {"table": embed_init(gen, (vocab, d_model), dtype, device)}


def embed_tokens(tokens: torch.Tensor, p) -> torch.Tensor:
    return p["table"][tokens.long()]


def unembed(x: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Logits in float32 — softmax stability at vocab 256k: ``...d,vd->...v``
    with ``preferred_element_type=float32``, as :func:`mm`."""
    return x.to(F32) @ table.to(F32).T
