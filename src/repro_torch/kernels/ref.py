"""Plain PyTorch versions of the PFCS kernels.

The same functions as ``csrc/*.cu``, written as whole-tensor PyTorch so
that they run on any device: the wrappers in ``factorize.py`` and
``gcd.py`` use them for tensors on the CPU, the tests hold them against
``repro.kernels.ref`` and the Pallas kernels, and ``chip_smoke.py``
holds each CUDA kernel against them on the card.  Integer kernels: every
comparison is exact.
"""

from __future__ import annotations

import torch

__all__ = ["divisibility_mask_ref", "factorize_squarefree_ref", "gcd_ref"]


def divisibility_mask_ref(composites: torch.Tensor,
                          primes: torch.Tensor) -> torch.Tensor:
    """mask[i, j] = primes[j] divides composites[i].

    composites: (N,) int32/int64, primes: (P,) same dtype -> (N, P) bool.
    Zero-padded primes never divide (pad-safe); composite 0/1 rows are all
    False for primes > 1.
    """
    c = composites[:, None]
    p = primes[None, :]
    safe_p = torch.where(p <= 0, torch.ones_like(p), p)
    return ((c % safe_p) == 0) & (p > 1)


def factorize_squarefree_ref(composites: torch.Tensor, primes: torch.Tensor):
    """``(mask, residual)`` with ``residual[i] = composites[i] // prod of
    the dividing pool primes`` (1 when the pool factors it fully)."""
    mask = divisibility_mask_ref(composites, primes)
    p = primes[None, :].to(composites.dtype)
    factors = torch.where(mask, p, torch.ones_like(p))
    prod = torch.prod(factors, dim=1, dtype=composites.dtype)
    residual = torch.where(prod > 0, composites // prod.clamp(min=1),
                           composites)
    return mask, residual


def gcd_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise gcd by Euclid, looping until every ``b`` is 0;
    ``gcd(x, 0) = x``.  Same shape and dtype in and out."""
    a, b = a.clone(), b.clone()
    while bool((b != 0).any()):
        live = b != 0
        r = torch.where(live, a % torch.where(live, b, torch.ones_like(b)),
                        torch.zeros_like(a))
        a = torch.where(live, b, a)
        b = r
    return a
