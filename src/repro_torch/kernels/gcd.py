"""Elementwise gcd: the CUDA kernels and their tensor-level wrappers.

``gcd`` replaces ``repro/kernels/gcd.py::gcd_pallas`` (``csrc/gcd.cu``)
and ``gcd_limbs`` replaces ``gcd_limbs_pallas`` (``csrc/gcd_limbs.cu``).
Each runs its kernel for CUDA tensors and its plain version (``ref.py``)
for CPU tensors; it never falls back from one to the other.  Flat inputs
are non-negative int32 or int64, ``gcd(x, 0) = x``; limb inputs are
(N, L) int64 limbs in [0, 2**32) and an int64 pool in [0, 2**31).
"""

from __future__ import annotations

import ctypes

import torch

from .cuda import CudaKernel
from .factorize import check_int_tensors, check_limb_tensors
from .ref import gcd_limbs_ref, gcd_ref

__all__ = ["gcd", "gcd_limbs", "GCD", "GCD_LIMBS"]

_P = ctypes.c_void_p

GCD = CudaKernel("gcd", "gcd.cu", "pfcs_gcd",
                 [_P, _P, _P, ctypes.c_longlong, ctypes.c_int, _P])
GCD_LIMBS = CudaKernel("gcd_limbs", "gcd_limbs.cu", "pfcs_gcd_limbs",
                       [_P, _P, _P, _P, ctypes.c_longlong, ctypes.c_longlong,
                        ctypes.c_int, _P])


def gcd(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise ``gcd(a, b)``, same shape and dtype as ``a``."""
    check_int_tensors(a, b)
    if a.shape != b.shape:
        raise ValueError(f"shape mismatch {tuple(a.shape)} vs {tuple(b.shape)}")
    if a.device.type == "cpu":
        return gcd_ref(a, b)
    out = torch.empty_like(a)
    if a.numel():
        GCD.launch(a.device, a.data_ptr(), b.data_ptr(), out.data_ptr(),
                   a.numel(), a.element_size())
    return out


def gcd_limbs(a: torch.Tensor, b: torch.Tensor,
              pool: torch.Tensor) -> torch.Tensor:
    """(N, L) limbs of the product of the pool primes (> 1) dividing both
    ``a[i]`` and ``b[i]``, truncated to L limbs: their gcd when both are
    squarefree products of pool primes."""
    check_limb_tensors(pool, a, b)
    if a.device.type == "cpu":
        return gcd_limbs_ref(a, b, pool)
    (n, nl), p = a.shape, pool.shape[0]
    out = torch.empty_like(a)
    if n:
        GCD_LIMBS.launch(a.device, a.data_ptr(), b.data_ptr(),
                         pool.data_ptr(), out.data_ptr(), n, p, nl)
    return out
