"""Elementwise gcd: the CUDA kernel and its tensor-level wrapper.

``gcd`` replaces ``repro/kernels/gcd.py::gcd_pallas`` (``csrc/gcd.cu``).
It runs the kernel for CUDA tensors and the plain Euclid loop
(``ref.gcd_ref``) for CPU tensors; it never falls back from one to the
other.  Inputs are non-negative int32 or int64; ``gcd(x, 0) = x``.
"""

from __future__ import annotations

import ctypes

import torch

from .cuda import CudaKernel
from .factorize import check_int_tensors
from .ref import gcd_ref

__all__ = ["gcd", "GCD"]

_P = ctypes.c_void_p

GCD = CudaKernel("gcd", "gcd.cu", "pfcs_gcd",
                 [_P, _P, _P, ctypes.c_longlong, ctypes.c_int, _P])


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
