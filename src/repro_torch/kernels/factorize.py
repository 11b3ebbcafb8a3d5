"""Divisibility mask and squarefree factorization: CUDA kernels and their
tensor-level wrappers.

``divisibility_mask`` replaces ``repro/kernels/factorize.py::
divisibility_mask_pallas`` (``csrc/divmask.cu``) and
``factorize_squarefree`` replaces ``factorize_squarefree_pallas``
(``csrc/factorize.cu``).  A wrapper runs the kernel for CUDA tensors and
the plain version (``ref.py``) for CPU tensors; it never falls back from
one to the other.  Inputs are non-negative int32 or int64 (callers check
on the host before upload, ``ops.py``); primes <= 1 never divide.
"""

from __future__ import annotations

import ctypes

import torch

from .cuda import CudaKernel
from .ref import divisibility_mask_ref, factorize_squarefree_ref

__all__ = ["divisibility_mask", "factorize_squarefree", "DIVMASK",
           "FACTORIZE", "check_int_tensors"]

_P = ctypes.c_void_p
_I64 = ctypes.c_longlong
_INT = ctypes.c_int

DIVMASK = CudaKernel("divisibility_mask", "divmask.cu", "pfcs_divmask",
                     [_P, _P, _P, _I64, _I64, _INT, _P])
FACTORIZE = CudaKernel("factorize_squarefree", "factorize.cu",
                       "pfcs_factorize", [_P, _P, _P, _P, _I64, _I64, _INT, _P])


def check_int_tensors(*ts: torch.Tensor) -> None:
    """Raise unless every tensor is 1-D, contiguous, int32 or int64, and
    all share one dtype and one device (CPU or CUDA)."""
    t0 = ts[0]
    for t in ts:
        if t.dtype not in (torch.int32, torch.int64):
            raise TypeError(f"expected int32 or int64, got {t.dtype}")
        if t.dtype != t0.dtype or t.device != t0.device:
            raise ValueError(f"dtype/device mismatch: {t.dtype}@{t.device} "
                             f"vs {t0.dtype}@{t0.device}")
        if t.dim() != 1 or not t.is_contiguous():
            raise ValueError("expected contiguous 1-D tensors")
    if t0.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {t0.device}")


def divisibility_mask(composites: torch.Tensor,
                      primes: torch.Tensor) -> torch.Tensor:
    """(N, P) bool: ``mask[i, j] = primes[j] > 1 and primes[j] | composites[i]``."""
    check_int_tensors(composites, primes)
    if composites.device.type == "cpu":
        return divisibility_mask_ref(composites, primes)
    n, p = composites.shape[0], primes.shape[0]
    mask = torch.empty((n, p), dtype=torch.bool, device=composites.device)
    if n and p:
        DIVMASK.launch(composites.device, composites.data_ptr(),
                       primes.data_ptr(), mask.data_ptr(), n, p,
                       composites.element_size())
    return mask


def factorize_squarefree(composites: torch.Tensor, primes: torch.Tensor):
    """``(mask (N, P) bool, residual (N,))``: the divisibility mask and
    each composite divided by its dividing pool primes."""
    check_int_tensors(composites, primes)
    if composites.device.type == "cpu":
        return factorize_squarefree_ref(composites, primes)
    n, p = composites.shape[0], primes.shape[0]
    mask = torch.empty((n, p), dtype=torch.bool, device=composites.device)
    residual = torch.empty_like(composites)
    if n:
        FACTORIZE.launch(composites.device, composites.data_ptr(),
                         primes.data_ptr(), mask.data_ptr(),
                         residual.data_ptr(), n, p,
                         composites.element_size())
    return mask, residual
