"""Divisibility mask and squarefree factorization: CUDA kernels and their
tensor-level wrappers.

``divisibility_mask`` replaces ``repro/kernels/factorize.py::
divisibility_mask_pallas`` (``csrc/divmask.cu``),
``factorize_squarefree`` replaces ``factorize_squarefree_pallas``
(``csrc/factorize.cu``), and their multi-limb twins
``divisibility_mask_limbs`` and ``factorize_limbs`` replace
``divisibility_mask_limbs_pallas`` (``csrc/divmask_limbs.cu``) and
``factorize_limbs_pallas`` (``csrc/factorize_limbs.cu``).  A wrapper runs
the kernel for CUDA tensors and the plain version (``ref.py``) for CPU
tensors; it never falls back from one to the other.  Flat inputs are
non-negative int32 or int64; limb inputs are (N, L) int64 limbs in
[0, 2**32) with int64 primes in [0, 2**31) (callers check values on the
host before upload, ``ops.py``); primes <= 1 never divide.
"""

from __future__ import annotations

import ctypes

import torch

from .cuda import CudaKernel
from .ref import (divisibility_mask_limbs_ref, divisibility_mask_ref,
                  factorize_limbs_ref, factorize_squarefree_ref)

__all__ = ["divisibility_mask", "factorize_squarefree",
           "divisibility_mask_limbs", "factorize_limbs", "DIVMASK",
           "FACTORIZE", "DIVMASK_LIMBS", "FACTORIZE_LIMBS",
           "check_int_tensors", "check_limb_tensors"]

_P = ctypes.c_void_p
_I64 = ctypes.c_longlong
_INT = ctypes.c_int

DIVMASK = CudaKernel("divisibility_mask", "divmask.cu", "pfcs_divmask",
                     [_P, _P, _P, _I64, _I64, _INT, _P])
FACTORIZE = CudaKernel("factorize_squarefree", "factorize.cu",
                       "pfcs_factorize", [_P, _P, _P, _P, _I64, _I64, _INT, _P])
DIVMASK_LIMBS = CudaKernel("divisibility_mask_limbs", "divmask_limbs.cu",
                           "pfcs_divmask_limbs",
                           [_P, _P, _P, _I64, _I64, _INT, _P])
FACTORIZE_LIMBS = CudaKernel("factorize_limbs", "factorize_limbs.cu",
                             "pfcs_factorize_limbs",
                             [_P, _P, _P, _P, _I64, _I64, _INT, _P])


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


def check_limb_tensors(primes: torch.Tensor, *limbs: torch.Tensor) -> None:
    """Raise unless every limb tensor is 2-D and the primes 1-D, all
    contiguous int64 on one device (CPU or CUDA), the limb tensors of one
    shape with at least one limb."""
    for t in (primes, *limbs):
        if t.dtype != torch.int64:
            raise TypeError(f"expected int64, got {t.dtype}")
        if t.device != primes.device:
            raise ValueError(f"device mismatch: {t.device} vs {primes.device}")
        if not t.is_contiguous():
            raise ValueError("expected contiguous tensors")
    if primes.dim() != 1:
        raise ValueError(f"expected 1-D primes, got {tuple(primes.shape)}")
    for t in limbs:
        if t.dim() != 2 or t.shape != limbs[0].shape or t.shape[1] < 1:
            raise ValueError(f"expected (N, L) limbs of one shape, L >= 1, "
                             f"got {tuple(t.shape)}")
    if primes.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {primes.device}")


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


def divisibility_mask_limbs(limbs: torch.Tensor,
                            primes: torch.Tensor) -> torch.Tensor:
    """(N, P) bool: ``mask[i, j] = primes[j] > 1`` and ``primes[j]``
    divides the composite held in limb row ``i``."""
    check_limb_tensors(primes, limbs)
    if limbs.device.type == "cpu":
        return divisibility_mask_limbs_ref(limbs, primes)
    (n, nl), p = limbs.shape, primes.shape[0]
    mask = torch.empty((n, p), dtype=torch.bool, device=limbs.device)
    if n and p:
        DIVMASK_LIMBS.launch(limbs.device, limbs.data_ptr(),
                             primes.data_ptr(), mask.data_ptr(), n, p, nl)
    return mask


def factorize_limbs(limbs: torch.Tensor, primes: torch.Tensor):
    """``(mask (N, P) bool, residual (N, L) int64)``: the limb mask and
    each composite divided once by every pool prime that divides it."""
    check_limb_tensors(primes, limbs)
    if limbs.device.type == "cpu":
        return factorize_limbs_ref(limbs, primes)
    (n, nl), p = limbs.shape, primes.shape[0]
    mask = torch.empty((n, p), dtype=torch.bool, device=limbs.device)
    residual = torch.empty_like(limbs)
    if n:
        FACTORIZE_LIMBS.launch(limbs.device, limbs.data_ptr(),
                               primes.data_ptr(), mask.data_ptr(),
                               residual.data_ptr(), n, p, nl)
    return mask, residual
