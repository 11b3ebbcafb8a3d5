"""Host-facing wrappers around the PFCS kernels: numpy in, numpy out.

The contract of ``repro.kernels.ops``: composites are padded with 1,
primes with 0 and gcd pairs with 0 up to the tile multiples; the values
run as int32 when every one is <= ``2**31 - 1`` and as int64 otherwise;
the mask is compacted on the host with ``np.nonzero``.  Inputs are
checked for negative values on the host before upload (the CUDA kernels
compute on unsigned words).  ``device`` (default ``"cuda"``) decides
where the work runs: the CUDA kernels on a card, their plain PyTorch
versions for ``device="cpu"``.  Values beyond int64 need the multi-limb
kernels, which are not ported yet (ROADMAP.md A.7).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device

from .factorize import divisibility_mask, factorize_squarefree
from .gcd import gcd

__all__ = ["factorize_batch", "divisibility_scan", "gcd_batch",
           "factorize_batch_exact", "gcd_batch_exact",
           "INT32_SAFE_LIMIT", "INT64_SAFE_LIMIT"]

# composites below this fit the int32 path
INT32_SAFE_LIMIT = 2**31 - 1

# composites below this fit the flat int64 kernels; anything larger needs
# the multi-limb path
INT64_SAFE_LIMIT = 2**63 - 1

#: padding multiples of the reference's tiles: composite rows, pool primes
#: and gcd pairs are padded (with 1, 0 and 0) to these
_BLOCK_N = 256
_BLOCK_P = 512
_GCD_BLOCK = 1024

_WIDE = ("multi-limb (max_bits > 63) kernels are not ported yet "
         "(ROADMAP.md A.7)")


def _pad_to(x: np.ndarray, mult: int, fill) -> np.ndarray:
    n = x.shape[0]
    pad = (-n) % mult
    if pad == 0:
        return x
    return np.concatenate([x, np.full(pad, fill, dtype=x.dtype)])


def _pick_dtype(*arrays: np.ndarray):
    """int32 when every value fits, else int64; raises on negative values
    and on values past int64."""
    lo = min((int(a.min()) if a.size else 0) for a in arrays)
    if lo < 0:
        raise ValueError(f"kernel inputs must be non-negative, got {lo}")
    hi = max((int(a.max()) if a.size else 0) for a in arrays)
    if hi > INT64_SAFE_LIMIT:
        raise NotImplementedError(_WIDE)
    return np.int32 if hi <= INT32_SAFE_LIMIT else np.int64


def _upload(x: np.ndarray, dev: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x)).to(dev)


def factorize_batch(
    composites: Sequence[int],
    primes: Sequence[int],
    device="cuda",
) -> Tuple[List[List[int]], np.ndarray]:
    """Factor each composite against the pool.

    Returns ``(factors, residuals)`` — per composite the dividing pool
    primes and the remaining cofactor (1 when fully factored).
    """
    dev = resolve_device(device)
    comp = np.asarray(list(composites))
    pool = np.asarray(list(primes))
    if comp.size == 0:
        return [], np.empty(0, dtype=np.int64)
    dt = _pick_dtype(comp, pool)
    n, p = comp.shape[0], pool.shape[0]
    comp_p = _pad_to(comp.astype(dt), _BLOCK_N, 1)
    pool_p = _pad_to(pool.astype(dt), _BLOCK_P, 0)
    mask, residual = factorize_squarefree(_upload(comp_p, dev),
                                          _upload(pool_p, dev))
    mask = mask.cpu().numpy()[:n, :p]
    residual = residual.cpu().numpy()[:n]
    factors = [[int(pool[j]) for j in np.nonzero(mask[i])[0]]
               for i in range(n)]
    return factors, residual.astype(np.int64)


def divisibility_scan(
    registry: Sequence[int],
    query_primes: Sequence[int],
    device="cuda",
) -> List[np.ndarray]:
    """For each query prime, indices of registry composites it divides.

    The §4.2 prefetch scan: the host compacts the kernel's boolean mask
    into candidate index lists.
    """
    dev = resolve_device(device)
    reg = np.asarray(list(registry))
    qs = np.asarray(list(query_primes))
    if reg.size == 0 or qs.size == 0:
        return [np.empty(0, dtype=np.int64) for _ in range(qs.size)]
    dt = _pick_dtype(reg, qs)
    n, q = reg.shape[0], qs.shape[0]
    reg_p = _pad_to(reg.astype(dt), _BLOCK_N, 1)
    qs_p = _pad_to(qs.astype(dt), _BLOCK_P, 0)
    mask = divisibility_mask(_upload(reg_p, dev), _upload(qs_p, dev))
    mask = mask.cpu().numpy()[:n, :q]
    return [np.nonzero(mask[:, j])[0] for j in range(q)]


def gcd_batch(
    a: Sequence[int],
    b: Sequence[int],
    device="cuda",
) -> np.ndarray:
    """Elementwise gcd over pairs (shared-prefix composite discovery)."""
    dev = resolve_device(device)
    aa = np.asarray(list(a))
    bb = np.asarray(list(b))
    if aa.shape != bb.shape:
        raise ValueError(f"shape mismatch {aa.shape} vs {bb.shape}")
    if aa.size == 0:
        return np.empty(0, dtype=np.int64)
    dt = _pick_dtype(aa, bb)
    n = aa.shape[0]
    ap = _pad_to(aa.astype(dt), _GCD_BLOCK, 0)
    bp = _pad_to(bb.astype(dt), _GCD_BLOCK, 0)
    g = gcd(_upload(ap, dev), _upload(bp, dev))
    return g.cpu().numpy()[:n].astype(np.int64)


def factorize_batch_exact(
    composites: Sequence[int],
    primes: Sequence[int],
    device="cuda",
) -> Tuple[List[List[int]], List[int]]:
    """Width-agnostic factorize of ``repro``: the flat kernels when every
    composite fits int64 (residuals as Python ints); wider values raise
    ``NotImplementedError`` until the limb kernels are ported."""
    dev = resolve_device(device)
    vals = [int(c) for c in composites]
    if not vals:
        return [], []
    if max(vals) > INT64_SAFE_LIMIT:
        raise NotImplementedError(_WIDE)
    facs, residual = factorize_batch(vals, primes, device=dev)
    return facs, [int(r) for r in residual]


def gcd_batch_exact(
    a: Sequence[int],
    b: Sequence[int],
    pool: Sequence[int],
    device="cuda",
) -> List[int]:
    """Width-agnostic elementwise gcd: the flat kernel when every value
    fits int64 (``pool`` serves the limb path only, not ported yet)."""
    dev = resolve_device(device)
    va = [int(x) for x in a]
    vb = [int(x) for x in b]
    if not va:
        return []
    if max(max(va), max(vb)) > INT64_SAFE_LIMIT:
        raise NotImplementedError(_WIDE)
    return [int(g) for g in gcd_batch(va, vb, device=dev)]
