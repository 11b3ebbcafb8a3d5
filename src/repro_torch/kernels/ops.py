"""Host-facing wrappers around the PFCS kernels: numpy in, numpy out.

The contract of ``repro.kernels.ops``: composites are padded with 1,
primes with 0 and gcd pairs with 0 up to the tile multiples; the values
run as int32 when every one is <= ``2**31 - 1`` and as int64 otherwise;
the mask is compacted on the host with ``np.nonzero``.  Inputs are
checked for negative values on the host before upload (the CUDA kernels
compute on unsigned words).  ``device`` (default ``"cuda"``) decides
where the work runs: the CUDA kernels on a card, their plain PyTorch
versions for ``device="cpu"``.

Values beyond int64 take the multi-limb wrappers (``*_limbs``): Python
ints are packed into ``(N, L)`` little-endian 32-bit limb matrices, rows
padded with value 1 and primes with 0 to the same multiples, and results
are unpacked exactly.  Limbs must lie in [0, 2**32) and primes in
[0, 2**31), checked on the host (every intermediate of the limb kernels
then fits 63 bits).  The ``*_exact`` dispatchers take the flat kernels
whenever every value fits int64, the limb kernels otherwise.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.composite import (MAX_PRIME_LIMIT, LIMB_BASE,
                                        n_limbs_for_bits, pack_limbs,
                                        unpack_limbs)
from repro_torch.device import resolve_device

from .factorize import (divisibility_mask, divisibility_mask_limbs,
                        factorize_limbs, factorize_squarefree)
from .gcd import gcd, gcd_limbs

__all__ = ["factorize_batch", "divisibility_scan", "gcd_batch",
           "divisibility_scan_limbs", "factorize_batch_limbs",
           "gcd_batch_limbs", "factorize_batch_exact", "gcd_batch_exact",
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
        raise ValueError(f"{hi} exceeds int64: use the *_limbs wrappers")
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


# --------------------------------------------------------------------------- #
# multi-limb wrappers and the exact dispatchers                                #
# --------------------------------------------------------------------------- #

def _is_limbs(values) -> bool:
    return (isinstance(values, np.ndarray) and values.ndim == 2
            and values.dtype != object)


def _n_limbs(values) -> int:
    """Limbs enough for the widest of ``values`` (at least one)."""
    return max(1, n_limbs_for_bits(max(
        (int(v).bit_length() for v in values), default=1)))


def _as_limbs(values, n_limbs: Optional[int] = None) -> np.ndarray:
    """Values -> (N, L) int64 limb matrix (L from the widest value unless
    given); passes (N, L) arrays through."""
    if _is_limbs(values):
        return values.astype(np.int64)
    vals = [int(v) for v in values]
    return pack_limbs(vals, n_limbs or _n_limbs(vals))


def _pad_limb_rows(limbs: np.ndarray) -> np.ndarray:
    """Limb rows padded to a ``_BLOCK_N`` multiple with rows of value 1
    (which no prime divides)."""
    pad = (-limbs.shape[0]) % _BLOCK_N
    if pad == 0:
        return limbs
    one = np.zeros((pad, limbs.shape[1]), dtype=np.int64)
    one[:, 0] = 1
    return np.concatenate([limbs, one])


def _check_limbs(*arrays: np.ndarray) -> None:
    for a in arrays:
        if a.size and (int(a.min()) < 0 or int(a.max()) >= LIMB_BASE):
            raise ValueError("limb values must lie in [0, 2**32)")


def _check_pool(pool: np.ndarray) -> None:
    if pool.size and (int(pool.min()) < 0
                      or int(pool.max()) >= MAX_PRIME_LIMIT):
        raise ValueError("limb-kernel primes must lie in [0, 2**31)")


def divisibility_scan_limbs(
    registry_limbs,
    query_primes: Sequence[int],
    device="cuda",
) -> List[np.ndarray]:
    """Wide §4.2 scan: per query prime, indices of dividing composites.
    ``registry_limbs`` is an (N, L) limb matrix or a sequence of ints."""
    dev = resolve_device(device)
    limbs = _as_limbs(registry_limbs)
    qs = np.asarray(list(query_primes), dtype=np.int64)
    n, q = limbs.shape[0], qs.shape[0]
    if n == 0 or q == 0:
        return [np.empty(0, dtype=np.int64) for _ in range(q)]
    _check_limbs(limbs)
    _check_pool(qs)
    mask = divisibility_mask_limbs(_upload(_pad_limb_rows(limbs), dev),
                                   _upload(_pad_to(qs, _BLOCK_P, 0), dev))
    mask = mask.cpu().numpy()[:n, :q]
    return [np.nonzero(mask[:, j])[0] for j in range(q)]


def factorize_batch_limbs(
    composites,
    primes: Sequence[int],
    device="cuda",
) -> Tuple[List[List[int]], List[int]]:
    """Wide :func:`factorize_batch`: ``composites`` is an (N, L) limb
    matrix or a sequence of ints; residuals come back as exact Python
    ints (1 when the pool fully factors the composite)."""
    dev = resolve_device(device)
    limbs = _as_limbs(composites)
    pool = np.asarray(list(primes), dtype=np.int64)
    n, p = limbs.shape[0], pool.shape[0]
    if n == 0:
        return [], []
    _check_limbs(limbs)
    _check_pool(pool)
    mask, residual = factorize_limbs(_upload(_pad_limb_rows(limbs), dev),
                                     _upload(_pad_to(pool, _BLOCK_P, 0), dev))
    mask = mask.cpu().numpy()[:n, :p]
    residual = residual.cpu().numpy()[:n]
    factors = [[int(pool[j]) for j in np.nonzero(mask[i])[0]]
               for i in range(n)]
    return factors, unpack_limbs(residual)


def gcd_batch_limbs(
    a, b,
    pool: Sequence[int],
    device="cuda",
) -> List[int]:
    """Wide elementwise gcd of squarefree composite pairs (two (N, L) limb
    matrices or two sequences of ints), exact Python ints out.  ``pool``
    must cover the common member primes (either side's prime set
    suffices)."""
    dev = resolve_device(device)
    aa = _as_limbs(a, None if _is_limbs(a) else _n_limbs([*a, *b]))
    bb = _as_limbs(b, aa.shape[1])
    if aa.shape != bb.shape:
        raise ValueError(f"shape mismatch {aa.shape} vs {bb.shape}")
    pool_arr = np.asarray(list(pool), dtype=np.int64)
    n = aa.shape[0]
    if n == 0:
        return []
    _check_limbs(aa, bb)
    _check_pool(pool_arr)
    g = gcd_limbs(_upload(_pad_limb_rows(aa), dev),
                  _upload(_pad_limb_rows(bb), dev),
                  _upload(_pad_to(pool_arr, _BLOCK_P, 0), dev))
    return unpack_limbs(g.cpu().numpy()[:n])


def factorize_batch_exact(
    composites: Sequence[int],
    primes: Sequence[int],
    device="cuda",
) -> Tuple[List[List[int]], List[int]]:
    """Width-agnostic factorize: the flat kernels when every composite
    fits int64, the limb kernels otherwise.  Residuals are Python ints
    either way."""
    dev = resolve_device(device)
    vals = [int(c) for c in composites]
    if not vals:
        return [], []
    if max(vals) <= INT64_SAFE_LIMIT:
        facs, residual = factorize_batch(vals, primes, device=dev)
        return facs, [int(r) for r in residual]
    return factorize_batch_limbs(vals, primes, device=dev)


def gcd_batch_exact(
    a: Sequence[int],
    b: Sequence[int],
    pool: Sequence[int],
    device="cuda",
) -> List[int]:
    """Width-agnostic elementwise gcd: the flat kernel when every value
    fits int64, else the limb kernel (see :func:`gcd_batch_limbs` for the
    squarefree/pool contract of the wide path)."""
    dev = resolve_device(device)
    va = [int(x) for x in a]
    vb = [int(x) for x in b]
    if not va:
        return []
    if max(max(va), max(vb)) <= INT64_SAFE_LIMIT:
        return [int(g) for g in gcd_batch(va, vb, device=dev)]
    return gcd_batch_limbs(va, vb, pool, device=dev)
