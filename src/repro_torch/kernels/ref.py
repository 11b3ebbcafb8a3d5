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

__all__ = ["divisibility_mask_ref", "factorize_squarefree_ref", "gcd_ref",
           "divisibility_mask_limbs_ref",
           "factorize_limbs_ref", "gcd_limbs_ref"]


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


# --------------------------------------------------------------------------- #
# multi-limb versions                                                          #
# --------------------------------------------------------------------------- #
# Composites wider than 63 bits arrive as (N, L) int64 tensors of
# little-endian 32-bit limbs; primes are < 2**31.  These follow the limb
# kernels' arithmetic, not full-precision math: the mask is taken on the
# input limbs (an all-zero row is divisible by every prime > 1), each
# dividing prime is divided out once by short division (a non-squarefree
# input keeps its repeated factor), and the gcd is the product of the
# common pool primes truncated to L limbs (``math.gcd`` only under the
# registry invariant).  Every intermediate fits int64: r * 2**32 + limb <
# p * 2**32 <= 2**63.

LIMB_BITS = 32
_LIMB_MASK = (1 << LIMB_BITS) - 1


def divisibility_mask_limbs_ref(limbs: torch.Tensor,
                                primes: torch.Tensor) -> torch.Tensor:
    """mask[i, j] = primes[j] > 1 and primes[j] divides the composite of
    limb row i, by Horner's rule most-significant limb first.
    limbs: (N, L) int64, primes: (P,) int64 -> (N, P) bool."""
    safe_p = torch.where(primes <= 1, torch.ones_like(primes), primes)[None, :]
    r = torch.zeros((limbs.shape[0], primes.shape[0]), dtype=torch.int64,
                    device=limbs.device)
    for k in reversed(range(limbs.shape[1])):
        r = ((r << LIMB_BITS) + limbs[:, k:k + 1]) % safe_p
    return (r == 0) & (primes > 1)[None, :]


def _hits_in_order(mask: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """Per row, the values of its set mask columns in column order, as an
    (N, H) tensor padded with 1 (H = the most set columns of any row)."""
    counts = mask.sum(dim=1)
    h = int(counts.max()) if counts.numel() else 0
    order = torch.argsort((~mask).to(torch.int8), dim=1, stable=True)[:, :h]
    live = torch.arange(h, device=mask.device)[None, :] < counts[:, None]
    return torch.where(live, values[order], torch.ones_like(order))


def _short_div_rows(limbs: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """floor(limbs / d) per row by short division, most-significant limb
    first; d: (N,) int64 in [1, 2**31)."""
    out = torch.empty_like(limbs)
    carry = torch.zeros_like(d)
    for k in reversed(range(limbs.shape[1])):
        cur = (carry << LIMB_BITS) + limbs[:, k]
        q = cur // d
        out[:, k] = q
        carry = cur - q * d
    return out


def factorize_limbs_ref(limbs: torch.Tensor, primes: torch.Tensor):
    """``(mask (N, P) bool, residual (N, L) int64)``: the limb mask, and
    each row divided once by every prime that divides its input.  Floor
    divisions compose, so the dividing primes are taken one round at a
    time across all rows (round t divides each row by its t-th hit, or
    by 1); an all-zero row stays zero without a walk."""
    mask = divisibility_mask_limbs_ref(limbs, primes)
    residual = limbs.clone()
    rows = torch.nonzero((limbs != 0).any(dim=1)).squeeze(1)
    divisors = _hits_in_order(mask[rows], primes)
    res = residual[rows]
    for t in range(divisors.shape[1]):
        res = _short_div_rows(res, divisors[:, t])
    residual[rows] = res
    return mask, residual


def _mul_small_rows(g: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """(g * m) mod 2**(32 L) per row, in canonical limbs; g: (N, L) limbs
    < 2**32, m: (N,) in [1, 2**31).  Each limb product splits into its
    low word and a carry into the next limb; carries are propagated until
    none is left (the carry out of the top limb is dropped)."""
    t = g * m[:, None]
    g = t & _LIMB_MASK
    carry = t >> LIMB_BITS
    while bool(carry[:, :-1].any()):
        g[:, 1:] += carry[:, :-1]
        carry = g >> LIMB_BITS
        g &= _LIMB_MASK
    return g


def gcd_limbs_ref(a: torch.Tensor, b: torch.Tensor,
                  pool: torch.Tensor) -> torch.Tensor:
    """(N, L) limbs of the product of the pool primes (> 1) that divide
    both a[i] and b[i], truncated to L limbs: gcd(a, b) when both are
    squarefree products of pool primes.  Multiplication mod 2**(32 L)
    commutes, so the common primes are taken one round at a time across
    all rows."""
    common = (divisibility_mask_limbs_ref(a, pool)
              & divisibility_mask_limbs_ref(b, pool))
    g = torch.zeros_like(a)
    g[:, 0] = 1
    factors = _hits_in_order(common, pool)
    for t in range(factors.shape[1]):
        g = _mul_small_rows(g, factors[:, t])
    return g
