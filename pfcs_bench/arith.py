"""The yardstick's arithmetic: data-sheet peaks, the least time a piece of
work can take on one H100, and the work of the PFCS kernels and of decode
attention computed from shapes.

Nothing here reads the program: operations and bytes come from the
configuration's sizes and from the shapes the benchmark saw launched.
"""

from __future__ import annotations

from typing import Iterable, Sequence, Tuple

#: NVIDIA H100 SXM data sheet, dense rates without sparsity, at the full
#: 700 W power limit (a card set lower runs slower; its limit is printed
#: beside every share).
BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12
#: 32-bit integer operations outside the tensor cores: 132 SMs x 64 INT32
#: lanes x 1.98 GHz boost (Hopper white paper).  One operation per modulo
#: or Euclid step, a lower bound: Hopper has no integer divide.
INT_OPS_PER_S = 132 * 64 * 1.98e9


def bound_s(n_bytes: float, n_ops: float, ops_per_s: float) -> float:
    """The least time: the larger of the bytes over the memory rate and
    the operations over the compute rate."""
    return max(n_bytes / HBM_BYTES_PER_S, n_ops / ops_per_s)


# --------------------------------------------------------------------------- #
# the PFCS kernels (csrc/divmask.cu, factorize.cu, gcd.cu)                     #
# --------------------------------------------------------------------------- #

def euclid_steps(a: Sequence[int], b: Sequence[int]) -> int:
    """Modulo steps Euclid's algorithm takes on these pairs, the gcd
    kernel's work (``gcd(x, 0) = x`` takes none)."""
    steps = 0
    for x, y in zip(a, b):
        x, y = int(x), int(y)
        while y:
            x, y = y, x % y
            steps += 1
    return steps


def pfcs_kernel_work(name: str, shapes: Tuple[int, ...], elem: int,
                     hits: int = 0, euclid: int = 0) -> Tuple[int, int]:
    """``(bytes, operations)`` one launch must move and do: each input read
    once, each output written once, one operation per modulo test (mask),
    plus one division per hit (factorization), or per Euclid step (gcd).

    ``divisibility_mask``: ``shapes = (N, P)``, reads N + P words, writes an
    N x P byte mask.  ``factorize_squarefree``: the same plus an N-word
    residual and ``hits`` divisions.  ``gcd``: ``shapes = (N,)``, reads two
    N-word inputs and writes one, ``euclid`` steps."""
    if name == "gcd":
        (n,) = shapes
        return 3 * n * elem, euclid
    n, p = shapes
    n_bytes, n_ops = (n + p) * elem + n * p, n * p
    if name == "factorize_squarefree":
        n_bytes += n * elem
        n_ops += hits
    return n_bytes, n_ops


# --------------------------------------------------------------------------- #
# decode attention and the model step                                          #
# --------------------------------------------------------------------------- #

def decode_attention_work(valid_rows: Iterable[int], n_heads: int,
                          n_kv: int, head_dim: int, cache_elem: int,
                          act_elem: int) -> Tuple[float, float]:
    """``(bytes, flops)`` of one-token attention for a batch whose rows see
    ``valid_rows`` cache rows each: the valid K and V rows read once in the
    cache's dtype, q read and the output written once; 2 FLOPs a
    multiply-add for the scores and the mix."""
    n_bytes = flops = 0.0
    rows = 0
    for v in valid_rows:
        n_bytes += 2.0 * v * n_kv * head_dim * cache_elem
        flops += 4.0 * n_heads * head_dim * v
        rows += 1
    n_bytes += 2.0 * rows * n_heads * head_dim * act_elem
    return n_bytes, flops
