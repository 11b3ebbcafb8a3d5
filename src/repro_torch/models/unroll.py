"""scan-or-unroll helper (port of ``repro.models.unroll``).

The reference runs layer stacks and query chunks under ``lax.scan`` and
unrolls them for its cost probes.  The port runs eagerly, so a scan is
always a loop over the leading axis; the helper is kept so that each
scan site of the reference has its counterpart here.
"""

from __future__ import annotations

from typing import Any, Callable, Sequence

import torch

__all__ = ["scan_or_unroll"]


def scan_or_unroll(body: Callable, carry: Any, xs: Sequence,
                   unroll: bool = False):
    """``jax.lax.scan(body, carry, xs)`` as a Python loop: ``xs`` is a
    tuple of tensors (or sequences) sharing their leading length, or one
    of them; the ``y`` outputs are stacked along a new leading axis
    (``None`` when the body returns none).  ``unroll`` has no effect."""
    del unroll
    seqs = xs if isinstance(xs, tuple) else (xs,)
    length = len(seqs[0])
    ys = []
    for i in range(length):
        x_i = tuple(s[i] for s in seqs)
        carry, y = body(carry, x_i if isinstance(xs, tuple) else x_i[0])
        ys.append(y)
    if not ys or ys[0] is None:
        return carry, None
    if isinstance(ys[0], tuple):
        return carry, tuple(torch.stack(parts, 0) for parts in zip(*ys))
    return carry, torch.stack(ys, 0)
