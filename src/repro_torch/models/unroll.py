"""scan-or-unroll helper (port of ``repro.models.unroll``).

The reference runs layer stacks and query chunks under ``lax.scan`` and
unrolls them for its cost probes.  The port runs eagerly, so a scan is
always a loop over the leading axis; the helper is kept so that each
scan site of the reference has its counterpart here.  :func:`batch_local`
marks a loop whose batch rows never mix, so that a tracer may run it on
each rank's own rows.
"""

from __future__ import annotations

import contextlib
from typing import Any, Callable, Optional, Sequence

import torch

__all__ = ["scan_or_unroll", "batch_local", "batch_local_by"]


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


#: how :func:`batch_local` runs its computation: ``None`` (directly), or
#: a runner installed by :func:`batch_local_by`
_RUNNER: Optional[Callable] = None


def batch_local(fn: Callable, args: Sequence, batch_dims: Sequence):
    """``fn(*args)``, a computation that never mixes the rows of its batch
    (a recurrence over time): ``batch_dims`` gives each argument's batch
    dim (``None`` for an argument every row shares), and each output's
    batch dim is its first.  Inside :func:`batch_local_by` its runner
    runs it instead, with the same arguments (a tracer's, which runs it on
    each rank's own rows)."""
    if _RUNNER is None:
        return fn(*args)
    return _RUNNER(fn, args, batch_dims)


@contextlib.contextmanager
def batch_local_by(runner: Callable):
    """Within this block :func:`batch_local` calls ``runner(fn, args,
    batch_dims)``."""
    global _RUNNER
    before, _RUNNER = _RUNNER, runner
    try:
        yield
    finally:
        _RUNNER = before
