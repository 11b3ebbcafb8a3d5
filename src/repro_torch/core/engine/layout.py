"""Shared array-state layout conventions and helpers.

Every engine structure is one of two fixed-shape layouts, each with a
leading batch dimension ``B`` (one row per trace; the reference's
``vmap`` written out):

**Slot arrays** (bounded structures: policy lists, cache levels, the
recency shadows).  A structure of capacity ``C`` is a pair/triple of
``(B, C)`` (or ``(B, C+1)`` where a one-slot overflow reserve is needed)
int32 tensors::

    keys : ``EMPTY`` (= -1) marks a free slot
    t    : recency/insertion stamp; stale values in free slots are
           ignored (occupancy is defined by ``keys != EMPTY`` alone)

Free slots are initialized with distinct *negative* stamps so that
"replace the LRU slot" (``argmin`` over stamps) fills empty slots first,
exactly an ``OrderedDict`` that evicts its front.  Real stamps are >= 0
and strictly increase, so ties cannot occur between live entries.

**Per-key arrays** (unbounded structures: the LIRS stack, the PFCS
residency index).  Shape ``(B, K)`` over the traces' key universe; -1
means "not present".

Stamps are int32 *micro-op* counters: each step consumes a fixed number
``M`` of ticks so that multi-insert steps keep the scalar oracle's
within-level ``OrderedDict`` order; ``batch.py`` checks ``length * M <
2**31``.

Reductions resolve ties and the all-masked case to the lowest index, as
``jnp.argmin`` / ``jnp.argmax`` do (``torch.argmin`` returns the first
minimal index as well).  The step functions are pure: they return new
tensors and never write their inputs, so a caller can gate a whole step
with :func:`tree_where`.
"""

from __future__ import annotations

from typing import Dict

import torch

__all__ = ["EMPTY", "I32MAX", "occupied", "count", "masked_argmin",
           "first_empty", "tree_where", "init_stamps", "gather", "put"]

EMPTY = -1                                  # free-slot key sentinel
I32MAX = 2**31 - 1


def occupied(keys: torch.Tensor) -> torch.Tensor:
    """Boolean occupancy mask of a slot array."""
    return keys != EMPTY


def count(keys: torch.Tensor) -> torch.Tensor:
    """(B,) number of live entries of each row (int32)."""
    return occupied(keys).sum(-1, dtype=torch.int32)


def masked_argmin(values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """(B,) index of the smallest ``values[b, i]`` with ``mask[b, i]``;
    ties and the all-masked case resolve to the lowest index."""
    return torch.where(mask, values, I32MAX).argmin(-1)


def first_empty(keys: torch.Tensor) -> torch.Tensor:
    """(B,) index of the first free slot (0 where there is none)."""
    return (keys == EMPTY).to(torch.uint8).argmax(-1)


def init_stamps(batch: int, n: int, device) -> torch.Tensor:
    """(B, n) distinct negative stamps so empties fill in slot order."""
    return torch.arange(-n, 0, dtype=torch.int32,
                        device=device).expand(batch, n).contiguous()


def gather(arr: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(B,) ``arr[b, idx[b]]``."""
    return arr.gather(-1, idx.long()[:, None])[:, 0]


def put(arr: torch.Tensor, idx: torch.Tensor, value, do) -> torch.Tensor:
    """A copy of ``arr`` with ``arr[b, idx[b]] = value[b]`` in the rows
    where ``do[b]``; other rows unchanged."""
    idx = idx.long()[:, None]
    old = arr.gather(-1, idx)[:, 0]
    if isinstance(value, torch.Tensor):
        value = value.to(arr.dtype)
    new = torch.where(do, value, old).to(arr.dtype)
    return arr.scatter(-1, idx, new[:, None])


def tree_where(pred: torch.Tensor, if_true: Dict, if_false: Dict) -> Dict:
    """Leafwise row selection over two state dicts of the same layout
    (``pred`` is (B,) bool; a leaf may be a nested dict or a tuple)."""
    def pick(a, b):
        if isinstance(a, dict):
            return {k: pick(a[k], b[k]) for k in a}
        if isinstance(a, tuple):
            return tuple(pick(x, y) for x, y in zip(a, b))
        p = pred.reshape(pred.shape + (1,) * (a.dim() - 1))
        return torch.where(p, a, b)
    return pick(if_true, if_false)
