"""Trees of tensors, the port's stand-in for ``jax.tree``: what the
optimizers, the train step, the compression and the checkpoint manager
walk.

A tree is a tensor (a leaf), a dict or a
:class:`~repro_torch.models.layers.ParamTree` (children in sorted key
order, as ``jax.tree`` flattens a dict), a ``NamedTuple`` (its fields in
order), or a list, tuple or ``nn.ModuleList`` (in index order).  Two
trees with the same keys flatten in the same order whatever order their
dicts were built in.  A path is the tuple of keys and indices from the
root to a leaf.
"""

from __future__ import annotations

import itertools
from typing import Any, Callable, Iterator, List, Optional, Tuple

import torch
from torch import nn

from repro_torch.models.layers import ParamTree

__all__ = ["children", "leaves", "leaves_with_path", "path_str",
           "tree_map", "zeros_like"]

Path = Tuple[Any, ...]


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def children(tree) -> Optional[List[Tuple[Any, Any]]]:
    """``tree``'s (key, child) pairs in flattening order; ``None`` for a
    leaf."""
    if isinstance(tree, ParamTree):
        return [(k, tree[k]) for k in sorted(tree.keys())]
    if isinstance(tree, dict):
        return [(k, tree[k]) for k in sorted(tree)]
    if _is_namedtuple(tree):
        return list(zip(tree._fields, tree))
    if isinstance(tree, (list, tuple, nn.ModuleList)):
        return list(enumerate(tree))
    return None


def _kids(node, is_leaf: Optional[Callable]):
    """``children(node)``, or ``None`` where ``is_leaf(node)`` stops the
    walk."""
    return None if is_leaf is not None and is_leaf(node) else children(node)


def leaves_with_path(tree, is_leaf: Optional[Callable] = None,
                     prefix: Path = ()) -> Iterator[Tuple[Path, Any]]:
    """(path, leaf) for every leaf of ``tree`` in flattening order;
    ``is_leaf(node)`` true stops the walk at ``node``."""
    kids = _kids(tree, is_leaf)
    if kids is None:
        yield prefix, tree
        return
    for key, child in kids:
        yield from leaves_with_path(child, is_leaf, prefix + (key,))


def leaves(tree, is_leaf: Optional[Callable] = None) -> List[Any]:
    return [leaf for _, leaf in leaves_with_path(tree, is_leaf)]


def path_str(path: Path) -> str:
    """A path as the checkpoint manifest names it: keys and indices
    joined by ``/``."""
    return "/".join(str(p) for p in path)


def tree_map(fn: Callable, tree, *rest, is_leaf: Optional[Callable] = None):
    """``fn`` of each leaf of ``tree`` and the leaves at the same place of
    ``rest`` (trees of the same structure, flattened up to ``tree``'s
    leaves): a dict (from a dict or a ``ParamTree``), a list (from a list
    or an ``nn.ModuleList``), a tuple or the same ``NamedTuple`` around
    the results."""
    flat_rest = [_flatten_up_to(tree, r, is_leaf) for r in rest]
    index = itertools.count()

    def build(node):
        kids = _kids(node, is_leaf)
        if kids is None:
            i = next(index)
            return fn(node, *(fr[i] for fr in flat_rest))
        out = [(k, build(c)) for k, c in kids]
        if isinstance(node, (dict, ParamTree)):
            return dict(out)
        if _is_namedtuple(node):
            return type(node)(*(v for _, v in out))
        if isinstance(node, tuple):
            return tuple(v for _, v in out)
        return [v for _, v in out]

    return build(tree)


def _flatten_up_to(shape_tree, tree, is_leaf) -> List[Any]:
    """``tree``'s subtrees at the places of ``shape_tree``'s leaves."""
    out: List[Any] = []

    def walk(s, t):
        kids = _kids(s, is_leaf)
        if kids is None:
            out.append(t)
            return
        sub = dict(children(t))
        for key, child in kids:
            walk(child, sub[key])

    walk(shape_tree, tree)
    return out


def zeros_like(tree, dtype=torch.float32):
    """A tree of zeros shaped like ``tree``'s leaves, in ``dtype`` on each
    leaf's device."""
    return tree_map(lambda p: torch.zeros(p.shape, dtype=dtype,
                                          device=p.device), tree)
