"""Logical-axis sharding rules -> a sharding for every tree leaf (port of
``repro.sharding.partition``).

MaxText-style logical partitioning: each parameter / cache / optimizer-
state leaf gets a :class:`PartitionSpec` derived from its path + shape,
with a divisibility fallback (a dim that does not divide the mesh axis is
replicated, with a warning once per distinct fallback — e.g. gemma's
single KV head, xlstm's 4 heads).  A spec is a tuple with one entry per
leading tensor dim (an axis name, a tuple of axis names, or ``None``), as
``jax.sharding.PartitionSpec`` is; :meth:`NamedSharding.placements` turns
it into DTensor placements on a ``DeviceMesh``: one tensor dim over
several mesh axes becomes ``Shard(d)`` on each of those mesh dims, the
major axis first (DTensor shards over mesh dims in order, which is the
row-major split a spec's axis tuple means).

Axis conventions
----------------
  mesh axes : ("pod", "data", "model")  (pod absent on single-pod)
  batch     -> ("pod", "data")          (DP across pods and data axis)
  heads/mlp/experts/vocab -> "model"    (TP / EP)
  d_model / d_ff fsdp dim -> "data"     (weight sharding for >=10B archs,
                                         gathered within a pod — never
                                         across the pod axis)
  long-context KV seq -> ("pod", "data") (sequence parallelism for
                                          batch=1 500k decode)

Two layouts differ from the reference's:

  * the reference stacks a family's layers on a leading axis and gives
    that axis ``None``; the port keeps one tree per layer
    (``models/convert.py``), so a per-layer leaf gets the reference's spec
    minus its leading stack entry — the rules read dims from the end, so
    the same rules give exactly that;
  * the optimizer state: AdamW's ``m`` / ``v`` and SGD-momentum's ``mom``
    are per-layer like the parameters, Adafactor's ``s`` is in the
    reference's stacked layout (``models/convert.py::reference_groups``),
    so its ``vr`` / ``vc`` take the stacked parameters' specs.

The decode cache keeps the reference's stacked layout, and its specs are
the reference's entry for entry.
"""

from __future__ import annotations

import logging
import re
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.training.tree import leaves_with_path, path_str, tree_map

log = logging.getLogger(__name__)

__all__ = ["PartitionSpec", "NamedSharding", "mesh_axis_size", "batch_axes",
           "shard_stack_spec", "param_pspec", "params_shardings",
           "batch_shardings", "cache_shardings", "opt_state_shardings",
           "replicated", "reset_fallback_warnings", "mesh_shape",
           "tree_shardings", "local_bytes", "local_block"]


def _entry(e):
    """An entry as ``jax.sharding.PartitionSpec`` keeps it: a one-axis
    tuple becomes the axis name."""
    if isinstance(e, (tuple, list)):
        e = tuple(e)
        return e[0] if len(e) == 1 else (e if e else None)
    return e


class PartitionSpec(tuple):
    """A tuple of per-dim entries (axis name, tuple of names or ``None``),
    trailing dims replicated."""

    def __new__(cls, *entries):
        return super().__new__(cls, tuple(_entry(e) for e in entries))

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


def mesh_shape(mesh) -> Dict[str, int]:
    """Axis name -> size, for a ``DeviceMesh`` or an :class:`AbstractMesh`
    (``repro_torch.launch.mesh``)."""
    if isinstance(mesh.shape, dict):
        return dict(mesh.shape)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def _axis_names(mesh) -> Tuple[str, ...]:
    names = getattr(mesh, "axis_names", None)
    return tuple(names if names is not None else mesh.mesh_dim_names)


def _axes_of(entry) -> Tuple[str, ...]:
    return () if entry is None else ((entry,) if isinstance(entry, str)
                                     else tuple(entry))


@dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (the counterpart of ``jax.sharding.NamedSharding``)."""

    mesh: Any
    spec: PartitionSpec

    def shard_shape(self, global_shape) -> Tuple[int, ...]:
        """Each rank's local shape of a ``global_shape`` tensor (every
        sharded dim divides its axes, as the rules guarantee)."""
        sizes = mesh_shape(self.mesh)
        out = list(global_shape)
        for d, entry in enumerate(self.spec):
            n = 1
            for a in _axes_of(entry):
                n *= sizes[a]
            if out[d] % n:
                raise ValueError(f"dim {d} of {tuple(global_shape)} does "
                                 f"not divide {entry} (size {n})")
            out[d] //= n
        return tuple(out)

    def placements(self) -> tuple:
        """DTensor placements, one per mesh dim: ``Shard(d)`` on each mesh
        dim that tensor dim ``d``'s entry names, ``Replicate()`` on the
        rest.  An entry's axes must come in mesh order (major first)."""
        from torch.distributed.tensor import Replicate, Shard

        names = _axis_names(self.mesh)
        out = [Replicate() for _ in names]
        for d, entry in enumerate(self.spec):
            idx = [names.index(a) for a in _axes_of(entry)]
            if idx != sorted(idx):
                raise ValueError(f"spec entry {entry} is not in the mesh's "
                                 f"axis order {names}")
            for i in idx:
                if not isinstance(out[i], Replicate):
                    raise ValueError(f"mesh axis {names[i]!r} shards two "
                                     f"dims in {self.spec}")
                out[i] = Shard(d)
        return tuple(out)


def mesh_axis_size(mesh, name: str) -> int:
    return mesh_shape(mesh).get(name, 1)


def batch_axes(mesh) -> Tuple[str, ...]:
    shape = mesh_shape(mesh)
    return tuple(a for a in ("pod", "data") if a in shape)


def shard_stack_spec(mesh) -> PartitionSpec:
    """PartitionSpec for per-shard PFCS state stacks (DESIGN.md §6):
    shards stack on the leading axis, partitioned over EVERY mesh axis
    (one shard per rank)."""
    return P(_axis_names(mesh))


def _axes_total(mesh, axes) -> Tuple[Tuple[str, ...], int]:
    """Normalized axes tuple + the product of their mesh sizes."""
    ax = (axes,) if isinstance(axes, str) else tuple(axes)
    total = 1
    for a in ax:
        total *= mesh_axis_size(mesh, a)
    return ax, total


def _div(dim: int, mesh, axes) -> bool:
    if axes is None:
        return True
    return dim % _axes_total(mesh, axes)[1] == 0


#: (dim, axes, axes-size) triples already reported — each distinct
#: fallback warns exactly ONCE per process, not once per layer/leaf
_WARNED_FALLBACKS: set = set()


def reset_fallback_warnings() -> None:
    """Clear the warn-once dedup state (test isolation hook)."""
    _WARNED_FALLBACKS.clear()


def _maybe(dim: int, mesh, axes):
    """axes if divisible else None (replicate, warning once per distinct
    fallback)."""
    if not axes:
        return None
    ax, total = _axes_total(mesh, axes)
    if dim % total == 0:
        return axes
    key = (int(dim), ax, total)
    if key not in _WARNED_FALLBACKS:
        _WARNED_FALLBACKS.add(key)
        log.warning(
            "sharding fallback: dim %d does not divide mesh axes %s "
            "(size %d); replicating instead", dim, ax, total)
    return None


# --------------------------------------------------------------------------- #
# parameter rules                                                             #
# --------------------------------------------------------------------------- #

_RULES = [
    # (path regex, callable(shape, mesh, fsdp) -> PartitionSpec entries for
    #  the *trailing* (non-stacked) dims). Leading stack dims get None.
    # embeddings: (V, D) — vocab over model, embed over fsdp
    (r"(embed.*table|unembed)$",
     lambda s, m, f: (_maybe(s[-2], m, "model"), _maybe(s[-1], m, f))),
    # attention projections
    (r"attn.*wq$|self_attn.*wq$|cross_attn.*wq$",
     lambda s, m, f: (_maybe(s[-3], m, f), _maybe(s[-2], m, "model"), None)),
    (r"(attn|self_attn|cross_attn).*(wk|wv)$",
     lambda s, m, f: (_maybe(s[-3], m, f),
                      _maybe(s[-2], m, "model"),
                      None if _div(s[-2], m, "model") else _maybe(s[-1], m, "model"))),
    (r"(attn|self_attn|cross_attn).*wo$",
     lambda s, m, f: (_maybe(s[-3], m, "model"), None, _maybe(s[-1], m, f))),
    (r"(bq|bk|bv)$", lambda s, m, f: (_maybe(s[-2], m, "model"), None)),
    # MLA
    (r"attn.*wq_a$", lambda s, m, f: (_maybe(s[-2], m, f), None)),
    (r"attn.*wq_b$", lambda s, m, f: (None, _maybe(s[-2], m, "model"), None)),
    (r"attn.*wkv_a$", lambda s, m, f: (_maybe(s[-2], m, f), None)),
    (r"attn.*(wk_b|wv_b)$",
     lambda s, m, f: (None, _maybe(s[-2], m, "model"), None)),
    # dense FFN
    (r"(ffn|shared).*(w_gate|w_up)$",
     lambda s, m, f: (_maybe(s[-2], m, f), _maybe(s[-1], m, "model"))),
    (r"(ffn|shared).*w_down$",
     lambda s, m, f: (_maybe(s[-2], m, "model"), _maybe(s[-1], m, f))),
    # MoE experts: (E, d, ff) / (E, ff, d)
    (r"moe.*(w_gate|w_up)$",
     lambda s, m, f: (_maybe(s[-3], m, "model"), _maybe(s[-2], m, f), None)),
    (r"moe.*w_down$",
     lambda s, m, f: (_maybe(s[-3], m, "model"), None, _maybe(s[-1], m, f))),
    (r"moe.*router$", lambda s, m, f: (None, _maybe(s[-1], m, "model"))),
    # Mamba2
    (r"mix.*in_proj$",
     lambda s, m, f: (_maybe(s[-2], m, f), _maybe(s[-1], m, "model"))),
    (r"mix.*out_proj$",
     lambda s, m, f: (_maybe(s[-2], m, "model"), _maybe(s[-1], m, f))),
    (r"mix.*conv_w$", lambda s, m, f: (None, _maybe(s[-1], m, "model"))),
    (r"mix.*conv_b$", lambda s, m, f: (_maybe(s[-1], m, "model"),)),
    (r"mix.*(A_log|D|dt_bias)$", lambda s, m, f: (_maybe(s[-1], m, "model"),)),
    (r"mix.*norm.*scale$", lambda s, m, f: (_maybe(s[-1], m, "model"),)),
    # xLSTM mLSTM
    (r"cell.*w_up$",
     lambda s, m, f: (_maybe(s[-2], m, f), _maybe(s[-1], m, "model"))),
    (r"cell.*w_down$",
     lambda s, m, f: (_maybe(s[-2], m, "model"), _maybe(s[-1], m, f))),
    (r"cell.*conv_w$", lambda s, m, f: (None, _maybe(s[-1], m, "model"))),
    (r"cell.*conv_b$", lambda s, m, f: (_maybe(s[-1], m, "model"),)),
    (r"cell.*(wq|wk|wv)$",
     lambda s, m, f: (_maybe(s[-3], m, "model"), None, None)),
    (r"cell.*(w_igate|w_fgate)$",
     lambda s, m, f: (_maybe(s[-2], m, "model"), None)),
    (r"cell.*w_x$", lambda s, m, f: (_maybe(s[-3], m, f), None,
                                     _maybe(s[-1], m, "model"))),
    (r"cell.*w_r$", lambda s, m, f: (None, None, _maybe(s[-1], m, "model"))),
    (r"cell.*w_out$", lambda s, m, f: (_maybe(s[-2], m, f),
                                       _maybe(s[-1], m, "model"))),
    # frontends
    (r"(frontend_proj|vis_proj.*w1)$",
     lambda s, m, f: (None, _maybe(s[-1], m, "model"))),
    (r"vis_proj.*w2$", lambda s, m, f: (_maybe(s[-2], m, "model"), None)),
]


def param_pspec(path: str, shape: Tuple[int, ...], mesh,
                fsdp: Optional[str]) -> PartitionSpec:
    """PartitionSpec for one parameter leaf."""
    for pat, fn in _RULES:
        if re.search(pat, path):
            trailing = fn(shape, mesh, fsdp)
            n_lead = len(shape) - len(trailing)
            if n_lead < 0:  # unstacked variant (e.g. zamba shared blocks)
                trailing = trailing[-len(shape):]
                n_lead = 0
            return P(*([None] * n_lead), *trailing)
    return P()  # replicate (norms, biases, scalars)


def tree_shardings(fn, tree) -> Any:
    """``fn(path_string, leaf)`` for every leaf, in ``tree``'s structure
    (``repro_torch.training.tree.tree_map`` with paths)."""
    paths = iter([path_str(p) for p, _ in leaves_with_path(tree)])
    return tree_map(lambda x: fn(next(paths), x), tree)


def params_shardings(abstract_params, mesh, cfg) -> Any:
    fsdp = "data" if cfg.use_fsdp else None
    dp_only = getattr(cfg, "dp_only", False)
    if dp_only:
        # small-model mode: REPLICATE weights (pure data parallelism);
        # optimizer state is ZeRO-1-sharded over data
        # (opt_state_shardings)
        fsdp = None

    def leaf(path, x):
        ps = param_pspec(path, tuple(x.shape), mesh, fsdp)
        if dp_only:
            ps = P(*[(None if e == "model" else e) for e in ps])
        return NamedSharding(mesh, ps)
    return tree_shardings(leaf, abstract_params)


# --------------------------------------------------------------------------- #
# batch / cache / activations                                                 #
# --------------------------------------------------------------------------- #

def batch_shardings(abstract_batch, mesh, all_axes: bool = False) -> Any:
    """Batch sharded over (pod, data); with ``all_axes`` (dp_only mode)
    over every mesh axis — one sample slice per rank."""
    ba = _axis_names(mesh) if all_axes else batch_axes(mesh)

    def leaf(x):
        if x.ndim >= 1 and _div(x.shape[0], mesh, ba):
            return NamedSharding(mesh, P(ba, *([None] * (x.ndim - 1))))
        return NamedSharding(mesh, P())
    return tree_map(leaf, abstract_batch)


def cache_shardings(abstract_cache, mesh, cfg, seq_shard: bool = False,
                    seq_over_model: bool = False) -> Any:
    """Decode-cache sharding.

    Layout convention: (L, B, S, ...) for kv-like caches, (L, B, ...) for
    recurrent states, plus the per-sequence ``len``.  ``seq_shard=True``
    (batch=1 long-context decode) shards S over the batch axes instead of
    B.  ``seq_over_model=True``: when the KV-head count does not divide
    the model axis, shard the cache *sequence* dim over 'model' instead of
    head_dim (flash-decoding-style split-K).
    """
    ba = batch_axes(mesh)
    kv_like = ("k", "v", "xk", "xv", "latent", "rope")

    def leaf(path_s, x):
        if x.ndim <= 1:
            return NamedSharding(mesh, P())
        spec = [None] * x.ndim
        # dim 0 is the layer stack; dim 1 batch; dim 2 seq (kv caches)
        if x.ndim >= 3 and not seq_shard and _div(x.shape[1], mesh, ba):
            spec[1] = ba
        elif seq_shard and x.ndim >= 3 and path_s.split("/")[-1] in kv_like \
                and _div(x.shape[2], mesh, ba):
            spec[2] = ba
        # last dims: shard heads over model; fall back to seq (opt) or hd
        if x.ndim >= 4 and _div(x.shape[-2], mesh, "model"):
            spec[-2] = "model"       # kv heads
        elif (seq_over_model and x.ndim >= 4 and spec[2] is None
                and path_s.split("/")[-1] in kv_like
                and _div(x.shape[2], mesh, "model")):
            spec[2] = "model"        # split-K decode
        elif _div(x.shape[-1], mesh, "model"):
            spec[-1] = "model"       # head_dim / latent / feature
        return NamedSharding(mesh, P(*spec))

    return tree_shardings(leaf, abstract_cache)


def _stacked_params(abstract_params, cfg):
    """The parameters in the reference's stacked layout (Adafactor's), or
    ``None`` for a tree that is not a model's."""
    from repro_torch.models.convert import reference_layout
    from repro_torch.models.layers import ParamTree

    if not isinstance(abstract_params, ParamTree):
        return None
    return reference_layout(cfg, abstract_params)


def opt_state_shardings(abstract_state, abstract_params, mesh, cfg) -> Any:
    """Optimizer-state sharding derived from the matching parameter spec.

    AdamW m/v and SGD-momentum mom mirror the (per-layer) param shape ->
    same spec.  Adafactor's state is stacked as the reference's: vr drops
    the stacked parameter's last dim, vc its second-to-last -> its spec
    with the matching entry removed.  Scalars replicate.
    """
    fsdp = "data" if cfg.use_fsdp else None
    param_specs: Dict[str, PartitionSpec] = {}
    for tree in (abstract_params, _stacked_params(abstract_params, cfg)):
        for path, x in leaves_with_path(tree) if tree is not None else ():
            ps = path_str(path)
            param_specs.setdefault(ps, param_pspec(ps, tuple(x.shape), mesh,
                                                   fsdp))

    dp_only = getattr(cfg, "dp_only", False)

    def leaf(ps, x):
        if x.ndim == 0:
            return NamedSharding(mesh, P())
        if dp_only:
            # ZeRO-1: shard moments over data on the first divisible dim
            for d in range(x.ndim):
                if _div(x.shape[d], mesh, "data"):
                    spec = [None] * x.ndim
                    spec[d] = "data"
                    return NamedSharding(mesh, P(*spec))
            return NamedSharding(mesh, P())
        # strip optimizer wrappers to find the param path suffix
        core = re.sub(r"^(m|v|mom|s)/", "", ps)
        core = re.sub(r"/(vr|vc|v)$", "", core)
        spec = param_specs.get(core)
        if spec is None:
            return NamedSharding(mesh, P())
        entries = list(spec)
        if ps.endswith("/vr") and len(entries) >= 1:      # param minus last dim
            entries = entries[:-1]
        elif ps.endswith("/vc") and len(entries) >= 2:    # minus 2nd-to-last
            entries = entries[:-2] + entries[-1:]
        return NamedSharding(mesh, P(*entries[: x.ndim]))

    return tree_shardings(leaf, abstract_state)


def replicated(mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def local_bytes(abstract_tree, shardings) -> int:
    """The bytes one rank holds of ``abstract_tree`` placed by
    ``shardings`` (a tree of :class:`NamedSharding` of the same
    structure): each leaf's local shard shape times its element size."""
    total = 0
    for (_, x), (_, sh) in zip(leaves_with_path(abstract_tree),
                               leaves_with_path(shardings,
                                                is_leaf=_is_sharding)):
        n = 1
        for d in sh.shard_shape(tuple(x.shape)):
            n *= d
        total += n * x.element_size()
    return total


def local_block(sharding: NamedSharding, global_shape) -> Tuple[slice, ...]:
    """The slices of a ``global_shape`` array that this rank holds under
    ``sharding`` (its coordinate on a ``DeviceMesh``; a tensor dim over
    several axes is split row-major, the first axis major)."""
    coord = sharding.mesh.get_coordinate()
    if coord is None:
        raise ValueError("this rank is not in the sharding's mesh")
    at = dict(zip(_axis_names(sharding.mesh), coord))
    sizes = mesh_shape(sharding.mesh)
    local = sharding.shard_shape(tuple(global_shape))
    out = []
    for d, n in enumerate(global_shape):
        idx = 0
        entry = sharding.spec[d] if d < len(sharding.spec) else None
        for a in _axes_of(entry):
            idx = idx * sizes[a] + at[a]
        out.append(slice(idx * local[d], (idx + 1) * local[d]))
    return tuple(out)


def _is_sharding(x) -> bool:
    return isinstance(x, NamedSharding)

