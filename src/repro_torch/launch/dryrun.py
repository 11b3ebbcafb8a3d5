"""Multi-pod dry-run: trace every (arch x shape x mesh) cell's step on
the production mesh (port of ``repro.launch.dryrun``).

The reference forces 512 XLA host devices, lowers and compiles each
cell, and reads XLA's memory and cost analyses and the compiled HLO.
The port has no compiler to ask, so for each cell this driver:

  1. starts a FAKE process group (``torch.testing._internal.distributed.
     fake_pg``: a store and a backend that move no data) of 256 ranks
     for the 16x16 mesh or 512 for 2x16x16, in this process — it must
     never be the default group of a process that does real work, so run
     it as ``python -m repro_torch.launch.dryrun`` (a process of its own);
  2. builds the model and its shape-only inputs (``"meta"`` tensors: no
     allocation) and places every parameter, optimizer-state, batch and
     cache leaf as a ``DTensor`` whose local shard is a ``"meta"`` tensor
     of the shape :mod:`repro_torch.sharding.partition` gives one rank —
     built from the local shard (``DTensor.from_local``), so placing the
     state issues no collective;
  3. runs the right step (``make_train_step``'s train step, ``prefill``
     or ``decode_step``) once on those DTensors, under a census that sees
     each rank's local ops (DTensor desugars every op into local ops and
     collectives first): ``flops`` by ``torch.utils.flop_counter``'s
     formulas on the local ops, ``bytes_accessed`` as the bytes every
     local op reads and writes, the temporaries as the peak of the
     local storages alive less the arguments, and ``collectives`` as
     ``{kind: {count, bytes}}``
     (each functional collective's result bytes, the reference's
     measure);  pending reductions (``Partial`` outputs) are resolved at
     the end, so they are counted;
  4. writes one JSON artifact per cell under ``artifacts/dryrun/``, named
     as the reference names it with ``__torch`` before ``.json`` (the two
     packages' artifacts never collide); the run is resumable (an ``ok``
     artifact is skipped unless ``--force``).

``memory.argument_size_in_bytes`` is exact: each leaf's local shard
bytes, from the specs' arithmetic.  ``lower_s`` is the seconds to build
and place the state, ``compile_s`` the seconds of the traced step;
``hlo_bytes`` is ``null`` (there is no HLO) and ``ops`` counts the local
ops traced.

Where DTensor's own rules stop, :class:`SpmdRules` supplies explicit ones
(each a redistribution DTensor would otherwise refuse, or a computation
of its own, and each counted in the artifact's ``rules``, ``{name:
count}``): a pending ``Partial`` sum is reduced before an op reads it
(``reduce``); a normalisation or softmax reads its reduced dims whole
(``norm``, ``softmax``); a reshape gathers a sharded dim it splits or
merges unless that dim leads its group and the group's leading result dim
splits as evenly, so the backward's inverse reshape splits too
(``reshape``); a two-operand einsum runs on each rank's local shards, the
operands first given compatible placements and the output placed by its
letters, a summed-away shard left pending (``einsum``: no fold of a
DTensor, which torch 2.11 refuses where the sharded dim does not lead); an
``x @ w`` of a 3-D ``x`` folds its leading dims by the reshape rule
(``matmul``), and ``repeat_interleave`` merges its repeats by it
(``repeat``); the decode cache's per-sequence row write (the reference's
``vmap(dynamic_update_slice)``) writes each rank's own rows, also where
the sequence is split over ranks (``row_write``); the MoE dispatch's
``bincount`` counts its replicated ids into a fixed number of bins
(``bincount``); a plain tensor written from DTensors takes their values
whole (``whole``); an embedding lookup looks up each rank's own ids in
a table gathered where it is split by rows (``lookup``).
:func:`register_rules` adds sharding rules for ``aten.polar`` and
``aten.view_as_real`` (RoPE's complex rotation) and, where the torch at
hand has none, ``aten.flip`` (a backward op), each counted where it
runs.  A layer's recompute in the
backward pass (``remat``) runs under the same rules (``recompute``), and a
loop that never mixes its batch rows (``models.unroll.batch_local``: the
sLSTM recurrence) runs on each rank's own rows as plain tensors, its
inputs gathered whole on the other mesh dims once (``batch_local``): each
step then costs plain ops, not DTensor dispatches, and the census counts
every one of them.  An op with no sharding rule at all raises in DTensor,
and the cell records ``status: "error"`` with the op's name: nothing is
replicated in silence.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma-2b \\
        --shape train_4k --mesh single
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both \\
        --jobs 8 --cell-timeout 600      # each cell in a process of its own
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --layers 1 \\
        --jobs 8                         # every cell at one layer: cheap

``run_cell(..., smoke=True, mesh_shape=(4, 4))`` traces an arch's smoke
config on a small fake mesh (the tests' cells).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import re
import sys
import time
import traceback
import weakref
from collections import Counter
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import (implicit_replication,
                                                   register_sharding)
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves, tree_map
from torch.utils.flop_counter import flop_registry
from torch.utils.weak import WeakIdKeyDictionary

ARTIFACT_DIR = Path(__file__).resolve().parents[3] / "artifacts" / "dryrun"

#: what the port's artifact names end with before ``.json``
ARTIFACT_SUFFIX = "__torch"

#: functional collectives -> the reference's collective kinds
COLLECTIVE_KINDS = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}
#: functional-collective ops that move nothing themselves
_NOT_COLLECTIVES = {"wait_tensor", "_wrap_tensor_autograd"}


# --------------------------------------------------------------------------- #
# cell configuration (the reference's, unchanged)                             #
# --------------------------------------------------------------------------- #

def probe_layer_counts(cfg):
    """Two reduced layer counts (L1 < L2) whose cost delta isolates one
    'layer period':
    total(L) = cost(L1) + (cost(L2) - cost(L1)) / (L2 - L1) * (L - L1).
    Periods: dense=1 layer; moe=1 moe layer (after the dense prefix);
    zamba=one shared_attn_every group; xlstm=one (slstm_every) run;
    encdec=1 enc + 1 dec layer."""
    if cfg.family == "hybrid":
        k = cfg.shared_attn_every
        return k, 2 * k
    if cfg.family == "ssm":
        k = cfg.xlstm.slstm_every
        return k, 2 * k
    if cfg.moe is not None:
        nd = cfg.moe.first_dense_layers
        return nd + 1, nd + 2
    return 1, 2


def override_layers(cfg, n: int):
    if cfg.family == "audio":
        return cfg.replace(encdec=type(cfg.encdec)(n_encoder_layers=n,
                                                   n_decoder_layers=n))
    return cfg.replace(n_layers=n)


def opt_overrides(cfg, shape_kind: str):
    """The optimized-variant settings (A/B'd against the baseline):
      * gather-combine MoE + d-sharded dispatch and 8x microbatch
        accumulation for the giant-MoE trains;
      * head padding to the TP degree for archs whose head counts do not
        divide the 16-way model axis (phi3: 40H/10KV -> 48/16);
      * int8 latent KV cache for MLA decode;
      * pure data parallelism + ZeRO-1 for the small ssm / audio models.
    The split-K decode-cache sharding lives in cache_shardings
    (seq_over_model=True)."""
    kw = {}
    if cfg.moe is not None:
        kw.update(moe_combine="gather", shard_moe_dispatch=cfg.use_fsdp)
        if shape_kind == "train" and cfg.use_fsdp:
            kw.update(accum_steps=8)
    if cfg.mla is None and cfg.n_heads % 16:
        h_pad = -(-cfg.n_heads // 16) * 16      # next multiple of TP degree
        kv = cfg.n_kv_heads
        kv_pad = (kv if kv <= 1 else
                  next(d for d in range(kv, h_pad + 1) if h_pad % d == 0))
        kw.update(n_heads=h_pad, n_kv_heads=kv_pad)
    if cfg.mla is not None and shape_kind == "decode":
        kw.update(kv_cache_dtype="int8")
    if cfg.family in ("ssm", "audio") and shape_kind in ("train", "prefill"):
        kw.update(dp_only=True)   # <3B models: pure DP + ZeRO-1 beats forced TP
    return cfg.replace(**kw) if kw else cfg


# --------------------------------------------------------------------------- #
# the fake group and the mesh                                                 #
# --------------------------------------------------------------------------- #

def start_fake_group(world: int) -> None:
    """Make a fake process group of ``world`` ranks (this process is rank
    0) the default group, replacing an earlier fake one; refuses a
    process whose default group is a real one."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError("the dry-run's fake process group would "
                               "replace a real default group; run it in a "
                               "process of its own")
        if dist.get_world_size() == world:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def cell_mesh(multi_pod: bool, mesh_shape: Optional[Tuple[int, ...]] = None):
    """The production mesh (16x16, or 2x16x16 with ``multi_pod``) or a
    ``mesh_shape`` one with the same axis names, over a fake group of its
    size."""
    from repro_torch.launch.mesh import make_mesh, make_production_mesh

    if mesh_shape is None:
        start_fake_group(512 if multi_pod else 256)
        return make_production_mesh(multi_pod=multi_pod)
    axes = ("pod", "data", "model")[-len(mesh_shape):]
    n = 1
    for s in mesh_shape:
        n *= s
    start_fake_group(n)
    return make_mesh(mesh_shape, axes)


def mesh_name(multi_pod: bool, mesh_shape=None) -> str:
    if mesh_shape is not None:
        return "fake_" + "x".join(str(s) for s in mesh_shape)
    return "multipod_2x16x16" if multi_pod else "pod_16x16"


# --------------------------------------------------------------------------- #
# explicit SPMD rules where DTensor's stop                                    #
# --------------------------------------------------------------------------- #

#: how often each explicit rule fired in the step being traced (a cell
#: artifact's ``rules``): a redistribution DTensor would otherwise refuse
#: or make unasked, or a computation of the rule's own
RULES: Counter = Counter()

#: the aten ops :func:`register_rules` gave a sharding rule, by rule name
_ATEN_RULES: Dict[Any, str] = {}


def _has_strategy(op) -> bool:
    """Whether this torch's DTensor has a sharding strategy for ``op``."""
    sp = DTensor._op_dispatcher.sharding_propagator
    return any(op in getattr(sp, table, {}) for table in (
        "op_strategy_funcs", "op_to_rules", "op_single_dim_strategy_funcs"))


def register_rules() -> None:
    """Sharding rules for aten ops DTensor has none for: the complex-number
    ops RoPE uses (``aten.polar``: two same-shape inputs;
    ``aten.view_as_real``: a trailing dim of 2 added) and, where this torch
    lacks one (2.11), ``aten.flip`` (``cumsum``'s backward), which keeps a
    shard on a dim it does not flip and passes a pending sum through.  The
    census counts each use (``RULES``)."""
    if _ATEN_RULES:
        return
    aten = torch.ops.aten

    @register_sharding(aten.polar.default)
    def _polar(abs_, angle):
        return [([Replicate()], [Replicate(), Replicate()])] + [
            ([Shard(d)], [Shard(d), Shard(d)]) for d in range(abs_.ndim)]

    @register_sharding(aten.view_as_real.default)
    def _view_as_real(x):
        return [([Replicate()], [Replicate()])] + [
            ([Shard(d)], [Shard(d)]) for d in range(x.ndim)]

    _ATEN_RULES.update({aten.polar.default: "polar",
                        aten.view_as_real.default: "view_as_real"})
    if not _has_strategy(aten.flip.default):
        @register_sharding(aten.flip.default)
        def _flip(x, dims):
            flipped = {d % x.ndim for d in dims}
            return [([Replicate()], [Replicate(), None]),
                    ([Partial()], [Partial(), None])] + [
                ([Shard(d)], [Shard(d), None]) for d in range(x.ndim)
                if d not in flipped]
        _ATEN_RULES[aten.flip.default] = "flip"


def _shard_dim(p, ndim: int) -> Optional[int]:
    return p.dim % ndim if isinstance(p, Shard) else None


def _redistributed(x, keep, rule: Optional[str] = None) -> Any:
    """``x`` with every mesh dim where ``keep(placement)`` is false made
    ``Replicate()`` (a no-op when none is; counted under ``rule``, if one
    is named, when not)."""
    pl = [p if keep(p) else Replicate() for p in x.placements]
    if pl == list(x.placements):
        return x
    if rule is not None:
        RULES[rule] += 1
    return x.redistribute(x.device_mesh, pl)


def _reduced(x):
    """A DTensor's pending ``Partial`` reductions resolved."""
    if not isinstance(x, DTensor):
        return x
    return _redistributed(x, lambda p: not p.is_partial(), "reduce")


def _whole_dims(x, dims, rule: str) -> Any:
    """``x`` with the tensor dims ``dims`` unsharded (and no Partial)."""
    return _redistributed(x, lambda p: not p.is_partial()
                          and _shard_dim(p, x.ndim) not in dims, rule)


def _row_write(cache, key, value) -> None:
    """``cache[(batch_index, rows)] = value``: each sequence's row written
    in place (``models/mla.py::_write_row``).  ``batch_index`` enumerates
    the batch, so each rank writes its own batch slice's rows on its
    local shard.  Where the cache is sharded on its row dim (a sequence
    split over ranks), every rank sees each row and value and writes the
    rows that fall in its block (the others it rewrites unchanged, as a
    ``dynamic_update_slice`` on a sharded dim selects)."""
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset

    RULES["row_write"] += 1
    _, rows = key
    mesh, n = cache.device_mesh, cache.ndim
    vpl, rpl = [], []
    for p in cache.placements:
        d = _shard_dim(p, n)
        vpl.append(Replicate() if d in (None, 1) else
                   Shard(0 if d == 0 else d - 1))
        rpl.append(Shard(0) if d == 0 else Replicate())
    value, rows = (_on_mesh(t, mesh) for t in (value, rows))
    v = value.to(cache.dtype).redistribute(mesh, vpl).to_local()
    r = rows.redistribute(mesh, rpl).to_local()
    local = cache.to_local()
    b = torch.arange(local.shape[0], device=local.device)
    if any(_shard_dim(p, n) == 1 for p in cache.placements):
        _, offset = compute_local_shape_and_global_offset(
            cache.shape, mesh, cache.placements)
        r = r - offset[1]
        mine = (r >= 0) & (r < local.shape[1])
        r = r.clamp(0, local.shape[1] - 1)
        v = torch.where(mine.reshape((-1,) + (1,) * (v.ndim - 1)), v,
                        local[b, r])
    local[b, r] = v


def _on_mesh(t, mesh):
    """``t`` as a DTensor on ``mesh``: a plain tensor replicated."""
    if isinstance(t, DTensor):
        return t
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def _from_local(local, mesh, placements, shape):
    """A DTensor of global ``shape`` from each rank's ``local`` shard,
    its global strides in the local tensor's order of dims (a permuted
    local view stays a permuted global one; a broadcast one is made
    whole)."""
    if any(st == 0 and n > 1 for st, n in zip(local.stride(), local.shape)):
        local = local.contiguous()
    stride, acc = [0] * local.ndim, 1
    for d in sorted(range(local.ndim), key=lambda d: (local.stride(d), -d)):
        stride[d] = acc
        acc *= shape[d]
    return DTensor.from_local(local, mesh, placements, run_check=False,
                              shape=tuple(shape), stride=tuple(stride))


def _bincount(x, weights=None, minlength=0):
    """``torch.bincount(x, weights, minlength)`` of ids that all lie below
    ``minlength`` (the MoE dispatch's per-expert counts): ``x`` (and
    ``weights``) replicated, then the counts as a scatter-add into
    ``minlength`` bins on every rank.  (DTensor has no rule for it: its
    output length depends on the values, which the dry-run's tensors do
    not hold.)"""
    RULES["bincount"] += 1
    mesh = x.device_mesh
    ids = _redistributed(x, lambda p: False).to_local()
    w = (torch.ones_like(ids) if weights is None else
         _redistributed(weights, lambda p: False).to_local())
    counts = torch.zeros(minlength, dtype=w.dtype, device=ids.device)
    counts.index_add_(0, ids, w)
    return DTensor.from_local(counts, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def _reshape_groups(src, dst):
    """The dims of ``src`` and ``dst`` (shapes of equal numel) in the
    groups a reshape maps onto each other: ``[(src dims, dst dims)]``."""
    groups, i, j = [], 0, 0
    while i < len(src) or j < len(dst):
        si, dj, ps, pd = [], [], 1, 1
        if i < len(src):
            ps *= src[i]
            si.append(i)
            i += 1
        if j < len(dst):
            pd *= dst[j]
            dj.append(j)
            j += 1
        while ps != pd:
            if ps < pd:
                ps *= src[i]
                si.append(i)
                i += 1
            else:
                pd *= dst[j]
                dj.append(j)
                j += 1
        groups.append((si, dj))
    return groups


def _reshapeable(x, shape):
    """``x`` with each mesh dim that shards a dim a reshape to ``shape``
    cannot carry evenly, both ways, gathered: a sharded dim is kept where
    it leads its group (its first dim larger than 1), it divides by its
    ranks (DTensor also shards unevenly) and so does the group's leading
    output dim, so the reshape and the backward's inverse one both split
    evenly."""
    src = tuple(x.shape)
    dst = list(shape)
    if -1 in dst:
        known = 1
        for s in dst:
            known *= s if s != -1 else 1
        dst[dst.index(-1)] = x.numel() // known
    lead = {}                   # src dim -> (it leads its group, dst lead)
    for si, dj in _reshape_groups(src, tuple(dst)):
        lead_s = next((d for d in si if src[d] > 1), None)
        lead_d = next((d for d in dj if dst[d] > 1), None)
        for d in si:
            lead[d] = (d == lead_s, lead_d)
    ranks: Dict[int, int] = {}
    for i, p in enumerate(x.placements):
        d = _shard_dim(p, x.ndim)
        if d is not None:
            ranks[d] = ranks.get(d, 1) * x.device_mesh.shape[i]

    def keep(p):
        d = _shard_dim(p, x.ndim)
        if d is None:
            return True
        leads, lead_d = lead[d]
        return (leads and lead_d is not None and src[d] % ranks[d] == 0
                and dst[lead_d] % ranks[d] == 0)
    return _redistributed(x, keep, "reshape")


class _RuleReshape(torch.autograd.Function):
    """A reshape whose backward's inverse reshape follows the same rule
    (the gradient may arrive sharded otherwise)."""

    @staticmethod
    def forward(ctx, x, shape):
        ctx.src = tuple(x.shape)
        return _reshapeable(x, shape).reshape(shape)

    @staticmethod
    def backward(ctx, g):
        return _reshapeable(g, ctx.src).reshape(ctx.src), None


def _rule_reshape(x, shape):
    """``x.reshape(shape)`` under the reshape rule, both ways."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _RuleReshape.apply(x, tuple(shape))
    return _reshapeable(x, tuple(shape)).reshape(shape)


def _matmul(x, w):
    """``x @ w`` for an ``x`` of three or more dims and a 2-D ``w``: the
    leading dims of ``x`` folded by the reshape rule (``matmul`` folds
    them below it, where torch 2.11's DTensor refuses a sharded dim that
    does not lead), a 2-D product, and the fold undone by the rule."""
    RULES["matmul"] += 1
    lead = tuple(x.shape[:-1])
    y = _rule_reshape(x, (math.prod(lead), x.shape[-1])) @ w
    return _rule_reshape(y, lead + (w.shape[-1],))


class _Lookup(torch.autograd.Function):
    """``table[ids]`` of placements :func:`_lookup` made compatible: each
    rank looks its own ids up in its local table (its rows whole, its
    columns perhaps split), and the rows' gradient is a local scatter-add,
    pending a sum over the mesh dims that split the ids."""

    @staticmethod
    def forward(ctx, table, ids):
        local_ids = ids.to_local().long()
        ctx.save_for_backward(local_ids)
        ctx.table = (tuple(table.to_local().shape), table.shape, table.dtype)
        ctx.pl = [Shard(ids.ndim) if p == Shard(1) else q
                  for p, q in zip(table.placements, ids.placements)]
        ctx.grad_pl = [p if p == Shard(1) else
                       Replicate() if q == Replicate() else Partial()
                       for p, q in zip(table.placements, ids.placements)]
        rows = table.to_local()[local_ids]
        return _from_local(rows, table.device_mesh, ctx.pl,
                           tuple(ids.shape) + tuple(table.shape[1:]))

    @staticmethod
    def backward(ctx, g):
        (local_ids,) = ctx.saved_tensors
        local_shape, shape, dtype = ctx.table
        mesh = g.device_mesh
        g = g.redistribute(mesh, ctx.pl).to_local()
        grad = torch.zeros(local_shape, dtype=dtype, device=g.device)
        grad.index_put_((local_ids,), g.to(dtype), accumulate=True)
        return _from_local(grad, mesh, ctx.grad_pl, shape), None


def _lookup(table, ids):
    """``table[ids]`` (an embedding lookup), each rank looking up its own
    ids (torch 2.11's DTensor has no strategy for ids split over two mesh
    dims, and its backward's ``index_put`` refuses a sharded table): on a
    mesh dim that splits the table's columns and not the ids, the output's
    last dim is split the same way; the table is gathered where it is
    split by rows (as torch 2.11's DTensor gathers it) or where the ids
    are split too (the batch kept split, the weights gathered)."""
    RULES["lookup"] += 1
    mesh = table.device_mesh
    ids = _reduced(_on_mesh(ids, mesh))
    keep = [p if type(p) is Shard else Replicate() for p in ids.placements]
    if keep != list(ids.placements):
        ids = ids.redistribute(mesh, keep)
    whole = [p if p == Shard(1) and q == Replicate() else Replicate()
             for p, q in zip(table.placements, ids.placements)]
    if whole != list(table.placements):
        table = table.redistribute(mesh, whole)
    return _Lookup.apply(table, ids)


def _repeat_interleave(x, repeats, dim=None, *, output_size=None):
    """``x.repeat_interleave(repeats, dim)`` for an int ``repeats``: each
    slice along ``dim`` broadcast ``repeats`` times on a new dim after it,
    and the two dims merged by the reshape rule (``repeat_interleave``
    merges them below it, where the backward's split of a sharded merged
    dim is refused when the split does not divide), or ``None``."""
    if not isinstance(repeats, int) or dim is None:
        return None
    RULES["repeat"] += 1
    d = dim % x.ndim
    shape = list(x.shape)
    y = x.unsqueeze(d + 1).expand(*shape[:d + 1], repeats, *shape[d + 1:])
    shape[d] *= repeats
    return _rule_reshape(y, tuple(shape))


def _einsum_terms(eq: str, a, b):
    """``eq``'s operand and output subscripts when it is a two-operand
    einsum of letters the rule handles (no ellipsis, no repeated letter,
    every shared letter the same size on both sides), else ``None``."""
    if "->" not in eq or "." in eq:
        return None
    lhs, out = eq.replace(" ", "").split("->")
    terms = lhs.split(",")
    if len(terms) != 2:
        return None
    sa, sb = terms
    if any(len(set(t)) != len(t) for t in (sa, sb, out)):
        return None
    if len(sa) != a.ndim or len(sb) != b.ndim:
        return None
    if any(a.shape[sa.index(c)] != b.shape[sb.index(c)]
           for c in set(sa) & set(sb)):
        return None
    return sa, sb, out


def _letter(p, sub: str) -> Optional[str]:
    d = _shard_dim(p, len(sub)) if type(p) is Shard else None
    return sub[d] if d is not None else None


def _einsum_placements(sa, sb, so, a, b):
    """The placements both operands take for a local einsum, and its
    output's: on each mesh dim an operand sharded on a letter the other
    also has makes the other shard it too (a local slice), two operands
    sharded on different letters leave the smaller one whole there; then
    a letter of the output sharded stays a shard of the output, a letter
    summed away leaves a pending sum."""
    pa, pb, po = [], [], []
    small_a = a.numel() <= b.numel()
    for p, q in zip(a.placements, b.placements):
        la, lb = _letter(p, sa), _letter(q, sb)
        if p != Replicate() and la is None:        # a strided shard
            p, la = Replicate(), None
        if q != Replicate() and lb is None:
            q, lb = Replicate(), None
        if la is not None and lb is not None and la != lb:
            if small_a:
                p, la = Replicate(), None
            else:
                q, lb = Replicate(), None
        if la is None and lb is not None and lb in sa:
            p, la = Shard(sa.index(lb)), lb
        elif lb is None and la is not None and la in sb:
            q, lb = Shard(sb.index(la)), la
        c = la if la is not None else lb
        pa.append(p)
        pb.append(q)
        po.append(Replicate() if c is None else
                  Shard(so.index(c)) if c in so else Partial())
    return pa, pb, po


def _einsum_grad(s_out: str, s_other: str, s_want: str, g, other, shape):
    """The gradient of an einsum operand of subscripts ``s_want`` and
    (local) ``shape`` from the output's gradient ``g`` and the other
    operand: letters of the operand alone were summed away, so their
    gradient is broadcast back."""
    keep = "".join(c for c in s_want if c in s_out or c in s_other)
    grad = torch.einsum(f"{s_out},{s_other}->{keep}", g, other.to(g.dtype))
    for i, c in enumerate(s_want):
        if c not in keep:
            grad = grad.unsqueeze(i)
    return grad.expand(shape)


class _LocalEinsum(torch.autograd.Function):
    """A two-operand einsum of placements :func:`_einsum_placements` made
    compatible, computed on each rank's local shards (no fold of a DTensor,
    so no refused flatten), its output and gradients placed by the same
    letters."""

    @staticmethod
    def forward(ctx, terms, a, b, po):
        sa, sb, so = terms
        ctx.terms, ctx.po = terms, po
        ctx.save_for_backward(a, b)
        size = {c: n for t, x in ((sa, a), (sb, b))
                for c, n in zip(t, x.shape)}
        out = torch.einsum(f"{sa},{sb}->{so}", a.to_local(), b.to_local())
        return _from_local(out, a.device_mesh, po,
                           tuple(size[c] for c in so))

    @staticmethod
    def backward(ctx, g):
        sa, sb, so = ctx.terms
        a, b = ctx.saved_tensors
        mesh = a.device_mesh
        g = _on_mesh(g, mesh).redistribute(
            mesh, [Replicate() if p.is_partial() else p for p in ctx.po])
        gl = g.to_local()
        grads = []
        for x, s, other, s_other, need in (
                (a, sa, b, sb, ctx.needs_input_grad[1]),
                (b, sb, a, sa, ctx.needs_input_grad[2])):
            if not need:
                grads.append(None)
                continue
            local = _einsum_grad(so, s_other, s, gl, other.to_local(),
                                 x.to_local().shape).to(x.dtype)
            pl = [p if p != Replicate() else
                  Partial() if q != Replicate() else p
                  for p, q in zip(x.placements, other.placements)]
            grads.append(_from_local(local, mesh, pl, x.shape))
        return None, grads[0], grads[1], None


def _einsum(eq, *operands):
    """``torch.einsum(eq, a, b)`` on local shards (:class:`_LocalEinsum`),
    or ``None`` for an einsum the rule does not handle."""
    if len(operands) != 2:
        return None
    a, b = (_reduced(t) for t in operands)
    mesh = next(t.device_mesh for t in (a, b) if isinstance(t, DTensor))
    a, b = _on_mesh(a, mesh), _on_mesh(b, mesh)
    terms = _einsum_terms(eq, a, b)
    if terms is None or a.dtype != b.dtype:
        return None
    RULES["einsum"] += 1
    pa, pb, po = _einsum_placements(*terms, a, b)
    if pa != list(a.placements):
        a = a.redistribute(mesh, pa)
    if pb != list(b.placements):
        b = b.redistribute(mesh, pb)
    return _LocalEinsum.apply(terms, a, b, po)


_NORMS = {torch.rms_norm, F.rms_norm, torch.layer_norm, F.layer_norm}
_SOFTMAXES = {torch.softmax, torch.Tensor.softmax, F.softmax,
              torch.log_softmax, torch.Tensor.log_softmax, F.log_softmax}
_RESHAPES = {torch.reshape, torch.Tensor.reshape, torch.Tensor.view}
_BINCOUNTS = {torch.bincount, torch.Tensor.bincount}
_MATMULS = {torch.matmul, torch.Tensor.matmul, torch.Tensor.__matmul__}
_REPEATS = {torch.repeat_interleave, torch.Tensor.repeat_interleave}


def _writes_first(func) -> bool:
    """Whether ``func`` writes into its first argument in place."""
    name = getattr(func, "__name__", "")
    return name == "__setitem__" or (name.endswith("_")
                                     and not name.startswith("_"))


class _Whole(torch.autograd.Function):
    """A replicated DTensor's local tensor, whose gradient (a DTensor once
    the tensor has met DTensors again) comes back replicated."""

    @staticmethod
    def forward(ctx, x):
        ctx.mesh = x.device_mesh
        return x.to_local()

    @staticmethod
    def backward(ctx, g):
        whole = [Replicate()] * ctx.mesh.ndim
        if isinstance(g, DTensor):
            return g.redistribute(ctx.mesh, whole)
        return DTensor.from_local(g, ctx.mesh, whole, run_check=False)


def _whole(x):
    """A DTensor's value replicated, as the local tensor every rank holds."""
    if not isinstance(x, DTensor):
        return x
    RULES["whole"] += 1
    return _Whole.apply(_redistributed(x, lambda p: False))


class SpmdRules(TorchFunctionMode):
    """The explicit rules of this module's docstring, applied to every
    torch function a traced step calls."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func is torch.einsum and not kwargs and any(
                isinstance(t, DTensor) for t in args[1:]):
            out = _einsum(*args)
            if out is not None:
                return out
        if (func is torch.Tensor.__setitem__ and isinstance(args[0], DTensor)
                and isinstance(args[1], tuple) and len(args[1]) == 2
                and all(isinstance(k, torch.Tensor) for k in args[1])):
            return _row_write(*args)
        args = tree_map(_reduced, args)
        kwargs = tree_map(_reduced, kwargs)
        x = args[0] if args else None
        if not isinstance(x, DTensor):
            if isinstance(x, torch.Tensor) and _writes_first(func):
                # a plain (replicated) tensor written from DTensors: their
                # values gathered whole on every rank
                args, kwargs = tree_map(_whole, (args, kwargs))
            return func(*args, **kwargs)
        rest = args[1:]
        if func in _BINCOUNTS:
            return _bincount(x, *rest, **kwargs)
        if (func is torch.Tensor.__getitem__ and x.ndim == 2 and rest
                and isinstance(rest[0], torch.Tensor)
                and not rest[0].is_floating_point()
                and rest[0].dtype != torch.bool):
            return _lookup(x, rest[0])
        if func in _REPEATS:
            out = _repeat_interleave(x, *rest, **kwargs)
            if out is not None:
                return out
        if (func in _MATMULS and x.ndim >= 3 and rest
                and isinstance(rest[0], torch.Tensor) and rest[0].ndim == 2):
            return _matmul(x, rest[0])
        if func in _NORMS:
            shape = rest[0] if rest else kwargs["normalized_shape"]
            x = _whole_dims(x, set(range(x.ndim - len(shape), x.ndim)),
                            "norm")
        elif func in _SOFTMAXES:
            d = rest[0] if rest else kwargs["dim"]
            x = _whole_dims(x, {d % x.ndim}, "softmax")
        elif func in _RESHAPES:
            shape = rest[0] if len(rest) == 1 and not isinstance(
                rest[0], int) else rest
            if isinstance(shape, torch.dtype):
                return func(x, *rest, **kwargs)
            return _rule_reshape(x, tuple(shape))
        return func(x, *rest, **kwargs)


@contextlib.contextmanager
def _under_rules():
    """The rules and DTensor's implicit replication, as a traced step's
    forward runs under them; a layer's recompute in the backward pass
    enters this (``models.layers.recompute_under``), counted as
    ``recompute``."""
    RULES["recompute"] += 1
    with SpmdRules(), implicit_replication():
        yield


def _batch_local(fn, args, batch_dims, local: bool = True):
    """``models.unroll.batch_local``'s computation (its batch rows never
    mix) run on each rank's own rows: the mesh dims that shard the first
    DTensor argument's batch dim shard every argument's batch dim, and
    every other mesh dim holds every argument whole (gathered once, here,
    not in each step of a loop).  Then ``fn`` runs on the local shards, as
    plain tensors, so a recurrence's steps cost plain ops rather than
    DTensor dispatches (the census still counts each); an argument without
    a batch dim gets back a gradient pending a sum over the batch's mesh
    dims.  ``local=False`` runs ``fn`` on the placed DTensors instead, op
    by op (the census of the two agrees)."""
    RULES["batch_local"] += 1
    lead = next(a for a, d in zip(args, batch_dims)
                if isinstance(a, DTensor) and d is not None)
    mesh = lead.device_mesh
    bd = batch_dims[list(args).index(lead)]
    on_batch = [type(p) is Shard and p.dim % lead.ndim == bd
                for p in _reduced(lead).placements]
    placed, grads = [], []
    for a, d in zip(args, batch_dims):
        a = _reduced(_on_mesh(a, mesh))
        pl = [Shard(d) if d is not None and sharded else Replicate()
              for sharded in on_batch]
        if pl != list(a.placements):
            a = a.redistribute(mesh, pl)
        placed.append(a)
        grads.append([p if d is not None or not sharded else Partial()
                      for p, sharded in zip(pl, on_batch)])
    out_pl = [Shard(0) if sharded else Replicate() for sharded in on_batch]
    if local:
        locals_ = [a.to_local(grad_placements=g)
                   for a, g in zip(placed, grads)]
        with torch._C.DisableTorchFunction():  # plain tensors: no rule applies
            outs = fn(*locals_)
        rows = lead.shape[bd]

        def wrap(o):
            return _from_local(o, mesh, out_pl, (rows,) + tuple(o.shape[1:]))
    else:
        outs = fn(*[_GradAs.apply(a, g) for a, g in zip(placed, grads)])

        def wrap(o):
            return _GradAs.apply(o, out_pl)
    return tuple(map(wrap, outs)) if isinstance(outs, tuple) else wrap(outs)


class _GradAs(torch.autograd.Function):
    """A DTensor as it is, whose gradient is redistributed to
    ``placements`` (what ``to_local(grad_placements=...)`` and
    ``from_local`` give the local run's)."""

    @staticmethod
    def forward(ctx, x, placements):
        ctx.placements = list(placements)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if list(g.placements) != ctx.placements:
            g = g.redistribute(g.device_mesh, ctx.placements)
        return g, None


# --------------------------------------------------------------------------- #
# the census                                                                  #
# --------------------------------------------------------------------------- #

def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def _moved_bytes(tree) -> int:
    """The bytes of ``tree``'s tensors as memory holds them: a dim of
    stride 0 (a broadcast view, ``expand``) is one element wide."""
    total = 0
    for t in tree_leaves(tree):
        if isinstance(t, torch.Tensor) and t.numel():
            n = t.element_size()
            for size, stride in zip(t.shape, t.stride()):
                n *= size if stride else 1
            total += n
    return total


def _propagating() -> bool:
    """Whether DTensor is propagating shapes: it runs each op once on
    fake tensors of the GLOBAL shapes (under a ``FakeTensorMode``, cached
    per op schema) before it runs the local op; that run is no rank's
    work."""
    return torch._C._get_dispatch_mode(
        torch._C._TorchDispatchModeKey.FAKE) is not None


#: local ops that move no bytes: allocations, and a view the schema does
#: not mark as one
_NO_TRAFFIC = {"empty", "empty_strided", "empty_like", "new_empty",
               "new_empty_strided", "_unsafe_view"}
#: in-place writes of some rows of their first argument: they read their
#: indices and values and write the values, not the whole destination
_ROW_WRITES = {"index_put_"}


def _fresh_outputs(func) -> bool:
    """Whether ``func`` returns only new tensors (no view, no write into
    an argument), so that its outputs depend on its inputs' shapes alone
    on "meta"."""
    sch = func._schema
    return (not sch.is_mutable and bool(sch.returns)
            and all(r.alias_info is None and str(r.type) == "Tensor"
                    for r in sch.returns))


def _signature(x):
    """A hashable key of an op argument: a "meta" tensor by its shape,
    strides and dtype, a scalar or a sequence by value; ``None`` for what
    has no such key (a tensor elsewhere, an object)."""
    if isinstance(x, torch.Tensor):
        if x.device.type != "meta" or isinstance(x, DTensor):
            return None
        return ("T", tuple(x.shape), x.stride(), x.dtype)
    if isinstance(x, (list, tuple)):
        keys = tuple(_signature(v) for v in x)
        return None if None in keys else ("L", keys)
    if x is None or isinstance(x, (bool, int, float, str, torch.dtype,
                                   torch.device, torch.memory_format,
                                   torch.layout)):
        return ("V", type(x).__name__, x)
    return None


def _tensors(out) -> List[torch.Tensor]:
    outs = out if isinstance(out, (tuple, list)) else (out,)
    return [t for t in outs if isinstance(t, torch.Tensor)]


class Census(TorchDispatchMode):
    """Per-rank counts of the local ops a traced step runs (it lets
    DTensor desugar every op first, and skips DTensor's shape propagation
    on global shapes): FLOPs by ``torch.utils.flop_counter``'s formulas,
    the bytes each op reads and writes (each input as memory holds it,
    each output once; views and allocations move none; a row write moves
    its rows), the functional collectives' count and result bytes by
    kind, and the peak of the "meta" storages alive (:meth:`track` the
    arguments first).

    An op that returns new tensors runs once for each signature (the op
    and its arguments' shapes, strides, dtypes and scalars): a later call
    of the same signature gets new empty tensors of the first's shapes,
    strides and dtypes, which is all a meta kernel computes, and the
    first's counts (torch's meta kernels run in Python, 0.05-0.7 ms an
    op; a recurrence's steps repeat their signatures)."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes_accessed = 0
        self.ops = 0
        self.collectives: Dict[str, Dict[str, int]] = {}
        self.live = self.peak = 0
        self._held = WeakIdKeyDictionary()
        self._fresh: Dict[Any, bool] = {}
        self._seen: Dict[Any, tuple] = {}

    def track(self, *tensors) -> None:
        """Count ``tensors``' storages as alive (a step's arguments)."""
        for t in tensors:
            if isinstance(t, torch.Tensor) and t.device.type == "meta":
                st = t.untyped_storage()
                if st not in self._held:
                    self._held[st] = True
                    n = st.nbytes()
                    self.live += n
                    self.peak = max(self.peak, self.live)
                    weakref.finalize(st, self._free, n)

    def _free(self, n: int) -> None:
        self.live -= n

    def _price(self, func, args, kwargs, out) -> Tuple[int, int]:
        name = func.__name__.split(".")[0]
        flops = 0
        if func._overloadpacket in flop_registry:
            flops = int(flop_registry[func._overloadpacket](
                *args, **kwargs, out_val=out))
        if name in _ROW_WRITES:
            moved = _moved_bytes((args[1:], kwargs)) + _moved_bytes(args[2])
        elif func.is_view or name in _NO_TRAFFIC:
            moved = 0
        else:
            moved = _moved_bytes((args, kwargs)) + _moved_bytes(out)
        return flops, moved

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            if func in _ATEN_RULES:
                RULES[_ATEN_RULES[func]] += 1
            return NotImplemented
        kwargs = kwargs or {}
        if _propagating():
            return func(*args, **kwargs)
        if func.namespace == "_c10d_functional":
            out = func(*args, **kwargs)
            name = func.__name__.split(".")[0]
            if name not in _NOT_COLLECTIVES:
                d = self.collectives.setdefault(
                    COLLECTIVE_KINDS.get(name, name), {"count": 0, "bytes": 0})
                d["count"] += 1
                d["bytes"] += _nbytes(out)
            return out
        self.ops += 1
        fresh = self._fresh.get(func)
        if fresh is None:
            fresh = self._fresh[func] = _fresh_outputs(func)
        key = (func, _signature(args), _signature(tuple(
            sorted(kwargs.items())))) if fresh else (None,)
        seen = None if None in key else self._seen.get(key)
        if seen is None:
            out = func(*args, **kwargs)
            flops, moved = self._price(func, args, kwargs, out)
            if None not in key and all(t.device.type == "meta"
                                       for t in _tensors(out)):
                self._seen[key] = (isinstance(out, tuple), [
                    (tuple(t.shape), t.stride(), t.dtype)
                    for t in _tensors(out)], flops, moved)
        else:
            many, shapes, flops, moved = seen
            outs = tuple(torch.empty_strided(shape, stride, dtype=dtype,
                                             device="meta")
                         for shape, stride, dtype in shapes)
            out = outs if many else outs[0]
        self.flops += flops
        self.bytes_accessed += moved
        self.track(*_tensors(out))
        return out


# --------------------------------------------------------------------------- #
# cells                                                                       #
# --------------------------------------------------------------------------- #

def _contiguous_stride(shape) -> Tuple[int, ...]:
    out, acc = [], 1
    for s in reversed(tuple(shape)):
        out.append(acc)
        acc *= s
    return tuple(reversed(out))


def place(tree, shardings, requires_grad: bool = False):
    """``tree``'s leaves as DTensors on their shardings' mesh, each local
    shard a ``"meta"`` tensor of the rank's shape (no collective)."""
    from repro_torch.sharding.partition import NamedSharding
    from repro_torch.training.tree import leaves, tree_map

    it = iter(leaves(shardings, is_leaf=lambda s: isinstance(s,
                                                             NamedSharding)))

    def one(x):
        sh = next(it)
        local = torch.empty(sh.shard_shape(tuple(x.shape)), dtype=x.dtype,
                            device="meta")
        d = DTensor.from_local(local, sh.mesh, sh.placements(),
                               run_check=False, shape=tuple(x.shape),
                               stride=_contiguous_stride(x.shape))
        if requires_grad and d.is_floating_point():
            d = d.detach().requires_grad_(True)
        return d
    return tree_map(one, tree)


def build_cell(arch_id: str, shape_name: str, multi_pod: bool,
               layer_override: Optional[int] = None, variant: str = "base",
               smoke: bool = False, mesh_shape=None):
    """``(mesh, step, args, shardings)`` for one cell: the step function,
    its shape-only arguments and their shardings (trees of the same
    structure)."""
    import dataclasses as _dc

    from repro_torch.configs import SHAPES, get_config, get_smoke
    from repro_torch.models import build_model
    from repro_torch.sharding import partition as pt
    from repro_torch.training.train_loop import (abstract_train_state,
                                                 make_train_step)

    cfg = (get_smoke if smoke else get_config)(arch_id)
    shape = next(s for s in SHAPES if s.name == shape_name)
    if variant == "opt":
        cfg = opt_overrides(cfg, shape.kind)
    if layer_override is not None:
        # probe mode: reduced layers and unrolled scans, enlarged chunks
        # (the reference's recipe; chunked FLOPs are chunk-size invariant)
        cfg = override_layers(cfg, layer_override).replace(unroll=True)
        if shape.kind in ("train", "prefill"):
            cfg = cfg.replace(attn_chunk=max(cfg.attn_chunk,
                                             shape.seq_len // 8))
            if cfg.ssm is not None:
                cfg = cfg.replace(ssm=_dc.replace(
                    cfg.ssm, chunk_size=max(cfg.ssm.chunk_size,
                                            shape.seq_len // 8)))
    mesh = cell_mesh(multi_pod, mesh_shape)
    model = build_model(cfg, device="cpu")
    batch_abs = model.input_specs(shape)
    batch_sh = pt.batch_shardings(batch_abs, mesh,
                                  all_axes=getattr(cfg, "dp_only", False))

    if shape.kind == "train":
        state_abs = abstract_train_state(model)
        p_sh = pt.params_shardings(state_abs.params, mesh, cfg)
        o_sh = pt.opt_state_shardings(state_abs.opt_state, state_abs.params,
                                      mesh, cfg)
        state_sh = type(state_abs)(p_sh, o_sh, pt.replicated(mesh))
        step = make_train_step(model, accum_steps=cfg.accum_steps)
        return mesh, step, (state_abs, batch_abs), (state_sh, batch_sh)

    params_abs = model.param_specs()
    p_sh = pt.params_shardings(params_abs, mesh, cfg)
    if shape.kind == "prefill":
        return mesh, model.prefill, (params_abs, batch_abs), (p_sh, batch_sh)

    cache_abs = model.cache_specs(shape)
    c_sh = pt.cache_shardings(cache_abs, mesh, cfg,
                              seq_shard=shape.global_batch == 1,
                              seq_over_model=(variant == "opt"))
    return (mesh, model.decode_step, (params_abs, batch_abs, cache_abs),
            (p_sh, batch_sh, c_sh))


def _local_tensors(tree) -> List[Any]:
    from repro_torch.training.tree import leaves

    return [x.to_local() if isinstance(x, DTensor) else x
            for x in leaves(tree)]


def _resolve_outputs(out):
    """Every DTensor output's pending reductions resolved (counted by the
    census); returns the outputs' local tensors."""
    return [_reduced(x).to_local() if isinstance(x, DTensor) else x
            for x in tree_leaves(out)]


_OP_RE = re.compile(r"Operator (\S+) does not have a sharding strategy"
                    r"|Sharding propagation failed for (aten\.[\w.]+)")


def trace_cell(arch_id: str, shape_name: str, multi_pod: bool,
               layer_override: Optional[int] = None, variant: str = "base",
               smoke: bool = False, mesh_shape=None) -> Dict[str, Any]:
    """The census of one cell's step (the ``ok`` record's fields)."""
    from repro_torch.models.layers import recompute_under
    from repro_torch.models.unroll import batch_local_by
    from repro_torch.sharding.partition import local_bytes

    register_rules()
    t0 = time.time()
    mesh, step, args, shardings = build_cell(
        arch_id, shape_name, multi_pod, layer_override, variant, smoke,
        mesh_shape)
    arg_bytes = sum(local_bytes(a, s) for a, s in zip(args, shardings))
    if hasattr(args[0], "opt_state"):   # a train state: params ask for grads
        st, st_sh = args[0], shardings[0]
        placed = (type(st)(place(st.params, st_sh.params, requires_grad=True),
                           place(st.opt_state, st_sh.opt_state),
                           place(st.step, st_sh.step)),
                  place(args[1], shardings[1]))
    else:
        placed = tuple(place(a, s) for a, s in zip(args, shardings))
    t_lower = time.time() - t0
    census = Census()
    census.track(*[t for a in placed for t in _local_tensors(a)])
    RULES.clear()
    with SpmdRules(), implicit_replication(), census, \
            recompute_under(_under_rules), batch_local_by(_batch_local):
        out_locals = _resolve_outputs(step(*placed))
    t_compile = time.time() - t0 - t_lower
    out_bytes = sum(t.numel() * t.element_size() for t in out_locals
                    if isinstance(t, torch.Tensor))
    n_dev = mesh.size()
    return dict(
        lower_s=round(t_lower, 1), compile_s=round(t_compile, 1),
        n_devices=n_dev, flops=float(census.flops),
        bytes_accessed=float(census.bytes_accessed),
        memory={"temp_size_in_bytes": max(census.peak - arg_bytes, 0),
                "argument_size_in_bytes": arg_bytes,
                "output_size_in_bytes": out_bytes},
        collectives=census.collectives, rules=dict(sorted(RULES.items())),
        hlo_bytes=None, ops=census.ops)


def artifact_path(out_dir: Path, arch_id: str, shape_name: str,
                  multi_pod: bool, layer_override=None, variant="base",
                  smoke: bool = False, mesh_shape=None) -> Path:
    suffix = f"__probe{layer_override}" if layer_override is not None else ""
    if variant != "base":
        suffix += f"__{variant}"
    if smoke:
        suffix += "__smoke"
    return out_dir / (f"{arch_id}__{shape_name}__"
                      f"{mesh_name(multi_pod, mesh_shape)}{suffix}"
                      f"{ARTIFACT_SUFFIX}.json")


def run_cell(arch_id: str, shape_name: str, multi_pod: bool,
             out_dir: Path = ARTIFACT_DIR, force: bool = False,
             layer_override: Optional[int] = None, variant: str = "base",
             smoke: bool = False, mesh_shape=None) -> Dict[str, Any]:
    out = artifact_path(Path(out_dir), arch_id, shape_name, multi_pod,
                        layer_override, variant, smoke, mesh_shape)
    out.parent.mkdir(parents=True, exist_ok=True)
    if out.exists() and not force:
        rec = json.loads(out.read_text())
        if rec.get("status") == "ok":
            print(f"[skip] {out.name} (cached)")
            return rec

    rec = {"arch": arch_id, "shape": shape_name,
           "mesh": mesh_name(multi_pod, mesh_shape),
           "layer_override": layer_override, "variant": variant,
           "smoke": smoke, "status": "error"}
    t0 = time.time()
    try:
        rec.update(trace_cell(arch_id, shape_name, multi_pod, layer_override,
                              variant, smoke, mesh_shape), status="ok")
        print(f"[ok]   {out.name}: trace={rec['compile_s']:.0f}s "
              f"flops/dev={rec['flops']:.3g} "
              f"args/dev={rec['memory']['argument_size_in_bytes']/2**30:.2f}"
              f"GiB temp/dev="
              f"{rec['memory']['temp_size_in_bytes']/2**30:.2f}GiB")
    except Exception as e:  # noqa: BLE001 — record and continue
        rec["error"] = f"{type(e).__name__}: {e}"[:2000]
        m = _OP_RE.search(str(e))
        if m:
            rec["op"] = m.group(1) or m.group(2)
        rec["traceback"] = traceback.format_exc()[-4000:]
        print(f"[FAIL] {out.name}: {rec['error'][:300]}")
    rec["wall_s"] = round(time.time() - t0, 1)
    out.write_text(json.dumps(rec, indent=1))
    return rec


def _run_jobs(todo, meshes, out_dir: Path, args) -> int:
    """Each (cell, mesh) of ``todo`` x ``meshes`` traced by ``python -m
    repro_torch.launch.dryrun`` in a process of its own, ``args.jobs`` at
    a time; a process past ``args.cell_timeout`` seconds is killed and
    its cell recorded as ``status: "error"``."""
    import subprocess

    queue = [(a, s, mp) for a, s in todo for mp in meshes]
    running: List[Tuple[Any, tuple, float]] = []
    n_ok = n_fail = 0

    def finish(cell, killed: bool) -> None:
        nonlocal n_ok, n_fail
        arch_id, shape_name, mp = cell
        path = artifact_path(out_dir, arch_id, shape_name, mp,
                             layer_override=args.layers,
                             variant=args.variant)
        rec = json.loads(path.read_text()) if path.exists() else {}
        if killed or rec.get("status") != "ok":
            if killed:
                rec = {"arch": arch_id, "shape": shape_name,
                       "mesh": mesh_name(mp), "layer_override": args.layers,
                       "variant": args.variant, "smoke": False,
                       "status": "error",
                       "error": f"timeout: not traced in "
                                f"{args.cell_timeout} s"}
                path.write_text(json.dumps(rec, indent=1))
            n_fail += 1
            print(f"[FAIL] {path.name}: {rec.get('error', 'no record')}"
                  [:300], flush=True)
        else:
            n_ok += 1
            print(f"[ok]   {path.name}", flush=True)

    while queue or running:
        while queue and len(running) < args.jobs:
            cell = queue.pop(0)
            arch_id, shape_name, mp = cell
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                   "--arch", arch_id, "--shape", shape_name,
                   "--mesh", "multi" if mp else "single",
                   "--variant", args.variant, "--out", str(out_dir)]
            if args.layers is not None:
                cmd += ["--layers", str(args.layers)]
            if args.force:
                cmd.append("--force")
            running.append((subprocess.Popen(
                cmd, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL),
                cell, time.monotonic()))
        time.sleep(0.5)
        for item in list(running):
            proc, cell, t0 = item
            late = (args.cell_timeout is not None
                    and time.monotonic() - t0 > args.cell_timeout)
            if proc.poll() is None and not late:
                continue
            if proc.poll() is None:
                proc.kill()
            proc.wait()
            running.remove(item)
            finish(cell, late)
    print(f"\ndone: {n_ok} ok, {n_fail} failed")
    return 1 if n_fail else 0


_KINDS = {"all-gather": "ag", "all-reduce": "ar", "reduce-scatter": "rs",
          "all-to-all": "a2a"}


def cell_table(out_dir: Path, variant: str = "base") -> str:
    """A markdown table of the artifacts in ``out_dir``: one row for each
    (arch, shape), its 16x16 and 2x16x16 values as ``single / multi``:
    status, wall seconds, FLOPs, bytes accessed, argument and temporary
    GB a rank, collectives by kind (count) and the rules that fired."""
    recs: Dict[Tuple[str, str], Dict[bool, dict]] = {}
    for path in sorted(Path(out_dir).glob(f"*{ARTIFACT_SUFFIX}.json")):
        rec = json.loads(path.read_text())
        if rec.get("variant") != variant or rec.get("layer_override") \
                or rec.get("smoke"):
            continue
        recs.setdefault((rec["arch"], rec["shape"]), {})[
            rec["mesh"] == mesh_name(True)] = rec

    def pair(cell, fn):
        return " / ".join(fn(cell[m]) if m in cell else "-"
                          for m in (False, True))

    def num(key, scale=1.0, fmt="{:.4g}"):
        return lambda r: (fmt.format(_get(r, key) / scale)
                          if r.get("status") == "ok" else "-")

    def coll(r):
        return ", ".join(f"{_KINDS.get(k, k)} {v['count']}"
                         for k, v in sorted(r.get("collectives", {}).items()))

    def rules(cell):
        names = sorted({n for r in cell.values() for n in r.get("rules", {})})
        out = []
        for n in names:
            c = [str(cell[m].get("rules", {}).get(n, 0)) if m in cell
                 else "-" for m in (False, True)]
            out.append(f"{n} {c[0]}" if c[0] == c[1] else
                       f"{n} {c[0]}/{c[1]}")
        return ", ".join(out)
    lines = ["| arch | shape | status | wall s | FLOPs a rank | bytes "
             "accessed a rank | arguments GB | temporaries GB | "
             "collectives | rules |", "|" + "---|" * 10]
    for (arch, shape), cell in sorted(recs.items()):
        lines.append("| " + " | ".join([
            arch, shape, pair(cell, lambda r: r["status"]),
            pair(cell, lambda r: str(r.get("wall_s"))),
            pair(cell, num("flops")), pair(cell, num("bytes_accessed")),
            pair(cell, num("memory.argument_size_in_bytes", 1e9, "{:.3f}")),
            pair(cell, num("memory.temp_size_in_bytes", 1e9, "{:.2f}")),
            pair(cell, coll), rules(cell)]) + " |")
    return "\n".join(lines)


def _get(rec: dict, key: str):
    for part in key.split("."):
        rec = rec[part]
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="both")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--probes", action="store_true",
                    help="run the two reduced-layer probe traces per cell "
                         "(single-pod) used to reconstruct per-layer costs")
    ap.add_argument("--layers", type=int, default=None,
                    help="trace each cell at this many layers (its probe "
                         "config: a cheap search for the ops that fail)")
    ap.add_argument("--variant", default="base", choices=["base", "opt"],
                    help="'opt' applies the optimized settings")
    ap.add_argument("--out", default=str(ARTIFACT_DIR))
    ap.add_argument("--jobs", type=int, default=1,
                    help="trace this many cells at once, each in a process "
                         "of its own (1: in this process, in turn)")
    ap.add_argument("--table", action="store_true",
                    help="print the markdown table of the artifacts in "
                         "--out (cell_table) and exit")
    ap.add_argument("--cell-timeout", type=float, default=None,
                    help="with --jobs: seconds a cell's process may take "
                         "before it is killed and the cell recorded as an "
                         "error")
    args = ap.parse_args(argv)

    from repro_torch.configs import cells, get_config

    out_dir = Path(args.out)
    if args.table:
        print(cell_table(out_dir, args.variant))
        return 0
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[
        args.mesh]

    if args.all or args.probes:
        todo = [(a, s.name) for a, s in cells()]
        if args.arch:
            todo = [(a, s) for a, s in todo if a == args.arch]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape, or --all")
        todo = [(args.arch, args.shape)]

    if args.jobs > 1 and not args.probes:
        return _run_jobs(todo, meshes, out_dir, args)
    n_ok = n_fail = 0
    for arch_id, shape_name in todo:
        if args.probes:
            l1, l2 = probe_layer_counts(get_config(arch_id))
            for lo in (l1, l2):
                rec = run_cell(arch_id, shape_name, False, out_dir,
                               args.force, layer_override=lo,
                               variant=args.variant)
                n_ok += rec.get("status") == "ok"
                n_fail += rec.get("status") != "ok"
            continue
        for mp in meshes:
            rec = run_cell(arch_id, shape_name, mp, out_dir, args.force,
                           layer_override=args.layers, variant=args.variant)
            if rec.get("status") == "ok":
                n_ok += 1
            else:
                n_fail += 1
    print(f"\ndone: {n_ok} ok, {n_fail} failed")
    return 1 if n_fail else 0


if __name__ == "__main__":
    sys.exit(main())
