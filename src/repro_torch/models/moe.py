"""Mixture-of-Experts FFN: top-k routing, shared experts (port of
``repro.models.moe``).

Dispatch uses the sort-based static-capacity formulation (MaxText /
Switch-style): tokens are permuted into an ``(E, capacity, d)`` buffer by
router assignment, each expert runs a dense GLU on its buffer, and
results scatter back weighted by router gates.  Tokens over capacity
drop (standard capacity-factor semantics), tracked by the aux outputs.

The PFCS integration (serving tier) consumes ``router_top_idx`` from the
aux dict: each token batch's active-expert set becomes a composite in the
expert-cache registry (see ``repro_torch.serving.expert_cache``).
"""

from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch

from .layers import F32, _dtype, apply_ffn, dense_init, init_ffn

Params = Dict[str, Any]


def _constrain(x: torch.Tensor, spec_entries) -> torch.Tensor:
    """The reference's sharding constraint: a ``DTensor`` is
    redistributed to the spec on its own mesh; a plain tensor, or a spec
    naming an axis the mesh lacks, passes unchanged (the reference's
    constraint is a no-op without a matching mesh)."""
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    from repro_torch.sharding.partition import NamedSharding, PartitionSpec

    names = set(x.device_mesh.mesh_dim_names or ())
    for e in spec_entries:
        axes = () if e is None else ((e,) if isinstance(e, str) else e)
        if not set(axes) <= names:
            return x
    sharding = NamedSharding(x.device_mesh, PartitionSpec(*spec_entries))
    return x.redistribute(x.device_mesh, sharding.placements())


def init_moe(gen, cfg, device) -> Params:
    m = cfg.moe
    d = cfg.d_model
    dt = _dtype(cfg.dtype)
    p: Params = {
        "router": dense_init(gen, (d, m.n_experts), F32, device),  # f32
        "w_gate": dense_init(gen, (m.n_experts, d, m.d_ff_expert), dt,
                             device),
        "w_up": dense_init(gen, (m.n_experts, d, m.d_ff_expert), dt, device),
        "w_down": dense_init(gen, (m.n_experts, m.d_ff_expert, d), dt,
                             device),
    }
    if m.n_shared_experts > 0:
        p["shared"] = init_ffn(gen, d, m.d_ff_shared * m.n_shared_experts,
                               cfg.act, dt, device)
    return p


def _capacity(n_tokens: int, m) -> int:
    cap = int(math.ceil(n_tokens * m.top_k / m.n_experts * m.capacity_factor))
    return max(8, -(-cap // 8) * 8)  # round up to 8 for lane alignment


def top_k(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k``: the ``k`` largest along the last axis, in
    descending order, the lower index first among equal values — a
    stable descending sort keeps equal values in index order, which
    ``torch.topk`` does not promise."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def apply_moe(x: torch.Tensor, p, cfg) -> Tuple[torch.Tensor, Dict]:
    """x: (B, S, D) -> (B, S, D), aux (load-balance loss, router stats)."""
    m = cfg.moe
    b, s, d = x.shape
    t = b * s
    tk = t * m.top_k
    xt = x.reshape(t, d)
    dev = x.device

    # --- routing (f32 for numerics) --------------------------------------- #
    logits = xt.to(F32) @ p["router"]                                  # (T,E)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, top_idx = top_k(probs, m.top_k)                         # (T,K)
    gate_vals = gate_vals / torch.clamp(
        gate_vals.sum(-1, keepdim=True), min=1e-9)                     # renorm

    # load-balance aux loss (Switch): E * sum_e f_e * p_e
    me = probs.mean(dim=0)                                             # (E,)
    ce = torch.nn.functional.one_hot(top_idx[:, 0], m.n_experts).to(
        F32).mean(dim=0)
    aux_loss = m.n_experts * torch.sum(me * ce) * m.router_aux_weight

    # --- sort-based dispatch ---------------------------------------------- #
    cap = _capacity(t, m)
    flat_expert = top_idx.reshape(-1)                                  # (T*K,)
    flat_token = torch.arange(t, device=dev).repeat_interleave(m.top_k)
    flat_gate = gate_vals.reshape(-1)

    order = torch.argsort(flat_expert, stable=True)
    se, st, sg = flat_expert[order], flat_token[order], flat_gate[order]
    # rank within expert: position - start offset of that expert's run
    counts = torch.bincount(se, minlength=m.n_experts)                 # (E,)
    starts = torch.cumsum(counts, 0) - counts                          # (E,)
    rank = torch.arange(tk, device=dev) - starts[se]                   # (TK,)
    keep = rank < cap                                                  # drops
    slot = torch.where(keep, se * cap + rank, tk)         # overflow -> OOB
    slot_c = torch.clamp(slot, 0, m.n_experts * cap - 1)
    keep_tk = torch.zeros((tk,), dtype=torch.bool, device=dev)
    keep_tk[order] = keep                                  # token order

    # gather tokens into (E*cap, d); an overflow slot is clipped to the
    # last slot and adds zeros there
    buf = torch.zeros((m.n_experts * cap, d), dtype=x.dtype, device=dev)
    buf.index_add_(0, slot_c, torch.where(keep[:, None], xt[st],
                                          0).to(x.dtype))
    buf = buf.reshape(m.n_experts, cap, d)
    if cfg.shard_moe_dispatch:
        buf = _constrain(buf, ("model", None, "data"))

    # --- expert computation (grouped GLU einsum over E) ------------------- #
    # ecd,edf->ecf as a batched matmul over E, its float32 result
    # unrounded (float32 operands, as layers.mm)
    bf = buf.to(F32)
    g = torch.nn.functional.silu(torch.bmm(bf, p["w_gate"].to(F32)))
    u = torch.bmm(bf, p["w_up"].to(F32))
    h = (g * u).to(x.dtype)
    if cfg.shard_moe_dispatch:
        h = _constrain(h, ("model", None, None))
    eo = torch.bmm(h, p["w_down"])                                     # (E,cap,d)

    # --- combine back ------------------------------------------------------ #
    eo_flat = eo.reshape(m.n_experts * cap, d)
    if cfg.moe_combine == "gather":
        # inverse-permutation gather + einsum combine
        inv = torch.zeros((tk,), dtype=torch.int64, device=dev)
        inv[order] = slot_c
        gathered = eo_flat[inv].reshape(t, m.top_k, d)
        w_tk = torch.where(keep_tk.reshape(t, m.top_k), gate_vals, 0.0)
        out = torch.einsum("tkd,tk->td", gathered.to(F32), w_tk)
    else:
        gathered = eo_flat[slot_c]                                     # (TK,d)
        gathered = torch.where(keep[:, None], gathered, 0)
        weighted = gathered.to(F32) * sg[:, None]
        out = torch.zeros((t, d), dtype=F32, device=dev).index_add_(
            0, st, weighted)

    # --- shared experts (dense branch) -------------------------------------- #
    if "shared" in p:
        out = out + apply_ffn(xt, p["shared"], cfg.act).to(F32)

    aux = {
        "moe_aux_loss": aux_loss,
        "router_top_idx": top_idx.to(torch.int32),  # (T, K): expert-cache feed
        "dropped_frac": 1.0 - keep.to(F32).mean(),
        "expert_load": counts,
        # the port's addition: which (token, choice) pairs were kept
        "keep": keep_tk.reshape(t, m.top_k),
    }
    return out.to(x.dtype).reshape(b, s, d), aux
