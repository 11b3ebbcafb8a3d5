"""Decoder-only transformer assembly: dense / MoE / MLA / VLM-stub (port of
``repro.models.transformer``).

The reference stacks its layers along a leading axis and scans them; the
port keeps one :class:`~repro_torch.models.layers.ParamTree` per layer in
``params["layers"]`` (an ``nn.ModuleList``: the dense layers, then the
MoE layers, in layer order) and loops over them.  The decode cache keeps
the reference's layout, one tensor stacked over layers per entry.

Three entry points per model:
  * ``train_logits``  — full-sequence causal forward (a forward only: the
                        loss and the optimizer are ROADMAP.md A.15)
  * ``prefill``       — forward + KV-cache materialization, last logits
  * ``decode_step``   — one token against the stacked KV cache

VLM ('vlm' family): precomputed patch embeddings are projected and
prepended to the token embeddings; loss masks the image positions.

The config's ``remat`` policy has no effect: it trades memory for
recomputation in a backward pass, and the port runs forwards only.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from . import attention as attn
from . import mla as mla_mod
from . import moe as moe_mod
from .layers import (F32, ParamTree, _dtype, apply_ffn, dense_init,
                     embed_tokens, gelu, init_embedding, init_ffn,
                     init_rmsnorm, rms_norm, unembed)
from .attention import valid_positions
from .layers import rope_table
from .mla import _write_row, write_index
from .unroll import scan_or_unroll

Params = Dict[str, Any]


# --------------------------------------------------------------------------- #
# init                                                                        #
# --------------------------------------------------------------------------- #

def n_dense_layers(cfg) -> int:
    """The leading dense layers; the rest are MoE layers
    (``first_dense_layers`` is a prefix by construction)."""
    return cfg.moe.first_dense_layers if cfg.moe else cfg.n_layers


def _init_layer(gen, cfg, moe_layer: bool, device) -> Params:
    dt = _dtype(cfg.dtype)
    p: Params = {
        "ln_attn": init_rmsnorm(cfg.d_model, dt, device),
        "ln_ffn": init_rmsnorm(cfg.d_model, dt, device),
    }
    if cfg.mla is not None:
        p["attn"] = mla_mod.init_mla(gen, cfg, device)
    else:
        p["attn"] = attn.init_attention(gen, cfg, device)
    if moe_layer:
        p["moe"] = moe_mod.init_moe(gen, cfg, device)
    else:
        p["ffn"] = init_ffn(gen, cfg.d_model, cfg.d_ff, cfg.act, dt, device)
    return p


def init_params(gen: Optional[torch.Generator], cfg, device) -> ParamTree:
    """Random parameters with the reference's distributions: truncated
    normal weights at the fan-in scale, the embedding N(0, 0.02**2), the
    unembedding at scale 0.02, a float32 router, zero biases and unit
    norms, drawn from ``gen`` on ``device`` (``"meta"``: shapes only)."""
    dt = _dtype(cfg.dtype)
    n_dense = n_dense_layers(cfg)
    p: Params = {
        "embed": init_embedding(gen, cfg.vocab_size, cfg.d_model, dt, device),
        "ln_f": init_rmsnorm(cfg.d_model, dt, device),
    }
    if not cfg.tie_embeddings:
        p["unembed"] = dense_init(gen, (cfg.vocab_size, cfg.d_model), dt,
                                  device, scale=0.02)
    p["layers"] = [_init_layer(gen, cfg, i >= n_dense, device)
                   for i in range(cfg.n_layers)]
    if cfg.family == "vlm":
        fd = cfg.frontend.feature_dim
        p["vis_proj"] = {
            "w1": dense_init(gen, (fd, cfg.d_model), dt, device),
            "w2": dense_init(gen, (cfg.d_model, cfg.d_model), dt, device),
        }
    return ParamTree(p)


# --------------------------------------------------------------------------- #
# layer bodies                                                                #
# --------------------------------------------------------------------------- #

def _layer_train(x, lp, cfg, positions):
    h = rms_norm(x, lp["ln_attn"], cfg.norm_eps)
    if cfg.mla is not None:
        a = mla_mod.mla_attention_train(h, lp["attn"], cfg, positions)
    else:
        q, k, v = attn.qkv_project(h, lp["attn"], cfg, positions)
        o = attn.attention_chunked(q, k, v, chunk=cfg.attn_chunk,
                                   causal=True, unroll=cfg.unroll)
        a = attn.out_project(o, lp["attn"])
    x = x + a
    h = rms_norm(x, lp["ln_ffn"], cfg.norm_eps)
    if "moe" in lp:
        f, aux = moe_mod.apply_moe(h, lp["moe"], cfg)
        return x + f, aux["moe_aux_loss"]
    return x + apply_ffn(h, lp["ffn"], cfg.act), None


def _embed_inputs(params, cfg, batch) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (x (B,S,D), loss_mask (B,S))."""
    x = embed_tokens(batch["tokens"], params["embed"])
    mask = torch.ones(batch["tokens"].shape, dtype=torch.bool,
                      device=x.device)
    if cfg.family == "vlm":
        vp = params["vis_proj"]
        # float32 patches against the projector: the reference's einsum
        # promotes both sides to float32
        pe = torch.einsum("bnf,fd->bnd", batch["patches"].to(F32),
                          vp["w1"].to(F32))
        pe = gelu(pe)
        pe = torch.einsum("bnd,de->bne", pe, vp["w2"].to(F32)).to(x.dtype)
        x = torch.cat([pe, x], dim=1)
        mask = torch.cat([torch.zeros(pe.shape[:2], dtype=torch.bool,
                                      device=x.device), mask], dim=1)
    return x, mask


def _run_stack(x, params, cfg, positions):
    """The layers in order.  Returns (x, total_aux_loss)."""
    aux_total = torch.zeros((), dtype=F32, device=x.device)
    for lp in params["layers"]:
        x, a = _layer_train(x, lp, cfg, positions)
        if a is not None:
            aux_total = aux_total + a
    return x, aux_total


def _logits(x, params, cfg):
    x = rms_norm(x, params["ln_f"], cfg.norm_eps)
    table = (params["embed"]["table"] if cfg.tie_embeddings
             else params["unembed"])
    return unembed(x, table)


def train_logits(params, cfg, batch: Dict) -> Tuple[torch.Tensor, Dict]:
    x, loss_mask = _embed_inputs(params, cfg, batch)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    x, aux_loss = _run_stack(x, params, cfg, positions)
    targets = batch["tokens"]
    if cfg.family == "vlm":  # align targets with the patch-prefixed stream
        pad = torch.zeros((targets.shape[0], cfg.frontend.n_positions),
                          dtype=targets.dtype, device=targets.device)
        targets = torch.cat([pad, targets], dim=1)
    return _logits(x, params, cfg), {"aux_loss": aux_loss,
                                     "loss_mask": loss_mask,
                                     "targets": targets}


# --------------------------------------------------------------------------- #
# prefill / decode                                                            #
# --------------------------------------------------------------------------- #

def init_cache(cfg, batch: int, max_len: int, device) -> Dict:
    dt = _dtype(cfg.dtype)
    l = cfg.n_layers
    i32 = torch.int32
    if cfg.mla is not None:
        m = cfg.mla
        out = {
            "latent": torch.zeros((l, batch, max_len, m.kv_lora_rank),
                                  dtype=dt, device=device),
            "rope": torch.zeros((l, batch, max_len, m.qk_rope_head_dim),
                                dtype=dt, device=device),
            "len": torch.zeros((batch,), dtype=i32, device=device),
        }
        if cfg.kv_cache_dtype == "int8":
            # quantized latent cache: int8 rows + a per-position f32 scale
            out["latent"] = torch.zeros((l, batch, max_len, m.kv_lora_rank),
                                        dtype=torch.int8, device=device)
            out["latent_scale"] = torch.zeros((l, batch, max_len), dtype=F32,
                                              device=device)
        return out
    kv, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    return {
        "k": torch.zeros((l, batch, max_len, kv, hd), dtype=dt,
                         device=device),
        "v": torch.zeros((l, batch, max_len, kv, hd), dtype=dt,
                         device=device),
        "len": torch.zeros((batch,), dtype=i32, device=device),
    }


def _ffn_or_moe(x, lp, cfg):
    """The layer's second half; returns (x, router top-k (B·1, K) int32 or
    ``None`` for a dense layer)."""
    h = rms_norm(x, lp["ln_ffn"], cfg.norm_eps)
    if "moe" in lp:
        f, aux = moe_mod.apply_moe(h, lp["moe"], cfg)
        return x + f, aux["router_top_idx"]
    return x + apply_ffn(h, lp["ffn"], cfg.act), None


def _attn_layer_decode(x, lp, cfg, k_cache, v_cache, cache_len, positions,
                       step):
    """One transformer layer, one token.  Caches: (B,S,KV,hd), written in
    place at ``cache_len`` (clamped to the last row)."""
    h = rms_norm(x, lp["ln_attn"], cfg.norm_eps)
    q, k, v = attn.qkv_project(h, lp["attn"], cfg, positions, step["rope"])
    _write_row(k_cache, cache_len, k[:, 0], step["at"])
    _write_row(v_cache, cache_len, v[:, 0], step["at"])
    o = attn.decode_attention(q, k_cache, v_cache, cache_len + 1,
                              step["valid"])
    x = x + attn.out_project(o, lp["attn"])
    return _ffn_or_moe(x, lp, cfg)


def _mla_layer_decode(x, lp, cfg, latent_c, rope_c, cache_len, positions,
                      latent_s, step):
    h = rms_norm(x, lp["ln_attn"], cfg.norm_eps)
    a, _, _, _ = mla_mod.mla_decode(h, lp["attn"], cfg, latent_c, rope_c,
                                    cache_len, positions,
                                    latent_scale=latent_s, step=step)
    return _ffn_or_moe(x + a, lp, cfg)


def _decode_step(params, cfg, batch: Dict, cache: Dict, with_router: bool):
    """Shared decode body; ``with_router`` also stacks the MoE layers'
    router top-k indices ((n_moe_layers, B, K) int32).  The cache's
    tensors are updated in place (the reference returns new arrays); the
    returned dict holds them with ``len`` advanced by one."""
    x = embed_tokens(batch["tokens"], params["embed"])
    cache_len = cache["len"]
    positions = cache_len[:, None]
    routers: List[torch.Tensor] = []
    mla = cfg.mla is not None
    int8 = mla and cfg.kv_cache_dtype == "int8"
    # what every layer shares, made once: the rotation table of the
    # positions, the (clamped) write index and the valid cache rows
    rows = cache["latent" if mla else "k"].shape[2]
    step = {"rope": rope_table(positions, cfg.mla.qk_rope_head_dim if mla
                               else cfg.resolved_head_dim, cfg.rope_theta),
            "at": write_index(cache_len, rows),
            "valid": valid_positions(cache_len + 1, rows)}
    for l, lp in enumerate(params["layers"]):
        if mla:
            x, top = _mla_layer_decode(
                x, lp, cfg, cache["latent"][l], cache["rope"][l], cache_len,
                positions, cache["latent_scale"][l] if int8 else None, step)
        else:
            x, top = _attn_layer_decode(x, lp, cfg, cache["k"][l],
                                        cache["v"][l], cache_len, positions,
                                        step)
        if top is not None:
            routers.append(top)
    cache = dict(cache, len=cache_len + 1)
    logits = _logits(x, params, cfg)
    if not with_router:
        return logits, cache
    b, k = batch["tokens"].shape[0], (cfg.moe.top_k if cfg.moe else 0)
    router = (torch.stack(routers, 0) if routers else
              torch.zeros((0, b, k), dtype=torch.int32, device=x.device))
    return logits, cache, router


def decode_step(params, cfg, batch: Dict, cache: Dict
                ) -> Tuple[torch.Tensor, Dict]:
    """batch: {'tokens': (B,1)}; returns (logits (B,1,V), new cache)."""
    return _decode_step(params, cfg, batch, cache, with_router=False)


def decode_step_router(params, cfg, batch: Dict, cache: Dict
                       ) -> Tuple[torch.Tensor, Dict, torch.Tensor]:
    """``decode_step`` that also returns the stacked MoE router top-k
    indices ((n_moe_layers, B, K) int32) — the PFCS expert-cache feed
    (``repro_torch.serving.expert_cache``)."""
    return _decode_step(params, cfg, batch, cache, with_router=True)


def _attn_layer_prefill(x, lp, cfg, positions):
    """Full-sequence forward that also returns this layer's k/v."""
    h = rms_norm(x, lp["ln_attn"], cfg.norm_eps)
    q, k, v = attn.qkv_project(h, lp["attn"], cfg, positions)
    o = attn.attention_chunked(q, k, v, chunk=cfg.attn_chunk, causal=True,
                               unroll=cfg.unroll)
    x = x + attn.out_project(o, lp["attn"])
    x, _ = _ffn_or_moe(x, lp, cfg)
    return x, (k, v)


def _mla_layer_prefill(x, lp, cfg, positions):
    h = rms_norm(x, lp["ln_attn"], cfg.norm_eps)
    a = mla_mod.mla_attention_train(h, lp["attn"], cfg, positions)
    c_kv, k_rope = mla_mod._latent(h, lp["attn"], cfg, positions)
    x, _ = _ffn_or_moe(x + a, lp, cfg)
    return x, (c_kv, k_rope[:, :, 0, :])


def prefill(params, cfg, batch: Dict) -> Tuple[torch.Tensor, Dict]:
    """Process the prompt; returns (last-position logits (B,V), cache)."""
    x, _ = _embed_inputs(params, cfg, batch)
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)[None, :]
    mla = cfg.mla is not None
    layer_fn = _mla_layer_prefill if mla else _attn_layer_prefill
    x, (a, bb) = scan_or_unroll(
        lambda x, lp: layer_fn(x, lp, cfg, positions), x,
        list(params["layers"]), cfg.unroll)
    new_len = torch.full((b,), s, dtype=torch.int32, device=x.device)
    if mla:
        cache = {"latent": a, "rope": bb, "len": new_len}
    else:
        cache = {"k": a, "v": bb, "len": new_len}
    logits = _logits(x[:, -1:, :], params, cfg)[:, 0, :]
    return logits, cache
