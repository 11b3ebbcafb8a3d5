"""Multi-head Latent Attention (DeepSeek-V2, arXiv:2405.04434; port of
``repro.models.mla``).

KV is compressed to a shared latent ``c_kv`` (kv_lora_rank) plus a
single decoupled RoPE key (qk_rope_head_dim) — the decode cache stores
only ``(B, S, kv_lora_rank + rope_dim)`` instead of per-head K/V.

Train path expands the latent to per-head K/V; decode path keeps the
latent cache and scores against it directly (absorbed attention).
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch

from .layers import (F32, _dtype, apply_rope, dense, dense_init, init_rmsnorm,
                     rms_norm)

Params = Dict[str, Any]
NEG_INF = -1e30


def init_mla(gen, cfg, device) -> Params:
    m = cfg.mla
    d, h = cfg.d_model, cfg.n_heads
    dt = _dtype(cfg.dtype)
    qk_head = m.qk_nope_head_dim + m.qk_rope_head_dim
    return {
        # query low-rank path
        "wq_a": dense_init(gen, (d, m.q_lora_rank), dt, device),
        "q_a_norm": init_rmsnorm(m.q_lora_rank, dt, device),
        "wq_b": dense_init(gen, (m.q_lora_rank, h, qk_head), dt, device),
        # kv latent path: latent + decoupled rope key
        "wkv_a": dense_init(gen, (d, m.kv_lora_rank + m.qk_rope_head_dim),
                            dt, device),
        "kv_a_norm": init_rmsnorm(m.kv_lora_rank, dt, device),
        "wk_b": dense_init(gen, (m.kv_lora_rank, h, m.qk_nope_head_dim), dt,
                           device),
        "wv_b": dense_init(gen, (m.kv_lora_rank, h, m.v_head_dim), dt,
                           device),
        "wo": dense_init(gen, (h, m.v_head_dim, d), dt, device),
    }


def _project_q(x, p, cfg, positions, rope=None):
    m = cfg.mla
    cq = dense(x, p["wq_a"])                              # bsd,dr->bsr
    cq = rms_norm(cq, p["q_a_norm"], cfg.norm_eps)
    q = dense(cq, p["wq_b"])                              # bsr,rhk->bshk
    q_nope = q[..., : m.qk_nope_head_dim]
    q_rope = apply_rope(q[..., m.qk_nope_head_dim:], positions, cfg.rope_theta,
                        rope)
    return q_nope, q_rope


def _latent(x, p, cfg, positions, rope=None):
    """Returns (c_kv (B,S,R) normalized latent, k_rope (B,S,1,rope))."""
    m = cfg.mla
    kv = dense(x, p["wkv_a"])                             # bsd,dr->bsr
    c_kv = rms_norm(kv[..., : m.kv_lora_rank], p["kv_a_norm"], cfg.norm_eps)
    k_rope = kv[..., m.kv_lora_rank:][:, :, None, :]       # single shared head
    k_rope = apply_rope(k_rope, positions, cfg.rope_theta, rope)
    return c_kv, k_rope


def mla_attention_train(x: torch.Tensor, p, cfg,
                        positions: torch.Tensor) -> torch.Tensor:
    """Full-sequence causal MLA (train/prefill). x: (B, S, D)."""
    m = cfg.mla
    s = x.shape[1]
    q_nope, q_rope = _project_q(x, p, cfg, positions)
    c_kv, k_rope = _latent(x, p, cfg, positions)
    k_nope = dense(c_kv, p["wk_b"])                       # bsr,rhk->bshk
    v = dense(c_kv, p["wv_b"])
    scale = 1.0 / math.sqrt(m.qk_nope_head_dim + m.qk_rope_head_dim)
    scores = (torch.einsum("bqhk,bshk->bhqs", q_nope.to(F32), k_nope.to(F32))
              + torch.einsum("bqhk,bsxk->bhqs", q_rope.to(F32),
                             k_rope.to(F32))) * scale
    qpos = torch.arange(s, device=x.device)
    mask = qpos[None, :] <= qpos[:, None]
    scores = torch.where(mask[None, None], scores, NEG_INF)
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqs,bshk->bqhk", w.to(v.dtype), v)
    return dense(out, p["wo"], 2)                         # bqhk,hkd->bqd


def write_index(pos: torch.Tensor, n_rows: int):
    """(batch index, row) of each sequence's write at ``pos`` in a cache of
    ``n_rows`` rows, the row clamped to the last as
    ``dynamic_update_slice`` clamps its start (a write at or past the end
    lands on the last row)."""
    return (torch.arange(pos.shape[0], device=pos.device),
            torch.clamp(pos.long(), 0, n_rows - 1))


def _write_row(cache: torch.Tensor, pos: torch.Tensor, val: torch.Tensor,
               at=None) -> None:
    """``vmap(dynamic_update_slice)(cache, val, (pos, 0...))`` in place:
    row ``pos[b]`` (clamped, :func:`write_index`; ``at``: that index,
    made once per decode step) of ``cache[b]`` becomes ``val[b]``."""
    cache[at if at is not None else write_index(pos, cache.shape[1])] = \
        val.to(cache.dtype)


def mla_decode(x: torch.Tensor, p, cfg, latent_cache: torch.Tensor,
               rope_cache: torch.Tensor, cache_len: torch.Tensor,
               positions: torch.Tensor,
               latent_scale: Optional[torch.Tensor] = None, step=None):
    """One-token decode with latent KV cache.

    latent_cache: (B, S, kv_lora_rank); rope_cache: (B, S, rope_dim).
    With ``latent_scale`` (B, S) the latent cache is int8 (per-position
    quantization) and dequantized on read.  The caches are written in
    place.  ``step``: what every layer of a decode step shares (the
    positions' ``rope``, the write index ``at``, the ``valid`` rows),
    made once.  Returns (out (B,1,D), latent_cache, rope_cache,
    latent_scale).
    """
    m = cfg.mla
    step = step or {}
    rope, at = step.get("rope"), step.get("at")
    q_nope, q_rope = _project_q(x, p, cfg, positions, rope)      # (B,1,H,*)
    c_kv, k_rope = _latent(x, p, cfg, positions, rope)     # (B,1,R), (B,1,1,rope)
    if latent_scale is not None:
        amax = torch.amax(torch.abs(c_kv.to(F32)), dim=-1)         # (B,1)
        scale = torch.clamp(amax, min=1e-6) / 127.0
        # torch.round rounds half to even, as jnp.round does
        c_q = torch.clamp(torch.round(c_kv.to(F32) / scale[..., None]),
                          -127, 127).to(torch.int8)
        _write_row(latent_cache, cache_len, c_q[:, 0], at)
        _write_row(latent_scale, cache_len, scale[:, 0], at)
    else:
        _write_row(latent_cache, cache_len, c_kv[:, 0], at)
    _write_row(rope_cache, cache_len, k_rope[:, 0, 0, :], at)
    new_len = cache_len + 1

    # absorbed attention: score against the latent cache directly
    # q_nope (B,1,H,nope) @ wk_b (R,H,nope) -> q_lat (B,1,H,R)
    if latent_scale is not None:
        lat = (latent_cache.to(F32)
               * latent_scale[..., None]).to(x.dtype)       # dequant on read
    else:
        lat = latent_cache
    q_lat = torch.einsum("bqhk,rhk->bqhr", q_nope, p["wk_b"])
    scale = 1.0 / math.sqrt(m.qk_nope_head_dim + m.qk_rope_head_dim)
    scores = (torch.einsum("bqhr,bsr->bhqs", q_lat.to(F32), lat.to(F32))
              + torch.einsum("bqhk,bsk->bhqs", q_rope.to(F32),
                             rope_cache.to(F32))) * scale
    valid = step.get("valid")
    if valid is None:
        valid = (torch.arange(latent_cache.shape[1], device=x.device)[None, :]
                 < new_len[:, None])
    scores = torch.where(valid[:, None, None, :], scores, NEG_INF)
    w = torch.softmax(scores, dim=-1)
    # mix latents, then expand through wv_b (absorbed-V form)
    mixed = torch.einsum("bhqs,bsr->bqhr", w, lat.to(w.dtype))
    out = torch.einsum("bqhr,rhk->bqhk", mixed, p["wv_b"].to(w.dtype))
    out = dense(out.to(x.dtype), p["wo"], 2)              # bqhk,hkd->bqd
    return out, latent_cache, rope_cache, latent_scale
