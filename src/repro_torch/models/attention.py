"""Attention: GQA/MQA with RoPE and qk-norm; train / prefill / decode paths
(port of ``repro.models.attention``).

Three execution regimes:

  * ``attention_full``     — plain einsum attention (short sequences,
                             smoke tests).
  * ``attention_chunked``  — query blocks in a loop: O(chunk x S) score
                             working set instead of O(S^2); each block sees
                             the full key axis, so the softmax is exact.
  * ``decode_attention``   — single-token query against a KV cache.

All paths share the GQA grouping einsum: q heads are reshaped to
(kv_heads, group), so q head ``h`` reads kv head ``h // G`` and no KV
repeat is materialized.  Scores are float32, masked with ``NEG_INF``
before a float32 softmax, as in the reference; no fused attention kernel
stands in for it.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch

from .layers import (F32, _dtype, apply_rope, dense, dense_init, init_rmsnorm,
                     rms_norm)
from .unroll import scan_or_unroll

Params = Dict[str, Any]

NEG_INF = -1e30


# --------------------------------------------------------------------------- #
# parameters                                                                  #
# --------------------------------------------------------------------------- #

def init_attention(gen, cfg, device) -> Params:
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    dt = _dtype(cfg.dtype)
    p: Params = {
        "wq": dense_init(gen, (d, h, hd), dt, device),
        "wk": dense_init(gen, (d, kv, hd), dt, device),
        "wv": dense_init(gen, (d, kv, hd), dt, device),
        "wo": dense_init(gen, (h, hd, d), dt, device),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((h, hd), dtype=dt, device=device)
        p["bk"] = torch.zeros((kv, hd), dtype=dt, device=device)
        p["bv"] = torch.zeros((kv, hd), dtype=dt, device=device)
    if cfg.qk_norm:
        p["q_norm"] = init_rmsnorm(hd, dt, device)
        p["k_norm"] = init_rmsnorm(hd, dt, device)
    return p


def qkv_project(x: torch.Tensor, p, cfg, positions: torch.Tensor,
                rope=None) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> q (B, S, H, hd), k/v (B, S, KV, hd): the bias, then
    qk-norm, then RoPE (``rope``: the positions' ``rope_table``)."""
    q = dense(x, p["wq"])                                 # bsd,dhk->bshk
    k = dense(x, p["wk"])
    v = dense(x, p["wv"])
    if "bq" in p:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    if "q_norm" in p:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    q = apply_rope(q, positions, cfg.rope_theta, rope)
    k = apply_rope(k, positions, cfg.rope_theta, rope)
    return q, k, v


def out_project(attn: torch.Tensor, p) -> torch.Tensor:
    return dense(attn, p["wo"], 2)                        # bshk,hkd->bsd


# --------------------------------------------------------------------------- #
# core attention math (GQA grouping)                                          #
# --------------------------------------------------------------------------- #

def _gqa_scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """q (B,Sq,KV,G,hd) x k (B,Sk,KV,hd) -> scores (B,KV,G,Sq,Sk) in f32."""
    return torch.einsum("bqkgd,bskd->bkgqs", q.to(F32), k.to(F32))


def _gqa_mix(w: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """w (B,KV,G,Sq,Sk) x v (B,Sk,KV,hd) -> (B,Sq,KV,G,hd)."""
    return torch.einsum("bkgqs,bskd->bqkgd", w, v.to(w.dtype))


def _split_groups(q: torch.Tensor, n_kv: int) -> torch.Tensor:
    b, s, h, d = q.shape
    return q.reshape(b, s, n_kv, h // n_kv, d)


def _merge_groups(x: torch.Tensor) -> torch.Tensor:
    b, s, kv, g, d = x.shape
    return x.reshape(b, s, kv * g, d)


def _causal(scores: torch.Tensor, q_offset: int) -> torch.Tensor:
    sq, sk = scores.shape[-2], scores.shape[-1]
    qpos = torch.arange(sq, device=scores.device) + q_offset
    kpos = torch.arange(sk, device=scores.device)
    mask = kpos[None, :] <= qpos[:, None]
    return torch.where(mask, scores, NEG_INF)


def attention_full(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   causal: bool = True, q_offset: int = 0) -> torch.Tensor:
    """Exact attention. q (B,Sq,H,hd), k/v (B,Sk,KV,hd) -> (B,Sq,H,hd)."""
    n_kv = k.shape[2]
    qg = _split_groups(q, n_kv)
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = _gqa_scores(qg, k) * scale                   # (B,KV,G,Sq,Sk)
    if causal:
        scores = _causal(scores, q_offset)
    w = torch.softmax(scores, dim=-1)
    out = _gqa_mix(w.to(v.dtype), v)
    return _merge_groups(out)


def attention_chunked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      chunk: int = 1024, causal: bool = True,
                      unroll: bool = False) -> torch.Tensor:
    """Query-chunked attention (self-attention, Sq == Sk): a loop over
    query blocks of ``chunk``, each against the whole key axis.  Falls
    back to :func:`attention_full` when ``s % chunk`` or ``s <= chunk``,
    as the reference does."""
    b, s, h, hd = q.shape
    if s % chunk != 0 or s <= chunk:
        return attention_full(q, k, v, causal=causal)
    n_kv = k.shape[2]
    qg = _split_groups(q, n_kv)                           # (B,S,KV,G,hd)
    n_chunks = s // chunk
    qg = qg.reshape(b, n_chunks, chunk, n_kv, h // n_kv, hd)
    qg = torch.movedim(qg, 1, 0)                          # (C,B,chunk,KV,G,hd)
    scale = 1.0 / math.sqrt(hd)

    def step(carry, xs):
        qc, off = xs
        scores = _gqa_scores(qc, k) * scale               # (B,KV,G,chunk,S)
        if causal:
            scores = _causal(scores, off)
        w = torch.softmax(scores, dim=-1)
        return carry, _gqa_mix(w.to(v.dtype), v)          # (B,chunk,KV,G,hd)

    offsets = [i * chunk for i in range(n_chunks)]
    _, outs = scan_or_unroll(step, None, (qg, offsets), unroll)
    outs = torch.movedim(outs, 0, 1)                      # (B,C,chunk,KV,G,hd)
    outs = outs.reshape(b, s, n_kv, h // n_kv, hd)
    return _merge_groups(outs)


def valid_positions(cache_len: torch.Tensor, s: int) -> torch.Tensor:
    """(B, S): the cache rows below each sequence's length."""
    return (torch.arange(s, device=cache_len.device)[None, :]
            < cache_len[:, None])


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cache_len: torch.Tensor,
                     valid=None) -> torch.Tensor:
    """One-token decode. q (B,1,H,hd); caches (B,S,KV,hd); cache_len (B,)
    valid prefix lengths (the new token's k/v must already be written);
    ``valid``: their ``valid_positions``, made once per decode step."""
    n_kv = k_cache.shape[2]
    qg = _split_groups(q, n_kv)
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = _gqa_scores(qg, k_cache) * scale             # (B,KV,G,1,S)
    if valid is None:
        valid = valid_positions(cache_len, k_cache.shape[1])
    scores = torch.where(valid[:, None, None, None, :], scores, NEG_INF)
    w = torch.softmax(scores, dim=-1)
    out = _gqa_mix(w.to(v_cache.dtype), v_cache)
    return _merge_groups(out)
