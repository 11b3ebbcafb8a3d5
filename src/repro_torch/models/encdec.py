"""Encoder-decoder transformer (seamless-m4t backbone); port of
``repro.models.encdec``.

Encoder: bidirectional self-attention over projected audio-frame
embeddings (the speech frontend is a stub — ``input_specs`` provides
precomputed fbank-stack features).  Decoder: causal self-attention +
cross-attention over encoder output.  The reference scans both stacks;
the port keeps one :class:`~repro_torch.models.layers.ParamTree` per
layer in ``enc_layers`` / ``dec_layers`` and loops.  Unless ``cfg.remat``
is ``"none"``, each layer of both stacks is recomputed in the backward
pass (``layers.remat``).

The decode cache holds the decoder's self-attention K/V (written in place
at ``len``) and the static cross K/V of ``enc_len`` rows, which a decode
step reads whole.  ``init_cache`` makes the cross K/V zeros of
``max_len`` rows, as the reference's model facade does, so a server that
never runs ``prefill`` cross-attends over zeros.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from . import attention as attn
from .hybrid import _aux
from .layers import (ParamTree, _dtype, apply_ffn, dense_init, embed_tokens,
                     init_embedding, init_ffn, init_rmsnorm, mm, remat,
                     rms_norm, unembed)

Params = Dict[str, Any]


def _init_enc_layer(gen, cfg, device) -> Params:
    dt = _dtype(cfg.dtype)
    return {
        "ln_attn": init_rmsnorm(cfg.d_model, dt, device),
        "attn": attn.init_attention(gen, cfg, device),
        "ln_ffn": init_rmsnorm(cfg.d_model, dt, device),
        "ffn": init_ffn(gen, cfg.d_model, cfg.d_ff, cfg.act, dt, device),
    }


def _init_dec_layer(gen, cfg, device) -> Params:
    dt = _dtype(cfg.dtype)
    return {
        "ln_self": init_rmsnorm(cfg.d_model, dt, device),
        "self_attn": attn.init_attention(gen, cfg, device),
        "ln_cross": init_rmsnorm(cfg.d_model, dt, device),
        "cross_attn": attn.init_attention(gen, cfg, device),
        "ln_ffn": init_rmsnorm(cfg.d_model, dt, device),
        "ffn": init_ffn(gen, cfg.d_model, cfg.d_ff, cfg.act, dt, device),
    }


def init_encdec(gen, cfg, device) -> ParamTree:
    dt = _dtype(cfg.dtype)
    e = cfg.encdec
    return ParamTree({
        "frontend_proj": dense_init(gen, (cfg.frontend.feature_dim,
                                          cfg.d_model), dt, device),
        "embed": init_embedding(gen, cfg.vocab_size, cfg.d_model, dt, device),
        "enc_layers": [_init_enc_layer(gen, cfg, device)
                       for _ in range(e.n_encoder_layers)],
        "dec_layers": [_init_dec_layer(gen, cfg, device)
                       for _ in range(e.n_decoder_layers)],
        "ln_enc": init_rmsnorm(cfg.d_model, dt, device),
        "ln_f": init_rmsnorm(cfg.d_model, dt, device),
        "unembed": dense_init(gen, (cfg.vocab_size, cfg.d_model), dt, device,
                              scale=0.02),
    })


def _positions(n: int, device) -> torch.Tensor:
    return torch.arange(n, device=device)[None, :]


def _enc_layer(x, lp, cfg, positions):
    h = rms_norm(x, lp["ln_attn"], cfg.norm_eps)
    q, k, v = attn.qkv_project(h, lp["attn"], cfg, positions)
    o = attn.attention_chunked(q, k, v, chunk=cfg.attn_chunk,
                               causal=False, unroll=cfg.unroll)
    x = x + attn.out_project(o, lp["attn"])
    h = rms_norm(x, lp["ln_ffn"], cfg.norm_eps)
    return x + apply_ffn(h, lp["ffn"], cfg.act)


def encode(params, cfg, features: torch.Tensor) -> torch.Tensor:
    """features: (B, S_enc, feat) -> (B, S_enc, D)."""
    x = mm(features, params["frontend_proj"]).to(_dtype(cfg.dtype))
    positions = _positions(x.shape[1], x.device)
    body = remat(_enc_layer, cfg, ("full", "dots"))
    for lp in params["enc_layers"]:
        x = body(x, lp, cfg, positions)
    return rms_norm(x, params["ln_enc"], cfg.norm_eps)


def _dec_layer_train(x, lp, cfg, enc_out, positions):
    """One decoder layer over the whole sequence; returns (x, (k, v, the
    cross k, the cross v))."""
    h = rms_norm(x, lp["ln_self"], cfg.norm_eps)
    q, k, v = attn.qkv_project(h, lp["self_attn"], cfg, positions)
    o = attn.attention_chunked(q, k, v, chunk=cfg.attn_chunk, causal=True,
                               unroll=cfg.unroll)
    x = x + attn.out_project(o, lp["self_attn"])
    h = rms_norm(x, lp["ln_cross"], cfg.norm_eps)
    qc, _, _ = attn.qkv_project(h, lp["cross_attn"], cfg, positions)
    _, kc, vc = attn.qkv_project(enc_out, lp["cross_attn"], cfg,
                                 _positions(enc_out.shape[1], x.device))
    oc = attn.attention_full(qc, kc, vc, causal=False)
    x = x + attn.out_project(oc, lp["cross_attn"])
    h = rms_norm(x, lp["ln_ffn"], cfg.norm_eps)
    return x + apply_ffn(h, lp["ffn"], cfg.act), (k, v, kc, vc)


def _decoder(params, cfg, batch):
    enc_out = encode(params, cfg, batch["features"])
    x = embed_tokens(batch["tokens"], params["embed"])
    positions = _positions(x.shape[1], x.device)
    body = remat(_dec_layer_train, cfg, ("full", "dots"))
    kvs = []
    for lp in params["dec_layers"]:
        x, kv = body(x, lp, cfg, enc_out, positions)
        kvs.append(kv)
    return rms_norm(x, params["ln_f"], cfg.norm_eps), kvs


def encdec_train_logits(params, cfg, batch) -> Tuple[torch.Tensor, Dict]:
    """batch: {'features': (B,S_enc,F), 'tokens': (B,S_dec)}."""
    x, _ = _decoder(params, cfg, batch)
    return unembed(x, params["unembed"]), _aux(batch["tokens"])


def encdec_init_cache(cfg, batch: int, max_len: int, enc_len: int,
                      device) -> Dict:
    dt = _dtype(cfg.dtype)
    l = cfg.encdec.n_decoder_layers
    kv, hd = cfg.n_kv_heads, cfg.resolved_head_dim

    def zeros(rows):
        return torch.zeros((l, batch, rows, kv, hd), dtype=dt, device=device)
    return {"k": zeros(max_len), "v": zeros(max_len),
            "xk": zeros(enc_len), "xv": zeros(enc_len),   # cross K/V (static)
            "len": torch.zeros((batch,), dtype=torch.int32, device=device)}


def encdec_prefill(params, cfg, batch):
    """Encode + decoder prompt pass; returns (last logits, cache)."""
    x, kvs = _decoder(params, cfg, batch)
    b, s = batch["tokens"].shape
    logits = unembed(x[:, -1:, :], params["unembed"])[:, 0]
    k, v, xk, xv = (torch.stack(parts, 0) for parts in zip(*kvs))
    return logits, {"k": k, "v": v, "xk": xk, "xv": xv,
                    "len": torch.full((b,), s, dtype=torch.int32,
                                      device=x.device)}


def encdec_decode_step(params, cfg, batch, cache):
    """One decoder token; cross-attention over the cached encoder K/V."""
    x = embed_tokens(batch["tokens"], params["embed"])
    cache_len = cache["len"]
    positions = cache_len[:, None]
    step = attn.decode_tables(cache_len, cache["k"].shape[2],
                              cfg.resolved_head_dim, cfg.rope_theta)
    enc_len = torch.full((x.shape[0],), cache["xk"].shape[2],
                         dtype=torch.int32, device=x.device)
    for l, lp in enumerate(params["dec_layers"]):
        h = rms_norm(x, lp["ln_self"], cfg.norm_eps)
        x = x + attn.self_attention_decode(h, lp["self_attn"], cfg,
                                           cache["k"][l], cache["v"][l],
                                           cache_len, step)
        h = rms_norm(x, lp["ln_cross"], cfg.norm_eps)
        qc, _, _ = attn.qkv_project(h, lp["cross_attn"], cfg, positions,
                                    step["rope"])
        oc = attn.decode_attention(qc, cache["xk"][l], cache["xv"][l],
                                   enc_len)
        x = x + attn.out_project(oc, lp["cross_attn"])
        h = rms_norm(x, lp["ln_ffn"], cfg.norm_eps)
        x = x + apply_ffn(h, lp["ffn"], cfg.act)
    x = rms_norm(x, params["ln_f"], cfg.norm_eps)
    return unembed(x, params["unembed"]), dict(cache, len=cache_len + 1)
