"""Hybrid and recurrent stacks: zamba2 (Mamba-2 + shared attention) and
xlstm (mLSTM/sLSTM interleave); port of ``repro.models.hybrid``.

zamba2 layout: ``n_layers`` Mamba-2 blocks; after every
``shared_attn_every`` Mamba layers one of ``n_shared_attn_blocks`` shared
transformer blocks (weights reused across applications, alternating) runs
on the residual stream.  Each *application* keeps its own KV cache.

xlstm layout: every ``slstm_every``-th block is an sLSTM; the rest are
mLSTM.

``cfg.remat == "full"`` recomputes each Mamba-2 layer and each mLSTM
block in the backward pass (``layers.remat``), as the reference
checkpoints those scan bodies only.

The reference stacks the Mamba layers (``mamba_layers``) and the mLSTM
blocks (``m_stack``) along a leading axis and scans them; the port keeps
one :class:`~repro_torch.models.layers.ParamTree` per layer in a list
under the same key and loops.  The decode caches keep the reference's
layout (one tensor stacked over layers per state) and are written in
place, as the transformer's are; the returned dict holds them with
``len`` advanced by one.

Both prefills return the *initial* recurrent state with ``len`` set to
the prompt's length, as the reference's do (its dry-run simplification):
``zamba_prefill``'s ``conv`` / ``ssm`` states stay zero, and
``xlstm_prefill``'s state is freshly initialised.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch

from . import attention as attn
from . import ssm as ssm_mod
from . import xlstm as xl
from .layers import (F32, ParamTree, _dtype, apply_ffn, dense_init,
                     embed_tokens, init_embedding, init_ffn, init_rmsnorm,
                     remat, rms_norm, unembed)

Params = Dict[str, Any]


def _aux(tokens: torch.Tensor) -> Dict:
    return {"aux_loss": torch.zeros((), dtype=F32, device=tokens.device),
            "loss_mask": torch.ones(tokens.shape, dtype=torch.bool,
                                    device=tokens.device),
            "targets": tokens}


# =========================================================================== #
# zamba2                                                                      #
# =========================================================================== #

def _zamba_groups(cfg) -> List[int]:
    """Sizes of Mamba runs between shared-attn applications."""
    k = cfg.shared_attn_every
    full, rem = divmod(cfg.n_layers, k)
    return [k] * full + ([rem] if rem else [])


def n_attn_applications(cfg) -> int:
    return len(_zamba_groups(cfg)[: cfg.n_layers // cfg.shared_attn_every])


def init_zamba(gen, cfg, device) -> ParamTree:
    dt = _dtype(cfg.dtype)
    return ParamTree({
        "embed": init_embedding(gen, cfg.vocab_size, cfg.d_model, dt, device),
        "mamba_layers": [{"ln": init_rmsnorm(cfg.d_model, dt, device),
                          "mix": ssm_mod.init_mamba2(gen, cfg, device)}
                         for _ in range(cfg.n_layers)],
        "shared_blocks": [
            {"ln_attn": init_rmsnorm(cfg.d_model, dt, device),
             "attn": attn.init_attention(gen, cfg, device),
             "ln_ffn": init_rmsnorm(cfg.d_model, dt, device),
             "ffn": init_ffn(gen, cfg.d_model, cfg.d_ff, cfg.act, dt,
                             device)}
            for _ in range(cfg.n_shared_attn_blocks)],
        "ln_f": init_rmsnorm(cfg.d_model, dt, device),
        "unembed": dense_init(gen, (cfg.vocab_size, cfg.d_model), dt, device,
                              scale=0.02),
    })


def _shared_block_train(x, sp, cfg, positions):
    """The shared transformer block over a whole sequence; also returns
    its k/v (the prefill's cache)."""
    h = rms_norm(x, sp["ln_attn"], cfg.norm_eps)
    q, k, v = attn.qkv_project(h, sp["attn"], cfg, positions)
    o = attn.attention_chunked(q, k, v, chunk=cfg.attn_chunk, causal=True,
                               unroll=cfg.unroll)
    x = x + attn.out_project(o, sp["attn"])
    h = rms_norm(x, sp["ln_ffn"], cfg.norm_eps)
    return x + apply_ffn(h, sp["ffn"], cfg.act), (k, v)


def _mamba_body(x, lp, cfg):
    h = rms_norm(x, lp["ln"], cfg.norm_eps)
    return x + ssm_mod.mamba2_block_train(h, lp["mix"], cfg)


def _zamba_forward(params, cfg, tokens):
    """Embed, the Mamba runs with the shared block after each full group,
    the final norm.  Returns (x (B,S,D), the applications' k and v)."""
    x = embed_tokens(tokens, params["embed"])
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    layers = params["mamba_layers"]
    body = remat(_mamba_body, cfg, ("full",))
    kv: List[Tuple[torch.Tensor, torch.Tensor]] = []
    off = 0
    for gi, gsize in enumerate(_zamba_groups(cfg)):
        for lp in layers[off:off + gsize]:
            x = body(x, lp, cfg)
        off += gsize
        if gsize == cfg.shared_attn_every:  # full group -> shared attn
            sp = params["shared_blocks"][gi % cfg.n_shared_attn_blocks]
            x, kv_i = _shared_block_train(x, sp, cfg, positions)
            kv.append(kv_i)
    return rms_norm(x, params["ln_f"], cfg.norm_eps), kv


def zamba_train_logits(params, cfg, batch):
    x, _ = _zamba_forward(params, cfg, batch["tokens"])
    return unembed(x, params["unembed"]), _aux(batch["tokens"])


def zamba_init_cache(cfg, batch: int, max_len: int, device) -> Dict:
    dt = _dtype(cfg.dtype)
    n_attn = cfg.n_layers // cfg.shared_attn_every
    kv, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    _, h, conv_dim = ssm_mod.ssm_dims(cfg)
    s = cfg.ssm
    return {
        "k": torch.zeros((n_attn, batch, max_len, kv, hd), dtype=dt,
                         device=device),
        "v": torch.zeros((n_attn, batch, max_len, kv, hd), dtype=dt,
                         device=device),
        "conv": torch.zeros((cfg.n_layers, batch, s.d_conv - 1, conv_dim),
                            dtype=dt, device=device),
        "ssm": torch.zeros((cfg.n_layers, batch, h, s.d_state, s.head_dim),
                           dtype=F32, device=device),
        "len": torch.zeros((batch,), dtype=torch.int32, device=device),
    }


def zamba_decode_step(params, cfg, batch, cache):
    """batch: {'tokens': (B,1)}; returns (logits (B,1,V), cache)."""
    x = embed_tokens(batch["tokens"], params["embed"])
    cache_len = cache["len"]
    step = attn.decode_tables(cache_len, cache["k"].shape[2],
                              cfg.resolved_head_dim, cfg.rope_theta)
    layers = params["mamba_layers"]
    off = 0
    for gi, gsize in enumerate(_zamba_groups(cfg)):
        for l in range(off, off + gsize):
            lp = layers[l]
            h = rms_norm(x, lp["ln"], cfg.norm_eps)
            o, st = ssm_mod.mamba2_block_decode(
                h, lp["mix"], cfg, {"conv": cache["conv"][l],
                                    "ssm": cache["ssm"][l]})
            cache["conv"][l] = st["conv"]
            cache["ssm"][l] = st["ssm"]
            x = x + o
        off += gsize
        if gsize == cfg.shared_attn_every:
            sp = params["shared_blocks"][gi % cfg.n_shared_attn_blocks]
            h = rms_norm(x, sp["ln_attn"], cfg.norm_eps)
            x = x + attn.self_attention_decode(
                h, sp["attn"], cfg, cache["k"][gi], cache["v"][gi],
                cache_len, step)
            h = rms_norm(x, sp["ln_ffn"], cfg.norm_eps)
            x = x + apply_ffn(h, sp["ffn"], cfg.act)
    x = rms_norm(x, params["ln_f"], cfg.norm_eps)
    return unembed(x, params["unembed"]), dict(cache, len=cache_len + 1)


def zamba_prefill(params, cfg, batch):
    """Prompt pass: the train forward, the shared blocks' k/v as the
    cache; the ``conv`` / ``ssm`` states are the initial ones (the
    reference's, ROADMAP.md queue C item 5)."""
    tokens = batch["tokens"]
    b, s = tokens.shape
    x, kv = _zamba_forward(params, cfg, tokens)
    logits = unembed(x[:, -1:, :], params["unembed"])[:, 0]
    cache = zamba_init_cache(cfg, b, s, x.device)
    if kv:
        cache["k"] = torch.stack([k for k, _ in kv], 0)
        cache["v"] = torch.stack([v for _, v in kv], 0)
    cache["len"] = torch.full((b,), s, dtype=torch.int32, device=x.device)
    return logits, cache


# =========================================================================== #
# xLSTM stack                                                                 #
# =========================================================================== #

def _xlstm_runs(cfg) -> List[Tuple[str, int]]:
    """[('m', run_len) | ('s', 1), ...] covering n_layers blocks."""
    k = cfg.xlstm.slstm_every
    runs: List[Tuple[str, int]] = []
    i = 0
    while i < cfg.n_layers:
        # blocks i..: (k-1) mLSTM then 1 sLSTM
        m_run = min(k - 1, cfg.n_layers - i)
        if m_run:
            runs.append(("m", m_run))
            i += m_run
        if i < cfg.n_layers:
            runs.append(("s", 1))
            i += 1
    return runs


def _xlstm_counts(cfg) -> Tuple[int, int]:
    runs = _xlstm_runs(cfg)
    return (sum(r for t, r in runs if t == "m"),
            sum(r for t, r in runs if t == "s"))


def init_xlstm_stack(gen, cfg, device) -> ParamTree:
    dt = _dtype(cfg.dtype)
    n_m, n_s = _xlstm_counts(cfg)
    return ParamTree({
        "embed": init_embedding(gen, cfg.vocab_size, cfg.d_model, dt, device),
        "m_stack": [{"ln": init_rmsnorm(cfg.d_model, dt, device),
                     "cell": xl.init_mlstm(gen, cfg, device)}
                    for _ in range(n_m)],
        "s_blocks": [{"ln": init_rmsnorm(cfg.d_model, dt, device),
                      "cell": xl.init_slstm(gen, cfg, device)}
                     for _ in range(n_s)],
        "ln_f": init_rmsnorm(cfg.d_model, dt, device),
        "unembed": dense_init(gen, (cfg.vocab_size, cfg.d_model), dt, device,
                              scale=0.02),
    })


def _mlstm_body(x, lp, cfg):
    h = rms_norm(x, lp["ln"], cfg.norm_eps)
    return x + xl.mlstm_block_train(h, lp["cell"], cfg)


def xlstm_train_logits(params, cfg, batch):
    x = embed_tokens(batch["tokens"], params["embed"])
    m_body = remat(_mlstm_body, cfg, ("full",))
    m_off, s_off = 0, 0
    for kind, run in _xlstm_runs(cfg):
        if kind == "m":
            for lp in params["m_stack"][m_off:m_off + run]:
                x = m_body(x, lp, cfg)
            m_off += run
        else:
            sp = params["s_blocks"][s_off]
            h = rms_norm(x, sp["ln"], cfg.norm_eps)
            x = x + xl.slstm_block_train(h, sp["cell"], cfg)
            s_off += 1
    x = rms_norm(x, params["ln_f"], cfg.norm_eps)
    return unembed(x, params["unembed"]), _aux(batch["tokens"])


def xlstm_init_cache(cfg, batch: int, max_len: int, device) -> Dict:
    del max_len
    n_m, n_s = _xlstm_counts(cfg)

    def stack(tree, n):
        return {k: v[None].repeat(n, *([1] * v.dim()))
                for k, v in tree.items()}
    return {"m": stack(xl.mlstm_init_state(cfg, batch, device), n_m),
            "s": stack(xl.slstm_init_state(cfg, batch, device), max(n_s, 1)),
            "len": torch.zeros((batch,), dtype=torch.int32, device=device)}


def _write_state(stacked: Dict, index: int, state: Dict) -> None:
    for key, value in state.items():
        stacked[key][index] = value


def xlstm_decode_step(params, cfg, batch, cache):
    """batch: {'tokens': (B,1)}; returns (logits (B,1,V), cache)."""
    x = embed_tokens(batch["tokens"], params["embed"])
    m_off, s_off = 0, 0
    for kind, run in _xlstm_runs(cfg):
        if kind == "m":
            for l in range(m_off, m_off + run):
                lp = params["m_stack"][l]
                h = rms_norm(x, lp["ln"], cfg.norm_eps)
                o, st = xl.mlstm_block_decode(
                    h, lp["cell"], cfg, {k: v[l] for k, v in
                                         cache["m"].items()})
                _write_state(cache["m"], l, st)
                x = x + o
            m_off += run
        else:
            sp = params["s_blocks"][s_off]
            h = rms_norm(x, sp["ln"], cfg.norm_eps)
            o, st = xl.slstm_block_decode(
                h, sp["cell"], cfg, {k: v[s_off] for k, v in
                                     cache["s"].items()})
            _write_state(cache["s"], s_off, st)
            x = x + o
            s_off += 1
    x = rms_norm(x, params["ln_f"], cfg.norm_eps)
    return (unembed(x, params["unembed"]),
            dict(cache, len=cache["len"] + 1))


def xlstm_prefill(params, cfg, batch):
    """Prompt pass for the recurrent stack: the parallel forward's last
    logits and a freshly initialised state with ``len`` at the prompt's
    length (the reference's, ROADMAP.md queue C item 5)."""
    logits, _ = xlstm_train_logits(params, cfg, batch)
    b, s = batch["tokens"].shape
    cache = xlstm_init_cache(cfg, b, s, logits.device)
    cache["len"] = torch.full((b,), s, dtype=torch.int32,
                              device=logits.device)
    return logits[:, -1], cache
