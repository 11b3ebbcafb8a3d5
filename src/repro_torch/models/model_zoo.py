"""Unified model facade: build any assigned architecture from its config
(port of ``repro.models.model_zoo``).

``build_model(cfg, device)`` returns a :class:`Model` whose methods run
eagerly on ``device`` (the card unless told ``"cpu"``):

  * ``init_params(rng)``                   — parameters (a seed or a
    ``torch.Generator`` on the model's device)
  * ``train_logits(params, batch)``        — (logits, aux)
  * ``prefill(params, batch)``             — (last logits, cache)
  * ``decode_step(params, batch, cache)``  — (logits, cache)
  * ``init_cache(batch, max_len)``         — decode cache
  * ``input_specs(shape)``                 — ``"meta"`` tensors standing in
    for every model input of an assignment shape (the reference's
    ``jax.ShapeDtypeStruct``: no allocation)

Every family is ported: ``dense``, ``vlm`` and ``moe`` (with or without
MLA; :mod:`.transformer`), ``hybrid`` (zamba2) and ``ssm`` (the xLSTM
stack; :mod:`.hybrid`) and ``audio`` (the encoder-decoder;
:mod:`.encdec`).  Modality frontends are STUBS per the assignment:
``input_specs`` provides precomputed patch and frame embeddings.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Union

import torch

from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.device import resolve_device

from . import encdec as encdec_mod
from . import hybrid as hybrid_mod
from . import transformer as tfm

__all__ = ["Model", "build_model", "count_params_analytic"]

Params = Any


# --------------------------------------------------------------------------- #
# analytic parameter counts (roofline MODEL_FLOPS = 6 N D)                     #
# --------------------------------------------------------------------------- #

def count_params_analytic(cfg: ArchConfig, active_only: bool = False) -> int:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    h, kv = cfg.n_heads, cfg.n_kv_heads
    glu = 3 if cfg.act in ("swiglu", "geglu") else 2

    def attn_params():
        if cfg.mla is not None:
            m = cfg.mla
            qk = m.qk_nope_head_dim + m.qk_rope_head_dim
            return (d * m.q_lora_rank + m.q_lora_rank * h * qk
                    + d * (m.kv_lora_rank + m.qk_rope_head_dim)
                    + m.kv_lora_rank * h * (m.qk_nope_head_dim + m.v_head_dim)
                    + h * m.v_head_dim * d)
        return d * h * hd + 2 * d * kv * hd + h * hd * d

    def dense_ffn(ff):
        return glu * d * ff

    total = cfg.vocab_size * d * (1 if cfg.tie_embeddings else 2)

    if cfg.family in ("dense", "vlm"):
        total += cfg.n_layers * (attn_params() + dense_ffn(cfg.d_ff))
        if cfg.family == "vlm":
            total += cfg.frontend.feature_dim * d + d * d
    elif cfg.family == "moe":
        m = cfg.moe
        nd = m.first_dense_layers
        per_moe = (attn_params() + d * m.n_experts
                   + ((m.top_k if active_only else m.n_experts)
                      * glu * d * m.d_ff_expert)
                   + glu * d * m.d_ff_shared * m.n_shared_experts)
        total += nd * (attn_params() + dense_ffn(cfg.d_ff))
        total += (cfg.n_layers - nd) * per_moe
    elif cfg.family == "audio":
        e = cfg.encdec
        enc = attn_params() + dense_ffn(cfg.d_ff)
        dec = 2 * attn_params() + dense_ffn(cfg.d_ff)
        total += e.n_encoder_layers * enc + e.n_decoder_layers * dec
        total += cfg.frontend.feature_dim * d
    elif cfg.family == "hybrid":
        s = cfg.ssm
        di = s.expand * d
        heads = di // s.head_dim
        mamba = (d * (2 * di + 2 * s.n_groups * s.d_state + heads)
                 + s.d_conv * (di + 2 * s.n_groups * s.d_state)
                 + di * d)
        total += cfg.n_layers * mamba
        total += cfg.n_shared_attn_blocks * (attn_params() + dense_ffn(cfg.d_ff))
    elif cfg.family == "ssm":
        x = cfg.xlstm
        di = int(x.proj_factor_mlstm * d)
        hd_i = di // cfg.n_heads
        mlstm = (d * 2 * di + x.conv_kernel * di + 3 * di * cfg.n_heads * hd_i
                 + 2 * di * cfg.n_heads + di * d)
        slstm = d * 4 * d + cfg.n_heads * (d // cfg.n_heads) * 4 * (d // cfg.n_heads) + d * d
        k = x.slstm_every
        n_s = cfg.n_layers // k
        total += (cfg.n_layers - n_s) * mlstm + n_s * slstm
    return int(total)


# --------------------------------------------------------------------------- #
# Model facade                                                                #
# --------------------------------------------------------------------------- #

def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


@dataclass
class Model:
    cfg: ArchConfig
    device: torch.device
    init_params: Callable           # (rng) -> params
    train_logits: Callable          # (params, batch) -> (logits, aux)
    prefill: Callable               # (params, batch) -> (last_logits, cache)
    decode_step: Callable           # (params, batch, cache) -> (logits, cache)
    init_cache: Callable            # (batch, max_len, device=None) -> cache
    #: MoE archs only: decode_step that also returns the stacked router
    #: top-k indices ((n_moe_layers, B, K) int32) — the PFCS
    #: expert-cache feed (repro_torch.serving)
    decode_step_router: Optional[Callable] = None

    # -- shape-only specs ---------------------------------------------------- #

    def input_specs(self, shape: ShapeSpec) -> Dict[str, Any]:
        """``"meta"`` tensors for the given assignment shape."""
        cfg = self.cfg
        b, s = shape.global_batch, shape.seq_len
        i32, f32 = torch.int32, torch.float32
        if shape.kind == "train" or shape.kind == "prefill":
            if cfg.family == "audio":
                return {"features": _meta((b, s, cfg.frontend.feature_dim),
                                          f32),
                        "tokens": _meta((b, s), i32)}
            if cfg.family == "vlm":
                npatch = cfg.frontend.n_positions
                return {"tokens": _meta((b, s - npatch), i32),
                        "patches": _meta((b, npatch,
                                          cfg.frontend.feature_dim), f32)}
            return {"tokens": _meta((b, s), i32)}
        # decode: one new token against a cache of length s
        return {"tokens": _meta((b, 1), i32)}

    def cache_specs(self, shape: ShapeSpec) -> Any:
        """Shape-only decode cache (``"meta"`` tensors)."""
        return self.init_cache(shape.global_batch, shape.seq_len,
                               device="meta")

    def param_specs(self, rng=None) -> Params:
        """Shape-only parameters (``"meta"`` tensors)."""
        del rng
        return init_fn(self.cfg)(None, self.cfg, "meta")


def _generator(rng: Union[int, torch.Generator], device) -> torch.Generator:
    if isinstance(rng, torch.Generator):
        return rng
    return torch.Generator(device=device).manual_seed(int(rng))


#: each family's (init, train_logits, prefill, decode_step, init_cache)
#: functions; ``init_cache`` takes (cfg, batch, max_len, device)
_FAMILIES = {
    "transformer": (tfm.init_params, tfm.train_logits, tfm.prefill,
                    tfm.decode_step, tfm.init_cache),
    "hybrid": (hybrid_mod.init_zamba, hybrid_mod.zamba_train_logits,
               hybrid_mod.zamba_prefill, hybrid_mod.zamba_decode_step,
               hybrid_mod.zamba_init_cache),
    "ssm": (hybrid_mod.init_xlstm_stack, hybrid_mod.xlstm_train_logits,
            hybrid_mod.xlstm_prefill, hybrid_mod.xlstm_decode_step,
            hybrid_mod.xlstm_init_cache),
    # the cross K/V get max_len rows too, as the reference's facade does
    "audio": (encdec_mod.init_encdec, encdec_mod.encdec_train_logits,
              encdec_mod.encdec_prefill, encdec_mod.encdec_decode_step,
              lambda cfg, b, m, device: encdec_mod.encdec_init_cache(
                  cfg, b, m, m, device)),
}


def _functions(cfg: ArchConfig):
    fam = cfg.family
    if fam in ("dense", "vlm", "moe"):
        return _FAMILIES["transformer"]
    if fam in _FAMILIES:
        return _FAMILIES[fam]
    raise ValueError(f"unknown family {fam!r}")


def init_fn(cfg: ArchConfig) -> Callable:
    """The family's parameter init: (generator, cfg, device) -> params."""
    return _functions(cfg)[0]


def build_model(cfg: ArchConfig, device="cuda") -> Model:
    """The model of ``cfg`` on ``device`` (``resolve_device``: raises
    without a card unless ``device="cpu"``)."""
    init, train, prefill, decode, cache = _functions(cfg)
    dev = resolve_device(device)
    return Model(
        cfg=cfg,
        device=dev,
        init_params=lambda rng: init(_generator(rng, dev), cfg, dev),
        train_logits=lambda p, b: train(p, cfg, b),
        prefill=lambda p, b: prefill(p, cfg, b),
        decode_step=lambda p, b, c: decode(p, cfg, b, c),
        init_cache=lambda b, m, device=None: cache(
            cfg, b, m, dev if device is None else device),
        decode_step_router=(
            (lambda p, b, c: tfm.decode_step_router(p, cfg, b, c))
            if cfg.moe is not None else None),
    )
