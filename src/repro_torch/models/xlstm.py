"""xLSTM blocks (arXiv:2405.04517): mLSTM (matrix memory, parallelizable)
and sLSTM (scalar memory, true recurrence); port of ``repro.models.xlstm``.

mLSTM training uses the paper's stabilized parallel form — a decay-gated
attention-like matrix D with exponential input gates and log-sigmoid
forget-gate cumsums; decode is the O(1) recurrence over (C, n, m) state.
sLSTM is inherently sequential (recurrent weight mixing) and trains by a
loop over time.

The stabilisers are the reference's: the running maximum ``m`` starts at
``-1e30`` and every denominator is ``max(|q . n|, exp(-m))``.

Simplifications vs the released stack (as the reference's): block-
internal LayerNorm/skip placement follows the paper figure but drops
learnable per-head out-norms; the sLSTM block uses a single projection
round instead of the 4/3-factor gated MLP sandwich.
"""

from __future__ import annotations

import math
from typing import Any, Dict

import torch
import torch.nn.functional as F

from .layers import F32, _dtype, dense, dense_init, init_rmsnorm, mm, rms_norm
from .ssm import _causal_conv, softplus
from .unroll import batch_local, scan_or_unroll

Params = Dict[str, Any]

#: the running maximum's start (``m`` of an empty state)
M_INIT = -1e30


def log_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.log_sigmoid``: ``-softplus(-x)``."""
    return -softplus(-x)


# --------------------------------------------------------------------------- #
# mLSTM                                                                       #
# --------------------------------------------------------------------------- #

def init_mlstm(gen, cfg, device) -> Params:
    x = cfg.xlstm
    d = cfg.d_model
    d_inner = int(x.proj_factor_mlstm * d)
    h = cfg.n_heads
    hd = d_inner // h
    dt = _dtype(cfg.dtype)
    return {
        "w_up": dense_init(gen, (d, 2 * d_inner), dt, device),   # [x_m | z]
        "conv_w": dense_init(gen, (x.conv_kernel, d_inner), dt, device,
                             scale=0.5),
        "conv_b": torch.zeros((d_inner,), dtype=dt, device=device),
        "wq": dense_init(gen, (d_inner, h, hd), dt, device),
        "wk": dense_init(gen, (d_inner, h, hd), dt, device),
        "wv": dense_init(gen, (d_inner, h, hd), dt, device),
        "w_igate": dense_init(gen, (d_inner, h), F32, device, scale=0.01),
        "w_fgate": dense_init(gen, (d_inner, h), F32, device, scale=0.01),
        "b_igate": torch.zeros((h,), dtype=F32, device=device),
        "b_fgate": torch.full((h,), 3.0, dtype=F32, device=device),  # remember
        "norm": init_rmsnorm(d_inner, dt, device),
        "w_down": dense_init(gen, (d_inner, d), dt, device),
    }


def _mlstm_qkv_gates(x_m, p):
    """x_m: (B,S,d_inner) post-conv features -> q,k,v (B,S,H,hd) float32,
    i,f (B,S,H)."""
    q, k, v = mm(x_m, p["wq"]), mm(x_m, p["wk"]), mm(x_m, p["wv"])
    xf = x_m.to(F32)
    ig = xf @ p["w_igate"] + p["b_igate"]
    fg = xf @ p["w_fgate"] + p["b_fgate"]
    return q, k, v, ig, fg


def _mlstm_rows(q, k, v, ig, fcum_q, fcum, mask):
    """Stabilized mLSTM outputs of the queries ``q`` (B,Sq,H,hd) against
    every key: ``score[i,j] = fcum_i - fcum_j + ig_j`` where ``mask``."""
    hd = q.shape[-1]
    score = (fcum_q[:, :, None, :] - fcum[:, None, :, :]
             + ig[:, None, :, :])                         # (B,Sq,Sk,H)
    score = torch.where(mask[None, :, :, None], score, -math.inf)
    m = torch.amax(score, dim=2, keepdim=True)            # (B,Sq,1,H)
    d_mat = torch.exp(score - m)                          # stabilized decays
    qk = torch.einsum("bihd,bjhd->bijh", q, k) / math.sqrt(hd)
    w = qk * d_mat                                        # (B,Sq,Sk,H)
    num = torch.einsum("bijh,bjhd->bihd", w, v)
    den = torch.maximum(torch.abs(torch.sum(w, dim=2)),
                        torch.exp(-m[:, :, 0, :]))        # (B,Sq,H)
    return num / den[..., None]


def mlstm_parallel(q, k, v, ig, fg):
    """Stabilized parallel mLSTM.

    q,k,v: (B,S,H,hd) f32; ig,fg: (B,S,H) raw gate pre-activations.
    Returns (B,S,H,hd).
    """
    s = q.shape[1]
    fcum = torch.cumsum(log_sigmoid(fg), dim=1)           # sum_{t<=i} log f_t
    mask = torch.tril(torch.ones((s, s), dtype=torch.bool, device=q.device))
    return _mlstm_rows(q, k, v, ig, fcum, fcum, mask)


def mlstm_chunked(q, k, v, ig, fg, chunk: int, unroll: bool = False):
    """Query-chunked stabilized parallel mLSTM (same math as
    ``mlstm_parallel``; O(chunk x S) working set by a loop over query
    chunks).  Falls back to the parallel form when ``S % chunk`` or
    ``S <= chunk``, as the reference does."""
    b, s, h, hd = q.shape
    if s % chunk != 0 or s <= chunk:
        return mlstm_parallel(q, k, v, ig, fg)
    fcum = torch.cumsum(log_sigmoid(fg), dim=1)           # (B,S,H)
    nc = s // chunk
    qc = torch.movedim(q.reshape(b, nc, chunk, h, hd), 1, 0)
    fq = torch.movedim(fcum.reshape(b, nc, chunk, h), 1, 0)
    offs = [i * chunk for i in range(nc)]
    keys = torch.arange(s, device=q.device)
    rows = torch.arange(chunk, device=q.device)

    def step(carry, inp):
        qi, fi, off = inp
        mask = keys[None, :] <= (rows + off)[:, None]
        return carry, _mlstm_rows(qi, k, v, ig, fi, fcum, mask)

    _, ys = scan_or_unroll(step, None, (qc, fq, offs), unroll)
    return torch.movedim(ys, 0, 1).reshape(b, s, h, hd)


def mlstm_recurrent_step(state, q, k, v, ig, fg):
    """One decode step.  state: dict(C (B,H,hd,hd), n (B,H,hd), m (B,H));
    q,k,v: (B,H,hd); ig,fg: (B,H).  Returns (y (B,H,hd), new state)."""
    C, n, m = state["C"], state["n"], state["m"]
    logf = log_sigmoid(fg)
    m_new = torch.maximum(logf + m, ig)
    f_sc = torch.exp(logf + m - m_new)[..., None]
    i_sc = torch.exp(ig - m_new)[..., None]
    hd = q.shape[-1]
    C_new = f_sc[..., None] * C + i_sc[..., None] * \
        torch.einsum("bhk,bhd->bhkd", k / math.sqrt(hd), v)
    n_new = f_sc * n + i_sc * k / math.sqrt(hd)
    num = torch.einsum("bhk,bhkd->bhd", q, C_new)
    den = torch.maximum(torch.abs(torch.einsum("bhk,bhk->bh", q, n_new)),
                        torch.exp(-m_new))
    return num / den[..., None], {"C": C_new, "n": n_new, "m": m_new}


def _mlstm_out(y, z, xin, p, cfg):
    """The cell's output (B,S,H,hd) float32 -> norm, gate, ``w_down``."""
    y = y.reshape(*y.shape[:2], -1).to(xin.dtype)
    y = rms_norm(y, p["norm"], cfg.norm_eps)
    y = y * F.silu(z.to(F32)).to(xin.dtype)
    return dense(y, p["w_down"])


def mlstm_block_train(xin, p, cfg):
    up = dense(xin, p["w_up"])
    x_m, z = torch.chunk(up, 2, dim=-1)
    x_c, _ = _causal_conv(x_m, p["conv_w"], p["conv_b"])
    q, k, v, ig, fg = _mlstm_qkv_gates(x_c, p)
    y = mlstm_chunked(q, k, v, ig, fg, cfg.attn_chunk, unroll=cfg.unroll)
    return _mlstm_out(y, z, xin, p, cfg)


def mlstm_init_state(cfg, batch: int, device) -> Dict:
    x = cfg.xlstm
    d_inner = int(x.proj_factor_mlstm * cfg.d_model)
    h = cfg.n_heads
    hd = d_inner // h
    return {
        "conv": torch.zeros((batch, x.conv_kernel - 1, d_inner),
                            dtype=_dtype(cfg.dtype), device=device),
        "C": torch.zeros((batch, h, hd, hd), dtype=F32, device=device),
        "n": torch.zeros((batch, h, hd), dtype=F32, device=device),
        "m": torch.full((batch, h), M_INIT, dtype=F32, device=device),
    }


def mlstm_block_decode(xin, p, cfg, state):
    up = dense(xin, p["w_up"])
    x_m, z = torch.chunk(up, 2, dim=-1)
    x_c, conv_state = _causal_conv(x_m, p["conv_w"], p["conv_b"],
                                   state=state["conv"])
    q, k, v, ig, fg = _mlstm_qkv_gates(x_c, p)
    cell = {"C": state["C"], "n": state["n"], "m": state["m"]}
    y, cell = mlstm_recurrent_step(cell, q[:, 0], k[:, 0], v[:, 0],
                                   ig[:, 0], fg[:, 0])
    return _mlstm_out(y[:, None], z, xin, p, cfg), {"conv": conv_state,
                                                    **cell}


# --------------------------------------------------------------------------- #
# sLSTM                                                                       #
# --------------------------------------------------------------------------- #

def init_slstm(gen, cfg, device) -> Params:
    d = cfg.d_model
    h = cfg.n_heads
    hd = d // h
    dt = _dtype(cfg.dtype)
    return {
        # input projection to 4 gates (i, f, z, o) per head
        "w_x": dense_init(gen, (d, h, 4 * hd), dt, device),
        # recurrent per-head mixing (block-diagonal R)
        "w_r": dense_init(gen, (h, hd, 4 * hd), dt, device, scale=0.05),
        "bias": torch.zeros((h, 4 * hd), dtype=F32, device=device),
        "norm": init_rmsnorm(d, dt, device),
        "w_out": dense_init(gen, (d, d), dt, device),
    }


def slstm_step(carry, gates_x, p):
    """carry: (h_prev (B,H,hd), c, n, m); gates_x: (B,H,4hd) input part."""
    h_prev, c_prev, n_prev, m_prev = carry
    rec = torch.einsum("bhk,hkg->bhg", h_prev.to(F32), p["w_r"].to(F32))
    z_all = gates_x.to(F32) + rec + p["bias"][None]
    i_raw, f_raw, z_raw, o_raw = torch.chunk(z_all, 4, dim=-1)
    logf = log_sigmoid(f_raw)
    m_new = torch.maximum(logf + m_prev, i_raw)
    i_sc = torch.exp(i_raw - m_new)
    f_sc = torch.exp(logf + m_prev - m_new)
    z_t = torch.tanh(z_raw)
    o_t = torch.sigmoid(o_raw)
    c_new = f_sc * c_prev + i_sc * z_t
    n_new = f_sc * n_prev + i_sc
    h_new = o_t * c_new / torch.clamp(n_new, min=1.0)
    return (h_new, c_new, n_new, m_new), h_new


def _slstm_out(y, xin, p, cfg):
    y = y.reshape(xin.shape).to(xin.dtype)
    y = rms_norm(y, p["norm"], cfg.norm_eps)
    return dense(y, p["w_out"])


def slstm_scan(gx, w_r, bias, h, c, n, m):
    """The sLSTM cell over time: ``gx`` (B,S,H,4hd) the gates' input
    part, (h, c, n, m) (each (B,H,hd)) the state it starts from.  Returns
    every step's ``h``, (B,S,H,hd)."""
    p = {"w_r": w_r, "bias": bias}
    _, hs = scan_or_unroll(lambda cr, g: slstm_step(cr, g, p), (h, c, n, m),
                           torch.movedim(gx, 1, 0))
    return torch.movedim(hs, 0, 1)


def slstm_block_train(xin, p, cfg):
    b, s, d = xin.shape
    state = slstm_init_state(cfg, b, xin.device)
    gx = mm(xin, p["w_x"])                                # (B,S,H,4hd)
    hs = batch_local(slstm_scan, (gx, p["w_r"], p["bias"], state["h"],
                                  state["c"], state["n"], state["m"]),
                     (0, None, None, 0, 0, 0, 0))
    return _slstm_out(hs, xin, p, cfg)


def slstm_init_state(cfg, batch: int, device) -> Dict:
    h = cfg.n_heads
    hd = cfg.d_model // h

    def z():
        return torch.zeros((batch, h, hd), dtype=F32, device=device)
    return {"h": z(), "c": z(), "n": z(),
            "m": torch.full((batch, h, hd), M_INIT, dtype=F32,
                            device=device)}


def slstm_block_decode(xin, p, cfg, state):
    gx = mm(xin, p["w_x"])[:, 0]                          # (B,H,4hd)
    carry = (state["h"], state["c"], state["n"], state["m"])
    (h_new, c_new, n_new, m_new), y = slstm_step(carry, gx, p)
    return _slstm_out(y, xin, p, cfg), {"h": h_new, "c": c_new, "n": n_new,
                                        "m": m_new}
