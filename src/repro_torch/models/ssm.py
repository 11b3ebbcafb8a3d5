"""Mamba-2 (SSD) block: chunked-scan training path + recurrent decode (port
of ``repro.models.ssm``).

Structure per arXiv:2405.21060 (state-space duality):

  in_proj -> [z | x | B | C | dt]; causal depthwise conv over (x,B,C);
  SSD with per-head scalar decay a_t = exp(dt_t * A_h); gated RMSNorm;
  out_proj.

The training path is the exact chunked algorithm: intra-chunk quadratic
attention-like term + inter-chunk recurrent state carried from chunk to
chunk in a loop (the (Q x Q) decay matrix is the only quadratic buffer
and never exceeds one chunk).  The decode path is the O(1) recurrence
``S <- a S + dt B x^T; y = C.S + D x`` over state ``(B, H, N, P)``.

The groups of ``B`` and ``C`` are shared by ``H / G`` consecutive heads
(``jnp.repeat``: :func:`torch.repeat_interleave`, not a tile), and
``softplus`` is ``jax.nn.softplus``'s ``logaddexp(x, 0)`` at every input
(PyTorch's switches to ``x`` above its threshold).
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from .layers import F32, _dtype, dense, dense_init, init_rmsnorm, rms_norm
from .unroll import scan_or_unroll

Params = Dict[str, Any]


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)`` with no threshold."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


def ssm_dims(cfg):
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    n_heads = d_inner // s.head_dim
    conv_dim = d_inner + 2 * s.n_groups * s.d_state
    return d_inner, n_heads, conv_dim


def init_mamba2(gen, cfg, device) -> Params:
    s = cfg.ssm
    d_inner, h, conv_dim = ssm_dims(cfg)
    dt = _dtype(cfg.dtype)
    d_in_proj = 2 * d_inner + 2 * s.n_groups * s.d_state + h
    return {
        "in_proj": dense_init(gen, (cfg.d_model, d_in_proj), dt, device),
        "conv_w": dense_init(gen, (s.d_conv, conv_dim), dt, device,
                             scale=0.5),
        "conv_b": torch.zeros((conv_dim,), dtype=dt, device=device),
        "A_log": torch.log(torch.linspace(1.0, 16.0, h, dtype=F32,
                                          device=device)),
        "D": torch.ones((h,), dtype=F32, device=device),
        "dt_bias": torch.zeros((h,), dtype=F32, device=device),
        "norm": init_rmsnorm(d_inner, dt, device),
        "out_proj": dense_init(gen, (d_inner, cfg.d_model), dt, device),
    }


def _split_proj(xz: torch.Tensor, cfg):
    s = cfg.ssm
    d_inner, h, _ = ssm_dims(cfg)
    gn = s.n_groups * s.d_state
    return torch.split(xz, [d_inner, d_inner, gn, gn, h], dim=-1)


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state=None):
    """Depthwise causal conv. x: (B,S,C), w: (K,C).  With ``state``
    ((B,K-1,C) trailing inputs) performs the streaming update and returns
    (y, new_state)."""
    k = w.shape[0]
    if state is None:
        state = torch.zeros((x.shape[0], k - 1, x.shape[2]), dtype=x.dtype,
                            device=x.device)
    xp = torch.cat([state, x], dim=1)
    # windowed dot: y_t = sum_k w_k * x_{t-K+1+k}, summed from 0 in order
    # as Python's sum() does in the reference
    ys = 0
    for i in range(k):
        ys = ys + xp[:, i:i + x.shape[1], :].to(F32) * w[i].to(F32)
    y = F.silu(ys + b.to(F32)).to(x.dtype)
    new_state = xp[:, xp.shape[1] - (k - 1):, :]
    return y, new_state


# --------------------------------------------------------------------------- #
# SSD core                                                                    #
# --------------------------------------------------------------------------- #

def ssd_chunked(x, dt, A, Bm, Cm, chunk: int, unroll: bool = False):
    """Exact SSD via chunked scan.

    x  : (B, S, H, P)   per-head inputs
    dt : (B, S, H)      softplus'd step sizes
    A  : (H,)           negative decay rates
    Bm : (B, S, G, N)   input maps (groups broadcast over heads)
    Cm : (B, S, G, N)   output maps
    -> y (B, S, H, P) float32
    """
    b, s, h, p = x.shape
    g, n = Bm.shape[2], Bm.shape[3]
    hg = h // g
    assert s % chunk == 0, (s, chunk)
    nc = s // chunk

    xdt = x.to(F32) * dt.to(F32)[..., None]        # dt premultiplied
    a = dt.to(F32) * A[None, None, :]              # (B,S,H) log-decay

    def rs(t, extra):  # (B,S,...) -> (nc, B, chunk, ...)
        return torch.movedim(t.reshape(b, nc, chunk, *extra), 1, 0)

    xc = rs(xdt, (h, p))
    ac = rs(a, (h,))
    Bc = rs(Bm.to(F32), (g, n))
    Cc = rs(Cm.to(F32), (g, n))
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                 device=x.device))

    def chunk_step(S_prev, inp):
        # (B,chunk,H,P), (B,chunk,H), (B,chunk,G,N) twice
        xk, ak, Bk, Ck = inp
        l = torch.cumsum(ak, dim=1)   # (B,chunk,H) cumulative log-decay
        ltot = l[:, -1, :]            # (B,H)
        # intra-chunk: scores[i,j] = exp(l_i - l_j) * (C_i . B_j), j <= i
        cb = torch.einsum("bign,bjgn->bgij", Ck, Bk)            # (B,G,Q,Q)
        cb = torch.repeat_interleave(cb, hg, dim=1)             # (B,H,Q,Q)
        lh = l.permute(0, 2, 1)                                 # (B,H,Q)
        decay = lh[:, :, :, None] - lh[:, :, None, :]           # l_i - l_j
        w = torch.where(mask[None, None], torch.exp(decay) * cb, 0.0)
        y_intra = torch.einsum("bhij,bjhp->bihp", w, xk)
        # inter-chunk: contribution of carried state, decayed to position i
        Ch_full = torch.repeat_interleave(Ck, hg, dim=2)        # (B,chunk,H,N)
        y_inter = torch.einsum("bihn,bhnp->bihp",
                               Ch_full * torch.exp(l)[..., None], S_prev)
        # new state: S = exp(ltot) S_prev + sum_j exp(ltot - l_j) B_j x_j^T
        wj = torch.exp(ltot[:, None, :] - l)                    # (B,chunk,H)
        Bh_full = torch.repeat_interleave(Bk, hg, dim=2)
        S_chunk = torch.einsum("bjhn,bjhp->bhnp", Bh_full * wj[..., None], xk)
        S_new = torch.exp(ltot)[..., None, None] * S_prev + S_chunk
        return S_new, y_intra + y_inter

    S0 = torch.zeros((b, h, n, p), dtype=F32, device=x.device)
    _, ys = scan_or_unroll(chunk_step, S0, (xc, ac, Bc, Cc), unroll)
    return torch.movedim(ys, 0, 1).reshape(b, s, h, p)


def ssd_recurrent_step(S, x_t, dt_t, A, B_t, C_t):
    """One decode step.  S: (B,H,N,P); x_t: (B,H,P); dt_t: (B,H);
    B_t/C_t: (B,G,N) -> (y (B,H,P), S_new)."""
    h = S.shape[1]
    hg = h // B_t.shape[1]
    a = torch.exp(dt_t.to(F32) * A[None, :])                    # (B,H)
    Bh = torch.repeat_interleave(B_t.to(F32), hg, dim=1)        # (B,H,N)
    Ch = torch.repeat_interleave(C_t.to(F32), hg, dim=1)
    xdt = x_t.to(F32) * dt_t.to(F32)[..., None]                 # (B,H,P)
    S_new = a[..., None, None] * S + torch.einsum("bhn,bhp->bhnp", Bh, xdt)
    y = torch.einsum("bhn,bhnp->bhp", Ch, S_new)
    return y, S_new


# --------------------------------------------------------------------------- #
# full block                                                                  #
# --------------------------------------------------------------------------- #

def _gated_out(y, z, xin, p, cfg):
    """``rms_norm(y * silu(z))`` then ``out_proj``, in the input's dtype."""
    y = rms_norm(y * F.silu(z.to(F32)).to(xin.dtype), p["norm"],
                 cfg.norm_eps)
    return dense(y, p["out_proj"])


def mamba2_block_train(xin: torch.Tensor, p, cfg) -> torch.Tensor:
    """(B,S,D) -> (B,S,D). Pre-norm residual handled by caller."""
    s_cfg = cfg.ssm
    d_inner, h, _ = ssm_dims(cfg)
    gn = s_cfg.n_groups * s_cfg.d_state
    z, x, B, C, dt = _split_proj(dense(xin, p["in_proj"]), cfg)
    xbc, _ = _causal_conv(torch.cat([x, B, C], dim=-1), p["conv_w"],
                          p["conv_b"])
    x, B, C = torch.split(xbc, [d_inner, gn, gn], dim=-1)
    b_, s_, _ = x.shape
    xh = x.reshape(b_, s_, h, s_cfg.head_dim)
    Bm = B.reshape(b_, s_, s_cfg.n_groups, s_cfg.d_state)
    Cm = C.reshape(b_, s_, s_cfg.n_groups, s_cfg.d_state)
    dt_s = softplus(dt.to(F32) + p["dt_bias"][None, None, :])
    A = -torch.exp(p["A_log"])
    y = ssd_chunked(xh, dt_s, A, Bm, Cm, s_cfg.chunk_size, unroll=cfg.unroll)
    y = y + xh.to(F32) * p["D"][None, None, :, None]
    y = y.reshape(b_, s_, d_inner).to(xin.dtype)
    return _gated_out(y, z, xin, p, cfg)


def mamba2_init_state(cfg, batch: int, dtype, device) -> Dict:
    s = cfg.ssm
    _, h, conv_dim = ssm_dims(cfg)
    return {
        "conv": torch.zeros((batch, s.d_conv - 1, conv_dim), dtype=dtype,
                            device=device),
        "ssm": torch.zeros((batch, h, s.d_state, s.head_dim), dtype=F32,
                           device=device),
    }


def mamba2_block_decode(xin: torch.Tensor, p, cfg, state: Dict
                        ) -> Tuple[torch.Tensor, Dict]:
    """xin: (B,1,D) one token; streaming conv + recurrent SSD."""
    s_cfg = cfg.ssm
    d_inner, h, _ = ssm_dims(cfg)
    gn = s_cfg.n_groups * s_cfg.d_state
    z, x, B, C, dt = _split_proj(dense(xin, p["in_proj"]), cfg)
    xbc, conv_state = _causal_conv(torch.cat([x, B, C], dim=-1),
                                   p["conv_w"], p["conv_b"],
                                   state=state["conv"])
    x, B, C = torch.split(xbc, [d_inner, gn, gn], dim=-1)
    b_ = x.shape[0]
    xh = x.reshape(b_, h, s_cfg.head_dim)
    Bm = B.reshape(b_, s_cfg.n_groups, s_cfg.d_state)
    Cm = C.reshape(b_, s_cfg.n_groups, s_cfg.d_state)
    dt_s = softplus(dt.reshape(b_, h).to(F32) + p["dt_bias"][None, :])
    A = -torch.exp(p["A_log"])
    y, ssm_state = ssd_recurrent_step(state["ssm"], xh, dt_s, A, Bm, Cm)
    y = y + xh.to(F32) * p["D"][None, :, None]
    y = y.reshape(b_, 1, d_inner).to(xin.dtype)
    return _gated_out(y, z, xin, p, cfg), {"conv": conv_state,
                                           "ssm": ssm_state}
