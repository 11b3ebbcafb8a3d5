"""Plain reference of the Zamba2 hybrid as the port states it: a stack of
Mamba-2 layers (pre-RMSNorm, residual) with, after every
``shared_attn_every`` of them, one of ``n_shared_attn_blocks`` shared
transformer blocks (attention + SwiGLU, alternating, each application
with its own K/V cache), final RMSNorm, untied unembedding; float32.

Mamba-2 layer (arXiv:2405.21060): ``in_proj`` -> [z | x | B | C | dt];
depthwise causal conv (width ``d_conv``, bias) over [x | B | C] then
SiLU; dt = softplus(dt + dt_bias); per head h, with group g = h // (H/G):
S_t = exp(dt_t A_h) S_{t-1} + dt_t B_t x_t^T, y_t = C_t . S_t + D_h x_t,
A = -exp(A_log); y * silu(z), RMSNorm, ``out_proj``.  The recurrence is
evaluated in chunks by its closed form, exactly.

Weights by name: ``embed.table``, ``mamba_layers.<l>.ln.scale``,
``mamba_layers.<l>.mix.{in_proj, conv_w, conv_b, A_log, D, dt_bias,
norm.scale, out_proj}``, ``shared_blocks.<b>.{ln_attn.scale, attn.w*,
ln_ffn.scale, ffn.w_*}``, ``ln_f.scale``, ``unembed``.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from pfcs_bench.reference import (F32, attn_block, cache_positions, rms_norm,
                                  swiglu)

#: the Mamba state moves on every call, advancing or not (a single-slot
#: prefill step feeds every other row a 0 token), so every call counts
RECURRENT = True

_CHUNK = 64


def _groups(m: Dict) -> List[int]:
    k = m["shared_attn_every"]
    full, rem = divmod(m["n_layers"], k)
    return [k] * full + ([rem] if rem else [])


def attention_layers(m: Dict) -> int:
    return m["n_layers"] // m["shared_attn_every"]


def _ssm(m: Dict):
    s = m["ssm"]
    d_inner = s["expand"] * m["d_model"]
    return s, d_inner, d_inner // s["head_dim"]


def matmul_params(m: Dict) -> int:
    """Weights a token multiplies by: every Mamba layer's projections and
    conv taps, the shared block at each application, the unembedding."""
    d = m["d_model"]
    s, di, h = _ssm(m)
    gn = s["n_groups"] * s["d_state"]
    mamba = d * (2 * di + 2 * gn + h) + s["d_conv"] * (di + 2 * gn) + di * d
    hh, kv, hd, f = m["n_heads"], m["n_kv_heads"], m["head_dim"], m["d_ff"]
    block = d * (hh + 2 * kv) * hd + hh * hd * d + 3 * d * f
    return (m["n_layers"] * mamba + attention_layers(m) * block
            + m["vocab_size"] * d)


def _ssd(x, a, bm, cm, hg):
    """The recurrence over (S, T) rows in chunks of ``_CHUNK``: x (S,T,H,P)
    (dt already applied), dt*A log-decays a (S,T,H), B/C (S,T,G,N)."""
    s_n, t_n, h, p = x.shape
    n = bm.shape[-1]
    state = x.new_zeros((s_n, h, n, p))
    ys = []
    for c0 in range(0, t_n, _CHUNK):
        xc, ac = x[:, c0:c0 + _CHUNK], a[:, c0:c0 + _CHUNK]
        bc = bm[:, c0:c0 + _CHUNK].repeat_interleave(hg, dim=2)
        cc = cm[:, c0:c0 + _CHUNK].repeat_interleave(hg, dim=2)
        q = xc.shape[1]
        l = torch.cumsum(ac, 1)                               # (S,Q,H)
        lh = l.permute(0, 2, 1)                               # (S,H,Q)
        tri = torch.tril(torch.ones(q, q, dtype=torch.bool, device=x.device))
        dec = torch.where(tri, lh[..., :, None] - lh[..., None, :],
                          float("-inf")).exp()                # (S,H,Q,Q)
        cb = torch.einsum("sihn,sjhn->shij", cc, bc)
        y = torch.einsum("shij,sjhp->sihp", dec * cb, xc)
        y = y + torch.einsum("sihn,shnp->sihp", cc * l.exp()[..., None],
                             state)
        wj = (l[:, -1:, :] - l).exp()                         # (S,Q,H)
        state = (l[:, -1, :].exp()[..., None, None] * state
                 + torch.einsum("sjhn,sjhp->shnp", bc * wj[..., None], xc))
        ys.append(y)
    return torch.cat(ys, 1)


def _mamba(x, w, p, m, wcast):
    s, di, h = _ssm(m)
    gn = s["n_groups"] * s["d_state"]
    sl, t_n, _ = x.shape
    z, xs, bm, cm, dt = torch.split(x @ wcast(w[p + "in_proj"]),
                                    [di, di, gn, gn, h], -1)
    xbc = torch.cat([xs, bm, cm], -1)
    cw = wcast(w[p + "conv_w"])                               # (K, C)
    k = cw.shape[0]
    xp = torch.cat([xbc.new_zeros((sl, k - 1, xbc.shape[-1])), xbc], 1)
    conv = sum(xp[:, i:i + t_n] * cw[i] for i in range(k))
    xbc = F.silu(conv + wcast(w[p + "conv_b"]))
    xs, bm, cm = torch.split(xbc, [di, gn, gn], -1)
    dt = F.softplus(dt + w[p + "dt_bias"].to(F32))
    a_rate = -torch.exp(w[p + "A_log"].to(F32))
    xh = xs.reshape(sl, t_n, h, s["head_dim"])
    y = _ssd(xh * dt[..., None], dt * a_rate,
             bm.reshape(sl, t_n, s["n_groups"], s["d_state"]),
             cm.reshape(sl, t_n, s["n_groups"], s["d_state"]),
             h // s["n_groups"])
    y = y + xh * w[p + "D"].to(F32)[:, None]
    y = y.reshape(sl, t_n, di) * F.silu(z)
    y = rms_norm(y, w[p + "norm.scale"], m["norm_eps"])
    return y @ wcast(w[p + "out_proj"])


def logits_at(w, m: Dict, slots: List[Dict], rows: int, wcast,
              block: int = 2048) -> List[torch.Tensor]:
    """As ``phi3-medium-14b.logits_at``; every slot has every call."""
    dev = w["embed.table"].device
    eps = m["norm_eps"]
    pos, vis = [], []
    for s in slots:
        ln, v = cache_positions(np.asarray(s["adv"]), rows)
        pos.append(torch.as_tensor(ln, device=dev))
        vis.append(torch.as_tensor(v, device=dev))
    tok = torch.stack([torch.as_tensor(np.asarray(s["tokens"]), device=dev)
                       for s in slots]).long()
    x = wcast(w["embed.table"])[tok]                           # (S,T,D)
    off = 0
    for gi, gsize in enumerate(_groups(m)):
        for l in range(off, off + gsize):
            p = f"mamba_layers.{l}."
            x = x + _mamba(rms_norm(x, w[p + "ln.scale"], eps), w,
                           p + "mix.", m, wcast)
        off += gsize
        if gsize == m["shared_attn_every"]:
            p = f"shared_blocks.{gi % m['n_shared_attn_blocks']}."
            h = rms_norm(x, w[p + "ln_attn.scale"], eps)
            x = x + torch.stack([attn_block(h[i], w, p + "attn.", m, pos[i],
                                            vis[i], wcast)
                                 for i in range(len(slots))])
            h = rms_norm(x, w[p + "ln_ffn.scale"], eps)
            x = x + swiglu(h, wcast(w[p + "ffn.w_gate"]),
                           wcast(w[p + "ffn.w_up"]),
                           wcast(w[p + "ffn.w_down"]))
    x = rms_norm(x, w["ln_f.scale"], eps)
    un = wcast(w["unembed"])
    out = []
    for i, s in enumerate(slots):
        xj = x[i][torch.as_tensor(np.asarray(s["judge"], dtype=np.int64),
                                  device=dev)]
        out.append(torch.cat([xj[j:j + block] @ un.T
                              for j in range(0, xj.shape[0], block)])
                   if xj.shape[0] else xj.new_zeros((0, un.shape[0])))
    return out
