"""Plain reference of a dense GQA decoder (Phi-3-medium): embedding, per
layer RMSNorm -> attention with interleaved RoPE -> residual -> RMSNorm ->
SwiGLU -> residual, final RMSNorm, untied unembedding; float32 throughout.

Weights by name: ``embed.table`` (V, D), ``layers.<l>.ln_attn.scale``,
``layers.<l>.attn.{wq,wk,wv}`` (D, heads, hd), ``layers.<l>.attn.wo``
(heads, hd, D), ``layers.<l>.ln_ffn.scale``, ``layers.<l>.ffn.{w_gate,
w_up}`` (D, F), ``w_down`` (F, D), ``ln_f.scale``, ``unembed`` (V, D).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from pfcs_bench.reference import (F32, attn_block, cache_positions, rms_norm,
                                  swiglu)

#: no state but the K/V cache: a call that does not advance a row's length
#: writes a K/V row that the row's next call overwrites before any other
#: call reads it, and changes nothing else, so only advancing calls matter
RECURRENT = False


def attention_layers(m: Dict) -> int:
    return m["n_layers"]


def matmul_params(m: Dict) -> int:
    """Weights a token multiplies by (the embedding is a lookup)."""
    d, h, kv, hd, f = (m["d_model"], m["n_heads"], m["n_kv_heads"],
                       m["head_dim"], m["d_ff"])
    per_layer = d * (h + 2 * kv) * hd + h * hd * d + 3 * d * f
    return m["n_layers"] * per_layer + m["vocab_size"] * d


def logits_at(w, m: Dict, slots: List[Dict], rows: int, wcast,
              block: int = 2048) -> List[torch.Tensor]:
    """For each slot ``{"tokens", "adv", "judge"}`` (its calls' tokens,
    whether each advanced the slot, the calls whose logits are wanted):
    the logits (len(judge), V) at those calls."""
    dev = w["embed.table"].device
    eps = m["norm_eps"]
    seqs = []
    for s in slots:
        keep = np.flatnonzero(s["adv"]) if not RECURRENT else \
            np.arange(len(s["adv"]))
        ln, vis = cache_positions(np.asarray(s["adv"])[keep], rows)
        where = {int(c): i for i, c in enumerate(keep)}
        seqs.append({"tok": torch.as_tensor(np.asarray(s["tokens"])[keep],
                                            device=dev).long(),
                     "pos": torch.as_tensor(ln, device=dev),
                     "vis": torch.as_tensor(vis, device=dev),
                     "judge": torch.as_tensor([where[int(c)]
                                               for c in s["judge"]],
                                              dtype=torch.long, device=dev)})
    sizes = [len(q["tok"]) for q in seqs]
    x = wcast(w["embed.table"])[torch.cat([q["tok"] for q in seqs])]
    for l in range(m["n_layers"]):
        p = f"layers.{l}."
        h = rms_norm(x, w[p + "ln_attn.scale"], eps)
        outs = [attn_block(hs, w, p + "attn.", m, q["pos"], q["vis"], wcast)
                for hs, q in zip(torch.split(h, sizes), seqs)]
        x = x + torch.cat(outs)
        h = rms_norm(x, w[p + "ln_ffn.scale"], eps)
        x = x + swiglu(h, wcast(w[p + "ffn.w_gate"]),
                       wcast(w[p + "ffn.w_up"]), wcast(w[p + "ffn.w_down"]))
    x = rms_norm(x, w["ln_f.scale"], eps)
    un = wcast(w["unembed"])
    out = []
    for xs, q in zip(torch.split(x, sizes), seqs):
        xj = xs[q["judge"]]
        out.append(torch.cat([xj[i:i + block] @ un.T
                              for i in range(0, xj.shape[0], block)])
                   if xj.shape[0] else xj.new_zeros((0, un.shape[0])))
    return out
