"""The plain reference: what the timed path should have produced, worked
out again in plain PyTorch and Python, importing nothing of the program.

- ``PageOracle``: the paged-KV tier's placement semantics (content-
  addressed pages, chain edges in registration order, an LRU HBM tier
  with a prefetch flag, host memory behind it, successor prefetch up to a
  budget), straight from the scheme's description: no primes, no
  registry scans, no kernels.
- ``KERNEL_REFS``: the PFCS kernels' results as whole-tensor arithmetic.
- The model math shared by the configurations' references
  (``configs/<name>.py``): RMSNorm, interleaved RoPE, GQA attention under
  the engine's cache semantics, SwiGLU.  Everything runs in float32 with
  TF32 off; the weights are the benchmark's own bfloat16 draws, widened.
"""

from __future__ import annotations

import math
from collections import OrderedDict
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

F32 = torch.float32

#: the page tier's counters that the program must reproduce exactly
PAGE_COUNTERS = ("hbm_hits", "host_hits", "misses", "prefetches",
                 "prefetch_hits", "evictions", "shared_prefix_pages")


# --------------------------------------------------------------------------- #
# the page tier                                                               #
# --------------------------------------------------------------------------- #

class PageOracle:
    """Page placement as the scheme defines it.

    A request's prompt maps onto pages of ``page_size`` tokens, a page
    identified by the whole prefix up to its end (equal prefixes share a
    page; ids in order of first appearance).  Consecutive pages of a chain
    form an edge, registered once.  A demand access hits HBM (LRU, capacity
    ``hbm_pages``), else comes from host memory, else is new; then every
    page joined to it by an edge, in edge registration order, that is not
    in HBM is prefetched into it, up to ``prefetch_budget`` pages.
    Overflowing HBM evicts the least recently used page to host memory."""

    def __init__(self, hbm_pages: int, page_size: int, prefetch_budget: int):
        self.cap = hbm_pages
        self.page_size = page_size
        self.budget = prefetch_budget
        self.content: Dict[Tuple[int, ...], int] = {}
        self.edges: Dict[int, List[int]] = {}
        self.edge_set = set()
        self.chains: Dict[int, List[int]] = {}
        self.hbm: "OrderedDict[int, bool]" = OrderedDict()
        self.host = set()
        self.stats = {k: 0 for k in PAGE_COUNTERS}
        self.prefetch_log: List[Tuple[int, int]] = []
        self.tiers: List[str] = []

    def register(self, rid: int, tokens: Sequence[int]) -> None:
        pages = []
        for end in range(self.page_size, len(tokens) + self.page_size,
                         self.page_size):
            key = tuple(tokens[:end])
            if key in self.content:
                self.stats["shared_prefix_pages"] += 1
            else:
                self.content[key] = len(self.content)
            pages.append(self.content[key])
        self.chains[rid] = pages
        for a, b in zip(pages, pages[1:]):
            e = frozenset((a, b))
            if a != b and e not in self.edge_set:
                self.edge_set.add(e)
                self.edges.setdefault(a, []).append(b)
                self.edges.setdefault(b, []).append(a)

    def release(self, rid: int) -> None:
        self.chains.pop(rid, None)

    def _insert(self, pid: int, prefetched: bool) -> None:
        self.host.discard(pid)
        self.hbm[pid] = prefetched
        self.hbm.move_to_end(pid)
        while len(self.hbm) > self.cap:
            old, _ = self.hbm.popitem(last=False)
            self.host.add(old)
            self.stats["evictions"] += 1

    def touch(self, rid: int, idx: int) -> None:
        pid = self.chains[rid][idx]
        if pid in self.hbm:
            if self.hbm[pid]:
                self.stats["prefetch_hits"] += 1
            self.hbm[pid] = False
            self.hbm.move_to_end(pid)
            self.stats["hbm_hits"] += 1
            self.tiers.append("hbm")
        elif pid in self.host:
            self.stats["host_hits"] += 1
            self._insert(pid, False)
            self.tiers.append("host")
        else:
            self.stats["misses"] += 1
            self._insert(pid, False)
            self.tiers.append("new")
        left = self.budget
        for succ in self.edges.get(pid, ()):
            if left <= 0:
                break
            if succ in self.hbm:
                continue
            self._insert(succ, True)
            self.stats["prefetches"] += 1
            self.prefetch_log.append((pid, succ))
            left -= 1


# --------------------------------------------------------------------------- #
# the PFCS kernels                                                            #
# --------------------------------------------------------------------------- #

def divisibility_mask(c: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """mask[i, j]: p[j] > 1 and p[j] divides c[i]."""
    pp = p[None, :]
    return ((c[:, None] % torch.where(pp > 0, pp, torch.ones_like(pp)))
            == 0) & (pp > 1)


def factorize_squarefree(c: torch.Tensor, p: torch.Tensor):
    """The mask, and each c[i] divided once by every dividing p[j]."""
    mask = divisibility_mask(c, p)
    prod = torch.ones_like(c)
    for j in range(p.shape[0]):         # exact integer products, column order
        prod = torch.where(mask[:, j], prod * p[j], prod)
    return mask, c // prod


def gcd(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise Euclid; gcd(x, 0) = x."""
    a, b = a.clone(), b.clone()
    while bool((b != 0).any()):
        nz = b != 0
        r = torch.where(nz, a % torch.where(nz, b, torch.ones_like(b)),
                        torch.zeros_like(a))
        a, b = torch.where(nz, b, a), r
    return a


KERNEL_REFS = {"divisibility_mask": divisibility_mask,
               "factorize_squarefree": factorize_squarefree,
               "gcd": gcd}


# --------------------------------------------------------------------------- #
# model math                                                                  #
# --------------------------------------------------------------------------- #

def no_tf32() -> None:
    """Float32 products in float32: TF32 would be a lower precision."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w.to(F32)


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotate interleaved pairs (x[..., 0::2], x[..., 1::2]) by pos * the
    inverse frequencies theta^(-2i/D).  x: (T, H, D); pos: (T,)."""
    d = x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, d, 2, dtype=torch.float64,
                                       device=x.device) / d)
    ang = (pos.to(torch.float64)[:, None] * inv).to(F32)[:, None, :]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., 0::2], x[..., 1::2]
    return torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                       -1).reshape(x.shape)


def cache_positions(adv: np.ndarray, rows: int):
    """For one cache row (a slot) driven by a sequence of model calls,
    ``adv[t]`` saying whether call t advanced its length: the length
    before each call (its RoPE position), and which earlier calls' K/V
    each call sees.

    Call t writes its K/V at row min(len_t, rows - 1) (a write at or past
    the end lands on the last row) and attends to the rows below
    len_t + 1, each holding what the last call at or before t wrote there.
    Returns ``(len (T,), visible (T, T) bool)``."""
    adv = np.asarray(adv, dtype=bool)
    t_n = adv.shape[0]
    ln = np.cumsum(adv) - adv
    row = np.minimum(ln, rows - 1)
    nxt = np.full(t_n, t_n, dtype=np.int64)   # next call writing the row
    last: Dict[int, int] = {}
    for t in range(t_n - 1, -1, -1):
        nxt[t] = last.get(int(row[t]), t_n)
        last[int(row[t])] = t
    t_i = np.arange(t_n)
    vis = ((t_i[None, :] <= t_i[:, None])
           & (t_i[:, None] < nxt[None, :])
           & (row[None, :] <= ln[:, None]))
    return ln, vis


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              visible: torch.Tensor) -> torch.Tensor:
    """q (T, H, D), k/v (T, KV, D); head h reads KV head h // (H / KV).
    ``visible`` (T, T): which calls' K/V each call sees."""
    t_n, h, d = q.shape
    g = h // k.shape[1]
    kk = k.repeat_interleave(g, dim=1)
    vv = v.repeat_interleave(g, dim=1)
    s = torch.einsum("thd,uhd->htu", q, kk) / math.sqrt(d)
    s = s.masked_fill(~visible[None], float("-inf"))
    return torch.einsum("htu,uhd->thd", torch.softmax(s, -1), vv)


def swiglu(x: torch.Tensor, wg, wu, wd) -> torch.Tensor:
    return (torch.nn.functional.silu(x @ wg.to(F32)) * (x @ wu.to(F32))) \
        @ wd.to(F32)


def attn_block(x: torch.Tensor, w, pre: str, m: Dict, pos: torch.Tensor,
               visible: torch.Tensor, wcast) -> torch.Tensor:
    """One self-attention sublayer's output for one slot's calls:
    x (T, D) already normed; weights ``pre + wq/wk/wv`` (D, H, hd) and
    ``pre + wo`` (H, hd, D)."""
    d, h, kv, hd = m["d_model"], m["n_heads"], m["n_kv_heads"], m["head_dim"]
    q = (x @ wcast(w[pre + "wq"]).reshape(d, h * hd)).reshape(-1, h, hd)
    k = (x @ wcast(w[pre + "wk"]).reshape(d, kv * hd)).reshape(-1, kv, hd)
    v = (x @ wcast(w[pre + "wv"]).reshape(d, kv * hd)).reshape(-1, kv, hd)
    q, k = rope(q, pos, m["rope_theta"]), rope(k, pos, m["rope_theta"])
    o = attention(q, k, v, visible)
    return o.reshape(-1, h * hd) @ wcast(w[pre + "wo"]).reshape(h * hd, d)


def widen(t: torch.Tensor) -> torch.Tensor:
    """The reference's weights: the bfloat16 draws exactly, in float32."""
    return t.to(F32)


def fp8_weights(t: torch.Tensor) -> torch.Tensor:
    """The control's weights: each matrix rounded to float8 e4m3 with one
    scale per output column (its largest magnitude to 448), in float32.
    Vectors (norm scales, biases, the SSM's per-head constants) stay."""
    if t.dim() < 2:
        return t.to(F32)
    f = t.to(F32)
    flat = f.reshape(-1, f.shape[-1])
    s = flat.abs().amax(0).clamp(min=1e-12) / 448.0
    q = (flat / s).to(torch.float8_e4m3fn).to(F32) * s
    return q.reshape(f.shape)
