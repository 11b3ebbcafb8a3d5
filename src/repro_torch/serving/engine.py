"""Continuous-batching serving engine with PFCS-managed KV pages (port of
``repro.serving.engine``, load-generator mode).

Request lifecycle: submit -> (queued) -> decode slots -> complete.  The
engine keeps a fixed decode batch; finished slots are refilled from the
queue every step (continuous batching, vLLM-style).  The paged KV cache
decides page placement; each decode step first touches the pages the
batch will read — PFCS prefetch means the successor pages of every
active chain are already HBM-resident with zero false-positive traffic.

Three cache backends (``kv=``):

  * ``"vec"`` (default) — :class:`~repro_torch.serving.kv_cache_vec.
    VectorizedPagedKVCache`: array page tables + table-driven discovery,
    maintained incrementally at registration (it launches no kernel).
  * ``"scalar"`` — the oracle :class:`~repro_torch.serving.kv_cache.
    PagedKVCache`; bit-exact same counters, one §4.2 scan per page.
  * ``"sharded"`` — :class:`~repro_torch.serving.kv_cache_sharded.
    ShardedPagedKVCache`: prime-space partitioned state (``shards=N``),
    every registry change rebuilt through the divisibility, gcd and
    factorization kernels on ``device``; bit-exact against the oracle.

The engine runs with ``model=None``: a pure page-management load
generator with deterministic stub tokens, the mode the serving benchmark
drives.  Model decode, ``kv="elastic"``, tenants, dedup and the MoE
expert tier are still to port (ROADMAP.md A.14, A.9, A.11, A.12, A.10)
and raise ``NotImplementedError``.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence

from .kv_cache import PagedKVCache
from .kv_cache_sharded import ShardedPagedKVCache
from .kv_cache_vec import VectorizedPagedKVCache

__all__ = ["Request", "ServingEngine", "make_kv_backend"]

#: stub-decode vocabulary (model=None load-generator mode)
_STUB_VOCAB = 32_000


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet (ROADMAP.md {item})")


def check_not_ported(*, model=None, moe=None, tenants=None,
                     dedup: bool = False) -> None:
    """Raise ``NotImplementedError`` for a feature of ``repro``'s engines
    that the port does not have yet."""
    if model is not None:
        raise _not_ported("serving a model (model is not None)", "A.14")
    if moe is not None:
        raise _not_ported("the MoE expert tier (moe=)", "A.10")
    if dedup:
        raise _not_ported("cross-tenant dedup (dedup=)", "A.12")
    if tenants is not None:
        raise _not_ported("tenant namespaces (tenants=)", "A.11")


def make_kv_backend(kv: str, *, hbm_pages: int, page_size: int,
                    prefetch_budget: int, shards: int = 2, mesh="auto",
                    tenants=None, max_bits: int = 62,
                    dedup: bool = False, device="cuda") -> PagedKVCache:
    """Construct a paged-KV cache backend by name — the backend registry
    every engine front-end shares (``ServingEngine`` and the
    continuous-batching :class:`~repro_torch.serving.slots.SlotMachine`).

    ``kv`` is one of ``"vec" | "scalar" | "sharded"``; ``device`` is where
    the discovery kernels run."""
    check_not_ported(tenants=tenants, dedup=dedup)
    if kv == "vec":
        return VectorizedPagedKVCache(
            hbm_pages=hbm_pages, page_size=page_size,
            prefetch_budget=prefetch_budget, max_bits=max_bits,
            device=device)
    if kv == "scalar":
        return PagedKVCache(hbm_pages=hbm_pages, page_size=page_size,
                            prefetch_budget=prefetch_budget,
                            max_bits=max_bits, device=device)
    if kv == "sharded":
        return ShardedPagedKVCache(
            hbm_pages=hbm_pages, page_size=page_size,
            prefetch_budget=prefetch_budget, n_shards=shards, mesh=mesh,
            max_bits=max_bits, device=device)
    if kv == "elastic":
        raise _not_ported("kv='elastic'", "A.9")
    raise ValueError(f"kv must be 'vec', 'scalar', 'sharded' or "
                     f"'elastic', got {kv!r}")


@dataclass
class Request:
    req_id: int
    prompt: List[int]
    max_new_tokens: int = 32
    tenant: int = 0
    generated: List[int] = field(default_factory=list)
    state: str = "queued"          # queued | running | done
    submit_t: float = 0.0
    first_token_t: Optional[float] = None
    done_t: Optional[float] = None


class ServingEngine:
    def __init__(self, model=None, params=None, max_batch: int = 8,
                 max_seq: int = 512, page_size: int = 16,
                 hbm_pages: int = 256, greedy: bool = True,
                 kv: str = "vec", prefetch_budget: int = 4,
                 reread_window: int = 1, shards: int = 2, mesh="auto",
                 moe: Optional[str] = None, tenants=None,
                 max_bits: int = 62, dedup: bool = False, obs=None,
                 device="cuda"):
        check_not_ported(model=model, moe=moe, tenants=tenants, dedup=dedup)
        self.model = model
        self.params = params
        self.max_batch = max_batch
        self.max_seq = max_seq
        self.pages: PagedKVCache = make_kv_backend(
            kv, hbm_pages=hbm_pages, page_size=page_size,
            prefetch_budget=prefetch_budget, shards=shards, mesh=mesh,
            max_bits=max_bits, device=device)
        self.device = self.pages.device
        self.queue: List[Request] = []
        self.slots: List[Optional[Request]] = [None] * max_batch
        self._next_id = 0
        self.steps = 0
        self.peak_live = 0          # max concurrent requests in one step
        #: observability sink — None by default (inert); attaching one
        #: also wires the page tier into the same event stream
        self.obs = obs
        if obs is not None:
            self.pages.obs = obs
        # pages of KV context each decode step demand-reads per request:
        # the last `reread_window` pages of the chain, oldest first (paged
        # attention touches the recent context window; 1 = tail only)
        self.reread_window = max(1, int(reread_window))

    # ------------------------------------------------------------------ #
    # elastic hooks (kv="elastic")                                        #
    # ------------------------------------------------------------------ #

    def resize(self, shards: int, mesh="auto"):
        """Live shard-count change mid-serve (not ported yet)."""
        raise _not_ported("resize (kv='elastic')", "A.9")

    def fail_shard(self, shard: int, recover: bool = True):
        """Inject a shard loss mid-serve (not ported yet)."""
        raise _not_ported("fail_shard (kv='elastic')", "A.9")

    # ------------------------------------------------------------------ #

    def submit(self, prompt: Sequence[int], max_new_tokens: int = 32,
               tenant: int = 0) -> int:
        if tenant:
            raise _not_ported("tenant ids", "A.11")
        rid = self._next_id
        self._next_id += 1
        self.queue.append(Request(rid, list(prompt), max_new_tokens,
                                  submit_t=time.monotonic()))
        return rid

    def _admit(self) -> None:
        """Fill free slots from the queue; register their prompts."""
        for i, slot in enumerate(self.slots):
            if slot is not None or not self.queue:
                continue
            req = self.queue.pop(0)
            req.state = "running"
            self.slots[i] = req
            self.pages.register_request(req.req_id, req.prompt)

    def _stub_token(self, req: Request) -> int:
        """Deterministic pseudo-decode for model=None mode (independent
        of cache state, so vec/scalar engine runs stay comparable)."""
        return (req.req_id * 7919 + len(req.generated) * 104_729) % _STUB_VOCAB

    def step(self) -> Dict[str, Any]:
        """One engine tick: admit, decode one token for every live slot.

        Page placement for the WHOLE batch is a single ``touch_batch``
        call — with the vectorized cache that means bulk table-driven
        discovery; with the scalar oracle it degenerates to the per-page
        scan loop.
        """
        self._admit()
        live = [(i, r) for i, r in enumerate(self.slots) if r is not None]
        if not live:
            return {"live": 0}
        self.peak_live = max(self.peak_live, len(live))
        # touch the pages each live slot's decode reads (the last
        # reread_window pages of its chain, oldest first)
        touches = [(r.req_id, j)
                   for _, r in live
                   if (n := len(self.pages.chains.get(r.req_id) or ()))
                   for j in range(max(0, n - self.reread_window), n)]
        if touches:
            self.pages.touch_batch(touches)
        nxt_of = {i: self._stub_token(r) for i, r in live}

        now = time.monotonic()
        for i, req in live:
            req.generated.append(nxt_of[i])
            if req.first_token_t is None:
                req.first_token_t = now
            if len(req.generated) >= req.max_new_tokens:
                req.state = "done"
                req.done_t = now
                self.pages.release_request(req.req_id)
                self.slots[i] = None
        self.steps += 1
        return {"live": len(live), "page_stats": self.pages.stats}

    def run_until_idle(self, max_steps: int = 10_000) -> List[Request]:
        done: List[Request] = []
        for _ in range(max_steps):
            if not self.queue and all(s is None for s in self.slots):
                break
            before = [s for s in self.slots]
            self.step()
            for s in before:
                if s is not None and s.state == "done":
                    done.append(s)
        return done
