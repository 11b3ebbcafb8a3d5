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
  * ``"elastic"`` — :class:`~repro_torch.serving.elastic.
    ElasticShardedPagedKVCache`: the sharded cache with live
    ``resize(shards=)`` / ``fail_shard()`` hooks; shard-count changes
    migrate only moved prime blocks, shard losses recover by
    re-factorization on ``device``, and oracle parity holds across every
    event.

Two expert-cache backends for MoE workloads (``moe=``, default off):
``"vec"`` (:class:`~repro_torch.serving.expert_cache_vec.
VectorizedExpertCache`, array residency + table-driven co-fire discovery)
and ``"scalar"`` (the oracle :class:`~repro_torch.serving.expert_cache.
ExpertCache`).  Router feeds are dual-mode: with ``model=None`` the
router is a deterministic synthetic schedule
(:func:`synthetic_router_groups`), the load-generator mode
``repro_torch.cases.case_moe`` drives; with a MoE model from
:mod:`repro_torch.models`, each decode step's real top-k sets flow from
``apply_moe``'s router into the expert cache
(``Model.decode_step_router``).

``tenants=`` (an int or a :class:`~repro_torch.tenancy.TenantQoSConfig`)
selects the tenant-namespaced variant of every backend (per-tenant HBM
quotas, prefetch budgets and stats; requests carry a tenant id), and
``dedup=True`` on top of it the copy-on-write shared-prefix dedup variant
(:mod:`repro_torch.serving.dedup`), whose admissions are probed through
the batched gcd on ``device``.

On-device compute is the model's ``decode_step`` (a model of
:func:`repro_torch.models.build_model`, its parameters on the engine's
``device``): each admitted prompt is prefilled one token at a time
through decode steps of its slot, and each tick decodes one greedy token
for every live slot.  Pass ``model=None`` to run the engine as a pure
page-management load generator (deterministic stub tokens) — the mode
the serving benchmark drives to 100+ concurrent requests per step.
Paging never reads the tokens, so both modes give the same page counters
on the same prompts.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from .elastic import ElasticShardedPagedKVCache
from .expert_cache import ExpertCache
from .expert_cache_vec import VectorizedExpertCache
from .kv_cache import PagedKVCache
from .kv_cache_sharded import ShardedPagedKVCache
from .kv_cache_vec import VectorizedPagedKVCache

__all__ = ["Request", "ServingEngine", "make_kv_backend",
           "make_expert_backend", "synthetic_router_groups"]

#: stub-decode vocabulary (model=None load-generator mode)
_STUB_VOCAB = 32_000


def make_kv_backend(kv: str, *, hbm_pages: int, page_size: int,
                    prefetch_budget: int, shards: int = 2, mesh="auto",
                    tenants=None, max_bits: int = 62,
                    dedup: bool = False, device="cuda") -> PagedKVCache:
    """Construct a paged-KV cache backend by name — the backend registry
    every engine front-end shares (``ServingEngine`` and the
    continuous-batching :class:`~repro_torch.serving.slots.SlotMachine`).

    ``kv`` is one of ``"vec" | "scalar" | "sharded" | "elastic"``;
    ``tenants`` (an int or a :class:`~repro_torch.tenancy.TenantQoSConfig`)
    selects the tenant-namespaced variant of the same backend, and
    ``dedup=True`` (tenants mode only) the copy-on-write shared-prefix
    dedup variant on top of it.  ``max_bits > 63`` runs the registry in
    multi-limb wide mode; ``device`` is where the discovery kernels run."""
    if dedup:
        if tenants is None:
            raise ValueError("dedup=True needs tenants= mode (the shared "
                             "namespace is a tenant-namespace extension)")
        from .dedup import (DedupElasticShardedPagedKVCache, DedupOracle,
                            DedupShardedPagedKVCache,
                            DedupVectorizedPagedKVCache)
        classes = {"vec": DedupVectorizedPagedKVCache,
                   "scalar": DedupOracle,
                   "sharded": DedupShardedPagedKVCache,
                   "elastic": DedupElasticShardedPagedKVCache}
    elif tenants is not None:
        from repro_torch.tenancy.qos import (
            TenantedElasticShardedPagedKVCache, TenantedPagedKVCache,
            TenantedShardedPagedKVCache, TenantedVectorizedPagedKVCache)
        classes = {"vec": TenantedVectorizedPagedKVCache,
                   "scalar": TenantedPagedKVCache,
                   "sharded": TenantedShardedPagedKVCache,
                   "elastic": TenantedElasticShardedPagedKVCache}
    else:
        classes = {"vec": VectorizedPagedKVCache, "scalar": PagedKVCache,
                   "sharded": ShardedPagedKVCache,
                   "elastic": ElasticShardedPagedKVCache}
    if kv not in classes:
        raise ValueError(f"kv must be 'vec', 'scalar', 'sharded' or "
                         f"'elastic', got {kv!r}")
    kw = dict(hbm_pages=hbm_pages, page_size=page_size,
              prefetch_budget=prefetch_budget, max_bits=max_bits,
              device=device)
    if kv in ("sharded", "elastic"):
        kw.update(n_shards=shards, mesh=mesh)
    if tenants is not None:
        kw["qos"] = tenants
    return classes[kv](**kw)


def make_expert_backend(moe: Optional[str], *, moe_experts: int,
                        moe_slots: int, moe_prefetch_budget: int,
                        tenants=None, device="cuda"
                        ) -> Optional[ExpertCache]:
    """Construct an MoE expert-cache backend by name (``None`` disables
    the tier).  Shared by every engine front-end; ``device`` is where
    the vectorized cache's kernel discovery runs.  With ``tenants`` the
    tenant-partitioned variant splits its own slot budget evenly."""
    if moe is None:
        return None
    if tenants is not None and moe in ("vec", "scalar"):
        from repro_torch.tenancy.qos import (TenantedExpertCache,
                                             TenantedVectorizedExpertCache)
        cls = (TenantedVectorizedExpertCache if moe == "vec"
               else TenantedExpertCache)
        # a TenantQoSConfig sizes the KV cache's HBM pages; the
        # expert tier keeps the tenant count and splits its own
        # slot budget evenly
        moe_qos = tenants if isinstance(tenants, int) else tenants.n_tenants
        return cls(moe_experts, hbm_slots=moe_slots,
                   prefetch_budget=moe_prefetch_budget, qos=moe_qos,
                   device=device)
    if moe == "vec":
        return VectorizedExpertCache(moe_experts, hbm_slots=moe_slots,
                                     prefetch_budget=moe_prefetch_budget,
                                     device=device)
    if moe == "scalar":
        return ExpertCache(moe_experts, hbm_slots=moe_slots,
                           prefetch_budget=moe_prefetch_budget,
                           device=device)
    raise ValueError(f"moe must be None, 'vec' or 'scalar', got {moe!r}")


def synthetic_router_groups(moe_experts: int, moe_topk: int,
                            moe_groups: int, moe_seed: int = 0):
    """Deterministic synthetic-router group pool (model=None MoE mode):
    a fixed set of co-activation groups with zipf-skewed expert
    popularity.  Every engine front-end draws from the same pool, so a
    workload replayed across engines routes identically."""
    rng = np.random.default_rng(moe_seed)
    pop = 1.0 / np.arange(1, moe_experts + 1, dtype=np.float64)
    pop /= pop.sum()
    return [tuple(int(e) for e in rng.choice(
        moe_experts, size=min(moe_topk, moe_experts),
        replace=False, p=pop))
        for _ in range(max(1, moe_groups))]


@dataclass
class Request:
    req_id: int
    prompt: List[int]
    max_new_tokens: int = 32
    tenant: int = 0                # namespace id (tenants= mode; else 0)
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
                 moe: Optional[str] = None, moe_experts: int = 64,
                 moe_slots: int = 16, moe_topk: int = 4,
                 moe_prefetch_budget: int = 4, moe_groups: int = 16,
                 moe_seed: int = 0, tenants=None, max_bits: int = 62,
                 dedup: bool = False, obs=None, device="cuda"):
        self.model = model
        self.params = params
        self.max_batch = max_batch
        self.max_seq = max_seq
        # multi-tenant QoS mode: tenants= an int (even HBM split) or a
        # TenantQoSConfig; requests carry a tenant id and the cache
        # enforces per-tenant quotas with per-tenant PageStats / logs
        self.tenants = tenants
        # dedup=True (tenants mode): cross-tenant COW shared-prefix dedup
        self.dedup = bool(dedup)
        self.pages: PagedKVCache = make_kv_backend(
            kv, hbm_pages=hbm_pages, page_size=page_size,
            prefetch_budget=prefetch_budget, shards=shards, mesh=mesh,
            tenants=tenants, max_bits=max_bits, dedup=dedup, device=device)
        self.device = self.pages.device
        # MoE expert-weight tier; the router feed is the real model
        # router when the model is a MoE arch, a deterministic synthetic
        # schedule in load-generator mode
        model_moe = getattr(getattr(model, "cfg", None), "moe", None)
        if model_moe is not None:
            moe_experts, moe_topk = model_moe.n_experts, model_moe.top_k
        self.experts: Optional[ExpertCache] = make_expert_backend(
            moe, moe_experts=moe_experts, moe_slots=moe_slots,
            moe_prefetch_budget=moe_prefetch_budget, tenants=tenants,
            device=device)
        if (self.experts is not None and model is not None
                and getattr(model, "decode_step_router", None) is None):
            raise ValueError(
                "moe= needs router output: pass a MoE model (one with "
                "decode_step_router) or model=None for the synthetic-"
                "router load-generator mode")
        # synthetic router: drawn deterministically per (request,
        # position) — identical across cache backends AND engines
        self._moe_groups = (synthetic_router_groups(
            moe_experts, moe_topk, moe_groups, moe_seed)
            if self.experts is not None and model is None else None)
        self.queue: List[Request] = []
        self.slots: List[Optional[Request]] = [None] * max_batch
        self._router_decode = self.experts is not None and model is not None
        if model is not None:
            self.cache = model.init_cache(max_batch, max_seq,
                                          device=self.device)
            self._decode = (model.decode_step_router if self._router_decode
                            else model.decode_step)
        else:                       # page-management load-generator mode
            self.cache = None
            self._decode = None
        self._next_id = 0
        self.steps = 0
        self.peak_live = 0          # max concurrent requests in one step
        #: observability sink — None by default (inert); attaching one
        #: also wires the page/expert tiers into the same event stream
        self.obs = obs
        if obs is not None:
            self.pages.obs = obs
            if self.experts is not None:
                self.experts.obs = obs
        # pages of KV context each decode step demand-reads per request:
        # the last `reread_window` pages of the chain, oldest first (paged
        # attention touches the recent context window; 1 = tail only)
        self.reread_window = max(1, int(reread_window))

    # ------------------------------------------------------------------ #
    # elastic hooks (kv="elastic")                                        #
    # ------------------------------------------------------------------ #

    def _elastic_pages(self) -> ElasticShardedPagedKVCache:
        if not isinstance(self.pages, ElasticShardedPagedKVCache):
            raise ValueError("resize/fail_shard need kv='elastic'")
        return self.pages

    def resize(self, shards: int, mesh="auto"):
        """Live shard-count change mid-serve; returns the
        :class:`~repro_torch.sharding.reshard.ReshardPlan` (only moved
        blocks' registry slices migrate — placement and parity are
        untouched)."""
        return self._elastic_pages().resize(shards, mesh=mesh)

    def fail_shard(self, shard: int, recover: bool = True):
        """Inject a shard loss mid-serve.  With ``recover=True`` the
        dead shard's discovery state is immediately rebuilt by
        re-factorizing surviving composites (returns the
        :class:`~repro_torch.serving.elastic.RecoveryReport`); otherwise
        recovery happens automatically before the next decode step."""
        pages = self._elastic_pages()
        pages.fail_shard(shard)
        return pages.recover_shard(shard) if recover else None

    # ------------------------------------------------------------------ #

    def submit(self, prompt: Sequence[int], max_new_tokens: int = 32,
               tenant: int = 0) -> int:
        if tenant and self.tenants is None:
            raise ValueError("tenant ids need tenants= mode (pass "
                             "tenants=N or a TenantQoSConfig)")
        if self.tenants is not None:
            # validate HERE: failing later inside _admit would leave a
            # permanently-running slot holding an unregistered request
            n = self.pages.qos_config.n_tenants
            if not 0 <= int(tenant) < n:
                raise ValueError(f"tenant {tenant} out of range [0, {n})")
        rid = self._next_id
        self._next_id += 1
        self.queue.append(Request(rid, list(prompt), max_new_tokens,
                                  tenant=int(tenant),
                                  submit_t=time.monotonic()))
        return rid

    def _admit(self) -> None:
        """Fill free slots from the queue; register and prefill their
        prompts."""
        for i, slot in enumerate(self.slots):
            if slot is not None or not self.queue:
                continue
            req = self.queue.pop(0)
            req.state = "running"
            self.slots[i] = req
            if self.tenants is not None:
                self.pages.register_request(req.req_id, req.prompt,
                                            tenant=req.tenant)
            else:
                self.pages.register_request(req.req_id, req.prompt)
            if self.model is None:
                continue            # stub mode: no device KV to prefill
            # prefill this slot: feed prompt tokens through decode steps
            # (single-slot prefill keeps the engine simple)
            for tok in req.prompt:
                self._step_slot(i, tok)

    def _tokens(self, values: Dict[int, int]) -> torch.Tensor:
        """The decode batch's (B, 1) token column: ``values[slot]`` for
        the slots given, 0 elsewhere."""
        toks = np.zeros((self.max_batch, 1), np.int64)
        for i, tok in values.items():
            toks[i, 0] = tok
        return torch.from_numpy(toks).to(self.device)

    def _step_slot(self, i: int, token: int) -> int:
        """Advance slot i by one token; returns the argmax next token."""
        out = self._decode(self.params, {"tokens": self._tokens({i: token})},
                           self.cache)
        # router-decode models return a third router output; prefill
        # routing is not observed (the same simplification as the
        # single-slot prefill itself)
        logits, self.cache = out[0], out[1]
        # only slot i's cache_len must advance: every other slot's goes
        # back by one
        ln = self.cache["len"] - 1
        ln[i] += 1
        self.cache = dict(self.cache, len=ln)
        return int(torch.argmax(logits[i, -1]))

    def _stub_token(self, req: Request) -> int:
        """Deterministic pseudo-decode for model=None mode (independent
        of cache state, so vec/scalar engine runs stay comparable)."""
        return (req.req_id * 7919 + len(req.generated) * 104_729) % _STUB_VOCAB

    def _stub_expert_set(self, req: Request):
        """Deterministic synthetic router draw for model=None MoE mode:
        each (request, position) picks one of the engine's co-activation
        groups, so the workload has learnable co-fire structure and is
        identical across expert-cache backends."""
        g = (req.req_id * 7919 + len(req.generated) * 104_729) \
            % len(self._moe_groups)
        return self._moe_groups[g]

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

        router = None
        if self.model is not None:
            toks = self._tokens({
                i: (req.generated[-1] if req.generated else
                    (req.prompt[-1] if req.prompt else 0))
                for i, req in live})
            out = self._decode(self.params, {"tokens": toks}, self.cache)
            logits, self.cache = out[0], out[1]
            if self._router_decode:
                router = out[2].cpu().numpy()     # (n_moe_layers, B, K)
            # greedy: torch.argmax takes the first index on ties, as
            # np.argmax does
            nxt = torch.argmax(logits[:, -1], dim=-1).tolist()
            nxt_of = {i: int(nxt[i]) for i, _ in live}
        else:
            nxt_of = {i: self._stub_token(r) for i, r in live}

        if self.experts is not None:
            # the whole step's router output — every live slot, every MoE
            # layer — is ONE observe_routing + ONE activate_batch call;
            # with the vectorized cache that means zero per-expert
            # registry scans
            if router is not None:
                sets = [[int(e) for e in router[l, i]]
                        for i, _ in live for l in range(router.shape[0])]
            else:
                sets = [self._stub_expert_set(r) for _, r in live]
            self.experts.observe_routing(sets)
            self.experts.activate_batch(sets)

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
        if self.obs is not None and self.obs.telemetry is not None:
            self.obs.telemetry.tick_engine(self)
        self.steps += 1
        out = {"live": len(live), "page_stats": self.pages.stats}
        if self.experts is not None:
            out["expert_stats"] = self.experts.stats
        if self.tenants is not None:
            out["tenant_stats"] = self.pages.qos.tenant_stats
        return out

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
