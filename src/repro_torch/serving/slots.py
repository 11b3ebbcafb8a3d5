"""Continuous-batching slot machine: prefill/decode disaggregation with
open-loop async admission over PFCS-managed KV pages (DESIGN.md §10).

``ServingEngine`` refills free slots from a closed queue and models no
prefill cost — fine for cache-parity work, blind to *arrival-process
shape*, which queueing theory says dominates hit-rate and latency
behavior.  This module is the JetStream-style front-end that makes the
serving stack measurable under realistic ragged traffic:

**Slot state as int32 arrays.**  ``phase`` (FREE/PREFILL/DECODE),
``slot_req``, ``age`` (ticks in the current phase), ``prefill_done``,
``gen``, ``need_prompt``/``need_new``/``chain_len`` are parallel arrays
of width ``max_batch``.  One engine tick is pure array arithmetic —
decode masks, chunked-prefill budget distribution (a ``cumsum``),
completion masks, token values — with **no per-slot Python branching in
the hot loop**; Python appears only at the cache-API boundary
(``register_request`` / ``release_request`` per request lifecycle
event, ONE ``touch_batch`` per tick).

**Prefill → insert-into-slot → batched decode.**  An admitted request
occupies a slot in PREFILL; each tick a shared ``prefill_tokens``
budget is distributed greedily in slot order (Sarathi-style chunking:
a long prompt streams across ticks without blocking the batch, several
short prompts batch into one tick's budget).  When its last prompt
token lands the slot flips to DECODE and emits one token per tick.
Admission is **asynchronous**: requests arrive on an open-loop clock
(``submit(..., arrival=tick)``) and enter any tick a slot frees — no
batch boundary.  The ``policy="lockstep"`` gate degrades the same
machine to the synchronous fixed-width loop (admission only when ALL
slots are free — the static-batching baseline the benchmark beats).

**Eviction/resume via factorization-recovered chains.**  Under queue
pressure (head-of-queue wait >= ``preempt_wait``) the machine preempts
the decode slot with the most remaining work — among slots that have
held their slot for at least one decode tick, a minimum quantum that
makes FIFO re-queue livelock-free; its pages cool off in
the cache's LRU while it re-queues.  On re-admission, *before the slot
re-enters decode*, the engine touches one resume anchor — the page
just ahead of the decode reread window — whose §4.2 divisibility scan
recovers the request's successor chain by factorization and prefetches
the window pages back host→HBM.  The resumed slot's first decode tick
then runs on prefetch hits instead of demand stalls (the resume-
prefetch invariant, DESIGN.md §10).

Two implementations, differentially fuzzed against each other
(``tests/test_serving_batching.py``):

  * :class:`SlotMachine` — the vectorized array-state engine above;
  * :class:`SlotOracle`  — the same scheduling semantics as per-slot
    Python loops over request objects (the lockstep oracle): bit-exact
    on every ``PARITY_COUNTERS`` field, per-touch tier, HBM LRU order,
    and prefetch log when driven on the same arrival trace.

Both compose with every cache backend (``kv="vec" | "scalar" |
"sharded" | "elastic"``, ``moe=``, ``tenants=``, ``dedup=``, with
``device`` placing the discovery kernels) through the shared factories in
``engine.py``; ``kv="elastic"`` exposes the same ``resize`` /
``fail_shard`` chaos hooks as ``ServingEngine``.  With ``dedup=True`` an
admitted request's leading shared-prefix run is already-computed
read-only content, so both machines skip its prefill
(``_register_admitted``).  Port of ``repro.serving.slots``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.obs.trace import (EV_ADMIT, EV_COMPLETE, EV_PREEMPT,
                                   EV_PREFILL_CHUNK, EV_RESUME_PREFETCH)

from .elastic import ElasticShardedPagedKVCache
from .engine import (_STUB_VOCAB, make_expert_backend, make_kv_backend,
                     synthetic_router_groups)

__all__ = ["SlotRequest", "SlotMachine", "SlotOracle",
           "PHASE_FREE", "PHASE_PREFILL", "PHASE_DECODE",
           "poisson_arrival_ticks"]

PHASE_FREE, PHASE_PREFILL, PHASE_DECODE = 0, 1, 2


def poisson_arrival_ticks(n: int, rate: float, seed: int = 0,
                          burst_frac: float = 0.0,
                          silence_ticks: int = 0) -> np.ndarray:
    """Open-loop Poisson arrival schedule: ``n`` integer arrival ticks
    with exponential inter-arrival times at ``rate`` requests/tick.
    ``burst_frac`` front-loads that fraction of requests at tick 0 and
    inserts ``silence_ticks`` of dead air after the burst (the
    burst-then-silence adversarial shape)."""
    rng = np.random.default_rng(seed)
    n_burst = int(round(n * burst_frac))
    tail = n - n_burst
    gaps = rng.exponential(1.0 / max(rate, 1e-9), size=tail)
    ticks = np.floor(np.cumsum(gaps)).astype(np.int64) if tail else \
        np.zeros(0, np.int64)
    if n_burst:
        ticks = np.concatenate([np.zeros(n_burst, np.int64),
                                ticks + silence_ticks])
    return ticks


@dataclass
class SlotRequest:
    """One open-loop request: prompt + decode demand with an arrival
    tick; all timing fields are integer engine ticks."""
    req_id: int
    prompt: List[int]
    max_new_tokens: int = 8
    tenant: int = 0
    arrival: int = 0
    state: str = "queued"        # queued | waiting | prefill | decode | done
    generated: List[int] = field(default_factory=list)
    prefill_done: int = 0        # prompt tokens prefilled so far
    requeue_tick: int = 0        # when it last entered the waiting queue
    first_tick: Optional[int] = None   # tick of the first decoded token
    done_tick: Optional[int] = None
    preemptions: int = 0
    was_preempted: bool = False  # pending resume-prefetch on re-admission

    @property
    def n_prompt(self) -> int:
        return len(self.prompt)

    def ttft(self) -> Optional[int]:
        return None if self.first_tick is None \
            else self.first_tick - self.arrival

    def tpot(self) -> Optional[float]:
        if self.done_tick is None or self.first_tick is None:
            return None
        return (self.done_tick - self.first_tick) \
            / max(1, len(self.generated) - 1)


def _stub_tokens(req_id: int, n: int) -> List[int]:
    """The engine's deterministic pseudo-decode stream (identical to
    ``ServingEngine._stub_token`` so traces are comparable across
    engines)."""
    return [(req_id * 7919 + i * 104_729) % _STUB_VOCAB for i in range(n)]


def _ranges(starts: np.ndarray, stops: np.ndarray):
    """Vectorized ``concatenate([arange(a, b) for a, b in zip(...)])``:
    returns (row_repeat, values) with rows in input order and values
    ascending within each row — the touch-list construction primitive
    (no per-slot Python loop)."""
    counts = np.maximum(stops - starts, 0).astype(np.int64)
    total = int(counts.sum())
    if total == 0:
        z = np.zeros(0, np.int64)
        return z, z
    rows = np.repeat(np.arange(len(starts), dtype=np.int64), counts)
    excl = np.cumsum(counts) - counts
    pos = np.arange(total, dtype=np.int64) - np.repeat(excl, counts)
    return rows, np.repeat(starts.astype(np.int64), counts) + pos


class _SlotFrontEnd:
    """Shared non-hot-path plumbing: backend construction, open-loop
    submission, elastic passthrough, and end-of-run reporting.  The
    per-tick scheduling itself is implemented twice — as array math in
    :class:`SlotMachine` and as per-slot loops in :class:`SlotOracle` —
    and the two are differentially fuzzed against each other."""

    policy_choices = ("continuous", "lockstep")

    def __init__(self, max_batch: int = 8, page_size: int = 16,
                 hbm_pages: int = 256, kv: str = "vec",
                 prefetch_budget: int = 4, reread_window: int = 1,
                 prefill_tokens: int = 64, policy: str = "continuous",
                 preempt_wait: Optional[int] = None, shards: int = 2,
                 mesh="auto", moe: Optional[str] = None,
                 moe_experts: int = 64, moe_slots: int = 16,
                 moe_topk: int = 4, moe_prefetch_budget: int = 4,
                 moe_groups: int = 16, moe_seed: int = 0, tenants=None,
                 max_bits: int = 62, dedup: bool = False, obs=None,
                 device="cuda"):
        if policy not in self.policy_choices:
            raise ValueError(f"policy must be one of "
                             f"{self.policy_choices}, got {policy!r}")
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        self.max_batch = max_batch
        self.page_size = page_size
        self.policy = policy
        self.preempt_wait = preempt_wait
        self.prefill_tokens = max(1, int(prefill_tokens))
        self.reread_window = max(1, int(reread_window))
        self.tenants = tenants
        # dedup=True (tenants mode): shared-prefix pages discovered at
        # admission are already-computed read-only content, so their
        # prefill is skipped, identically in the machine and the oracle
        self.dedup = bool(dedup)
        self.pages = make_kv_backend(
            kv, hbm_pages=hbm_pages, page_size=page_size,
            prefetch_budget=prefetch_budget, shards=shards, mesh=mesh,
            tenants=tenants, max_bits=max_bits, dedup=dedup, device=device)
        self.device = self.pages.device
        self.experts = make_expert_backend(
            moe, moe_experts=moe_experts, moe_slots=moe_slots,
            moe_prefetch_budget=moe_prefetch_budget, tenants=tenants,
            device=device)
        self._moe_groups = synthetic_router_groups(
            moe_experts, moe_topk, moe_groups, moe_seed) \
            if self.experts is not None else None
        self.requests: List[SlotRequest] = []
        self._pending: List[SlotRequest] = []    # submitted, not arrived
        self._pending_dirty = False
        self.waiting: List[SlotRequest] = []     # arrived, not in a slot
        self.now = 0                             # current tick
        self.ticks = 0                           # ticks executed
        self.tier_log: List[str] = []            # every touch's tier
        self.preemptions = 0
        self.resumes = 0
        self.peak_in_flight = 0                  # waiting + occupied
        self.peak_live = 0                       # occupied slots
        #: observability sink — None by default (inert); attaching one
        #: also wires it into the page and expert cache tiers so the
        #: whole stack shares a single event stream
        self.obs = obs
        if obs is not None:
            self.pages.obs = obs
            if self.experts is not None:
                self.experts.obs = obs

    # ------------------------------------------------------------------ #
    # open-loop submission                                                #
    # ------------------------------------------------------------------ #

    def submit(self, prompt: Sequence[int], max_new_tokens: int = 8,
               tenant: int = 0, arrival: int = 0) -> int:
        """Queue a request that ARRIVES at tick ``arrival`` (open-loop:
        the engine sees it only once its tick comes — arrivals in the
        past arrive immediately).  Returns the request id."""
        if tenant and self.tenants is None:
            raise ValueError("tenant ids need tenants= mode (pass "
                             "tenants=N or a TenantQoSConfig)")
        if self.tenants is not None:
            n = self.pages.qos_config.n_tenants
            if not 0 <= int(tenant) < n:
                raise ValueError(f"tenant {tenant} out of range [0, {n})")
        rid = len(self.requests)
        req = SlotRequest(rid, list(prompt), max(1, int(max_new_tokens)),
                          tenant=int(tenant),
                          arrival=max(self.now, int(arrival)))
        req.requeue_tick = req.arrival
        self.requests.append(req)
        self._pending.append(req)
        self._pending_dirty = True
        return rid

    def _arrivals(self) -> None:
        """Move every pending request whose arrival tick has come into
        the waiting queue, in (arrival, req_id) order."""
        if self._pending_dirty:
            self._pending.sort(key=lambda r: (r.arrival, r.req_id))
            self._pending_dirty = False
        while self._pending and self._pending[0].arrival <= self.now:
            req = self._pending.pop(0)
            req.state = "waiting"
            self.waiting.append(req)

    # ------------------------------------------------------------------ #
    # elastic hooks (kv="elastic")                                        #
    # ------------------------------------------------------------------ #

    def _elastic_pages(self) -> ElasticShardedPagedKVCache:
        if not isinstance(self.pages, ElasticShardedPagedKVCache):
            raise ValueError("resize/fail_shard need kv='elastic'")
        return self.pages

    def resize(self, shards: int, mesh="auto"):
        """Live shard-count change mid-serve (returns the ReshardPlan)."""
        return self._elastic_pages().resize(shards, mesh=mesh)

    def fail_shard(self, shard: int, recover: bool = True):
        """Inject a shard loss mid-serve; recovery is immediate unless
        ``recover=False`` (then failover-on-demand rebuilds it at the
        next touch)."""
        pages = self._elastic_pages()
        pages.fail_shard(shard)
        return pages.recover_shard(shard) if recover else None

    # ------------------------------------------------------------------ #
    # driving                                                             #
    # ------------------------------------------------------------------ #

    def idle(self) -> bool:
        return not (self._pending or self.waiting or self._any_occupied())

    def run_until_idle(self, max_ticks: int = 100_000) -> List[SlotRequest]:
        """Tick until every submitted request completed; raises if the
        machine fails to drain (a starvation bug, not a load condition —
        admission is FIFO and preemption round-robins)."""
        for _ in range(max_ticks):
            if self.idle():
                return [r for r in self.requests if r.state == "done"]
            self.step()
        raise RuntimeError(f"slot machine failed to drain within "
                           f"{max_ticks} ticks "
                           f"({len(self.waiting)} waiting)")

    def latency_report(self) -> Dict[str, Any]:
        """TTFT/TPOT percentiles (ticks) + goodput over completed
        requests — the benchmark payload."""
        done = [r for r in self.requests if r.state == "done"]
        ttft = np.asarray([r.ttft() for r in done], dtype=np.float64)
        tpot = np.asarray([r.tpot() for r in done], dtype=np.float64)
        toks = sum(len(r.generated) for r in done)
        pct = lambda a, q: float(np.percentile(a, q)) if len(a) else 0.0
        return dict(
            completed=len(done),
            tokens=toks,
            ticks=self.ticks,
            goodput_tok_per_tick=toks / max(1, self.ticks),
            ttft_ticks={q: pct(ttft, q) for q in (50, 95, 99)},
            tpot_ticks={q: pct(tpot, q) for q in (50, 95, 99)},
            preemptions=self.preemptions,
            resumes=self.resumes,
            peak_in_flight=self.peak_in_flight,
            peak_live=self.peak_live,
        )

    # observability (shared emit points — both twins call these at the
    # same semantic step, so their event streams are bit-identical) ----- #

    def _register_admitted(self, req: SlotRequest) -> None:
        """Register an admitted request's prompt (under its tenant in
        tenants mode) unless its chain is live already; with dedup, a
        request that has not prefilled yet skips the prefill of its
        leading shared-prefix run (the machine and the oracle both call
        this, so the skip is the same in both)."""
        if req.req_id in self.pages.chains:
            return
        if self.tenants is not None:
            self.pages.register_request(req.req_id, req.prompt,
                                        tenant=req.tenant)
        else:
            self.pages.register_request(req.req_id, req.prompt)
        if self.dedup and req.prefill_done == 0:
            skip = self.pages.dedup_prefix.get(req.req_id, 0) \
                * self.page_size
            req.prefill_done = min(req.n_prompt, skip)

    def _note_admit(self, slot: int, req: SlotRequest, t: int) -> None:
        if self.obs is not None:
            self.obs.emit(EV_ADMIT, tick=t, slot=slot, req=req.req_id,
                          tenant=req.tenant)

    def _note_preempt(self, slot: int, req: SlotRequest, t: int) -> None:
        if self.obs is not None:
            self.obs.emit(EV_PREEMPT, tick=t, slot=slot, req=req.req_id,
                          tenant=req.tenant,
                          arg=req.max_new_tokens - len(req.generated))

    def _note_resume(self, slot: int, req: SlotRequest, t: int,
                     anchor: int) -> None:
        if self.obs is not None:
            self.obs.emit(EV_RESUME_PREFETCH, tick=t, slot=slot,
                          req=req.req_id, page=anchor, tenant=req.tenant)

    def _note_prefill_chunk(self, slot: int, req_id: int, t: int,
                            tokens: int) -> None:
        if self.obs is not None:
            self.obs.emit(EV_PREFILL_CHUNK, tick=t, slot=slot, req=req_id,
                          arg=tokens)

    def _note_complete(self, slot: int, req: SlotRequest, t: int) -> None:
        if self.obs is None:
            return
        ttft = req.ttft()
        self.obs.emit(EV_COMPLETE, tick=t, slot=slot, req=req.req_id,
                      tenant=req.tenant,
                      arg=-1 if ttft is None else int(ttft))
        tm = getattr(self.obs, "telemetry", None)
        if tm is not None:
            tpot = req.tpot()
            tm.complete(0 if ttft is None else int(ttft),
                        0 if tpot is None else int(round(tpot * 1000)))

    def _note_tick(self) -> None:
        tm = getattr(self.obs, "telemetry", None)
        if tm is not None:
            tm.tick_slots(self)

    # subclass responsibilities ----------------------------------------- #

    def step(self) -> Dict[str, Any]:            # pragma: no cover
        raise NotImplementedError

    def obs_slot_mix(self) -> Tuple[int, int, int]:  # pragma: no cover
        raise NotImplementedError

    def _any_occupied(self) -> bool:             # pragma: no cover
        raise NotImplementedError


class SlotMachine(_SlotFrontEnd):
    """The vectorized continuous-batching engine: slot occupancy, age,
    and phase live in int32 arrays; admission, chunked prefill, decode,
    and completion are masked array ops; the cache sees ONE
    ``touch_batch`` per tick."""

    def __init__(self, **kw):
        super().__init__(**kw)
        b = self.max_batch
        self.phase = np.full(b, PHASE_FREE, np.int32)
        self.slot_req = np.full(b, -1, np.int32)
        self.age = np.zeros(b, np.int32)         # ticks in current phase
        self.prefill_done = np.zeros(b, np.int32)
        self.gen = np.zeros(b, np.int32)
        self.need_prompt = np.zeros(b, np.int32)
        self.need_new = np.zeros(b, np.int32)
        self.chain_len = np.zeros(b, np.int32)

    def _any_occupied(self) -> bool:
        return bool((self.phase != PHASE_FREE).any())

    def obs_slot_mix(self) -> Tuple[int, int, int]:
        """(free, prefill, decode) slot counts — the shared telemetry
        accessor both twins implement over their own state."""
        return (int((self.phase == PHASE_FREE).sum()),
                int((self.phase == PHASE_PREFILL).sum()),
                int((self.phase == PHASE_DECODE).sum()))

    # ------------------------------------------------------------------ #

    def step(self) -> Dict[str, Any]:
        """One tick: arrivals -> (preempt) -> admit -> decode/prefill
        masks -> ONE touch_batch -> token/MoE bookkeeping -> completion
        -> ages."""
        t = self.now
        self._arrivals()
        self.peak_in_flight = max(
            self.peak_in_flight,
            len(self.waiting) + int((self.phase != PHASE_FREE).sum()))
        fresh = np.zeros(self.max_batch, bool)
        anchor_items: List[Tuple[int, int]] = []

        # -- preemption (continuous policy only): queue pressure evicts
        #    the decode slot with the most remaining work ---------------- #
        if (self.policy == "continuous" and self.preempt_wait is not None
                and self.waiting
                and t - self.waiting[0].requeue_tick >= self.preempt_wait
                and not (self.phase == PHASE_FREE).any()):
            # minimum one-tick quantum (age >= 1): every residency emits
            # at least one token before eviction, so FIFO re-queue can
            # never livelock even on a 1-slot engine
            decode = (self.phase == PHASE_DECODE) & (self.age >= 1)
            if decode.any():
                remaining = np.where(decode, self.need_new - self.gen, -1)
                i = int(np.argmax(remaining))    # ties -> lowest slot
                victim = self.requests[int(self.slot_req[i])]
                # boundary event: persist slot progress back onto the
                # request so re-admission restores it
                victim.prefill_done = int(self.prefill_done[i])
                victim.generated = _stub_tokens(victim.req_id,
                                                int(self.gen[i]))
                victim.state = "waiting"
                victim.preemptions += 1
                victim.was_preempted = True
                victim.requeue_tick = t
                self.waiting.append(victim)
                self.phase[i] = PHASE_FREE
                self.slot_req[i] = -1
                self.preemptions += 1
                self._note_preempt(i, victim, t)

        # -- admission: free slots x FIFO waiting queue ------------------ #
        gate_open = (self.policy == "continuous"
                     or not (self.phase != PHASE_FREE).any())
        if gate_open:
            for i in np.flatnonzero(self.phase == PHASE_FREE):
                if not self.waiting:
                    break
                req = self.waiting.pop(0)
                i = int(i)
                self.slot_req[i] = req.req_id
                self.need_prompt[i] = req.n_prompt
                self.need_new[i] = req.max_new_tokens
                self.gen[i] = len(req.generated)
                self.prefill_done[i] = req.prefill_done
                self.age[i] = 0
                fresh[i] = True
                self._note_admit(i, req, t)
                self._register_admitted(req)
                self.prefill_done[i] = req.prefill_done
                L = len(self.pages.chains[req.req_id])
                self.chain_len[i] = L
                if req.prefill_done >= req.n_prompt:
                    self.phase[i] = PHASE_DECODE
                    req.state = "decode"
                    if req.was_preempted and L > 0:
                        # resume-prefetch: touch the page just ahead of
                        # the reread window; its §4.2 scan recovers the
                        # successor chain and prefetches the window
                        # back BEFORE the slot re-enters decode
                        anchor = max(0, L - self.reread_window - 1)
                        anchor_items.append((req.req_id, anchor))
                        self.resumes += 1
                        req.was_preempted = False
                        self._note_resume(i, req, t, anchor)
                else:
                    self.phase[i] = PHASE_PREFILL
                    req.state = "prefill"
        self.peak_live = max(self.peak_live,
                             int((self.phase != PHASE_FREE).sum()))

        # -- decode mask + window touches (slots live BEFORE this tick) -- #
        decode_mask = (self.phase == PHASE_DECODE) & ~fresh
        d_idx = np.flatnonzero(decode_mask)
        L = self.chain_len[d_idx]
        rows, pages_idx = _ranges(
            np.maximum(0, L - self.reread_window).astype(np.int64),
            L.astype(np.int64))
        d_reqs = self.slot_req[d_idx]
        decode_items = list(zip(d_reqs[rows].tolist(), pages_idx.tolist()))

        # -- chunked prefill: one budget, greedy in slot order ----------- #
        p_idx = np.flatnonzero(self.phase == PHASE_PREFILL)
        prefill_items: List[Tuple[int, int]] = []
        if len(p_idx):
            need = (self.need_prompt[p_idx]
                    - self.prefill_done[p_idx]).astype(np.int64)
            excl = np.cumsum(need) - need
            give = np.clip(self.prefill_tokens - excl, 0, need)
            old = self.prefill_done[p_idx].astype(np.int64)
            new = old + give
            ps = self.page_size
            rows, pages_idx = _ranges(-(-old // ps), -(-new // ps))
            p_reqs = self.slot_req[p_idx]
            prefill_items = list(zip(p_reqs[rows].tolist(),
                                     pages_idx.tolist()))
            if self.obs is not None:
                for k, i in enumerate(p_idx):
                    if give[k] > 0:
                        self._note_prefill_chunk(int(i), int(p_reqs[k]),
                                                 t, int(give[k]))
            self.prefill_done[p_idx] = new.astype(np.int32)
            finished = p_idx[new >= self.need_prompt[p_idx]]
            self.phase[finished] = PHASE_DECODE
            fresh[finished] = True               # decode starts NEXT tick
            for i in finished:
                self.requests[int(self.slot_req[i])].state = "decode"

        # -- the tick's ONE bulk cache call ------------------------------ #
        items = anchor_items + decode_items + prefill_items
        if items:
            self.tier_log.extend(self.pages.touch_batch(items))

        # -- token + MoE bookkeeping ------------------------------------- #
        if len(d_idx):
            if self.experts is not None:
                g = (d_reqs.astype(np.int64) * 7919
                     + self.gen[d_idx].astype(np.int64) * 104_729) \
                    % len(self._moe_groups)
                sets = [self._moe_groups[i] for i in g.tolist()]
                self.experts.observe_routing(sets)
                self.experts.activate_batch(sets)
            first = d_idx[self.gen[d_idx] == 0]
            for i in first:
                self.requests[int(self.slot_req[i])].first_tick = t
            self.gen[d_idx] += 1

        # -- completion: vectorized mask, per-request release ------------ #
        done_idx = d_idx[self.gen[d_idx] >= self.need_new[d_idx]]
        for i in done_idx:
            req = self.requests[int(self.slot_req[i])]
            req.generated = _stub_tokens(req.req_id, int(self.gen[i]))
            req.state = "done"
            req.done_tick = t
            self.pages.release_request(req.req_id)
            self._note_complete(int(i), req, t)
        self.phase[done_idx] = PHASE_FREE
        self.slot_req[done_idx] = -1

        # -- ages: +1 for surviving occupants, 0 for fresh phases -------- #
        occ = self.phase != PHASE_FREE
        self.age[occ & ~fresh] += 1
        self.age[fresh & occ] = 0
        self._note_tick()
        self.now += 1
        self.ticks += 1
        out = {"live": int(occ.sum()), "waiting": len(self.waiting),
               "page_stats": self.pages.stats}
        if self.experts is not None:
            out["expert_stats"] = self.experts.stats
        if self.tenants is not None:
            out["tenant_stats"] = self.pages.qos.tenant_stats
        return out


class SlotOracle(_SlotFrontEnd):
    """The lockstep oracle: identical scheduling semantics implemented
    as per-slot Python loops over request objects — no arrays, explicit
    branching — used to pin the vectorized machine bit-exactly
    (``tests/test_serving_batching.py``)."""

    def __init__(self, **kw):
        super().__init__(**kw)
        self.slots: List[Optional[SlotRequest]] = [None] * self.max_batch
        self.slot_age: List[int] = [0] * self.max_batch

    def _any_occupied(self) -> bool:
        return any(s is not None for s in self.slots)

    def obs_slot_mix(self) -> Tuple[int, int, int]:
        """(free, prefill, decode) slot counts — must report exactly
        what the machine's phase-array histogram reports."""
        free = sum(s is None for s in self.slots)
        prefill = sum(1 for s in self.slots
                      if s is not None and s.state == "prefill")
        decode = sum(1 for s in self.slots
                     if s is not None and s.state == "decode")
        return free, prefill, decode

    def step(self) -> Dict[str, Any]:
        t = self.now
        self._arrivals()
        occupied = sum(s is not None for s in self.slots)
        self.peak_in_flight = max(self.peak_in_flight,
                                  len(self.waiting) + occupied)
        fresh: set = set()
        anchor_items: List[Tuple[int, int]] = []

        # preemption: the decode slot with the most remaining work
        if (self.policy == "continuous" and self.preempt_wait is not None
                and self.waiting
                and t - self.waiting[0].requeue_tick >= self.preempt_wait
                and all(s is not None for s in self.slots)):
            best, best_rem = -1, -1
            for i, req in enumerate(self.slots):
                if (req is not None and req.state == "decode"
                        and self.slot_age[i] >= 1):  # min one-tick quantum
                    rem = req.max_new_tokens - len(req.generated)
                    if rem > best_rem:
                        best, best_rem = i, rem
            if best >= 0:
                victim = self.slots[best]
                victim.state = "waiting"
                victim.preemptions += 1
                victim.was_preempted = True
                victim.requeue_tick = t
                self.waiting.append(victim)
                self.slots[best] = None
                self.preemptions += 1
                self._note_preempt(best, victim, t)

        # admission
        gate_open = (self.policy == "continuous"
                     or all(s is None for s in self.slots))
        if gate_open:
            for i in range(self.max_batch):
                if self.slots[i] is not None or not self.waiting:
                    continue
                req = self.waiting.pop(0)
                self.slots[i] = req
                self.slot_age[i] = 0
                fresh.add(i)
                self._note_admit(i, req, t)
                self._register_admitted(req)
                L = len(self.pages.chains[req.req_id])
                if req.prefill_done >= req.n_prompt:
                    req.state = "decode"
                    if req.was_preempted and L > 0:
                        anchor = max(0, L - self.reread_window - 1)
                        anchor_items.append((req.req_id, anchor))
                        self.resumes += 1
                        req.was_preempted = False
                        self._note_resume(i, req, t, anchor)
                else:
                    req.state = "prefill"
        self.peak_live = max(self.peak_live,
                             sum(s is not None for s in self.slots))

        # decode touches: slots that were ALREADY decoding this tick
        decode_slots = [i for i, r in enumerate(self.slots)
                        if r is not None and r.state == "decode"
                        and i not in fresh]
        decode_items: List[Tuple[int, int]] = []
        for i in decode_slots:
            req = self.slots[i]
            L = len(self.pages.chains.get(req.req_id) or ())
            for j in range(max(0, L - self.reread_window), L):
                decode_items.append((req.req_id, j))

        # chunked prefill, greedy in slot order
        budget = self.prefill_tokens
        prefill_items: List[Tuple[int, int]] = []
        for i in range(self.max_batch):
            req = self.slots[i]
            if req is None or req.state != "prefill":
                continue
            give = min(budget, req.n_prompt - req.prefill_done)
            budget -= give
            if give > 0:
                self._note_prefill_chunk(i, req.req_id, t, give)
            old, new = req.prefill_done, req.prefill_done + give
            ps = self.page_size
            for j in range(-(-old // ps), -(-new // ps)):
                prefill_items.append((req.req_id, j))
            req.prefill_done = new
            if new >= req.n_prompt:
                req.state = "decode"
                fresh.add(i)                     # decode starts NEXT tick

        items = anchor_items + decode_items + prefill_items
        if items:
            self.tier_log.extend(self.pages.touch_batch(items))

        # token + MoE bookkeeping
        if decode_slots and self.experts is not None:
            sets = []
            for i in decode_slots:
                req = self.slots[i]
                g = (req.req_id * 7919 + len(req.generated) * 104_729) \
                    % len(self._moe_groups)
                sets.append(self._moe_groups[g])
            self.experts.observe_routing(sets)
            self.experts.activate_batch(sets)
        for i in decode_slots:
            req = self.slots[i]
            if not req.generated:
                req.first_tick = t
            req.generated.append(_stub_tokens(req.req_id,
                                              len(req.generated) + 1)[-1])
            if len(req.generated) >= req.max_new_tokens:
                req.state = "done"
                req.done_tick = t
                self.pages.release_request(req.req_id)
                self._note_complete(i, req, t)
                self.slots[i] = None

        for i in range(self.max_batch):
            if self.slots[i] is None:
                continue
            self.slot_age[i] = 0 if i in fresh else self.slot_age[i] + 1
        self._note_tick()
        self.now += 1
        self.ticks += 1
        live = sum(s is not None for s in self.slots)
        out = {"live": live, "waiting": len(self.waiting),
               "page_stats": self.pages.stats}
        if self.experts is not None:
            out["expert_stats"] = self.experts.stats
        if self.tenants is not None:
            out["tenant_stats"] = self.pages.qos.tenant_stats
        return out
