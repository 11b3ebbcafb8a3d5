"""Vectorized PFCS hierarchy: array twin of ``pfcs_cache.PFCSCache``.

State layout
------------
Each level of capacity ``C`` is four ``(B, C+1)`` tensors: ``keys``,
``t`` (recency stamp), ``pf`` (brought in by prefetch, not yet
demanded) and ``deg`` (relationship degree, snapshotted at insert from
the static degree table).  The extra slot absorbs the oracle's
add-then-evict transient, so an eviction always runs over a *full*
``C+1``-slot window.

``where`` is a (B, K) int32 array mapping key -> resident level (or -1):
hit detection and the residency check that guards prefetch admission.

Relationship discovery is *table-driven*: relationships are registered
at schema time and immutable during a trace, so the oracle's
``IntelligentPrefetcher.decide`` collapses to a static (K, budget)
target table plus a (K,) degree table (``tables.py``, optionally built
through the discovery kernels).  The weight-ranked target order is kept
in the table, which makes the prefetch admissions equal the oracle's.

Stamp discipline: each access consumes ``M = L (+ budget)`` micro-op
ticks: tick ``base+i`` for the level-``i`` insert of the demand / demote
cascade, tick ``base+L+j`` for the ``j``-th prefetch insert.

Victim selection replicates ``PFCSCache._select_victim``: among the
``min(victim_window, C+1)`` least-recent entries, evict the lowest
relationship degree, ties to the older entry (strict ``<`` in the scan
from the oldest).

These steps are the plain PyTorch version of the engine's PFCS kernel
(``repro_torch/kernels/engine.py``, ``csrc/engine_pfcs.cu``).  The
eviction and each prefetch insert run only when some row needs them
(one host read of a flag), which changes no result.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from .layout import (EMPTY, I32MAX, count, first_empty, gather,
                     init_stamps, occupied, put)

__all__ = ["build_pfcs"]


def _level_init(cap: int, batch: int, device):
    n = cap + 1
    return {"keys": torch.full((batch, n), EMPTY, dtype=torch.int32,
                               device=device),
            "t": init_stamps(batch, n, device),
            "pf": torch.zeros((batch, n), dtype=torch.bool, device=device),
            "deg": torch.zeros((batch, n), dtype=torch.int32, device=device)}


def _add(lv, k, tick, pf, dg, do):
    e = first_empty(lv["keys"])
    return {"keys": put(lv["keys"], e, k, do),
            "t": put(lv["t"], e, tick, do),
            "pf": put(lv["pf"], e, pf, do),
            "deg": put(lv["deg"], e, dg, do)}


def _evict(lv, cap: int, window: int, do):
    """Relationship-aware replacement over a full C+1-slot level: the
    ``w`` least-recent slots, oldest first (``topk`` of the stamps: exact,
    live stamps are unique), and among them the first of the lowest
    degree (``argmin`` takes the first, so ties keep the older entry, the
    oracle's strict ``<``).  Returns ``(level, key, pf, deg)`` of the
    victim; only the ``do`` rows lose it."""
    w = min(window, cap + 1)
    stamps = torch.where(occupied(lv["keys"]), lv["t"], I32MAX)
    window_slots = stamps.topk(w, largest=False, sorted=True).indices
    best = window_slots.gather(
        -1, lv["deg"].gather(-1, window_slots).argmin(-1)[:, None])[:, 0]
    vk, vpf, vdeg = (gather(lv[f], best) for f in ("keys", "pf", "deg"))
    return {**lv, "keys": put(lv["keys"], best, EMPTY, do)}, vk, vpf, vdeg


def build_pfcs(capacities: Sequence[Tuple[str, int]], n_keys: int,
               prefetch_budget: int, victim_window: int,
               enable_prefetch: bool, trigger_always: bool, batch: int,
               device):
    """Returns ``(state, micro_ticks, step)``.

    ``step(state, key, base, tgt_tbl, truth_tbl, deg_tbl) -> state``
    where ``key`` is (B,) int32, ``base`` advances by ``micro_ticks`` per
    access, and the tables are (B, K, budget) int32, (B, K, budget) bool
    and (B, K) int32; counters live in ``state["stats"]``.  ``key < 0``
    marks a padded (no-op) step, which makes ragged batches exact.
    """
    caps = [int(c) for _, c in capacities]
    L = len(caps)
    budget = prefetch_budget if enable_prefetch else 0
    micro = L + budget

    def zeros(*shape):
        return torch.zeros((batch, *shape), dtype=torch.int32, device=device)

    state = {
        "levels": tuple(_level_init(c, batch, device) for c in caps),
        "where": torch.full((batch, n_keys), -1, dtype=torch.int32,
                            device=device),
        "stats": {"hits": zeros(L), "miss": zeros(), "demand": zeros(),
                  "issued": zeros(), "used": zeros(), "true": zeros()},
    }
    rows = torch.arange(batch, device=device)

    def step(s, key, base, tgt_tbl, truth_tbl, deg_tbl):
        levels = list(s["levels"])
        where_of = s["where"]
        st = s["stats"]
        valid = key >= 0
        k = key.clamp(min=0)

        lvl = gather(where_of, k)
        hit = valid & (lvl >= 0)
        was_pf = torch.zeros_like(hit)
        for i in range(L):
            m = levels[i]["keys"] == k[:, None]
            was_pf = was_pf | (hit & (lvl == i)
                               & (m & levels[i]["pf"]).any(-1))

        # L0 hit: touch in place, clear the prefetched flag
        hit0 = hit & (lvl == 0)
        m0 = (levels[0]["keys"] == k[:, None]) & hit0[:, None]
        levels[0] = {**levels[0],
                     "t": torch.where(m0, base, levels[0]["t"]),
                     "pf": levels[0]["pf"] & ~m0}

        # deeper hit: remove, then re-insert at L0 through the cascade
        for i in range(1, L):
            m = ((levels[i]["keys"] == k[:, None])
                 & (hit & (lvl == i))[:, None])
            levels[i] = {**levels[i],
                         "keys": torch.where(m, EMPTY, levels[i]["keys"])}

        # demand insert + demote cascade
        pend_k, pend_pf = k, torch.zeros_like(hit)
        pend_deg = gather(deg_tbl, k)
        pend_do = valid & ~hit0
        for i in range(L):
            levels[i] = _add(levels[i], pend_k, base + i, pend_pf, pend_deg,
                             pend_do)
            where_of = put(where_of, pend_k.clamp(min=0), i, pend_do)
            over = pend_do & (count(levels[i]["keys"]) > caps[i])
            if not bool(over.any()):
                pend_do = over
                break
            levels[i], vk, vpf, vdeg = _evict(levels[i], caps[i],
                                              victim_window, over)
            pend_k, pend_pf, pend_deg, pend_do = vk, vpf, vdeg, over
        where_of = put(where_of, pend_k.clamp(min=0), -1, pend_do)

        # deterministic relationship prefetch into the last level
        issued = torch.zeros_like(lvl)
        true_cnt = torch.zeros_like(lvl)
        if enable_prefetch:
            trigger = valid & (trigger_always | ~hit | was_pf)
            tgts = tgt_tbl[rows, k]
            truths = truth_tbl[rows, k]
            last = L - 1
            for j in range(budget):
                tgt = tgts[:, j]
                safe = tgt.clamp(min=0)
                do = trigger & (tgt >= 0) & (gather(where_of, safe) < 0)
                if not bool(do.any()):
                    continue
                issued = issued + do.to(torch.int32)
                true_cnt = true_cnt + (do & truths[:, j]).to(torch.int32)
                levels[last] = _add(levels[last], tgt, base + L + j,
                                    torch.ones_like(do),
                                    gather(deg_tbl, safe), do)
                where_of = put(where_of, safe, last, do)
                over = do & (count(levels[last]["keys"]) > caps[last])
                if bool(over.any()):
                    levels[last], vk, _, _ = _evict(levels[last], caps[last],
                                                    victim_window, over)
                    where_of = put(where_of, vk.clamp(min=0), -1, over)

        onehot = ((torch.arange(L, device=lvl.device) == lvl[:, None])
                  & hit[:, None])
        stats = {"hits": st["hits"] + onehot.to(torch.int32),
                 "miss": st["miss"] + (valid & ~hit).to(torch.int32),
                 "demand": st["demand"] + valid.to(torch.int32),
                 "issued": st["issued"] + issued,
                 "used": st["used"] + (hit & was_pf).to(torch.int32),
                 "true": st["true"] + true_cnt}
        return {"levels": tuple(levels), "where": where_of, "stats": stats}

    return state, micro, step
