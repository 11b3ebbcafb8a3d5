"""The comparison that decides ``correct``: what the timed path produced
against the plain reference (``reference.py``, ``configs/<name>.py``).

Three layers, each a number beside its limit:

- ``logit_gap``: over every token the engine served on the slots checked
  (every slot, unless the configuration names a sample drawn from the
  seed, with the slot of the longest finished request in it), by how
  much the served token's logit lies below the reference's best at that
  call; beside it the mean of those gaps and the largest of the slots'
  means (``GAP_NUMBERS``).  The reference replays each checked slot's
  whole history (every call for a recurrent model) from the prompts and
  the served tokens, in float32.
- ``page_tier_mismatches``: the page tier's counters, the tier of every
  touch and the prefetch log against ``PageOracle`` replaying the
  requests' registrations, touches and releases (limit 0).
- ``kernel_mismatches``: launches of the PFCS kernels whose outputs differ
  from the plain versions on the same inputs (limit 0).

Besides: ``schedule_mismatches`` (the engine's slots or served-token
counts against the mirror, limit 0) and ``nonfinite_logits`` (limit 0).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from pfcs_bench.reference import KERNEL_REFS, PAGE_COUNTERS, PageOracle

#: the served-token numbers; a configuration's ``limits`` says which of
#: them its cells are held to
GAP_NUMBERS = ("logit_gap", "mean_logit_gap", "slot_mean_logit_gap",
               "off_argmax_share")


def page_tier(mirror, pages, tiers: List[str], serving: Dict) -> int:
    """Differences between the program's page tier (its counters, its
    prefetch log, ``tiers``: what each touch returned) and the oracle's."""
    ora = PageOracle(serving["hbm_pages"], serving["page_size"],
                     serving["prefetch_budget"])
    rw = serving["reread_window"]
    for st in mirror.steps:
        for rid in st["admitted"]:
            ora.register(rid, mirror.req[rid]["prompt"])
        for _, rid in st["touches"]:
            n = len(ora.chains[rid])
            for j in range(max(0, n - rw), n):
                ora.touch(rid, j)
        for rid in st["done"]:
            ora.release(rid)
    bad = sum(getattr(pages.stats, k) != ora.stats[k] for k in PAGE_COUNTERS)
    bad += int([tuple(x) for x in pages.prefetch_log] != ora.prefetch_log)
    return bad + int(list(tiers) != ora.tiers)


def kernels(launches: List[Dict]) -> int:
    bad = 0
    for rec in launches:
        want = KERNEL_REFS[rec["name"]](*rec["args"])
        want = want if isinstance(want, tuple) else (want,)
        bad += int(any(not torch.equal(a.to(b.dtype), b)
                       for a, b in zip(want, rec["out"])))
    return bad


def sample_slots(mirror, seed: int, k: int) -> List[int]:
    """``k`` slots drawn from the seed, the longest finished request's
    slot first."""
    rng = np.random.default_rng([int(seed) % (1 << 63), 1])
    done = [r for r in mirror.req.values()
            if len(r["served"]) >= r["max_new"]]
    first = ([max(done, key=lambda r: len(r["served"]))["slot"]]
             if done else [])
    rest = [int(i) for i in rng.permutation(mirror.b) if i not in first]
    return (first + rest)[:k]


def slot_histories(mirror, slots: List[int]) -> List[Dict]:
    tokens, adv, served = mirror.arrays()
    out = []
    for s in slots:
        judge = np.flatnonzero(served[:, s] >= 0)
        out.append({"tokens": tokens[:, s], "adv": adv[:, s],
                    "judge": judge, "served": served[judge, s]})
    return out


def gaps(logits: List[torch.Tensor], hist: List[Dict],
         pick=None) -> Dict:
    """By how much the served tokens (or ``pick``'s, one tensor a slot)
    lie below the reference's best logit: the widest gap, the mean gap,
    the largest of the slots' mean gaps (a fault confined to a few slots
    moves it where the mean over all of them dilutes it), the share of
    tokens that are not the reference's first; and the count of calls
    with a non-finite logit."""
    worst, total, nonfinite, n, off = 0.0, 0.0, 0, 0, 0
    slot_worst = 0.0
    for i, (lg, h) in enumerate(zip(logits, hist)):
        if lg.shape[0] == 0:
            continue
        tok = (torch.as_tensor(h["served"], device=lg.device) if pick is None
               else pick[i])
        nonfinite += int((~torch.isfinite(lg)).any(1).sum())
        g = lg.max(1).values - lg.gather(1, tok[:, None].long())[:, 0]
        worst = max(worst, float(g.max()))
        total += float(g.sum())
        slot_worst = max(slot_worst, float(g.mean()))
        off += int((g > 0).sum())
        n += lg.shape[0]
    return {"logit_gap": worst, "mean_logit_gap": total / max(1, n),
            "slot_mean_logit_gap": slot_worst,
            "off_argmax_share": off / max(1, n), "nonfinite": nonfinite,
            "tokens": n}
