"""Vectorized baseline hierarchy: policy residency + recency-shadow tiers.

Array twin of ``simulator._BaselineHierarchy``: residency is decided by
ONE policy instance over the summed level capacity, while tier
*attribution* uses policy-independent nested exact-LRU shadows of sizes
``c1 < c1+c2 < ... < Ctot``.  The nested shadows see the same touch
stream, so one slot array of size ``Ctot`` represents them all: a key is
in shadow ``i`` iff its *recency rank* (one plus the number of tracked
keys touched more recently) is ``<= cum_i``.  A resident key absent from
every shadow is charged the MEM tier, as in the oracle.

Per access, in oracle order:

    1. tier  := shadow rank of the key (BEFORE the touch)
    2. hit   := policy residency       (BEFORE the policy update)
    3. touch the shadow, step the policy

The step emits ``(hit, tier_idx)`` with ``tier_idx in [0, L]`` where
``L`` is the MEM bin.
"""

from __future__ import annotations

from itertools import accumulate
from typing import Sequence, Tuple

import torch

from .layout import EMPTY, I32MAX, init_stamps, occupied, put
from .policies_vec import VEC_POLICIES

__all__ = ["build_hierarchy"]


def build_hierarchy(policy: str, capacities: Sequence[Tuple[str, int]],
                    n_keys: int, batch: int, device):
    """Returns ``(state, step)`` for one baseline system over ``batch``
    traces.

    ``step(state, key, now) -> (state, (hit, tier_idx))``; ``now`` must
    advance by ``POLICY_TICKS`` per access (the shadow shares the
    policy's stamp space but writes its own array, so one stamp per
    access serves both).
    """
    caps = [int(c) for _, c in capacities]
    cums = torch.tensor(list(accumulate(caps)), dtype=torch.int32,
                        device=device)
    total = int(sum(caps))
    n_levels = len(caps)

    pol_state, pol_step = VEC_POLICIES[policy](total, n_keys, batch, device)
    state = {
        "pol": pol_state,
        "shk": torch.full((batch, total), EMPTY, dtype=torch.int32,
                          device=device),
        "sht": init_stamps(batch, total, device),
    }

    def step(s, key, now):
        shk, sht = s["shk"], s["sht"]
        match = shk == key[:, None]
        in_shadow = match.any(-1)
        t_key = torch.where(match, sht, -I32MAX).amax(-1)
        rank = 1 + (occupied(shk) & (sht > t_key[:, None])).sum(-1)
        tier = torch.where(in_shadow, (rank[:, None] > cums).sum(-1),
                           n_levels)

        # shadow touch == LRU update over the largest shadow
        victim = sht.argmin(-1)
        shk2 = put(shk, victim, key, ~in_shadow)
        sht2 = put(torch.where(match, now, sht), victim, now, ~in_shadow)

        pol, hit = pol_step(s["pol"], key, now)
        return {"pol": pol, "shk": shk2, "sht": sht2}, (hit, tier)

    return state, step
