"""Vectorized replacement policies: array-state twins of ``policies.py``.

Each policy is built by ``VEC_POLICIES[name](capacity, n_keys, batch,
device) -> (state, step)``:

    state                      dict of (B, ...) tensors
    step(state, key, now)  ->  (state', hit (B,) bool)

``key`` is a (B,) int32 tensor of non-negative keys and ``now`` the
step's stamp (a Python int, shared by every row).  ``step`` replicates
the corresponding ``CachePolicy.access`` *exactly*: the same residency
decisions, the same evictions, the same adaptive-parameter arithmetic.
The batch dimension ``B`` is the reference's ``vmap`` written out; where
the reference switches on a per-trace case (ARC, LIRS), every row takes
only its own case's writes, each gated by the row's case mask.  State
layouts are the reference's (``layout.py``), so a final state can be held
against it array by array.

These steps are the plain PyTorch version of the engine's baseline
kernel (``repro_torch/kernels/engine.py``, ``csrc/engine_baseline.cu``),
which runs the same state machines with one thread block per trace.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

from .layout import (EMPTY, I32MAX, count, first_empty, gather,
                     init_stamps, masked_argmin, occupied, put)

__all__ = ["VEC_POLICIES", "POLICY_TICKS", "LIRS_TICKS", "twoq_sizes",
           "lirs_sizes"]


def _slots(batch: int, n: int, device):
    return torch.full((batch, n), EMPTY, dtype=torch.int32, device=device)


def _has(keys, key):
    return (keys == key[:, None]).any(-1)


# --------------------------------------------------------------------------- #
# LRU — also the recency-shadow primitive of hierarchy.py                     #
# --------------------------------------------------------------------------- #

def lru_init(capacity: int, n_keys: int, batch: int, device):
    del n_keys
    return {"keys": _slots(batch, capacity, device),
            "t": init_stamps(batch, capacity, device)}


def lru_step(s, key, now):
    # hit -> restamp; miss -> overwrite the argmin-stamp slot (empty slots
    # carry the smallest stamps, so they fill first)
    match = s["keys"] == key[:, None]
    hit = match.any(-1)
    victim = s["t"].argmin(-1)
    keys = put(s["keys"], victim, key, ~hit)
    t = put(torch.where(match, now, s["t"]), victim, now, ~hit)
    return {"keys": keys, "t": t}, hit


# --------------------------------------------------------------------------- #
# FIFO                                                                        #
# --------------------------------------------------------------------------- #

def fifo_init(capacity: int, n_keys: int, batch: int, device):
    del n_keys
    return {"keys": _slots(batch, capacity, device),
            "ins": init_stamps(batch, capacity, device)}


def fifo_step(s, key, now):
    # hits never restamp (insertion order, not recency, governs FIFO)
    hit = _has(s["keys"], key)
    victim = s["ins"].argmin(-1)
    return {"keys": put(s["keys"], victim, key, ~hit),
            "ins": put(s["ins"], victim, now, ~hit)}, hit


# --------------------------------------------------------------------------- #
# 2Q (Johnson & Shasha '94) — A1in FIFO / A1out ghosts / Am LRU               #
# --------------------------------------------------------------------------- #

def twoq_sizes(capacity: int, kin_frac: float = 0.25,
               kout_frac: float = 0.5):
    """``(kin, kout, km)``, clamped to at least 1 each as the scalar
    policy does (so ``capacity=1`` holds two keys, as the reference)."""
    kin = max(1, int(capacity * kin_frac))
    kout = max(1, int(capacity * kout_frac))
    return kin, kout, max(1, capacity - kin)


def twoq_init(capacity: int, n_keys: int, batch: int, device):
    del n_keys
    kin, kout, km = twoq_sizes(capacity)
    return {"a1k": _slots(batch, kin, device),
            "a1t": init_stamps(batch, kin, device),
            "aok": _slots(batch, kout, device),
            "aot": init_stamps(batch, kout, device),
            "amk": _slots(batch, km, device),
            "amt": init_stamps(batch, km, device)}


def twoq_step(s, key, now):
    in_am = _has(s["amk"], key)
    in_a1 = _has(s["a1k"], key)
    ghost = s["aok"] == key[:, None]
    in_ao = ghost.any(-1)
    hit = in_am | in_a1
    miss_hot = ~hit & in_ao          # second touch within window -> Am
    miss_new = ~hit & ~in_ao         # cold insert -> A1in

    # Am hit: touch (A1in hits do not restamp, classic 2Q)
    amt = torch.where(s["amk"] == key[:, None], now, s["amt"])
    # miss_hot: drop the ghost, admit into Am over its LRU/empty slot
    am_v = s["amt"].argmin(-1)
    amk = put(s["amk"], am_v, key, miss_hot)
    amt = put(amt, am_v, now, miss_hot)
    ghost = ghost & miss_hot[:, None]
    aok = torch.where(ghost, EMPTY, s["aok"])
    # the freed ghost slot is restamped below every init stamp so that the
    # next push reuses it instead of evicting a live ghost
    aot = torch.where(ghost, -I32MAX, s["aot"])

    # miss_new: admit into A1in; a displaced occupant (oldest insertion)
    # becomes an A1out ghost, displacing the oldest ghost if full
    a1_v = s["a1t"].argmin(-1)
    displaced = gather(s["a1k"], a1_v)
    spill = miss_new & (displaced != EMPTY)
    a1k = put(s["a1k"], a1_v, key, miss_new)
    a1t = put(s["a1t"], a1_v, now, miss_new)
    ao_v = aot.argmin(-1)
    aok = put(aok, ao_v, displaced, spill)
    aot = put(aot, ao_v, now, spill)
    return {"a1k": a1k, "a1t": a1t, "aok": aok, "aot": aot,
            "amk": amk, "amt": amt}, hit


# --------------------------------------------------------------------------- #
# ARC (Megiddo & Modha, FAST'03)                                              #
# --------------------------------------------------------------------------- #
#
# T1/T2 resident + B1/B2 ghost lists as slot arrays: c slots for T1/T2/B1
# and 2c+1 for B2 (the +1 absorbs the transient push-before-pop).  The
# adaptive target ``p`` is float64, so its arithmetic is CPython's.

def _push(keys, times, k, now, do):
    e = first_empty(keys)
    return put(keys, e, k, do), put(times, e, now, do)


def arc_build(capacity: int, n_keys: int, batch: int, device):
    del n_keys
    c = capacity

    def slots(n):
        return (_slots(batch, n, device),
                torch.zeros((batch, n), dtype=torch.int32, device=device))

    t1k, t1t = slots(c)
    t2k, t2t = slots(c)
    b1k, b1t = slots(c)
    b2k, b2t = slots(2 * c + 1)
    state = {"t1k": t1k, "t1t": t1t, "t2k": t2k, "t2t": t2t,
             "b1k": b1k, "b1t": b1t, "b2k": b2k, "b2t": b2t,
             "p": torch.zeros((batch,), dtype=torch.float64, device=device)}

    def replace(s, in_b2, now, active):
        """ARC REPLACE: demote the LRU of T1 (-> B1 ghost) or of T2 (->
        B2), steered by p; only in the ``active`` rows."""
        n_t1, n_t2 = count(s["t1k"]), count(s["t2k"])
        p_int = s["p"].to(torch.int32)      # int(p): p >= 0, trunc == floor
        cond_t1 = (n_t1 > 0) & ((in_b2 & (n_t1 == p_int)) | (n_t1 > p_int))
        do_t1 = active & (cond_t1 | ((n_t2 == 0) & (n_t1 > 0)))
        do_t2 = active & ~cond_t1 & (n_t2 > 0)
        i1 = masked_argmin(s["t1t"], occupied(s["t1k"]))
        i2 = masked_argmin(s["t2t"], occupied(s["t2k"]))
        b1k, b1t = _push(s["b1k"], s["b1t"], gather(s["t1k"], i1), now,
                         do_t1)
        b2k, b2t = _push(s["b2k"], s["b2t"], gather(s["t2k"], i2), now,
                         do_t2)
        return {**s, "t1k": put(s["t1k"], i1, EMPTY, do_t1),
                "t2k": put(s["t2k"], i2, EMPTY, do_t2),
                "b1k": b1k, "b1t": b1t, "b2k": b2k, "b2t": b2t}

    def step(s, key, now):
        in_t1 = _has(s["t1k"], key)
        in_t2 = _has(s["t2k"], key)
        in_b1 = _has(s["b1k"], key)
        in_b2 = _has(s["b2k"], key)
        hit = in_t1 | in_t2
        # the reference's five cases; each row takes exactly one
        c_t2 = ~in_t1 & in_t2
        c_b1 = ~hit & in_b1
        c_b2 = ~hit & ~in_b1 & in_b2
        c_miss = ~hit & ~in_b1 & ~in_b2

        # Case I: a T1 hit leaves T1 (and joins T2's MRU below); a T2 hit
        # restamps
        t1k = torch.where(in_t1[:, None] & (s["t1k"] == key[:, None]),
                          EMPTY, s["t1k"])
        t2t = torch.where(c_t2[:, None] & (s["t2k"] == key[:, None]), now,
                          s["t2t"])
        s = {**s, "t1k": t1k, "t2t": t2t}

        # Cases II and III adapt p first (float64, CPython's arithmetic)
        n_b1 = count(s["b1k"]).to(torch.float64)
        n_b2 = count(s["b2k"]).to(torch.float64)
        up = torch.clamp(n_b2 / torch.clamp(n_b1, min=1.0), min=1.0)
        down = torch.clamp(n_b1 / torch.clamp(n_b2, min=1.0), min=1.0)
        p = torch.where(c_b1, torch.clamp(s["p"] + up, max=float(c)), s["p"])
        p = torch.where(c_b2, torch.clamp(p - down, min=0.0), p)

        # Case IV pops before its REPLACE
        n_t1, n_t2 = count(s["t1k"]), count(s["t2k"])
        n_b1i, n_b2i = count(s["b1k"]), count(s["b2k"])
        l1 = n_t1 + n_b1i
        total = l1 + n_t2 + n_b2i
        case_a = c_miss & (l1 == c)
        drop_b1 = case_a & (n_t1 < c)
        drop_t1 = case_a & (n_t1 >= c)
        case_b = c_miss & (l1 != c) & (total >= c)
        drop_b2 = case_b & (total == 2 * c)
        ib1 = masked_argmin(s["b1t"], occupied(s["b1k"]))
        it1 = masked_argmin(s["t1t"], occupied(s["t1k"]))
        ib2 = masked_argmin(s["b2t"], occupied(s["b2k"]))
        s = {**s, "p": p,
             "b1k": put(s["b1k"], ib1, EMPTY, drop_b1),
             "t1k": put(s["t1k"], it1, EMPTY, drop_t1),
             "b2k": put(s["b2k"], ib2, EMPTY, drop_b2)}

        s = replace(s, c_b2, now, c_b1 | c_b2 | drop_b1 | case_b)

        # the ghost leaves its list; the key joins T2 (Cases I-III) or T1
        b1k = torch.where(c_b1[:, None] & (s["b1k"] == key[:, None]),
                          EMPTY, s["b1k"])
        b2k = torch.where(c_b2[:, None] & (s["b2k"] == key[:, None]),
                          EMPTY, s["b2k"])
        t2k, t2t = _push(s["t2k"], s["t2t"], key, now, in_t1 | c_b1 | c_b2)
        t1k, t1t = _push(s["t1k"], s["t1t"], key, now, c_miss)
        return {**s, "b1k": b1k, "b2k": b2k, "t1k": t1k, "t1t": t1t,
                "t2k": t2k, "t2t": t2t}, hit

    return state, step


# --------------------------------------------------------------------------- #
# LIRS (Jiang & Zhang, SIGMETRICS'02)                                         #
# --------------------------------------------------------------------------- #
#
# The recency stack S is unbounded (it holds non-resident HIR ghosts), so
# LIRS is carried as per-key arrays over the key universe.  Stack
# membership is a threshold instead of a simulated prune:
#
#     in_S(k)  <=>  s_t[k] >= 0  and  s_t[k] >= min{ s_t[j] : j is LIR }
#
# (after every prune the bottom of S is LIR, and the oldest-LIR stamp
# never decreases).  Each access consumes 3 stamp ticks: +0 capacity-stage
# queue push, +1 stack write, +2 insert-stage queue push.

_LIR, _HIR, _NONE = 0, 1, 2
LIRS_TICKS = 3


def lirs_sizes(capacity: int, hir_frac: float = 0.05):
    """``(lhirs, llirs)`` as the scalar policy computes them."""
    lhirs = max(1, int(capacity * hir_frac))
    return lhirs, max(1, capacity - lhirs)


def lirs_build(capacity: int, n_keys: int, batch: int, device):
    _, llirs = lirs_sizes(capacity)
    shape = (batch, n_keys)
    state = {"status": torch.full(shape, _NONE, dtype=torch.int32,
                                  device=device),
             "s_t": torch.full(shape, -1, dtype=torch.int32, device=device),
             "q_t": torch.full(shape, -1, dtype=torch.int32, device=device),
             "res": torch.zeros(shape, dtype=torch.bool, device=device),
             "n_lir": torch.zeros((batch,), dtype=torch.int32,
                                  device=device),
             "n_res": torch.zeros((batch,), dtype=torch.int32,
                                  device=device)}

    def in_stack(s, key):
        lir_min = torch.where(s["status"] == _LIR, s["s_t"],
                              I32MAX).amin(-1)
        st = gather(s["s_t"], key)
        return (st >= 0) & (st >= lir_min)

    def demote_bottom(s, tick, active):
        """Bottom LIR -> HIR: leaves S; enters Q if resident."""
        do = active & (s["n_lir"] > 0)
        b = masked_argmin(s["s_t"], s["status"] == _LIR)
        return {**s,
                "s_t": put(s["s_t"], b, -1, do),
                "status": put(s["status"], b, _HIR, do),
                "n_lir": s["n_lir"] - do.to(torch.int32),
                "q_t": put(s["q_t"], b, tick, do & gather(s["res"], b))}

    def evict_resident_hir(s, active):
        in_q = s["q_t"] >= 0
        has = active & in_q.any(-1)
        v = masked_argmin(s["q_t"], in_q)
        return {**s,
                "q_t": put(s["q_t"], v, -1, has),
                "res": put(s["res"], v, False, has),
                "n_res": s["n_res"] - has.to(torch.int32)}

    def step(s, key, now):
        hit = gather(s["res"], key)
        c_lir = gather(s["status"], key) == _LIR
        c_hir = ~c_lir & hit                 # resident HIR
        c_miss = ~hit & ~c_lir

        # miss: make room (all-LIR corner: demote a LIR so Q can evict)
        full1 = c_miss & (s["n_res"] >= capacity)
        s = evict_resident_hir(s, full1)
        full2 = full1 & (s["n_res"] >= capacity)
        s = evict_resident_hir(demote_bottom(s, now, full2), full2)
        s = {**s, "res": put(s["res"], key, True, c_miss),
             "n_res": s["n_res"] + c_miss.to(torch.int32)}

        # stack membership after the demotes moved the threshold (a
        # resident HIR row's state is untouched so far)
        ins = in_stack(s, key)
        cold = c_miss & (s["n_lir"] < llirs) & ~ins
        to_lir = (c_hir | c_miss) & (cold | ins)
        queue = (c_hir | c_miss) & ~cold & ~ins
        s = {**s,
             "s_t": put(s["s_t"], key, now + 1, torch.ones_like(hit)),
             "status": put(s["status"], key,
                           torch.where(to_lir, _LIR, _HIR), ~c_lir),
             "n_lir": s["n_lir"] + to_lir.to(torch.int32),
             "q_t": put(s["q_t"], key, torch.where(queue, now + 2, -1),
                        queue | (c_hir & ins))}
        promoted = (c_hir | c_miss) & ins & (s["n_lir"] > llirs)
        return demote_bottom(s, now + 2, promoted), hit

    return state, step


# --------------------------------------------------------------------------- #
# registry                                                                    #
# --------------------------------------------------------------------------- #

def _simple_build(init, step_fn):
    def build(capacity: int, n_keys: int, batch: int, device):
        return init(capacity, n_keys, batch, device), step_fn
    return build


#: name -> build(capacity, n_keys, batch, device) -> (initial_state, step)
VEC_POLICIES: Dict[str, Callable] = {
    "lru": _simple_build(lru_init, lru_step),
    "fifo": _simple_build(fifo_init, fifo_step),
    "2q": _simple_build(twoq_init, twoq_step),
    "arc": arc_build,
    "lirs": lirs_build,
}

#: stamp ticks consumed per access (worst case across policies + shadow)
POLICY_TICKS = 4
