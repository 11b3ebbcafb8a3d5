"""A Python model of the engine kernels' state structures
(``csrc/engine_baseline.cu``, ``csrc/engine_pfcs.cu``, ``engine_list.cuh``),
held against the plain step functions' final state and the reference's
scalar oracles.

The kernels keep no slot array to fold: each list is a doubly linked list
of its slots in stamp order (oldest first), each free set a two-level
bitmap searched by ``__ffs``, each key's place a per-key map, and the
shadow's tiers a list with one boundary node per level.  The model below
does what each kernel does, step for step, with plain Python ints and
lists, so that every rule the kernels rely on -- a written stamp is the
newest in its list, ties go to the lowest slot, the first free slot is the
lowest, the LIR bottom only moves forward -- is checked here on the CPU,
where the kernels cannot run:

* on ``chip_smoke.py``'s check traces through every system, and PFCS's
  variants (no prefetch, prefetch on every access, a victim window wider
  than every level), at capacity 1 and on the swing that drives ARC's p
  to 0 and to c (p by its bits): the final state array by array and every
  counter equal the plain step functions';
* on one trace of each Table-1 workload at ``benchmarks/table1.py``'s
  levels: every counter equals the reference's scalar oracle (PFCS's the
  oracle's as ``chip_smoke.TABLE1_PFCS`` records them, which
  ``tests/test_torch_engine_ref.py`` holds to the reference).
"""

from torch_parity import chip_smoke

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.core as R
from repro_torch import cases
from repro_torch.core.engine.batch import key_space, stack_accesses
from repro_torch.core.engine.policies_vec import (POLICY_TICKS, lirs_sizes,
                                                  twoq_sizes)
from repro_torch.core.engine.tables import pfcs_tables
from repro_torch.kernels import engine as kengine
from repro_torch.kernels.engine import baseline_scan_ref, pfcs_scan_ref

EMPTY, NIL, I32MAX = -1, -1, 2**31 - 1
LIR, HIR, NO_STATUS = 0, 1, 2
POLICIES = ["lru", "fifo", "2q", "arc", "lirs"]


# --------------------------------------------------------------------------- #
# the structures (engine_list.cuh)                                            #
# --------------------------------------------------------------------------- #

class Chain:
    """A doubly linked list over slot indices, oldest (``head``) to
    newest (``tail``)."""

    def __init__(self, n: int, order=()):
        self.nxt, self.prv = [NIL] * n, [NIL] * n
        self.head = self.tail = NIL
        for i in order:
            self.append(i)

    def append(self, i: int) -> None:
        self.prv[i], self.nxt[i] = self.tail, NIL
        if self.tail == NIL:
            self.head = i
        else:
            self.nxt[self.tail] = i
        self.tail = i

    def unlink(self, i: int) -> None:
        p, n = self.prv[i], self.nxt[i]
        if p == NIL:
            self.head = n
        else:
            self.nxt[p] = n
        if n == NIL:
            self.tail = p
        else:
            self.prv[n] = p

    def to_tail(self, i: int) -> None:
        if self.tail != i:
            self.unlink(i)
            self.append(i)


class FreeSet:
    """The free slots of one array as a two-level bitmap: bit i of word
    ``lo[i >> 5]`` is set when slot i is free, and bit w of ``hi[w >> 5]``
    when ``lo[w]`` is not zero.  ``first()`` is the lowest free slot (or
    None): the first nonzero ``hi`` word, then ``__ffs`` twice."""

    def __init__(self, n: int, free: bool):
        self.lo = [0] * ((n + 31) // 32)
        self.hi = [0] * ((len(self.lo) + 31) // 32)
        if free:
            for i in range(n):
                self.add(i)

    @staticmethod
    def _ffs(word: int) -> int:
        return (word & -word).bit_length() - 1

    def add(self, i: int) -> None:
        w = i >> 5
        if self.lo[w] == 0:
            self.hi[w >> 5] |= 1 << (w & 31)
        self.lo[w] |= 1 << (i & 31)

    def remove(self, i: int) -> None:
        w = i >> 5
        self.lo[w] &= ~(1 << (i & 31))
        if self.lo[w] == 0:
            self.hi[w >> 5] &= ~(1 << (w & 31))

    def first(self):
        for h, word in enumerate(self.hi):
            if word:
                w = h * 32 + self._ffs(word)
                return w * 32 + self._ffs(self.lo[w])
        return None


class Shadow:
    """The tier shadow: ``total`` slots in stamp order (empty slots first:
    their stamps ``i - total`` are below every real one), the key -> slot
    map, each slot's tier (its rank from the newest against the levels'
    cumulative capacities) and the node at rank ``cums[l]`` of each level.
    A touch moves a slot to the newest end; the boundary node of each
    level above the slot's tier then moves one level down, and its newer
    neighbour takes its place."""

    def __init__(self, cums, n_keys: int):
        self.cums = list(cums)
        n = self.cums[-1]
        self.keys, self.t = [EMPTY] * n, [i - n for i in range(n)]
        self.chain = Chain(n, range(n))
        self.tier = [sum(c < n - i for c in self.cums) for i in range(n)]
        self.bound = [n - c for c in self.cums]
        self.slot = [NIL] * n_keys

    def access(self, key: int, now: int) -> int:
        """The key's tier before the touch (``len(cums)`` when it is not
        in the shadow), then the touch."""
        m = self.slot[key]
        if m == NIL:
            tier = len(self.cums)
            m = self.chain.head                      # the LRU slot
            if self.keys[m] != EMPTY:
                self.slot[self.keys[m]] = NIL
            self.keys[m] = key
            self.slot[key] = m
            s = len(self.cums) - 1
        else:
            tier = s = self.tier[m]
        for l in range(s):
            b = self.bound[l]
            self.tier[b] = l + 1
            nb = self.chain.nxt[b]
            self.bound[l] = m if nb == NIL else nb
        if self.bound[s] == m:
            nb = self.chain.nxt[m]
            self.bound[s] = m if nb == NIL else nb
        self.chain.to_tail(m)
        self.tier[m] = 0
        self.t[m] = now
        return tier


# --------------------------------------------------------------------------- #
# the baseline policies                                                       #
# --------------------------------------------------------------------------- #

class Slots:
    """One slot array of a policy: keys, stamps, the live (or all) slots
    in stamp order, the free set and the occupied count."""

    def __init__(self, n: int, stamps, linked_all: bool):
        self.keys, self.t = [EMPTY] * n, list(stamps)
        self.chain = Chain(n, range(n) if linked_all else ())
        self.free = FreeSet(n, not linked_all)
        self.n = 0


class LRUModel:
    def __init__(self, c, n_keys, restamp: bool):
        self.s = Slots(c, [i - c for i in range(c)], True)
        self.slot = [NIL] * n_keys
        self.restamp = restamp

    def access(self, key, now):
        s, m = self.s, self.slot[key]
        if m != NIL:
            if self.restamp:
                s.t[m] = now
                s.chain.to_tail(m)
            return True
        v = s.chain.head
        if s.keys[v] != EMPTY:
            self.slot[s.keys[v]] = NIL
        s.keys[v], s.t[v] = key, now
        self.slot[key] = v
        s.chain.to_tail(v)
        return False

    def state(self):
        return {"keys": self.s.keys,
                "t" if self.restamp else "ins": self.s.t}


class TwoQModel:
    """A1in (FIFO), A1out (ghosts; a freed ghost slot is stamped
    ``-I32MAX``, below every other, so the lowest freed slot is reused
    first: those slots sit in a free set, outside the stamp order) and Am
    (LRU); ``where`` maps a key to ``slot * 4 + list``."""
    A1, AO, AM = 0, 1, 2

    def __init__(self, c, n_keys):
        kin, kout, km = twoq_sizes(c)
        self.l = [Slots(n, [i - n for i in range(n)], True)
                  for n in (kin, kout, km)]
        self.freed = FreeSet(kout, False)
        self.where = [NIL] * n_keys

    def _put(self, lst, v, key, now):
        s = self.l[lst]
        if s.keys[v] != EMPTY:
            self.where[s.keys[v]] = NIL
        s.keys[v], s.t[v] = key, now
        self.where[key] = v * 4 + lst

    def access(self, key, now):
        code = self.where[key]
        which, m = (code & 3, code >> 2) if code != NIL else (None, None)
        a1, ao, am = self.l
        if which == self.AM:
            am.t[m] = now
            am.chain.to_tail(m)
            return True
        if which == self.A1:
            return True
        if which == self.AO:                 # second touch: the ghost -> Am
            v = am.chain.head
            self._put(self.AM, v, key, now)
            am.chain.to_tail(v)
            ao.keys[m], ao.t[m] = EMPTY, -I32MAX
            ao.chain.unlink(m)
            self.freed.add(m)
            return False
        v = a1.chain.head                    # cold: into A1in
        displaced = a1.keys[v]
        a1.keys[v], a1.t[v] = key, now
        self.where[key] = v * 4 + self.A1
        a1.chain.to_tail(v)
        if displaced != EMPTY:
            g = self.freed.first()
            if g is None:
                g = ao.chain.head
                ao.chain.unlink(g)
            else:
                self.freed.remove(g)
            self._put(self.AO, g, displaced, now)
            ao.chain.append(g)
        return False

    def state(self):
        a1, ao, am = self.l
        return {"a1k": a1.keys, "a1t": a1.t, "aok": ao.keys, "aot": ao.t,
                "amk": am.keys, "amt": am.t}


class ARCModel:
    """T1, T2, B1 (c slots) and B2 (2c + 1): the live slots of each in
    stamp order, its free set, its count; ``where`` maps a key to
    ``slot * 4 + list``; p a Python float (CPython's arithmetic)."""
    T1, T2, B1, B2 = 0, 1, 2, 3

    def __init__(self, c, n_keys):
        self.c = c
        self.l = [Slots(n, [0] * n, False) for n in (c, c, c, 2 * c + 1)]
        self.where = [NIL] * n_keys
        self.p = 0.0

    def lru(self, lst):
        s = self.l[lst]
        return s.chain.head if s.n else 0

    def pop(self, lst, slot, forget):
        s = self.l[lst]
        if s.keys[slot] == EMPTY:
            return
        if forget:
            self.where[s.keys[slot]] = NIL
        s.keys[slot] = EMPTY
        s.chain.unlink(slot)
        s.free.add(slot)
        s.n -= 1

    def push(self, lst, key, now):
        s = self.l[lst]
        e = s.free.first()
        if e is None:                        # no free slot: slot 0
            e = 0
            self.pop(lst, 0, True)
        s.keys[e], s.t[e] = key, now
        s.free.remove(e)
        s.chain.append(e)
        s.n += 1
        self.where[key] = e * 4 + lst

    def replace(self, in_b2, now):
        t1, t2 = self.l[self.T1], self.l[self.T2]
        p_int = int(self.p)
        cond_t1 = t1.n > 0 and ((in_b2 and t1.n == p_int) or t1.n > p_int)
        if cond_t1 or (t2.n == 0 and t1.n > 0):
            v = self.lru(self.T1)
            k = t1.keys[v]
            self.pop(self.T1, v, False)
            self.push(self.B1, k, now)
        elif t2.n > 0:
            v = self.lru(self.T2)
            k = t2.keys[v]
            self.pop(self.T2, v, False)
            self.push(self.B2, k, now)

    def access(self, key, now):
        c = self.c
        code = self.where[key]
        which, m = (code & 3, code >> 2) if code != NIL else (None, None)
        t1, t2, b1, b2 = self.l
        if which == self.T1:
            self.pop(self.T1, m, False)
            self.push(self.T2, key, now)
            return True
        if which == self.T2:
            t2.t[m] = now
            t2.chain.to_tail(m)
            return True
        if which in (self.B1, self.B2):
            n_b1, n_b2 = float(b1.n), float(b2.n)
            if which == self.B1:
                self.p = min(float(c), self.p + max(1.0, n_b2 / max(n_b1,
                                                                    1.0)))
            else:
                self.p = max(0.0, self.p - max(1.0, n_b1 / max(n_b2, 1.0)))
            self.replace(which == self.B2, now)
            self.pop(which, m, False)
            self.push(self.T2, key, now)
            return False
        l1 = t1.n + b1.n
        total = l1 + t2.n + b2.n
        case_a = l1 == c
        drop_b1 = case_a and t1.n < c
        drop_t1 = case_a and t1.n >= c
        case_b = not case_a and total >= c
        if drop_b1:
            self.pop(self.B1, self.lru(self.B1), True)
        if drop_t1:
            self.pop(self.T1, self.lru(self.T1), True)
        if case_b and total == 2 * c:
            self.pop(self.B2, self.lru(self.B2), True)
        if drop_b1 or case_b:
            self.replace(False, now)
        self.push(self.T1, key, now)
        return False

    def state(self):
        out = {}
        for name, s in zip(("t1", "t2", "b1", "b2"), self.l):
            out[name + "k"], out[name + "t"] = s.keys, s.t
        out["p"] = self.p
        return out


class LIRSModel:
    """LIRS over per-key arrays.  The LIR bottom is the LIR key of least
    stack stamp; every key that becomes LIR, or is touched as one, takes
    the step's stamp, so that minimum never falls and the bottom is found
    by a pointer that walks the trace forward to the first step whose key
    is LIR and still carries that step's stamp.  The resident HIR queue is
    a linked list over the keys in queue-stamp order."""

    def __init__(self, c, n_keys, acc):
        _, self.llirs = lirs_sizes(c)
        self.capacity = c
        self.status = [NO_STATUS] * n_keys
        self.s_t, self.q_t = [-1] * n_keys, [-1] * n_keys
        self.res = [0] * n_keys
        self.q = Chain(n_keys)
        self.n_lir = self.n_res = 0
        self.acc, self.bp = acc, 0

    def bottom(self):
        """``(key, stamp)`` of the LIR bottom, ``(None, I32MAX)`` when no
        key is LIR."""
        if self.n_lir == 0:
            return None, I32MAX
        while True:
            k = self.acc[self.bp]
            if (k >= 0 and self.status[k] == LIR
                    and self.s_t[k] == self.bp * POLICY_TICKS + 1):
                return k, self.s_t[k]
            self.bp += 1

    def demote(self, tick, b):
        if self.n_lir <= 0:
            return
        self.s_t[b], self.status[b] = -1, HIR
        if self.res[b]:
            self.q_t[b] = tick
            self.q.append(b)
        self.n_lir -= 1

    def evict_resident_hir(self):
        v = self.q.head
        if v == NIL:
            return
        self.q.unlink(v)
        self.q_t[v], self.res[v] = -1, 0
        self.n_res -= 1

    def access(self, key, now):
        hit = bool(self.res[key])
        if self.status[key] == LIR:
            self.s_t[key] = now + 1
            return hit
        cold = False
        if not hit:
            if self.n_res >= self.capacity:
                self.evict_resident_hir()
                if self.n_res >= self.capacity:
                    self.demote(now, self.bottom()[0])
                    self.evict_resident_hir()
            self.res[key] = 1
            self.n_res += 1
        b, b_t = self.bottom()
        st = self.s_t[key]
        ins = st >= 0 and st >= b_t
        if not hit:
            cold = self.n_lir < self.llirs and not ins
        to_lir = cold or ins
        # a resident key that is not LIR is in the queue, and only such a
        # key: the kernel reads no queue stamp (``q_t`` is written only)
        queued = hit
        self.s_t[key] = now + 1
        self.status[key] = LIR if to_lir else HIR
        if not to_lir:
            self.q_t[key] = now + 2
            if queued:
                self.q.to_tail(key)
            else:
                self.q.append(key)
        elif hit:
            self.q_t[key] = -1
            if queued:
                self.q.unlink(key)
        if to_lir:
            self.n_lir += 1
        if ins and self.n_lir > self.llirs:
            self.demote(now + 2, b)
        return hit

    def state(self):
        return {"status": self.status, "s_t": self.s_t, "q_t": self.q_t,
                "res": [bool(r) for r in self.res], "n_lir": self.n_lir,
                "n_res": self.n_res}


def run_baseline(acc, policy, caps, n_keys):
    """One trace (-1 padded) through the model of ``engine_baseline.cu``:
    ``(hits per tier, misses, demand, state)``."""
    total = sum(caps)
    cums = list(np.cumsum(caps))
    shadow = Shadow(cums, n_keys)
    pol = {"lru": lambda: LRUModel(total, n_keys, True),
           "fifo": lambda: LRUModel(total, n_keys, False),
           "2q": lambda: TwoQModel(total, n_keys),
           "arc": lambda: ARCModel(total, n_keys),
           "lirs": lambda: LIRSModel(total, n_keys, acc)}[policy]()
    hits, miss, demand = [0] * (len(caps) + 1), 0, 0
    for step, key in enumerate(acc):
        if key < 0:
            continue
        now = step * POLICY_TICKS
        tier = shadow.access(key, now)
        if pol.access(key, now):
            hits[tier] += 1
        else:
            miss += 1
        demand += 1
    return hits, miss, demand, {"shk": shadow.keys, "sht": shadow.t,
                                "pol": pol.state()}


# --------------------------------------------------------------------------- #
# PFCS                                                                        #
# --------------------------------------------------------------------------- #

class PFCSModel:
    """The levels as slot arrays with their live slots in stamp order
    (every stamp a step writes into a level is the newest there: the
    demand insert ``base + l``, a prefetch ``base + levels + j``, an L0
    touch ``base``), a free set and a count each; ``where`` and ``slot``
    per key.  An eviction walks the ``min(window, C + 1)`` oldest slots
    once and takes the first of the lowest degree."""

    def __init__(self, caps, n_keys, budget, window, always):
        self.caps, self.budget, self.window = list(caps), budget, window
        self.always = always
        self.lv = [dict(keys=[EMPTY] * (c + 1),
                        t=[i - c - 1 for i in range(c + 1)],
                        pf=[False] * (c + 1), deg=[0] * (c + 1),
                        chain=Chain(c + 1), free=FreeSet(c + 1, True), n=0)
                   for c in caps]
        # the one free slot of a level that holds C, when known
        self.only = [None] * len(caps)
        self.where, self.slot = [-1] * n_keys, [NIL] * n_keys
        self.stats = dict(hits=[0] * len(caps), miss=0, demand=0, issued=0,
                          used=0, true=0)
        self.walked = self.evictions = 0

    def add(self, l, key, tick, pf, deg):
        v = self.lv[l]
        e = v["free"].first()
        assert e is not None       # at most C of the C + 1 slots are taken
        if v["n"] == self.caps[l] and self.only[l] is not None:
            assert self.only[l] == e        # the kernel's shortcut
        self.only[l] = None
        v["keys"][e], v["t"][e], v["pf"][e], v["deg"][e] = key, tick, pf, deg
        v["free"].remove(e)
        v["chain"].append(e)
        v["n"] += 1
        self.where[key], self.slot[key] = l, e
        return v["n"] > self.caps[l]

    def evict(self, l):
        v = self.lv[l]
        w = min(self.window, self.caps[l] + 1)
        self.evictions += 1
        i, best, best_deg = v["chain"].head, NIL, I32MAX
        for _ in range(w):
            self.walked += 1
            if v["deg"][i] < best_deg:
                best, best_deg = i, v["deg"][i]
            i = v["chain"].nxt[i]
        out = v["keys"][best], v["pf"][best], v["deg"][best]
        self.remove(l, best)
        return out

    def remove(self, l, i):
        v = self.lv[l]
        v["keys"][i] = EMPTY
        v["chain"].unlink(i)
        v["free"].add(i)
        v["n"] -= 1
        self.only[l] = i if v["n"] == self.caps[l] else None

    def access(self, key, base, row, truth, deg_tbl):
        L = len(self.caps)
        lvl = self.where[key]
        hit = lvl >= 0
        was_pf = False
        if hit:
            v, m = self.lv[lvl], self.slot[key]
            was_pf = v["pf"][m]
            if lvl == 0:
                v["t"][m], v["pf"][m] = base, False
                v["chain"].to_tail(m)
            else:
                self.remove(lvl, m)
        if not (hit and lvl == 0):
            pk, ppf, pdeg = key, False, deg_tbl[key]
            pending = True
            for l in range(L):
                pending = self.add(l, pk, base + l, ppf, pdeg)
                if not pending:
                    break
                pk, ppf, pdeg = self.evict(l)
            if pending:
                self.where[pk] = -1
        if self.budget and (self.always or not hit or was_pf):
            for j in range(self.budget):
                tg = row[j]
                if tg < 0 or self.where[tg] >= 0:
                    continue
                self.stats["issued"] += 1
                self.stats["true"] += bool(truth[j])
                if self.add(L - 1, tg, base + L + j, True, deg_tbl[tg]):
                    self.where[self.evict(L - 1)[0]] = -1
        st = self.stats
        if hit:
            st["hits"][lvl] += 1
        else:
            st["miss"] += 1
        st["demand"] += 1
        st["used"] += hit and was_pf

    def state(self):
        return {"levels": tuple({f: v[f] for f in ("keys", "t", "pf", "deg")}
                                for v in self.lv),
                "where": self.where}


def run_pfcs(acc, caps, n_keys, budget, window, enable, always, targets,
             truth, degree):
    """One trace through the model of ``engine_pfcs.cu``."""
    b = budget if enable else 0
    m = PFCSModel(caps, n_keys, b, window, always)
    micro = len(caps) + b
    for step, key in enumerate(acc):
        if key >= 0:
            m.access(key, step * micro, targets[key], truth[key], degree)
    return m


# --------------------------------------------------------------------------- #
# the comparisons                                                             #
# --------------------------------------------------------------------------- #

def assert_tree(model, plain, path=""):
    """The model's state (lists, ints, a float) equals one row of the
    plain version's (tensors): ints exactly, floats by their bits."""
    if isinstance(plain, dict):
        assert set(model) == set(plain), path
        for k in plain:
            assert_tree(model[k], plain[k], f"{path}/{k}")
    elif isinstance(plain, (tuple, list)):
        for i, (a, b) in enumerate(zip(model, plain)):
            assert_tree(a, b, f"{path}/{i}")
    elif plain.dtype == torch.float64:
        assert np.float64(model).view(np.int64) == plain.view(
            torch.int64).item(), path
    elif plain.dim() == 0:
        assert int(model) == int(plain), path
    else:
        assert [int(x) for x in model] == plain.to(torch.int64).tolist(), path


def row(tree, b):
    if isinstance(tree, dict):
        return {k: row(v, b) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(row(v, b) for v in tree)
    return tree[b]


def check_baseline(acc, policy, caps, n_keys):
    """Every row of ``acc`` through the model against the plain version."""
    want = baseline_scan_ref(acc, policy, caps, n_keys)
    for b, keys in enumerate(acc.tolist()):
        hits, miss, demand, state = run_baseline(keys, policy, caps, n_keys)
        assert hits == want["hits"][b].tolist()
        assert (miss, demand) == (int(want["miss"][b]),
                                  int(want["demand"][b]))
        assert_tree(state, row(want["state"], b))


def check_pfcs(acc, caps, n_keys, budget, window, enable, always, tables):
    targets, truth, degree = tables
    want = pfcs_scan_ref(acc, caps, n_keys, budget, window, enable, always,
                         targets, truth, degree)
    for b, keys in enumerate(acc.tolist()):
        m = run_pfcs(keys, caps, n_keys, budget, window, enable, always,
                     targets[b].tolist(), truth[b].tolist(),
                     degree[b].tolist())
        for k in ("hits", "miss", "demand", "issued", "used", "true"):
            got = m.stats[k]
            assert got == (want[k][b].tolist() if k == "hits"
                           else int(want[k][b])), k
        assert_tree(m.state(), row(want["state"], b))


def tables_of(traces, caps, n_keys):
    from repro_torch.core.engine.batch import stack_tables

    return stack_tables([pfcs_tables(tr, caps, n_keys=n_keys, device="cpu")
                         for tr in traces], "cpu")


CHECK_CAPS = [c for _, c in chip_smoke().CHECK_CAPS]


@pytest.fixture(scope="module")
def check_batch():
    cs = chip_smoke()
    traces = cs.check_traces(160)
    return traces, stack_accesses(traces, "cpu"), key_space(traces)


@pytest.mark.parametrize("policy", POLICIES)
def test_baseline_model_equals_plain_on_the_check_batch(policy,
                                                        check_batch):
    _, acc, n_keys = check_batch
    check_baseline(acc, policy, CHECK_CAPS, n_keys)


@pytest.mark.parametrize("variant", [
    dict(window=8, enable=True, always=False),
    dict(window=8, enable=False, always=False),
    dict(window=8, enable=True, always=True),
    dict(window=1, enable=True, always=False),
], ids=["default", "no-prefetch", "always", "window1"])
def test_pfcs_model_equals_plain_on_the_check_batch(variant, check_batch):
    traces, acc, n_keys = check_batch
    check_pfcs(acc, CHECK_CAPS, n_keys, 4, tables=tables_of(
        traces, chip_smoke().CHECK_CAPS, n_keys), **variant)


def test_pfcs_model_window_wider_than_every_level(check_batch):
    traces, acc, n_keys = check_batch
    narrow = (("L1", 4), ("L2", 8), ("L3", 16))
    check_pfcs(acc, [c for _, c in narrow], n_keys, 4, 100, True, False,
               tables_of(traces, narrow, n_keys))


@pytest.mark.parametrize("system", POLICIES + ["pfcs"])
def test_model_at_capacity_one(system):
    cs = chip_smoke()
    from repro_torch.core import Trace

    one = cs.check_traces(cs.CAPACITY1_LENGTH)[:2]
    one[0] = Trace(name="0,1,0 + zipf", accesses=np.concatenate(
        [[0, 1, 0], one[0].accesses]), relationships=one[0].relationships,
        n_keys=one[0].n_keys)
    acc, n_keys = stack_accesses(one, "cpu"), key_space(one)
    if system == "pfcs":
        check_pfcs(acc, [1], n_keys, 4, 8, True, False,
                   tables_of(one, (("ONE", 1),), n_keys))
    else:
        check_baseline(acc, system, [1], n_keys)


def test_arc_model_p_swing_by_its_bits():
    cs = chip_smoke()
    caps = [4, 12]
    swing = cs.arc_swing_accesses(sum(caps))
    path = cs.arc_p_path(swing, sum(caps))
    assert min(path) == 0.0 and max(path) == float(sum(caps))
    check_baseline(torch.from_numpy(swing.astype(np.int32)[None]), "arc",
                   caps, int(swing.max()) + 1)


@pytest.mark.parametrize("levels", [(3, 29, 7), (1, 1, 1), (16,)],
                         ids=["unequal", "ones", "single"])
@pytest.mark.parametrize("policy", POLICIES)
def test_shadow_tiers_at_odd_levels(policy, levels, check_batch):
    """The shadow's boundary nodes at levels of capacity 1 (a boundary at
    the newest slot) and with a single level."""
    _, acc, n_keys = check_batch
    check_baseline(acc[:2], policy, list(levels), n_keys)


def test_free_set_finds_the_lowest_free_slot():
    rng = np.random.default_rng(0)
    for n in (1, 31, 32, 33, 1024, 1025, 2049):
        fs, free = FreeSet(n, True), set(range(n))
        for _ in range(3 * n):
            i = int(rng.integers(n))
            if i in free:
                fs.remove(i)
                free.discard(i)
            else:
                fs.add(i)
                free.add(i)
            assert fs.first() == (min(free) if free else None)


TABLE1_CAPS = [c for _, c in cases.TABLE1_CAPS]


@pytest.fixture(scope="module")
def table1_traces():
    cs = chip_smoke()
    return {w: cs._make_trace(gen, seed=0, **kw)
            for w, (gen, kw) in cases.table1_workloads().items()}


def _ref_trace(tr):
    return R.Trace(name=tr.name, accesses=np.asarray(tr.accesses),
                   relationships=[tuple(g) for g in tr.relationships],
                   n_keys=tr.n_keys, meta=dict(tr.meta))


@pytest.mark.parametrize("workload", ["db_join", "ml_epoch", "hft"])
@pytest.mark.parametrize("policy", POLICIES)
def test_baseline_model_equals_oracle_on_table1(policy, workload,
                                                table1_traces):
    cs = chip_smoke()
    tr = table1_traces[workload]
    hits, miss, demand, _ = run_baseline(
        [int(k) for k in tr.accesses], policy, TABLE1_CAPS,
        key_space([tr]))
    want = R.simulate_baseline(policy, _ref_trace(tr), cases.TABLE1_CAPS)
    assert hits == list(want.hits_per_level.values())
    assert (miss, demand) == (want.misses, want.demand_accesses)
    assert (sum(hits), demand) == cs.TABLE1_SEED0[workload][policy]


@pytest.mark.parametrize("workload", ["db_join", "ml_epoch", "hft"])
def test_pfcs_model_equals_oracle_on_table1(workload, table1_traces):
    cs = chip_smoke()
    tr = table1_traces[workload]
    n_keys = key_space([tr])
    tb = pfcs_tables(tr, cases.TABLE1_CAPS, n_keys=n_keys, device="cpu")
    m = run_pfcs([int(k) for k in tr.accesses], TABLE1_CAPS, n_keys, 4, 8,
                 True, False, np.asarray(tb.targets).tolist(),
                 np.asarray(tb.truth).tolist(),
                 np.asarray(tb.degree).tolist())
    st = m.stats
    got = (tuple(st["hits"]), st["miss"], st["demand"], st["issued"],
           st["used"], st["true"])
    assert got == cs.TABLE1_PFCS[workload][0]
    # one pass over the window per eviction: 8 slots walked each
    assert m.evictions > 0 and m.walked == 8 * m.evictions


# --------------------------------------------------------------------------- #
# the state's placement (engine_list.cuh::plan_arena)                         #
# --------------------------------------------------------------------------- #

CSRC = Path(kengine.__file__).parent / "csrc"
#: shared bytes a block may take on an H100 (cudaDevAttrMaxSharedMemory-
#: PerBlockOptin), less the PFCS kernel's static per-level scalars (eight
#: 48-byte ``LevelMeta``)
H100_SHARED = 232_448
PFCS_STATIC = 48 * 8
#: engine_baseline.cu's kMeta: its counters, boundary nodes, a chunk's
#: tiers and hits
BASELINE_FIXED = (4 * (2 * 8 + 3) + 2 * 1024 + 15) // 16 * 16


def kernel_array_counts():
    """``kArrays`` of ``engine_baseline.cu``: the arrays each policy's
    kernel takes, in ``POLICY_IDS``' order."""
    src = (CSRC / "engine_baseline.cu").read_text()
    line = src[src.index("constexpr int kArrays[5] = {"):].split("\n")[0]
    return [int(x) for x in re.findall(r"\d+", line.split("=")[1])]


def plan(kinds, words, cap, fixed, least=0):
    """``plan_arena`` in Python: ``(mode, dynamic shared bytes)``; the
    first mode from ``least`` on that fits."""
    def r16(b):
        return -(-b // 16) * 16

    need, fits = [0, 0], [True, True]
    for k, w in zip(kinds, words):
        if k == "G":
            continue
        part, link = (1 if k in "Kk" else 0), k in "skL"
        if link and w > (65534 if k == "L" else 2 * 65534):
            fits[part] = False
        need[part] += r16(2 * w if link else 4 * w)
    mode = max(least, 0 if fits[0] and fits[1] and fixed + sum(need) <= cap
               else 1 if fits[0] and fixed + need[0] <= cap else 2)
    at = fixed
    for k, w in zip(kinds, words):
        if k != "G" and (mode == 0 if k in "Kk" else mode <= 1):
            at += r16(2 * w if k in "skL" else 4 * w)
    return mode, at


@pytest.mark.parametrize("policy", POLICIES)
def test_baseline_arena_is_the_kernels(policy):
    """The wrapper lays out exactly the arrays the kernel names, in its
    order: the outputs (stamps written, never read: 'G'), then the
    shadow's and the policy's links (two words a slot), bitmaps and key
    maps."""
    total, n_keys = 96, 50
    lay = (kengine.baseline_layout(policy, total, n_keys)
           + kengine.baseline_arena(policy, total, n_keys))
    kinds = kengine.baseline_kinds(policy)
    assert len(kinds) == len(lay)
    assert kernel_array_counts()[kengine.POLICY_IDS[policy]] == len(lay)
    for k, (path, n) in zip(kinds, lay):
        name = path[-1]
        if k in "sk":
            assert name == "links" and n % 2 == 0
        if k == "b":
            assert name in ("lo", "hi")
        if k == "G":
            assert name in ("sht", "t", "ins", "a1t", "aot", "amt", "t1t",
                            "t2t", "b1t", "b2t", "q_t", "n_lir", "n_res")
        if k in "Kk" and name != "links":
            assert n == n_keys


def test_pfcs_arena_is_the_kernels():
    lay = kengine.pfcs_layout([3, 5], 40) + kengine.pfcs_arena([3, 5], 40)
    kinds = kengine.pfcs_kinds(2)
    assert len(kinds) == len(lay)
    assert [p[-1] for k, (p, _) in zip(kinds, lay) if k == "G"] == [
        "keys", "t", "pf", "deg"] * 2
    assert [n for k, (_, n) in zip(kinds, lay) if k in "SL"] == [4 + 6] * 5


@pytest.mark.parametrize("workload,n_keys", [("db_join", 5800),
                                             ("ml_epoch", 3100),
                                             ("hft", 2500)])
def test_table1_state_fits_in_shared_memory(workload, n_keys, table1_traces):
    """At Table-1 levels every system keeps its whole state in shared
    memory on an H100 (mode 0); the bytes are those the card reported for
    db_join (ARC, the largest, 173,296 of 232,448)."""
    assert key_space([table1_traces[workload]]) <= n_keys
    total = sum(TABLE1_CAPS)
    got = {}
    for policy in POLICIES:
        lay = (kengine.baseline_layout(policy, total, n_keys)
               + kengine.baseline_arena(policy, total, n_keys))
        got[policy] = plan(kengine.baseline_kinds(policy),
                           [n for _, n in lay], H100_SHARED, BASELINE_FIXED)
    lay = (kengine.pfcs_layout(TABLE1_CAPS, n_keys)
           + kengine.pfcs_arena(TABLE1_CAPS, n_keys))
    got["pfcs"] = plan(kengine.pfcs_kinds(3), [n for _, n in lay],
                       H100_SHARED - PFCS_STATIC, 0)
    assert {m for m, _ in got.values()} == {0}
    if workload == "db_join":
        assert {s: b for s, (_, b) in got.items()} == {
            "lru": 95888, "fifo": 95888, "2q": 105536, "arc": 173296,
            "lirs": 146544, "pfcs": 107920}


@pytest.mark.parametrize("system", POLICIES + ["pfcs"])
def test_a_placement_asked_for_takes_less_shared_memory(system):
    """``engine_check`` asks each shared-memory batch into the two other
    placements (``placement=``): at the check levels and 400 keys each
    request gets its mode, the per-key arrays leave shared memory and
    then the slots, down to the kernel's own scalars."""
    cs = chip_smoke()
    levels = [c for _, c in cs.CHECK_CAPS]
    if system == "pfcs":
        lay = kengine.pfcs_layout(levels, 400) + kengine.pfcs_arena(levels,
                                                                    400)
        kinds, cap, fixed = kengine.pfcs_kinds(3), H100_SHARED - PFCS_STATIC, 0
    else:
        lay = (kengine.baseline_layout(system, sum(levels), 400)
               + kengine.baseline_arena(system, sum(levels), 400))
        kinds, cap, fixed = (kengine.baseline_kinds(system), H100_SHARED,
                             BASELINE_FIXED)
    words = [n for _, n in lay]
    got = [plan(kinds, words, cap, fixed, least) for least in (0, 1, 2)]
    assert [m for m, _ in got] == [0, 1, 2]
    assert got[0][1] > got[1][1] > got[2][1] == fixed


def test_placement_leaves_large_states_in_global_memory():
    """``chip_smoke.py``'s placement batches: 60,000 keys at the check
    levels keep the per-key arrays in global memory (mode 1), levels of
    8 / 24 / 20,000 every array (mode 2)."""
    cs = chip_smoke()
    for levels, n_keys, mode in (([8, 24, 64], 60_000, 1),
                                 ([c for _, c in cs.GLOBAL_CAPS], 400, 2)):
        for policy in POLICIES:
            lay = (kengine.baseline_layout(policy, sum(levels), n_keys)
                   + kengine.baseline_arena(policy, sum(levels), n_keys))
            kinds = kengine.baseline_kinds(policy)
            assert plan(kinds, [n for _, n in lay], H100_SHARED,
                        BASELINE_FIXED)[0] == mode, policy
        lay = (kengine.pfcs_layout(levels, n_keys)
               + kengine.pfcs_arena(levels, n_keys))
        assert plan(kengine.pfcs_kinds(3), [n for _, n in lay],
                    H100_SHARED - PFCS_STATIC, 0)[0] == mode
