"""Baseline cache replacement policies (PFCS Table 1 comparison set).

Exact host-side reference implementations of every system the paper
compares against:

  * LRU          — least recently used (paper "Traditional LRU")
  * FIFO         — first in first out (extra baseline)
  * 2Q           — Johnson & Shasha, VLDB'94 [paper ref 13]
  * ARC          — Megiddo & Modha, FAST'03 [paper ref 2]
  * LIRS         — Jiang & Zhang, SIGMETRICS'02 [paper ref 3]

All policies implement :class:`CachePolicy`: unit-sized entries,
``access(key) -> hit?`` with internal insertion on miss, plus an explicit
``insert``/``contains`` split so the simulator can model prefetching
(inserts that are not demand accesses).
"""

from __future__ import annotations

from collections import OrderedDict, deque
from typing import Deque, Dict, Hashable, Optional, Set

__all__ = ["CachePolicy", "LRUCachePolicy", "FIFOCachePolicy", "TwoQCachePolicy",
           "ARCCachePolicy", "LIRSCachePolicy", "make_policy", "POLICY_FACTORIES"]

Key = Hashable


class CachePolicy:
    """Interface: a fixed-capacity, unit-entry cache."""

    name = "base"

    def __init__(self, capacity: int):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = capacity

    # -- required -----------------------------------------------------------
    def access(self, key: Key) -> bool:
        """Demand access. Returns True on hit; on miss the key is admitted."""
        raise NotImplementedError

    def contains(self, key: Key) -> bool:
        raise NotImplementedError

    def insert(self, key: Key) -> None:
        """Admit ``key`` without counting it as a demand access (prefetch)."""
        raise NotImplementedError

    def evict_key(self, key: Key) -> None:
        """Force-remove (invalidation); default no-op if absent."""
        raise NotImplementedError

    def __len__(self) -> int:
        raise NotImplementedError


# ---------------------------------------------------------------------------


class LRUCachePolicy(CachePolicy):
    name = "lru"

    def __init__(self, capacity: int):
        super().__init__(capacity)
        self._d: "OrderedDict[Key, None]" = OrderedDict()

    def access(self, key: Key) -> bool:
        if key in self._d:
            self._d.move_to_end(key)
            return True
        self.insert(key)
        return False

    def contains(self, key: Key) -> bool:
        return key in self._d

    def insert(self, key: Key) -> None:
        if key in self._d:
            self._d.move_to_end(key)
            return
        self._d[key] = None
        if len(self._d) > self.capacity:
            self._d.popitem(last=False)

    def evict_key(self, key: Key) -> None:
        self._d.pop(key, None)

    def __len__(self) -> int:
        return len(self._d)


class FIFOCachePolicy(CachePolicy):
    name = "fifo"

    def __init__(self, capacity: int):
        super().__init__(capacity)
        self._q: Deque[Key] = deque()
        self._s: Set[Key] = set()

    def access(self, key: Key) -> bool:
        if key in self._s:
            return True
        self.insert(key)
        return False

    def contains(self, key: Key) -> bool:
        return key in self._s

    def insert(self, key: Key) -> None:
        if key in self._s:
            return
        self._q.append(key)
        self._s.add(key)
        if len(self._q) > self.capacity:
            self._s.discard(self._q.popleft())

    def evict_key(self, key: Key) -> None:
        if key in self._s:
            self._s.discard(key)
            try:
                self._q.remove(key)
            except ValueError:
                pass

    def __len__(self) -> int:
        return len(self._s)


class TwoQCachePolicy(CachePolicy):
    """Simplified 2Q (Johnson & Shasha '94): A1in FIFO (Kin), ghost A1out
    (Kout), main Am LRU."""

    name = "2q"

    def __init__(self, capacity: int, kin_frac: float = 0.25, kout_frac: float = 0.5):
        super().__init__(capacity)
        self.kin = max(1, int(capacity * kin_frac))
        self.kout = max(1, int(capacity * kout_frac))
        self.km = max(1, capacity - self.kin)
        self._a1in: "OrderedDict[Key, None]" = OrderedDict()
        self._a1out: "OrderedDict[Key, None]" = OrderedDict()  # ghosts (no data)
        self._am: "OrderedDict[Key, None]" = OrderedDict()

    def access(self, key: Key) -> bool:
        if key in self._am:
            self._am.move_to_end(key)
            return True
        if key in self._a1in:
            return True  # stays in A1in until evicted (classic 2Q)
        self.insert(key)
        return False

    def contains(self, key: Key) -> bool:
        return key in self._am or key in self._a1in

    def insert(self, key: Key) -> None:
        if self.contains(key):
            return
        if key in self._a1out:  # second touch within window -> hot
            self._a1out.pop(key)
            self._am[key] = None
            if len(self._am) > self.km:
                self._am.popitem(last=False)
            return
        self._a1in[key] = None
        if len(self._a1in) > self.kin:
            old, _ = self._a1in.popitem(last=False)
            self._a1out[old] = None
            if len(self._a1out) > self.kout:
                self._a1out.popitem(last=False)

    def evict_key(self, key: Key) -> None:
        self._a1in.pop(key, None)
        self._am.pop(key, None)

    def __len__(self) -> int:
        return len(self._a1in) + len(self._am)


class ARCCachePolicy(CachePolicy):
    """ARC (Megiddo & Modha, FAST'03) — faithful to the published pseudocode.

    T1/T2 resident lists, B1/B2 ghost lists, adaptive target ``p``.
    """

    name = "arc"

    def __init__(self, capacity: int):
        super().__init__(capacity)
        self.p = 0.0
        self.t1: "OrderedDict[Key, None]" = OrderedDict()
        self.t2: "OrderedDict[Key, None]" = OrderedDict()
        self.b1: "OrderedDict[Key, None]" = OrderedDict()
        self.b2: "OrderedDict[Key, None]" = OrderedDict()

    # LRU = first item; MRU = last item.
    def _replace(self, in_b2: bool) -> None:
        if self.t1 and ((in_b2 and len(self.t1) == int(self.p)) or len(self.t1) > int(self.p)):
            k, _ = self.t1.popitem(last=False)
            self.b1[k] = None
        elif self.t2:
            k, _ = self.t2.popitem(last=False)
            self.b2[k] = None
        elif self.t1:
            k, _ = self.t1.popitem(last=False)
            self.b1[k] = None

    def access(self, key: Key) -> bool:
        c = self.capacity
        if key in self.t1:  # Case I
            self.t1.pop(key)
            self.t2[key] = None
            return True
        if key in self.t2:
            self.t2.move_to_end(key)
            return True
        if key in self.b1:  # Case II
            self.p = min(float(c), self.p + max(1.0, len(self.b2) / max(1, len(self.b1))))
            self._replace(False)
            self.b1.pop(key)
            self.t2[key] = None
            return False
        if key in self.b2:  # Case III
            self.p = max(0.0, self.p - max(1.0, len(self.b1) / max(1, len(self.b2))))
            self._replace(True)
            self.b2.pop(key)
            self.t2[key] = None
            return False
        # Case IV: complete miss
        l1 = len(self.t1) + len(self.b1)
        if l1 == c:
            if len(self.t1) < c:
                self.b1.popitem(last=False)
                self._replace(False)
            else:
                self.t1.popitem(last=False)
        else:
            total = l1 + len(self.t2) + len(self.b2)
            if total >= c:
                if total == 2 * c:
                    self.b2.popitem(last=False)
                self._replace(False)
        self.t1[key] = None
        return False

    def contains(self, key: Key) -> bool:
        return key in self.t1 or key in self.t2

    def insert(self, key: Key) -> None:
        if not self.contains(key):
            # prefetch path: same as a miss access, minus the hit return
            self.access(key)
            # undo the "recency" boost a demand access would legitimately get
            # (prefetched entries enter T1 cold, which access() already does)

    def evict_key(self, key: Key) -> None:
        for lst in (self.t1, self.t2, self.b1, self.b2):
            lst.pop(key, None)

    def __len__(self) -> int:
        return len(self.t1) + len(self.t2)


class LIRSCachePolicy(CachePolicy):
    """LIRS (Jiang & Zhang, SIGMETRICS'02).

    Stack S tracks recency (LIR + HIR + non-resident HIR); queue Q tracks
    resident HIR blocks. ``hir_frac`` of capacity is the HIR partition
    (1% in the paper; bumped for small caches).
    """

    name = "lirs"

    _LIR, _HIR = 0, 1

    def __init__(self, capacity: int, hir_frac: float = 0.05):
        super().__init__(capacity)
        self.lhirs = max(1, int(capacity * hir_frac))
        self.llirs = max(1, capacity - self.lhirs)
        self.s: "OrderedDict[Key, None]" = OrderedDict()   # recency stack
        self.q: "OrderedDict[Key, None]" = OrderedDict()   # resident HIR queue
        self.status: Dict[Key, int] = {}                   # key -> LIR/HIR
        self.resident: Set[Key] = set()
        self.n_lir = 0

    def _stack_prune(self) -> None:
        while self.s:
            k = next(iter(self.s))
            if self.status.get(k) == self._LIR:
                break
            self.s.pop(k)
            if k not in self.resident:
                self.status.pop(k, None)

    def _evict_resident_hir(self) -> None:
        if self.q:
            k, _ = self.q.popitem(last=False)
            self.resident.discard(k)  # becomes non-resident HIR (ghost in S)
            if k not in self.s:
                self.status.pop(k, None)

    def _demote_bottom_lir(self) -> None:
        if not self.s:
            return
        k = next(iter(self.s))
        if self.status.get(k) == self._LIR:
            self.s.pop(k)
            self.status[k] = self._HIR
            self.n_lir -= 1
            if k in self.resident:
                self.q[k] = None
            self._stack_prune()

    def access(self, key: Key) -> bool:
        hit = key in self.resident
        self._touch(key, demand=True)
        return hit

    def _touch(self, key: Key, demand: bool) -> None:
        st = self.status.get(key)
        if st == self._LIR:  # hit on LIR
            was_bottom = next(iter(self.s)) == key if self.s else False
            self.s.pop(key, None)
            self.s[key] = None
            if was_bottom:
                self._stack_prune()
            return
        if key in self.resident:  # resident HIR
            in_stack = key in self.s
            if in_stack:
                self.s.pop(key)
                self.s[key] = None
                self.status[key] = self._LIR
                self.n_lir += 1
                self.q.pop(key, None)
                if self.n_lir > self.llirs:
                    self._demote_bottom_lir()
            else:
                self.s[key] = None
                self.status[key] = self._HIR
                self.q.pop(key, None)
                self.q[key] = None  # move to queue end
            return
        # miss ---------------------------------------------------------------
        if len(self.resident) >= self.capacity:
            self._evict_resident_hir()
            if len(self.resident) >= self.capacity:  # all-LIR corner case
                self._demote_bottom_lir()
                self._evict_resident_hir()
        self.resident.add(key)
        if self.n_lir < self.llirs and key not in self.s:
            # cold start: fill LIR partition first
            self.status[key] = self._LIR
            self.n_lir += 1
            self.s[key] = None
            return
        if key in self.s:  # non-resident HIR with recency -> promote to LIR
            self.s.pop(key)
            self.s[key] = None
            self.status[key] = self._LIR
            self.n_lir += 1
            if self.n_lir > self.llirs:
                self._demote_bottom_lir()
        else:
            self.s[key] = None
            self.status[key] = self._HIR
            self.q[key] = None

    def contains(self, key: Key) -> bool:
        return key in self.resident

    def insert(self, key: Key) -> None:
        if key not in self.resident:
            self._touch(key, demand=False)

    def evict_key(self, key: Key) -> None:
        self.resident.discard(key)
        self.q.pop(key, None)

    def __len__(self) -> int:
        return len(self.resident)


POLICY_FACTORIES = {
    "lru": LRUCachePolicy,
    "fifo": FIFOCachePolicy,
    "2q": TwoQCachePolicy,
    "arc": ARCCachePolicy,
    "lirs": LIRSCachePolicy,
}


def make_policy(name: str, capacity: int) -> CachePolicy:
    try:
        return POLICY_FACTORIES[name](capacity)
    except KeyError:
        raise ValueError(f"unknown policy {name!r}; have {sorted(POLICY_FACTORIES)}")
