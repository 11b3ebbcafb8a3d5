"""Factorization-event tracing: a fixed-capacity int32 ring buffer
(DESIGN.md §13).

Every typed runtime event — slot admission, chunked-prefill step,
preemption, resume-prefetch, completion, eviction (victim + tenant),
prefetch issue, dedup hit / promotion / COW divergence, shared-page
age-out, shard gcd-exchange, recovery refactorization — is one row of
eight ``int32`` lanes in a preallocated ring:

    (kind, tick, slot, req, page, tenant, shard, arg)

The buffer is plain array state, exactly like the slot machine's
``phase``/``age`` arrays it rides along with: emitting an event is one
row write at ``total % capacity`` plus a counter increment.  Nothing is
read back on the hot path, no allocation happens after construction,
and ``capacity=0`` degrades every ``emit`` to a bare counter bump — so
tracing can be carried by both the scalar oracles and the vectorized
twins without perturbing a single placement decision (the inertness
contract tests/test_obs.py pins).

Because the oracle and the vec twin emit at semantically identical
points, a **trace diff** (:func:`trace_diff`) is a differential-testing
axis one level finer than ``PARITY_COUNTERS``: two backends that agree
on every counter but disagree on the *order* of events diverge here
first.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import numpy as np

__all__ = [
    "EVENT_FIELDS", "EVENT_NAMES", "TraceEvent", "EventTracer",
    "trace_diff",
    "EV_ADMIT", "EV_PREFILL_CHUNK", "EV_PREEMPT", "EV_RESUME_PREFETCH",
    "EV_COMPLETE", "EV_EVICT", "EV_PREFETCH", "EV_DEDUP_HIT",
    "EV_DEDUP_PROMOTE", "EV_COW", "EV_AGE_OUT", "EV_GCD_EXCHANGE",
    "EV_RECOVERY",
]

#: int32 lanes of one ring row, in storage order.  Unused lanes hold -1.
EVENT_FIELDS = ("kind", "tick", "slot", "req", "page", "tenant",
                "shard", "arg")

# -- typed event kinds (DESIGN.md §13 event schema) ------------------------- #
EV_ADMIT = 1            #: request admitted to a slot (slot, req)
EV_PREFILL_CHUNK = 2    #: chunked-prefill step (slot, req, arg=tokens)
EV_PREEMPT = 3          #: decode slot preempted (slot, req)
EV_RESUME_PREFETCH = 4  #: resume anchor touched (req, page=anchor idx)
EV_COMPLETE = 5         #: request finished (slot, req, arg=ttft ticks)
EV_EVICT = 6            #: HBM eviction (page=victim, tenant)
EV_PREFETCH = 7         #: prefetch issued (page=source, arg=target)
EV_DEDUP_HIT = 8        #: admission hit an existing shared page (page)
EV_DEDUP_PROMOTE = 9    #: private content promoted to a shared page
EV_COW = 10             #: copy-on-write divergence (page=fresh private)
EV_AGE_OUT = 11         #: zero-ref shared page aged out, prime recycled
EV_GCD_EXCHANGE = 12    #: sharded collective gcd exchange (shard, arg)
EV_RECOVERY = 13        #: shard recovery refactorization (shard, arg)

EVENT_NAMES = {
    EV_ADMIT: "admit",
    EV_PREFILL_CHUNK: "prefill_chunk",
    EV_PREEMPT: "preempt",
    EV_RESUME_PREFETCH: "resume_prefetch",
    EV_COMPLETE: "complete",
    EV_EVICT: "evict",
    EV_PREFETCH: "prefetch",
    EV_DEDUP_HIT: "dedup_hit",
    EV_DEDUP_PROMOTE: "dedup_promote",
    EV_COW: "cow",
    EV_AGE_OUT: "age_out",
    EV_GCD_EXCHANGE: "gcd_exchange",
    EV_RECOVERY: "recovery",
}


class TraceEvent(NamedTuple):
    kind: int
    tick: int
    slot: int
    req: int
    page: int
    tenant: int
    shard: int
    arg: int

    @property
    def name(self) -> str:
        return EVENT_NAMES.get(self.kind, f"kind{self.kind}")


class EventTracer:
    """Fixed-capacity int32 event ring.

    ``capacity`` rows are allocated once; ``emit`` writes row
    ``total % capacity`` and bumps ``total``.  When the ring wraps, the
    oldest events are overwritten (``dropped`` counts them).  A
    ``capacity=0`` tracer accepts every emit as a pure counter bump —
    the cheapest possible "tracing attached but recording nothing"
    configuration, used by the inertness parity sweep.
    """

    def __init__(self, capacity: int = 4096):
        if capacity < 0:
            raise ValueError("capacity must be >= 0")
        self.capacity = int(capacity)
        self.buf = np.full((self.capacity, len(EVENT_FIELDS)), -1,
                           dtype=np.int32)
        self.total = 0

    def emit(self, kind: int, tick: int = -1, slot: int = -1,
             req: int = -1, page: int = -1, tenant: int = -1,
             shard: int = -1, arg: int = -1) -> None:
        if self.capacity:
            self.buf[self.total % self.capacity] = (
                kind, tick, slot, req, page, tenant, shard, arg)
        self.total += 1

    @property
    def dropped(self) -> int:
        """Events overwritten by ring wraparound (or uncaptured at
        capacity 0)."""
        return max(0, self.total - self.capacity)

    def __len__(self) -> int:
        return min(self.total, self.capacity)

    def as_array(self) -> np.ndarray:
        """Retained events, oldest first, as an ``(n, 8)`` int32 view."""
        n = len(self)
        if n < self.capacity or n == 0:
            return self.buf[:n].copy()
        head = self.total % self.capacity
        return np.concatenate([self.buf[head:], self.buf[:head]])

    def events(self) -> List[TraceEvent]:
        """Retained events, oldest first, as typed tuples."""
        return [TraceEvent(*(int(x) for x in row))
                for row in self.as_array()]

    def clear(self) -> None:
        self.buf.fill(-1)
        self.total = 0

    def export(self) -> dict:
        return {
            "capacity": self.capacity,
            "total": self.total,
            "dropped": self.dropped,
            "fields": list(EVENT_FIELDS),
            "events": [list(row) for row in self.as_array().tolist()],
        }


def trace_diff(a: "EventTracer", b: "EventTracer"
               ) -> Optional[Tuple[int, Optional[TraceEvent],
                                   Optional[TraceEvent]]]:
    """First divergence between two event streams, or ``None`` if they
    are bit-identical (counts, order, and every lane).

    Returns ``(index, event_a, event_b)``; a missing side is ``None``
    when one stream is a strict prefix of the other.
    """
    ea, eb = a.events(), b.events()
    for i, (x, y) in enumerate(zip(ea, eb)):
        if x != y:
            return (i, x, y)
    if len(ea) != len(eb):
        i = min(len(ea), len(eb))
        return (i, ea[i] if i < len(ea) else None,
                eb[i] if i < len(eb) else None)
    if a.total != b.total:
        return (len(ea), None, None)
    return None
