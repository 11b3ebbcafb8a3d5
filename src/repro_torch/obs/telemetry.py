"""Serving telemetry: per-tick gauges, streaming histograms, and
progress/rate reporting (port of ``repro.obs.telemetry``, which has no
JAX in it: carried over unchanged).

Everything here is **read-only over serving state**: a snapshot pulls
queue depth, slot occupancy, phase mix, counter deltas, per-tenant
charged HBM (refcount-weighted when the dedup tier is active), and
per-shard scan-slice peaks out of an engine or slot machine, and stores
them in bounded rings.  No snapshot ever writes back into the object it
observes, which is the whole inertness argument: with telemetry
attached, the serving stack computes byte-for-byte the same placement
it computes without it.

Histograms are power-of-two bucketed (``value.bit_length()``), so they
are deterministic for the integer quantities they record (tick
latencies, queue depths) — percentile *estimates* come from bucket
upper bounds, exact min/max/mean come from exact accumulators.
"""

from __future__ import annotations

import sys
import time
from typing import Dict, List, Optional

__all__ = ["StreamingHist", "Telemetry", "Progress"]


class StreamingHist:
    """Streaming histogram over non-negative integers with power-of-two
    buckets: bucket ``k`` holds values with ``bit_length() == k``
    (i.e. ``[2^(k-1), 2^k)``; bucket 0 holds the zeros)."""

    def __init__(self) -> None:
        self.counts: Dict[int, int] = {}
        self.n = 0
        self.total = 0
        self.min: Optional[int] = None
        self.max: Optional[int] = None

    def add(self, value: int) -> None:
        v = int(value)
        if v < 0:
            v = 0
        b = v.bit_length()
        self.counts[b] = self.counts.get(b, 0) + 1
        self.n += 1
        self.total += v
        self.min = v if self.min is None else min(self.min, v)
        self.max = v if self.max is None else max(self.max, v)

    def quantile(self, q: float) -> int:
        """Upper-bound estimate of the ``q``-quantile from the bucket
        boundaries (exact for values 0 and 1, within 2x above)."""
        if not self.n:
            return 0
        want = max(1, int(q * self.n + 0.999999))
        seen = 0
        for b in sorted(self.counts):
            seen += self.counts[b]
            if seen >= want:
                return (1 << b) - 1 if b else 0
        return self.max or 0

    def summary(self) -> dict:
        return {
            "count": self.n,
            "sum": self.total,
            "mean": self.total / self.n if self.n else 0.0,
            "min": self.min or 0,
            "max": self.max or 0,
            "p50": self.quantile(0.50),
            "p90": self.quantile(0.90),
            "p99": self.quantile(0.99),
            "buckets": {str(k): v for k, v in sorted(self.counts.items())},
        }


class Telemetry:
    """Bounded per-tick gauge rings + named streaming histograms.

    ``gauge(name, value, tick)`` appends to a ring of the last
    ``capacity`` samples per name; ``observe(name, value)`` feeds the
    named histogram.  ``tick_slots``/``tick_engine`` are the canonical
    snapshot points wired into ``SlotMachine``/``SlotOracle`` ticks and
    ``ServingEngine.step()``.
    """

    def __init__(self, capacity: int = 4096):
        self.capacity = int(capacity)
        self.gauges: Dict[str, List[List[float]]] = {}
        self.hists: Dict[str, StreamingHist] = {}
        self.ticks_seen = 0

    # -- primitives -------------------------------------------------------- #

    def gauge(self, name: str, value, tick: int = -1) -> None:
        ring = self.gauges.setdefault(name, [])
        ring.append([int(tick), float(value)])
        if len(ring) > self.capacity:
            del ring[:len(ring) - self.capacity]

    def observe(self, name: str, value: int) -> None:
        self.hists.setdefault(name, StreamingHist()).add(value)

    # -- canonical snapshot points ----------------------------------------- #

    def tick_slots(self, m) -> None:
        """Per-tick gauges from a slot front-end (machine or oracle):
        queue depth, phase mix, live occupancy — all via the shared
        ``obs_slot_mix()`` accessor so both twins report identically."""
        tick = int(m.now)
        free, prefill, decode = m.obs_slot_mix()
        self.gauge("queue_depth", len(m.waiting), tick)
        self.gauge("slots_free", free, tick)
        self.gauge("slots_prefill", prefill, tick)
        self.gauge("slots_decode", decode, tick)
        self.gauge("live", prefill + decode, tick)
        self.observe("queue_depth", len(m.waiting))
        self._snap_pages(m.pages, tick)
        self.ticks_seen += 1

    def tick_engine(self, eng) -> None:
        """Per-step gauges from a ``ServingEngine``: queue depth, live
        slots, cache counters, per-tenant charged HBM, shard scan
        slices."""
        tick = int(getattr(eng, "steps", self.ticks_seen))
        live = sum(1 for s in eng.slots if s is not None)
        self.gauge("queue_depth", len(eng.queue), tick)
        self.gauge("live", live, tick)
        self.observe("queue_depth", len(eng.queue))
        self._snap_pages(eng.pages, tick)
        self.ticks_seen += 1

    def _snap_pages(self, pages, tick: int) -> None:
        st = pages.stats
        self.gauge("hbm_hits", st.hbm_hits, tick)
        self.gauge("misses", st.misses, tick)
        self.gauge("prefetches", st.prefetches, tick)
        self.gauge("evictions", st.evictions, tick)
        self.gauge("prefetch_hit_rate", st.prefetch_hit_rate, tick)
        # per-tenant charged HBM: refcount-weighted under dedup, plain
        # quota occupancy under tenancy, absent otherwise
        if hasattr(pages, "charged_shares"):
            for t, v in enumerate(pages.charged_shares()):
                self.gauge(f"tenant{t}_charged_pages", float(v), tick)
        elif hasattr(pages, "qos"):
            for t, v in enumerate(pages.qos.occupancy):
                self.gauge(f"tenant{t}_charged_pages", int(v), tick)
        # per-shard scan-slice peaks (sharded/elastic backends)
        scan = getattr(pages, "last_scan", None)
        if scan is not None and scan.local_composites:
            self.gauge("scan_slice_peak", max(scan.local_composites),
                       tick)
            self.gauge("scan_cross_composites", scan.cross_composites,
                       tick)

    def complete(self, ttft_ticks: int, tpot_milliticks: int) -> None:
        """Request-completion latency observations (engine ticks; TPOT
        scaled x1000 so sub-tick decode rates survive integer
        buckets)."""
        self.observe("ttft_ticks", ttft_ticks)
        self.observe("tpot_milliticks", tpot_milliticks)

    # -- export ------------------------------------------------------------- #

    def export(self) -> dict:
        return {
            "capacity": self.capacity,
            "ticks_seen": self.ticks_seen,
            "gauges": {k: [list(s) for s in v]
                       for k, v in sorted(self.gauges.items())},
            "hists": {k: h.summary()
                      for k, h in sorted(self.hists.items())},
        }


class Progress:
    """Host-side progress/rate reporter for long deterministic builds
    (the ``case_scale`` 1M-element registry loop).

    Rate accounting always runs (the totals feed the benchmark ``obs``
    block); *printing* is throttled to ``interval_s`` and suppressed
    entirely under ``quiet=True`` — the CI default, where 20 seconds of
    progress lines would only bloat logs.
    """

    def __init__(self, total: int, label: str = "", quiet: bool = False,
                 interval_s: float = 2.0, stream=None):
        self.total = int(total)
        self.label = label
        self.quiet = bool(quiet)
        self.interval_s = float(interval_s)
        self.stream = stream if stream is not None else sys.stderr
        self.done_n = 0
        self.t0 = time.perf_counter()
        self._last_print = self.t0

    def advance(self, n: int = 1) -> None:
        self.done_n += int(n)
        if self.quiet:
            return
        now = time.perf_counter()
        if (now - self._last_print) >= self.interval_s \
                and self.done_n < self.total:
            self._last_print = now
            self._print(now)

    def _print(self, now: float) -> None:
        rate = self.done_n / max(now - self.t0, 1e-9)
        pct = 100.0 * self.done_n / max(self.total, 1)
        print(f"  {self.label}: {self.done_n:,}/{self.total:,} "
              f"({pct:.1f}%)  {rate:,.0f}/s", file=self.stream)

    @property
    def rate(self) -> float:
        return self.done_n / max(time.perf_counter() - self.t0, 1e-9)

    def finish(self) -> dict:
        """Close out (prints a final line unless quiet) and return the
        rate summary for the benchmark ``obs`` block."""
        wall = time.perf_counter() - self.t0
        if not self.quiet:
            print(f"  {self.label}: {self.done_n:,}/{self.total:,} "
                  f"done in {wall:.1f}s "
                  f"({self.done_n / max(wall, 1e-9):,.0f}/s)",
                  file=self.stream)
        return {"label": self.label, "n": self.done_n,
                "wall_s": wall,
                "per_s": self.done_n / max(wall, 1e-9)}
