"""PFCS observability layer: event tracing, serving telemetry, kernel
profiling (port of ``repro.obs``) — disabled by default, provably inert
when off.

Every serving cache, slot front-end, and engine carries an ``obs``
attribute that defaults to ``None``; every hook in the hot paths is
guarded by ``if self.obs is not None``.  Attaching an
:class:`Observability` turns on event recording and telemetry
snapshots without touching a single placement decision — the
tracing-off parity sweep in ``tests/test_torch_obs.py`` pins that the
counters, tier logs, LRU orders, and prefetch logs of every backend
are bit-identical with ``obs=None``, with a zero-capacity tracer, and
with a live tracer attached, and that the port's event streams equal
the reference's under :func:`~repro_torch.obs.trace.trace_diff`.

:class:`Observability` (the façade),
:class:`~repro_torch.obs.trace.EventTracer` (the int32 event ring),
:func:`~repro_torch.obs.trace.trace_diff` (the differential-trace axis),
:class:`~repro_torch.obs.telemetry.Telemetry` (gauges + histograms),
:class:`~repro_torch.obs.telemetry.Progress` (host-side rate reporting),
and :func:`~repro_torch.obs.profile.kernel_scope` (a
``torch.profiler.record_function`` region + launch-ledger profiling).
"""

from __future__ import annotations

import json
from typing import Optional

from . import profile
from .telemetry import Progress, StreamingHist, Telemetry
from .trace import (EVENT_FIELDS, EVENT_NAMES, EV_ADMIT, EV_AGE_OUT,
                    EV_COMPLETE, EV_COW, EV_DEDUP_HIT, EV_DEDUP_PROMOTE,
                    EV_EVICT, EV_GCD_EXCHANGE, EV_PREEMPT, EV_PREFETCH,
                    EV_PREFILL_CHUNK, EV_RECOVERY, EV_RESUME_PREFETCH,
                    EventTracer, TraceEvent, trace_diff)

__all__ = [
    "Observability", "EventTracer", "TraceEvent", "trace_diff",
    "Telemetry", "StreamingHist", "Progress", "profile",
    "EVENT_FIELDS", "EVENT_NAMES",
    "EV_ADMIT", "EV_PREFILL_CHUNK", "EV_PREEMPT", "EV_RESUME_PREFETCH",
    "EV_COMPLETE", "EV_EVICT", "EV_PREFETCH", "EV_DEDUP_HIT",
    "EV_DEDUP_PROMOTE", "EV_COW", "EV_AGE_OUT", "EV_GCD_EXCHANGE",
    "EV_RECOVERY",
]


class Observability:
    """The attachable observability façade: one event tracer + one
    telemetry sink, carried by caches / slot machines / engines as
    their ``obs`` attribute.

    ``trace_capacity=0`` keeps the tracer attached but recording
    nothing (pure counter bumps); ``telemetry=False`` drops the
    telemetry sink entirely.  The kernel profiling ledger is
    process-global (``repro_torch.obs.profile``) and merely *reported* here.
    """

    def __init__(self, trace_capacity: int = 4096,
                 telemetry: bool = True,
                 telemetry_capacity: int = 4096):
        self.trace = EventTracer(trace_capacity)
        self.telemetry: Optional[Telemetry] = (
            Telemetry(telemetry_capacity) if telemetry else None)

    # hot-path hook: one guarded call in the instrumented sites
    def emit(self, kind: int, **lanes) -> None:
        self.trace.emit(kind, **lanes)

    def export(self) -> dict:
        """Everything observed, as one JSON-ready payload (the input
        format of ``tools/trace_view.py``)."""
        return {
            "schema": {str(k): v for k, v in EVENT_NAMES.items()},
            "trace": self.trace.export(),
            "telemetry": (self.telemetry.export()
                          if self.telemetry is not None else None),
            "kernel_launches": profile.summary(),
        }

    def export_json(self, path) -> None:
        with open(path, "w") as fh:
            json.dump(self.export(), fh, indent=1, sort_keys=True)
            fh.write("\n")


def attach(target, obs: Optional[Observability]) -> Optional[Observability]:
    """Attach ``obs`` to an engine / slot front-end and its cache
    tiers (``pages`` and, when present, ``experts``).  Returns ``obs``
    for chaining; ``attach(target, None)`` detaches."""
    target.obs = obs
    for attr in ("pages", "experts"):
        tier = getattr(target, attr, None)
        if tier is not None:
            tier.obs = obs
    return obs
