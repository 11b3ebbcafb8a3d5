"""Kernel profiling hooks: named regions + a wall-clock launch ledger
(port of ``repro.obs.profile``).

Every kernel wrapper in ``repro_torch.kernels.ops`` (and the per-shard
gcd exchange in ``repro_torch.core.engine.shard``) runs its body under
:func:`kernel_scope`, which does two things:

  * always opens a ``torch.profiler.record_function`` region of that
    name — metadata for ``torch.profiler`` traces, with zero numeric
    effect (the reference's ``jax.named_scope``);
  * when profiling is **enabled** (off by default), times the region
    with ``time.perf_counter`` and accumulates a per-name launch ledger
    ``{calls, items, wall_s}``.  Each wrapper copies its results back to
    the host inside the region, so the wall covers the launch and the
    wait for it.

The ledger is process-global on purpose: kernel launches happen deep
under cache internals where threading a handle through every call
would be pure noise, and wall clocks are only ever *reported* (into
the wall-clock-exempt ``obs`` block of ``BENCH_*.json``), never gated.
Disabled, the only residue is the region and one module-level boolean
check per launch.
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from typing import Dict

import torch

__all__ = ["kernel_scope", "enable", "enabled", "reset", "summary",
           "profiling"]

_enabled = False
_ledger: Dict[str, Dict[str, float]] = {}


def enable(on: bool = True) -> None:
    """Turn the wall-clock launch ledger on/off (named regions are
    always opened)."""
    global _enabled
    _enabled = bool(on)


def enabled() -> bool:
    return _enabled


def reset() -> None:
    """Drop all accumulated ledger entries."""
    _ledger.clear()


def summary() -> Dict[str, Dict[str, float]]:
    """Per-kernel launch ledger: ``{name: {calls, items, wall_s}}``."""
    return {name: dict(rec) for name, rec in sorted(_ledger.items())}


@contextmanager
def kernel_scope(name: str, items: int = 0):
    """Annotate (always) and, when enabled, time one kernel launch.

    ``items`` is the batch size the launch processed (composites,
    query primes, gcd pairs, ...) so the ledger can report per-item
    rates alongside raw walls.
    """
    with torch.profiler.record_function(name):
        if not _enabled:
            yield
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            rec = _ledger.setdefault(
                name, {"calls": 0, "items": 0, "wall_s": 0.0})
            rec["calls"] += 1
            rec["items"] += int(items)
            rec["wall_s"] += dt


@contextmanager
def profiling():
    """Scoped enable: ledger is reset and collected for the duration.

    Yields the live ledger dict so callers can snapshot it on exit::

        with profiling():
            run_benchmark()
            obs_block = {"kernel_launches": summary()}
    """
    prev = _enabled
    reset()
    enable(True)
    try:
        yield _ledger
    finally:
        enable(prev)
