"""Engine entry points: a batch of traces through one system in one kernel.

``simulate_batch`` stacks the traces on a leading axis (shorter traces
padded with key ``-1``, an exact no-op step, so ragged batches lose
nothing) and hands them to the engine's scans
(``repro_torch.kernels.engine``): on a card one launch of
``csrc/engine_baseline.cu`` or ``csrc/engine_pfcs.cu``, one thread block
per trace; on the CPU the step functions of this package run as a Python
loop over the trace.  Per-trace PFCS tables ride along as batched inputs.

All state is int32 except ARC's adaptive target ``p``, a float64 whose
arithmetic is CPython's, so every counter equals the scalar oracle's.

``AccessStats`` assembly mirrors the scalar simulators field for field,
so callers (benchmarks, Table 1 derivations) cannot tell which engine
produced a result, except by wall clock.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device

from ..metrics import AccessStats
from ..traces import Trace
from .tables import PFCSTables, pfcs_tables

__all__ = ["simulate_trace", "simulate_batch", "sweep", "VECTORIZED_SYSTEMS",
           "key_space", "stack_accesses", "stack_tables"]

#: systems the engine can simulate (the semantic baseline stays scalar:
#: its RNG noise is consumed in miss order, which is inherently serial)
VECTORIZED_SYSTEMS = ("lru", "fifo", "2q", "arc", "lirs", "pfcs")

_DEFAULT_LEVELS = (("L1", 64), ("L2", 512), ("L3", 4096))


# --------------------------------------------------------------------------- #
# AccessStats assembly                                                        #
# --------------------------------------------------------------------------- #

def _baseline_stats(policy: str, caps, out: Dict, i: int) -> AccessStats:
    hits = out["hits"][i].tolist()
    st = AccessStats(name=policy.upper())
    st.hits_per_level = {name: int(h) for (name, _), h in zip(caps, hits)}
    st.hits_per_level["MEM"] = int(hits[len(caps)])
    st.misses = int(out["miss"][i])
    st.demand_accesses = int(out["demand"][i])
    return st


def _pfcs_stats(caps, out: Dict, tables: PFCSTables, i: int) -> AccessStats:
    hits = out["hits"][i].tolist()
    st = AccessStats(name="PFCS")
    st.hits_per_level = {name: int(h) for (name, _), h in zip(caps, hits)}
    st.misses = int(out["miss"][i])
    st.demand_accesses = int(out["demand"][i])
    st.prefetches_issued = int(out["issued"][i])
    st.prefetches_used = int(out["used"][i])
    st.prefetches_true = int(out["true"][i])
    st.extra_backing_fetches = st.prefetches_issued
    st.factor_ops = dict(tables.factor_ops)
    return st


# --------------------------------------------------------------------------- #
# public entry points                                                         #
# --------------------------------------------------------------------------- #

def key_space(traces: Sequence[Trace]) -> int:
    """The key universe a batch's state must cover."""
    return max(max(tr.n_keys, int(tr.accesses.max(initial=0)) + 1)
               for tr in traces)


def stack_accesses(traces: Sequence[Trace], device) -> torch.Tensor:
    """(B, T) int32 accesses on ``device``, shorter traces padded with -1
    (a no-op step)."""
    acc = np.full((len(traces), max(tr.length for tr in traces)), -1,
                  dtype=np.int32)
    for i, tr in enumerate(traces):
        acc[i, :tr.length] = np.asarray(tr.accesses, dtype=np.int32)
    return torch.from_numpy(acc).to(device)


def stack_tables(tables: Sequence[PFCSTables], device) -> Tuple:
    """The per-trace PFCS tables stacked on ``device`` as the PFCS scan
    takes them: (B, K, budget) int32 targets, (B, K, budget) bool truth,
    (B, K) int32 degrees."""
    def stack(name, dtype):
        return torch.from_numpy(np.stack(
            [np.asarray(getattr(tb, name)) for tb in tables])
            .astype(dtype)).to(device)

    return (stack("targets", np.int32), stack("truth", bool),
            stack("degree", np.int32))


def simulate_trace(trace: Trace, system: str,
                   capacities: Sequence[Tuple[str, int]] = _DEFAULT_LEVELS,
                   *, prefetch_budget: int = 4, victim_window: int = 8,
                   enable_prefetch: bool = True,
                   prefetch_trigger: str = "miss",
                   discover: str = "host",
                   tables: Optional[PFCSTables] = None,
                   device="cuda") -> AccessStats:
    """Simulate ONE trace on the engine -> AccessStats, equal to
    ``simulate_baseline(system, trace, capacities)`` /
    ``simulate_pfcs(trace, capacities, ...)`` on every counter the scalar
    oracles produce.  ``device`` is where the engine runs."""
    return simulate_batch([trace], system, capacities,
                          prefetch_budget=prefetch_budget,
                          victim_window=victim_window,
                          enable_prefetch=enable_prefetch,
                          prefetch_trigger=prefetch_trigger,
                          discover=discover,
                          tables=[tables] if tables is not None else None,
                          device=device)[0]


def simulate_batch(traces: Sequence[Trace], system: str,
                   capacities: Sequence[Tuple[str, int]] = _DEFAULT_LEVELS,
                   *, prefetch_budget: int = 4, victim_window: int = 8,
                   enable_prefetch: bool = True,
                   prefetch_trigger: str = "miss",
                   discover: str = "host",
                   tables: Optional[Sequence[PFCSTables]] = None,
                   device="cuda") -> List[AccessStats]:
    """Simulate a batch of traces in ONE engine scan.

    Traces may have ragged lengths (padded with no-op steps) and ragged
    key spaces (state sized to the largest).  PFCS tables are built here
    with ``discover`` on ``device`` unless the caller passes them.
    Returns one ``AccessStats`` per trace, in order.
    """
    from repro_torch.kernels.engine import baseline_scan, pfcs_scan

    dev = resolve_device(device)
    system = system.lower()
    if system not in VECTORIZED_SYSTEMS:
        raise ValueError(f"engine cannot simulate {system!r}; "
                         f"supported: {VECTORIZED_SYSTEMS}")
    caps = tuple((str(n), int(c)) for n, c in capacities)
    n = len(traces)
    n_keys = key_space(traces)
    acc = stack_accesses(traces, dev)

    if system == "pfcs":
        budget_cols = max(1, int(prefetch_budget))
        if tables is not None:
            # caller-built tables define the key universe (targets may
            # index keys the residency array must be able to hold)
            sizes = {tb.targets.shape[0] for tb in tables}
            if len(sizes) > 1:
                raise ValueError(f"tables disagree on key-space size: "
                                 f"{sorted(sizes)}")
            if max(sizes) < n_keys:
                raise ValueError(
                    f"tables cover {max(sizes)} keys but the traces reach "
                    f"key {n_keys - 1}; rebuild with n_keys>={n_keys}")
            n_keys = max(sizes)
            if any(tb.targets.shape[1] != budget_cols for tb in tables):
                raise ValueError(
                    f"tables built for budget {tables[0].targets.shape[1]}, "
                    f"run requested {budget_cols}; rebuild with matching "
                    f"prefetch_budget")
        if tables is None:
            tables = [pfcs_tables(tr, caps, prefetch_budget, victim_window,
                                  enable_prefetch, prefetch_trigger,
                                  discover, n_keys=n_keys, device=dev)
                      for tr in traces]
        out = pfcs_scan(acc, [c for _, c in caps], n_keys, budget_cols,
                        int(victim_window), bool(enable_prefetch),
                        prefetch_trigger == "always",
                        *stack_tables(tables, dev))
        out = {k: v.cpu() for k, v in out.items()
               if k not in ("state", "visits", "placement")}
        return [_pfcs_stats(caps, out, tables[i], i) for i in range(n)]

    out = baseline_scan(acc, system, [c for _, c in caps], n_keys)
    out = {k: v.cpu() for k, v in out.items()
           if k not in ("state", "visits", "placement")}
    return [_baseline_stats(system, caps, out, i) for i in range(n)]


def sweep(traces: Sequence[Trace], systems: Sequence[str],
          capacity_configs: Sequence[Sequence[Tuple[str, int]]],
          **kw) -> Dict[Tuple[str, int], List[AccessStats]]:
    """Systems x capacity-configs x traces sweep.

    Returns ``{(system, config_index): [AccessStats per trace]}``; each
    (system, config) cell is one batched run over all traces.  Keyword
    arguments (``device`` among them) go to :func:`simulate_batch`.
    """
    out: Dict[Tuple[str, int], List[AccessStats]] = {}
    for ci, caps in enumerate(capacity_configs):
        for system in systems:
            out[(system, ci)] = simulate_batch(traces, system, caps, **kw)
    return out
