"""Elastic scaling, failure handling, and straggler mitigation (port of
``repro.training.elastic``, which has no JAX in it: carried over
unchanged; the serving tier's ``ElasticController`` drives it).

Components
----------
* :class:`FleetState` — tracks healthy/failed/slow nodes from heartbeats.
* :class:`ElasticPlanner` — given the healthy node count, picks the
  largest valid mesh (pod x data x model) that preserves the model-axis
  requirement, and emits a re-shard plan (which checkpoint to restore,
  new mesh shape, new per-device batch).  Data-parallel size changes keep
  the GLOBAL batch constant by rescaling gradient-accumulation steps —
  bit-identical optimizer trajectory across elastic events.
* :class:`StragglerMonitor` — per-step timing ring buffer; flags nodes
  whose step time exceeds median * threshold repeatedly.  Mitigation
  policy: (1) within-step, rely on backup-task semantics at the input
  pipeline level (slow host's batch is re-assigned); (2) across steps,
  if a node stays slow for ``evict_after`` windows it is treated as
  failed and the ElasticPlanner re-plans without it.
* :class:`ManualClock` — the injectable clock every component reads, so
  tests drive fleet time by hand.
"""

from __future__ import annotations

import math
import time
from collections import defaultdict, deque
from dataclasses import dataclass, field
from typing import Callable, Deque, Dict, List, Optional, Sequence, Tuple

__all__ = ["FleetState", "ManualClock", "MeshPlan", "ElasticPlanner",
           "StragglerMonitor"]


class ManualClock:
    """Deterministic injectable clock for tests and chaos harnesses.

    Call it like ``time.monotonic`` (returns the current simulated
    time); ``advance(dt)`` moves time forward.  ``FleetState``,
    ``StragglerMonitor``, and ``serving.elastic.ElasticController`` all
    accept a ``clock=`` so no test path ever reads the wall clock.
    """

    def __init__(self, t: float = 0.0):
        self.t = float(t)

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> float:
        self.t += float(dt)
        return self.t


@dataclass
class FleetState:
    n_nodes: int
    chips_per_node: int = 4
    heartbeat_timeout_s: float = 30.0
    clock: Callable[[], float] = time.monotonic
    _last_seen: Dict[int, float] = field(default_factory=dict)
    _failed: set = field(default_factory=set)

    def heartbeat(self, node: int, t: Optional[float] = None) -> None:
        if node not in self._failed:
            self._last_seen[node] = t if t is not None else self.clock()

    def mark_failed(self, node: int) -> None:
        self._failed.add(node)
        self._last_seen.pop(node, None)

    def join(self, node: int, t: Optional[float] = None) -> None:
        """(Re-)admit a node — a replacement host or an elastic grow.
        Clears any failed mark and heartbeats it immediately."""
        self._failed.discard(node)
        self.n_nodes = max(self.n_nodes, node + 1)
        self.heartbeat(node, t)

    def sweep(self, now: Optional[float] = None) -> List[int]:
        """Expire silent nodes; returns newly-failed node ids."""
        now = now if now is not None else self.clock()
        newly = [n for n, t in self._last_seen.items()
                 if now - t > self.heartbeat_timeout_s]
        for n in newly:
            self.mark_failed(n)
        return newly

    @property
    def healthy_nodes(self) -> List[int]:
        return [n for n in range(self.n_nodes) if n not in self._failed]

    @property
    def healthy_chips(self) -> int:
        return len(self.healthy_nodes) * self.chips_per_node


@dataclass(frozen=True)
class MeshPlan:
    mesh_shape: Tuple[int, ...]
    mesh_axes: Tuple[str, ...]
    n_chips: int
    accum_steps: int                 # rescaled to keep global batch fixed
    restore_step: Optional[int]


class ElasticPlanner:
    """Pick the largest valid mesh for the surviving fleet.

    The model axis is fixed by the sharding plan (TP degree must divide
    heads/ff); the data (and pod) axes absorb the loss.  Preference order:
    keep pods symmetric; shrink data-parallel width to the largest
    power-of-two that fits; bump accumulation to hold global batch.
    """

    def __init__(self, model_axis: int = 16, base_data_axis: int = 16,
                 base_pods: int = 2, global_batch: int = 256,
                 base_accum: int = 1):
        self.model_axis = model_axis
        self.base_data = base_data_axis
        self.base_pods = base_pods
        self.global_batch = global_batch
        self.base_accum = base_accum

    def plan(self, healthy_chips: int,
             restore_step: Optional[int] = None) -> MeshPlan:
        if healthy_chips < self.model_axis:
            raise RuntimeError(
                f"cannot build model axis {self.model_axis} from "
                f"{healthy_chips} chips")
        max_groups = healthy_chips // self.model_axis   # data*pod capacity
        # largest power-of-two group count <= capacity
        groups = 1 << (max_groups.bit_length() - 1)
        pods = self.base_pods
        while pods > 1 and groups % pods != 0:
            pods //= 2
        data = groups // pods
        base_groups = self.base_data * self.base_pods
        scale = base_groups / groups
        accum = max(1, int(math.ceil(self.base_accum * scale)))
        if pods > 1:
            shape = (pods, data, self.model_axis)
            axes = ("pod", "data", "model")
        else:
            shape = (data, self.model_axis)
            axes = ("data", "model")
        return MeshPlan(shape, axes, groups * self.model_axis, accum,
                        restore_step)


class StragglerMonitor:
    def __init__(self, threshold: float = 1.5, window: int = 20,
                 evict_after: int = 3,
                 clock: Callable[[], float] = time.monotonic):
        self.threshold = threshold
        self.window = window
        self.evict_after = evict_after
        self.clock = clock
        self._times: Dict[int, Deque[float]] = defaultdict(
            lambda: deque(maxlen=window))
        self._strikes: Dict[int, int] = defaultdict(int)
        self._last_tick: Dict[int, float] = {}

    def record(self, node: int, step_time_s: float) -> None:
        self._times[node].append(step_time_s)

    def tick(self, node: int) -> Optional[float]:
        """Record a step boundary for ``node`` from the injected clock;
        returns the measured step time (``None`` on the first tick)."""
        now = self.clock()
        last = self._last_tick.get(node)
        self._last_tick[node] = now
        if last is None:
            return None
        dt = now - last
        self.record(node, dt)
        return dt

    def _medians(self) -> Dict[int, float]:
        out = {}
        for n, ts in self._times.items():
            if ts:
                s = sorted(ts)
                out[n] = s[len(s) // 2]
        return out

    def check(self) -> Tuple[List[int], List[int]]:
        """Returns (currently_slow, evict_candidates)."""
        med = self._medians()
        if not med:
            return [], []
        fleet_median = sorted(med.values())[len(med) // 2]
        slow = [n for n, m in med.items()
                if m > self.threshold * fleet_median]
        for n in list(self._strikes):
            if n not in slow:
                self._strikes[n] = 0
        evict = []
        for n in slow:
            self._strikes[n] += 1
            if self._strikes[n] >= self.evict_after:
                evict.append(n)
        return slow, evict
