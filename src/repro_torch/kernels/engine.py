"""The Table-1 engine's trace scans: CUDA kernels and their wrappers.

``baseline_scan`` (``csrc/engine_baseline.cu``) and ``pfcs_scan``
(``csrc/engine_pfcs.cu``) run a whole batch of traces through a baseline
system (one policy plus the tier shadow) or through PFCS, one thread
block per trace, in one launch.  They replace the ``lax.scan`` loops of
the reference, ``repro/core/engine/batch.py:47`` (``_baseline_core``) and
``batch.py:82`` (``_pfcs_core``), with the step functions those scan
(``policies_vec.py``, ``hierarchy.py``, ``pfcs_vec.py``).  This module has
no counterpart in the reference, like ``cuda.py``.

The plain versions, ``baseline_scan_ref`` and ``pfcs_scan_ref``, are the
step functions of ``repro_torch/core/engine/`` run as a Python loop over
the trace with the batch as a leading dimension.  A wrapper runs the
kernel for CUDA tensors and the plain version for CPU tensors; it never
falls back from one to the other.  Both return the counters and the final
state in the step functions' layout (the kernel's state is a view of its
scratch, laid out by ``baseline_layout`` / ``pfcs_layout``, whose offsets
the wrapper hands to the kernel), so the two can be compared array by
array; the kernel also returns ``visits``, the slot words its scans read,
a diagnostic (the plain version ``None``).

Stamps are int32 micro-op ticks: each access advances ``POLICY_TICKS``
(baselines) or ``levels + budget`` (PFCS) of them, so both scans refuse a
trace of ``2**31 / ticks`` accesses or more, for every caller.
"""

from __future__ import annotations

import ctypes
from itertools import accumulate
from typing import Dict, List, Sequence, Tuple

import torch

from ..core.engine.hierarchy import build_hierarchy
from ..core.engine.layout import tree_where
from ..core.engine.pfcs_vec import build_pfcs
from ..core.engine.policies_vec import POLICY_TICKS, lirs_sizes, twoq_sizes
from .cuda import CudaKernel

__all__ = ["baseline_scan", "pfcs_scan", "baseline_scan_ref",
           "pfcs_scan_ref", "baseline_layout", "pfcs_layout",
           "ENGINE_BASELINE", "ENGINE_PFCS", "POLICY_IDS", "MAX_LEVELS",
           "STAMP_SPACE"]

_P = ctypes.c_void_p
_I64 = ctypes.c_longlong
_INT = ctypes.c_int

ENGINE_BASELINE = CudaKernel(
    "engine_baseline", "engine_baseline.cu", "pfcs_engine_baseline",
    [_P, _I64, _I64, _INT, _P, _INT, _INT, _INT, _INT, _INT, _INT, _P, _I64,
     _P, _INT, _P, _P, _P, _P])
ENGINE_PFCS = CudaKernel(
    "engine_pfcs", "engine_pfcs.cu", "pfcs_engine_pfcs",
    [_P, _I64, _I64, _P, _INT, _INT, _INT, _INT, _INT, _INT, _P, _P, _P, _P,
     _I64, _P, _INT, _P, _P, _P])

#: the policy codes of ``engine_baseline.cu``
POLICY_IDS = {"lru": 0, "fifo": 1, "2q": 2, "arc": 3, "lirs": 4}
#: the most cache levels the kernels take
MAX_LEVELS = 8
#: int32 stamps: an access's ticks times the trace length stay below this
STAMP_SPACE = 2**31


def baseline_layout(policy: str, total: int,
                    n_keys: int) -> List[Tuple[Tuple[str, ...], int]]:
    """The int32 words of one trace's baseline state, in the kernel's
    order: ``[(path in the state dict, words), ...]``."""
    pol: List[Tuple[str, int]]
    if policy in ("lru", "fifo"):
        pol = [("keys", total), ("t" if policy == "lru" else "ins", total)]
    elif policy == "2q":
        kin, kout, km = twoq_sizes(total)
        pol = [("a1k", kin), ("a1t", kin), ("aok", kout), ("aot", kout),
               ("amk", km), ("amt", km)]
    elif policy == "arc":
        pol = [(name, total) for name in ("t1k", "t1t", "t2k", "t2t", "b1k",
                                          "b1t")]
        pol += [("b2k", 2 * total + 1), ("b2t", 2 * total + 1)]
    elif policy == "lirs":
        pol = [(name, n_keys) for name in ("status", "s_t", "q_t", "res")]
        pol += [("n_lir", 1), ("n_res", 1)]
    else:
        raise ValueError(f"unknown policy {policy!r}")
    return ([(("shk",), total), (("sht",), total)]
            + [(("pol", name), n) for name, n in pol])


def pfcs_layout(caps: Sequence[int],
                n_keys: int) -> List[Tuple[Tuple, int]]:
    """The int32 words of one trace's PFCS state, in the kernel's order."""
    out: List[Tuple[Tuple, int]] = []
    for i, c in enumerate(caps):
        out += [(("levels", i, f), int(c) + 1)
                for f in ("keys", "t", "pf", "deg")]
    return out + [(("where",), n_keys)]


def _offsets(layout) -> ctypes.Array:
    """The word at which each array of ``layout`` starts, as the host
    array the kernels take."""
    starts = [0, *accumulate(n for _, n in layout)][:-1]
    return (ctypes.c_longlong * len(starts))(*starts)


def _unflatten(layout, scratch: torch.Tensor) -> Dict:
    """Views of ``scratch`` (B, words) named by ``layout``, each at the
    offset ``_offsets`` hands the kernel."""
    out: Dict = {}
    for (path, n), at in zip(layout, _offsets(layout)):
        node = out
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = scratch[:, at:at + n]
    return out


def _check_stamp_space(length: int, ticks: int) -> None:
    """Refuse ``length`` accesses of ``ticks`` stamp ticks each when the
    stamps would leave int32: past 2**31 they wrap into the negative init
    stamps and silently corrupt recency order."""
    if length * ticks >= STAMP_SPACE:
        raise ValueError(
            f"trace length {length} x {ticks} stamp ticks/access exceeds "
            f"the engine's int32 stamp space ({STAMP_SPACE - 1}); split the "
            f"trace into <= {(STAMP_SPACE - 1) // ticks}-access segments")


def _check_accesses(accesses: torch.Tensor, n_keys: int) -> None:
    if accesses.dtype != torch.int32 or accesses.dim() != 2:
        raise TypeError(f"expected (B, T) int32 accesses, got "
                        f"{accesses.dtype} {tuple(accesses.shape)}")
    if not accesses.is_contiguous():
        raise ValueError("expected contiguous accesses")
    if accesses.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {accesses.device}")
    if accesses.numel() and int(accesses.max()) >= n_keys:
        raise ValueError(f"a key reaches {int(accesses.max())}, outside "
                         f"the {n_keys}-key universe")


def _check_levels(caps: Sequence[int]) -> None:
    if not 1 <= len(caps) <= MAX_LEVELS or min(caps) < 1:
        raise ValueError(f"expected 1 to {MAX_LEVELS} levels of capacity "
                         f">= 1, got {list(caps)}")


# --------------------------------------------------------------------------- #
# baseline systems                                                            #
# --------------------------------------------------------------------------- #

def baseline_scan_ref(accesses: torch.Tensor, policy: str,
                      caps: Sequence[int], n_keys: int) -> Dict:
    """The plain version: ``hierarchy.build_hierarchy``'s step over every
    column of ``accesses`` (B, T), a padded step (key < 0) leaving its
    row's state as it was."""
    batch, length = accesses.shape
    dev = accesses.device
    state, step = build_hierarchy(policy, [(str(i), c)
                                           for i, c in enumerate(caps)],
                                  n_keys, batch, dev)
    n_levels = len(caps)
    bins = torch.arange(n_levels + 1, device=dev)
    hits = torch.zeros((batch, n_levels + 1), dtype=torch.int32, device=dev)
    miss = torch.zeros((batch,), dtype=torch.int32, device=dev)
    demand = torch.zeros_like(miss)
    unpadded = (accesses >= 0).all(0).tolist()     # one read, not T
    for t in range(length):
        key = accesses[:, t]
        valid = key >= 0
        s2, (hit, tier) = step(state, key.clamp(min=0), t * POLICY_TICKS)
        state = s2 if unpadded[t] else tree_where(valid, s2, state)
        hit = hit & valid
        hits += ((bins == tier[:, None]) & hit[:, None]).to(torch.int32)
        miss += (valid & ~hit).to(torch.int32)
        demand += valid.to(torch.int32)
    return {"hits": hits, "miss": miss, "demand": demand, "state": state,
            "visits": None}


def baseline_scan(accesses: torch.Tensor, policy: str, caps: Sequence[int],
                  n_keys: int) -> Dict:
    """Run a batch of traces through one baseline system: ``accesses`` is
    (B, T) int32, -1 padding; ``caps`` the level capacities; keys below
    ``n_keys``.  Returns ``{"hits": (B, L+1) (MEM last), "miss": (B,),
    "demand": (B,), "state": {...}, "visits": (B,) int64 or None}``."""
    if policy not in POLICY_IDS:
        raise ValueError(f"unknown policy {policy!r}")
    caps = [int(c) for c in caps]
    _check_levels(caps)
    if accesses.dim() == 2:
        _check_stamp_space(accesses.shape[1], POLICY_TICKS)
    _check_accesses(accesses, n_keys)
    if accesses.device.type == "cpu":
        return baseline_scan_ref(accesses, policy, caps, n_keys)
    dev = accesses.device
    batch, length = accesses.shape
    total = sum(caps)
    layout = baseline_layout(policy, total, n_keys)
    offsets = _offsets(layout)
    words = sum(n for _, n in layout)
    scratch = torch.empty((batch, words), dtype=torch.int32, device=dev)
    cums = torch.tensor(list(accumulate(caps)), dtype=torch.int32,
                        device=dev)
    n_levels = len(caps)
    counters = torch.empty((batch, n_levels + 3), dtype=torch.int32,
                           device=dev)
    p_out = torch.empty((batch,), dtype=torch.float64, device=dev)
    visits = torch.empty((batch,), dtype=torch.int64, device=dev)
    if policy == "2q":
        sizes = twoq_sizes(total)
    elif policy == "lirs":
        sizes = (total, lirs_sizes(total)[1], 0)
    else:
        sizes = (0, 0, 0)
    if batch:
        ENGINE_BASELINE.launch(dev, accesses.data_ptr(), batch, length,
                               POLICY_IDS[policy], cums.data_ptr(), n_levels,
                               total, *sizes, n_keys, scratch.data_ptr(),
                               words, ctypes.addressof(offsets),
                               len(offsets), p_out.data_ptr(),
                               counters.data_ptr(), visits.data_ptr())
    state = _unflatten(layout, scratch)
    if policy == "arc":
        state["pol"]["p"] = p_out
    if policy == "lirs":
        pol = state["pol"]
        pol["res"] = pol["res"].bool()
        pol["n_lir"], pol["n_res"] = pol["n_lir"][:, 0], pol["n_res"][:, 0]
    return {"hits": counters[:, :n_levels + 1],
            "miss": counters[:, n_levels + 1],
            "demand": counters[:, n_levels + 2], "state": state,
            "visits": visits}


# --------------------------------------------------------------------------- #
# PFCS                                                                        #
# --------------------------------------------------------------------------- #

def pfcs_scan_ref(accesses: torch.Tensor, caps: Sequence[int], n_keys: int,
                  budget: int, window: int, enable_prefetch: bool,
                  always: bool, targets: torch.Tensor, truth: torch.Tensor,
                  degree: torch.Tensor) -> Dict:
    """The plain version: ``pfcs_vec.build_pfcs``'s step over every column
    of ``accesses``."""
    batch, length = accesses.shape
    state, micro, step = build_pfcs([(str(i), c) for i, c in enumerate(caps)],
                                    n_keys, budget, window, enable_prefetch,
                                    always, batch, accesses.device)
    for t in range(length):
        state = step(state, accesses[:, t], t * micro, targets, truth,
                     degree)
    stats = state["stats"]
    return {**stats, "state": {"levels": state["levels"],
                               "where": state["where"]}, "visits": None}


def pfcs_scan(accesses: torch.Tensor, caps: Sequence[int], n_keys: int,
              budget: int, window: int, enable_prefetch: bool, always: bool,
              targets: torch.Tensor, truth: torch.Tensor,
              degree: torch.Tensor) -> Dict:
    """Run a batch of traces through PFCS: ``accesses`` (B, T) int32, -1
    padding; the discovery tables (B, K, budget) int32 targets (-1 pad),
    (B, K, budget) bool truth and (B, K) int32 degrees.  Returns
    ``{"hits": (B, L), "miss", "demand", "issued", "used", "true": (B,),
    "state": {...}, "visits": (B,) int64 or None}``."""
    caps = [int(c) for c in caps]
    _check_levels(caps)
    if accesses.dim() == 2:
        _check_stamp_space(accesses.shape[1], len(caps) + budget)
    _check_accesses(accesses, n_keys)
    batch = accesses.shape[0]
    if (targets.dtype != torch.int32 or degree.dtype != torch.int32
            or truth.dtype != torch.bool):
        raise TypeError("expected int32 targets and degrees, bool truth")
    if (targets.shape != (batch, n_keys, budget) or truth.shape !=
            targets.shape or degree.shape != (batch, n_keys)):
        raise ValueError(f"tables {tuple(targets.shape)} / "
                         f"{tuple(truth.shape)} / {tuple(degree.shape)} do "
                         f"not fit {batch} traces of {n_keys} keys, budget "
                         f"{budget}")
    if any(t.device != accesses.device for t in (targets, truth, degree)):
        raise ValueError("tables and accesses on different devices")
    if targets.numel() and (int(targets.max()) >= n_keys
                            or int(targets.min()) < -1):
        raise ValueError("a prefetch target lies outside the key universe")
    if accesses.device.type == "cpu":
        return pfcs_scan_ref(accesses, caps, n_keys, budget, window,
                             enable_prefetch, always, targets, truth, degree)
    dev = accesses.device
    length = accesses.shape[1]
    layout = pfcs_layout(caps, n_keys)
    offsets = _offsets(layout)
    words = sum(n for _, n in layout)
    scratch = torch.empty((batch, words), dtype=torch.int32, device=dev)
    n_levels = len(caps)
    counters = torch.empty((batch, n_levels + 5), dtype=torch.int32,
                           device=dev)
    visits = torch.empty((batch,), dtype=torch.int64, device=dev)
    caps_t = torch.tensor(caps, dtype=torch.int32, device=dev)
    targets, degree = targets.contiguous(), degree.contiguous()
    truth8 = truth.to(torch.uint8).contiguous()
    if batch:
        ENGINE_PFCS.launch(dev, accesses.data_ptr(), batch, length,
                           caps_t.data_ptr(), n_levels, n_keys,
                           budget if enable_prefetch else 0, budget,
                           int(window), int(bool(always)),
                           targets.data_ptr(), truth8.data_ptr(),
                           degree.data_ptr(), scratch.data_ptr(), words,
                           ctypes.addressof(offsets), len(offsets),
                           counters.data_ptr(), visits.data_ptr())
    state = _unflatten(layout, scratch)
    levels = tuple(dict(state["levels"][i], pf=state["levels"][i]["pf"]
                        .bool()) for i in range(n_levels))
    c = counters
    return {"hits": c[:, :n_levels], "miss": c[:, n_levels],
            "demand": c[:, n_levels + 1], "issued": c[:, n_levels + 2],
            "used": c[:, n_levels + 3], "true": c[:, n_levels + 4],
            "state": {"levels": levels, "where": state["where"]},
            "visits": visits}
