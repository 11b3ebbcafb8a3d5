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
state in the step functions' layout (``baseline_layout`` /
``pfcs_layout``), so the two can be compared array by array; the kernel
also returns ``visits``, the entries its searches walked (the eviction
windows' slots, the LIR bottom's steps), and ``placement``, where it kept
its state, both diagnostics (the plain version ``None``).

A trace's region of the kernel's scratch holds those arrays, then the
kernel's own (``baseline_arena`` / ``pfcs_arena``: the lists' links, the
free-slot bitmaps, the per-key maps); the wrapper hands the kernel every
array's offset and how it is placed (``baseline_kinds`` / ``pfcs_kinds``).
The kernel keeps what it reads in shared memory where it fits and says
where: ``{"mode": "shared" | "keys global" | "global", "shared_bytes":
n}``, ``"keys global"`` when the per-key arrays do not fit beside the
slots, ``"global"`` when the slots do not fit either.  A caller may ask
for less shared memory than fits (``placement=``), which checks the other
placements' template instances on a small state.

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
           "baseline_arena", "pfcs_arena", "baseline_kinds", "pfcs_kinds",
           "ENGINE_BASELINE", "ENGINE_PFCS",
           "POLICY_IDS", "MAX_LEVELS", "STAMP_SPACE"]

_P = ctypes.c_void_p
_I64 = ctypes.c_longlong
_INT = ctypes.c_int

ENGINE_BASELINE = CudaKernel(
    "engine_baseline", "engine_baseline.cu", "pfcs_engine_baseline",
    [_P, _I64, _I64, _INT, _P, _INT, _INT, _INT, _INT, _INT, _INT, _P, _I64,
     ctypes.c_char_p, _P, _INT, _P, _P, _P, _P, _P])
ENGINE_PFCS = CudaKernel(
    "engine_pfcs", "engine_pfcs.cu", "pfcs_engine_pfcs",
    [_P, _I64, _I64, _P, _INT, _INT, _INT, _INT, _INT, _INT, _P, _P, _P, _P,
     _I64, ctypes.c_char_p, _P, _INT, _P, _P, _P, _P])

#: the policy codes of ``engine_baseline.cu``
POLICY_IDS = {"lru": 0, "fifo": 1, "2q": 2, "arc": 3, "lirs": 4}
#: the most cache levels the kernels take
MAX_LEVELS = 8
#: int32 stamps: an access's ticks times the trace length stay below this
STAMP_SPACE = 2**31
_MODES = ("shared", "keys global", "global")


def _placement(out: ctypes.Array) -> Dict:
    """The kernel's report of where it kept its state."""
    return {"mode": _MODES[out[0]], "shared_bytes": int(out[1])}


def _least_mode(placement) -> int:
    """The kernel's code for the least shared placement a caller takes."""
    if placement is None:
        return 0
    if placement not in _MODES:
        raise ValueError(f"unknown placement {placement!r}; expected one of "
                         f"{_MODES}")
    return _MODES.index(placement)


# Each array of a trace's region comes with how the kernels place it
# (``csrc/engine_list.cuh::plan_arena``): "S" / "K" an int32 array over the
# slots / the keys, "G" one the kernel writes and never reads (it stays in
# the region), "s" / "k" the links of a list over the slots / the keys, "L"
# one link of the slots, "b" the words of a free-slot bitmap.

def _baseline_outputs(policy: str, total: int, n_keys: int) -> List:
    """``baseline_layout``'s arrays with their kinds."""
    if policy in ("lru", "fifo"):
        pol = [("keys", total, "S"),
               ("t" if policy == "lru" else "ins", total, "G")]
    elif policy == "2q":
        kin, kout, km = twoq_sizes(total)
        pol = [("a1k", kin, "S"), ("a1t", kin, "G"), ("aok", kout, "S"),
               ("aot", kout, "G"), ("amk", km, "S"), ("amt", km, "G")]
    elif policy == "arc":
        pol = [(name + f, n, kind)
               for name, n in (("t1", total), ("t2", total), ("b1", total),
                               ("b2", 2 * total + 1))
               for f, kind in (("k", "S"), ("t", "G"))]
    elif policy == "lirs":
        pol = [("status", n_keys, "K"), ("s_t", n_keys, "K"),
               ("q_t", n_keys, "G"), ("res", n_keys, "K"),
               ("n_lir", 1, "G"), ("n_res", 1, "G")]
    else:
        raise ValueError(f"unknown policy {policy!r}")
    return ([(("shk",), total, "S"), (("sht",), total, "G")]
            + [(("pol", name), n, kind) for name, n, kind in pol])


def _bitmap(n: int, name: Tuple = ()) -> List:
    """A free-slot bitmap of ``n`` slots: its two levels' words."""
    lo = (n + 31) // 32
    return [(name + ("lo",), lo, "b"), (name + ("hi",), (lo + 31) // 32, "b")]


def _list(name: str, n: int, bitmap: bool = False, kind: str = "s") -> List:
    """A list's links over ``n`` entries (each entry's next and previous
    side by side: two int32 words in the region, which the kernel packs to
    two 16-bit halves of one word in shared memory), and its free-slot
    bitmap."""
    return ([((name, "links"), 2 * n, kind)]
            + (_bitmap(n, (name,)) if bitmap else []))


def _baseline_own(policy: str, total: int, n_keys: int) -> List:
    """``baseline_arena``'s arrays with their kinds."""
    out = _list("sh", total) + [(("sh", "tier"), total, "S"),
                                (("sh", "slot"), n_keys, "K")]
    if policy in ("lru", "fifo"):
        out += _list("lru", total)
    elif policy == "2q":
        kin, kout, km = twoq_sizes(total)
        out += (_list("a1", kin) + _list("ao", kout) + _list("am", km)
                + _bitmap(kout, ("freed",)))
    elif policy == "arc":
        for name, n in (("t1", total), ("t2", total), ("b1", total),
                        ("b2", 2 * total + 1)):
            out += _list(name, n, bitmap=True)
    elif policy == "lirs":
        return [(("arena",) + path, n, kind) for path, n, kind in
                out + _list("q", n_keys, kind="k")]
    else:
        raise ValueError(f"unknown policy {policy!r}")
    out += [(("where",), n_keys, "K")]
    return [(("arena",) + path, n, kind) for path, n, kind in out]


def _pfcs_outputs(caps: Sequence[int], n_keys: int) -> List:
    """``pfcs_layout``'s arrays with their kinds: the levels, written out
    at the end, stay in the region."""
    return [(("levels", i, f), int(c) + 1, "G") for i, c in enumerate(caps)
            for f in ("keys", "t", "pf", "deg")] + [(("where",), n_keys, "K")]


def _pfcs_own(caps: Sequence[int], n_keys: int) -> List:
    """``pfcs_arena``'s arrays with their kinds."""
    slots = sum(int(c) + 1 for c in caps)
    bitmaps = [_bitmap(int(c) + 1) for c in caps]
    out = [((name,), slots, kind) for name, kind in
           (("keys", "S"), ("pf", "S"), ("deg", "S"), ("nxt", "L"),
            ("prv", "L"))]
    out += [(("lo",), sum(b[0][1] for b in bitmaps), "b"),
            (("hi",), sum(b[1][1] for b in bitmaps), "b"),
            (("slot",), n_keys, "K"), (("degree",), n_keys, "K")]
    return [(("arena",) + path, n, kind) for path, n, kind in out]


def baseline_layout(policy: str, total: int,
                    n_keys: int) -> List[Tuple[Tuple[str, ...], int]]:
    """The int32 words of one trace's baseline state, in the kernel's
    order: ``[(path in the state dict, words), ...]``."""
    return [(p, n) for p, n, _ in _baseline_outputs(policy, total, n_keys)]


def pfcs_layout(caps: Sequence[int],
                n_keys: int) -> List[Tuple[Tuple, int]]:
    """The int32 words of one trace's PFCS state, in the kernel's order."""
    return [(p, n) for p, n, _ in _pfcs_outputs(caps, n_keys)]


def baseline_arena(policy: str, total: int,
                   n_keys: int) -> List[Tuple[Tuple[str, ...], int]]:
    """The baseline kernel's own arrays, after ``baseline_layout``'s, in
    its order: the shadow's links, tiers and key -> slot map, then the
    policy's lists (and 2Q's free set of ghost slots) and key map (LIRS:
    its resident HIR queue over the keys)."""
    return [(p, n) for p, n, _ in _baseline_own(policy, total, n_keys)]


def pfcs_arena(caps: Sequence[int],
               n_keys: int) -> List[Tuple[Tuple, int]]:
    """The PFCS kernel's own arrays, after ``pfcs_layout``'s: every
    level's slots numbered across levels (keys, prefetched flags, degrees,
    the links of each level's stamp order), each level's free-slot bitmap
    one after the other, then the key -> slot map and a copy of the degree
    table.  The kernel writes the levels out in ``pfcs_layout`` at the
    end."""
    return [(p, n) for p, n, _ in _pfcs_own(caps, n_keys)]


def baseline_kinds(policy: str) -> str:
    """How the baseline kernel places each array of ``baseline_layout``
    and ``baseline_arena``, one letter an array (``plan_arena``'s)."""
    return "".join(k for *_, k in _baseline_outputs(policy, 8, 1)
                   + _baseline_own(policy, 8, 1))


def pfcs_kinds(n_levels: int) -> str:
    """How the PFCS kernel places each array of ``pfcs_layout`` and
    ``pfcs_arena`` at ``n_levels`` levels."""
    caps = [1] * n_levels
    return "".join(k for *_, k in _pfcs_outputs(caps, 1)
                   + _pfcs_own(caps, 1))


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
            "visits": None, "placement": None}


def baseline_scan(accesses: torch.Tensor, policy: str, caps: Sequence[int],
                  n_keys: int, placement: str = None) -> Dict:
    """Run a batch of traces through one baseline system: ``accesses`` is
    (B, T) int32, -1 padding; ``caps`` the level capacities; keys below
    ``n_keys``; ``placement`` the most shared placement the kernel may take
    (``None``: the first that fits; the plain version has one).  Returns
    ``{"hits": (B, L+1) (MEM last), "miss": (B,), "demand": (B,), "state":
    {...}, "visits": (B,) int64 or None, "placement": {...} or None}``."""
    if policy not in POLICY_IDS:
        raise ValueError(f"unknown policy {policy!r}")
    least = _least_mode(placement)
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
    region = layout + baseline_arena(policy, total, n_keys)
    offsets = _offsets(region)
    kinds = baseline_kinds(policy).encode()
    words = sum(n for _, n in region)
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
    placed = (ctypes.c_int * 2)(least, 0)
    if batch:
        ENGINE_BASELINE.launch(dev, accesses.data_ptr(), batch, length,
                               POLICY_IDS[policy], cums.data_ptr(), n_levels,
                               total, *sizes, n_keys, scratch.data_ptr(),
                               words, kinds, ctypes.addressof(offsets),
                               len(offsets), placed, p_out.data_ptr(),
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
            "visits": visits,
            "placement": _placement(placed) if batch else None}


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
                               "where": state["where"]}, "visits": None,
            "placement": None}


def pfcs_scan(accesses: torch.Tensor, caps: Sequence[int], n_keys: int,
              budget: int, window: int, enable_prefetch: bool, always: bool,
              targets: torch.Tensor, truth: torch.Tensor,
              degree: torch.Tensor, placement: str = None) -> Dict:
    """Run a batch of traces through PFCS: ``accesses`` (B, T) int32, -1
    padding; the discovery tables (B, K, budget) int32 targets (-1 pad),
    (B, K, budget) bool truth and (B, K) int32 degrees; ``placement`` as
    ``baseline_scan``'s.  Returns
    ``{"hits": (B, L), "miss", "demand", "issued", "used", "true": (B,),
    "state": {...}, "visits": (B,) int64 or None, "placement": {...} or
    None}``."""
    caps = [int(c) for c in caps]
    _check_levels(caps)
    least = _least_mode(placement)
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
    region = layout + pfcs_arena(caps, n_keys)
    offsets = _offsets(region)
    kinds = pfcs_kinds(len(caps)).encode()
    words = sum(n for _, n in region)
    scratch = torch.empty((batch, words), dtype=torch.int32, device=dev)
    n_levels = len(caps)
    counters = torch.empty((batch, n_levels + 5), dtype=torch.int32,
                           device=dev)
    visits = torch.empty((batch,), dtype=torch.int64, device=dev)
    caps_t = torch.tensor(caps, dtype=torch.int32, device=dev)
    targets, degree = targets.contiguous(), degree.contiguous()
    truth8 = truth.to(torch.uint8).contiguous()
    placed = (ctypes.c_int * 2)(least, 0)
    if batch:
        ENGINE_PFCS.launch(dev, accesses.data_ptr(), batch, length,
                           caps_t.data_ptr(), n_levels, n_keys,
                           budget if enable_prefetch else 0, budget,
                           int(window), int(bool(always)),
                           targets.data_ptr(), truth8.data_ptr(),
                           degree.data_ptr(), scratch.data_ptr(), words,
                           kinds, ctypes.addressof(offsets), len(offsets),
                           placed, counters.data_ptr(), visits.data_ptr())
    state = _unflatten(layout, scratch)
    levels = tuple(dict(state["levels"][i], pf=state["levels"][i]["pf"]
                        .bool()) for i in range(n_levels))
    c = counters
    return {"hits": c[:, :n_levels], "miss": c[:, n_levels],
            "demand": c[:, n_levels + 1], "issued": c[:, n_levels + 2],
            "used": c[:, n_levels + 3], "true": c[:, n_levels + 4],
            "state": {"levels": levels, "where": state["where"]},
            "visits": visits,
            "placement": _placement(placed) if batch else None}
