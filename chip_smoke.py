"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It puts ``<root>/src`` on ``sys.path`` itself, builds the port's CUDA
kernels from ``src/repro_torch/kernels/csrc`` (``nvcc``, one process per
source, started together), and drives the port's serving path on the card
in phases, each printing one JSON line with its seconds (the sharded runs also
report where their wall time went, ``sharded_time_split``):

  device         the card, the torch and CUDA versions, the interpreter,
                 the ``nvcc`` found, the build directory, and
                 ``nvidia-smi``'s name and power limit (``null`` with the
                 error when ``nvidia-smi`` is missing or fails: a missing
                 label is not a missing card);
  build          the three kernels, with ``-Xptxas -v``'s register,
                 shared-memory and spill lines;
  kernel_check   each kernel against its plain PyTorch version on the card
                 at registry-refresh sizes, int32 and int64 (exact);
  serving_full   ``case_serving``'s full configuration through
                 ``ServingEngine`` with ``kv="vec"``, ``"scalar"`` and
                 ``"sharded"`` (two shards): equal parity counters, every
                 kernel launched, and each kernel held against its plain
                 version on the inputs the sharded run gave it;
  serving_smoke  ``case_serving``'s smoke configuration against
                 ``BENCH_case_serving.json``;
  batching       ``case_batching``'s smoke trace (1200 open-loop Poisson
                 requests) through ``SlotMachine`` / ``SlotOracle``
                 against ``BENCH_case_batching.json``, and through
                 ``kv="sharded"`` with the same counters;
  batching_full  ``case_batching``'s full configuration (4000 requests),
                 ``kv="sharded"`` against ``kv="vec"``;
  launcher       ``repro_torch.launch.serve --null-model --kv sharded``,
                 each kernel held against its plain version on the
                 inputs that run gave it.

Then the table of the reference's six Pallas kernels, the card's name and
power limit, the ``kernels`` line (launches on the ``case_serving`` sharded
run, error, times and bound at that run's shapes) and, last,
``{"ok": true, "device": {...}}``.

Every path that launches the kernels holds each kernel against its plain
version on one input of every distinct shape and dtype the path gave it,
and times it at the largest.  Every check raises; the first failure
prints ``{"phase": ..., "error": ..., "traceback": ...}`` on stdout and
exits 1.  No measurement decides pass or fail.  Kernel times are
CUDA-event times: ``graph_ms`` per launch replayed from a captured CUDA
graph (no host work between launches; ``ms`` in the ``kernels`` line,
null when the capture failed), ``wrapper_ms`` per call of the
Python wrapper in a loop (what a caller that issues launches one by one
pays), ``plain_ms`` per call of the plain version in a loop, and
``library_ms`` / ``library_wrapper_ms`` the same two for ``torch.gcd``
(gcd only; a yardstick the port never calls).

Without a card (``torch.cuda.is_available()`` false) it prints no result
and exits 2.
"""

from __future__ import annotations

import contextlib
import importlib.util
import io
import json
import os
import subprocess
import sys
import time
import traceback

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))

#: where every phase runs the port (the card; one device)
DEVICE = "cuda"

#: H100 SXM HBM3 rate (NVIDIA data sheet), bytes/s
HBM_BYTES_PER_S = 3.35e12
#: H100 SXM 32-bit integer rate outside the tensor cores, operations/s:
#: 132 SMs x 64 INT32 lanes x 1.98 GHz boost (Hopper white paper).  The
#: bound counts one operation per modulo or Euclid step, a lower bound:
#: Hopper has no integer divide, so each is a software sequence.
INT_OPS_PER_S = 132 * 64 * 1.98e9

#: the six Pallas kernels of ``src/repro/kernels`` and their ports
TPU_KERNELS = [
    ("divisibility_mask", "src/repro/kernels/factorize.py:258",
     "src/repro_torch/kernels/csrc/divmask.cu"),
    ("factorize_squarefree", "src/repro/kernels/factorize.py:215",
     "src/repro_torch/kernels/csrc/factorize.cu"),
    ("gcd", "src/repro/kernels/gcd.py:45",
     "src/repro_torch/kernels/csrc/gcd.cu"),
    ("divisibility_mask_limbs", "src/repro/kernels/factorize.py:99", None),
    ("factorize_limbs", "src/repro/kernels/factorize.py:155", None),
    ("gcd_limbs", "src/repro/kernels/gcd.py:143", None),
]
PORTED = [name for name, _, src in TPU_KERNELS if src]


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi():
    """``(line, None)`` with the card's name and power limit, or
    ``(None, error)`` when ``nvidia-smi`` is missing or fails."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.SubprocessError) as exc:
        return None, f"{type(exc).__name__}: {exc}"
    lines = out.stdout.strip().splitlines()
    if out.returncode != 0 or not lines:
        return None, f"exit {out.returncode}: {out.stderr.strip()[:300]}"
    return lines[0], None


# --------------------------------------------------------------------------- #
# timing (CUDA events) and bounds                                             #
# --------------------------------------------------------------------------- #

def loop_ms(fn, target_ms: float = 40.0, max_reps: int = 200) -> float:
    """Time per call of ``fn()`` in a back-to-back loop after a warm-up:
    for a small kernel the rate at which the host issues the calls."""
    fn()
    torch.cuda.synchronize()
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    fn()
    stop.record()
    torch.cuda.synchronize()
    once = max(start.elapsed_time(stop), 1e-3)
    reps = int(min(max_reps, max(3, target_ms / once)))
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def graph_ms(fn, calls: int = 50, replays: int = 5) -> float:
    """Time per call of ``fn()`` with no host work between launches:
    ``calls`` calls captured in one CUDA graph, replayed after a warm-up."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(replays):
        graph.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / (replays * calls)


def timed(fn) -> dict:
    """``graph_ms`` and ``wrapper_ms`` of ``fn``.  A failed graph capture
    records its error and leaves ``graph_ms`` null: a measurement tool
    does not decide pass or fail."""
    row = {"wrapper_ms": loop_ms(fn)}
    try:
        row["graph_ms"] = graph_ms(fn)
    except RuntimeError as exc:
        torch.cuda.synchronize()
        row["graph_ms"] = None
        row["graph_error"] = f"{type(exc).__name__}: {exc}"[:300]
    return row


def bound_ms(n_bytes: float, n_ops: float):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / INT_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def euclid_steps(a: torch.Tensor, b: torch.Tensor) -> int:
    """Modulo steps Euclid takes on these pairs (the gcd kernel's work)."""
    a, b = a.clone(), b.clone()
    steps = 0
    while True:
        live = b != 0
        n = int(live.sum())
        if n == 0:
            return steps
        steps += n
        r = torch.where(live, a % torch.where(live, b, torch.ones_like(b)),
                        torch.zeros_like(a))
        a, b = torch.where(live, b, a), r


def max_abs_err(x: torch.Tensor, y: torch.Tensor) -> int:
    if x.shape != y.shape:
        raise AssertionError(f"shape {tuple(x.shape)} != {tuple(y.shape)}")
    if x.numel() == 0:
        return 0
    return int((x.to(torch.int64) - y.to(torch.int64)).abs().max())


# --------------------------------------------------------------------------- #
# kernel checks                                                               #
# --------------------------------------------------------------------------- #

def _primes_upto(n: int) -> np.ndarray:
    sieve = np.ones(n + 1, dtype=bool)
    sieve[:2] = False
    for i in range(2, int(n ** 0.5) + 1):
        if sieve[i]:
            sieve[i * i::i] = False
    return np.nonzero(sieve)[0].astype(np.int64)


def synthetic_inputs(dtype, rng):
    """Inputs at the sizes of a large registry refresh: mask 4096 x 2048,
    factorize 2048 x 4096, gcd 2**20 pairs.  Composites are products of
    pool primes mixed with random values, 0 and 1; pools are padded with
    0 and 1; gcd pairs share factors and include zeros."""
    wide = dtype == torch.int64
    primes = _primes_upto(1 << 20 if wide else 46_000)
    hi = (1 << 62) if wide else (1 << 31) - 1
    k_max = 3 if wide else 2

    def composites(n, pool):
        k = rng.integers(1, k_max + 1, size=n)
        picks = rng.choice(pool, size=(n, k_max))
        prods = np.where(np.arange(k_max)[None, :] < k[:, None], picks, 1)
        c = np.prod(prods, axis=1)
        rand = rng.integers(0, hi, size=n)
        c = np.where(rng.random(n) < 0.25, rand, c)
        c[:4] = [0, 1, 0, 1]
        return c

    def pool(n):
        p = rng.choice(primes, size=n, replace=False)
        p[-3:] = [0, 1, 0]
        return p

    p_mask = pool(2048)
    c_mask = composites(4096, p_mask[p_mask > 1])
    p_fac = pool(4096)
    c_fac = composites(2048, p_fac[p_fac > 1])
    n_gcd = 1 << 20
    shared = rng.choice(primes, size=n_gcd)
    a = shared * rng.choice(primes, size=n_gcd)
    b = shared * rng.choice(primes, size=n_gcd)
    if not wide:
        a, b = a % hi, b % hi
    a[:3], b[:3] = [0, 7, 0], [5, 0, 0]

    def t(x):
        return torch.from_numpy(np.asarray(x, dtype=np.int64)).to(
            DEVICE, dtype)

    return {"divisibility_mask": (t(c_mask), t(p_mask)),
            "factorize_squarefree": (t(c_fac), t(p_fac)),
            "gcd": (t(a), t(b))}


def kernel_pair(name: str):
    """``(kernel wrapper, plain version)`` of one ported kernel."""
    from repro_torch.kernels import factorize, gcd, ref

    return {"divisibility_mask": (factorize.divisibility_mask,
                                  ref.divisibility_mask_ref),
            "factorize_squarefree": (factorize.factorize_squarefree,
                                     ref.factorize_squarefree_ref),
            "gcd": (gcd.gcd, ref.gcd_ref)}[name]


def check_exact(name: str, args):
    """The kernel against its plain version on the same card inputs:
    ``(max_abs_err, kernel outputs)``; raises unless they are equal."""
    kern, plain = kernel_pair(name)
    out_k, out_p = kern(*args), plain(*args)
    torch.cuda.synchronize()
    outs_k = out_k if isinstance(out_k, tuple) else (out_k,)
    outs_p = out_p if isinstance(out_p, tuple) else (out_p,)
    err = max(max_abs_err(x, y) for x, y in zip(outs_k, outs_p))
    if err != 0 or any(not torch.equal(x, y) for x, y in zip(outs_k, outs_p)):
        raise AssertionError(f"{name} {args[0].dtype}: kernel != plain "
                             f"(max abs err {err})")
    return err, outs_k


def other_dtype(args):
    """``args`` in the other of int32 / int64 where every value fits it,
    else ``None``."""
    if args[0].dtype == torch.int32:
        return tuple(a.to(torch.int64) for a in args)
    if max(int(a.max()) for a in args if a.numel()) <= 2**31 - 1:
        return tuple(a.to(torch.int32) for a in args)
    return None


def check_and_time(name: str, args) -> dict:
    """The kernel against its plain version on the same card inputs
    (exact, or raise), then its times, its plain version's time, and its
    bound from these inputs."""
    kern, plain = kernel_pair(name)
    err, outs_k = check_exact(name, args)
    elem = args[0].element_size()
    if name == "gcd":
        n = args[0].numel()
        n_bytes = 3 * n * elem
        n_ops = euclid_steps(*args)
        shape = [n]
    else:
        n, p = args[0].numel(), args[1].numel()
        n_bytes = (n + p) * elem + n * p
        n_ops = n * p
        if name == "factorize_squarefree":
            n_bytes += n * elem
            n_ops += int(outs_k[0].sum())        # one division per hit
        shape = [n, p]
    b_ms, b_by = bound_ms(n_bytes, n_ops)
    row = {"name": name, "dtype": str(args[0].dtype).replace("torch.", ""),
           "shape": shape, "bytes": n_bytes, "operations": n_ops,
           "max_abs_err": err, **timed(lambda: kern(*args)),
           "plain_ms": loop_ms(lambda: plain(*args), max_reps=20),
           "bound_ms": b_ms, "bound_by": b_by,
           "library_ms": None, "library_wrapper_ms": None}
    if name == "gcd":
        lib = timed(lambda: torch.gcd(*args))
        row["library_ms"] = lib["graph_ms"]
        row["library_wrapper_ms"] = lib["wrapper_ms"]
    return row


class Capture:
    """Keeps one copy of the inputs of every distinct shape and dtype that
    each kernel wrapper saw during a run (``inputs[name][key]``; the
    callers pad to bucketed widths, so there are few), so that the kernels
    can be checked at every shape the path gave them.  The wrapped
    functions call the originals, whose launch counts are unchanged."""

    def __init__(self):
        from repro_torch.kernels import factorize, gcd, ops

        self.inputs = {}
        self._undo = []
        for mod in (factorize, gcd, ops):
            for name in PORTED:
                if hasattr(mod, name):
                    self._wrap(mod, name)

    def _wrap(self, mod, name):
        orig = getattr(mod, name)

        def wrapped(*args):
            if args[0].device.type == DEVICE:
                key = (str(args[0].dtype).replace("torch.", ""),
                       tuple(tuple(a.shape) for a in args))
                seen = self.inputs.setdefault(name, {})
                if key not in seen:
                    seen[key] = tuple(a.clone() for a in args)
            return orig(*args)

        setattr(mod, name, wrapped)
        self._undo.append((mod, name, orig))

    def close(self):
        for mod, name, orig in self._undo:
            setattr(mod, name, orig)


class Timers:
    """Host seconds spent inside the sharded registry refresh during a
    run: the whole table rebuild (``refresh_s``) and, within it, the calls
    that upload to the card, launch the kernels and read the results back
    (``kernel_calls_s``: the per-shard scan with its mask and gcd
    kernels, and the squarefree decode; neither calls the other), and the
    kernel launches made inside those calls (``kernel_calls_launches``).
    What remains of the refresh is host Python; what remains of the run
    is the tick loop."""

    def __init__(self):
        from repro_torch import kernels
        from repro_torch.core.engine import shard
        from repro_torch.kernels import ops
        from repro_torch.serving.kv_cache_sharded import ShardedPagedKVCache

        self.seconds = {"refresh_s": 0.0, "kernel_calls_s": 0.0,
                        "kernel_calls_launches": 0}
        self._launches = lambda: sum(kernels.launch_counts().values())
        self._undo = []
        self._wrap(ShardedPagedKVCache, "refresh_tables", "refresh_s")
        self._wrap(shard, "_scan_sharded", "kernel_calls_s")
        self._wrap(ops, "factorize_batch_exact", "kernel_calls_s")

    def _wrap(self, owner, name, key):
        orig = getattr(owner, name)

        def wrapped(*args, **kw):
            n0, t0 = self._launches(), time.perf_counter()
            try:
                return orig(*args, **kw)
            finally:
                self.seconds[key] += time.perf_counter() - t0
                if key == "kernel_calls_s":
                    self.seconds["kernel_calls_launches"] += (
                        self._launches() - n0)

        setattr(owner, name, wrapped)
        self._undo.append((owner, name, orig))

    def close(self):
        for owner, name, orig in reversed(self._undo):
            setattr(owner, name, orig)


def traced(run, *args, **kw):
    """``run(*args, **kw)`` with every kernel launch counted (from 0), the
    kernel inputs of each distinct shape captured and the refresh timed:
    ``(result, launches, captured inputs, seconds)``."""
    from repro_torch import kernels

    capture, timers = Capture(), Timers()
    try:
        kernels.reset_launch_counts()
        out = run(*args, **kw)
        launches = kernels.launch_counts()
    finally:
        timers.close()
        capture.close()
    return out, launches, capture.inputs, timers.seconds


def check_path(label: str, launches: dict, inputs: dict,
               timed: bool = True) -> list:
    """Every kernel of a path launched, and held against its plain version
    on every distinct shape and dtype the path gave it (and in the other
    of int32 / int64 where the values fit); with ``timed``, also measured
    at the largest.  Emits one line per kernel and returns the lines."""
    if sorted(inputs) != sorted(PORTED) or min(
            launches[n] for n in PORTED) <= 0:
        raise AssertionError(f"{label}: a kernel was not launched on the "
                             f"path: {launches}")
    rows = []
    for name in PORTED:
        seen = inputs[name]
        top = max(seen, key=lambda k: sum(a.numel() for a in seen[k]))
        also = set()
        for key, args in seen.items():
            if key != top or not timed:
                check_exact(name, args)
            other = other_dtype(args)
            if other is not None:
                check_exact(name, other)
                also.add(str(other[0].dtype).replace("torch.", ""))
        row = (check_and_time(name, seen[top]) if timed else
               {"name": name, "max_abs_err": 0})
        row.update(shapes_checked=len(seen), also_exact_as=sorted(also),
                   largest=[list(map(list, top[1])), top[0]])
        emit({"phase": f"kernel_{label}", **row})
        rows.append(row)
    return rows


def time_split(wall_s: float, seconds: dict, launches: dict,
               rows: list) -> dict:
    """Where a sharded run's wall time went, and the card's busy share two
    ways.  Upper bound (measured): the host seconds inside the calls that
    reach the card, over wall; each call waits for its results, so the
    card works only inside them.  It holds only when every launch fell
    inside them, else it is null.  Estimate: every launch costed at the
    graph-replay time of the run's largest inputs of its kernel (replay
    hides the per-launch overhead; smaller shapes cost less); null when a
    graph capture failed."""
    total = sum(launches[n] for n in PORTED)
    inside = seconds["kernel_calls_launches"]
    graph = [r["graph_ms"] for r in rows]
    est = (None if None in graph else
           sum(launches[r["name"]] * r["graph_ms"] for r in rows) / 1e3)
    return {"wall_s": wall_s, **seconds,
            "refresh_host_python_s": seconds["refresh_s"]
            - seconds["kernel_calls_s"],
            "outside_refresh_s": wall_s - seconds["refresh_s"],
            "launches_outside_kernel_calls": total - inside,
            "device_busy_upper_share": (seconds["kernel_calls_s"] / wall_s
                                        if inside == total else None),
            "device_busy_graph_est_s": est,
            "device_busy_graph_est_share": (None if est is None
                                            else est / wall_s)}


# --------------------------------------------------------------------------- #
# serving                                                                     #
# --------------------------------------------------------------------------- #

def run_serving(kv: str, budget: int, smoke: bool, n_shards: int = 2):
    """``benchmarks/cases.py::case_serving``'s engine run, on the card."""
    from repro_torch.serving.engine import ServingEngine

    if smoke:
        n_req, max_batch, max_new = 48, 16, 8
        hbm, shared_tok, window = 24, 64, 2
    else:
        n_req, max_batch, max_new = 256, 128, 32
        hbm, shared_tok, window = 384, 128, 4
    rng = np.random.default_rng(0)
    eng = ServingEngine(None, None, max_batch=max_batch, page_size=16,
                        hbm_pages=hbm, kv=kv, prefetch_budget=budget,
                        reread_window=window, shards=n_shards,
                        device=DEVICE)
    groups = [list(rng.integers(0, 30_000, size=shared_tok))
              for _ in range(max(1, n_req // 8))]
    for r in range(n_req):
        tail = list(rng.integers(0, 30_000, size=int(rng.integers(48, 129))))
        eng.submit(groups[r % len(groups)] + tail, max_new_tokens=max_new)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    done = eng.run_until_idle()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    st = eng.pages.stats
    out = {"kv": kv, "completed": len(done), "wall_s": wall,
           "tok_per_s": sum(len(r.generated) for r in done) / wall,
           "peak_concurrency": eng.peak_live,
           "hbm_hit_rate": st.hbm_hit_rate,
           "prefetch_hit_rate": st.prefetch_hit_rate,
           "registry_scans": st.registry_scans,
           "bulk_refreshes": getattr(eng.pages, "bulk_refreshes", None),
           "parity": list(st.parity_tuple())}
    if kv == "sharded":
        scan = eng.pages.last_scan
        out.update(shards=n_shards,
                   local_composites=list(scan.local_composites),
                   cross_composites=scan.cross_composites,
                   gcd_pairs=scan.gcd_pairs,
                   shard_agg_parity=list(
                       eng.pages.aggregate_shard_stats().parity_tuple()))
    return out


def batching_trace(smoke: bool):
    """``benchmarks/cases.py::case_batching``'s arrival trace and engine
    sizes: a 60% burst front plus a Poisson tail, 32-token shared
    prefixes, ragged tails and decode demands."""
    from repro_torch.serving.slots import poisson_arrival_ticks

    if smoke:
        n_req, max_batch, rate, hbm, prefill_tok = 1200, 64, 24.0, 96, 256
    else:
        n_req, max_batch, rate, hbm, prefill_tok = 4000, 128, 48.0, 256, 1024
    rng = np.random.default_rng(0)
    ticks = poisson_arrival_ticks(n_req, rate=rate, seed=0, burst_frac=0.6,
                                  silence_ticks=2)
    groups = [list(rng.integers(0, 30_000, size=48))
              for _ in range(max(1, n_req // 64))]
    arrivals = []
    for i, t in enumerate(ticks):
        tail = list(rng.integers(0, 30_000, size=int(rng.integers(8, 33))))
        arrivals.append((int(t), groups[i % len(groups)][:32] + tail,
                         int(rng.integers(4, 9))))
    return arrivals, dict(max_batch=max_batch, hbm_pages=hbm,
                          prefill_tokens=prefill_tok)


def run_batching(arrivals, sizes, config: str, kv: str = "vec"):
    """One ``case_batching`` engine on the card: ``config`` is a key of
    ``BENCH_case_batching.json``."""
    from repro_torch.serving.slots import SlotMachine, SlotOracle

    cls, policy, budget, wait = {
        "slot_vec": (SlotMachine, "continuous", 4, 6),
        "slot_oracle": (SlotOracle, "continuous", 4, 6),
        "lockstep": (SlotMachine, "lockstep", 4, None),
        "lru": (SlotMachine, "continuous", 0, 6)}[config]
    eng = cls(page_size=16, kv=kv, prefetch_budget=budget, reread_window=2,
              policy=policy, preempt_wait=wait, shards=2, device=DEVICE,
              **sizes)
    for t, prompt, new in arrivals:
        eng.submit(prompt, max_new_tokens=new, arrival=t)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.run_until_idle(max_ticks=1_000_000)
    torch.cuda.synchronize()
    rep = eng.latency_report()
    rep.update(wall_s=time.perf_counter() - t0,
               hbm_hit_rate=eng.pages.stats.hbm_hit_rate,
               prefetch_hit_rate=eng.pages.stats.prefetch_hit_rate)
    trail = {"parity": eng.pages.stats.parity_tuple(),
             "prefetch_log": list(eng.pages.prefetch_log),
             "tier_log": eng.tier_log,
             "timings": [(r.first_tick, r.done_tick, r.preemptions)
                         for r in eng.requests]}
    return rep, trail


def bench_failures(bench_file: str, fresh: dict):
    """The deterministic keys of a checked-in ``BENCH_*.json`` that
    ``fresh`` does not reproduce, as ``tools/check_bench_regression.py``
    compares them (time-derived keys skipped, exact equality)."""
    spec = importlib.util.spec_from_file_location(
        "check_bench_regression",
        os.path.join(ROOT, "tools", "check_bench_regression.py"))
    gate = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gate)
    with open(os.path.join(ROOT, bench_file)) as f:
        base = json.load(f)
    failures, _ = gate.compare_case(bench_file, base, fresh, rel_tol=0.0)
    return failures


# --------------------------------------------------------------------------- #
# phases                                                                      #
# --------------------------------------------------------------------------- #

class Context:
    """What one phase hands the next."""

    def __init__(self):
        self.kind = None
        self.smi = None
        self.launches = None
        self.kernel_rows = []


def phase_device(ctx: Context) -> dict:
    from repro_torch.kernels import cuda

    ctx.kind = torch.cuda.get_device_name(0)
    ctx.smi, smi_error = nvidia_smi()
    return {"kind": ctx.kind, "count": torch.cuda.device_count(),
            "torch": torch.__version__, "cuda": torch.version.cuda,
            "python": sys.executable, "nvcc": cuda.nvcc_path(),
            "build_dir": str(cuda.build_dir()), "nvidia_smi": ctx.smi,
            "nvidia_smi_error": smi_error}


def phase_build(ctx: Context) -> dict:
    from repro_torch import kernels

    if sorted(kernels.KERNELS) != sorted(PORTED):
        raise AssertionError(f"kernels {sorted(kernels.KERNELS)} != "
                             f"{sorted(PORTED)}")
    nvcc_s = kernels.build_all()
    return {"nvcc_seconds": nvcc_s,
            "ptxas": {name: [ln.strip() for ln in
                             k.build_log().splitlines()
                             if "registers" in ln or "spill" in ln]
                      for name, k in kernels.KERNELS.items()}}


def phase_kernel_check(ctx: Context) -> dict:
    rng = np.random.default_rng(0)
    checked = []
    for dtype in (torch.int32, torch.int64):
        inputs = synthetic_inputs(dtype, rng)
        for name, args in inputs.items():
            row = check_and_time(name, args)
            emit({"phase": "kernel_check", **row})
            checked.append(f"{name}:{row['dtype']}")
        del inputs
    return {"exact": checked}


def phase_serving_full(ctx: Context) -> dict:
    full = {"vec": run_serving("vec", 4, smoke=False),
            "scalar": run_serving("scalar", 4, smoke=False)}
    full["sharded"], ctx.launches, inputs, seconds = traced(
        run_serving, "sharded", 4, smoke=False)
    sh = full["sharded"]
    emit({"phase": "serving_full_runs", "launches": ctx.launches, **full})
    if not (full["vec"]["parity"] == full["scalar"]["parity"]
            == sh["parity"] == sh["shard_agg_parity"]):
        raise AssertionError("serving parity diverged across vec / scalar "
                             "/ sharded")
    if full["vec"]["registry_scans"] or sh["registry_scans"]:
        raise AssertionError("vec or sharded touch path scanned the registry")
    if full["vec"]["peak_concurrency"] < 100:
        raise AssertionError("fewer than 100 concurrent requests per step")
    if sh["cross_composites"] <= 0:
        raise AssertionError("no cross-shard composites: gcd path idle")
    # each kernel against its plain version on the inputs the sharded run
    # gave it; these times are the kernels line's
    ctx.kernel_rows = check_path("main_path", ctx.launches, inputs)
    return {"parity": sh["parity"], "launches": ctx.launches,
            "main_path_exact": PORTED,
            "sharded_time_split": time_split(sh["wall_s"], seconds,
                                             ctx.launches, ctx.kernel_rows)}


def phase_serving_smoke(ctx: Context) -> dict:
    runs = {"pfcs_vec": run_serving("vec", 4, smoke=True),
            "pfcs_scalar": run_serving("scalar", 4, smoke=True),
            "lru": run_serving("vec", 0, smoke=True),
            "pfcs_shard2": run_serving("sharded", 4, smoke=True)}
    fresh = {key: {cfg: r[key] for cfg, r in runs.items()}
             for key in ("hbm_hit_rate", "prefetch_hit_rate",
                         "registry_scans", "tok_per_s")}
    failures = bench_failures("BENCH_case_serving.json", fresh)
    if failures:
        raise AssertionError("; ".join(failures))
    return {"matches": "BENCH_case_serving.json", **fresh}


def sharded_batching(arrivals, sizes, vec, vec_trail, label: str) -> dict:
    """The ``slot_vec`` engine again with ``kv="sharded"`` (two shards):
    its counters and logs must equal ``kv="vec"``'s, every kernel must
    launch, and each kernel is held against its plain version on every
    shape this run gave it."""
    (sharded, trail), launches, inputs, seconds = traced(
        run_batching, arrivals, sizes, "slot_vec", kv="sharded")
    same = {k: v for k, v in sharded.items() if k != "wall_s"} == \
        {k: v for k, v in vec.items() if k != "wall_s"}
    if not same or trail != vec_trail:
        raise AssertionError(f"{label}: kv='sharded' slot machine diverged "
                             f"from kv='vec'")
    rows = check_path(label, launches, inputs)
    return {"sharded_wall_s": sharded["wall_s"],
            "sharded_launches": launches,
            "sharded_time_split": time_split(sharded["wall_s"], seconds,
                                             launches, rows)}


def phase_batching(ctx: Context) -> dict:
    arrivals, sizes = batching_trace(smoke=True)
    fresh, trails = {}, {}
    for config in ("slot_vec", "slot_oracle", "lockstep", "lru"):
        fresh[config], trails[config] = run_batching(arrivals, sizes, config)
    failures = bench_failures("BENCH_case_batching.json", fresh)
    if failures:
        raise AssertionError("; ".join(failures))
    if trails["slot_vec"] != trails["slot_oracle"]:
        raise AssertionError("slot machine diverged from the slot oracle")
    vec = fresh["slot_vec"]
    return {"matches": "BENCH_case_batching.json",
            "requests": len(arrivals), **sizes,
            "peak_in_flight": vec["peak_in_flight"],
            "goodput_tok_per_tick": vec["goodput_tok_per_tick"],
            "wall_s": {c: r["wall_s"] for c, r in fresh.items()},
            **sharded_batching(arrivals, sizes, vec, trails["slot_vec"],
                               "batching")}


def phase_batching_full(ctx: Context) -> dict:
    """``case_batching``'s full configuration (4000 requests, 128 slots,
    1024-token prefill budget).  It has no checked-in keys: ``kv="sharded"``
    is held against ``kv="vec"`` on the same trace."""
    arrivals, sizes = batching_trace(smoke=False)
    vec, vec_trail = run_batching(arrivals, sizes, "slot_vec")
    return {"requests": len(arrivals), **sizes,
            "peak_in_flight": vec["peak_in_flight"],
            "goodput_tok_per_tick": vec["goodput_tok_per_tick"],
            "ticks": vec["ticks"], "vec_wall_s": vec["wall_s"],
            **sharded_batching(arrivals, sizes, vec, vec_trail,
                               "batching_full")}


def run_launcher():
    from repro_torch.launch import serve

    with contextlib.redirect_stdout(io.StringIO()):
        out = serve.main(["--null-model", "--kv", "sharded", "--max-batch",
                          "128", "--requests", "256", "--device", DEVICE])
    torch.cuda.synchronize()
    return out


def phase_launcher(ctx: Context) -> dict:
    """The user's entry point: all 256 requests complete, every kernel
    launches, and each is held against its plain version on every shape
    the run gave it."""
    out, launches, inputs, seconds = traced(run_launcher)
    if out["completed"] != 256:
        raise AssertionError(f"launcher run: {out['completed']} of 256 "
                             f"requests")
    rows = check_path("launcher", launches, inputs, timed=False)
    return {"launches": launches, "launcher_seconds": seconds,
            "shapes_checked": {r["name"]: r["shapes_checked"] for r in rows},
            **out}


PHASES = [
    ("device", phase_device),
    ("build", phase_build),
    ("kernel_check", phase_kernel_check),
    ("serving_full", phase_serving_full),
    ("serving_smoke", phase_serving_smoke),
    ("batching", phase_batching),
    ("batching_full", phase_batching_full),
    ("launcher", phase_launcher),
]


def report(ctx: Context) -> None:
    """The table of the six TPU kernels, the card's label, the
    ``kernels`` line and the ``ok`` line."""
    emit({"tpu_kernels": [{"name": n, "replaces": repl,
                           "status": "ported" if src else "not yet",
                           "source": src} for n, repl, src in TPU_KERNELS]})
    ported = {n: (src, repl) for n, repl, src in TPU_KERNELS if src}
    rows = []
    for r in ctx.kernel_rows:
        rows.append({
            "name": r["name"], "route": "cuda",
            "source": ported[r["name"]][0], "replaces": ported[r["name"]][1],
            "launches": ctx.launches[r["name"]],
            "max_abs_err": r["max_abs_err"],
            "ms": r["graph_ms"], "graph_ms": r["graph_ms"], "wrapper_ms": r["wrapper_ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    print(ctx.smi or f"{ctx.kind}, power.limit not measured (nvidia-smi "
                     f"failed)", flush=True)
    emit({"kernels": rows})
    emit({"ok": True, "device": {"platform": "gpu", "kind": ctx.kind,
                                 "count": torch.cuda.device_count()}})


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    phase = "start"
    t_start = time.perf_counter()
    try:
        ctx = Context()
        for phase, fn in PHASES:
            t0 = time.perf_counter()
            out = fn(ctx)
            emit({"phase": phase, "seconds": time.perf_counter() - t0, **out})
        phase = "report"
        emit({"phase": "total", "seconds": time.perf_counter() - t_start})
        report(ctx)
    except Exception as exc:
        frames = traceback.format_exception(type(exc), exc,
                                            exc.__traceback__)
        emit({"phase": phase, "error": f"{type(exc).__name__}: {exc}",
              "traceback": "".join(frames[-6:])})
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
