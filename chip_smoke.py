"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It puts ``<root>/src`` on ``sys.path`` itself, builds the port's eight
CUDA kernels from ``src/repro_torch/kernels/csrc`` (``nvcc``, one process
per source, started together), and drives the port's serving path, its
wide (multi-limb) path and its Table-1 trace engine on the card in
phases, each printing one JSON line with its seconds (the sharded runs
also report where their wall time went, ``sharded_time_split``):

  device         the card, the torch and CUDA versions, the interpreter,
                 the ``nvcc`` found, the build directory, and
                 ``nvidia-smi``'s name and power limit (``null`` with the
                 error when ``nvidia-smi`` is missing or fails: a missing
                 label is not a missing card);
  build          the eight kernels and an empty one, one ``nvcc`` each,
                 all started together: it waits for the six discovery
                 kernels and the empty one (``-Xptxas -v``'s register,
                 shared-memory and spill lines, for the kernels of
                 ``NAMED_INSTANCES`` under the name of each template
                 instance) and leaves the two engine kernels building
                 until ``engine_check``; and the launch floor: the
                 graph-replay time of the empty kernel launched through
                 the same ``ctypes`` binding (``launch_floor_ms``,
                 repeated in every kernel line);
  kernel_check   each kernel against its plain PyTorch version on the card
                 at registry-refresh sizes: the flat kernels in int32 and
                 int64, also on the edges of their arithmetic (the
                 largest values of each type, powers of two, the largest
                 primes below 2**31, large int64 primes, a pool with a
                 duplicate entry and entries with their multiples, gcd
                 chains of consecutive Fibonacci pairs, zeros, equal
                 sides and sides of 1, arrays off their 16-byte
                 alignment), the limb kernels at 2, 3, 8 and 32 limbs
                 with zero, value-1 and non-squarefree rows, pad primes,
                 ragged shapes and the edges of their arithmetic (even
                 entries, powers of two, the largest primes below 2**31,
                 all-ones rows, rows whose top limb is the first, a
                 middle or the last) (exact);
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
                 inputs that run gave it;
  scale          ``case_scale`` at its published size (1M elements, 10,000
                 chains 100 deep, 1024-bit chunks: 32 limbs) through
                 ``repro_torch.cases``, against every deterministic key of
                 ``BENCH_case_scale.json``, each limb kernel held against
                 its plain version on the inputs the run gave it;
  scale_full_scan  the limb mask kernel over the whole registry of the
                 scale phase (991,832 composites x 32 limbs) against its
                 359 query primes: equal to its plain version, every hit
                 re-checked with Python ints, the hits of 8 primes equal to
                 an exact host scan, no negative-control hit;
  serving_wide   ``case_serving``'s full configuration at ``max_bits`` 128
                 and 1024 with ``kv="vec"``, ``"scalar"`` and ``"sharded"``:
                 counters, tier and prefetch logs equal to the narrow
                 run's, each kernel the sharded runs launched held against
                 its plain version; and ``case_batching``'s smoke trace with
                 ``kv="sharded"``, ``max_bits`` 128, against ``kv="vec"``;
  launcher_wide  the launcher with ``--max-bits 1024``;
  engine_check   the two engine kernels (``engine_baseline``: LRU, FIFO,
                 2Q, ARC, LIRS with the tier shadow; ``engine_pfcs``) on
                 the card against their plain versions (the step
                 functions run as a Python loop on the host's CPU), every
                 counter and the whole final state: a ragged batch of
                 four traces of the port's generators (about 512
                 accesses) through every system; PFCS without prefetch,
                 with prefetch on every access and with a victim window
                 wider than every level (about 256 accesses); levels of
                 capacity 1 (2Q holds two keys, as in the reference); a
                 trace that drives ARC's p to 0 and to c (p bit for
                 bit); each of these again with the state asked into the
                 two other placements (the per-key arrays in global
                 memory; every array there), equal to the same plain
                 result; then the placements the sizes choose: every
                 system on the check traces with their keys spread over
                 60,000 (the per-key arrays in global memory) and at
                 levels of 8 / 24 / 20,000 (every array in global
                 memory) against the plain loop, and on a long batch at
                 those levels whose keys outnumber its slots (164,000
                 accesses over 28,000 and 30,000 keys: every policy
                 evicts) against the scalar oracles' counters, each line
                 naming where the kernel kept its state;
  table1         the paper's Table 1 at ``benchmarks/table1.py``'s
                 configuration, unreduced (three workloads, three trials
                 each): every system through ``simulate_batch`` on the
                 card, PFCS's tables from ``discover="kernel"``; every
                 baseline trace's counters equal to the scalar oracle,
                 every PFCS trace's to the oracle's recorded in
                 ``TABLE1_PFCS`` (and to the oracle run on hft's trial 0,
                 ``TABLE1_PFCS_ORACLE``), the seed-0 hit counts equal to
                 ``TABLE1_SEED0``; per workload and system the hit rate,
                 the engine's wall, its kernel time (CUDA events), its
                 bound, accesses/s, the oracle's host seconds, the table
                 build's host seconds and ``derive_table1_row`` against
                 LRU, the kernel's ns per serial step (its ms over the
                 longest trace's steps) and where it kept its state (the
                 dynamic shared bytes); the flat mask and factorization
                 held against their plain versions at every shape the
                 tables launched them at; the engine kernels' ``ptxas``
                 lines (registers and static shared memory of each
                 template instance).

Then the table of the reference's six Pallas kernels, the card's name and
power limit, the ``kernels`` line (for the flat kernels: launches on the
``case_serving`` sharded run and times at that run's shapes; for the limb
kernels: the same from the ``scale`` run; for the engine kernels:
launches on the ``table1`` run, ``path_ms`` / ``path_bound_ms`` the sums
of their CUDA-event times and bounds there, and ``ms`` / ``plain_ms`` /
``bound_ms`` on ``engine_check``'s check batch, summed over the five
baseline systems for ``engine_baseline``; an engine kernel's bound counts
the words its algorithm must read for the run's data, from the inputs and
the checked results, not the kernel's own scans: ``engine_bound``) and,
last,
``{"ok": true, "device": {...}}``.

Every path that launches the kernels holds each kernel against its plain
version on one input of every distinct shape and dtype the path gave it,
times it in full at the largest, and by graph replay at every shape it
launched at, with the launches at each: the sharded runs' device time per
kernel is the sum of launches times graph ms over its shapes.  The flat
mask's lines also give the share of its rows of 2**32 or more (the
64-bit test) and of 0 or 1 (no test), the largest pool entry, and at
each timed shape ``write_only_ms``, the graph time of writing a mask of
that shape alone (a PyTorch fill); the limb factorization's give its rows
by significant limbs and the most hits of a row.  Every
check raises; the first failure prints ``{"phase": ..., "error": ...,
"traceback": ...}`` on stdout and exits 1.  No measurement decides pass
or fail.  Kernel times are
CUDA-event times: ``graph_ms`` per launch replayed from a captured CUDA
graph (no host work between launches; ``ms`` in the ``kernels`` line,
null when the capture failed), ``wrapper_ms`` per call of the
Python wrapper in a loop (what a caller that issues launches one by one
pays), ``plain_ms`` per call of the plain version in a loop, and
``library_ms`` / ``library_wrapper_ms`` the same two for ``torch.gcd``
(gcd only; a yardstick the port never calls).

Without a card (``torch.cuda.is_available()`` false) it prints no result
and exits 2.

    python3 chip_smoke.py --compare-engine DIR [--rounds 2]

runs none of that: it times the Table-1 engine kernels of the port in
``DIR`` (holding its ``src``, e.g. ``git archive <commit> src`` unpacked)
against this tree's, each tree in processes of its own, in turns
(``compare_engine``).
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
    ("divisibility_mask_limbs", "src/repro/kernels/factorize.py:99",
     "src/repro_torch/kernels/csrc/divmask_limbs.cu"),
    ("factorize_limbs", "src/repro/kernels/factorize.py:155",
     "src/repro_torch/kernels/csrc/factorize_limbs.cu"),
    ("gcd_limbs", "src/repro/kernels/gcd.py:143",
     "src/repro_torch/kernels/csrc/gcd_limbs.cu"),
]
PORTED = [name for name, _, src in TPU_KERNELS if src]
#: the kernels every narrow sharded path launches
FLAT = ["divisibility_mask", "factorize_squarefree", "gcd"]
#: the multi-limb kernels of wide registries
LIMB = ["divisibility_mask_limbs", "factorize_limbs", "gcd_limbs"]

#: the trace engine's kernels (no Pallas kernel of the reference: each
#: replaces a ``lax.scan`` loop) and the reference code they replace
ENGINE_KERNELS = [
    ("engine_baseline", "src/repro/core/engine/batch.py:47",
     "src/repro_torch/kernels/csrc/engine_baseline.cu"),
    ("engine_pfcs", "src/repro/core/engine/batch.py:82",
     "src/repro_torch/kernels/csrc/engine_pfcs.cu"),
]
ENGINE = [name for name, _, _ in ENGINE_KERNELS]
#: the engine's systems: the baselines (``engine_baseline``) and PFCS
BASELINES = ("lru", "fifo", "2q", "arc", "lirs")

#: ``benchmarks/table1.py``'s level capacities and workloads (lines
#: 27-55), unreduced, and its documented ``--trials 3`` (seeds 0-2)
TABLE1_CAPS = (("L1", 64), ("L2", 256), ("L3", 2048))
TABLE1_TRIALS = 3
TABLE1_WORKLOADS = {
    "db_join": ("db_join_trace", dict(n_orders=4000, n_customers=600,
                                      n_items=1200, n_queries=20000)),
    "ml_epoch": ("ml_epoch_trace", dict(n_samples=2500, n_feature_rows=600,
                                        n_epochs=3)),
    "hft": ("hft_trace", dict(n_instruments=2500, n_corr_groups=350,
                              n_events=20000)),
}
#: seed-0 hits / demand accesses of each workload and system, from the
#: scalar oracles (``simulate_baseline``, ``simulate_pfcs``)
TABLE1_SEED0 = {
    "db_join": {"lru": (15761, 20000), "fifo": (15028, 20000),
                "2q": (14483, 20000), "arc": (15923, 20000),
                "lirs": (15920, 20000), "pfcs": (17977, 20000)},
    "ml_epoch": {"lru": (23649, 30000), "fifo": (23295, 30000),
                 "2q": (22516, 30000), "arc": (24023, 30000),
                 "lirs": (24025, 30000), "pfcs": (24565, 30000)},
    "hft": {"lru": (18272, 20000), "fifo": (18272, 20000),
            "2q": (17458, 20000), "arc": (18272, 20000),
            "lirs": (18272, 20000), "pfcs": (19220, 20000)},
}
#: every PFCS counter of every trial (seeds 0-2) of each workload, from
#: the scalar oracle ``simulate_pfcs``: hits per level, misses, demand
#: accesses, prefetches issued, used and true
#: (``tests/test_torch_engine_ref.py`` holds them against the
#: reference's oracle)
TABLE1_PFCS = {
    "db_join": [((2671, 4299, 11007), 2023, 20000, 4702, 2936, 4702),
                ((2588, 4394, 10923), 2095, 20000, 5142, 3159, 5142),
                ((2781, 4501, 10713), 2005, 20000, 4714, 2907, 4714)],
    "ml_epoch": [((2004, 6758, 15803), 5435, 30000, 1071, 915, 1071),
                 ((2044, 6931, 15622), 5403, 30000, 1079, 942, 1079),
                 ((2063, 6722, 15777), 5438, 30000, 1070, 948, 1070)],
    "hft": [((8932, 5027, 5261), 780, 20000, 1020, 948, 1020),
            ((8402, 4881, 5889), 828, 20000, 981, 927, 981),
            ((6856, 6075, 6211), 858, 20000, 1012, 953, 1012)],
}
#: the workloads whose PFCS trial 0 ``table1`` also runs through
#: ``simulate_pfcs`` on the card's host (0.5 s of host Python on hft,
#: 1.9-2.0 s each on the other two)
TABLE1_PFCS_ORACLE = ("hft",)
#: ``engine_check``'s level capacities (those of ``tests/test_engine.py``)
#: and trace lengths: the check batch, the PFCS variants' batch and the
#: capacity-1 batch
CHECK_CAPS = (("L1", 8), ("L2", 24), ("L3", 64))
CHECK_LENGTH = 512
VARIANT_LENGTH = 256
CAPACITY1_LENGTH = 100
#: ``engine_check``'s placement batches: the check traces at this length,
#: their keys spread by ``KEY_SPREAD`` (400 keys become a 60,000-key space,
#: whose per-key arrays do not fit in shared memory beside the slots), and
#: the same traces at ``GLOBAL_CAPS``, whose slots do not fit either
#: (every array in global memory)
PLACEMENT_LENGTH = 48
KEY_SPREAD = 150
GLOBAL_CAPS = (("L1", 8), ("L2", 24), ("L3", 20_000))
#: ``engine_check``'s long batch at ``GLOBAL_CAPS`` (``global_traces``):
#: its blocks' keys, and its counters by the port's scalar oracles
#: (``simulate_baseline`` / ``simulate_pfcs``), which
#: ``tests/test_torch_engine_ref.py`` holds to the reference's: per system
#: and trace, the hits per level (the baselines' MEM last), misses and
#: demand accesses (PFCS: then the prefetches issued, used and true)
GLOBAL_BLOCK = 14_000
GLOBAL_COUNTS = {
    "lru": [[0, 0, 42000, 0, 42000, 84000], [47, 185, 50680, 0, 29088, 80000]],
    "fifo": [[0, 0, 42000, 0, 42000, 84000],
             [47, 185, 47511, 1836, 30421, 80000]],
    "2q": [[0, 0, 22080, 6032, 55888, 84000],
           [47, 185, 39019, 503, 40246, 80000]],
    "arc": [[0, 0, 31016, 0, 52984, 84000], [47, 185, 49899, 916, 28953, 80000]],
    "lirs": [[0, 0, 24062, 5031, 54907, 84000],
             [47, 185, 48246, 2539, 28983, 80000]],
    "pfcs": [[0, 0, 46007, 37993, 84000, 3986, 3986, 3986],
             [47, 185, 50680, 29088, 80000, 0, 0, 0]],
}

#: limb counts of the limb kernels' synthetic checks (64 to 1024 bits)
LIMB_WIDTHS = (2, 3, 8, 32)
#: ``case_scale``'s published size (``benchmarks/cases.py``)
SCALE_SIZE = dict(n_chains=10_000, depth=100, n_verify_chains=24)
#: query primes whose full-registry hits are held against an exact host
#: scan in ``scale_full_scan`` (each scan walks the whole registry)
FULL_SCAN_EXACT_PRIMES = 8
#: rows per chunk of the plain version in ``scale_full_scan``
FULL_SCAN_CHUNK = 1 << 16


#: the launch floor measured in the build phase (ms), in every kernel line
LAUNCH_FLOOR_MS = None


def launch_floor_kernel():
    """The empty kernel of ``csrc/launch_floor.cu`` behind the kernels'
    own ``ctypes`` binding; not a kernel of the port (not in ``KERNELS``)."""
    import ctypes

    from repro_torch.kernels.cuda import CudaKernel

    return CudaKernel("launch_floor", "launch_floor.cu", "pfcs_launch_floor",
                      [ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
                      register=False)


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


#: pool entries the limb checks add: powers of two (small and 2**30), an
#: even composite, and the largest primes below 2**31
ADVERSARIAL_POOL = (2, 4, 6, 2**30, 2_147_483_647, 2_147_483_629)
#: a prime below 2**31 that no pool of the limb checks holds
OUTSIDE_PRIME = 2_147_483_587


def adversarial_rows(n_limbs: int, rng) -> list:
    """Values of ``n_limbs`` limbs at the edges of the limb kernels'
    arithmetic: all limbs 0xFFFFFFFF; a top nonzero limb at limb 0, a
    middle limb and limb L - 1; multiples of the even and largest pool
    entries."""
    top = 1 << (32 * n_limbs)
    out = [top - 1]
    for k in sorted({0, n_limbs // 2, n_limbs - 1}):
        out.append(int(rng.integers(1, 2**32)) << (32 * k)
                   | int.from_bytes(rng.bytes(4 * k), "little"))
    out += [2**30 * 2_147_483_647 * 3, 6 * 2_147_483_629 * 5,
            4 * 2_147_483_647, 2**30]
    return [v % top for v in out]


def synthetic_limb_inputs(n_limbs: int, rng):
    """Limb-kernel inputs at registry-refresh sizes with ragged edges:
    mask 4099 x 1030, factorize 2051 x 1030, gcd 16,411 pairs against a
    1030-entry pool.  Composites are products of distinct pool primes that
    fit ``32 * n_limbs`` bits, some times a squared prime, random limb
    rows, zero rows, value-1 rows and ``adversarial_rows``; the pool holds
    distinct primes below 2**31, one of them twice, ``ADVERSARIAL_POOL``
    and the pads 0 and 1; gcd pairs share primes, and include a zero pair,
    a pair sharing a prime the pool lacks, and runs of pairs sharing their
    a or their b row."""
    from repro_torch.core.composite import pack_limbs

    bits = 32 * n_limbs
    primes = _primes_upto(1 << 21)
    pool = np.concatenate([rng.choice(primes[primes > 1000], size=1016,
                                      replace=False),
                           [3, 5, *ADVERSARIAL_POOL, 0, 1, 0, 1, 0, 7]])
    pool[-1] = pool[0]
    pool = rng.permutation(pool)
    live = pool[pool > 1]

    def composites(n):
        out = []
        for i in range(n):
            if i % 5 == 4:
                out.append(int.from_bytes(rng.bytes(4 * n_limbs), "little"))
                continue
            v = 1
            for q in rng.choice(live, size=int(rng.integers(1, 60)),
                                replace=False):
                if (v * int(q)).bit_length() < bits:
                    v *= int(q)
            if i % 5 == 3 and (v * 9).bit_length() < bits:
                v *= 9
            out.append(v)
        out[:4] = [0, 1, 0, 45]
        edge = adversarial_rows(n_limbs, rng)
        out[6:6 + len(edge)] = edge
        return pack_limbs(out, n_limbs)

    a = composites(16_411)
    b = np.roll(a, 7, axis=0)
    b[0] = 0                                  # a zero pair (a[0] == 0)
    a[5], b[5] = pack_limbs([OUTSIDE_PRIME * 3, OUTSIDE_PRIME * 5],
                            n_limbs)          # common prime not in the pool
    a[100:400] = a[100]                       # runs of pairs sharing a side,
    b[500:800] = b[500]                       # as the sharded exchange gives

    def t(x):
        return torch.from_numpy(np.asarray(x, dtype=np.int64)).to(DEVICE)

    return {"divisibility_mask_limbs": (t(composites(4099)), t(pool)),
            "factorize_limbs": (t(composites(2051)), t(pool)),
            "gcd_limbs": (t(a), t(b), t(pool))}


def kernel_pair(name: str):
    """``(kernel wrapper, plain version)`` of one ported kernel."""
    from repro_torch.kernels import factorize, gcd, ref

    return {"divisibility_mask": (factorize.divisibility_mask,
                                  ref.divisibility_mask_ref),
            "factorize_squarefree": (factorize.factorize_squarefree,
                                     ref.factorize_squarefree_ref),
            "gcd": (gcd.gcd, ref.gcd_ref),
            "divisibility_mask_limbs": (factorize.divisibility_mask_limbs,
                                        ref.divisibility_mask_limbs_ref),
            "factorize_limbs": (factorize.factorize_limbs,
                                ref.factorize_limbs_ref),
            "gcd_limbs": (gcd.gcd_limbs, ref.gcd_limbs_ref)}[name]


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
    else ``None`` (always for limb inputs, which are int64 only)."""
    if args[0].dim() != 1:
        return None
    if args[0].dtype == torch.int32:
        return tuple(a.to(torch.int64) for a in args)
    if max(int(a.max()) for a in args if a.numel()) <= 2**31 - 1:
        return tuple(a.to(torch.int32) for a in args)
    return None


def significant_limbs(limbs: torch.Tensor) -> torch.Tensor:
    """(N,) count of each row's limbs up to its top nonzero one (0 for a
    zero row): the Horner steps the row needs, since a step on a leading
    zero limb leaves the remainder at 0."""
    pos = torch.arange(1, limbs.shape[1] + 1, device=limbs.device)
    return ((limbs != 0) * pos).amax(dim=1)


def _n_limbs(x: int) -> int:
    return -(-x.bit_length() // 32)


def _row_ints(limbs: torch.Tensor, rows) -> list:
    return [sum(v << (32 * k) for k, v in enumerate(r))
            for r in limbs[torch.as_tensor(rows, dtype=torch.long,
                                           device=limbs.device)].tolist()]


def division_steps(limbs: torch.Tensor, mask: torch.Tensor,
                   pool: torch.Tensor) -> int:
    """Short-division steps of the limb factorization: each nonzero row
    divided by its hits in pool order, each division as many steps as
    the residual's significant limbs."""
    primes, m = pool.cpu().tolist(), mask.cpu().numpy()
    rows = np.flatnonzero(m.any(axis=1) & (significant_limbs(limbs) > 0)
                          .cpu().numpy())
    steps = 0
    for i, r in zip(rows, _row_ints(limbs, rows)):
        for j in np.flatnonzero(m[i]):
            steps += _n_limbs(r)
            r //= primes[j]
    return steps


def multiply_steps(common: torch.Tensor, pool: torch.Tensor,
                   n_limbs: int) -> int:
    """Limb multiply-accumulate steps of the gcd rebuild: for each common
    prime, in pool order, the significant limbs of the product so far
    (kept mod 2**(32 L), as the kernel drops the top carry)."""
    steps, top = 0, 1 << (32 * n_limbs)
    primes, c = pool.cpu().tolist(), common.cpu().numpy()
    for row in c[c.any(axis=1)]:
        g = 1
        for j in np.flatnonzero(row):
            steps += _n_limbs(g)
            g = g * primes[j] % top
    return steps


def trailing_zero_bits(limbs: torch.Tensor) -> torch.Tensor:
    """(N,) trailing zero bits of each row's value; 32 L for a zero row,
    more than any pool entry's power of two."""
    nz = limbs != 0
    first = nz.to(torch.int8).argmax(dim=1)
    low = limbs.gather(1, first[:, None]).squeeze(1)
    ctz = torch.log2((low & -low).clamp(min=1).double()).long()
    return torch.where(nz.any(dim=1), 32 * first + ctz,
                       torch.full_like(first, 32 * limbs.shape[1]))


def split_entries(pool: torch.Tensor):
    """``(t, q)`` with ``pool = 2**t * q``, q odd, for entries > 1; q = 0
    for the entries <= 1, which never divide (``limb_mod.cuh``)."""
    live = pool > 1
    p = torch.where(live, pool, torch.ones_like(pool))
    t = torch.log2((p & -p).double()).long()
    return t, torch.where(live, p >> t, torch.zeros_like(p))


def montgomery_runs(limbs: torch.Tensor, pool: torch.Tensor) -> torch.Tensor:
    """(N, P) bool: the (row, entry) pairs on which the limb kernels run a
    Montgomery pass (``limb_mod.cuh``): the entry's odd part is > 1 and its
    power of two divides the row; the others are settled by one compare."""
    t, q = split_entries(pool)
    tz = trailing_zero_bits(limbs)
    return (q > 1)[None, :] & (t[None, :] <= tz[:, None])


def horner_steps(limbs: torch.Tensor, pool: torch.Tensor) -> int:
    """Montgomery steps of a divisibility test of every row against every
    entry: each row's significant limbs on each (row, entry) pair that
    runs a pass; grouped by the entries' power of two, so that no (N, P)
    tensor is made at the full scan's size."""
    t, q = split_entries(pool)
    n, tz = significant_limbs(limbs), trailing_zero_bits(limbs)
    steps = 0
    for tv in torch.unique(t[q > 1]).tolist():
        steps += (int(((q > 1) & (t == tv)).sum())
                  * int(n[tz >= tv].sum()))
    return steps


def gcd_first_sides(a: torch.Tensor, b: torch.Tensor):
    """``(a_first, fresh)``, (N,) bool each: the side each pair tests
    against the whole pool, as ``gcd_limbs.cu`` picks it over the pairs in
    order with one cached row (the cached row's side when a or b equals
    it; else a side equal to the previous pair's, a first; else the side
    with fewer significant limbs, a on a tie), and whether that test is
    made anew (the row is not the cached one).  The kernel's warps each
    start with nothing cached, so they make at least these tests."""
    na, nb = significant_limbs(a).tolist(), significant_limbs(b).tolist()
    rows_a = [tuple(r) for r in a.tolist()]
    rows_b = [tuple(r) for r in b.tolist()]
    a_first, fresh, cached, prev = [], [], None, (None, None)
    for ra, rb, la, lb in zip(rows_a, rows_b, na, nb):
        if ra == cached or rb == cached:
            a_first.append(ra == cached)
            fresh.append(False)
        else:
            side_a = ra == prev[0] or (rb != prev[1] and la <= lb)
            a_first.append(side_a)
            fresh.append(True)
            cached = ra if side_a else rb
        prev = (ra, rb)
    return (torch.tensor(a_first, dtype=torch.bool, device=a.device),
            torch.tensor(fresh, dtype=torch.bool, device=a.device))


def limb_work(name: str, args, outs) -> tuple:
    """``(bytes, operations)`` a limb kernel must move and do on these
    inputs: each input read once, each output written once; one
    operation per Montgomery, short-division or multiply step, counting
    only the steps these inputs need (``horner_steps`` for a
    divisibility test, the residual's significant limbs for a division,
    the product's for a multiply).  The gcd tests one side of each pair
    against the whole pool where ``gcd_first_sides`` says it is tested
    anew, the other side only where that one is divisible, and multiplies
    only where both are."""
    from repro_torch.kernels import ref

    limbs, pool = args[0], args[-1]
    n, nl = limbs.shape
    words = 8 * (n * nl)
    if name == "divisibility_mask_limbs":
        return (words + 8 * pool.numel() + outs[0].numel(),
                horner_steps(limbs, pool))
    if name == "factorize_limbs":
        return (2 * words + 8 * pool.numel() + outs[0].numel(),
                horner_steps(limbs, pool)
                + division_steps(limbs, outs[0], pool))
    a, b = args[0], args[1]
    in_a = ref.divisibility_mask_limbs_ref(a, pool)
    in_b = ref.divisibility_mask_limbs_ref(b, pool)
    na, nb = significant_limbs(a), significant_limbs(b)
    a_first, fresh = gcd_first_sides(a, b)
    runs_a, runs_b = montgomery_runs(a, pool), montgomery_runs(b, pool)
    runs1 = torch.where(a_first[:, None], runs_a, runs_b) & fresh[:, None]
    runs2 = torch.where(a_first[:, None], in_a & runs_b, in_b & runs_a)
    n1, n2 = torch.where(a_first, na, nb), torch.where(a_first, nb, na)
    steps = int((runs1.sum(dim=1) * n1).sum() + (runs2.sum(dim=1) * n2).sum())
    return (3 * words + 8 * pool.numel(),
            steps + multiply_steps(in_a & in_b, pool, nl))


def kernel_work(name: str, args, outs) -> tuple:
    """``(bytes, operations, shape)`` of one kernel call on these inputs."""
    elem = args[0].element_size()
    if name in LIMB:
        return (*limb_work(name, args, outs), [list(a.shape) for a in args])
    if name == "gcd":
        n = args[0].numel()
        return 3 * n * elem, euclid_steps(*args), [n]
    n, p = args[0].numel(), args[1].numel()
    n_bytes, n_ops = (n + p) * elem + n * p, n * p
    if name == "factorize_squarefree":
        n_bytes += n * elem
        n_ops += int(outs[0].sum())              # one division per hit
    return n_bytes, n_ops, [n, p]


def check_and_time(name: str, args) -> dict:
    """The kernel against its plain version on the same card inputs
    (exact, or raise), then its times, its plain version's time, and its
    bound from these inputs."""
    kern, plain = kernel_pair(name)
    err, outs_k = check_exact(name, args)
    n_bytes, n_ops, shape = kernel_work(name, args, outs_k)
    b_ms, b_by = bound_ms(n_bytes, n_ops)
    row = {"name": name, "dtype": str(args[0].dtype).replace("torch.", ""),
           "shape": shape, "bytes": n_bytes, "operations": n_ops,
           "max_abs_err": err, **timed(lambda: kern(*args)),
           "plain_ms": loop_ms(lambda: plain(*args), max_reps=20),
           "bound_ms": b_ms, "bound_by": b_by,
           "library_ms": None, "library_wrapper_ms": None,
           "launch_floor_ms": LAUNCH_FLOOR_MS}
    if name == "gcd":
        lib = timed(lambda: torch.gcd(*args))
        row["library_ms"] = lib["graph_ms"]
        row["library_wrapper_ms"] = lib["wrapper_ms"]
    if name == "divisibility_mask":
        row["write_only_ms"] = mask_write_ms(outs_k[0])
    return row


def mask_write_ms(mask: torch.Tensor) -> float:
    """Graph-replay ms of writing a mask of this shape alone (PyTorch's
    fill): a yardstick of the flat mask's stores, never used by the port."""
    out = torch.empty_like(mask)
    return graph_ms(lambda: out.zero_())


def check_and_graph_time(name: str, args) -> dict:
    """The kernel against its plain version on these inputs (exact, or
    raise), its graph-replay time (null with the error when the capture
    failed) and its bound: the lighter measurement of a path's smaller
    shapes."""
    kern, _ = kernel_pair(name)
    _, outs_k = check_exact(name, args)
    n_bytes, n_ops, shape = kernel_work(name, args, outs_k)
    b_ms, b_by = bound_ms(n_bytes, n_ops)
    row = {"shape": shape, "bound_ms": b_ms, "bound_by": b_by}
    try:
        row["graph_ms"] = graph_ms(lambda: kern(*args))
    except RuntimeError as exc:
        torch.cuda.synchronize()
        row["graph_ms"] = None
        row["graph_error"] = f"{type(exc).__name__}: {exc}"[:300]
    if name == "divisibility_mask":
        row["write_only_ms"] = mask_write_ms(outs_k[0])
    return row


class Capture:
    """Keeps one copy of the inputs of every distinct shape and dtype that
    each kernel wrapper saw during a run (``inputs[name][key]``; the
    callers pad to bucketed widths, so there are few) and the launches
    made at each (``launches[name][key]``), so that the kernels can be
    checked and timed at every shape the path gave them.  The wrapped
    functions call the originals, whose launch counts are unchanged."""

    def __init__(self):
        from repro_torch.kernels import factorize, gcd, ops

        self.inputs, self.launches = {}, {}
        self._undo = []
        for mod in (factorize, gcd, ops):
            for name in PORTED:
                if hasattr(mod, name):
                    self._wrap(mod, name)

    def _wrap(self, mod, name):
        from repro_torch.kernels import KERNELS

        orig = getattr(mod, name)

        def wrapped(*args):
            if args[0].device.type != DEVICE:
                return orig(*args)
            key = (str(args[0].dtype).replace("torch.", ""),
                   tuple(tuple(a.shape) for a in args))
            seen = self.inputs.setdefault(name, {})
            if key not in seen:
                seen[key] = tuple(a.clone() for a in args)
            before = KERNELS[name].launches
            try:
                return orig(*args)
            finally:
                counts = self.launches.setdefault(name, {})
                counts[key] = (counts.get(key, 0)
                               + KERNELS[name].launches - before)

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
    kernels, flat or limb, and the squarefree decode; neither calls the
    other), and the
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
        self._wrap(shard, "_scan_sharded_limbs", "kernel_calls_s")
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
    kernel inputs of each distinct shape captured with their launches, and
    the refresh timed: ``(result, launches, capture, seconds)``."""
    from repro_torch import kernels

    capture, timers = Capture(), Timers()
    try:
        kernels.reset_launch_counts()
        out = run(*args, **kw)
        launches = kernels.launch_counts()
    finally:
        timers.close()
        capture.close()
    return out, launches, capture, timers.seconds


def check_path(label: str, launches: dict, inputs: dict,
               timed: bool = True, required=FLAT,
               shape_launches: dict = None) -> list:
    """Every kernel in ``required`` launched on the path, and every kernel
    the path launched held against its plain version on every distinct
    shape and dtype the path gave it (and in the other of int32 / int64
    where the values fit).  With ``timed``, each kernel is also measured
    in full at its largest shape and, given ``shape_launches`` (the
    launches at each shape, ``Capture.launches``, which must add up to
    the kernel's), timed by graph replay at every shape it launched at,
    each shape's launches beside it: ``device_ms`` is the sum of launches
    times graph ms, ``gap_ms`` that of launches times (graph ms - bound
    ms).  Emits one line per kernel and returns the lines."""
    launched = [n for n in PORTED if launches.get(n, 0) > 0]
    if (any(n not in launched or n not in inputs for n in required)
            or sorted(inputs) != sorted(launched)):
        raise AssertionError(f"{label}: a kernel was not launched on the "
                             f"path, or launched uncaptured: {launches}")
    rows = []
    for name in launched:
        seen = inputs[name]
        counts = (shape_launches or {}).get(name, {})
        if (shape_launches is not None
                and sum(counts.values()) != launches[name]):
            raise AssertionError(f"{label}: {name}'s launches by shape "
                                 f"{sum(counts.values())} != {launches[name]}")
        top = max(seen, key=lambda k: sum(a.numel() for a in seen[k]))
        also, shapes = set(), []
        for key, args in seen.items():
            n_at = counts.get(key, 0)
            if timed and key == top:
                row = check_and_time(name, args)
                at = row
            elif timed and n_at:
                at = check_and_graph_time(name, args)
            else:
                check_exact(name, args)
                at = None
            if at is not None and n_at:
                shapes.append({"dtype": key[0], "shape": at["shape"],
                               "launches": n_at, "graph_ms": at["graph_ms"],
                               "bound_ms": at["bound_ms"]})
                if "write_only_ms" in at:
                    shapes[-1]["write_only_ms"] = at["write_only_ms"]
            other = other_dtype(args)
            if other is not None:
                check_exact(name, other)
                also.add(str(other[0].dtype).replace("torch.", ""))
        if not timed:
            row = {"name": name, "max_abs_err": 0,
                   "launch_floor_ms": LAUNCH_FLOOR_MS}
        if shapes:
            graph = [x["graph_ms"] for x in shapes]
            row["shapes"] = shapes
            row["device_ms"] = (None if None in graph else
                                sum(x["launches"] * x["graph_ms"]
                                    for x in shapes))
            row["gap_ms"] = (None if None in graph else
                             sum(x["launches"] * (x["graph_ms"]
                                                  - x["bound_ms"])
                                 for x in shapes))
        row.update(shapes_checked=len(seen), also_exact_as=sorted(also),
                   largest=[list(map(list, top[1])), top[0]])
        if name == "divisibility_mask":
            row.update(mask_row_classes(seen, counts))
        if name == "factorize_limbs":
            row.update(limb_row_classes(seen))
        emit({"phase": f"kernel_{label}", **row})
        rows.append(row)
    return rows


def mask_row_classes(seen: dict, counts: dict) -> dict:
    """What the flat mask met on a path: the share of its rows of 2**32
    or more (the 64-bit test; the rest take the 32-bit one), and of 0 or
    1 (no test), over the captured input of each shape weighted by that
    shape's launches (each shape once where none were counted), and the
    largest pool entry captured."""
    wide = small = rows = 0
    for key, (comps, pool) in seen.items():
        k = counts.get(key, 0) or 1
        wide += k * int((comps.long() >= 2**32).sum())
        small += k * int((comps <= 1).sum())
        rows += k * comps.numel()
    return {"rows_at_least_2_32_share": wide / max(rows, 1),
            "rows_0_or_1_share": small / max(rows, 1),
            "max_pool_entry": max((int(pool.max()) for _, pool in seen.values()
                                   if pool.numel()), default=None)}


def limb_row_classes(seen: dict) -> dict:
    """What the limb factorization met on a path: its rows by significant
    limbs (``{limbs: rows}``) and the most hits (dividing entries) of any
    row, over the captured inputs."""
    from repro_torch.kernels import ref

    by_limbs, hits = {}, 0
    for limbs, pool in seen.values():
        counts = torch.bincount(significant_limbs(limbs)).tolist()
        for k, v in enumerate(counts):
            if v:
                by_limbs[str(k)] = by_limbs.get(str(k), 0) + v
        mask = ref.divisibility_mask_limbs_ref(limbs, pool)
        hits = max(hits, int(mask.sum(dim=1).max()) if mask.numel() else 0)
    return {"rows_by_significant_limbs": by_limbs, "max_hits_per_row": hits}


def time_split(wall_s: float, seconds: dict, launches: dict,
               rows: list) -> dict:
    """Where a sharded run's wall time went, and the card's busy share two
    ways.  Upper bound (measured): the host seconds inside the calls that
    reach the card, over wall; each call waits for its results, so the
    card works only inside them.  It holds only when every launch fell
    inside them, else it is null.  Estimate: each kernel's launches at
    each shape costed at that shape's graph-replay time (``device_ms`` of
    ``check_path``; replay hides the per-launch overhead); null when a
    graph capture failed or a row has no per-shape times."""
    total = sum(launches[r["name"]] for r in rows)
    inside = seconds["kernel_calls_launches"]
    per_kernel = {r["name"]: r.get("device_ms") for r in rows}
    est = (None if None in per_kernel.values() else
           sum(per_kernel.values()) / 1e3)
    return {"wall_s": wall_s, **seconds,
            "refresh_host_python_s": seconds["refresh_s"]
            - seconds["kernel_calls_s"],
            "outside_refresh_s": wall_s - seconds["refresh_s"],
            "launches_outside_kernel_calls": total - inside,
            "device_busy_upper_share": (seconds["kernel_calls_s"] / wall_s
                                        if inside == total else None),
            "device_ms_by_kernel": per_kernel,
            "device_busy_graph_est_s": est,
            "device_busy_graph_est_share": (None if est is None
                                            else est / wall_s)}


# --------------------------------------------------------------------------- #
# serving                                                                     #
# --------------------------------------------------------------------------- #

def run_serving(kv: str, budget: int, smoke: bool, n_shards: int = 2,
                max_bits: int = 62):
    """``benchmarks/cases.py::case_serving``'s engine run, on the card:
    ``(report, trail)``, the trail holding the parity counters, every
    touch's tier and the prefetch log."""
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
                        max_bits=max_bits, device=DEVICE)
    tiers, record_s = [], [0.0]

    def record(items, touch=eng.pages.touch_batch):
        out = touch(items)
        t = time.perf_counter()
        tiers.extend(out)
        record_s[0] += time.perf_counter() - t
        return out

    eng.pages.touch_batch = record
    groups = [list(rng.integers(0, 30_000, size=shared_tok))
              for _ in range(max(1, n_req // 8))]
    for r in range(n_req):
        tail = list(rng.integers(0, 30_000, size=int(rng.integers(48, 129))))
        eng.submit(groups[r % len(groups)] + tail, max_new_tokens=max_new)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    done = eng.run_until_idle()
    torch.cuda.synchronize()
    # the wall leaves out the tier recording (reported on its own)
    wall = time.perf_counter() - t0 - record_s[0]
    st = eng.pages.stats
    out = {"kv": kv, "max_bits": max_bits, "completed": len(done),
           "wall_s": wall, "tier_record_s": record_s[0],
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
    trail = {"parity": st.parity_tuple(), "tiers": tiers,
             "prefetch_log": list(eng.pages.prefetch_log)}
    return out, trail


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


def run_batching(arrivals, sizes, config: str, kv: str = "vec",
                 max_bits: int = 62):
    """One ``case_batching`` engine on the card: ``config`` is a key of
    ``BENCH_case_batching.json``."""
    from repro_torch.serving.slots import SlotMachine, SlotOracle

    cls, policy, budget, wait = {
        "slot_vec": (SlotMachine, "continuous", 4, 6),
        "slot_oracle": (SlotOracle, "continuous", 4, 6),
        "lockstep": (SlotMachine, "lockstep", 4, None),
        "lru": (SlotMachine, "continuous", 0, 6)}[config]
    eng = cls(page_size=16, kv=kv, prefetch_budget=budget, reread_window=2,
              policy=policy, preempt_wait=wait, shards=2, max_bits=max_bits,
              device=DEVICE, **sizes)
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
        self.serving_trail = None     # narrow case_serving full, kv="vec"
        self.batching = None          # the smoke trace and its vec run
        self.universe = None          # case_scale's registry
        self.scale_launches = None
        self.scale_rows = []
        self.engine_check = {}        # engine kernel -> its check-batch times
        self.engine_path = {}         # engine kernel -> its table1 launches
        self.engine_builds = None     # the engine kernels' nvcc, running


def phase_device(ctx: Context) -> dict:
    from repro_torch.kernels import cuda

    ctx.kind = torch.cuda.get_device_name(0)
    ctx.smi, smi_error = nvidia_smi()
    return {"kind": ctx.kind, "count": torch.cuda.device_count(),
            "torch": torch.__version__, "cuda": torch.version.cuda,
            "python": sys.executable, "nvcc": cuda.nvcc_path(),
            "build_dir": str(cuda.build_dir()), "nvidia_smi": ctx.smi,
            "nvidia_smi_error": smi_error}


#: the kernels whose compiled functions the build line names (the
#: ``-Xptxas -v`` lines of each template instance follow its name)
NAMED_INSTANCES = ("divisibility_mask", "factorize_squarefree", "gcd",
                   "factorize_limbs", "engine_baseline", "engine_pfcs")


def phase_build(ctx: Context) -> dict:
    """Start one ``nvcc`` per source, all together; wait for the
    discovery kernels and the empty one, and leave the engine kernels'
    (the longest: the baseline's template instances) building while the
    serving paths run, until ``engine_check``."""
    global LAUNCH_FLOOR_MS
    from repro_torch import kernels
    from repro_torch.kernels.cuda import Builds

    if sorted(kernels.KERNELS) != sorted(PORTED + ENGINE):
        raise AssertionError(f"kernels {sorted(kernels.KERNELS)} != "
                             f"{sorted(PORTED + ENGINE)}")
    floor = launch_floor_kernel()
    ctx.engine_builds = Builds([kernels.KERNELS[n] for n in ENGINE])
    nvcc_s = Builds([k for n, k in kernels.KERNELS.items()
                     if n not in ENGINE] + [floor]).finish()
    dev = torch.device(DEVICE)
    LAUNCH_FLOOR_MS = graph_ms(lambda: floor.launch(dev, 1, 256))
    return {"nvcc_seconds": nvcc_s,
            "launch_floor_ms": LAUNCH_FLOOR_MS,
            "launch_floor": "empty kernel, 1 block of 256 threads, "
                            "csrc/launch_floor.cu through ctypes, graph "
                            "replay",
            "ptxas": {name: ptxas_lines(k) for name, k in
                      kernels.KERNELS.items() if name not in ENGINE},
            "engine_kernels": "still building (engine_check waits for "
                              "them; table1 prints their ptxas lines)"}


def ptxas_lines(kernel) -> list:
    """``kernel``'s ``-Xptxas -v`` lines: registers, shared memory and
    spills of each compiled function, after its name for the kernels of
    ``NAMED_INSTANCES``."""
    return [ln.strip() for ln in kernel.build_log().splitlines()
            if "registers" in ln or "spill" in ln
            or (kernel.name in NAMED_INSTANCES and "entry function" in ln)]


def fibonacci_pairs(limit: int) -> list:
    """Consecutive Fibonacci pairs (F_k, F_k+1) with F_k+1 <= ``limit``:
    Euclid's worst case."""
    out, a, b = [], 1, 2
    while b <= limit:
        out.append((a, b))
        a, b = b, a + b
    return out


#: large int64 primes of the flat checks
BIG_PRIMES = (1_000_003, 1_000_033, 1_000_037, 1_000_039, 999_983, 999_979)


def adversarial_flat_inputs(dtype, device=None):
    """Flat inputs at the edges of the kernels' arithmetic, each valid in
    ``dtype``: ``{"factorize": [(composites, pool), ...], "gcd": [(a, b),
    ...]}``.  Pools: the type's largest values, powers of two (2, 2**30,
    2**62), the largest primes below 2**31, large int64 primes, and an
    out-of-contract pool (a duplicate entry, 2 and 4, 3 and 9) whose
    residuals stop being divisible, so the floor division runs; rows
    keep the product of their dividing entries inside the type, where
    the plain version's residual is defined.  Gcd: consecutive Fibonacci
    pairs to the type's top (both ways round), 0 on either side and both,
    equal sides, sides of 1, powers of two and the largest values, also
    one element off the arrays' 16-byte alignment.  Tensors on ``device``
    (default ``DEVICE``); the tests take the same inputs."""
    top = 2**31 - 1 if dtype == torch.int32 else 2**63 - 1
    cases = [
        ([0, 1, top, 2**30, 105, 2**30 - 1, 210, 2**31 - 2,
          2_147_483_629, 65_521 * 32_749],
         [2_147_483_647, 2**30, 3, 5, 7, 0, 1, 2_147_483_629, 65_521]),
        ([2, 4, 8, 12, 36, 72, 1, 0, 2**30, 6, 2**31 - 1, 81],
         [2, 4, 2, 3, 3, 9, 0, 1]),
    ]
    if dtype == torch.int64:
        m61, big = 2**61 - 1, list(BIG_PRIMES)
        cases.append((
            [top, 2**62, 3 * m61, big[0] * big[1] * big[2],
             big[3] * big[4] * 2**20, 0, 1, 2**62 + 2, m61 * 2,
             2_147_483_647 * 2_147_483_629],
            big + [m61, 2**62, 3, 0, 1, 2_147_483_647, 2_147_483_629]))
    fib = fibonacci_pairs(top)
    pairs = fib + [(b, a) for a, b in fib] + [
        (0, 7), (7, 0), (0, 0), (top, top), (top, 1), (1, top), (1, 1),
        (2**30, 2**12 * 3), (top - 1, (top - 1) // 2), (2**30, 0)]
    if dtype == torch.int64:
        pairs += [(2**62, 2**60 * 5), (2**61 - 1, (2**61 - 1) * 3),
                  (top, 7 * 73), (2**62, 1), (2**40 * 3, 2**35 * 9)]

    def t(x):
        return torch.tensor(x, dtype=dtype, device=device or DEVICE)

    a, b = (t(list(x)) for x in zip(*pairs))
    return {"factorize": [(t(c), t(p)) for c, p in cases],
            "gcd": [(a, b), (b, a), (a[1:], b[1:])]}


def phase_kernel_check(ctx: Context) -> dict:
    rng = np.random.default_rng(0)
    checked = []
    for dtype in (torch.int32, torch.int64):
        adv = adversarial_flat_inputs(dtype)
        for args in adv["factorize"]:
            check_exact("divisibility_mask", args)
            check_exact("factorize_squarefree", args)
        for args in adv["gcd"]:
            check_exact("gcd", args)
        checked.append(f"adversarial flat:{str(dtype).replace('torch.', '')}")
    for dtype in (torch.int32, torch.int64):
        inputs = synthetic_inputs(dtype, rng)
        for name, args in inputs.items():
            row = check_and_time(name, args)
            emit({"phase": "kernel_check", **row})
            checked.append(f"{name}:{row['dtype']}")
        del inputs
    for n_limbs in LIMB_WIDTHS:
        inputs = synthetic_limb_inputs(n_limbs, rng)
        for name, args in inputs.items():
            if n_limbs == LIMB_WIDTHS[-1]:       # timed at the widest
                row = check_and_time(name, args)
                emit({"phase": "kernel_check", **row})
            else:
                check_exact(name, args)
            checked.append(f"{name}:{n_limbs} limbs")
        del inputs
    return {"exact": checked}


def phase_serving_full(ctx: Context) -> dict:
    (vec, ctx.serving_trail), (scalar, _) = (
        run_serving("vec", 4, smoke=False),
        run_serving("scalar", 4, smoke=False))
    full = {"vec": vec, "scalar": scalar}
    (full["sharded"], _), ctx.launches, cap, seconds = traced(
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
    ctx.kernel_rows = check_path("main_path", ctx.launches, cap.inputs,
                                 shape_launches=cap.launches)
    return {"parity": sh["parity"], "launches": ctx.launches,
            "main_path_exact": PORTED,
            "sharded_time_split": time_split(sh["wall_s"], seconds,
                                             ctx.launches, ctx.kernel_rows)}


def phase_serving_smoke(ctx: Context) -> dict:
    runs = {"pfcs_vec": run_serving("vec", 4, smoke=True)[0],
            "pfcs_scalar": run_serving("scalar", 4, smoke=True)[0],
            "lru": run_serving("vec", 0, smoke=True)[0],
            "pfcs_shard2": run_serving("sharded", 4, smoke=True)[0]}
    fresh = {key: {cfg: r[key] for cfg, r in runs.items()}
             for key in ("hbm_hit_rate", "prefetch_hit_rate",
                         "registry_scans", "tok_per_s")}
    failures = bench_failures("BENCH_case_serving.json", fresh)
    if failures:
        raise AssertionError("; ".join(failures))
    return {"matches": "BENCH_case_serving.json", **fresh}


def sharded_batching(arrivals, sizes, vec, vec_trail, label: str,
                     max_bits: int = 62, required=FLAT) -> dict:
    """The ``slot_vec`` engine again with ``kv="sharded"`` (two shards) at
    ``max_bits``: its counters and logs must equal (narrow) ``kv="vec"``'s,
    every kernel in ``required`` must launch, and each kernel it launched
    is held against its plain version on every shape this run gave it."""
    (sharded, trail), launches, cap, seconds = traced(
        run_batching, arrivals, sizes, "slot_vec", kv="sharded",
        max_bits=max_bits)
    same = {k: v for k, v in sharded.items() if k != "wall_s"} == \
        {k: v for k, v in vec.items() if k != "wall_s"}
    if not same or trail != vec_trail:
        raise AssertionError(f"{label}: kv='sharded' slot machine diverged "
                             f"from kv='vec'")
    rows = check_path(label, launches, cap.inputs, required=required,
                      shape_launches=cap.launches)
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
    ctx.batching = (arrivals, sizes, vec, trails["slot_vec"])
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


def run_launcher(*extra: str):
    from repro_torch.launch import serve

    with contextlib.redirect_stdout(io.StringIO()):
        out = serve.main(["--null-model", "--kv", "sharded", "--max-batch",
                          "128", "--requests", "256", "--device", DEVICE,
                          *extra])
    torch.cuda.synchronize()
    return out


def phase_launcher(ctx: Context, extra=(), label: str = "launcher",
                   required=FLAT) -> dict:
    """The user's entry point: all 256 requests complete, every kernel in
    ``required`` launches, and each kernel launched is held against its
    plain version on every shape the run gave it."""
    out, launches, cap, seconds = traced(run_launcher, *extra)
    if out["completed"] != 256:
        raise AssertionError(f"{label} run: {out['completed']} of 256 "
                             f"requests")
    rows = check_path(label, launches, cap.inputs, timed=False,
                      required=required, shape_launches=cap.launches)
    return {"launches": launches, "launcher_seconds": seconds,
            "shapes_checked": {r["name"]: r["shapes_checked"] for r in rows},
            **out}


# --------------------------------------------------------------------------- #
# the wide (multi-limb) path                                                  #
# --------------------------------------------------------------------------- #

#: the kernels every wide sharded serving path launches: the limb scan and
#: the limb gcd exchange (the decode of its gcds, products of two primes,
#: takes the flat factorization)
WIDE_SHARDED = ["divisibility_mask_limbs", "gcd_limbs",
                "factorize_squarefree"]


def phase_scale(ctx: Context) -> dict:
    """``case_scale`` at its published size: the registry is built on the
    host, the verification runs the three limb kernels on the card (the
    launches of the ``kernels`` line), and every deterministic key of
    ``BENCH_case_scale.json`` is reproduced."""
    from repro_torch.cases import build_scale_universe, verify_scale

    t0 = time.perf_counter()
    ctx.universe = build_scale_universe(**SCALE_SIZE)
    build_s = time.perf_counter() - t0
    out, ctx.scale_launches, cap, _ = traced(verify_scale, ctx.universe,
                                             device=DEVICE)
    failures = bench_failures("BENCH_case_scale.json", out)
    if failures:
        raise AssertionError("; ".join(failures))
    ctx.scale_rows = check_path("scale", ctx.scale_launches, cap.inputs,
                                required=LIMB, shape_launches=cap.launches)
    return {"matches": "BENCH_case_scale.json", "build_s": build_s,
            "launches": ctx.scale_launches, **out}


def phase_scale_full_scan(ctx: Context) -> dict:
    """The limb mask kernel over the whole ``case_scale`` registry against
    its query primes: equal to its plain version (run in row chunks), no
    false positive (each hit re-checked with Python ints), no miss for
    ``FULL_SCAN_EXACT_PRIMES`` primes (their hits equal an exact host
    scan of every composite), and no hit for a negative control."""
    from repro_torch import kernels
    from repro_torch.cases import NEGATIVE_PRIMES
    from repro_torch.kernels import factorize, ref

    u = ctx.universe
    t0 = time.perf_counter()
    limbs = u.registry.limbs_array()
    comps = u.registry.composites_list()
    pack_s = time.perf_counter() - t0
    lt = torch.from_numpy(limbs).to(DEVICE)
    qt = torch.tensor(u.queries, dtype=torch.int64, device=DEVICE)
    kernels.reset_launch_counts()
    mask = factorize.divisibility_mask_limbs(lt, qt)
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    if launches["divisibility_mask_limbs"] != 1:
        raise AssertionError(f"full scan did not launch the kernel once: "
                             f"{launches}")
    n, nl = lt.shape
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    plain = [ref.divisibility_mask_limbs_ref(lt[lo:lo + FULL_SCAN_CHUNK], qt)
             for lo in range(0, n, FULL_SCAN_CHUNK)]
    stop.record()
    torch.cuda.synchronize()
    plain_ms = start.elapsed_time(stop)
    for lo, chunk in zip(range(0, n, FULL_SCAN_CHUNK), plain):
        if not torch.equal(mask[lo:lo + FULL_SCAN_CHUNK], chunk):
            raise AssertionError(f"full scan: kernel != plain in rows "
                                 f"{lo}:{lo + chunk.shape[0]}")
    del plain
    rows, cols = (x.cpu().numpy() for x in torch.nonzero(mask,
                                                         as_tuple=True))
    false_pos = sum(1 for i, j in zip(rows, cols)
                    if comps[i] % u.queries[j] != 0)
    if false_pos:
        raise AssertionError(f"full scan: {false_pos} false positives")
    n_neg = len(NEGATIVE_PRIMES)
    if bool(mask[:, -n_neg:].any()):
        raise AssertionError("full scan: a negative-control prime hit")
    n_pos = len(u.queries) - n_neg
    exact = sorted({int(j) for j in np.linspace(0, n_pos - 1,
                                                FULL_SCAN_EXACT_PRIMES)})
    t0 = time.perf_counter()
    for j in exact:
        q = u.queries[j]
        want = [i for i, c in enumerate(comps) if c % q == 0]
        if rows[cols == j].tolist() != want:
            raise AssertionError(f"full scan: hits of prime {q} differ "
                                 f"from the exact host scan")
    host_scan_s = time.perf_counter() - t0
    b_ms, b_by = bound_ms(limbs.nbytes + 8 * qt.numel() + mask.numel(),
                          horner_steps(lt, qt))
    return {"shape": [[n, nl], [qt.numel()]], "launches": launches,
            "max_abs_err": 0, "hits": int(rows.size),
            "false_positives": false_pos, "exact_primes": len(exact),
            "exact_host_scan_s": host_scan_s, "pack_s": pack_s,
            "ms": loop_ms(lambda: factorize.divisibility_mask_limbs(lt, qt),
                          max_reps=5),
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by}


def phase_serving_wide(ctx: Context) -> dict:
    """``case_serving``'s full configuration at ``max_bits`` 128 and 1024
    with every cache backend: parity counters, tiers and prefetch log
    equal to the narrow ``kv="vec"`` run's (placement does not depend on
    the width); then the ``case_batching`` smoke trace with
    ``kv="sharded"`` at 128 bits against its narrow ``kv="vec"`` run."""
    out = {}
    for max_bits in (128, 1024):
        walls = {}
        for kv in ("vec", "scalar"):
            rep, trail = run_serving(kv, 4, smoke=False, max_bits=max_bits)
            if trail != ctx.serving_trail:
                raise AssertionError(f"{kv} at {max_bits} bits diverged "
                                     f"from the narrow run")
            walls[kv] = rep["wall_s"]
        (rep, trail), launches, cap, seconds = traced(
            run_serving, "sharded", 4, smoke=False, max_bits=max_bits)
        if trail != ctx.serving_trail:
            raise AssertionError(f"sharded at {max_bits} bits diverged from "
                                 f"the narrow run")
        label = f"serving_wide_{max_bits}"
        rows = check_path(label, launches, cap.inputs, required=WIDE_SHARDED,
                          shape_launches=cap.launches)
        walls["sharded"] = rep["wall_s"]
        out[label] = {"parity": list(trail["parity"]), "wall_s": walls,
                      "launches": launches,
                      "gcd_pairs": rep["gcd_pairs"],
                      "cross_composites": rep["cross_composites"],
                      "sharded_time_split": time_split(
                          rep["wall_s"], seconds, launches, rows)}
    arrivals, sizes, vec, vec_trail = ctx.batching
    out["batching_wide_128"] = sharded_batching(
        arrivals, sizes, vec, vec_trail, "batching_wide_128", max_bits=128,
        required=WIDE_SHARDED)
    return out


def phase_launcher_wide(ctx: Context) -> dict:
    return phase_launcher(ctx, ("--max-bits", "1024"), "launcher_wide",
                          required=WIDE_SHARDED)


# --------------------------------------------------------------------------- #
# the Table-1 trace engine                                                    #
# --------------------------------------------------------------------------- #

def tree_diff(a, b, path: str = "") -> list:
    """The paths at which two results of the engine's scans differ:
    counters and final state, int arrays as int64, floats by their bits
    (ARC's p); ``visits`` and ``placement`` (the kernel's own reports) are
    not compared."""
    if isinstance(a, dict):
        return [p for k in a if k not in ("visits", "placement")
                for p in tree_diff(a[k], b[k], f"{path}/{k}")]
    if isinstance(a, (tuple, list)):
        return [p for i, (x, y) in enumerate(zip(a, b))
                for p in tree_diff(x, y, f"{path}/{i}")]
    x, y = a.cpu(), b.cpu()
    if x.dtype == torch.float64:
        same = torch.equal(x.view(torch.int64), y.view(torch.int64))
    else:
        same = x.shape == y.shape and torch.equal(x.to(torch.int64),
                                                  y.to(torch.int64))
    return [] if same else [path]


def engine_bytes(name: str, args: tuple, out: dict) -> int:
    """Bytes an engine scan must move: its inputs read once (the accesses
    and, for PFCS, the three tables) and its outputs written once (the
    counters, the final state and ARC's p; not the kernel's own
    ``visits``)."""
    n = 4 * args[0].numel()
    for k, v in out.items():
        if isinstance(v, torch.Tensor) and k != "visits":
            n += v.numel() * v.element_size()
    for _, v in state_leaves(out["state"]):
        n += v.numel() * v.element_size()
    if name == "engine_pfcs":
        n += sum(t.numel() * t.element_size() for t in args[-3:])
    return n


def baseline_work(policy: str, keys, caps, n_keys: int) -> int:
    """The slot words the engine's algorithm must read to run one trace
    (``keys``, padding dropped) through a baseline system, counted by
    replaying the port's scalar policy (``core/policies.py``) beside an
    LRU shadow, apart from the kernel.  Per access: the shadow's keys (the
    match), then its keys and stamps again for the rank pass when the key
    is in it, else its stamps to choose the slot to replace; the policy's
    key arrays (the match, the count and the first free slot come from
    the same read), and the stamp array of each list the step takes an
    LRU entry from: LRU/FIFO on a miss; 2Q's Am on a ghost hit, A1in on a
    cold miss and A1out when that displaces an A1in entry; ARC's B1, T1
    or B2 when a miss drops their LRU and T1 or T2 for each REPLACE; and
    LIRS, over its per-key arrays, the bottom LIR search (status and
    stack stamps) on every access that is not a LIR hit, the queue's
    stamps when a miss finds the cache full, and a second search and
    queue pass in the all-LIR corner."""
    from collections import OrderedDict

    from repro_torch.core.engine.policies_vec import twoq_sizes
    from repro_torch.core.policies import make_policy

    total = sum(caps)
    pol = make_policy(policy, total)
    kin, kout, km = twoq_sizes(total)
    shadow = OrderedDict()
    words = 0
    for key in keys:
        if key in shadow:
            shadow.move_to_end(key)
            words += 3 * total
        else:
            shadow[key] = None
            if len(shadow) > total:
                shadow.popitem(last=False)
            words += 2 * total
        hit = pol.contains(key)
        if policy in ("lru", "fifo"):
            words += total if hit else 2 * total
        elif policy == "2q":
            words += kin + kout + km
            if not hit:
                words += (km if key in pol._a1out else
                          kin + (kout if len(pol._a1in) >= kin else 0))
        elif policy == "arc":
            c = total
            words += 5 * c + 1
            replace = c if (pol.t1 or pol.t2) else 0
            if key in pol.t1 or key in pol.t2:
                pass
            elif key in pol.b1 or key in pol.b2:
                words += replace
            else:
                l1 = len(pol.t1) + len(pol.b1)
                if l1 == c:
                    words += c + replace if len(pol.t1) < c else c
                elif l1 + len(pol.t2) + len(pol.b2) >= c:
                    full = l1 + len(pol.t2) + len(pol.b2) == 2 * c
                    words += (2 * c + 1 if full else 0) + replace
        elif pol.status.get(key) != pol._LIR:
            words += 2 * n_keys
            if not hit and len(pol.resident) >= pol.capacity:
                words += n_keys if pol.q else 4 * n_keys
        pol.access(key)
    return words


def pfcs_level_moves(out: dict, caps, enable_prefetch: bool) -> list:
    """``[(inserts, evictions), ...]`` per level, each (B,), of a PFCS
    run, from its counters and final occupancy: the inserts into L1 are
    the accesses that are no L1 hit, those into level l+1 the evictions
    from level l (plus the prefetches into the last level), and a level's
    evictions its inserts less the keys a hit took out of it (levels below
    L1) less the keys it holds at the end."""
    hits = out["hits"].cpu().long()
    inserts = out["demand"].cpu().long() - hits[:, 0]
    moves = []
    for l, lv in enumerate(out["state"]["levels"]):
        if l == len(caps) - 1 and enable_prefetch:
            inserts = inserts + out["issued"].cpu().long()
        held = (lv["keys"] != -1).sum(1).cpu().long()
        evictions = inserts - (hits[:, l] if l else 0) - held
        moves.append((inserts, evictions))
        inserts = evictions
    return moves


def pfcs_work(out: dict, caps, budget: int, window: int, always: bool,
              enable_prefetch: bool) -> int:
    """The words PFCS's algorithm must read for a batch, from the run's
    counters and final occupancy (each held against the plain version or
    the oracle; ``pfcs_level_moves``), apart from the kernel.  Per access
    the key's level (``where``); on a hit the keys of its level (C+1
    slots); per insert into a level its keys (the first free slot and the
    count) and, for a demand insert, the key's degree; per eviction one
    pass over the level's keys and stamps to select the
    ``min(window, C+1)`` least recent, and their degrees; per prefetch
    trigger the target row and each target's ``where``, and per prefetch
    its truth and degree."""
    hits = out["hits"].cpu().long()
    miss, demand, issued, used = (out[k].cpu().long() for k in
                                  ("miss", "demand", "issued", "used"))
    moves = pfcs_level_moves(out, caps, enable_prefetch)
    words = demand + moves[0][0]          # where[key]; the demand degree
    for l, (c, (inserts, evictions)) in enumerate(zip(caps, moves)):
        n = c + 1
        words += hits[:, l] * n + inserts * n
        words += evictions * (2 * n + min(window, n))
    if enable_prefetch:
        triggers = demand if always else miss + used
        words += triggers * 2 * budget + issued * 2
    return int(words.sum())


def engine_work(name: str, args: tuple, out: dict) -> int:
    """The words the engine's algorithm must read for this call (see
    ``baseline_work`` and ``pfcs_work``): the bound's operations, counted
    from the inputs and the run's checked results, never from the
    kernel's own scans."""
    if name == "engine_pfcs":
        acc, caps, _, budget, window, enable, always = args[:7]
        return pfcs_work(out, caps, budget, window, always, enable)
    acc, policy, caps, n_keys = args
    return sum(baseline_work(policy, [k for k in row if k >= 0], caps,
                             n_keys) for row in acc.cpu().tolist())


def engine_bound(call: dict) -> dict:
    """``call``'s bytes, algorithmic words and bound (bytes over the
    memory rate, words over the int32 operation rate); takes the inputs
    and results that ``EngineCapture`` kept out of ``call``."""
    args, out = call.pop("args"), call.pop("out")
    n_bytes = engine_bytes(call["name"], args, out)
    work = engine_work(call["name"], args, out)
    b_ms, b_by = bound_ms(n_bytes, work)
    return {"bytes": n_bytes, "work": work, "bound_ms": b_ms,
            "bound_by": b_by}


def state_leaves(tree, prefix=()):
    """``(path, tensor)`` for every array of a nested state."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from state_leaves(v, prefix + (k,))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from state_leaves(v, prefix + (i,))
    else:
        yield prefix, tree


class EngineCapture:
    """Every engine scan of a run on the card: which kernel and system,
    the batch's shape, the kernel's device time by CUDA events around its
    launch and the slot words its scans read (``visits``, a diagnostic);
    its inputs and results are kept for ``engine_bound``, which a caller
    runs after the timed run.  The wrapped functions call the originals,
    whose launch counts are unchanged."""

    def __init__(self):
        from repro_torch.kernels import engine

        self.calls, self._events, self._undo = [], [], []
        for fname, kname in (("baseline_scan", "engine_baseline"),
                             ("pfcs_scan", "engine_pfcs")):
            self._wrap_scan(engine, fname, kname)
        for k in (engine.ENGINE_BASELINE, engine.ENGINE_PFCS):
            self._wrap_launch(k)

    def _wrap_scan(self, mod, fname, kname):
        orig = getattr(mod, fname)

        def wrapped(*args, **kw):
            n_events = len(self._events)
            out = orig(*args, **kw)
            torch.cuda.synchronize()
            ms = sum(a.elapsed_time(b) for a, b in self._events[n_events:])
            self.calls.append({
                "name": kname,
                "system": args[1] if kname == "engine_baseline" else "pfcs",
                "shape": list(args[0].shape), "ms": ms,
                # where the kernel kept its state (None: the plain version,
                # or a tree whose kernels do not say)
                "placement": out.get("placement"),
                # (the plain version, on the CPU, counts no visits)
                "visits": (None if out["visits"] is None
                           else int(out["visits"].sum())),
                "args": args, "out": out})
            return out

        setattr(mod, fname, wrapped)
        self._undo.append((mod, fname, orig))

    def _wrap_launch(self, kernel):
        orig = kernel.launch

        def launch(device, *args):
            start, stop = (torch.cuda.Event(enable_timing=True)
                           for _ in range(2))
            start.record()
            orig(device, *args)
            stop.record()
            self._events.append((start, stop))

        kernel.launch = launch
        self._undo.append((kernel, "launch", None))

    def close(self):
        for owner, name, orig in reversed(self._undo):
            if orig is None:
                del owner.launch          # back to the class's method
            else:
                setattr(owner, name, orig)


def _make_trace(gen: str, **kw):
    from repro_torch.core import traces

    return getattr(traces, gen)(**kw)


def check_traces(length: int = None) -> list:
    """The check batch: the port's generators at about ``length``
    (default ``CHECK_LENGTH``) accesses, ragged (the last two shorter,
    padded with -1 in the batch)."""
    length = length or CHECK_LENGTH
    return [_make_trace("zipf_trace", n_keys=400, n_accesses=length,
                        seed=1),
            _make_trace("db_join_trace", n_orders=150, n_customers=40,
                        n_items=80, n_queries=length, seed=2),
            _make_trace("scan_trace", n_keys=length // 3 - 10, n_passes=3),
            _make_trace("graph_walk_trace", n_keys=300,
                        relationship_density=0.7,
                        n_accesses=length * 3 // 5, seed=4)]


def spread_traces(traces) -> list:
    """``traces`` with every key (and relationship member) multiplied by
    ``KEY_SPREAD``: the same accesses over a key space that many times as
    large."""
    from repro_torch.core import Trace

    f = KEY_SPREAD
    return [Trace(name=f"{tr.name} x{f}",
                  accesses=np.asarray(tr.accesses, dtype=np.int64) * f,
                  relationships=[tuple(int(k) * f for k in g)
                                 for g in tr.relationships],
                  n_keys=tr.n_keys * f) for tr in traces]


def global_traces() -> list:
    """Two traces with more distinct keys than ``GLOBAL_CAPS`` hold, so
    that every system evicts with its whole state in global memory: two
    blocks of ``GLOBAL_BLOCK`` keys looped A A B B A A (2Q's Am fills and
    evicts, ARC hits both ghost lists), the first 3,000 keys related in
    threes (PFCS prefetches), and 80,000 zipf accesses (alpha 0.5) over
    30,000 keys."""
    from repro_torch.core import Trace

    b = GLOBAL_BLOCK
    blocks = np.concatenate([np.arange(i * b, (i + 1) * b)
                             for i in (0, 0, 1, 1, 0, 0)])
    return [Trace(name="blocks", accesses=blocks,
                  relationships=[(k, k + 1, k + 2)
                                 for k in range(0, 3000, 3)],
                  n_keys=2 * b),
            _make_trace("zipf_trace", n_keys=30_000, n_accesses=80_000,
                        alpha=0.5, seed=3)]


def scan_counters(out: dict) -> list:
    """A scan's counters per trace, in ``GLOBAL_COUNTS``' order."""
    names = ("hits", "miss", "demand", "issued", "used", "true")
    cols = [out[n].reshape(out[n].shape[0], -1).cpu() for n in names
            if n in out]
    return torch.cat(cols, dim=1).tolist()


def oracle_counters(stats) -> list:
    """A scalar oracle's ``AccessStats`` in ``GLOBAL_COUNTS``' order."""
    out = [*stats.hits_per_level.values(), stats.misses,
           stats.demand_accesses]
    if stats.name == "PFCS":
        out += [stats.prefetches_issued, stats.prefetches_used,
                stats.prefetches_true]
    return out


def arc_swing_accesses(c: int, length: int = 200) -> np.ndarray:
    """Accesses that drive ARC's p (over ``c`` slots) to 0 and to ``c``
    and leave it at a value with a rounding history: loops over 2c keys
    (B1 ghost hits raise p), a hot set touched twice among one-offs (B2
    ghost hits lower it) and random keys, in seeded phases."""
    out = []
    for seed in (1, 6):
        rng = np.random.default_rng(seed)
        part = []
        while len(part) < length:
            phase = int(rng.integers(3))
            if phase == 0:
                part += list(range(2 * c)) * 2
            elif phase == 1:
                hot = rng.integers(100, 100 + c, size=c)
                part += ([int(x) for x in np.repeat(hot, 2)]
                         + list(range(200, 200 + c)))
            else:
                part += [int(x) for x in rng.integers(0, 3 * c, size=2 * c)]
        out += part[:length]
    return np.asarray(out, dtype=np.int64)


def arc_p_path(accesses: np.ndarray, c: int) -> list:
    """ARC's p after every access, by the plain step on the CPU."""
    from repro_torch.core.engine.policies_vec import VEC_POLICIES

    s, step = VEC_POLICIES["arc"](c, 0, 1, "cpu")
    out = []
    for t, k in enumerate(accesses.tolist()):
        s, _ = step(s, torch.tensor([k], dtype=torch.int32), t * 4)
        out.append(float(s["p"][0]))
    return out


def batch_inputs(traces):
    """``(accesses (B, T) int32 on DEVICE, n_keys)``, -1 padded, as
    ``simulate_batch`` makes them."""
    from repro_torch.core.engine.batch import key_space, stack_accesses

    return stack_accesses(traces, DEVICE), key_space(traces)


def pfcs_table_inputs(traces, caps, n_keys: int) -> tuple:
    """The three PFCS tables of ``traces`` (host discovery, budget 4),
    stacked on DEVICE as ``simulate_batch`` hands them to ``pfcs_scan``."""
    from repro_torch.core.engine import pfcs_tables
    from repro_torch.core.engine.batch import stack_tables

    return stack_tables([pfcs_tables(tr, caps, n_keys=n_keys, device=DEVICE)
                         for tr in traces], DEVICE)


#: the placements every shared-memory batch of ``engine_check`` is also
#: asked for (the other template instances of each kernel)
OTHER_PLACEMENTS = ("keys global", "global")


def check_engine(kernel_name: str, args: tuple, also=()) -> dict:
    """One engine scan against its plain version on the same inputs, run
    on the host's CPU: every counter and the whole final state (exact, or
    raise); the scan again with its state placed as each of ``also`` asks,
    each held to the same plain result; the kernel's device time (the
    least of three runs, CUDA events), the plain version's host time, the
    words its algorithm must read and the bound (``engine_bound``)."""
    from repro_torch.kernels import engine

    fname = {"engine_baseline": "baseline_scan",
             "engine_pfcs": "pfcs_scan"}[kernel_name]
    plain = getattr(engine, fname + "_ref")
    cap = EngineCapture()
    try:
        outs = [getattr(engine, fname)(*args) for _ in range(3)]
    finally:
        cap.close()
    placed = {m: getattr(engine, fname)(*args, placement=m) for m in also}
    torch.cuda.synchronize()
    host = tuple(a.cpu() if isinstance(a, torch.Tensor) else a for a in args)
    t0 = time.perf_counter()
    want = plain(*host)
    plain_ms = (time.perf_counter() - t0) * 1e3
    for mode, out in [(None, outs[0]), *placed.items()]:
        bad = tree_diff(want, out)
        if bad:
            where = mode or "its own placement"
            raise AssertionError(f"{kernel_name} {args[1:2]} ({where}): "
                                 f"kernel != plain at {bad[:6]}")
        if mode and out["placement"] and out["placement"]["mode"] != mode:
            raise AssertionError(f"{kernel_name}: asked for {mode!r}, ran "
                                 f"{out['placement']}")
    best = min(cap.calls, key=lambda c: c["ms"])
    best.update(engine_bound(best))
    return {**best, "max_abs_err": 0, "plain_ms": plain_ms,
            "also_exact_in": {m: o["placement"] for m, o in placed.items()},
            "out": outs[0]}


def phase_engine_check(ctx: Context) -> dict:
    """Both engine kernels against their plain versions (the step
    functions run as a Python loop over the trace on the host's CPU): the
    check batch (four traces of the port's generators, ragged) through
    every system and PFCS's variants (a victim window wider than every
    level, no prefetch, prefetch on every access); levels of capacity 1
    (2Q holds two keys); a trace that drives ARC's p to 0 and to c (p
    compared bit for bit).  Each of these runs again with its state asked
    into the two other placements (``OTHER_PLACEMENTS``), held to the same
    plain result.  Then the placements that the sizes choose: a key space
    and levels past shared memory against the plain loop, and a long batch
    whose keys outnumber its 20,032 slots against the scalar oracles'
    counters (``GLOBAL_COUNTS``).  The check batch's times are the
    ``kernels`` line's."""
    t0 = time.perf_counter()
    if ctx.engine_builds:
        ctx.engine_builds.finish()
    waited_s = time.perf_counter() - t0
    caps = [c for _, c in CHECK_CAPS]
    traces = check_traces()
    acc, n_keys = batch_inputs(traces)
    lines, rows = [], {name: [] for name in ENGINE}

    def record(label, kernel_name, args, timed=False, also=OTHER_PLACEMENTS):
        r = check_engine(kernel_name, args, also)
        out = r.pop("out")
        line = {"check": label, **{k: v for k, v in r.items()
                                   if k != "name"}}
        lines.append(line)
        if timed:
            rows[kernel_name].append(r)
        return out

    for policy in BASELINES:
        record(f"{policy} check batch", "engine_baseline",
               (acc, policy, caps, n_keys), timed=True)
    tables = pfcs_table_inputs(traces, CHECK_CAPS, n_keys)
    record("pfcs check batch", "engine_pfcs",
           (acc, caps, n_keys, 4, 8, True, False, *tables), timed=True)
    # PFCS's variants on a shorter batch of the same generators
    short = check_traces(VARIANT_LENGTH)
    acc_v, k_v = batch_inputs(short)
    tables_v = pfcs_table_inputs(short, CHECK_CAPS, k_v)
    for label, window, enable, always in (
            ("pfcs enable_prefetch=False", 8, False, False),
            ("pfcs prefetch_trigger='always'", 8, True, True)):
        record(label, "engine_pfcs",
               (acc_v, caps, k_v, 4, window, enable, always, *tables_v))
    # a window wider than every level (C + 1 = 5, 9, 17): the whole level
    narrow = (("L1", 4), ("L2", 8), ("L3", 16))
    record("pfcs victim_window 100 > C+1", "engine_pfcs",
           (acc_v, [c for _, c in narrow], k_v, 4, 100, True, False,
            *pfcs_table_inputs(short, narrow, k_v)))

    # levels of capacity 1; the first trace opens with 0, 1, 0, after
    # which 2Q's A1in and Am each hold a key for good
    from repro_torch.core import Trace

    one = check_traces(CAPACITY1_LENGTH)[:2]
    one[0] = Trace(name="0,1,0 + zipf", accesses=np.concatenate(
        [[0, 1, 0], one[0].accesses]), relationships=one[0].relationships,
        n_keys=one[0].n_keys)
    acc1, k1 = batch_inputs(one)
    held = {}
    for policy in BASELINES:
        out = record(f"{policy} capacity 1", "engine_baseline",
                     (acc1, policy, [1], k1))
        pol = out["state"]["pol"]
        keys = [v for name, v in pol.items()
                if name in ("keys", "a1k", "amk", "t1k", "t2k")]
        held[policy] = (int(sum((k != -1).sum(dim=1) for k in keys)[0])
                        if keys else int(pol["n_res"][0]))
    if held["2q"] != 2 or any(v != 1 for p, v in held.items() if p != "2q"):
        raise AssertionError(f"capacity 1: keys held {held}; 2Q holds 2 in "
                             f"the reference, every other policy 1")
    record("pfcs capacity 1", "engine_pfcs",
           (acc1, [1], k1, 4, 8, True, False,
            *pfcs_table_inputs(one, (("ONE", 1),), k1)))

    # ARC's p driven to 0 and to c
    swing_caps = [4, 12]
    c = sum(swing_caps)
    swing = arc_swing_accesses(c)
    path = arc_p_path(swing, c)
    if min(path) != 0.0 or max(path) != float(c):
        raise AssertionError(f"the swing trace keeps p in "
                             f"[{min(path)}, {max(path)}], not [0, {c}]")
    out = record("arc p swing", "engine_baseline",
                 (torch.from_numpy(swing.astype(np.int32)[None]).to(DEVICE),
                  "arc", swing_caps, int(swing.max()) + 1))
    p_end = float(out["state"]["pol"]["p"][0])
    if p_end != path[-1]:
        raise AssertionError(f"arc p: kernel {p_end!r} != plain {path[-1]!r}")

    # the placements the sizes choose: the batches above keep the state in
    # shared memory; a key space past shared memory leaves the per-key
    # arrays in global memory, and levels past it every array
    placements = {"shared": lines[:]}
    few = check_traces(PLACEMENT_LENGTH)
    for mode, batch, levels in (("keys global", spread_traces(few),
                                 CHECK_CAPS), ("global", few, GLOBAL_CAPS)):
        acc_p, k_p = batch_inputs(batch)
        tables_p = pfcs_table_inputs(batch, levels, k_p)
        caps_p = [c for _, c in levels]
        n_lines = len(lines)
        for policy in BASELINES:
            record(f"{policy} {k_p} keys {caps_p}, {mode}", "engine_baseline",
                   (acc_p, policy, caps_p, k_p), also=())
        record(f"pfcs {k_p} keys {caps_p}, {mode}", "engine_pfcs",
               (acc_p, caps_p, k_p, 4, 8, True, False, *tables_p), also=())
        placements[mode] = lines[n_lines:]
    for mode, ls in placements.items():
        got = {ln["placement"]["mode"] for ln in ls if ln["placement"]}
        if got - {mode}:
            raise AssertionError(f"engine_check: the {mode} batches ran "
                                 f"with their state {sorted(got)}")
    long_batch = global_check()

    ctx.engine_check = {}
    for name, rs in rows.items():
        b_ms, b_by = bound_ms(sum(r["bytes"] for r in rs),
                              sum(r["work"] for r in rs))
        ctx.engine_check[name] = {
            "systems": [r["system"] for r in rs],
            "shape": rs[0]["shape"],
            "ms": sum(r["ms"] for r in rs),
            "plain_ms": sum(r["plain_ms"] for r in rs),
            "bound_ms": b_ms, "bound_by": b_by}
    asked = sum(len(ln["also_exact_in"]) for ln in placements["shared"])
    return {"checks": lines, "arc_p_range": [min(path), max(path)],
            "arc_p_end": p_end, "held_at_capacity_1": held,
            "check_batch": ctx.engine_check,
            "placements_checked": {m: len(ls) for m, ls in
                                   placements.items()},
            "placements_asked": asked, "global_batch": long_batch,
            # how long this phase waited for the engine kernels' nvcc,
            # started in the build phase
            "engine_build_waited_s": waited_s}


def global_check() -> dict:
    """``global_traces`` through every system at ``GLOBAL_CAPS``, in the
    placement the sizes choose (every array in global memory), each
    trace's counters equal to ``GLOBAL_COUNTS``."""
    from repro_torch.kernels import engine

    traces = global_traces()
    acc, n_keys = batch_inputs(traces)
    caps = [c for _, c in GLOBAL_CAPS]
    tables = pfcs_table_inputs(traces, GLOBAL_CAPS, n_keys)
    out = {}
    for system in BASELINES + ("pfcs",):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if system == "pfcs":
            got = engine.pfcs_scan(acc, caps, n_keys, 4, 8, True, False,
                                   *tables)
        else:
            got = engine.baseline_scan(acc, system, caps, n_keys)
        counts = scan_counters(got)
        wall_ms = (time.perf_counter() - t0) * 1e3
        if counts != GLOBAL_COUNTS[system]:
            raise AssertionError(f"engine_check global batch {system}: "
                                 f"{counts} != the oracles' "
                                 f"{GLOBAL_COUNTS[system]}")
        if got["placement"] and got["placement"]["mode"] != "global":
            raise AssertionError(f"engine_check global batch {system}: ran "
                                 f"{got['placement']}")
        out[system] = {"wall_ms": wall_ms, "placement": got["placement"]}
    return {"traces": [tr.name for tr in traces],
            "accesses": [tr.length for tr in traces], "n_keys": n_keys,
            "levels": caps, "systems": out}


def mean_rows(rows: list) -> dict:
    """The mean of each numeric field of ``derive_table1_row``'s rows over
    the trials (None where every trial has None; text from the first)."""
    out = {}
    for k, v in rows[0].items():
        vals = [r[k] for r in rows if r[k] is not None]
        out[k] = (v if isinstance(v, str) else
                  float(np.mean(vals)) if vals else None)
    return out


def pfcs_counters(st) -> tuple:
    """A PFCS run's counters in ``TABLE1_PFCS``'s order."""
    return (tuple(st.hits_per_level.values()), st.misses,
            st.demand_accesses, st.prefetches_issued, st.prefetches_used,
            st.prefetches_true)


def table1_runs(engine_cap) -> dict:
    """Each Table-1 workload's three traces (PFCS's tables built by
    ``discover="kernel"``) through every system with ``simulate_batch``,
    one engine launch each: ``{workload: (traces, tables, table build s,
    {system: (stats, wall s, engine_cap's call)})}``."""
    from repro_torch.core.engine import pfcs_tables, simulate_batch
    from repro_torch.core.engine.batch import key_space

    results = {}
    for wname, (gen, kw) in TABLE1_WORKLOADS.items():
        traces = [_make_trace(gen, seed=s, **kw)
                  for s in range(TABLE1_TRIALS)]
        n_keys = key_space(traces)
        t0 = time.perf_counter()
        tables = [pfcs_tables(tr, TABLE1_CAPS, discover="kernel",
                              n_keys=n_keys, device=DEVICE)
                  for tr in traces]
        table_s = time.perf_counter() - t0
        per = {}
        for system in BASELINES + ("pfcs",):
            n_calls = len(engine_cap.calls)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            stats = simulate_batch(
                traces, system, TABLE1_CAPS, device=DEVICE,
                tables=tables if system == "pfcs" else None)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            per[system] = (stats, wall, engine_cap.calls[n_calls])
        results[wname] = (traces, tables, table_s, per)
    return results


def phase_table1(ctx: Context) -> dict:
    """The paper's Table 1 on the card at ``benchmarks/table1.py``'s
    configuration, unreduced: each workload's three trials (seeds 0-2)
    through every system with ``simulate_batch`` (one launch of the
    baseline or the PFCS kernel each), PFCS's tables built by
    ``discover="kernel"`` (the flat mask and factorization kernels, each
    held against its plain version at every shape it launched at and
    timed by graph replay).  Every baseline trace's counters equal the
    port's scalar oracle, every PFCS trace's the oracle's recorded in
    ``TABLE1_PFCS`` (and the oracle run here on trial 0 of the workloads
    of ``TABLE1_PFCS_ORACLE``), and the seed-0 hit counts equal
    ``TABLE1_SEED0``.  Launches are counted from 0 over the whole run;
    each engine call's bound (``engine_bound``) is counted after it."""
    from repro_torch import kernels
    from repro_torch.core import (derive_table1_row, simulate_baseline,
                                  simulate_pfcs)

    systems = BASELINES + ("pfcs",)
    capture, engine_cap = Capture(), EngineCapture()
    report = {}
    try:
        kernels.reset_launch_counts()
        results = table1_runs(engine_cap)
        launches = kernels.launch_counts()
    finally:
        engine_cap.close()
        capture.close()
    for call in engine_cap.calls:
        call.update(engine_bound(call))

    for wname, (traces, tables, table_s, per) in results.items():
        accesses = sum(tr.length for tr in traces)
        oracle_s, rows = {}, {}
        for system in systems:
            stats, wall, call = per[system]
            t0 = time.perf_counter()
            if system == "pfcs":
                got = [pfcs_counters(st) for st in stats]
                if got != [(tuple(h), *r) for h, *r in
                           TABLE1_PFCS[wname][:len(stats)]]:
                    raise AssertionError(
                        f"table1 {wname} pfcs: counters {got} != the "
                        f"oracle's {TABLE1_PFCS[wname]}")
                want = ([simulate_pfcs(traces[0], TABLE1_CAPS)]
                        if wname in TABLE1_PFCS_ORACLE else [])
            else:
                want = [simulate_baseline(system, tr, TABLE1_CAPS)
                        for tr in traces]
            oracle_s[system] = time.perf_counter() - t0
            for w, st in zip(want, stats):
                if ((w.hits_per_level, w.misses, w.demand_accesses,
                     w.prefetches_issued, w.prefetches_used,
                     w.prefetches_true)
                        != (st.hits_per_level, st.misses,
                            st.demand_accesses, st.prefetches_issued,
                            st.prefetches_used, st.prefetches_true)):
                    raise AssertionError(f"table1 {wname} {system}: engine "
                                         f"!= scalar oracle")
            seed0 = TABLE1_SEED0.get(wname, {}).get(system)
            if seed0 and (stats[0].hits, stats[0].demand_accesses) != seed0:
                raise AssertionError(
                    f"table1 {wname} {system}: seed-0 hits "
                    f"{(stats[0].hits, stats[0].demand_accesses)} != {seed0}")
            longest = max(tr.length for tr in traces)
            rows[system] = {
                "hit_rate_mean": float(np.mean([s.hit_rate for s in stats])),
                "hit_rate_seed0": stats[0].hit_rate,
                "engine_wall_s": wall, "kernel_ms": call["ms"],
                # the latency of one serial step: the longest trace's
                "ns_per_step": call["ms"] * 1e6 / longest,
                "placement": call["placement"],
                "bound_ms": call["bound_ms"], "bound_by": call["bound_by"],
                "work": call["work"], "visits": call["visits"],
                "bytes": call["bytes"],
                "accesses_per_s_kernel": (accesses / (call["ms"] / 1e3)
                                          if call["ms"] else None),
                "accesses_per_s_wall": accesses / wall,
                "oracle_host_s": oracle_s[system] if want else None,
                "oracle_traces": len(want),
                "oracle_accesses_per_s": (sum(tr.length for tr in
                                              traces[:len(want)])
                                          / oracle_s[system]
                                          if want else None),
            }
        lru = per["lru"][0]
        for system in systems:
            trial_rows = [derive_table1_row(st, base)
                          for st, base in zip(per[system][0], lru)]
            rows[system]["table1_row_vs_lru"] = mean_rows(trial_rows)
        report[wname] = {"traces": len(traces), "accesses": accesses,
                         "n_keys": max(tr.n_keys for tr in traces),
                         "table_build_host_s": table_s, "systems": rows}
        emit({"phase": "table1_workload", "workload": wname,
              **report[wname]})

    engine_launches = {name: launches.get(name, 0) for name in ENGINE}
    if engine_launches != {"engine_baseline": len(BASELINES) * len(results),
                           "engine_pfcs": len(results)}:
        raise AssertionError(f"table1: engine launches {engine_launches}")
    ctx.engine_path = {
        name: {"launches": engine_launches[name],
               "path_ms": sum(c["ms"] for c in engine_cap.calls
                              if c["name"] == name),
               "path_bound_ms": sum(c["bound_ms"] for c in engine_cap.calls
                                    if c["name"] == name)}
        for name in ENGINE}
    flat = {k: v for k, v in launches.items() if k not in ENGINE}
    rows = check_path("table1", flat, capture.inputs,
                      required=["divisibility_mask", "factorize_squarefree"],
                      shape_launches=capture.launches)
    return {"launches": launches, "engine": ctx.engine_path,
            "flat_kernels_exact": [r["name"] for r in rows],
            # (each launch's dynamic shared bytes are in its placement)
            "engine_ptxas": {name: ptxas_lines(kernels.KERNELS[name])
                             for name in ENGINE}}


PHASES = [
    ("device", phase_device),
    ("build", phase_build),
    ("kernel_check", phase_kernel_check),
    ("serving_full", phase_serving_full),
    ("serving_smoke", phase_serving_smoke),
    ("batching", phase_batching),
    ("batching_full", phase_batching_full),
    ("launcher", phase_launcher),
    ("scale", phase_scale),
    ("scale_full_scan", phase_scale_full_scan),
    ("serving_wide", phase_serving_wide),
    ("launcher_wide", phase_launcher_wide),
    ("engine_check", phase_engine_check),
    ("table1", phase_table1),
]


def report(ctx: Context) -> None:
    """The table of the six TPU kernels, the card's label, the
    ``kernels`` line and the ``ok`` line."""
    emit({"tpu_kernels": [{"name": n, "replaces": repl,
                           "status": "ported" if src else "not yet",
                           "source": src} for n, repl, src in TPU_KERNELS]})
    ported = {n: (src, repl) for n, repl, src in TPU_KERNELS if src}
    rows = []
    for r, launches in ([(r, ctx.launches) for r in ctx.kernel_rows]
                        + [(r, ctx.scale_launches) for r in ctx.scale_rows]):
        rows.append({
            "name": r["name"], "route": "cuda",
            "source": ported[r["name"]][0], "replaces": ported[r["name"]][1],
            "launches": launches[r["name"]],
            "max_abs_err": r["max_abs_err"],
            "ms": r["graph_ms"], "graph_ms": r["graph_ms"], "wrapper_ms": r["wrapper_ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "launch_floor_ms": r["launch_floor_ms"]})
    for name, repl, src in ENGINE_KERNELS:
        chk, path = ctx.engine_check[name], ctx.engine_path[name]
        rows.append({
            "name": name, "route": "cuda", "source": src, "replaces": repl,
            "launches": path["launches"], "max_abs_err": 0,
            "ms": chk["ms"], "graph_ms": None, "wrapper_ms": None,
            "plain_ms": chk["plain_ms"], "bound_ms": chk["bound_ms"],
            "bound_by": chk["bound_by"], "library_ms": None,
            "launch_floor_ms": LAUNCH_FLOOR_MS, "shape": chk["shape"],
            "systems": chk["systems"], "path_ms": path["path_ms"],
            "path_bound_ms": path["path_bound_ms"]})
    print(ctx.smi or f"{ctx.kind}, power.limit not measured (nvidia-smi "
                     f"failed)", flush=True)
    emit({"kernels": rows})
    emit({"ok": True, "device": {"platform": "gpu", "kind": ctx.kind,
                                 "count": torch.cuda.device_count()}})


def table1_times(tree: str) -> dict:
    """``table1_runs`` twice with the port of ``tree`` (a directory
    holding a ``src/repro_torch``): each (workload, system)'s engine
    kernel ms, the least of its two launches (CUDA events around the
    launch; a process's first launch of a kernel also loads it), its
    seed-0 hits held to ``TABLE1_SEED0``."""
    src = os.path.realpath(os.path.join(tree, "src"))
    sys.path.insert(0, src)
    import repro_torch

    if not os.path.realpath(repro_torch.__file__).startswith(src + os.sep):
        raise RuntimeError(f"imported {repro_torch.__file__}, not {tree}'s")
    cap = EngineCapture()
    try:
        runs = [table1_runs(cap) for _ in range(2)]
    finally:
        cap.close()
    ms = {}
    for results in runs:
        for wname, (_, _, _, per) in results.items():
            for system, (stats, _, call) in per.items():
                if (stats[0].hits, stats[0].demand_accesses) != \
                        TABLE1_SEED0[wname][system]:
                    raise AssertionError(f"{tree}: {wname} {system} seed-0 "
                                         f"hits {stats[0].hits}")
                key = f"{wname}/{system}"
                ms[key] = min(ms.get(key, call["ms"]), call["ms"])
    return ms


def compare_engine(old: str, rounds: int) -> int:
    """The engine kernels of the port of ``old`` (a directory holding its
    ``src``, e.g. an older commit unpacked by ``git archive <commit> src``)
    against this tree's over Table 1, ``rounds`` times in turns (old, new,
    new, old: a drift of the card's clock falls on both), each run in a
    process of its own that builds its tree's kernels there.  Prints each
    run's kernel ms per (workload, system), then the card's name and power
    limit and the median of each tree's runs."""
    runs = {"old": [], "new": []}
    for _ in range(rounds):
        for label, tree in (("old", old), ("new", ROOT), ("new", ROOT),
                            ("old", old)):
            res = subprocess.run([sys.executable, os.path.abspath(__file__),
                                  "--table1-times", tree],
                                 capture_output=True, text=True, cwd=ROOT)
            if res.returncode:
                sys.stderr.write(res.stdout + res.stderr)
                return 1
            ms = json.loads(res.stdout.strip().splitlines()[-1])
            emit({"tree": label, "kernel_ms": ms})
            runs[label].append(ms)
    smi, _ = nvidia_smi()
    print(smi, flush=True)
    emit({"median_kernel_ms": {
        label: {k: float(np.median([r[k] for r in rs])) for k in rs[0]}
        for label, rs in runs.items()}})
    return 0


def main(argv=()) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="Smoke run of the port on "
                                             "one NVIDIA card.")
    ap.add_argument("--compare-engine", metavar="DIR",
                    help="instead: time the Table-1 engine kernels of the "
                         "port in DIR (holding its src) against this "
                         "tree's, in turns")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--table1-times", metavar="TREE", help=argparse.SUPPRESS)
    args = ap.parse_args(list(argv))
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA card", file=sys.stderr)
        return 2
    if args.table1_times:
        emit(table1_times(os.path.abspath(args.table1_times)))
        return 0
    if args.compare_engine:
        return compare_engine(os.path.abspath(args.compare_engine),
                              args.rounds)
    sys.path.insert(0, os.path.join(ROOT, "src"))
    phase = "start"
    t_start = time.perf_counter()
    ctx = Context()
    try:
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
    finally:
        if ctx.engine_builds:
            ctx.engine_builds.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
