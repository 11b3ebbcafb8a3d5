"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It puts ``<root>/src`` on ``sys.path`` itself, builds the port's six CUDA
kernels from ``src/repro_torch/kernels/csrc`` (``nvcc``, one process per
source, started together), and drives the port's serving path and its
wide (multi-limb) path on the card in phases, each printing one JSON line
with its seconds (the sharded runs also report where their wall time
went, ``sharded_time_split``):

  device         the card, the torch and CUDA versions, the interpreter,
                 the ``nvcc`` found, the build directory, and
                 ``nvidia-smi``'s name and power limit (``null`` with the
                 error when ``nvidia-smi`` is missing or fails: a missing
                 label is not a missing card);
  build          the six kernels and an empty one, with ``-Xptxas -v``'s
                 register, shared-memory and spill lines (for the
                 redesigned kernels, ``REDESIGNED``, under the name of
                 each template instance), and the launch floor: the
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
  launcher_wide  the launcher with ``--max-bits 1024``.

Then the table of the reference's six Pallas kernels, the card's name and
power limit, the ``kernels`` line (for the flat kernels: launches on the
``case_serving`` sharded run and times at that run's shapes; for the limb
kernels: the same from the ``scale`` run) and, last,
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
REDESIGNED = ("divisibility_mask", "factorize_squarefree", "gcd",
              "factorize_limbs")


def phase_build(ctx: Context) -> dict:
    global LAUNCH_FLOOR_MS
    from repro_torch import kernels

    if sorted(kernels.KERNELS) != sorted(PORTED):
        raise AssertionError(f"kernels {sorted(kernels.KERNELS)} != "
                             f"{sorted(PORTED)}")
    floor = launch_floor_kernel()
    nvcc_s = kernels.build_all(extra=[floor])
    dev = torch.device(DEVICE)
    LAUNCH_FLOOR_MS = graph_ms(lambda: floor.launch(dev, 1, 256))
    return {"nvcc_seconds": nvcc_s,
            "launch_floor_ms": LAUNCH_FLOOR_MS,
            "launch_floor": "empty kernel, 1 block of 256 threads, "
                            "csrc/launch_floor.cu through ctypes, graph "
                            "replay",
            "ptxas": {name: [ln.strip() for ln in
                             k.build_log().splitlines()
                             if "registers" in ln or "spill" in ln
                             or (name in REDESIGNED
                                 and "entry function" in ln)]
                      for name, k in kernels.KERNELS.items()}}


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
