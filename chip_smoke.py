"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It puts ``<root>/src`` on ``sys.path`` itself, builds the port's eight
CUDA kernels from ``src/repro_torch/kernels/csrc`` (``nvcc``, one process
per source, started together), and drives the port's serving path
(with its elastic cache, its MoE expert tier, its observability layer,
its multi-tenant QoS tier and its cross-tenant dedup), its models (the
transformers, zamba2, the xLSTM stack, the encoder-decoder), its wide
(multi-limb) path and its Table-1 trace engine on the card in phases,
each printing one JSON line with its seconds (the sharded and elastic
runs also report where their wall time went, ``sharded_time_split``):

  device         the card, the torch and CUDA versions, the interpreter,
                 the ``nvcc`` found, the build directory, the card's
                 ``total_memory`` beside ``launch/mesh.py``'s
                 ``HW.HBM_BYTES``, and
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
  batching_full  ``case_batching``'s full configuration with its 4000
                 requests cut to ``BATCHING_FULL_REQUESTS``,
                 ``kv="sharded"`` against ``kv="vec"``;
  launcher       ``repro_torch.launch.serve --null-model --kv sharded``,
                 each kernel held against its plain version on the
                 inputs that run gave it;
  elastic        ``repro_torch.cases.case_elastic``: its smoke
                 configuration against ``BENCH_case_elastic.json``, its
                 full one (192 requests, 64 slots, a 2 <-> 4 resize storm,
                 periodic kills and a deferred one; the case asserts that
                 tokens, counters, LRU order and prefetch log equal the
                 uninterrupted scalar oracle's) against ``ELASTIC_FULL``;
                 every refresh and recovery runs the flat mask, gcd and
                 factorization, each held against its plain version at
                 every shape and timed at the full run's; the recovery
                 latency and the refresh's time split;
  mesh           the sharded scan across ranks, each rank a process of
                 its own on this card with torchrun's environment
                 (``--mesh-rank``): an NCCL world of 1 (``case_serving``
                 full at 1 shard: the exchange's all-gathers on the card),
                 gloo worlds of 2 (``case_serving`` full, 2 shards; its
                 smoke configuration against ``BENCH_case_serving.json``)
                 and 4 (``case_elastic`` full, 2 <-> 4 shards, against
                 ``ELASTIC_FULL``; its smoke configuration against
                 ``BENCH_case_elastic.json``) sharing the card: every
                 rank's counters equal the one-card loop's, every refresh
                 on a mesh of one rank per shard; per rank
                 ``used_shard_map``, the exchange's backend, seconds and
                 bytes, and the launches;
  moe            ``repro_torch.cases.case_moe``: smoke against
                 ``BENCH_case_moe.json``, full (4096 experts, 1000 x 8
                 router sets, synthetic router) against ``MOE_FULL``, then
                 the full schedule through
                 ``VectorizedExpertCache(discover="kernel")``, equal to
                 the incremental run on counters and prefetch log, its
                 flat mask and factorization held against their plain
                 versions; and the real-router block (``case_moe``'s
                 ``kimi-k2-1t-a32b`` smoke model, 4 requests) on the card
                 and on the host's CPU on the same parameters: every
                 router choice (a differing one fails with the k-th
                 probability gap of both sides), ``PageStats``,
                 ``ExpertCacheStats`` and the prefetch log equal, no
                 false-positive prefetch (Theorem 1), no registry scan;
  model_check    the model zoo at full width and cut depth, float32, TF32
                 off: ``qwen2.5-3b`` (two layers; B 2, S 64)
                 ``train_logits``, ``prefill`` and a teacher-forced
                 ``decode_step`` on the card within 1e-3 of the same calls
                 on the host's CPU on the same parameters, decode within
                 2e-3 of train's next position; ``deepseek-v2-236b`` (one
                 dense and one MoE layer, MLA; B 2, S 32): prefill against
                 train within 2e-3, ``decode_step_router``'s (1, 2, 6)
                 distinct indices, the int8 latent cache within 8% after
                 12 teacher-forced steps; ``zamba2-7b`` (7 Mamba-2 layers,
                 one shared-block application; S 256), ``xlstm-1.3b`` (8
                 blocks, the eighth an sLSTM; S 64) and
                 ``seamless-m4t-large-v2`` (2 + 2 layers; S 64): train and
                 prefill logits, every cache tensor and the decode steps
                 (eight teacher-forced from ``init_cache`` for the
                 recurrent two, one from the prefill's cache for the
                 encoder-decoder) within 1e-3 of the host's CPU, decode
                 (and a recurrent prefill) within 2e-3 of train;
  model_serving  published models in bfloat16 through
                 ``ServingEngine(kv="sharded")``, 4 requests each of the
                 launcher's prompt recipe: ``qwen2.5-3b`` (36 layers), the
                 81-layer ``zamba2-7b``, the 48-block ``xlstm-1.3b`` and
                 the 24 + 24-layer ``seamless-m4t-large-v2``: every
                 request completes, every logit finite, every
                 ``PageStats`` counter but ``registry_scans`` equal to the
                 ``model=None`` run's, the flat kernels held against their
                 plain versions at every shape; parameters, peak memory,
                 init seconds, ms per prefill step and per tick,
                 tokens/s, the refresh's time split; qwen's bf16 against
                 float32 logits at two layers;
  launcher_model ``repro_torch.launch.serve --arch ARCH`` (its smoke
                 model) for qwen2.5-3b and the three families above: 16
                 requests complete, the reference launcher's keys;
  train_check    training, card against the host's CPU on the same
                 parameters: ``qwen2.5-3b`` at its published widths, two
                 layers, float32, TF32 off, a B 2 x S 64 batch of the
                 synthetic corpus: loss, ``ce``, ``grad_norm`` and every
                 gradient leaf within 1e-3 of the leaf's largest
                 magnitude; one AdamW, Adafactor and SGD-momentum update
                 each from the host's gradients within 1e-5;
                 ``accum_steps=2`` against 1 on the card;
  train_full     the published ``qwen2.5-3b`` (36 layers, bfloat16,
                 ``remat="full"``, AdamW) through ``init_train_state`` and
                 ``make_train_step``: 6 steps of B 4 x S 256 on the
                 launcher's schedule, every loss finite and the last two
                 below the first; ms per step (CUDA events), tokens/s and
                 the peak memory;
  launcher_train ``repro_torch.launch.train`` with
                 ``examples/train_lm.py``'s default arguments (the
                 ``qwen2.5-3b`` smoke model at d 512 and 8 layers, 120
                 steps) and ``--pfcs-data``: exit without error (its own
                 loss assert), the reference launcher's keys; the
                 checkpoint of step 60 restored (``verify=True``) and run
                 to step 120 gives the launcher's last loss and its final
                 train state bit for bit; a bfloat16 train state saved and
                 restored bit for bit;
  obs            the observability layer: ``SlotMachine`` and
                 ``SlotOracle`` on ``tests/test_obs.py``'s golden spec
                 with ``kv="sharded"`` and ``"elastic"``, event streams
                 identical to each other and to the plain versions' run
                 (``trace_diff``), the kernel ledger's calls equal to the
                 launch counters, placement unchanged by a zero-capacity
                 or a live tracer, and the launcher with ``--kv elastic
                 --trace`` (its export converted by ``tools/trace_view.py``);
  tenancy        ``repro_torch.cases.case_tenancy``: smoke against
                 ``BENCH_case_tenancy.json``, full (1 hot, 6 cold and 1
                 scanner tenants, 128 HBM pages, 64 slots; the case
                 asserts vec and scalar bit-exact per tenant, isolation,
                 quotas) against ``TENANCY_FULL``; the full traffic again
                 through ``kv="sharded"`` and ``"elastic"``: every tier,
                 counter, per-tenant counter, log and occupancy equal to
                 the vec run's, ``check_isolation`` green, the mask and
                 the gcd exchange held against their plain versions at
                 every shape (timed on the sharded run);
  dedup          ``repro_torch.cases.case_dedup``: smoke against
                 ``BENCH_case_dedup.json``, full (6 tenants x 10 requests
                 sharing two system prompts) against ``DEDUP_FULL``, its
                 admission probes' gcd and factorization held against
                 their plain versions and timed; the full trace through
                 ``SlotMachine`` with ``kv="sharded"`` and ``"elastic"``
                 and with ``kv="vec"`` at 128 bits (the probes take the
                 limb gcd and factorization): counters, tier log,
                 refcount state and every request's timings equal to the
                 narrow vec run's, isolation green, every kernel held
                 against its plain version at every shape;
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
                 each), through ``repro_torch.cases.run_table1``: every
                 engine system through ``simulate_batch`` on the card,
                 PFCS's tables from ``discover="kernel"``; its rows; every
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
                 template instance);
  dryrun         ``repro_torch.launch.dryrun`` on ``DRYRUN_CELLS``:
                 ``qwen2.5-3b`` x ``decode_32k`` and ``train_4k``,
                 ``zamba2-7b`` x ``prefill_32k`` on 16x16 (a fake group of
                 256 ranks), and ``qwen2.5-3b`` x ``decode_32k`` on
                 2x16x16 (512), each in a process of its own where
                 importing JAX or the reference raises, started together
                 by ``mesh`` (they need no card), overlapping every phase
                 after it, and waited for last:
                 each record (``status: "ok"``, the ``rules`` that fired)
                 on a line of its own.

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
``DIR`` (holding its ``src``, e.g. ``git archive <commit> src`` unpacked,
of a tree whose ``repro_torch.cases`` has ``run_table1``) against this
tree's, each tree in processes of its own, in turns (``compare_engine``).
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

#: ``benchmarks/table1.py``'s documented ``--trials 3`` (seeds 0-2); its
#: level capacities and workloads are ``repro_torch.cases.TABLE1_CAPS`` and
#: ``table1_workloads()``, which ``run_table1`` runs
TABLE1_TRIALS = 3
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
#: ``case_elastic``'s counters at its full configuration (192 requests, 64
#: slots, 128 HBM pages, page size 8, the 2 <-> 4 resize storm, periodic
#: kills and one deferred kill), from the reference's own case
#: (``tests/test_torch_cases.py`` holds them to it)
ELASTIC_FULL = dict(n_resizes=16, n_recoveries=13, moved_blocks=12_727,
                    migrated_bytes=101_816, full_rebuild_bytes=222_872,
                    refactorized=8_444, rows_rebuilt=9_027,
                    hbm_hit_rate=0.6666666666666666,
                    prefetch_hit_rate=0.6666666666666666)
#: ``case_moe``'s counters at its full configuration with the synthetic
#: router (4096 experts, 256 hot, 64 HBM slots, top-8, 1000 x 8 router
#: sets), from the reference's own case (``tests/test_torch_cases.py``)
#: ``case_tenancy``'s BENCH keys at its full configuration (1 hot, 6 cold
#: and 1 scanner tenants, 128 HBM pages, 64 slots), from the reference's
#: own case (``tests/test_torch_cases.py`` holds them to it)
TENANCY_FULL = {
    "completed": 112, "cross_tenant_prefetches": 0,
    "isolation_composites": 764, "registry_scans": 0,
    "protection": {"quota_hit": 0.8666666666666667, "shared_hit": 0.0},
    "quota": [44, 12, 12, 12, 12, 12, 12, 12],
    "tenant_evictions": [88, 1140, 1044, 1092, 1092, 1140, 1140, 1008],
    "tenant_hit_rate": [0.9388020833333334, 0.5, 0.5, 0.5, 0.5, 0.5, 0.5,
                        0.5572916666666666],
}
#: ``case_dedup``'s BENCH keys at its full configuration (6 tenants x 10
#: requests, two 64-token system prompts, 84 HBM pages), from the
#: reference's own case (``tests/test_torch_cases.py``)
DEDUP_FULL = {
    "completed": 60,
    "counters": {"cow_copies": 58, "dedup_hits": 896, "dedup_promotions": 32,
                 "evictions": 103, "hbm_hits": 1075, "host_hits": 0,
                 "misses": 60, "prefetch_hits": 117, "prefetches": 119,
                 "shared_prefix_pages": 896},
    "dedup_probes": 54, "dedup_state_refs": {},
    "hbm_pages_per_user_dedup": [12.0] * 6,
    "hbm_pages_per_user_nodedup": [14.0] * 6,
    "n_shared_composites": 88, "shared_occupancy": 4,
    "ttft_ticks": {"dedup": {"50": 45.5, "95": 74.05, "99": 77.41},
                   "nodedup": {"50": 286.0, "95": 507.84999999999997,
                               "99": 535.6899999999999}},
    "unique_pages": {"dedup": 207, "nodedup": 335},
}
MOE_FULL = {
    "pfcs_vec": dict(hbm_hit_rate=0.81759375, demand_misses=11_674,
                     prefetch_precision=1.0, registry_scans=0),
    "pfcs_scalar": dict(hbm_hit_rate=0.81759375, demand_misses=11_674,
                        prefetch_precision=1.0, registry_scans=64_000),
    "lru": dict(hbm_hit_rate=0.240203125, demand_misses=48_627,
                prefetch_precision=0.0, registry_scans=0),
    "engine_loadgen": dict(completed=96, expert_hit_rate=0.6848958333333334,
                           expert_misses=1_936,
                           prefetch_precision=0.1797877505722411,
                           registry_scans=0),
}
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

#: ``batching_full``'s request count: ``case_batching``'s full
#: configuration has 4000; its depth is cut to this many (the same
#: recipe, slots, HBM pages and prefill budget) so that the script, which
#: grew by the elastic, MoE and observability paths, stays inside its
#: time limit (the sharded run's refresh is host Python that grows with
#: the registry: 30.1 s at 4000 requests on the H100)
BATCHING_FULL_REQUESTS = 2000
#: ``model_check``'s cuts: float32, full width, two layers each (qwen2.5-3b
#: dense GQA: 0.78 B parameters, 3.1 GB; deepseek-v2-236b MLA with one
#: dense and one MoE layer: 5.36 B, 21.4 GB), batch and sequence, and the
#: int8 latent cache's teacher-forced steps (``tests/test_perf_variants.py``)
MODEL_CHECK = {
    "qwen2.5-3b": dict(n_layers=2, batch=2, seq=64),
    "deepseek-v2-236b": dict(n_layers=2, batch=2, seq=32, int8_steps=12),
}
#: ``model_check``'s recurrent and encoder-decoder families, float32 at
#: full width, each depth cut (``cut``: fields of the configuration, a
#: dict for a field of a nested one): ``zamba2-7b`` (d 3584, 112 SSM heads
#: in 2 groups, chunk 256) at 7 Mamba-2 layers, one shared-block
#: application, S 256 (the chunk must divide it); ``xlstm-1.3b`` (d 2048,
#: 4 heads) at 8 blocks, so that its sLSTM runs; ``seamless-m4t-large-v2``
#: (d 1024, vocab 256,206) at 2 + 2 layers.  ``steps``: the teacher-forced
#: decode steps from ``init_cache`` of a recurrent family (the encoder-
#: decoder decodes one step from its prefill's cache, as ``qwen_check``)
FAMILY_CHECK = {
    "zamba2-7b": dict(cut=dict(n_layers=7), batch=2, seq=256, steps=8),
    "xlstm-1.3b": dict(cut=dict(n_layers=8), batch=2, seq=64, steps=8),
    "seamless-m4t-large-v2": dict(
        cut=dict(encdec=dict(n_encoder_layers=2, n_decoder_layers=2)),
        batch=2, seq=64),
}
#: ``model_check``'s tolerances: card against the host's CPU on the same
#: float32 parameters, and decode / prefill against the train forward
#: (``tests/test_models.py``'s bound); the int8 cache's relative bound
#: (``tests/test_perf_variants.py``)
MODEL_TOL = 1e-3
MODEL_TRAIN_TOL = 2e-3
INT8_REL_BOUND = 0.08
#: ``model_serving``: published models in bfloat16 through
#: ``ServingEngine(kv="sharded")``, the launcher's prompt recipe (seed 0, a
#: shared prefix, then 4-11 tokens each): qwen2.5-3b (36 layers; 8
#: requests until the recurrent families came, now 4), then zamba2-7b
#: (81 Mamba-2 layers, 2 shared blocks), xlstm-1.3b (48 blocks) and
#: seamless-m4t-large-v2 (24 + 24 layers), each at its published depth
MODEL_SERVING = [
    dict(arch="qwen2.5-3b", requests=4, max_new=8, max_batch=4, max_seq=192,
         shared_prefix=32),
    dict(arch="zamba2-7b", requests=4, max_new=4, max_batch=4, max_seq=64,
         shared_prefix=8),
    dict(arch="xlstm-1.3b", requests=4, max_new=4, max_batch=4, max_seq=64,
         shared_prefix=8),
    dict(arch="seamless-m4t-large-v2", requests=4, max_new=4, max_batch=4,
         max_seq=64, shared_prefix=8),
]
#: ``launcher_model``'s archs: the launcher with ``--arch`` for each family
LAUNCHER_ARCHS = ("qwen2.5-3b", "zamba2-7b", "xlstm-1.3b",
                  "seamless-m4t-large-v2")
#: the keys of the reference launcher's output with a model (``front_end
#: == "engine"``), which ``launcher_model`` must print
LAUNCHER_ENGINE_KEYS = ("front_end", "kv", "completed", "decode_tokens",
                        "tok_per_s", "mean_ttft_s", "peak_concurrency",
                        "hbm_hit_rate", "prefetches", "prefetch_hits",
                        "shared_prefix_pages", "registry_scans")
#: ``train_check``: qwen2.5-3b at its published widths cut to two layers,
#: float32 (0.78 B parameters: 3.1 GB, as much again for the gradients
#: and twice that for AdamW's moments), a batch of the loader
#: (``ShardedLoader(SyntheticCorpus(vocab_size=259), 2, 64)``: every id
#: is a valid id of the full vocabulary), and the learning rate of the
#: three optimizer updates
TRAIN_CHECK = dict(arch="qwen2.5-3b", n_layers=2, batch=2, seq=64, lr=1e-3)
#: ``train_check``'s tolerances, relative to each leaf's largest
#: magnitude: the card's loss, metrics and gradients against the host's,
#: and an optimizer update on both from the host's gradients
TRAIN_TOL = 1e-3
TRAIN_UPDATE_TOL = 1e-5
#: ``train_full``: the published qwen2.5-3b (36 layers, bfloat16,
#: remat "full", AdamW) on the launcher's schedule (warmup 1 of 6 steps)
TRAIN_FULL = dict(arch="qwen2.5-3b", batch=4, seq=256, steps=6, lr=3e-4,
                  warmup=1)
#: ``examples/train_lm.py``'s default argument list (that script imports
#: the reference's launcher, so the list is written out here;
#: ``tests/test_torch_train_loop.py`` holds the two equal)
TRAIN_LM_ARGS = ("--arch", "qwen2.5-3b", "--smoke", "--d-model", "512",
                 "--n-layers", "8", "--steps", "120", "--batch", "4",
                 "--seq", "128", "--lr", "1e-3", "--ckpt-every", "60")
#: the reference training launcher's output keys
LAUNCHER_TRAIN_KEYS = ("first_loss", "last_loss", "steps", "wall_s",
                       "pfcs_shard_prefetches")
TRAIN_CKPT = os.path.join(ROOT, "build", "train_ckpt")
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
    run: the whole table rebuild (``refresh_s``; for the elastic cache its
    refresh and its shard recoveries, each counted once where one runs
    inside the other) and, within it, the calls that upload to the card,
    launch the kernels and read the results back (``kernel_calls_s``: the
    per-shard scan with its mask and gcd kernels, flat or limb, and the
    squarefree decode, also the recovery's; neither calls the other);
    outside the refresh, the same calls of a dedup admission probe (its
    batched gcd and decode, the names ``serving/kv_cache_vec.py`` calls:
    ``probe_calls_s``); and the kernel launches made inside either
    (``kernel_calls_launches``).  What remains of the refresh is host
    Python; what remains of the run is the tick loop and the probes."""

    def __init__(self):
        from repro_torch import kernels
        from repro_torch.core.engine import shard
        from repro_torch.kernels import ops
        from repro_torch.serving import kv_cache_vec
        from repro_torch.serving.elastic import ElasticShardedPagedKVCache
        from repro_torch.serving.kv_cache_sharded import ShardedPagedKVCache

        self.seconds = {"refresh_s": 0.0, "kernel_calls_s": 0.0,
                        "probe_calls_s": 0.0, "kernel_calls_launches": 0}
        self._launches = lambda: sum(kernels.launch_counts().values())
        self._depth = dict.fromkeys(self.seconds, 0)
        self._undo = []
        self._wrap(ShardedPagedKVCache, "refresh_tables", "refresh_s")
        self._wrap(ElasticShardedPagedKVCache, "refresh_tables", "refresh_s")
        self._wrap(ElasticShardedPagedKVCache, "recover_shard", "refresh_s")
        self._wrap(shard, "_scan_sharded", "kernel_calls_s")
        self._wrap(shard, "_scan_sharded_limbs", "kernel_calls_s")
        self._wrap(ops, "factorize_batch_exact", "kernel_calls_s")
        for name in ("gcd_batch", "gcd_batch_limbs", "factorize_batch_exact"):
            self._wrap(kv_cache_vec, name, "probe_calls_s")

    def _wrap(self, owner, name, key):
        orig = getattr(owner, name)

        def wrapped(*args, **kw):
            if self._depth[key]:               # inside a timed call already
                return orig(*args, **kw)
            self._depth[key] += 1
            n0, t0 = self._launches(), time.perf_counter()
            try:
                return orig(*args, **kw)
            finally:
                self._depth[key] -= 1
                self.seconds[key] += time.perf_counter() - t0
                if key != "refresh_s":
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
            "device_busy_upper_share": ((seconds["kernel_calls_s"]
                                         + seconds["probe_calls_s"]) / wall_s
                                        if inside == total else None),
            "device_ms_by_kernel": per_kernel,
            "device_busy_graph_est_s": est,
            "device_busy_graph_est_share": (None if est is None
                                            else est / wall_s)}


# --------------------------------------------------------------------------- #
# serving                                                                     #
# --------------------------------------------------------------------------- #

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
        self.serving_parity = None    # case_serving full, one-card loop
        self.dryrun = []              # the dry-run's processes, running


def phase_device(ctx: Context) -> dict:
    from repro_torch.kernels import cuda

    from repro_torch.launch.mesh import HW

    ctx.kind = torch.cuda.get_device_name(0)
    ctx.smi, smi_error = nvidia_smi()
    return {"kind": ctx.kind, "count": torch.cuda.device_count(),
            "total_memory": torch.cuda.get_device_properties(0).total_memory,
            "hw_hbm_bytes": HW.HBM_BYTES,
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
    from repro_torch.cases import serving_run

    (vec, ctx.serving_trail), (scalar, _) = (
        serving_run("vec", 4, smoke=False, device=DEVICE),
        serving_run("scalar", 4, smoke=False, device=DEVICE))
    full = {"vec": vec, "scalar": scalar}
    (full["sharded"], _), ctx.launches, cap, seconds = traced(
        serving_run, "sharded", 4, smoke=False, device=DEVICE)
    sh = full["sharded"]
    ctx.serving_parity = sh["parity"]
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
    """``repro_torch.cases.case_serving`` at its smoke configuration (its
    own asserts) against ``BENCH_case_serving.json``."""
    from repro_torch.cases import bench_payload, case_serving

    fresh = bench_payload("case_serving",
                          case_serving(smoke=True, device=DEVICE))
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
    from repro_torch.cases import batching_run

    (sharded, trail), launches, cap, seconds = traced(
        batching_run, arrivals, sizes, "slot_vec", kv="sharded",
        max_bits=max_bits, device=DEVICE)
    timed = ("wall_s", "tok_per_s")
    same = {k: v for k, v in sharded.items() if k not in timed} == \
        {k: v for k, v in vec.items() if k not in timed}
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
    """``repro_torch.cases.case_batching`` at its smoke configuration, by
    its pieces (the trace, the four engines, the case's asserts and its
    report) so that the ``slot_vec`` trail stays for the sharded run:
    against ``BENCH_case_batching.json``."""
    from repro_torch.cases import (BATCHING_CONFIGS, batching_report,
                                   batching_run, batching_trace,
                                   bench_payload, check_batching)

    arrivals, sizes = batching_trace(smoke=True)
    runs = {config: batching_run(arrivals, sizes, config, device=DEVICE)
            for config in BATCHING_CONFIGS}
    check_batching(runs)
    fresh = {config: rep for config, (rep, _) in runs.items()}
    failures = bench_failures(
        "BENCH_case_batching.json",
        bench_payload("case_batching", batching_report(fresh)))
    if failures:
        raise AssertionError("; ".join(failures))
    vec, vec_trail = runs["slot_vec"]
    ctx.batching = (arrivals, sizes, vec, vec_trail)
    return {"matches": "BENCH_case_batching.json",
            "requests": len(arrivals), **sizes,
            "peak_in_flight": vec["peak_in_flight"],
            "goodput_tok_per_tick": vec["goodput_tok_per_tick"],
            "wall_s": {c: r["wall_s"] for c, r in fresh.items()},
            **sharded_batching(arrivals, sizes, vec, vec_trail, "batching")}


def phase_batching_full(ctx: Context) -> dict:
    """``case_batching``'s full configuration (128 slots, 256 HBM pages,
    1024-token prefill budget), its 4000 requests cut to
    ``BATCHING_FULL_REQUESTS``.  It has no checked-in keys:
    ``kv="sharded"`` is held against ``kv="vec"`` on the same trace."""
    from repro_torch.cases import batching_run, batching_trace

    arrivals, sizes = batching_trace(smoke=False,
                                     n_requests=BATCHING_FULL_REQUESTS)
    vec, vec_trail = batching_run(arrivals, sizes, "slot_vec",
                                  device=DEVICE)
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
# elastic serving, the MoE expert tier, observability                         #
# --------------------------------------------------------------------------- #

def counter_failures(label: str, want: dict, got: dict) -> list:
    """The keys of ``want`` (nested one level at most) that ``got`` does
    not reproduce exactly."""
    bad = []
    for key, value in want.items():
        if isinstance(value, dict):
            bad += counter_failures(f"{label}.{key}", value, got.get(key, {}))
        elif got.get(key) != value:
            bad.append(f"{label}.{key}: {got.get(key)!r} != {value!r}")
    return bad


def phase_elastic(ctx: Context) -> dict:
    """``case_elastic`` on the card: its smoke configuration against
    ``BENCH_case_elastic.json``, then its full configuration (the case's
    own asserts: tokens, counters, LRU order, prefetch log and shard
    stats equal to the uninterrupted scalar oracle's, less migrated than
    a full rebuild) with its counters equal to ``ELASTIC_FULL``.  Every
    refresh and recovery runs the flat mask, gcd and factorization on the
    card; each is held against its plain version at every shape each run
    gave it, and timed at the full run's."""
    from repro_torch.cases import case_elastic

    smoke, s_launches, s_cap, _ = traced(case_elastic, smoke=True,
                                         device=DEVICE)
    failures = bench_failures("BENCH_case_elastic.json", smoke)
    if failures:
        raise AssertionError("; ".join(failures))
    check_path("elastic_smoke", s_launches, s_cap.inputs, timed=False,
               shape_launches=s_cap.launches)
    full, launches, cap, seconds = traced(case_elastic, smoke=False,
                                          device=DEVICE)
    bad = counter_failures("case_elastic", ELASTIC_FULL, full)
    if bad:
        raise AssertionError("; ".join(bad))
    rows = check_path("elastic", launches, cap.inputs,
                      shape_launches=cap.launches)
    return {"matches": ["BENCH_case_elastic.json", "ELASTIC_FULL"],
            "smoke_launches": s_launches, "launches": launches, **full,
            "sharded_time_split": time_split(full["wall_s_elastic"], seconds,
                                             launches, rows)}


# --------------------------------------------------------------------------- #
# sharding across ranks: the mesh exchange and the dry-run                    #
# --------------------------------------------------------------------------- #

#: the ``mesh`` phase's worlds: (name, backend, ranks), each rank a process
#: of its own on this one card (torchrun's environment, a ``file://``
#: rendezvous under ``build/``)
MESH_WORLDS = (("nccl1", "nccl", 1), ("serving2", "gloo", 2),
               ("wide2", "gloo", 2), ("elastic4", "gloo", 4))
MESH_TIMEOUT_S = 300
#: the ``dryrun`` phase's production cells (arch, shape, multi-pod): a
#: decode step on 16x16; a train step (every layer recomputed, its
#: products through the ``@`` rule); a Mamba-2 prefill (the einsum rule);
#: and a decode step on the multi-pod 2x16x16 mesh
DRYRUN_CELLS = (("qwen2.5-3b", "decode_32k", False),
                ("qwen2.5-3b", "train_4k", False),
                ("zamba2-7b", "prefill_32k", False),
                ("qwen2.5-3b", "decode_32k", True))
DRYRUN_TIMEOUT_S = 540
DRYRUN_OUT = os.path.join(ROOT, "build", "dryrun")


def mesh_required(kind: str) -> list:
    """The kernels every rank of a ``mesh`` world launches: the flat mask
    and gcd at 1 shard (it has no cross-shard composite to decode), the
    limb mask and gcd with the squarefree decode at 128 bits, else the
    flat mask, gcd and decode."""
    return {"nccl1": ["divisibility_mask", "gcd"],
            "wide2": WIDE_SHARDED}.get(kind, FLAT)


def trail_digest(trail) -> str:
    """A digest of a ``serving_run`` trail (parity counters, every touch's
    tier, the prefetch log), to compare a rank's with this process's."""
    import hashlib

    return hashlib.sha256(json.dumps(trail, sort_keys=True, default=str)
                          .encode()).hexdigest()


def mesh_rank(kind: str, store: str) -> dict:
    """One rank of a ``mesh`` world (``--mesh-rank``): start the group
    from torchrun's environment, drive the world's run with every launch
    counted from 0, every kernel input captured by shape and every
    refresh's exchange logged; then, with the counts read, hold each
    kernel the rank launched against its plain version on the card at
    every shape it launched at, and report."""
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import dataclasses

    import torch.distributed as dist

    from repro_torch import kernels
    from repro_torch.cases import (bench_payload, case_elastic,
                                   case_serving, serving_run)
    from repro_torch.launch.mesh import init_distributed
    from repro_torch.serving.elastic import ElasticShardedPagedKVCache
    from repro_torch.serving.kv_cache_sharded import ShardedPagedKVCache

    backend = {name: b for name, b, _ in MESH_WORLDS}[kind]
    dev = init_distributed(backend, device=DEVICE,
                           init_method=f"file://{store}")
    scans = []
    undo = []
    for cls in (ShardedPagedKVCache, ElasticShardedPagedKVCache):
        orig = cls.__dict__["refresh_tables"]

        def refresh(self, discover=None, _orig=orig):
            _orig(self, discover)
            if discover is None:
                scans.append(dataclasses.asdict(self.last_scan))
        setattr(cls, "refresh_tables", refresh)
        undo.append((cls, orig))
    out = {"rank": dist.get_rank(), "world": dist.get_world_size(),
           "backend": backend, "device": str(dev)}
    capture = Capture()
    try:
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        if kind in ("nccl1", "serving2", "wide2"):
            out["run"], trail = serving_run(
                "sharded", 4, smoke=False, n_shards=1 if kind == "nccl1"
                else 2, max_bits=128 if kind == "wide2" else 62, device=dev)
            out["trail_digest"] = trail_digest(trail)
        else:
            out["run"] = case_elastic(smoke=False, device=dev)
        if kind == "serving2":
            out["bench_failures"] = bench_failures(
                "BENCH_case_serving.json",
                bench_payload("case_serving",
                              case_serving(smoke=True, device=dev)))
        elif kind == "elastic4":
            out["bench_failures"] = bench_failures(
                "BENCH_case_elastic.json", case_elastic(smoke=True,
                                                       device=dev))
        torch.cuda.synchronize(dev)
        out["seconds"] = time.perf_counter() - t0
        out["launches"] = kernels.launch_counts()
        dist.barrier()
    finally:
        capture.close()
        for cls, orig in undo:
            setattr(cls, "refresh_tables", orig)
        dist.destroy_process_group()
    rows = check_path(f"mesh_{kind}_rank{out['rank']}", out["launches"],
                      capture.inputs, timed=False,
                      required=mesh_required(kind),
                      shape_launches=capture.launches)
    out["shapes_checked"] = _kernel_summary(rows)
    out["refreshes"] = len(scans)
    out["used_shard_map"] = sorted({s["used_shard_map"] for s in scans})
    out["exchange_backend"] = sorted({str(s["exchange_backend"])
                                      for s in scans})
    out["exchange_s"] = sum(s["exchange_s"] for s in scans)
    out["exchange_bytes"] = sum(s["exchange_bytes"] for s in scans)
    out["shards"] = sorted({s["n_shards"] for s in scans})
    return out


def run_world(kind: str, ranks: int) -> list:
    """The ranks of one ``mesh`` world, each ``chip_smoke.py --mesh-rank``
    in a process of its own with torchrun's environment; every process is
    waited for (killed past ``MESH_TIMEOUT_S``).  Returns each rank's
    report; a failed rank raises with its error output."""
    store = os.path.join(ROOT, "build", f"mesh_store_{kind}")
    os.makedirs(os.path.dirname(store), exist_ok=True)
    if os.path.exists(store):
        os.remove(store)
    procs = []
    for r in range(ranks):
        env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(ranks),
                   LOCAL_RANK=str(r), LOCAL_WORLD_SIZE=str(ranks))
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--mesh-rank", kind,
             "--mesh-store", store], env=env, cwd=ROOT,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    deadline = time.monotonic() + MESH_TIMEOUT_S
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(
                timeout=max(1.0, deadline - time.monotonic())))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    reports, failed = [], []
    for r, (p, (out, err)) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            failed.append(f"rank {r} exit {p.returncode}: {err[-2000:]}")
            continue
        reports.append(json.loads(out.strip().splitlines()[-1]))
    if failed:
        raise AssertionError(f"mesh world {kind}: " + " | ".join(failed))
    return reports


def phase_mesh(ctx: Context) -> dict:
    """The sharded scan across ranks on this card: an NCCL world of 1
    (``case_serving`` full at 1 shard: the exchange's all-gathers run on
    the card), gloo worlds of 2 (``case_serving`` full, ``kv="sharded"``,
    narrow, its smoke configuration against ``BENCH_case_serving.json``;
    and at ``max_bits`` 128, the limb kernels) and 4 (``case_elastic``
    full, 2 <-> 4 shards, against ``ELASTIC_FULL``; its smoke
    configuration against ``BENCH_case_elastic.json``), the ranks sharing
    the card (gloo stages the exchange through host memory).  Every
    rank's counters, and each serving world's tiers and prefetch log,
    equal the one-card runs'; every refresh ran on a mesh of one rank per
    shard; each rank launched its world's kernels (``mesh_required``) on
    the card and held every kernel it launched against its plain version
    at each shape it launched at (``shapes_checked``)."""
    ctx.dryrun = start_dryrun()     # host-only: they overlap what follows
    digest = trail_digest(ctx.serving_trail)
    out = {}
    for kind, backend, ranks in MESH_WORLDS:
        t0 = time.perf_counter()
        reps = run_world(kind, ranks)
        out[kind] = {
            "backend": backend, "ranks": ranks,
            "wall_s": time.perf_counter() - t0,
            "per_rank": [{k: rep[k] for k in (
                "rank", "device", "seconds", "refreshes", "shards",
                "used_shard_map", "exchange_backend", "exchange_s",
                "exchange_bytes", "launches", "shapes_checked")}
                for rep in reps]}
        emit({"phase": f"mesh_{kind}", **out[kind]})
        bad = []
        for rep in reps:
            label = f"{kind} rank {rep['rank']}"
            if kind == "elastic4":
                bad += counter_failures(label, ELASTIC_FULL, rep["run"])
            else:
                if rep["run"]["parity"] != list(ctx.serving_parity):
                    bad.append(f"{label}: parity {rep['run']['parity']} != "
                               f"the one-card loop's {ctx.serving_parity}")
                if rep["trail_digest"] != digest:
                    bad.append(f"{label}: tiers or prefetch log differ from "
                               f"the one-card run's")
            bad += [f"{label}: {f}" for f in rep.get("bench_failures", [])]
            if rep["used_shard_map"] != [True] or \
                    rep["exchange_backend"] != [backend]:
                bad.append(f"{label}: refreshes off the mesh "
                           f"({rep['used_shard_map']}, "
                           f"{rep['exchange_backend']})")
            if sorted(rep["shapes_checked"]) != sorted(
                    n for n, c in rep["launches"].items() if c):
                bad.append(f"{label}: kernels launched but not checked "
                           f"({rep['shapes_checked']})")
        if bad:
            raise AssertionError("; ".join(bad))
    out["matches"] = ["one-card case_serving runs", "ELASTIC_FULL",
                      "BENCH_case_serving.json", "BENCH_case_elastic.json"]
    return out


_DRYRUN = """
import sys
sys.modules["jax"] = sys.modules["repro"] = None      # importing either raises
sys.path.insert(0, sys.argv[1])
from repro_torch.launch import dryrun
sys.exit(dryrun.main(sys.argv[2:]))
"""


def _dryrun_log(arch: str, shape: str, multi: bool) -> str:
    return os.path.join(DRYRUN_OUT, f"{arch}__{shape}__{int(multi)}.log")


def start_dryrun() -> list:
    """``repro_torch.launch.dryrun`` on each of ``DRYRUN_CELLS`` (a fake
    group of 256 ranks for 16x16, 512 for 2x16x16), each in a process of
    its own where importing JAX or the reference raises, all started
    together, their output in ``DRYRUN_OUT``."""
    os.makedirs(DRYRUN_OUT, exist_ok=True)
    procs = []
    for arch, shape, multi in DRYRUN_CELLS:
        with open(_dryrun_log(arch, shape, multi), "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, "-c", _DRYRUN, os.path.join(ROOT, "src"),
                 "--arch", arch, "--shape", shape,
                 "--mesh", "multi" if multi else "single", "--force",
                 "--out", DRYRUN_OUT], cwd=ROOT, stdout=log,
                stderr=subprocess.STDOUT))
    return procs


def phase_dryrun(ctx: Context) -> dict:
    """The dry-runs the ``mesh`` phase started (``start_dryrun``), waited
    for: each cell's record, ``status: "ok"``, with the explicit sharding
    rules that fired (``rules``), printed on a line of its own."""
    from repro_torch.launch import dryrun

    t0 = time.perf_counter()
    procs, ctx.dryrun = ctx.dryrun, []
    rcs = []
    try:
        for proc in procs:
            left = DRYRUN_TIMEOUT_S - (time.perf_counter() - t0)
            rcs.append(proc.wait(timeout=max(left, 1.0)))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    waited_s = time.perf_counter() - t0
    cells = []
    for (arch, shape, multi), rc in zip(DRYRUN_CELLS, rcs):
        if rc != 0:
            with open(_dryrun_log(arch, shape, multi)) as f:
                raise AssertionError(f"dryrun {arch} {shape} multi={multi} "
                                     f"exit {rc}: {f.read()[-3000:]}")
        path = dryrun.artifact_path(dryrun.Path(DRYRUN_OUT), arch, shape,
                                    multi)
        with open(path) as f:
            rec = json.load(f)
        if rec.get("status") != "ok" or not rec.get("rules"):
            raise AssertionError(f"dryrun {path.name}: {rec.get('error')}")
        emit({"dryrun_record": {k: v for k, v in rec.items()
                                if k != "traceback"}})
        cells.append({"artifact": os.path.relpath(path, ROOT),
                      "status": rec["status"], "wall_s": rec["wall_s"],
                      "n_devices": rec["n_devices"],
                      "argument_bytes_per_rank":
                          rec["memory"]["argument_size_in_bytes"],
                      "collectives": rec["collectives"],
                      "rules": rec["rules"]})
    return {"waited_s": waited_s, "cells": cells}


def phase_moe(ctx: Context) -> dict:
    """``case_moe`` on the card: its smoke configuration against
    ``BENCH_case_moe.json``, its full configuration with the synthetic
    router against ``MOE_FULL``; then the full schedule through
    ``VectorizedExpertCache(discover="kernel")``, whose co-fire rows are
    rebuilt through the flat mask and factorization on the card at every
    registry change: its counters and prefetch log equal the
    ``discover="incremental"`` run's, and each kernel is held against its
    plain version at every shape it launched at; and the real-router
    block (``real_router_check``)."""
    from repro_torch.cases import (bench_payload, case_moe, moe_run,
                                   moe_schedule)
    from repro_torch.serving.expert_cache_vec import VectorizedExpertCache

    fresh = bench_payload("case_moe", case_moe(smoke=True, device=DEVICE))
    failures = bench_failures("BENCH_case_moe.json", fresh)
    if failures:
        raise AssertionError("; ".join(failures))
    full = case_moe(smoke=False, real_router=False, device=DEVICE)
    bad = counter_failures("case_moe", MOE_FULL, full)
    if bad:
        raise AssertionError("; ".join(bad))
    ms = moe_schedule(smoke=False)

    def cache(discover):
        return VectorizedExpertCache(ms.n_experts, hbm_slots=ms.slots,
                                     prefetch_budget=ms.topk - 1,
                                     discover=discover, device=DEVICE)

    incremental = moe_run(ms, cache("incremental"))
    kc = cache("kernel")
    kernel, launches, cap, seconds = traced(moe_run, ms, kc)
    for key in ("parity", "prefetch_log"):
        if kernel[key] != incremental[key]:
            raise AssertionError(f"discover='kernel' diverged from "
                                 f"'incremental': {key}")
    rows = check_path("moe", launches, cap.inputs,
                      required=["divisibility_mask", "factorize_squarefree"],
                      shape_launches=cap.launches)
    walls = {k: v["wall_s"] for k, v in full.items() if isinstance(v, dict)
             and "wall_s" in v}
    return {"matches": ["BENCH_case_moe.json", "MOE_FULL"],
            "real_router": real_router_check(),
            "full": {k: v for k, v in full.items() if k in MOE_FULL},
            "wall_s": walls, "kernel_discover": {
                "wall_s": kernel["wall_s"],
                "incremental_wall_s": incremental["wall_s"],
                "bulk_refreshes": kc.bulk_refreshes,
                "parity": list(kernel["parity"]),
                "prefetches_logged": len(kernel["prefetch_log"]),
                "launches": launches,
                "device_ms": {r["name"]: r.get("device_ms") for r in rows}}}


class RouterLog:
    """Records every ``apply_moe`` call of a run: the router's top-k
    indices and, per token, the gap between the k-th and the (k+1)-th
    largest router probability (how near the choice was to a tie)."""

    def __init__(self):
        from repro_torch.models import moe

        self.calls = []
        self._mod, self._orig = moe, moe.apply_moe

        def recording(x, p, cfg):
            out, aux = self._orig(x, p, cfg)
            k = cfg.moe.top_k
            probs = torch.softmax(torch.einsum(
                "td,de->te", x.reshape(-1, x.shape[-1]).float(),
                p["router"]), dim=-1)
            vals = torch.sort(probs, dim=-1, descending=True,
                              stable=True).values
            self.calls.append((aux["router_top_idx"].cpu(),
                               (vals[:, k - 1] - vals[:, k]).cpu()))
            return out, aux

        moe.apply_moe = recording

    def close(self):
        self._mod.apply_moe = self._orig


def params_copy(params, device):
    """A copy of a model's parameters on ``device``."""
    import copy

    return copy.deepcopy(params).to(device)


def router_failures(card: list, host: list) -> list:
    """The calls where the card's router chose other experts than the
    host's, each with both sides' gap at the k-th entry of the first
    token that differs (no tie is hidden: a differing choice fails)."""
    if len(card) != len(host):
        return [f"{len(card)} router calls on the card, {len(host)} on "
                f"the host"]
    bad = []
    for n, ((ic, gc), (ih, gh)) in enumerate(zip(card, host)):
        rows = (ic != ih).any(dim=-1).nonzero().flatten().tolist()
        if rows:
            r = rows[0]
            bad.append(f"call {n} token {r}: card {ic[r].tolist()} host "
                       f"{ih[r].tolist()}, k-th gap card {float(gc[r])!r} "
                       f"host {float(gh[r])!r}")
    return bad


def real_router_check() -> dict:
    """``case_moe``'s real-router block: the ``kimi-k2-1t-a32b`` smoke
    model (4 requests, ``max_batch=2``) on the card and on the host's CPU
    on the same parameters (initialized once on the card and copied):
    every router choice, ``PageStats``, ``ExpertCacheStats`` and the
    prefetch log equal; Theorem 1 (no false-positive prefetch) and no
    registry scan."""
    import dataclasses

    from repro_torch.cases import (MOE_REAL_ROUTER_ARCH,
                                   moe_real_router_engine,
                                   real_router_report)
    from repro_torch.configs import get_smoke
    from repro_torch.models import build_model

    cfg = get_smoke(MOE_REAL_ROUTER_ARCH)
    card = build_model(cfg, device=DEVICE)
    params = card.init_params(0)
    runs = {}
    for side, model, p, dev in (
            ("card", card, params, DEVICE),
            ("host", build_model(cfg, device="cpu"),
             params_copy(params, "cpu"), "cpu")):
        log = RouterLog()
        try:
            t0 = time.perf_counter()
            eng = moe_real_router_engine(model, p, dev)
            wall = time.perf_counter() - t0
        finally:
            log.close()
        runs[side] = (eng, log.calls, wall)
    (eng, calls, wall), (h_eng, h_calls, h_wall) = runs["card"], runs["host"]
    bad = router_failures(calls, h_calls)
    for name, a, b in (
            ("PageStats", dataclasses.asdict(eng.pages.stats),
             dataclasses.asdict(h_eng.pages.stats)),
            ("ExpertCacheStats", dataclasses.asdict(eng.experts.stats),
             dataclasses.asdict(h_eng.experts.stats)),
            ("prefetch_log", eng.experts.prefetch_log,
             h_eng.experts.prefetch_log)):
        if a != b:
            bad.append(f"{name}: card {a} host {b}")
    rep = real_router_report(cfg, eng)
    if rep["false_positive_prefetches"]:
        bad.append("Theorem 1 violated on live router traffic")
    if eng.experts.stats.registry_scans:
        bad.append("the real-router run scanned the registry")
    if bad:
        raise AssertionError("real router: " + "; ".join(bad))
    return {**rep, "router_calls": len(calls),
            "min_kth_gap": min(float(g.min()) for _, g in calls),
            "prefetches_logged": len(eng.experts.prefetch_log),
            "expert_stats": dataclasses.asdict(eng.experts.stats),
            "wall_s": wall, "host_wall_s": h_wall}


# --------------------------------------------------------------------------- #
# the model zoo                                                               #
# --------------------------------------------------------------------------- #

def cut_config(cfg, **cut):
    """``cfg`` with ``cut`` applied; a dict replaces fields of a nested
    configuration (``encdec=dict(n_decoder_layers=2)``)."""
    import dataclasses

    return cfg.replace(**{
        k: (dataclasses.replace(getattr(cfg, k), **v) if isinstance(v, dict)
            else v) for k, v in cut.items()})


def model_config(arch: str, **cut):
    """The published configuration of ``arch`` with ``cut`` applied (the
    CPU rehearsals replace this with small configurations)."""
    from repro_torch.configs import get_config

    return cut_config(get_config(arch), **cut)


def free_card() -> None:
    import gc

    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def rel_err(x: torch.Tensor, y: torch.Tensor) -> float:
    """max |x - y| / max |y|."""
    x, y = x.float().cpu(), y.float().cpu()
    return float((x - y).abs().max() / y.abs().max().clamp(min=1e-9))


def all_close(label: str, card: torch.Tensor, host: torch.Tensor,
              tol: float) -> float:
    """Raises unless ``card`` is within ``rtol = atol = tol`` of ``host``;
    returns the largest absolute difference."""
    card, host = card.float().cpu(), host.float().cpu()
    err = float((card - host).abs().max())
    if not torch.allclose(card, host, rtol=tol, atol=tol):
        raise AssertionError(f"{label}: max abs err {err} over rtol = atol "
                             f"= {tol}")
    return err


def grown_cache(model, cache: dict, batch: int, max_len: int) -> dict:
    """A prefill's cache copied into a decode cache of ``max_len`` rows."""
    big = model.init_cache(batch, max_len)
    for key, value in cache.items():
        if key == "len":
            big["len"] = value.clone()
        else:
            big[key][:, :, :value.shape[2]] = value
    return big


def qwen_check() -> dict:
    """qwen2.5-3b at full width, two layers, float32: ``train_logits``,
    ``prefill`` (logits and cache) and a teacher-forced ``decode_step``
    on the card against the same calls on the host's CPU on the same
    parameters (``MODEL_TOL``), and decode against the train forward's
    next position (``MODEL_TRAIN_TOL``)."""
    from repro_torch.models import build_model

    c = MODEL_CHECK["qwen2.5-3b"]
    cfg = model_config("qwen2.5-3b", n_layers=c["n_layers"],
                       dtype="float32")
    b, s = c["batch"], c["seq"]
    t0 = time.perf_counter()
    card = build_model(cfg, device=DEVICE)
    params = card.init_params(0)
    host = build_model(cfg, device="cpu")
    h_params = params_copy(params, "cpu")
    init_s = time.perf_counter() - t0
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (b, s)))
    out, times = {}, {}
    for side, model, p in (("card", card, params), ("host", host, h_params)):
        dev = model.device
        t0 = time.perf_counter()
        full = model.train_logits(p, {"tokens": toks.to(dev)})[0]
        last, cache = model.prefill(p, {"tokens": toks[:, :-1].to(dev)})
        cache = grown_cache(model, cache, b, s)
        step, _ = model.decode_step(p, {"tokens": toks[:, -1:].to(dev)},
                                    cache)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        times[side] = time.perf_counter() - t0
        out[side] = (full, last, cache, step)
    (full, last, cache, step), (h_full, h_last, h_cache, h_step) = (
        out["card"], out["host"])
    errs = {"train_logits": all_close("train_logits", full, h_full,
                                      MODEL_TOL),
            "prefill_logits": all_close("prefill", last, h_last, MODEL_TOL),
            "decode_logits": all_close("decode_step", step, h_step,
                                       MODEL_TOL)}
    for key in ("k", "v"):
        errs[f"cache_{key}"] = all_close(f"cache {key}", cache[key],
                                         h_cache[key], MODEL_TOL)
    errs["decode_vs_train"] = all_close("decode vs train", step[:, 0],
                                        full[:, -1], MODEL_TRAIN_TOL)
    n = sum(p.numel() for p in params.parameters())
    del card, params, host, h_params, out, full, cache, step
    free_card()
    return {"config": {"n_layers": cfg.n_layers, "d_model": cfg.d_model,
                       "heads": [cfg.n_heads, cfg.n_kv_heads],
                       "d_ff": cfg.d_ff, "vocab": cfg.vocab_size,
                       "batch": b, "seq": s},
            "params": n, "weight_gb": n * 4 / 1e9, "max_abs_err": errs,
            "init_s": init_s, "card_s": times["card"],
            "host_s": times["host"]}


def deepseek_check() -> dict:
    """deepseek-v2-236b at full width, two layers (one dense, one MoE:
    160 experts, top-6, 2 shared; MLA 512 / 1536), float32, on the card:
    ``prefill``'s last logits against ``train_logits``' last position
    (``MODEL_TRAIN_TOL``), ``decode_step_router``'s indices
    ``(1, B, 6)``, distinct per token and in range, and the int8 latent
    cache after teacher-forced steps within ``INT8_REL_BOUND`` of the
    float cache's logits."""
    from repro_torch.models import build_model

    c = MODEL_CHECK["deepseek-v2-236b"]
    cfg = model_config("deepseek-v2-236b", n_layers=c["n_layers"],
                       dtype="float32")
    b, s, steps = c["batch"], c["seq"], c["int8_steps"]
    t0 = time.perf_counter()
    model = build_model(cfg, device=DEVICE)
    params = model.init_params(0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, s))).to(
        model.device)
    t0 = time.perf_counter()
    full = model.train_logits(params, {"tokens": toks})[0]
    last, cache = model.prefill(params, {"tokens": toks})
    err = all_close("prefill vs train", last, full[:, -1], MODEL_TRAIN_TOL)
    cache = grown_cache(model, cache, b, s + 1)
    _, _, router = model.decode_step_router(
        params, {"tokens": toks[:, -1:]}, cache)
    k, e = cfg.moe.top_k, cfg.moe.n_experts
    n_moe = cfg.n_layers - cfg.moe.first_dense_layers
    r = router.cpu()
    if (tuple(r.shape) != (n_moe, b, k) or r.dtype != torch.int32
            or int(r.min()) < 0 or int(r.max()) >= e
            or any(len(set(row)) != k for row in r.reshape(-1, k).tolist())):
        raise AssertionError(f"decode_step_router: {r.dtype} {r.tolist()}")
    m8 = build_model(cfg.replace(kv_cache_dtype="int8"), device=DEVICE)
    ca, cb = model.init_cache(b, steps + 4), m8.init_cache(b, steps + 4)
    seq = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, steps))).to(
        model.device)
    for t in range(steps):
        la, ca = model.decode_step(params, {"tokens": seq[:, t:t + 1]}, ca)
        lb, cb = m8.decode_step(params, {"tokens": seq[:, t:t + 1]}, cb)
    rel = rel_err(lb, la)
    if not rel < INT8_REL_BOUND:
        raise AssertionError(f"int8 latent cache: relative error {rel}")
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    n = sum(p.numel() for p in params.parameters())
    del model, m8, params, full, cache, ca, cb
    free_card()
    return {"config": {"n_layers": cfg.n_layers, "d_model": cfg.d_model,
                       "experts": e, "top_k": k,
                       "shared": cfg.moe.n_shared_experts,
                       "mla": [cfg.mla.kv_lora_rank, cfg.mla.q_lora_rank],
                       "batch": b, "seq": s},
            "params": n, "weight_gb": n * 4 / 1e9,
            "prefill_vs_train_max_abs_err": err, "router": r.tolist(),
            "int8_steps": steps, "int8_rel_err": rel, "init_s": init_s,
            "run_s": run_s}


def model_inputs(cfg, b: int, s: int) -> dict:
    """A (b, s) batch of tokens from seed 0, with the audio family's frame
    features (``S_enc = s``)."""
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                                     (b, s)))}
    if cfg.family == "audio":
        batch["features"] = torch.from_numpy(rng.normal(
            size=(b, s, cfg.frontend.feature_dim)).astype(np.float32))
    return batch


def family_run(model, params, batch: dict, steps) -> dict:
    """``train_logits``, ``prefill`` and decode steps of one model on its
    device.  A recurrent family (``steps``) decodes that many teacher-
    forced steps from ``init_cache``, continuing train positions 0, 1,
    ...; the encoder-decoder prefills all but the last token (its cross
    K/V over every frame), grows the cache to the sequence and decodes
    the last one."""
    dev = model.device
    on = {k: v.to(dev) for k, v in batch.items()}
    b, s = on["tokens"].shape
    full = model.train_logits(params, on)[0]
    if steps is not None:
        last, cache = model.prefill(params, on)
        dec, positions = model.init_cache(b, steps), list(range(steps))
    else:
        last, cache = model.prefill(params, dict(on, tokens=on["tokens"][
            :, :-1]))
        dec, positions = grown_cache(model, cache, b, s), [s - 1]
    logits = []
    for t in positions:
        step, dec = model.decode_step(params, {"tokens": on["tokens"][
            :, t:t + 1]}, dec)
        logits.append(step[:, 0])
    return {"full": full, "last": last, "cache": cache, "steps": logits,
            "positions": positions, "decode_cache": dec}


def family_check(arch: str) -> dict:
    """One family of ``FAMILY_CHECK`` at full width and cut depth,
    float32: ``family_run`` on the card and on the host's CPU on the same
    parameters, each output (train and prefill logits, every tensor of
    the prefill's and of the last decode step's cache, each decode step's
    logits) within ``MODEL_TOL``; on the card, each decode step within
    ``MODEL_TRAIN_TOL`` of the train forward at its position, and a
    recurrent family's prefill logits of train's last position."""
    from repro_torch.models import build_model

    c = FAMILY_CHECK[arch]
    cfg = model_config(arch, dtype="float32", **c["cut"])
    b, s, steps = c["batch"], c["seq"], c.get("steps")
    t0 = time.perf_counter()
    card = build_model(cfg, device=DEVICE)
    params = card.init_params(0)
    host = build_model(cfg, device="cpu")
    h_params = params_copy(params, "cpu")
    init_s = time.perf_counter() - t0
    batch = model_inputs(cfg, b, s)
    runs, times = {}, {}
    for side, model, p in (("card", card, params), ("host", host, h_params)):
        t0 = time.perf_counter()
        runs[side] = family_run(model, p, batch, steps)
        if model.device.type == "cuda":
            torch.cuda.synchronize()
        times[side] = time.perf_counter() - t0
    got, want = runs["card"], runs["host"]
    errs = {"train_logits": all_close("train_logits", got["full"],
                                      want["full"], MODEL_TOL),
            "prefill_logits": all_close("prefill", got["last"], want["last"],
                                        MODEL_TOL)}
    for key in ("cache", "decode_cache"):
        for (path, x), (_, y) in zip(state_leaves(got[key]),
                                     state_leaves(want[key])):
            name = f"{key} {'/'.join(map(str, path))}"
            errs[name] = all_close(name, x, y, MODEL_TOL)
    errs["decode_logits"] = max(
        all_close(f"decode step {t}", x, y, MODEL_TOL)
        for t, x, y in zip(got["positions"], got["steps"], want["steps"]))
    errs["decode_vs_train"] = max(
        all_close(f"decode step {t} vs train", x, got["full"][:, t],
                  MODEL_TRAIN_TOL)
        for t, x in zip(got["positions"], got["steps"]))
    if steps is not None:
        errs["prefill_vs_train"] = all_close(
            "prefill vs train", got["last"], got["full"][:, -1],
            MODEL_TRAIN_TOL)
    n = sum(p.numel() for p in params.parameters())
    del card, params, host, h_params, runs, got, want
    free_card()
    return {"config": {"n_layers": cfg.n_layers, "d_model": cfg.d_model,
                       "heads": [cfg.n_heads, cfg.n_kv_heads],
                       "vocab": cfg.vocab_size, "cut": c["cut"],
                       "batch": b, "seq": s, "decode_steps": steps or 1},
            "params": n, "weight_gb": n * 4 / 1e9, "max_abs_err": errs,
            "init_s": init_s, "card_s": times["card"],
            "host_s": times["host"]}


def phase_model_check(ctx: Context) -> dict:
    """The model zoo at full width and cut depth in float32, TF32 off:
    ``qwen_check`` (card against the host's CPU), ``deepseek_check``
    (MLA, MoE routing, the int8 latent cache) and ``family_check`` for
    zamba2, xLSTM and the encoder-decoder; each model freed before the
    next."""
    if torch.backends.cuda.matmul.allow_tf32 is not False:
        raise AssertionError("TF32 matmuls are on: float32 checks need "
                             "them off")
    return {"allow_tf32": torch.backends.cuda.matmul.allow_tf32,
            "qwen2.5-3b": qwen_check(),
            "deepseek-v2-236b": deepseek_check(),
            **{arch: family_check(arch) for arch in FAMILY_CHECK}}


def launcher_prompts(vocab: int, n: int, shared_prefix: int) -> list:
    """``launch/serve.py``'s prompts: seed 0, a shared prefix, then 4-11
    tokens each."""
    rng = np.random.default_rng(0)
    shared = list(rng.integers(0, vocab, size=shared_prefix))
    return [[int(t) for t in shared + list(rng.integers(
        0, vocab, size=int(rng.integers(4, 12))))] for _ in range(n)]


class DecodeTimes:
    """Wall seconds of each decode step of a model engine, split into the
    single-slot prefill steps (``_step_slot``) and the engine ticks, each
    waited for; and whether every logit of every step was finite."""

    def __init__(self, eng):
        self.prefill, self.tick = [], []
        self.finite = True
        self._in_prefill = False
        decode, step_slot = eng._decode, eng._step_slot

        def timed(*args):
            t0 = time.perf_counter()
            out = decode(*args)
            self.finite &= bool(torch.isfinite(out[0]).all())
            (self.prefill if self._in_prefill else self.tick).append(
                time.perf_counter() - t0)
            return out

        def slot(*args):
            self._in_prefill = True
            try:
                return step_slot(*args)
            finally:
                self._in_prefill = False

        eng._decode, eng._step_slot = timed, slot

    def summary(self) -> dict:
        def ms(xs):
            return {"steps": len(xs),
                    "mean_ms": 1e3 * float(np.mean(xs)) if xs else None,
                    "median_ms": 1e3 * float(np.median(xs)) if xs else None}
        return {"prefill_steps": ms(self.prefill),
                "decode_ticks": ms(self.tick)}


def bf16_logit_error(cfg, n_layers: int = 2) -> float:
    """The bfloat16 model's logits against a float32 copy of the same
    weights, at ``n_layers`` layers: max |bf16 - f32| / max |f32| of a
    (2, 64) train forward (reported, not bounded)."""
    from repro_torch.models import build_model

    cut = cfg.replace(n_layers=n_layers)
    m16 = build_model(cut, device=DEVICE)
    p16 = m16.init_params(0)
    m32 = build_model(cut.replace(dtype="float32"), device=DEVICE)
    p32 = params_copy(p16, DEVICE).float()
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 64))).to(m16.device)
    rel = rel_err(m16.train_logits(p16, {"tokens": toks})[0],
                  m32.train_logits(p32, {"tokens": toks})[0])
    del m16, p16, m32, p32
    free_card()
    return rel


def serve_model(c: dict) -> dict:
    """One published model of ``MODEL_SERVING`` (bfloat16) served through
    ``ServingEngine(kv="sharded")``: every request completes with finite
    logits, every ``PageStats`` counter but ``registry_scans`` equals the
    ``model=None``, ``kv="vec"`` run of the same prompts, and each flat
    kernel the sharded refreshes launched is held against its plain
    version at every shape.  Reports the parameters, the card's peak
    memory, init seconds, decode ms (prefill steps and ticks apart),
    tokens/s and the refresh's time split."""
    import dataclasses

    from repro_torch.models import build_model, count_params_analytic
    from repro_torch.serving.engine import ServingEngine

    cfg = model_config(c["arch"])
    if torch.cuda.is_available():
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = build_model(cfg, device=DEVICE)
    params = model.init_params(0)
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n = sum(p.numel() for p in params.parameters())
    weight_bytes = sum(p.numel() * p.element_size()
                       for p in params.parameters())
    prompts = launcher_prompts(cfg.vocab_size, c["requests"],
                               c["shared_prefix"])
    kw = dict(max_batch=c["max_batch"], max_seq=c["max_seq"], device=DEVICE)
    eng = ServingEngine(model, params, kv="sharded", **kw)
    times = DecodeTimes(eng)

    def serve(engine):
        for prompt in prompts:
            engine.submit(prompt, max_new_tokens=c["max_new"])
        t0 = time.perf_counter()
        done = engine.run_until_idle()
        return done, time.perf_counter() - t0

    label = f"model serving {cfg.name}"
    (done, wall), launches, cap, seconds = traced(serve, eng)
    if (len(done) != c["requests"]
            or any(len(r.generated) != c["max_new"] for r in done)):
        raise AssertionError(f"{label}: {len(done)} of {c['requests']} "
                             f"requests completed")
    if not times.finite:
        raise AssertionError(f"{label}: a logit was not finite")
    null = ServingEngine(None, None, kv="vec", **kw)
    serve(null)
    stats = dataclasses.asdict(eng.pages.stats)
    stub = dataclasses.asdict(null.pages.stats)
    stats.pop("registry_scans"), stub.pop("registry_scans")
    if stats != stub:
        raise AssertionError(f"{label}'s page counters {stats} != the "
                             f"model=None run's {stub}")
    launched = [k for k in FLAT if launches.get(k)]
    if "divisibility_mask" not in launched:
        raise AssertionError(f"{label}: the sharded refresh launched no "
                             f"mask: {launches}")
    rows = check_path(f"model_serving_{c['arch']}", launches, cap.inputs,
                      timed=False, required=launched,
                      shape_launches=cap.launches)
    peak = (torch.cuda.max_memory_allocated() if torch.cuda.is_available()
            else None)
    tokens = sum(len(r.generated) for r in done)
    del eng, model, params, null
    free_card()
    return {"arch": cfg.name, "family": cfg.family,
            "n_layers": cfg.n_layers, "dtype": cfg.dtype,
            "params": n, "params_analytic": count_params_analytic(cfg),
            "weight_gb": weight_bytes / 1e9,
            "max_memory_allocated_gb": None if peak is None else peak / 1e9,
            "init_s": init_s, "requests": len(done), "tokens": tokens,
            "wall_s": wall, "tok_per_s": tokens / wall,
            **times.summary(), "page_stats": stats,
            "launches": launches,
            "shapes_checked": {r["name"]: r["shapes_checked"] for r in rows},
            "sharded_time_split": time_split(wall, seconds, launches, rows)}


def phase_model_serving(ctx: Context) -> dict:
    """Each model of ``MODEL_SERVING`` through ``serve_model``, freed
    before the next, and qwen2.5-3b's bfloat16 logits against float32 at
    two layers."""
    out = {c["arch"]: serve_model(c) for c in MODEL_SERVING}
    qwen = MODEL_SERVING[0]["arch"]
    out[qwen]["bf16_vs_f32_rel_err_2_layers"] = bf16_logit_error(
        model_config(qwen))
    return out


def phase_launcher_model(ctx: Context) -> dict:
    """``python -m repro_torch.launch.serve --arch ARCH`` for each of
    ``LAUNCHER_ARCHS``: the reference launcher's defaults with the arch's
    smoke model, on the card (the default device, named; called in this
    process, as the other launcher phases are): every request completes,
    and it prints the reference launcher's keys."""
    from repro_torch.launch import serve

    out = {}
    for arch in LAUNCHER_ARCHS:
        with contextlib.redirect_stdout(io.StringIO()):
            got = serve.main(["--arch", arch, "--device", DEVICE])
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        missing = [k for k in LAUNCHER_ENGINE_KEYS if k not in got]
        if missing or got["completed"] != 16 or got["front_end"] != "engine":
            raise AssertionError(f"launcher with --arch {arch}: {got}")
        out[arch] = got
    return out


def leaf_rel_err(card: torch.Tensor, host: torch.Tensor) -> float:
    """max |card - host| / max |host| of one leaf, computed on the card's
    side (NaN where either side has one at a place the other has not;
    places where both have one are left out)."""
    card = card.detach().float()
    host = host.detach().to(card.device).float()
    nan = torch.isnan(host)
    if not torch.equal(torch.isnan(card), nan):
        return float("nan")
    if host.numel() == 0:
        return 0.0
    diff = torch.where(nan, 0.0, card - host).abs().max()
    scale = torch.where(nan, 0.0, host).abs().max()
    return float(diff / scale.clamp(min=1e-30))


def tree_rel_errs(card, host) -> dict:
    """``leaf_rel_err`` of every leaf of two trees of the same structure,
    by path."""
    from repro_torch.training.tree import leaves_with_path, path_str

    got, want = list(leaves_with_path(card)), list(leaves_with_path(host))
    if [p for p, _ in got] != [p for p, _ in want]:
        raise AssertionError("the two trees differ in structure")
    return {path_str(p): leaf_rel_err(c, h)
            for (p, c), (_, h) in zip(got, want)}


def held(label: str, errs: dict, tol: float) -> float:
    """The largest of ``errs``; raises naming the worst leaf unless every
    one is within ``tol`` (a NaN fails)."""
    worst = max(errs, key=lambda k: (not errs[k] <= tol, errs[k]))
    if not errs[worst] <= tol:
        raise AssertionError(f"{label}: {worst} rel err {errs[worst]} over "
                             f"{tol}")
    return errs[worst]


def loader_batch(batch: int, seq: int, step: int = 0, **kw):
    """The tokens of ``step`` of the training loader on the synthetic
    corpus (vocabulary 259)."""
    from repro_torch.data.pipeline import ShardedLoader, SyntheticCorpus

    loader = ShardedLoader(SyntheticCorpus(vocab_size=259), batch, seq, **kw)
    return torch.from_numpy(loader.batch_at(step)["tokens"])


def phase_train_check(ctx: Context) -> dict:
    """``TRAIN_CHECK``: gradients and the three optimizers on the card
    against the host's CPU on the same float32 parameters (TF32 off)."""
    from repro_torch.models import build_model
    from repro_torch.training.optimizer import global_norm, make_optimizer
    from repro_torch.training.train_loop import loss_and_grads, make_loss_fn
    from repro_torch.training.tree import leaves, tree_map

    if torch.backends.cuda.matmul.allow_tf32 is not False:
        raise AssertionError("TF32 matmuls are on: float32 checks need "
                             "them off")
    c = TRAIN_CHECK
    cfg = model_config(c["arch"], n_layers=c["n_layers"], dtype="float32")
    if torch.cuda.is_available():
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    card = build_model(cfg, device=DEVICE)
    host = build_model(cfg, device="cpu")
    params = card.init_params(0).requires_grad_(True)
    h_params = params_copy(params, "cpu")
    toks = loader_batch(c["batch"], c["seq"])
    out, times = {}, {"init": time.perf_counter() - t0}
    for side, model, p in (("card", card, params), ("host", host, h_params)):
        t0 = time.perf_counter()
        loss, parts, grads = loss_and_grads(
            make_loss_fn(model), p, {"tokens": toks.to(model.device)})
        out[side] = (loss, parts["ce"], global_norm(grads), grads)
        if model.device.type == "cuda":
            torch.cuda.synchronize()
        times[side] = time.perf_counter() - t0
    t0 = time.perf_counter()
    (loss, ce, gnorm, grads), (h_loss, h_ce, h_gnorm, h_grads) = (
        out["card"], out["host"])
    errs = {"loss": leaf_rel_err(loss, h_loss), "ce": leaf_rel_err(ce, h_ce),
            "grad_norm": leaf_rel_err(gnorm, h_gnorm)}
    held("train_check metrics", errs, TRAIN_TOL)
    grad_err = held("train_check gradients", tree_rel_errs(grads, h_grads),
                    TRAIN_TOL)
    # two microbatches of one against the whole batch, on the card
    a_loss, _, a_grads = loss_and_grads(
        make_loss_fn(card), params, {"tokens": toks.to(card.device)},
        accum_steps=2)
    accum = {"loss": leaf_rel_err(a_loss, loss),
             "grads": held("accum_steps=2 against 1",
                           tree_rel_errs(a_grads, grads), TRAIN_TOL)}
    held("accum_steps=2 loss", {"loss": accum["loss"]}, TRAIN_TOL)
    del grads, a_grads, out
    times["compare_and_accum"] = time.perf_counter() - t0
    t_updates = time.perf_counter()
    updates = {}
    lr = torch.tensor(c["lr"], dtype=torch.float32)
    for name in ("adamw", "adafactor", "sgdm"):
        opt = make_optimizer(name, cfg)
        sides = []
        for model, p in ((card, params), (host, h_params)):
            q = params_copy(p, model.device)
            st = opt.init(q)
            g = tree_map(lambda x: x.to(model.device), h_grads)
            t0 = time.perf_counter()
            opt.update(g, q, st, lr.to(model.device))
            if model.device.type == "cuda":
                torch.cuda.synchronize()
            sides.append((q, st, time.perf_counter() - t0))
        (q, st, card_s), (h_q, h_st, host_s) = sides
        updates[name] = {
            "params": held(f"{name} update", tree_rel_errs(q, h_q),
                           TRAIN_UPDATE_TOL),
            "state": held(f"{name} state", tree_rel_errs(st, h_st),
                          TRAIN_UPDATE_TOL),
            "card_s": card_s, "host_s": host_s}
        del q, st, h_q, h_st, sides
    times["updates"] = time.perf_counter() - t_updates
    n = sum(t.numel() for t in leaves(params))
    peak = (torch.cuda.max_memory_allocated() / 1e9
            if torch.cuda.is_available() else None)
    del card, host, params, h_params, h_grads
    free_card()
    return {"config": {"n_layers": cfg.n_layers, "d_model": cfg.d_model,
                       "heads": [cfg.n_heads, cfg.n_kv_heads],
                       "d_ff": cfg.d_ff, "vocab": cfg.vocab_size,
                       "batch": c["batch"], "seq": c["seq"]},
            "allow_tf32": torch.backends.cuda.matmul.allow_tf32,
            "params": n, "loss": float(loss), "host_loss": float(h_loss),
            "rel_err": {**errs, "grads": grad_err}, "accum": accum,
            "updates": updates, "seconds_by_part": times,
            "peak_gb": peak}


class StepTimer:
    """CUDA events around each step on the card (the host's clock on the
    CPU): ms per step."""

    def __init__(self):
        self.cuda = torch.cuda.is_available() and DEVICE == "cuda"
        self.ms = []

    @contextlib.contextmanager
    def step(self):
        if self.cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            yield
            end.record()
            end.synchronize()
            self.ms.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            yield
            self.ms.append((time.perf_counter() - t0) * 1e3)


def phase_train_full(ctx: Context) -> dict:
    """``TRAIN_FULL``: the published qwen2.5-3b taking AdamW steps."""
    from repro_torch.models import build_model
    from repro_torch.training.train_loop import (init_train_state,
                                                 make_train_step)
    from repro_torch.training.tree import leaves

    c = TRAIN_FULL
    cfg = model_config(c["arch"])
    if torch.cuda.is_available():
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = build_model(cfg, device=DEVICE)
    state = init_train_state(model, 0)
    if DEVICE == "cuda":
        torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    state_gb = sum(t.numel() * t.element_size()
                   for t in leaves(state)) / 1e9
    step = make_train_step(model, lr=c["lr"], warmup=c["warmup"],
                           total_steps=c["steps"])
    timer = StepTimer()
    losses, gnorms, lrs = [], [], []
    for i in range(c["steps"]):
        batch = {"tokens": loader_batch(c["batch"], c["seq"], i).to(
            model.device)}
        with timer.step():
            state, m = step(state, batch)
        losses.append(float(m["loss"]))
        gnorms.append(float(m["grad_norm"]))
        lrs.append(float(m["lr"]))
    peak = (torch.cuda.max_memory_allocated() / 1e9
            if torch.cuda.is_available() else None)
    n = sum(t.numel() for t in leaves(state.params))
    del model, state
    free_card()
    if not all(np.isfinite(losses)):
        raise AssertionError(f"train_full: a loss is not finite: {losses}")
    if not np.mean(losses[-2:]) < losses[0]:
        raise AssertionError(f"train_full: the last two losses are not "
                             f"below the first: {losses}")
    ms = float(np.median(timer.ms[1:]))
    return {"config": {"n_layers": cfg.n_layers, "d_model": cfg.d_model,
                       "vocab": cfg.vocab_size, "dtype": cfg.dtype,
                       "remat": cfg.remat, "optimizer": cfg.optimizer,
                       **c},
            "params": n, "state_gb": state_gb, "init_s": init_s,
            "losses": losses, "grad_norms": gnorms, "lrs": lrs,
            "step_ms": timer.ms, "ms_per_step": ms,
            "tokens_per_s": c["batch"] * c["seq"] / (ms / 1e3),
            "peak_gb": peak}


def train_states_equal(a, b) -> bool:
    """Every leaf of two train states equal bit for bit."""
    from repro_torch.training.tree import leaves

    return all(x.dtype == y.dtype and torch.equal(
        x.detach().view(torch.int16) if x.dtype == torch.bfloat16 else x,
        y.detach().view(torch.int16) if y.dtype == torch.bfloat16 else y)
        for x, y in zip(leaves(a), leaves(b)))


def phase_launcher_train(ctx: Context) -> dict:
    """``python -m repro_torch.launch.train`` with ``TRAIN_LM_ARGS`` and
    ``--pfcs-data`` (called in this process, as the other launcher phases
    are), then its checkpoints: step 60 resumed to 120 against the
    launcher's end, and a bfloat16 state's round trip."""
    import json as _json
    import shutil

    from repro_torch.configs import get_smoke
    from repro_torch.launch import train
    from repro_torch.models import build_model
    from repro_torch.training.checkpoint import CheckpointManager
    from repro_torch.training.train_loop import (init_train_state,
                                                 make_train_step)

    shutil.rmtree(TRAIN_CKPT, ignore_errors=True)
    argv = list(TRAIN_LM_ARGS) + ["--pfcs-data", "--ckpt-dir", TRAIN_CKPT,
                                  "--device", DEVICE]
    t0 = time.perf_counter()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        got = train.main(argv)
    launcher_s = time.perf_counter() - t0
    printed = _json.loads(buf.getvalue().strip().splitlines()[-1])
    missing = [k for k in LAUNCHER_TRAIN_KEYS if k not in got]
    if missing or printed != got:
        raise AssertionError(f"launcher_train: {got} (missing {missing})")
    def arg(flag):
        return TRAIN_LM_ARGS[TRAIN_LM_ARGS.index(flag) + 1]

    steps, every = int(arg("--steps")), int(arg("--ckpt-every"))
    cfg = get_smoke(arg("--arch")).replace(
        d_model=int(arg("--d-model")), n_layers=int(arg("--n-layers")),
        vocab_size=259)
    mgr = CheckpointManager(os.path.join(TRAIN_CKPT, cfg.name))
    if mgr.all_steps() != [every, steps]:
        raise AssertionError(f"launcher_train: checkpoints {mgr.all_steps()}")
    model = build_model(cfg, device=DEVICE)
    step_fn = make_train_step(model, lr=float(arg("--lr")),
                              total_steps=steps, warmup=max(1, steps // 10))
    t0 = time.perf_counter()
    state = mgr.restore(init_train_state(model, 1), step=every, verify=True)
    for i in range(every, steps):
        batch = {"tokens": loader_batch(int(arg("--batch")),
                                        int(arg("--seq")), i).to(
                                            model.device)}
        state, m = step_fn(state, batch)
    resumed_loss = float(m["loss"])
    end = mgr.restore(init_train_state(model, 2), step=steps, verify=True)
    resume_s = time.perf_counter() - t0
    if resumed_loss != got["last_loss"] or not train_states_equal(state,
                                                                  end):
        raise AssertionError(
            f"launcher_train: resumed from step {every}, last loss "
            f"{resumed_loss} against {got['last_loss']}, states equal "
            f"{train_states_equal(state, end)}")
    # a bfloat16 train state (after one step: moments and parameters
    # moved) saved and restored into another one
    m16 = build_model(cfg.replace(dtype="bfloat16"), device=DEVICE)
    s16 = init_train_state(m16, 3)
    make_train_step(m16, lr=1e-3, warmup=0, total_steps=10)(
        s16, {"tokens": loader_batch(4, 128).to(m16.device)})
    mgr16 = CheckpointManager(os.path.join(TRAIN_CKPT, "bfloat16"))
    mgr16.save(1, s16)
    other = mgr16.restore(init_train_state(m16, 4), verify=True)
    with open(os.path.join(TRAIN_CKPT, "bfloat16", "step_00000001",
                           "manifest.json")) as f:
        dtypes = sorted({v["dtype"] for v in
                         _json.load(f)["leaves"].values()})
    if not train_states_equal(s16, other) or "bfloat16" not in dtypes:
        raise AssertionError(f"launcher_train: the bfloat16 state did not "
                             f"round-trip ({dtypes})")
    del model, state, end, m16, s16, other
    free_card()
    return {"launcher": got, "launcher_s": launcher_s, "resumed_from": every,
            "resumed_loss": resumed_loss, "resume_s": resume_s,
            "bf16_manifest_dtypes": dtypes,
            "deterministic_algorithms":
                torch.are_deterministic_algorithms_enabled()}


#: ``tests/test_obs.py``'s golden arrival spec (seed 5, 10 requests at
#: rate 1.2, prompts under 16 tokens from a shared pool of 8, up to 5 new
#: tokens) and its inertness sweep's (seed 11, 18 requests)
GOLDEN_SPEC = dict(seed=5, n_requests=10, rate=1.2, burst_frac=0.0,
                   silence_ticks=0, min_prompt=1, max_prompt=16, max_new=6,
                   shared_pool=8, key_space=200)
SWEEP_SPEC = dict(seed=11, n_requests=18, rate=1.6, burst_frac=0.2,
                  silence_ticks=0, min_prompt=1, max_prompt=22, max_new=8,
                  shared_pool=12, key_space=200)
#: ``tests/test_obs.py``'s slot-machine configuration
OBS_CFG = dict(max_batch=4, page_size=4, hbm_pages=24, prefetch_budget=2,
               reread_window=2, prefill_tokens=12, preempt_wait=3)
#: where the ``obs`` phase's launcher writes its ``--trace`` export
#: (``build/`` is gitignored)
OBS_TRACE = os.path.join(ROOT, "build", "obs_trace.json")


def spec_arrivals(spec: dict) -> list:
    """``tests/strategies.py::build_poisson_arrivals`` for one tenant:
    ``(tick, prompt, max_new)`` (``tests/test_torch_imports.py`` holds
    the two equal)."""
    from repro_torch.serving.slots import poisson_arrival_ticks

    rng = np.random.default_rng(spec["seed"])
    ticks = poisson_arrival_ticks(spec["n_requests"], rate=spec["rate"],
                                  seed=spec["seed"],
                                  burst_frac=spec["burst_frac"],
                                  silence_ticks=spec["silence_ticks"])
    shared = list(rng.integers(0, spec["key_space"],
                               size=spec["shared_pool"]))
    lo = max(1, spec["min_prompt"])
    hi = max(lo + 1, spec["max_prompt"])
    out = []
    for t in ticks:
        n = int(rng.integers(lo, hi))
        pfx = int(rng.integers(0, min(spec["shared_pool"], n) + 1))
        tail = [int(x) for x in rng.integers(0, spec["key_space"],
                                             size=n - pfx)]
        out.append((int(t), tuple(int(x) for x in shared[:pfx]) + tuple(tail),
                    int(rng.integers(1, max(2, spec["max_new"])))))
    return out


def drive_slots(cls: str, kv: str, arrivals, ob, device=None):
    """One slot engine of ``tests/test_obs.py``'s configuration over the
    arrivals, to idle."""
    from repro_torch.serving import slots

    eng = getattr(slots, cls)(kv=kv, obs=ob, device=device or DEVICE,
                              **OBS_CFG)
    for t, prompt, new in arrivals:
        eng.submit(list(prompt), max_new_tokens=new, arrival=t)
    eng.run_until_idle(max_ticks=100_000)
    return eng


def placement(eng) -> tuple:
    """What the inertness contract holds fixed: counters, tiers, the LRU
    order, the host set, the prefetch log, every request's tokens and
    tick timings."""
    from repro_torch.serving.kv_cache import PARITY_COUNTERS

    return (tuple(getattr(eng.pages.stats, f) for f in PARITY_COUNTERS),
            tuple(eng.tier_log), tuple(eng.pages.hbm.items()),
            frozenset(eng.pages.host), tuple(eng.pages.prefetch_log),
            tuple(tuple(r.generated) for r in eng.requests),
            tuple((r.first_tick, r.done_tick, r.preemptions)
                  for r in eng.requests))


def ledger_failures(ledger: dict, launches: dict, n_shards: int) -> list:
    """Where the kernel ledger's calls disagree with the launch counters:
    each wrapper launches its kernel once a call, the gcd exchange the
    mask and the gcd once a shard."""
    calls = {k: v["calls"] for k, v in ledger.items()}
    exch = n_shards * calls.get("sharded_gcd_exchange", 0)
    want = {"divisibility_mask": calls.get("divisibility_scan", 0) + exch,
            "gcd": calls.get("gcd_batch", 0) + exch,
            "factorize_squarefree": calls.get("factorize_batch", 0)}
    return [f"{k}: {launches.get(k, 0)} launches, ledger {v}"
            for k, v in want.items() if launches.get(k, 0) != v]


def phase_obs(ctx: Context) -> dict:
    """The observability layer on the card: ``SlotMachine`` and
    ``SlotOracle`` on ``tests/test_obs.py``'s golden spec with
    ``kv="sharded"`` and ``kv="elastic"`` give event streams that
    ``trace_diff`` finds identical to each other and to the same run with
    the plain versions; placement is the same with ``obs=None``, a
    zero-capacity tracer and a live tracer; the kernel ledger's calls
    equal the launch counters over the golden runs (and an elastic
    shard's loss and recovery); the launcher runs with ``--kv elastic
    --trace`` and ``tools/trace_view.py`` converts its export."""
    from repro_torch.obs import Observability, profile, trace_diff

    golden, sweep = spec_arrivals(GOLDEN_SPEC), spec_arrivals(SWEEP_SPEC)

    def golden_runs():
        streams = {}
        with profile.profiling():
            for kv in ("sharded", "elastic"):
                for cls in ("SlotMachine", "SlotOracle"):
                    streams[kv, cls] = Observability(trace_capacity=8192)
                    drive_slots(cls, kv, golden, streams[kv, cls])
            # an elastic shard's loss and recovery (its decode)
            drive_slots("SlotMachine", "elastic", golden, None).fail_shard(0)
            return streams, profile.summary()

    (streams, ledger), launches, cap, _ = traced(golden_runs)
    bad = ledger_failures(ledger, launches, n_shards=2)
    if bad:
        raise AssertionError("kernel ledger != launch counters: "
                             + "; ".join(bad))
    rows = check_path("obs_golden", launches, cap.inputs, timed=False,
                      shape_launches=cap.launches)
    events, inert = {}, {}
    for kv in ("sharded", "elastic"):
        plain = Observability(trace_capacity=8192)
        drive_slots("SlotMachine", kv, golden, plain, device="cpu")
        card = streams[kv, "SlotMachine"].trace
        for other, trace in (("SlotOracle", streams[kv, "SlotOracle"].trace),
                             ("the plain versions' run", plain.trace)):
            diff = trace_diff(card, trace)
            if diff is not None:
                raise AssertionError(f"{kv}: SlotMachine and {other} event "
                                     f"streams differ at {diff}")
        events[kv] = card.total
    for kv in ("sharded", "elastic"):
        for cls in ("SlotMachine", "SlotOracle"):
            runs = [placement(drive_slots(cls, kv, sweep, ob)) for ob in (
                None, Observability(trace_capacity=0, telemetry=False),
                Observability(trace_capacity=4096))]
            if not runs[0] == runs[1] == runs[2]:
                raise AssertionError(f"tracing changed {cls} {kv}'s "
                                     f"placement")
            inert[f"{cls}/{kv}"] = "identical"
    path = OBS_TRACE
    os.makedirs(os.path.dirname(path), exist_ok=True)
    # the later --kv overrides run_launcher's --kv sharded
    launcher = phase_launcher(ctx, ("--kv", "elastic", "--trace", path),
                              "launcher_elastic")
    with open(path) as f:
        payload = json.load(f)
    spec = importlib.util.spec_from_file_location(
        "trace_view", os.path.join(ROOT, "tools", "trace_view.py"))
    trace_view = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(trace_view)
    chrome = trace_view.convert(payload)
    phases = sorted({e["ph"] for e in chrome["traceEvents"]})
    if not {"i", "C", "X", "M"} <= set(phases):
        raise AssertionError(f"trace_view gave phases {phases}")
    if "sharded_gcd_exchange" not in payload["kernel_launches"]:
        raise AssertionError("the launcher's ledger has no gcd exchange")
    return {"golden_events": events, "twins_identical": ["sharded",
                                                         "elastic"],
            "inert": inert, "ledger": ledger, "launches": launches,
            "shapes_checked": {r["name"]: r["shapes_checked"] for r in rows},
            "launcher": {k: launcher[k] for k in ("completed", "launches",
                                                  "trace_events")},
            "trace_view_events": len(chrome["traceEvents"]),
            "trace_view_phases": phases}


# --------------------------------------------------------------------------- #
# multi-tenant QoS and cross-tenant dedup                                     #
# --------------------------------------------------------------------------- #

#: the kernels the tenanted sharded and elastic refreshes launch: the scan
#: and the gcd exchange.  ``case_tenancy``'s tenant stripes fall inside the
#: shard stripes (each of its 4 or 8 tenants' blocks lies in one of the two
#: shards), so no chain edge crosses shards, every exchanged gcd is 1 and
#: nothing is left to factorize
TENANCY_SHARDED = ["divisibility_mask", "gcd"]


def _kernel_summary(rows: list) -> dict:
    """The distinct shapes and dtypes each kernel was checked at."""
    return {r["name"]: r["shapes_checked"] for r in rows}


def phase_tenancy(ctx: Context) -> dict:
    """``case_tenancy`` on the card: its smoke configuration against
    ``BENCH_case_tenancy.json``, its full one (the case's own asserts:
    vec and scalar bit-exact globally and per tenant, no cross-tenant
    prefetch, occupancy within quota, isolation) against
    ``TENANCY_FULL``; then the full traffic through ``kv="sharded"`` and
    ``kv="elastic"`` (two shards), whose every registry refresh rebuilds
    the successor table through the flat mask and the gcd exchange
    (``TENANCY_SHARDED``):
    counters, per-tenant counters, every touch's tier, the prefetch log,
    the per-tenant logs and the occupancy equal the vec run's,
    ``check_isolation`` holds over the final registry, and each kernel is
    held against its plain version at every shape it launched at (timed
    on the sharded run)."""
    from repro_torch.cases import (TENANCY_TRAIL, bench_payload,
                                   case_tenancy, check_tenancy, tenancy_run)

    smoke, s_launches, s_cap, _ = traced(case_tenancy, smoke=True,
                                         device=DEVICE)
    failures = bench_failures("BENCH_case_tenancy.json",
                              bench_payload("case_tenancy", smoke))
    if failures:
        raise AssertionError("; ".join(failures))
    check_path("tenancy_smoke", s_launches, s_cap.inputs, timed=False,
               required=(), shape_launches=s_cap.launches)
    vec = tenancy_run("vec", smoke=False, device=DEVICE)
    trail = {k: vec[k] for k in TENANCY_TRAIL}
    scalar = tenancy_run("scalar", smoke=False, device=DEVICE)
    walls = {"vec": vec["wall_s"], "scalar": scalar["wall_s"]}
    full = check_tenancy({"pfcs_vec": vec, "pfcs_scalar": scalar},
                         smoke=False, device=DEVICE)
    payload = bench_payload("case_tenancy", full)
    bad = counter_failures("case_tenancy", TENANCY_FULL, payload)
    if bad:
        raise AssertionError("; ".join(bad))
    out = {"matches": ["BENCH_case_tenancy.json", "TENANCY_FULL"],
           "smoke_launches": s_launches, "full": payload,
           "fairness_ratio": full["fairness_ratio"]}
    for kv in ("sharded", "elastic"):
        run, launches, cap, seconds = traced(tenancy_run, kv, smoke=False,
                                             device=DEVICE)
        walls[kv] = run["wall_s"]
        diff = [k for k in TENANCY_TRAIL if run[k] != trail[k]]
        if diff:
            raise AssertionError(f"tenancy kv={kv!r} diverged from kv='vec': "
                                 f"{diff}")
        pages = run["_pages"]
        rep = pages.namespace.check_isolation(pages.registry)
        if (not rep.ok or run["cross_tenant_prefetches"]
                or not run["occupancy_ok"]):
            raise AssertionError(f"tenancy kv={kv!r}: isolation or quota "
                                 f"broken: {rep.violations[:4]}")
        rows = check_path(f"tenancy_{kv}", launches, cap.inputs,
                          timed=kv == "sharded", required=TENANCY_SHARDED,
                          shape_launches=cap.launches)
        out[kv] = {"launches": launches,
                   "shapes_checked": _kernel_summary(rows),
                   "bulk_refreshes": pages.bulk_refreshes,
                   "isolation_composites": rep.n_composites,
                   "time_split": time_split(run["wall_s"], seconds,
                                            launches, rows)}
    out["wall_s"] = walls
    return out


def phase_dedup(ctx: Context) -> dict:
    """``case_dedup`` on the card: its smoke configuration against
    ``BENCH_case_dedup.json``; its full one (the case's asserts: the
    dedup slot machine bit-exact against the scalar oracle on
    ``DEDUP_COUNTERS``, tier log and refcount state, isolation green with
    shared composites, dedup lowering HBM pages per user and the median
    TTFT) against ``DEDUP_FULL``.  Every admission with a live
    co-referencing request probes ``shared_prefix`` (the gcd and the
    squarefree factorization on the card).  Then the full trace through
    ``SlotMachine`` with ``kv="sharded"`` and ``"elastic"`` (their refreshes
    launch the flat mask too) and with ``kv="vec"`` at ``max_bits`` 128
    (its probes launch the limb gcd): counters, tier log, refcount state
    and every request's timings equal the narrow vec run's, isolation
    green; each kernel held against its plain version at every shape
    (timed but on the elastic run)."""
    from repro_torch.cases import (bench_payload, case_dedup, check_dedup,
                                   dedup_run, dedup_trace)

    smoke, s_launches, s_cap, _ = traced(case_dedup, smoke=True,
                                         device=DEVICE)
    failures = bench_failures("BENCH_case_dedup.json",
                              bench_payload("case_dedup", smoke))
    if failures:
        raise AssertionError("; ".join(failures))
    check_path("dedup_smoke", s_launches, s_cap.inputs, timed=False,
               required=["gcd", "factorize_squarefree"],
               shape_launches=s_cap.launches)
    tr = dedup_trace(smoke=False)
    keys = ("counters", "tier_log", "dedup_state", "timings")

    def full_runs():
        return {"dedup_vec": dedup_run(tr, "SlotMachine", "vec", True,
                                       device=DEVICE),
                "dedup_scalar": dedup_run(tr, "SlotOracle", "scalar", True,
                                          device=DEVICE),
                "nodedup_vec": dedup_run(tr, "SlotMachine", "vec", False,
                                         device=DEVICE)}

    res, launches, cap, seconds = traced(full_runs)
    trail = {k: res["dedup_vec"][k] for k in keys}
    walls = {k: r["wall_s"] for k, r in res.items()}
    full = check_dedup(res, tr, smoke=False)
    payload = bench_payload("case_dedup", full)
    bad = counter_failures("case_dedup", DEDUP_FULL, payload)
    if bad:
        raise AssertionError("; ".join(bad))
    rows = check_path("dedup", launches, cap.inputs,
                      required=["gcd", "factorize_squarefree"],
                      shape_launches=cap.launches)
    out = {"matches": ["BENCH_case_dedup.json", "DEDUP_FULL"],
           "smoke_launches": s_launches, "launches": launches,
           "shapes_checked": _kernel_summary(rows), "full": payload,
           "probes": full["dedup_vec"]["dedup_probes"],
           # the probes' kernels run in the dedup_vec run alone
           "dedup_vec_time_split": time_split(walls["dedup_vec"], seconds,
                                              launches, rows)}
    for kv, max_bits, required in (
            ("sharded", 62, FLAT), ("elastic", 62, FLAT),
            ("vec", 128, ["gcd_limbs"])):
        label = f"dedup_{kv}" + ("_128" if max_bits > 62 else "")
        run, launches, cap, seconds = traced(
            dedup_run, tr, "SlotMachine", kv, True, max_bits=max_bits,
            device=DEVICE)
        walls[label] = run["wall_s"]
        diff = [k for k in keys if run[k] != trail[k]]
        if diff:
            raise AssertionError(f"{label} diverged from the narrow kv='vec' "
                                 f"run: {diff}")
        pages = run["_pages"]
        rep = pages.namespace.check_isolation(pages.registry)
        if not rep.ok or run["cross_tenant_prefetches"]:
            raise AssertionError(f"{label}: isolation broken: "
                                 f"{rep.violations[:4]}")
        rows = check_path(label, launches, cap.inputs,
                          timed=kv != "elastic", required=required,
                          shape_launches=cap.launches)
        out[label] = {"launches": launches,
                      "shapes_checked": _kernel_summary(rows),
                      "probes": run["dedup_probes"],
                      "bulk_refreshes": getattr(pages, "bulk_refreshes",
                                                None),
                      "time_split": time_split(run["wall_s"], seconds,
                                               launches, rows)}
    out["wall_s"] = walls
    return out


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
    with open(os.path.join(ROOT, "BENCH_case_scale.json")) as f:
        ref_ledger = json.load(f)["obs"]["kernel_launches"]
    ledger = out["obs"]["kernel_launches"]
    failures += [f"obs.kernel_launches.{k}: {ledger.get(k)} != {v}"
                 for k, v in ref_ledger.items() if ledger.get(k) is None
                 or (ledger[k]["calls"], ledger[k]["items"])
                 != (v["calls"], v["items"])]
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
    from repro_torch.cases import serving_run

    out = {}
    for max_bits in (128, 1024):
        walls = {}
        for kv in ("vec", "scalar"):
            rep, trail = serving_run(kv, 4, smoke=False, max_bits=max_bits,
                                     device=DEVICE)
            if trail != ctx.serving_trail:
                raise AssertionError(f"{kv} at {max_bits} bits diverged "
                                     f"from the narrow run")
            walls[kv] = rep["wall_s"]
        (rep, trail), launches, cap, seconds = traced(
            serving_run, "sharded", 4, smoke=False, max_bits=max_bits,
            device=DEVICE)
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


def table1_runs(engine_cap):
    """``repro_torch.cases.run_table1`` over ``TABLE1_TRIALS`` trials of
    each Table-1 workload with every engine system (PFCS's tables built by
    ``discover="kernel"``), one engine launch a system and workload:
    ``({workload: (traces, tables, table build s, {system: (stats, wall
    s, engine_cap's call)})}, the table's rows)``."""
    from repro_torch.cases import run_table1

    systems = BASELINES + ("pfcs",)
    n_calls = len(engine_cap.calls)
    table = run_table1(TABLE1_TRIALS, 0, DEVICE, systems=systems,
                       discover="kernel")
    calls = iter(engine_cap.calls[n_calls:])
    results = {}
    for wname, run in table["_runs"].items():
        per = {system: (run["stats"][system], run["wall_s"][system],
                        next(calls)) for system in systems}
        results[wname] = (run["traces"], run["tables"], run["table_s"], per)
    if next(calls, None) is not None:
        raise AssertionError("table1: more engine calls than runs")
    return results, {k: v for k, v in table.items()
                     if not k.startswith("_")}


def phase_table1(ctx: Context) -> dict:
    """The paper's Table 1 on the card at ``benchmarks/table1.py``'s
    configuration, unreduced, through ``repro_torch.cases.run_table1``:
    each workload's three trials (seeds 0-2) through every engine system
    with ``simulate_batch`` (one launch of the baseline or the PFCS kernel
    each), PFCS's tables built by
    ``discover="kernel"`` (the flat mask and factorization kernels, each
    held against its plain version at every shape it launched at and
    timed by graph replay).  Every baseline trace's counters equal the
    port's scalar oracle, every PFCS trace's the oracle's recorded in
    ``TABLE1_PFCS`` (and the oracle run here on trial 0 of the workloads
    of ``TABLE1_PFCS_ORACLE``), and the seed-0 hit counts equal
    ``TABLE1_SEED0``.  Launches are counted from 0 over the whole run;
    each engine call's bound (``engine_bound``) is counted after it."""
    from repro_torch import kernels
    from repro_torch.cases import TABLE1_CAPS
    from repro_torch.core import (derive_table1_row, simulate_baseline,
                                  simulate_pfcs)

    systems = BASELINES + ("pfcs",)
    capture, engine_cap = Capture(), EngineCapture()
    report = {}
    try:
        kernels.reset_launch_counts()
        results, table_rows = table1_runs(engine_cap)
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
            "rows": table_rows,
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
    ("elastic", phase_elastic),
    ("mesh", phase_mesh),
    ("moe", phase_moe),
    ("model_check", phase_model_check),
    ("model_serving", phase_model_serving),
    ("launcher_model", phase_launcher_model),
    ("train_check", phase_train_check),
    ("train_full", phase_train_full),
    ("launcher_train", phase_launcher_train),
    ("obs", phase_obs),
    ("tenancy", phase_tenancy),
    ("dedup", phase_dedup),
    ("scale", phase_scale),
    ("scale_full_scan", phase_scale_full_scan),
    ("serving_wide", phase_serving_wide),
    ("launcher_wide", phase_launcher_wide),
    ("engine_check", phase_engine_check),
    ("table1", phase_table1),
    ("dryrun", phase_dryrun),
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
    holding a ``src/repro_torch`` with ``cases.run_table1``): each
    (workload, system)'s engine kernel ms, the least of its two launches
    (CUDA events around the launch; a process's first launch of a kernel
    also loads it), its seed-0 hits held to ``TABLE1_SEED0``."""
    src = os.path.realpath(os.path.join(tree, "src"))
    sys.path.insert(0, src)
    import repro_torch

    if not os.path.realpath(repro_torch.__file__).startswith(src + os.sep):
        raise RuntimeError(f"imported {repro_torch.__file__}, not {tree}'s")
    from repro_torch import cases

    if not hasattr(cases, "run_table1"):
        raise RuntimeError(f"{tree}'s repro_torch.cases has no run_table1, "
                           f"whose configuration the comparison runs")
    cap = EngineCapture()
    try:
        runs = [table1_runs(cap)[0] for _ in range(2)]
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
    ap.add_argument("--mesh-rank", metavar="WORLD", help=argparse.SUPPRESS)
    ap.add_argument("--mesh-store", help=argparse.SUPPRESS)
    args = ap.parse_args(list(argv))
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA card", file=sys.stderr)
        return 2
    if args.table1_times:
        emit(table1_times(os.path.abspath(args.table1_times)))
        return 0
    if args.mesh_rank:
        emit(mesh_rank(args.mesh_rank, args.mesh_store))
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
        for proc in ctx.dryrun:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
