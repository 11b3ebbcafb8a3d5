"""Serving launcher: runs the batched-request engines (port of
``repro.launch.serve``).

Default front-end is the continuous-batching :class:`~repro_torch.
serving.slots.SlotMachine`: open-loop Poisson arrivals, chunked prefill,
async admission, preemption/resume.  ``--front-end engine`` selects the
closed-queue ``ServingEngine`` loop instead; a real model (``--arch``
without ``--null-model``: the arch's smoke configuration, random
parameters from a generator seeded 0) always runs through
``ServingEngine``, because the slot machine is a page-management load
generator (stub decode only).

Both front-ends share the PFCS paged KV cache backends (``--kv vec``
array-state tables by default, ``scalar`` for the oracle, ``sharded``
for the prime-space partitioned cache whose registry refreshes run the
CUDA discovery kernels on ``--device``, and ``elastic``, the sharded
cache with live resize and shard-loss recovery).  ``--trace PATH``
records the observability layer (event ring, telemetry and the kernel
ledger) and writes its export, the input of ``tools/trace_view.py``.

Under ``torchrun`` (``--dist-backend gloo|nccl`` names the backend; a
world larger than 1 without it is refused) every rank starts the
process group, runs the same serving program and prints the same
counters: with ``--kv sharded`` / ``elastic`` the registry refreshes
scan one shard per rank and exchange the cross-shard slices by an
all-gather (2 shards; ranks beyond them receive the results by a
broadcast).  Ranks that share a card run ``gloo``.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-3b \
        --requests 16 --max-new 24
    PYTHONPATH=src python -m repro_torch.launch.serve --null-model \
        --kv sharded --max-batch 128 --requests 256
    torchrun --nproc-per-node 2 -m repro_torch.launch.serve --null-model \
        --kv sharded --dist-backend gloo
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2.5-3b")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=24)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=256)
    ap.add_argument("--shared-prefix", type=int, default=24,
                    help="tokens of shared prompt prefix (exercises PFCS "
                         "prefix sharing)")
    ap.add_argument("--kv", choices=("vec", "scalar", "sharded", "elastic"),
                    default="vec",
                    help="paged-KV backend (serving/engine.py factory)")
    ap.add_argument("--max-bits", type=int, default=62,
                    help="registry chunk width; > 63 selects multi-limb "
                         "wide mode (DESIGN.md §11)")
    ap.add_argument("--front-end", choices=("slots", "engine"),
                    default="slots",
                    help="continuous-batching SlotMachine (default) or "
                         "the closed-queue ServingEngine loop")
    ap.add_argument("--arrival-rate", type=float, default=2.0,
                    help="slots front-end: open-loop Poisson arrivals "
                         "per tick")
    ap.add_argument("--prefill-tokens", type=int, default=64,
                    help="slots front-end: shared chunked-prefill budget "
                         "per tick")
    ap.add_argument("--null-model", action="store_true",
                    help="no device decode: pure page-management load "
                         "generation (scales to hundreds of slots)")
    ap.add_argument("--trace", metavar="PATH", default=None,
                    help="record the observability layer (event ring + "
                         "telemetry + kernel ledger) and write the export "
                         "JSON here; feed it to tools/trace_view.py for a "
                         "Chrome trace")
    ap.add_argument("--device", default="cuda",
                    help="where the model and the discovery kernels run: "
                         "'cuda' (the default) or 'cpu' for the plain "
                         "versions")
    ap.add_argument("--dist-backend", choices=("gloo", "nccl"), default=None,
                    help="under torchrun: start the process group with "
                         "this backend (ranks sharing a card: gloo)")
    ap.add_argument("--dist-init-method", default=None,
                    help="the group's rendezvous (default env://, "
                         "torchrun's MASTER_ADDR / MASTER_PORT; e.g. "
                         "file:///path)")
    args = ap.parse_args(argv)

    world = int(os.environ.get("WORLD_SIZE", "1"))
    if args.dist_backend is None and world > 1:
        ap.error(f"a world of {world} ranks: pass --dist-backend")
    if args.dist_backend is not None:
        from repro_torch.launch.mesh import init_distributed

        args.device = str(init_distributed(
            args.dist_backend, device=args.device,
            init_method=args.dist_init_method))
    try:
        out = _serve(args)
        if args.dist_backend is not None:
            import torch.distributed as dist

            dist.barrier()      # no rank leaves while another still serves
        return out
    finally:
        if args.dist_backend is not None:
            import torch.distributed as dist

            dist.destroy_process_group()


def _serve(args):

    obs = None
    if args.trace:
        from repro_torch.obs import Observability, profile

        obs = Observability()
        profile.reset()
        profile.enable(True)

    if args.null_model:
        model, params, vocab = None, None, 32_000
    else:
        from repro_torch.configs import get_smoke
        from repro_torch.models import build_model

        cfg = get_smoke(args.arch)
        model = build_model(cfg, device=args.device)
        params = model.init_params(0)
        vocab = cfg.vocab_size

    # the slot machine decodes stub tokens only — a real model needs the
    # ServingEngine's device decode step
    front_end = args.front_end if model is None else "engine"

    rng = np.random.default_rng(0)
    shared = list(rng.integers(0, vocab, size=args.shared_prefix))
    prompts = [shared + list(rng.integers(0, vocab,
                                          size=int(rng.integers(4, 12))))
               for _ in range(args.requests)]

    if front_end == "slots":
        from repro_torch.serving.slots import (SlotMachine,
                                               poisson_arrival_ticks)

        machine = SlotMachine(max_batch=args.max_batch, kv=args.kv,
                              prefill_tokens=args.prefill_tokens,
                              max_bits=args.max_bits, obs=obs,
                              device=args.device)
        arrivals = poisson_arrival_ticks(len(prompts), args.arrival_rate)
        for prompt, tick in zip(prompts, arrivals):
            machine.submit(prompt, max_new_tokens=args.max_new,
                           arrival=int(tick))
        t0 = time.time()
        machine.run_until_idle()
        wall = time.time() - t0
        st = machine.pages.stats
        rep = machine.latency_report()
        out = {
            "front_end": "slots",
            "kv": args.kv,
            "device": str(machine.device),
            "completed": rep["completed"],
            "decode_tokens": rep["tokens"],
            "ticks": rep["ticks"],
            "tok_per_s": round(rep["tokens"] / max(wall, 1e-9), 1),
            "goodput_tok_per_tick": round(rep["goodput_tok_per_tick"], 3),
            "ttft_p50_ticks": rep["ttft_ticks"][50],
            "peak_in_flight": rep["peak_in_flight"],
            "hbm_hit_rate": round(st.hbm_hit_rate, 4),
            "prefetches": st.prefetches,
            "prefetch_hits": st.prefetch_hits,
            "shared_prefix_pages": st.shared_prefix_pages,
            "registry_scans": st.registry_scans,
        }
        pages = machine.pages
    else:
        from repro_torch.serving.engine import ServingEngine

        engine = ServingEngine(model, params, max_batch=args.max_batch,
                               max_seq=args.max_seq, kv=args.kv,
                               max_bits=args.max_bits, obs=obs,
                               device=args.device)
        for prompt in prompts:
            engine.submit(prompt, max_new_tokens=args.max_new)
        t0 = time.time()
        done = engine.run_until_idle()
        wall = time.time() - t0
        toks = sum(len(r.generated) for r in done)
        st = engine.pages.stats
        ttfts = [r.first_token_t - r.submit_t
                 for r in done if r.first_token_t]
        out = {
            "front_end": "engine",
            "kv": args.kv,
            "device": str(engine.device),
            "completed": len(done),
            "decode_tokens": toks,
            "tok_per_s": round(toks / wall, 1),
            "mean_ttft_s": round(float(np.mean(ttfts)), 3) if ttfts else None,
            "peak_concurrency": engine.peak_live,
            "hbm_hit_rate": round(st.hbm_hit_rate, 4),
            "prefetches": st.prefetches,
            "prefetch_hits": st.prefetch_hits,
            "shared_prefix_pages": st.shared_prefix_pages,
            "registry_scans": st.registry_scans,
        }
        pages = engine.pages
    if args.dist_backend is not None:
        import torch.distributed as dist

        scan = getattr(pages, "last_scan", None)
        out.update(rank=dist.get_rank(), world=dist.get_world_size(),
                   used_shard_map=getattr(scan, "used_shard_map", None),
                   exchange_backend=getattr(scan, "exchange_backend", None))
    if obs is not None:
        from repro_torch.obs import profile

        profile.enable(False)
        obs.export_json(args.trace)
        out["trace_events"] = obs.trace.total
        print(f"observability export ({obs.trace.total} events) "
              f"-> {args.trace}", flush=True)
    print(json.dumps(out, indent=1))
    # deterministic shared-prefix discovery demo
    if len(pages.chains) >= 2:
        ids = list(pages.chains)[:2]
        print("shared pages of first two live chains:",
              pages.shared_prefix(*ids))
    return out


if __name__ == "__main__":
    main()
