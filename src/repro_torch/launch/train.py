"""Training launcher: the end-to-end program wiring every substrate
together (port of ``repro.launch.train``).

Runs a real training loop on ``--device`` (the card unless told
``cpu``): model from ``--arch`` (smoke or full config), sharded data
loader, train step (eager, updating the train state in place, as the
reference's jitted step does with its donated state), checkpoint/restore
with atomic commit, the straggler monitor, and the optional PFCS-cached
data tier.  The loader's shard and the straggler log's rank are the
process group's rank and world when one is started (the reference asks
``jax.process_index()`` / ``process_count()``), 0 of 1 when none is; as
in the reference, every process trains the whole model on its own
loader shard (no data-parallel step).

``examples/train_lm.py`` calls this launcher with a ~33M config.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma-2b \
        --smoke --steps 50 --batch 8 --seq 256 [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import torch


def process_rank_world():
    """(rank, world) of the started process group; (0, 1) without one."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma-2b")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced smoke config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--ckpt-dir", default="artifacts/ckpt")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--d-model", type=int, default=0,
                    help="override width (e.g. ~100M example model)")
    ap.add_argument("--n-layers", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--pfcs-data", action="store_true",
                    help="route the data tier through the PFCS shard cache")
    ap.add_argument("--device", default="cuda",
                    help="where the model trains: 'cuda' (the default) or "
                         "'cpu'")
    args = ap.parse_args(argv)

    from repro_torch.configs import get_config, get_smoke
    from repro_torch.data.pipeline import (ByteTokenizer, ShardedLoader,
                                           SyntheticCorpus)
    from repro_torch.device import resolve_device
    from repro_torch.models import build_model
    from repro_torch.training.checkpoint import CheckpointManager
    from repro_torch.training.elastic import StragglerMonitor
    from repro_torch.training.train_loop import (init_train_state,
                                                 make_train_step)

    device = resolve_device(args.device)
    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    overrides = {}
    if args.d_model:
        overrides.update(d_model=args.d_model)
    if args.n_layers:
        overrides.update(n_layers=args.n_layers)
    if overrides:
        cfg = cfg.replace(**overrides)
    # byte-level vocab for the synthetic corpus
    cfg = cfg.replace(vocab_size=ByteTokenizer.vocab_size)
    model = build_model(cfg, device=device)

    corpus = SyntheticCorpus(vocab_size=cfg.vocab_size)
    pfcs = None
    if args.pfcs_data:
        from repro_torch.core.pfcs_cache import PFCSCache
        pfcs = PFCSCache(capacities=(("L1", 8), ("L2", 32), ("L3", 64)))
    rank, world = process_rank_world()
    loader = ShardedLoader(corpus, args.batch, args.seq, shard_index=rank,
                           shard_count=world, pfcs_cache=pfcs)

    ckpt = CheckpointManager(Path(args.ckpt_dir) / cfg.name)
    state = init_train_state(model, 0)
    start_step = 0
    if args.resume:
        latest = ckpt.latest_step()
        if latest is not None:
            state = ckpt.restore(state, step=latest)
            start_step = latest
            print(f"resumed from step {latest}")

    step_fn = make_train_step(model, lr=args.lr, total_steps=args.steps,
                              warmup=max(1, args.steps // 10),
                              accum_steps=args.accum)
    straggler = StragglerMonitor()

    losses = []
    t_start = time.time()
    for step in range(start_step, args.steps):
        batch = {k: torch.from_numpy(v).to(device)
                 for k, v in loader.batch_at(step).items()}
        t0 = time.time()
        state, metrics = step_fn(state, batch)
        loss = float(metrics["loss"])
        dt = time.time() - t0
        straggler.record(rank, dt)
        losses.append(loss)
        if step % args.log_every == 0 or step == args.steps - 1:
            print(f"step {step:5d}  loss {loss:.4f}  "
                  f"gnorm {float(metrics['grad_norm']):.3f}  "
                  f"lr {float(metrics['lr']):.2e}  {dt*1e3:.0f} ms")
        if args.ckpt_every and (step + 1) % args.ckpt_every == 0:
            ckpt.save(step + 1, state, blocking=False)
    ckpt.wait()
    ckpt.save(args.steps, state)
    out = {"first_loss": losses[0], "last_loss": losses[-1],
           "steps": args.steps, "wall_s": round(time.time() - t_start, 1),
           "device": device.type}
    if pfcs is not None:
        out["pfcs_shard_prefetches"] = pfcs.prefetches_issued
    print(json.dumps(out))
    assert losses[-1] < losses[0], "training did not reduce loss"
    return out


if __name__ == "__main__":
    main()
