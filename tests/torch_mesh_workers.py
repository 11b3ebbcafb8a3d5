"""Ranks of a ``torch.distributed`` world for the port's mesh tests
(``tests/test_torch_mesh.py``): :func:`run_world` spawns one process per
rank (gloo, on the CPU), each rank runs a target of this module and
pickles what it returns into the test's temporary directory.  Nothing
here imports JAX: the spawned ranks import only the port.

Hygiene: the ranks rendezvous through a ``FileStore`` file under the
test's ``tmp_path`` (no port), every group waits at most 60 s for a peer
(``repro_torch.launch.mesh.DEFAULT_TIMEOUT``), the parent joins each
rank with its own deadline and kills what is left, and no group is ever
started in the pytest worker itself.
"""

from __future__ import annotations

import dataclasses
import os
import pickle
import time
import traceback
from pathlib import Path
from typing import Any, Dict, List

import numpy as np

__all__ = ["run_world", "serve_engine", "elastic_chaos", "mesh_layouts",
           "restore_rows", "wrong_mesh_raises", "launchers", "engine_run",
           "engine_summary", "ENGINE_REQUESTS"]

#: the engine workload: ``tests/test_torch_serving.py``'s ``_run_engine``
ENGINE_REQUESTS = 48


def _rank_main(target: str, rank: int, world: int, store: str, out: str,
               args: tuple, init: bool, backend: str, device: str) -> None:
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world))
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    path = Path(out) / f"rank{rank}.pkl"
    try:
        from repro_torch.launch.mesh import init_distributed

        if init:
            init_distributed(backend, device=device,
                             init_method=f"file://{store}")
        result = globals()[target](rank, world, *args)
        if dist.is_initialized():
            # every rank is done with whatever group is up (this one's, or
            # one the target started) before any rank destroys it; a rank
            # that raised skips this, and its peers' wait ends at the
            # group's timeout or the parent's deadline
            dist.barrier()
        with open(path, "wb") as f:
            pickle.dump({"ok": result}, f)
    except BaseException:
        with open(path, "wb") as f:
            pickle.dump({"error": traceback.format_exc()}, f)
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_world(target: str, world: int, tmp_path, args: tuple = (),
              timeout: float = 240.0, init: bool = True,
              backend: str = "gloo", device: str = "cpu") -> List[Any]:
    """Run ``target(rank, world, *args)`` on ``world`` spawned ranks of a
    ``backend`` group on ``device`` (``init=False``: the target starts the
    group itself, from the ``torchrun`` environment each rank is given);
    returns each rank's result, in rank order.  Fails naming the rank
    that raised or did not finish within ``timeout`` seconds."""
    import multiprocessing

    tmp = Path(tmp_path)
    store = tmp / "store"
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank_main,
                         args=(target, r, world, str(store), str(tmp), args,
                               init, backend, device),
                         daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
        p.join(10)
    results, errors = [], []
    for r in range(world):
        path = tmp / f"rank{r}.pkl"
        if not path.exists():
            errors.append(f"rank {r}: no result")
            continue
        with open(path, "rb") as f:
            got = pickle.load(f)
        if "error" in got:
            errors.append(f"rank {r}:\n{got['error']}")
        results.append(got.get("ok"))
    assert not hung, f"ranks {hung} did not finish in {timeout} s"
    assert not errors, "\n".join(errors)
    assert all(p.exitcode == 0 for p in procs), [p.exitcode for p in procs]
    return results


# --------------------------------------------------------------------------- #
# targets                                                                     #
# --------------------------------------------------------------------------- #

def _scan_log(pages) -> List[dict]:
    """Wrap ``pages.refresh_tables`` to log each refresh's report."""
    log: List[dict] = []
    inner = pages.refresh_tables

    def refresh(discover=None):
        inner(discover)
        if discover is None:
            log.append(dataclasses.asdict(pages.last_scan))
    pages.refresh_tables = refresh
    return log


def engine_summary(eng) -> Dict[str, Any]:
    pages = eng.pages
    return {"parity": pages.stats.parity_tuple(),
            "registry_scans": pages.stats.registry_scans,
            "prefetch_log": list(pages.prefetch_log),
            "hbm": list(pages.hbm.items()),
            "rows": pages.successor_rows(),
            "shard_load": pages.shard_load(),
            "hbm_hit_rate": pages.stats.hbm_hit_rate,
            "prefetch_hit_rate": pages.stats.prefetch_hit_rate,
            "peak_live": eng.peak_live}


def engine_run(cls, kv: str, shards: int, max_bits: int = 62, **kw):
    """``_run_engine``'s workload (``case_serving``'s smoke mix) through
    engine class ``cls`` (either package's ``ServingEngine``):
    ``(engine, completed requests, each refresh's report)``."""
    eng = cls(None, None, max_batch=16, page_size=16, hbm_pages=24, kv=kv,
              prefetch_budget=4, reread_window=2, shards=shards,
              max_bits=max_bits, **kw)
    scans = _scan_log(eng.pages)
    rng = np.random.default_rng(0)
    groups = [list(rng.integers(0, 30_000, size=64)) for _ in range(6)]
    for r in range(ENGINE_REQUESTS):
        tail = list(rng.integers(0, 30_000, size=int(rng.integers(48, 129))))
        eng.submit(groups[r % len(groups)] + tail, max_new_tokens=8)
    return eng, len(eng.run_until_idle()), scans


def serve_engine(rank: int, world: int, kv: str, shards: int,
                 max_bits: int = 62, device: str = "cpu") -> Dict[str, Any]:
    """:func:`engine_run` with the port's ``ServingEngine(kv=kv,
    shards=shards)``, ``mesh="auto"``, on ``device``."""
    import torch

    from repro_torch.serving.engine import ServingEngine

    if device == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    eng, done, scans = engine_run(ServingEngine, kv, shards, max_bits,
                                  device=device)
    mesh = eng.pages.mesh
    out = engine_summary(eng)
    out.update(completed=done, scans=scans,
               last_scan=dataclasses.asdict(eng.pages.last_scan),
               mesh_shape=None if mesh is None else tuple(mesh.shape),
               mesh_ranks=None if mesh is None else
               mesh.mesh.flatten().tolist())
    return out


def elastic_chaos(rank: int, world: int) -> Dict[str, Any]:
    """``case_elastic``'s smoke run (its own asserts against the scalar
    oracle) with every refresh logged: a 2 <-> 4 resize storm and kills,
    each refresh's mesh the first ``n_shards`` ranks (and which mesh
    object it was)."""
    from repro_torch import cases
    from repro_torch.serving import elastic

    logs: List[dict] = []
    inner = elastic.ElasticShardedPagedKVCache.refresh_tables

    def refresh(self, discover=None):
        inner(self, discover)
        if discover is None:
            logs.append({"n_shards": self.n_shards, "mesh_id": id(self.mesh),
                         **dataclasses.asdict(self.last_scan)})
    elastic.ElasticShardedPagedKVCache.refresh_tables = refresh
    out = cases.case_elastic(smoke=True, device="cpu")
    out = {k: v for k, v in out.items() if "latency" not in k
           and not k.startswith("wall_s") and k != "tok_per_s"}
    return {"case": out, "scans": logs}


def mesh_layouts(rank: int, world: int, counts) -> Dict[int, Any]:
    """``shard_mesh(n)``'s shape and ranks for each ``n`` of ``counts``,
    and whether a second call returned the same mesh."""
    from repro_torch.core.engine.shard import shard_mesh

    out = {}
    for n in counts:
        mesh = shard_mesh(n)
        out[n] = (None if mesh is None else
                  (tuple(mesh.shape), mesh.mesh.flatten().tolist(),
                   mesh.mesh_dim_names, shard_mesh(n) is mesh))
    return out


def restore_rows(rank: int, world: int, ckpt_dir: str) -> Dict[str, Any]:
    """``CheckpointManager.restore(shardings=...)`` of the tree saved in
    ``ckpt_dir`` onto a (1, world) mesh: each leaf's local shard and its
    placements."""
    import torch

    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.sharding.partition import NamedSharding, PartitionSpec
    from repro_torch.training.checkpoint import CheckpointManager

    mesh = make_local_mesh()
    target = {"w": torch.zeros(8, 6), "b": torch.zeros(6),
              "h": torch.zeros(4, 10, dtype=torch.bfloat16)}
    shardings = {"w": NamedSharding(mesh, PartitionSpec("model", None)),
                 "b": NamedSharding(mesh, PartitionSpec()),
                 "h": NamedSharding(mesh, PartitionSpec(None, "model"))}
    got = CheckpointManager(ckpt_dir).restore(target, shardings=shardings,
                                              verify=True)
    return {k: (v.to_local().float().numpy(), [str(p) for p in v.placements],
                tuple(v.shape))
            for k, v in got.items()}


def wrong_mesh_raises(rank: int, world: int) -> str:
    """A cache given a mesh with another rank count than its shards
    raises the reference's ``ValueError``; so does a resize."""
    from repro_torch.core.engine.shard import shard_mesh
    from repro_torch.serving.elastic import ElasticShardedPagedKVCache
    from repro_torch.serving.kv_cache_sharded import ShardedPagedKVCache

    mesh = shard_mesh(world)
    msgs = []
    for make in (lambda: ShardedPagedKVCache(n_shards=2 * world, mesh=mesh,
                                             device="cpu"),
                 lambda: ElasticShardedPagedKVCache(
                     n_shards=world, device="cpu").resize(2 * world,
                                                          mesh=mesh)):
        try:
            make()
        except ValueError as exc:
            msgs.append(str(exc))
    return msgs


def launchers(rank: int, world: int, store: str) -> Dict[str, Any]:
    """``launch/serve.py`` starting the group itself (gloo, a ``file://``
    rendezvous) and serving its 2 shards, one a rank in a world of 2;
    then, in a group started here, ``launch/train.py``'s rank and
    world."""
    import torch.distributed as dist

    from repro_torch.launch import serve, train
    from repro_torch.launch.mesh import init_distributed

    out = serve.main(["--null-model", "--kv", "sharded", "--requests", "6",
                      "--device", "cpu",
                      "--dist-backend", "gloo",
                      "--dist-init-method", f"file://{store}-serve"])
    assert not dist.is_initialized()
    init_distributed("gloo", device="cpu",
                     init_method=f"file://{store}-train")
    return {"serve": out, "train": train.process_rank_world()}
