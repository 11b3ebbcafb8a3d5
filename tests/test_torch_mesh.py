"""The port's sharded discovery across ranks: gloo worlds of 2 and 4 on
the CPU (``tests/torch_mesh_workers.py`` spawns them; no process group is
started in this process), held against the reference's host loop and the
port's one-device loop:

  * ``case_serving``'s smoke mix through ``kv="sharded"`` with one shard
    per rank, narrow and at 128 bits, and with 2 shards on a 2-rank
    sub-mesh of a world of 4 (the other two ranks receive the results by
    a broadcast): every rank's successor rows, ``PARITY_COUNTERS``,
    ``PageStats``, tier order and prefetch log equal the reference's and
    the loop's, ``used_shard_map`` on every refresh, the exchange on
    gloo;
  * ``case_elastic``'s smoke run (a 2 <-> 4 resize storm and kills) in a
    world of 4: every rank's counters equal the loop's and
    ``BENCH_case_elastic.json``'s keys, each refresh on a mesh of its
    shard count;
  * ``shard_mesh``'s layout against the reference's rule at 4 forced host
    devices (in a subprocess: ``jax.make_mesh((2, 1))`` takes the first
    two of four);
  * ``CheckpointManager.restore(shardings=...)`` gives each rank its exact
    rows;
  * a mesh of the wrong size raises; the launchers take the group's rank
    and world; ``nccl`` on the CPU and the production mesh without a
    group raise.
"""

import torch_parity  # noqa: F401

import dataclasses
import functools
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from torch_mesh_workers import (ENGINE_REQUESTS, engine_run, engine_summary,
                                run_world)

from repro.serving.engine import ServingEngine as RefEngine
from repro_torch.cases import case_elastic
from repro_torch.serving.engine import ServingEngine

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: the reference's ShardScanReport fields (the port adds the exchange's)
REF_SCAN = ("n_shards", "local_composites", "cross_composites",
            "queries_per_shard", "gcd_pairs")


@functools.lru_cache(maxsize=None)
def _loop_and_reference(shards, max_bits):
    """The port's one-device loop and the reference's host loop (one JAX
    device: fewer devices than shards) on the same mix."""
    port, n_port, _ = engine_run(ServingEngine, "sharded", shards, max_bits,
                                 device="cpu")
    ref, n_ref, _ = engine_run(RefEngine, "sharded", shards, max_bits)
    assert n_port == n_ref == ENGINE_REQUESTS
    want = engine_summary(port)
    assert want == engine_summary(ref)
    assert ref.pages.last_scan.used_shard_map is False
    return want, dataclasses.asdict(port.pages.last_scan)


@pytest.mark.parametrize("world,shards,max_bits", [
    (2, 2, 62), (4, 4, 62), (2, 2, 128), (4, 4, 128), (4, 2, 62)],
    ids=["2ranks", "4ranks", "2ranks-128bit", "4ranks-128bit",
         "2shards-of-4ranks"])
def test_sharded_serving_on_gloo_ranks(world, shards, max_bits, tmp_path):
    want, loop_scan = _loop_and_reference(shards, max_bits)
    got = run_world("serve_engine", world, tmp_path,
                    ("sharded", shards, max_bits))
    for rank, res in enumerate(got):
        assert res["completed"] == ENGINE_REQUESTS
        assert {k: res[k] for k in want} == want, rank
        assert res["mesh_shape"] == ((2, 1) if shards == 2 else (2, 2))
        assert res["mesh_ranks"] == list(range(shards))
        assert res["scans"], rank
        for scan in res["scans"]:
            assert scan["used_shard_map"] and scan["n_shards"] == shards
            assert scan["exchange_backend"] == "gloo"
            assert scan["exchange_bytes"] > 0
        assert {k: res["last_scan"][k] for k in REF_SCAN} == \
            {k: loop_scan[k] for k in REF_SCAN}
        assert loop_scan["exchange_backend"] is None
    if (shards, max_bits) == (2, 62):
        # case_serving's smoke configuration at 2 shards: its row of
        # BENCH_case_serving.json
        bench = json.load(open(os.path.join(ROOT,
                                            "BENCH_case_serving.json")))
        for key in ("hbm_hit_rate", "prefetch_hit_rate", "registry_scans"):
            assert {r[key] for r in got} == {bench[key]["pfcs_shard2"]}


def _elastic_keys(out):
    return {k: v for k, v in out.items() if "latency" not in k
            and not k.startswith("wall_s") and k != "tok_per_s"}


def test_elastic_resize_and_kill_on_four_ranks(tmp_path):
    """``case_elastic``'s smoke run in a world of 4: its own asserts (the
    uninterrupted scalar oracle's tokens, counters, LRU order and
    prefetch log) on every rank, counters equal to the one-device loop's
    and ``BENCH_case_elastic.json``; every refresh on a mesh of its shard
    count (2 ranks of 4, or all 4)."""
    loop = _elastic_keys(case_elastic(smoke=True, device="cpu"))
    bench = json.load(open(os.path.join(ROOT, "BENCH_case_elastic.json")))
    for key in ("n_resizes", "n_recoveries", "moved_blocks",
                "migrated_bytes", "full_rebuild_bytes", "migrated_ratio",
                "refactorized", "rows_rebuilt", "hbm_hit_rate",
                "prefetch_hit_rate"):
        assert loop[key] == bench[key], key
    got = run_world("elastic_chaos", 4, tmp_path)

    def scans(res):
        return [{k: s[k] for k in REF_SCAN + ("used_shard_map",
                                              "exchange_backend")}
                for s in res["scans"]]

    for rank, res in enumerate(got):
        assert res["case"] == loop, rank
        assert {s["n_shards"] for s in res["scans"]} == {2, 4}
        for s in res["scans"]:
            assert s["used_shard_map"] and s["exchange_backend"] == "gloo"
        assert scans(res) == scans(got[0]), rank
        # every resize to a shard count reuses that count's mesh: the
        # storm makes no new sub-groups
        meshes = {}
        for s in res["scans"]:
            meshes.setdefault(s["n_shards"], set()).add(s["mesh_id"])
        assert {n: len(ids) for n, ids in meshes.items()} == {2: 1, 4: 1}


_REF_MESHES = r"""
import json
import jax
import conftest  # the enable_x64 shim
from repro.core.engine.shard import shard_mesh
out = {}
for n in range(1, 6):
    m = shard_mesh(n)
    out[n] = None if m is None else [list(m.devices.shape),
                                     [d.id for d in m.devices.flat],
                                     list(m.axis_names)]
print(json.dumps(out))
"""


def test_shard_mesh_matches_the_reference_rule(tmp_path):
    """``shard_mesh(n)`` in a world of 4 is the reference's at 4 forced
    host devices: the square-ish split over the first n, ``None`` past 4;
    a second call returns the same mesh."""
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.pathsep.join([os.path.join(ROOT, "src"),
                                           os.path.join(ROOT, "tests")]))
    res = subprocess.run([sys.executable, "-c", _REF_MESHES], env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    want = json.loads(res.stdout.strip().splitlines()[-1])
    got = run_world("mesh_layouts", 4, tmp_path, (list(range(1, 6)),))
    for rank_layouts in got:
        for n in range(1, 6):
            g = rank_layouts[n]
            assert (None if g is None else
                    [list(g[0]), g[1], list(g[2])]) == want[str(n)], n
            assert g is None or g[3], n
    assert want["2"][0] == [2, 1] and want["2"][1] == [0, 1]
    assert want["5"] is None


def test_restore_shardings_gives_each_rank_its_rows(tmp_path):
    from repro_torch.training.checkpoint import CheckpointManager

    rng = np.random.default_rng(3)
    tree = {"w": torch.from_numpy(rng.standard_normal((8, 6)).astype(
                np.float32)),
            "b": torch.from_numpy(rng.standard_normal(6).astype(np.float32)),
            "h": torch.from_numpy(rng.standard_normal((4, 10)).astype(
                np.float32)).to(torch.bfloat16)}
    ckpt = tmp_path / "ckpt"
    CheckpointManager(ckpt).save(7, tree)
    (tmp_path / "world").mkdir()
    got = run_world("restore_rows", 2, tmp_path / "world", (str(ckpt),))
    for rank, res in enumerate(got):
        w, pw, sw = res["w"]
        assert np.array_equal(w, tree["w"][4 * rank:4 * rank + 4].numpy())
        assert pw == ["R", "S(0)"] and sw == (8, 6)
        b, pb, _ = res["b"]
        assert np.array_equal(b, tree["b"].numpy())
        assert pb == ["R", "R"]
        h, ph, _ = res["h"]
        assert np.array_equal(h, tree["h"][:, 5 * rank:5 * rank + 5]
                              .float().numpy())
        assert ph == ["R", "S(1)"]


def test_wrong_mesh_size_raises(tmp_path):
    got = run_world("wrong_mesh_raises", 2, tmp_path)
    for msgs in got:
        assert msgs == ["mesh has 2 ranks, cache has 4 shards"] * 2


def test_launchers_take_the_group(tmp_path):
    """Under ``torchrun``'s environment ``launch/serve.py`` starts the
    group itself (``--dist-backend gloo``) and every rank prints the same
    counters with the exchange on; ``launch/train.py`` reads rank and
    world from the started group."""
    got = run_world("launchers", 2, tmp_path, (str(tmp_path / "serve"),),
                    init=False)
    timed = {"tok_per_s", "rank"}
    outs = [{k: v for k, v in r["serve"].items() if k not in timed}
            for r in got]
    assert outs[0] == outs[1]
    assert outs[0]["used_shard_map"] is True
    assert outs[0]["exchange_backend"] == "gloo"
    assert outs[0]["world"] == 2 and outs[0]["completed"] == 6
    assert [r["serve"]["rank"] for r in got] == [0, 1]
    assert [r["train"] for r in got] == [(0, 2), (1, 2)]


def test_no_group_no_mesh_and_no_nccl_on_the_cpu(monkeypatch):
    """Without a group the mesh functions raise ``ValueError`` and
    ``shard_mesh`` is ``None`` (the loop); ``nccl`` asks for the card;
    the environment torchrun gives is required."""
    import torch.distributed as dist

    from repro_torch.core.engine.shard import shard_mesh
    from repro_torch.launch import mesh as lm

    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="no process group"):
        lm.make_production_mesh()
    with pytest.raises(ValueError, match="no process group"):
        lm.make_local_mesh()
    assert shard_mesh(1) is None and shard_mesh(4) is None
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "1")
    with pytest.raises(RuntimeError, match="'gloo'"):
        lm.init_distributed("nccl", device="cpu")
    monkeypatch.delenv("RANK")
    with pytest.raises(RuntimeError, match="RANK is not set"):
        lm.init_distributed("gloo", device="cpu")
    assert not dist.is_initialized()
    assert lm.HW.HBM_BW == 3.35e12 and lm.HW.PEAK_BF16_FLOPS == 989e12
    assert lm.AbstractMesh((2, 16, 16), ("pod", "data", "model")).size() \
        == 512
