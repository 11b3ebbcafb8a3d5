"""The port's dry-run (``repro_torch.launch.dryrun``) against the
reference's (``repro.launch.dryrun``): the cell configuration helpers
(``opt_overrides``, ``probe_layer_counts``, ``override_layers``) give the
reference's configs for every arch and shape; and, in a process of its
own with a fake group (never in this pytest worker), a smoke-config
train cell and a decode cell of a dense arch and a decode cell of an MoE
arch on a fake 4x4 mesh reach ``status: "ok"`` with collectives and the
explicit rules that fired counted and the argument bytes of the specs'
arithmetic, while a cell that
reaches an op DTensor has no sharding rule for records ``status:
"error"`` naming the op; and the census of a dense decode cell on a fake
2x2 mesh equals its arithmetic.

The reference's module sets ``XLA_FLAGS`` (512 host devices) when it is
imported, which would change JAX's devices for every later test of the
worker, so it is imported only in a subprocess (``_reference``)."""

import torch_parity  # noqa: F401

import dataclasses
import json
import os
import subprocess
import sys

import pytest

from repro.configs import ARCH_IDS
from repro.configs import get_config as ref_config
from repro_torch.configs import SHAPES, get_config, get_smoke
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import AbstractMesh
from repro_torch.models import build_model
from repro_torch.sharding import partition as pt
from repro_torch.training.train_loop import abstract_train_state

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


_REFERENCE = r"""
import dataclasses, json, sys
sys.path.insert(0, sys.argv[1])
import conftest  # the enable_x64 shim
from repro.configs import ARCH_IDS, SHAPES, get_config
from repro.launch import dryrun
out = {"artifact_dir": str(dryrun.ARTIFACT_DIR), "archs": {}}
for arch in ARCH_IDS:
    cfg = get_config(arch)
    probes = dryrun.probe_layer_counts(cfg)
    out["archs"][arch] = {
        "opt": {s.name: dataclasses.asdict(dryrun.opt_overrides(cfg, s.kind))
                for s in SHAPES},
        "probes": list(probes),
        "layers": [dataclasses.asdict(dryrun.override_layers(cfg, n))
                   for n in probes]}
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def reference():
    """The reference's dry-run helpers' results, from a subprocess."""
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(ROOT, "src"))
    res = subprocess.run([sys.executable, "-c", _REFERENCE,
                          os.path.join(ROOT, "tests")], env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


def _plain(cfg):
    """A config as the reference's side arrives (through JSON)."""
    return json.loads(json.dumps(dataclasses.asdict(cfg)))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cell_configs_equal_the_reference(arch, reference):
    """``opt_overrides`` for every shape, ``probe_layer_counts`` and
    ``override_layers`` at both probe depths give the reference's
    configs, field for field."""
    cfg = get_config(arch)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref_config(arch))
    want = reference["archs"][arch]
    assert sorted(want["opt"]) == sorted(s.name for s in SHAPES)
    for shape in SHAPES:
        assert _plain(dryrun.opt_overrides(cfg, shape.kind)) == \
            want["opt"][shape.name], shape.name
    probes = dryrun.probe_layer_counts(cfg)
    assert list(probes) == want["probes"]
    assert [_plain(dryrun.override_layers(cfg, n)) for n in probes] == \
        want["layers"]


def test_artifact_names_follow_the_reference_with_a_suffix(tmp_path,
                                                           reference):
    """The reference's names with ``__torch`` before ``.json``: the two
    packages' artifacts in ``artifacts/dryrun/`` never collide."""
    assert str(dryrun.ARTIFACT_DIR) == reference["artifact_dir"]
    name = dryrun.artifact_path(tmp_path, "gemma-2b", "train_4k", True,
                                layer_override=2, variant="opt").name
    assert name == "gemma-2b__train_4k__multipod_2x16x16__probe2__opt" \
                   "__torch.json"
    assert dryrun.artifact_path(tmp_path, "qwen2.5-3b", "decode_32k",
                                False).name == \
        "qwen2.5-3b__decode_32k__pod_16x16__torch.json"


_CELLS = r"""
import json, sys
from pathlib import Path
import torch
from repro_torch.launch import dryrun
from repro_torch.sharding.partition import NamedSharding, PartitionSpec
out = Path(sys.argv[1])
recs = [dryrun.run_cell(arch, shape, False, out, smoke=True,
                        mesh_shape=(4, 4))
        for arch, shape in (("qwen2.5-3b", "train_4k"),
                            ("qwen2.5-3b", "decode_32k"),
                            ("kimi-k2-1t-a32b", "decode_32k"))]


# a cell whose step reaches an op DTensor has no sharding rule for
@torch.library.custom_op("dryrun_test::opaque", mutates_args=())
def opaque(x: torch.Tensor) -> torch.Tensor:
    return x.clone()


@opaque.register_fake
def _(x):
    return torch.empty_like(x)


def opaque_cell(arch, shape, multi_pod, layer_override, variant, smoke,
                mesh_shape):
    mesh = dryrun.cell_mesh(multi_pod, mesh_shape)
    x = {"x": torch.empty(8, 16, device="meta")}
    return (mesh, lambda t: opaque(t["x"]), (x,),
            ({"x": NamedSharding(mesh, PartitionSpec("data", "model"))},))


dryrun.build_cell = opaque_cell
recs.append(dryrun.run_cell("opaque", "none", False, out, smoke=True,
                            mesh_shape=(4, 4)))
print(json.dumps(recs))
"""


def _spec_bytes(arch, shape_name):
    """The argument bytes one rank holds: each leaf's local shard under
    the specs of a 4x4 mesh, by arithmetic."""
    return _spec_bytes_on(arch, shape_name, (4, 4))


def _spec_bytes_on(arch, shape_name, mesh_shape):
    cfg = get_smoke(arch)
    shape = next(s for s in SHAPES if s.name == shape_name)
    mesh = AbstractMesh(mesh_shape, ("data", "model"))
    model = build_model(cfg, device="cpu")
    batch = model.input_specs(shape)
    total = pt.local_bytes(batch, pt.batch_shardings(batch, mesh))
    if shape.kind == "train":
        st = abstract_train_state(model)
        total += pt.local_bytes(st.params, pt.params_shardings(
            st.params, mesh, cfg))
        total += pt.local_bytes(st.opt_state, pt.opt_state_shardings(
            st.opt_state, st.params, mesh, cfg))
        return total + 4                       # the int32 step
    params = model.param_specs()
    cache = model.cache_specs(shape)
    return (total + pt.local_bytes(params, pt.params_shardings(params, mesh,
                                                               cfg))
            + pt.local_bytes(cache, pt.cache_shardings(cache, mesh, cfg)))


def test_smoke_cells_on_a_fake_four_by_four_mesh(tmp_path):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    res = subprocess.run([sys.executable, "-c", _CELLS, str(tmp_path)],
                         env=env, capture_output=True, text=True,
                         timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    train, decode, moe, opaque = json.loads(
        res.stdout.strip().splitlines()[-1])
    for rec, shape in ((train, "train_4k"), (decode, "decode_32k")):
        assert rec["status"] == "ok", rec.get("error")
        assert rec["n_devices"] == 16 and rec["mesh"] == "fake_4x4"
        coll = rec["collectives"]
        assert sum(coll.get(k, {}).get("count", 0)
                   for k in ("all-reduce", "all-gather")) >= 1, coll
        assert all(v["bytes"] > 0 for v in coll.values())
        assert rec["memory"]["argument_size_in_bytes"] == \
            _spec_bytes("qwen2.5-3b", shape)
        assert rec["flops"] > 0 and rec["bytes_accessed"] > 0
        assert rec["memory"]["temp_size_in_bytes"] > 0
        saved = json.loads(dryrun.artifact_path(
            tmp_path, "qwen2.5-3b", shape, False, smoke=True,
            mesh_shape=(4, 4)).read_text())
        assert saved == rec
    # the gradients of the batch-sharded loss are reduced
    assert train["collectives"]["all-reduce"]["count"] >= 1
    # every explicit rule that fired is counted in the record: the einsum
    # and product rules of each layer, the pending sums reduced, and the
    # decode step's k and v row writes of each layer
    for rec in (train, decode):
        assert all(isinstance(n, int) and n > 0
                   for n in rec["rules"].values()), rec["rules"]
        assert rec["rules"]["einsum"] >= 2 and rec["rules"]["matmul"] >= 2
        assert rec["rules"]["reduce"] >= 1
    assert decode["rules"]["row_write"] == 2 * get_smoke("qwen2.5-3b").n_layers
    assert "row_write" not in train["rules"]
    # the MoE dispatch's bincount counts its gathered expert ids
    assert moe["status"] == "ok", moe.get("error")
    assert moe["collectives"]["all-gather"]["count"] >= 1
    assert moe["rules"]["bincount"] >= 1
    assert opaque["status"] == "error"
    assert opaque["op"] == "dryrun_test.opaque.default", opaque["error"]


_ARITHMETIC_CELL = r"""
import json, sys
from repro_torch.launch import dryrun
print(json.dumps(dryrun.trace_cell("qwen2.5-3b", "decode_32k", False,
                                   smoke=True, mesh_shape=(2, 2))))
"""


def test_census_of_a_dense_decode_cell_equals_its_arithmetic():
    """qwen2.5-3b's smoke decode step on a fake 2x2 mesh, where every
    sharded dim divides (the batch over "data"; heads, KV heads, d_ff and
    the vocabulary over "model"), so one rank does a quarter of the work:
    FLOPs are 2 x matmul params x tokens plus the attention's 4 x batch x
    heads x cache length x head dim per layer, over 4 ranks, exactly;
    the bytes read and written lie between the arguments read once and
    the cache read a few times plus the scores; and each layer all-reduces
    its attention and FFN outputs."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    res = subprocess.run([sys.executable, "-c", _ARITHMETIC_CELL], env=env,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    rec = json.loads(res.stdout.strip().splitlines()[-1])
    cfg = get_smoke("qwen2.5-3b")
    shape = next(s for s in SHAPES if s.name == "decode_32k")
    b, seq, layers, ranks = shape.global_batch, shape.seq_len, \
        cfg.n_layers, 4
    model = build_model(cfg, device="cpu")
    matmul_params = sum(
        x.numel() for name, x in model.param_specs().named_parameters()
        if name == "unembed" or name.rsplit(".", 1)[-1].startswith("w"))
    attention = 4 * b * cfg.n_heads * seq * cfg.head_dim * layers
    assert rec["flops"] * ranks == 2 * b * matmul_params + attention
    args = rec["memory"]["argument_size_in_bytes"]
    assert args == _spec_bytes_on("qwen2.5-3b", "decode_32k", (2, 2))
    scores = (b // 2) * (cfg.n_heads // 2) * seq * 4 * layers   # float32
    assert args <= rec["bytes_accessed"] <= 4 * args + 16 * scores
    assert rec["collectives"]["all-reduce"] == {
        "count": 2 * layers, "bytes": 2 * layers * (b // 2) * cfg.d_model * 4}
