"""The port's sharding rules (``repro_torch.sharding.partition``) against
the reference's (``repro.sharding.partition``) on the production mesh
shapes: every parameter, optimizer-state, batch and decode-cache leaf of
every arch's published config gets the reference's spec — on the port's
per-layer leaves the reference's spec minus its leading stack entry
(``models/convert.py::reference_groups`` maps the leaves) — at 16x16 and
2x16x16; the local shard shapes on a fake-group ``DeviceMesh`` (in a
subprocess) equal the reference's ``NamedSharding.shard_shape``; the
warn-once fallback, ``dp_only``, ``seq_shard`` and ``seq_over_model``;
and specs as DTensor placements."""

import torch_parity  # noqa: F401

import json
import logging
import os
import subprocess
import sys

import jax
import pytest
from jax.sharding import NamedSharding as RefSharding

from repro.configs import ARCH_IDS
from repro.configs import SHAPES as REF_SHAPES
from repro.configs import get_config as ref_config
from repro.configs import shape_applies as ref_shape_applies
from repro.models import build_model as ref_build
from repro.sharding import partition as rpt
from repro.training.optimizer import make_optimizer as ref_optimizer
from repro.training.train_loop import abstract_train_state as ref_state
from repro_torch.configs import SHAPES, get_config
from repro_torch.launch.mesh import AbstractMesh
from repro_torch.models import build_model
from repro_torch.models.convert import reference_groups
from repro_torch.sharding import partition as pt
from repro_torch.training.optimizer import make_optimizer
from repro_torch.training.train_loop import abstract_train_state
from repro_torch.training.tree import leaves, leaves_with_path, path_str

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

MESHES = {"pod": ((16, 16), ("data", "model")),
          "multipod": ((2, 16, 16), ("pod", "data", "model"))}


def _ref_mesh(shape, axes):
    from jax.sharding import AbstractMesh as RefAbstractMesh
    try:
        return RefAbstractMesh(tuple(zip(axes, shape)))
    except TypeError:
        return RefAbstractMesh(shape, axes)


def _meshes(name):
    shape, axes = MESHES[name]
    return _ref_mesh(shape, axes), AbstractMesh(shape, axes)


def _ref_specs(shardings):
    """path -> spec tuple of a reference tree of NamedSharding."""
    flat, _ = jax.tree_util.tree_flatten_with_path(
        shardings, is_leaf=lambda x: isinstance(x, RefSharding))
    return {rpt._path_str(p): tuple(s.spec) for p, s in flat}


def _port_specs(shardings):
    return {path_str(p): tuple(s.spec) for p, s in leaves_with_path(
        shardings, is_leaf=lambda x: isinstance(x, pt.NamedSharding))}


def _groups(cfg):
    return {path_str(p): g for p, g in leaves_with_path(
        reference_groups(cfg), is_leaf=lambda x: type(x) is tuple)}


def _param_paths(params):
    return [path_str(p) for p, _ in leaves_with_path(params)]


def _expect_per_layer(ref, port, groups, port_paths, prefix=""):
    """Every port leaf has the spec of the reference leaf it is in: equal
    for an unstacked leaf, minus the stack entry for a stacked one."""
    checked = 0
    for rpath, g in groups.items():
        want = ref[prefix + rpath]
        if type(g) is tuple:
            assert want[:1] in ((), (None,)), (rpath, want)
            for i in g:
                assert port[prefix + port_paths[i]] == want[1:], \
                    (rpath, port_paths[i], want)
                checked += 1
        else:
            assert port[prefix + port_paths[g]] == want, (rpath, want)
            checked += 1
    return checked


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_equal_the_reference(arch, mesh_name):
    rmesh, pmesh = _meshes(mesh_name)
    rcfg, cfg = ref_config(arch), get_config(arch)
    ref = _ref_specs(rpt.params_shardings(ref_build(rcfg).param_specs(),
                                          rmesh, rcfg))
    params = build_model(cfg, device="cpu").param_specs()
    port = _port_specs(pt.params_shardings(params, pmesh, cfg))
    groups = _groups(cfg)
    assert set(groups) == set(ref)
    n = _expect_per_layer(ref, port, groups, _param_paths(params))
    assert n == len(port)


@pytest.mark.parametrize("optimizer", ["adamw", "sgdm", "adafactor"])
@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_opt_state_specs_equal_the_reference(arch, mesh_name, optimizer):
    """AdamW's ``m`` / ``v`` and SGD-momentum's ``mom`` per layer (the
    stack entry dropped), Adafactor's stacked ``vr`` / ``vc`` / ``v`` and
    every ``count`` entry for entry."""
    rmesh, pmesh = _meshes(mesh_name)
    rcfg, cfg = ref_config(arch), get_config(arch)
    rst = ref_state(ref_build(rcfg), ref_optimizer(optimizer))
    ref = _ref_specs(rpt.opt_state_shardings(rst.opt_state, rst.params,
                                             rmesh, rcfg))
    pst = abstract_train_state(build_model(cfg, device="cpu"),
                               make_optimizer(optimizer, cfg))
    port = _port_specs(pt.opt_state_shardings(pst.opt_state, pst.params,
                                              pmesh, cfg))
    assert port["count"] == ref["count"] == ()
    if optimizer == "adafactor":
        assert port == ref
        assert any(s for s in port.values())
        return
    groups, paths = _groups(cfg), _param_paths(pst.params)
    keys = ("m", "v") if optimizer == "adamw" else ("mom",)
    n = sum(_expect_per_layer(ref, port, groups, paths, f"{k}/")
            for k in keys)
    assert n + 1 == len(port)


def _decode_shapes(arch):
    return [s for s in REF_SHAPES
            if s.kind == "decode" and ref_shape_applies(ref_config(arch), s)]


@pytest.mark.parametrize("seq_over_model", [False, True],
                         ids=["base", "seq_over_model"])
@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_specs_equal_the_reference(arch, mesh_name, seq_over_model):
    """The decode cache keeps the reference's stacked layout: equal entry
    for entry, with ``seq_shard`` at batch 1 (long_500k)."""
    rmesh, pmesh = _meshes(mesh_name)
    rcfg, cfg = ref_config(arch), get_config(arch)
    for rshape in _decode_shapes(arch):
        shape = next(s for s in SHAPES if s.name == rshape.name)
        kw = dict(seq_shard=shape.global_batch == 1,
                  seq_over_model=seq_over_model)
        ref = _ref_specs(rpt.cache_shardings(
            ref_build(rcfg).cache_specs(rshape), rmesh, rcfg, **kw))
        port = _port_specs(pt.cache_shardings(
            build_model(cfg, device="cpu").cache_specs(shape), pmesh, cfg,
            **kw))
        assert port == ref, rshape.name


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_batch_specs_equal_the_reference(arch, mesh_name):
    rmesh, pmesh = _meshes(mesh_name)
    rmodel = ref_build(ref_config(arch))
    model = build_model(get_config(arch), device="cpu")
    for rshape, shape in zip(REF_SHAPES, SHAPES):
        for all_axes in (False, True):
            ref = _ref_specs(rpt.batch_shardings(rmodel.input_specs(rshape),
                                                 rmesh, all_axes))
            port = _port_specs(pt.batch_shardings(model.input_specs(shape),
                                                  pmesh, all_axes))
            assert port == ref, (shape.name, all_axes)


@pytest.mark.parametrize("arch", ["xlstm-1.3b", "seamless-m4t-large-v2",
                                  "qwen3-32b"])
def test_dp_only_equals_the_reference(arch):
    """``dp_only``: replicated weights (the reference's minus its stack
    entry) and ZeRO-1 moments over data on the first divisible dim.  The
    reference's first divisible dim of a stacked leaf may be the stack
    itself (qwen3-32b's 64 layers over data=16); the port's per-layer
    leaf has no stack, so there its moment takes its own first divisible
    dim."""
    rmesh, pmesh = _meshes("pod")
    rcfg = ref_config(arch).replace(dp_only=True)
    cfg = get_config(arch).replace(dp_only=True)
    ref = _ref_specs(rpt.params_shardings(ref_build(rcfg).param_specs(),
                                          rmesh, rcfg))
    params = build_model(cfg, device="cpu").param_specs()
    port = _port_specs(pt.params_shardings(params, pmesh, cfg))
    groups, paths = _groups(cfg), _param_paths(params)
    _expect_per_layer(ref, port, groups, paths)
    assert not any("model" in str(s) for s in port.values())
    rst = ref_state(ref_build(rcfg))
    ref_o = _ref_specs(rpt.opt_state_shardings(rst.opt_state, rst.params,
                                               rmesh, rcfg))
    pst = abstract_train_state(build_model(cfg, device="cpu"))
    port_o = _port_specs(pt.opt_state_shardings(pst.opt_state, pst.params,
                                                pmesh, cfg))
    shapes = {path_str(p): tuple(x.shape)
              for p, x in leaves_with_path(pst.opt_state)}
    assert cfg.optimizer == "adamw"
    n_stack = 0
    for key in ("m", "v"):
        for rpath, g in groups.items():
            want = ref_o[f"{key}/{rpath}"]
            for i in (g if type(g) is tuple else (g,)):
                ppath = f"{key}/{paths[i]}"
                if type(g) is tuple and want[:1] == ("data",):
                    n_stack += 1
                    dims = shapes[ppath]
                    d = next((d for d, n in enumerate(dims) if n % 16 == 0),
                             None)
                    want_p = () if d is None else tuple(
                        "data" if i == d else None for i in range(len(dims)))
                else:
                    want_p = want[1:] if type(g) is tuple else want
                assert port_o[ppath] == want_p, (ppath, want)
    # qwen3-32b's 64 layers divide data=16: there the stack is sharded
    assert (n_stack > 0) == (arch == "qwen3-32b")
    assert port_o["count"] == ()


def test_seq_shard_and_split_k_equal_the_reference():
    """Sequence parallelism at batch 1 (zamba2's long_500k) and the
    split-K cache (phi3's 10 KV heads over 16) shard the sequence dim."""
    rmesh, pmesh = _meshes("pod")
    for arch, name, kw in (("zamba2-7b", "long_500k",
                            dict(seq_shard=True)),
                           ("phi3-medium-14b", "decode_32k",
                            dict(seq_over_model=True))):
        rcfg, cfg = ref_config(arch), get_config(arch)
        rshape = next(s for s in REF_SHAPES if s.name == name)
        shape = next(s for s in SHAPES if s.name == name)
        ref = _ref_specs(rpt.cache_shardings(
            ref_build(rcfg).cache_specs(rshape), rmesh, rcfg, **kw))
        port = _port_specs(pt.cache_shardings(
            build_model(cfg, device="cpu").cache_specs(shape), pmesh, cfg,
            **kw))
        assert port == ref
        assert port["k"][2] is not None, (arch, port["k"])


def test_divisibility_fallback_warns_exactly_once(caplog):
    """gemma's single KV head (1 vs model=16) appears in every attention
    block but warns once; a repeat adds nothing; the messages equal the
    reference's."""
    cfg, rcfg = get_config("gemma-2b"), ref_config("gemma-2b")
    params = build_model(cfg, device="cpu").param_specs()
    _, pmesh = _meshes("pod")
    pt.reset_fallback_warnings()
    with caplog.at_level(logging.WARNING, logger=pt.log.name):
        pt.params_shardings(params, pmesh, cfg)
    port_msgs = [r.getMessage() for r in caplog.records
                 if r.name == pt.log.name]
    kv_head = [m for m in port_msgs
               if "dim 1 does not divide" in m and "'model'" in m]
    assert len(kv_head) == 1, port_msgs
    with caplog.at_level(logging.WARNING, logger=pt.log.name):
        pt.params_shardings(params, pmesh, cfg)
    assert len([r for r in caplog.records if r.name == pt.log.name]) \
        == len(port_msgs)
    caplog.clear()
    rpt.reset_fallback_warnings()
    rmesh, _ = _meshes("pod")
    with caplog.at_level(logging.WARNING, logger=rpt.log.name):
        rpt.params_shardings(ref_build(rcfg).param_specs(), rmesh, rcfg)
    assert sorted(r.getMessage() for r in caplog.records
                  if r.name == rpt.log.name) == sorted(port_msgs)
    pt.reset_fallback_warnings()
    rpt.reset_fallback_warnings()


def test_specs_become_placements():
    """One tensor dim over several mesh axes is Shard(d) on each, major
    first; an axis out of mesh order or used twice raises."""
    from torch.distributed.tensor import Replicate, Shard

    _, mesh = _meshes("multipod")
    P, NS = pt.PartitionSpec, pt.NamedSharding
    assert NS(mesh, P(("pod", "data"), None, "model")).placements() == \
        (Shard(0), Shard(0), Shard(2))
    assert NS(mesh, P()).placements() == (Replicate(),) * 3
    assert NS(mesh, P(None, ("data", "model"))).placements() == \
        (Replicate(), Shard(1), Shard(1))
    assert P(("data",), None) == ("data", None)
    assert NS(mesh, P(("pod", "data"), "model")).shard_shape((64, 32)) == \
        (2, 2)
    with pytest.raises(ValueError, match="axis order"):
        NS(mesh, P(("model", "data"))).placements()
    with pytest.raises(ValueError, match="shards two"):
        NS(mesh, P("data", "data")).placements()
    with pytest.raises(ValueError, match="does not divide"):
        NS(mesh, P("model")).shard_shape((8,))


_LOCAL_SHAPES = r"""
import json, sys
import torch
from repro_torch.launch import dryrun
from repro_torch.configs import SHAPES, get_config
from repro_torch.models import build_model
from repro_torch.sharding import partition as pt
from repro_torch.training.tree import leaves_with_path, path_str
from torch.distributed.tensor import distribute_tensor

archs, multi = json.loads(sys.argv[1]), sys.argv[2] == "1"
mesh = dryrun.cell_mesh(multi)
out = {}
for arch in archs:
    cfg = get_config(arch)
    model = build_model(cfg, device="cpu")
    trees = {"params": (model.param_specs(), pt.params_shardings),
             "cache": (model.cache_specs(SHAPES[2]),
                       lambda t, m, c: pt.cache_shardings(t, m, c))}
    for kind, (tree, rule) in trees.items():
        sh = dict((path_str(p), s) for p, s in leaves_with_path(
            rule(tree, mesh, cfg),
            is_leaf=lambda x: isinstance(x, pt.NamedSharding)))
        for p, x in leaves_with_path(tree):
            s = sh[path_str(p)]
            d = distribute_tensor(torch.empty(x.shape, device="meta"),
                                  mesh, s.placements(), src_data_rank=None)
            out[f"{arch}:{kind}:{path_str(p)}"] = list(d.to_local().shape)
print(json.dumps(out))
"""

LOCAL_ARCHS = ["qwen3-32b", "deepseek-v2-236b", "zamba2-7b", "gemma-2b"]


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_local_shapes_on_a_fake_mesh_equal_shard_shape(mesh_name):
    """In a process of its own with a fake group of 256 / 512 ranks: each
    parameter's and decode-cache leaf's local shard shape on the
    production ``DeviceMesh`` equals the reference's
    ``NamedSharding.shard_shape`` (minus the stack dim per layer)."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    res = subprocess.run(
        [sys.executable, "-c", _LOCAL_SHAPES, json.dumps(LOCAL_ARCHS),
         "1" if mesh_name == "multipod" else "0"],
        env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    got = json.loads(res.stdout.strip().splitlines()[-1])
    rmesh, _ = _meshes(mesh_name)
    n = 0
    for arch in LOCAL_ARCHS:
        rcfg, cfg = ref_config(arch), get_config(arch)
        rmodel = ref_build(rcfg)
        params = rmodel.param_specs()
        shards = rpt.params_shardings(params, rmesh, rcfg)
        flat_p = {rpt._path_str(p): x for p, x in
                  jax.tree_util.tree_flatten_with_path(params)[0]}
        flat_s = {rpt._path_str(p): s for p, s in
                  jax.tree_util.tree_flatten_with_path(
                      shards, is_leaf=lambda x: isinstance(x, RefSharding))[0]}
        paths = _param_paths(build_model(cfg, device="cpu").param_specs())
        for rpath, g in _groups(cfg).items():
            want = list(flat_s[rpath].shard_shape(flat_p[rpath].shape))
            for i in (g if type(g) is tuple else (g,)):
                assert got[f"{arch}:params:{paths[i]}"] == \
                    (want[1:] if type(g) is tuple else want), rpath
                n += 1
        cache = rmodel.cache_specs(REF_SHAPES[2])
        csh = rpt.cache_shardings(cache, rmesh, rcfg)
        for (p, x), s in zip(jax.tree_util.tree_flatten_with_path(cache)[0],
                             jax.tree_util.tree_leaves(
                                 csh, is_leaf=lambda x: isinstance(
                                     x, RefSharding))):
            assert got[f"{arch}:cache:{rpt._path_str(p)}"] == \
                list(s.shard_shape(x.shape))
            n += 1
    assert n == len(got)


def test_local_bytes_is_the_specs_arithmetic():
    """``local_bytes``: each leaf's local shard shape times its element
    size, summed."""
    import torch

    _, mesh = _meshes("pod")
    tree = {"a": torch.empty(32, 48, dtype=torch.bfloat16, device="meta"),
            "b": torch.empty(7, device="meta")}
    sh = {"a": pt.NamedSharding(mesh, pt.PartitionSpec("data", "model")),
          "b": pt.replicated(mesh)}
    assert pt.local_bytes(tree, sh) == 2 * 3 * 2 + 7 * 4
    assert len(leaves(sh, is_leaf=lambda x: isinstance(
        x, pt.NamedSharding))) == 2
