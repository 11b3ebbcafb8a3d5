"""The dry-run's explicit sharding rules (``repro_torch.launch.dryrun``),
each in a process of its own with a fake group (never in this pytest
worker):

* a layer's recompute (``remat="full"``, every production config's
  policy) runs under the rules, as its forward does: the smoke train
  cells of ``qwen2.5-3b`` and ``zamba2-7b`` trace on a fake 4x4 mesh, with
  more FLOPs than the ``remat="none"`` cell by the layer bodies'
  recompute, and each recompute counted;
* the sLSTM recurrence run on each rank's own rows (``batch_local``)
  counts the FLOPs, bytes and collectives of the same program traced op
  by op on DTensors;
* the einsum, ``@``, ``repeat_interleave`` and reshape rules give the
  placements and local values their docstrings promise, and each is
  counted in ``RULES`` (the artifact's ``rules``);
* a smoke cell traces on a fake 2x2x2 (pod, data, model) mesh, the shape
  of the multi-pod mesh.
"""

import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(script: str, *argv, timeout: float = 300) -> dict:
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    res = subprocess.run([sys.executable, "-c", script, *argv], env=env,
                         capture_output=True, text=True, timeout=timeout)
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


#: a smoke cell traced with a config field and the sequence length set
_CELL = r"""
import dataclasses, json, sys
import repro_torch.configs as configs
from repro_torch.launch import dryrun
arch, shape, field, values, seq, mesh = sys.argv[1:7]
mesh = tuple(int(n) for n in mesh.split("x"))
smoke = configs.get_smoke
configs.SHAPES = [dataclasses.replace(s, seq_len=int(seq))
                  if s.name == shape and int(seq) else s
                  for s in configs.SHAPES]
recs = {}
for value in values.split(","):
    configs.get_smoke = lambda a, v=value: smoke(a).replace(**{field: v})
    recs[value] = dryrun.trace_cell(arch, shape, False, smoke=True,
                                    mesh_shape=mesh)
print(json.dumps(recs))
"""


@pytest.mark.parametrize("arch,seq,recomputed", [("qwen2.5-3b", 0, 2),
                                                 ("zamba2-7b", 512, 4)])
def test_remat_cells_trace_under_the_rules(arch, seq, recomputed):
    """``remat="full"`` recomputes each layer body (qwen: its 2 layers;
    zamba2: its 4 Mamba-2 layers) in the backward pass under the rules:
    the cell traces (on the parent, the recompute escaped them and the
    qwen cell failed on an in-place add to a pending sum), its FLOPs
    exceed ``remat="none"``'s by less than a second forward and backward,
    and its collectives are counted."""
    recs = _run(_CELL, arch, "train_4k", "remat", "full,none", str(seq),
                "4x4")
    full, none = recs["full"], recs["none"]
    assert full["rules"]["recompute"] == recomputed
    assert "recompute" not in none["rules"]
    assert none["flops"] < full["flops"] < 2 * none["flops"]
    for rec in (full, none):
        assert rec["collectives"]["all-reduce"]["count"] >= 1
        assert all(v["bytes"] > 0 for v in rec["collectives"].values())
        assert rec["rules"]["einsum"] >= 1 and rec["rules"]["reduce"] >= 1
    assert full["memory"]["temp_size_in_bytes"] < \
        none["memory"]["temp_size_in_bytes"]


_SLSTM = r"""
import dataclasses, functools, json, sys
import repro_torch.configs as configs
from repro_torch.launch import dryrun
shape, seq = sys.argv[1], int(sys.argv[2])
configs.SHAPES = [dataclasses.replace(s, seq_len=seq) if s.name == shape
                  else s for s in configs.SHAPES]
fast = dryrun.trace_cell("xlstm-1.3b", shape, False, smoke=True,
                         mesh_shape=(4, 4))
dryrun._batch_local = functools.partial(dryrun._batch_local, local=False)
steps = dryrun.trace_cell("xlstm-1.3b", shape, False, smoke=True,
                          mesh_shape=(4, 4))
print(json.dumps({"fast": fast, "steps": steps}))
"""


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k"])
def test_slstm_fast_path_counts_as_the_step_by_step_trace(shape):
    """The xLSTM smoke model (2 sLSTM blocks) at a 16-step sequence: its
    sLSTM recurrences run on each rank's local rows as plain tensors give
    the FLOPs, bytes and collectives of the same recurrences traced op by
    op on DTensors, forward and (for the train step) backward."""
    recs = _run(_SLSTM, shape, "16")
    fast, steps = recs["fast"], recs["steps"]
    for rec in (fast, steps):
        assert rec["rules"]["batch_local"] == 2
    assert fast["flops"] == steps["flops"] > 0
    assert fast["bytes_accessed"] == steps["bytes_accessed"] > 0
    assert fast["collectives"] == steps["collectives"]
    assert steps["rules"]["einsum"] > fast["rules"]["einsum"]


_RULES = r"""
import json
import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from repro_torch.launch import dryrun

mesh = dryrun.cell_mesh(False, (4, 4))          # this process is rank 0
gen = torch.Generator().manual_seed(0)
out = {}


def dt(x, placements):
    # rank 0's shard of a global x: the first block of each sharded dim
    local = x
    for i, p in enumerate(placements):
        if isinstance(p, Shard):
            local = local.narrow(p.dim, 0, local.shape[p.dim] // 4)
    return DTensor.from_local(local.contiguous(), mesh, placements,
                              run_check=False, shape=x.shape,
                              stride=x.contiguous().stride())


def first(x, placements):
    return dt(x, placements).to_local()


def names(placements):
    return ["S%d" % p.dim if type(p) is Shard else
            "P" if p.is_partial() else "R" for p in placements]


def case(name, fn):
    dryrun.RULES.clear()
    c = dryrun.Census()
    with dryrun.SpmdRules(), c:
        res = fn()
    res["rules"] = dict(dryrun.RULES)
    res["collectives"] = c.collectives
    out[name] = res


def rnd(*shape):
    return torch.randn(*shape, generator=gen, dtype=torch.float64)


# GQA scores: batch over data, kv heads over model on both operands
q, k = rnd(8, 3, 4, 2, 5), rnd(8, 6, 4, 5)
qp = kp = [Shard(0), Shard(2)]
g = rnd(8, 4, 2, 3, 6)


def gqa():
    qd = dt(q, qp).requires_grad_(True)
    kd = dt(k, kp).requires_grad_(True)
    s = torch.einsum("bqkgd,bskd->bkgqs", qd, kd)
    gq, gk = torch.autograd.grad(s, (qd, kd), dt(g, [Shard(0), Shard(1)]))
    want = torch.einsum("bqkgd,bskd->bkgqs", q, k)
    want_gq = torch.einsum("bkgqs,bskd->bqkgd", g, k)
    return {"placements": names(s.placements),
            "grad_placements": names(gq.placements + gk.placements),
            "equal": torch.allclose(s.to_local(), first(want, s.placements)),
            "grad_equal": torch.allclose(gq.to_local(),
                                         first(want_gq, gq.placements))}


case("gqa", gqa)

# the sLSTM's recurrent product, its contracted dim over model on both
h, w = rnd(8, 4, 12), rnd(4, 12, 16)


def contracted():
    r = torch.einsum("bhk,hkg->bhg", dt(h, [Shard(0), Shard(2)]),
                     dt(w, [Replicate(), Shard(1)]))
    part = torch.einsum("bhk,hkg->bhg", h[:2, :, :3], w[:, :3])
    return {"placements": names(r.placements),
            "equal": torch.allclose(r.to_local(), part)}


case("contracted", contracted)


# one operand whole, the other sharded on a shared letter: a local slice
def sliced():
    r = torch.einsum("bhk,hkg->bhg", dt(h, [Replicate(), Replicate()]),
                     dt(w, [Replicate(), Shard(0)]))
    return {"placements": names(r.placements),
            "equal": torch.allclose(
                r.to_local(), torch.einsum("bhk,hkg->bhg", h, w)[:, :1])}


case("sliced", sliced)


# both sharded over model on letters of their own: the smaller gathered
def conflict():
    r = torch.einsum("bn,nd->bd", dt(rnd(8, 12), [Replicate(), Shard(0)]),
                     dt(rnd(12, 40), [Replicate(), Shard(1)]))
    return {"placements": names(r.placements)}


case("conflict", conflict)

# x @ w of a 3-D x: batch-sharded (the fold keeps it), and sequence-sharded
# with a batch of 2 before it (the fold gathers it)
x, wm = rnd(8, 6, 12), rnd(12, 5)


def matmul(pl):
    def run():
        y = dt(x, pl) @ dt(wm, [Replicate(), Replicate()])
        return {"placements": names(y.placements),
                "shape": list(y.shape),
                "equal": torch.allclose(y.to_local(), first(x @ wm,
                                                            y.placements))}
    return run


case("matmul_batch", matmul([Shard(0), Replicate()]))
case("matmul_seq", matmul([Shard(1), Replicate()]))


# repeat_interleave of heads over model: the merge by the reshape rule
hx, gr = rnd(2, 3, 4, 5), rnd(2, 3, 8, 5)


def repeat():
    xd = dt(hx, [Replicate(), Shard(2)]).requires_grad_(True)
    r = torch.repeat_interleave(xd, 2, dim=2)
    (gx,) = torch.autograd.grad(r, (xd,), dt(gr, [Replicate(), Shard(2)]))
    want = torch.repeat_interleave(hx, 2, dim=2)
    want_g = gr.reshape(2, 3, 4, 2, 5).sum(3)
    return {"shape": list(r.shape),
            "placements": names(r.placements),
            "equal": torch.equal(r.to_local(), first(want, r.placements)),
            "grad_equal": torch.allclose(gx.to_local(),
                                         first(want_g, gx.placements))}


case("repeat", repeat)

# an embedding lookup: ids split over data, the table whole or split
tab = rnd(12, 6)
ids = torch.randint(0, 12, (8, 3), generator=gen)
gl = rnd(8, 3, 6)


def lookup(table_pl):
    def run():
        td = dt(tab, table_pl).requires_grad_(True)
        r = td[dt(ids, [Shard(0), Replicate()])]
        (gt,) = torch.autograd.grad(r, (td,), dt(gl, [Shard(0), Replicate()]))
        want_g = torch.zeros(12, 6, dtype=gl.dtype).index_put_(
            (ids[:2],), gl[:2], accumulate=True)
        return {"placements": names(r.placements),
                "grad_placements": names(gt.placements),
                "equal": torch.equal(r.to_local(), tab[ids[:2]]),
                "grad_equal": torch.allclose(gt.to_local(),
                                             first(want_g, gt.placements))}
    return run


case("lookup", lookup([Replicate(), Replicate()]))
case("lookup_split", lookup([Replicate(), Shard(0)]))
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def rules():
    return _run(_RULES)


def test_einsum_rule_keeps_shared_shards_local(rules):
    """Batch and kv heads sharded on both GQA operands: each rank's
    einsum of its own shards is its block of the whole, the output keeps
    both shards, the gradients the operands' placements, and nothing
    moves."""
    r = rules["gqa"]
    assert r["placements"] == ["S0", "S1"]
    assert r["grad_placements"] == ["S0", "S2"] * 2
    assert r["equal"] and r["grad_equal"]
    assert r["rules"] == {"einsum": 1}
    assert r["collectives"] == {}


def test_einsum_rule_leaves_a_pending_sum_for_a_sharded_contraction(rules):
    r = rules["contracted"]
    assert r["placements"] == ["S0", "P"]
    assert r["equal"] and r["rules"] == {"einsum": 1}
    assert r["collectives"] == {}


def test_einsum_rule_slices_a_whole_operand_locally(rules):
    r = rules["sliced"]
    assert r["placements"] == ["R", "S1"]
    assert r["equal"] and r["rules"] == {"einsum": 1}
    assert r["collectives"] == {}


def test_einsum_rule_gathers_the_smaller_of_two_conflicting_operands(rules):
    r = rules["conflict"]
    assert r["placements"] == ["R", "S1"]
    assert r["rules"] == {"einsum": 1}
    assert r["collectives"]["all-gather"]["count"] == 1


def test_matmul_rule_folds_through_the_reshape_rule(rules):
    """A batch-sharded ``x @ w`` folds without a gather; a sequence-
    sharded one (its dim does not lead the fold) is gathered by the
    reshape rule, counted."""
    batch, seq = rules["matmul_batch"], rules["matmul_seq"]
    assert batch["placements"] == ["S0", "R"]
    assert batch["rules"] == {"matmul": 1} and batch["collectives"] == {}
    assert seq["rules"] == {"matmul": 1, "reshape": 1}
    assert seq["collectives"]["all-gather"]["count"] == 1
    assert batch["shape"] == seq["shape"] == [8, 6, 5]
    assert batch["equal"]       # (a fake group's gather moves no values)


def test_repeat_rule_merges_through_the_reshape_rule(rules):
    """Heads sharded over model, each repeated twice: the merged dim
    keeps the shard (its leading dim divides), and so does the backward's
    split of the gradient, each rank's block equal to the whole's."""
    r = rules["repeat"]
    assert r["shape"] == [2, 3, 8, 5]
    assert r["placements"] == ["R", "S2"]
    assert r["equal"] and r["grad_equal"]
    assert r["rules"] == {"repeat": 1} and r["collectives"] == {}


def test_lookup_rule_keeps_the_ids_where_they_lie(rules):
    """Ids split over data: each rank looks up its own ids in the whole
    table (a vocab-split table is gathered first), its rows' gradient a
    local scatter-add pending a sum over data, then split back as the
    table was (DTensor resolves the pending sum on the way)."""
    whole, split = rules["lookup"], rules["lookup_split"]
    for r in (whole, split):
        assert r["placements"] == ["S0", "R"]
        assert r["rules"] == {"lookup": 1}
    assert whole["equal"] and whole["grad_equal"]
    assert whole["grad_placements"] == ["P", "R"]
    assert whole["collectives"] == {}
    # the gather's backward splits the gradient back, its sum over data
    # resolved on the way
    assert split["grad_placements"] == ["R", "S0"]
    assert split["collectives"]["all-gather"]["count"] == 1


_MULTI = r"""
import json
from repro_torch.launch import dryrun
print(json.dumps([dryrun.trace_cell("qwen2.5-3b", shape, True, smoke=True,
                                    mesh_shape=(2, 2, 2))
                  for shape in ("decode_32k", "train_4k")]))
"""


def test_smoke_cells_on_a_fake_multi_pod_shaped_mesh():
    """The (pod, data, model) mesh at 2x2x2: the batch sharded over pod
    and data, a decode and a train cell trace, the train step's gradients
    reduced over both batch axes."""
    decode, train = _run(_MULTI)
    for rec in (decode, train):
        assert rec["n_devices"] == 8
        assert rec["flops"] > 0 and rec["bytes_accessed"] > 0
        assert rec["collectives"]["all-reduce"]["count"] >= 1
    assert decode["rules"]["row_write"] == 4
    assert train["rules"]["einsum"] >= 1
