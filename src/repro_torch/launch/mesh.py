"""Production mesh construction (port of ``repro.launch.mesh``).

Defined as FUNCTIONS (never module-level state) so importing this module
starts no process group: the dry-run starts a fake group of 256 or 512
ranks in a process of its own, and tests and the serving paths must keep
seeing the group they started, or none.

The reference's ``jax.make_mesh`` lays out the devices a JAX process
sees.  The port's counterpart is a ``torch.distributed`` process group:
:func:`init_distributed` starts it from ``torchrun``'s environment, and
the mesh functions lay its ranks out as a
``torch.distributed.device_mesh.DeviceMesh``.  Neither mesh function
starts a group itself; a world that does not match the mesh raises
``ValueError``, as ``jax.make_mesh`` raises on the wrong device count.

:class:`AbstractMesh` is the counterpart of ``jax.sharding.AbstractMesh``:
axis names and sizes, no ranks, no group (what
:mod:`repro_torch.sharding.partition`'s rules need to choose specs).
"""

from __future__ import annotations

import os
from datetime import timedelta
from typing import Dict, Optional, Sequence, Tuple

import torch

__all__ = ["make_production_mesh", "make_local_mesh", "make_mesh",
           "AbstractMesh", "HW", "init_distributed", "DEFAULT_TIMEOUT"]

#: every process group the port starts waits at most this long for a peer
DEFAULT_TIMEOUT = timedelta(seconds=60)


class AbstractMesh:
    """Axis names and sizes with no ranks behind them (the counterpart of
    ``jax.sharding.AbstractMesh``): enough to choose partition specs and
    local shard shapes."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str]):
        if len(shape) != len(axis_names):
            raise ValueError(f"{len(shape)} sizes for {len(axis_names)} axes")
        self.axis_names: Tuple[str, ...] = tuple(axis_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names,
                                              (int(s) for s in shape)))

    def size(self) -> int:
        n = 1
        for s in self.shape.values():
            n *= s
        return n

    def __repr__(self) -> str:
        return f"AbstractMesh({self.shape})"


def _mesh_device_type() -> str:
    """The device type of a mesh over the started group: ``"cuda"`` where
    its backend is NCCL (the collectives run on the card), else ``"cpu"``
    (gloo and the dry-run's fake backend move host tensors)."""
    import torch.distributed as dist

    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_mesh(shape: Sequence[int], axes: Sequence[str]):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over the first
    ``prod(shape)`` ranks of the started group, row-major (rank ``i`` at
    the ``i``-th position).  Every rank of the group calls it (it makes
    the mesh's sub-groups); a rank outside the mesh gets a mesh on which
    ``get_coordinate()`` is ``None``.  Raises ``ValueError`` when no group
    is started or the group has fewer ranks than the mesh."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    n = 1
    for s in shape:
        n *= int(s)
    world = dist.get_world_size() if dist.is_initialized() else 0
    if world < n:
        raise ValueError(
            f"a mesh of shape {tuple(shape)} needs {n} ranks; "
            + (f"the process group has {world}" if world else
               "no process group is started (init_distributed)"))
    return DeviceMesh(_mesh_device_type(),
                      torch.arange(n).reshape(tuple(int(s) for s in shape)),
                      mesh_dim_names=tuple(axes))


def _whole_world(shape, axes):
    import torch.distributed as dist

    n = 1
    for s in shape:
        n *= s
    if dist.is_initialized() and dist.get_world_size() != n:
        raise ValueError(f"a mesh of shape {shape} needs a world of {n} "
                         f"ranks; the process group has "
                         f"{dist.get_world_size()}")
    return make_mesh(shape, axes)


def make_production_mesh(*, multi_pod: bool = False):
    """Single pod: (data=16, model=16) = 256 ranks.
    Multi-pod: (pod=2, data=16, model=16) = 512 ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _whole_world(shape, axes)


def make_local_mesh():
    """Every rank of the started group on a (data=1, model=world) mesh
    (tests/examples)."""
    import torch.distributed as dist

    if not dist.is_initialized():
        raise ValueError("no process group is started (init_distributed)")
    return _whole_world((1, dist.get_world_size()), ("data", "model"))


def init_distributed(backend: str, device="cuda",
                     init_method: Optional[str] = None,
                     timeout: timedelta = DEFAULT_TIMEOUT) -> torch.device:
    """Start the default process group from ``torchrun``'s environment
    (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, and
    ``MASTER_ADDR`` / ``MASTER_PORT`` unless ``init_method`` names another
    rendezvous, e.g. ``file://`` a path) with ``backend``, and return this
    rank's device: ``cuda:{LOCAL_RANK % device_count}`` (made current), or
    the CPU for ``device="cpu"``.

    Nothing switches backend on its own: ``nccl`` needs a card per rank
    of the node, and asking for it with more ranks than cards (NCCL
    refuses two ranks on one device) raises ``RuntimeError`` naming the
    card; ranks that share a card ask for ``gloo``."""
    import torch.distributed as dist

    from repro_torch.device import resolve_device

    if dist.is_initialized():
        raise RuntimeError("a process group is already started")
    try:
        rank = int(os.environ["RANK"])
        world = int(os.environ["WORLD_SIZE"])
    except KeyError as exc:
        raise RuntimeError(f"init_distributed reads torchrun's environment; "
                           f"{exc.args[0]} is not set") from None
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    dev = resolve_device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", local_rank % torch.cuda.device_count())
    if backend == "nccl":
        if dev.type != "cuda":
            raise RuntimeError("backend 'nccl' runs on the card; "
                               "device='cpu' asks for 'gloo'")
        if local_world > torch.cuda.device_count():
            raise RuntimeError(
                f"backend 'nccl' with {local_world} ranks on "
                f"{torch.cuda.device_count()} card(s) "
                f"({torch.cuda.get_device_name(dev)}): NCCL refuses two "
                f"ranks on one device; ranks that share a card use 'gloo'")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=init_method or "env://",
                            rank=rank, world_size=world, timeout=timeout)
    return dev


class HW:
    """NVIDIA H100 SXM hardware constants for the roofline model (per
    card).  Sources: NVIDIA's H100 Tensor Core GPU data sheet (SXM5 part,
    dense rates without sparsity, at its 700 W limit): the bf16 peak, the
    HBM3 bandwidth, the NVLink bandwidth (900 GB/s total per GPU, 450 GB/s
    each way) and the 80 GB of HBM (``chip_smoke.py`` prints
    ``torch.cuda.get_device_properties(0).total_memory`` beside it)."""

    PEAK_BF16_FLOPS = 989e12     # FLOP/s, dense
    HBM_BW = 3.35e12             # bytes/s
    NVLINK_BW = 450e9            # bytes/s per direction
    HBM_BYTES = 80 * 10**9       # bytes (80 GB)
