"""Checkpointing with atomic commit, restore, and retention (port of
``repro.training.checkpoint``).

The reference's on-disk format:

  * every leaf of the tree is a raw ``.npy`` file under ``step_<N>.tmp/``
    (named by ``_leaf_filename`` of its path); a JSON manifest records the
    step and each leaf's file, shape, dtype and a content checksum
    (``sha256_16``: the first 16 hex digits of the SHA-256 of its bytes).
  * Commit is atomic: each file is fsync'd, the ``.tmp`` directory renamed
    to ``step_<N>/`` and ``LATEST`` updated last — a crash mid-write can
    never leave a readable-but-corrupt checkpoint (restart picks up the
    last committed step).
  * ``keep_last`` retention prunes old steps after each successful commit.

Async mode: ``save(..., blocking=False)`` copies every tensor to host
memory, then writes on a worker thread, overlapping I/O with the next
train step.  The copy is made before ``save`` returns, because the port's
train step updates its tensors in place (on the CPU, ``Tensor.numpy()``
would share their storage).

A bfloat16 leaf (numpy has no such dtype without ``ml_dtypes``) is stored
as its 16-bit patterns (``uint16``), its manifest dtype ``"bfloat16"``
and its checksum over those bytes; ``restore`` gives it back bit for bit.

Not mirrored: the manifest's ``treedef`` string (a JAX pytree repr) is
written as the port's tree's type.  ``restore`` writes the checkpoint
into the target tree's tensors in place (the train state's own tensors,
as the train step updates them) and returns that tree; with
``shardings=`` (elastic re-shard onto a mesh) it returns a new tree whose
sharded leaves are DTensors built from the rows of each ``.npy``
that this rank owns (read through a memory map: the counterpart of the
reference's ``make_array_from_callback``).
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from .tree import leaves_with_path, path_str, tree_map

__all__ = ["CheckpointManager"]


def _leaf_filename(path_s: str) -> str:
    h = hashlib.sha1(path_s.encode()).hexdigest()[:12]
    safe = path_s.replace("/", ".")[:80]
    return f"{safe}.{h}.npy"


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """A host copy of ``t`` as numpy (a bfloat16 tensor as its bits)."""
    host = t.detach().to("cpu", copy=True)
    if host.dtype == torch.bfloat16:
        return host.view(torch.int16).numpy().view(np.uint16)
    return host.numpy()


def _from_numpy(arr: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
    if dtype == torch.bfloat16:
        return torch.from_numpy(arr.view(np.int16)).view(dtype)
    return torch.from_numpy(arr)


def _checksum(arr: np.ndarray) -> str:
    return hashlib.sha256(arr.tobytes()).hexdigest()[:16]


def _shardings_by_path(shardings) -> Dict[str, Any]:
    if shardings is None:
        return {}
    from repro_torch.sharding.partition import NamedSharding

    return {path_str(p): s for p, s in leaves_with_path(
        shardings, is_leaf=lambda x: isinstance(x, NamedSharding))}


def _dtensor_from(arr: np.ndarray, sharding, ref: torch.Tensor):
    """A ``DTensor`` of ``arr`` placed by ``sharding``, its local shard
    read from this rank's block of rows (on ``ref``'s device)."""
    from torch.distributed.tensor import DTensor

    from repro_torch.sharding.partition import local_block

    local = np.ascontiguousarray(arr[local_block(sharding, arr.shape)])
    t = _from_numpy(local, ref.dtype).to(ref.device)
    return DTensor.from_local(t, sharding.mesh, sharding.placements(),
                              run_check=False, shape=tuple(arr.shape),
                              stride=tuple(ref.stride()))


class CheckpointManager:
    def __init__(self, directory: str | Path, keep_last: int = 3):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep_last = keep_last
        self._worker: Optional[threading.Thread] = None

    # ------------------------------------------------------------------ #
    # save                                                                #
    # ------------------------------------------------------------------ #

    def save(self, step: int, tree: Any, blocking: bool = True) -> Path:
        """Snapshot ``tree`` (a tree of tensors) at ``step``."""
        # the host copy first (the next step updates the tensors in
        # place): the only synchronous part of async mode
        host: List[Tuple[str, np.ndarray, str]] = [
            (path_str(path), _to_numpy(x), _dtype_name(x.dtype))
            for path, x in leaves_with_path(tree)]
        kind = type(tree).__name__
        if blocking:
            return self._write(step, host, kind)
        self.wait()  # one in-flight checkpoint at a time
        self._worker = threading.Thread(target=self._write,
                                        args=(step, host, kind), daemon=True)
        self._worker.start()
        return self.dir / f"step_{step:08d}"

    def wait(self) -> None:
        if self._worker is not None:
            self._worker.join()
            self._worker = None

    def _write(self, step: int, leaves, treedef_str: str) -> Path:
        final = self.dir / f"step_{step:08d}"
        tmp = self.dir / f"step_{step:08d}.tmp"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        manifest: Dict[str, Any] = {"step": step, "treedef": treedef_str,
                                    "leaves": {}}
        for path_s, arr, dtype in leaves:
            fn = _leaf_filename(path_s)
            fp = tmp / fn
            with open(fp, "wb") as f:
                np.save(f, arr)
                f.flush()
                os.fsync(f.fileno())
            manifest["leaves"][path_s] = {
                "file": fn,
                "shape": list(arr.shape),
                "dtype": dtype,
                "sha256_16": _checksum(arr),
            }
        mf = tmp / "manifest.json"
        mf.write_text(json.dumps(manifest, indent=1))
        if final.exists():
            shutil.rmtree(final)
        os.replace(tmp, final)                      # atomic commit
        (self.dir / "LATEST.tmp").write_text(str(step))
        os.replace(self.dir / "LATEST.tmp", self.dir / "LATEST")
        self._retain()
        return final

    def _retain(self) -> None:
        steps = sorted(self.all_steps())
        for s in steps[: max(0, len(steps) - self.keep_last)]:
            shutil.rmtree(self.dir / f"step_{s:08d}", ignore_errors=True)

    # ------------------------------------------------------------------ #
    # restore                                                             #
    # ------------------------------------------------------------------ #

    def all_steps(self) -> List[int]:
        out = []
        for p in self.dir.glob("step_*"):
            if p.is_dir() and not p.name.endswith(".tmp") and \
                    (p / "manifest.json").exists():
                out.append(int(p.name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        latest = self.dir / "LATEST"
        if latest.exists():
            s = int(latest.read_text().strip())
            if (self.dir / f"step_{s:08d}" / "manifest.json").exists():
                return s
        steps = self.all_steps()
        return steps[-1] if steps else None

    @torch.no_grad()
    def restore(self, target_tree: Any, step: Optional[int] = None,
                shardings: Any = None, verify: bool = False) -> Any:
        """Restore into ``target_tree``'s tensors (in place) and return it.

        Every leaf of the target must be in the checkpoint with its shape
        and dtype; ``verify`` checks each file's checksum first.
        ``shardings``: a tree of
        :class:`~repro_torch.sharding.partition.NamedSharding` matching
        the target (or a sub-tree of its paths); its leaves come back as
        DTensors holding this rank's rows, in a new tree (the
        other leaves are restored in place).
        """
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.dir}")
        cdir = self.dir / f"step_{step:08d}"
        manifest = json.loads((cdir / "manifest.json").read_text())
        shard_of = _shardings_by_path(shardings)

        def load(path_s: str, ref: torch.Tensor):
            meta = manifest["leaves"].get(path_s)
            if meta is None:
                raise KeyError(f"checkpoint missing leaf {path_s}")
            sharding = shard_of.get(path_s)
            arr = np.load(cdir / meta["file"],
                          mmap_mode="r" if sharding is not None and
                          not verify else None)
            if verify and _checksum(arr) != meta["sha256_16"]:
                raise IOError(f"checksum mismatch for {path_s}")
            if tuple(arr.shape) != tuple(ref.shape):
                raise ValueError(
                    f"shape mismatch {path_s}: ckpt {arr.shape} vs "
                    f"{tuple(ref.shape)}")
            if meta["dtype"] != _dtype_name(ref.dtype):
                raise ValueError(
                    f"dtype mismatch {path_s}: ckpt {meta['dtype']} vs "
                    f"{_dtype_name(ref.dtype)}")
            if sharding is not None:
                return _dtensor_from(arr, sharding, ref)
            ref.copy_(_from_numpy(arr, ref.dtype))
            return ref

        paths = [path_str(p) for p, _ in leaves_with_path(target_tree)]
        if not shard_of:
            for path_s, (_, ref) in zip(paths,
                                        leaves_with_path(target_tree)):
                load(path_s, ref)
            return target_tree
        it = iter(paths)
        return tree_map(lambda ref: load(next(it), ref), target_tree)
