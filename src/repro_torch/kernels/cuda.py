"""Build and bind the hand-written CUDA kernels under ``csrc/``.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled on its own
into ``<build dir>/<name>-<hash>.so`` at first use, by
``nvcc -gencode arch=compute_90a,code=sm_90a`` (Hopper), then loaded with
``ctypes``.  The hash covers the source and the flags, so an edited source
builds anew and an unchanged one is reused.  ``build_all`` starts one
``nvcc`` per source at once; the kernels' first launch otherwise builds
its own library.  Nothing here runs at import time.

The build directory is ``build/`` beside this module (gitignored).
``nvcc`` keeps its own temporary files inside it.  Every failure to find
``nvcc``, to make or write the directory or to compile raises, naming
what was tried.

Every C entry point returns ``cudaGetLastError()`` after its launch; the
binding raises on a non-zero code.  ``CudaKernel.launches`` counts the
launches that were made, so a run can show which kernels its path took.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, List, NamedTuple, Optional, Sequence

import torch

__all__ = ["BUILD_DIR", "CudaKernel", "KERNELS", "NVCC_FLAGS", "build_all",
           "build_dir", "launch_counts", "nvcc_path", "reset_launch_counts"]

CSRC = Path(__file__).resolve().parent / "csrc"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
#: where the kernels' libraries are built (gitignored)
BUILD_DIR = Path(__file__).resolve().parent / "build"

#: every kernel of the port, by name (filled as the kernel modules load)
KERNELS: Dict[str, "CudaKernel"] = {}


def nvcc_path() -> str:
    """The ``nvcc`` to build with: the first found on ``PATH``, under
    ``$CUDA_HOME`` / ``$CUDA_PATH``, under PyTorch's idea of the CUDA
    home (``torch.utils.cpp_extension.CUDA_HOME``), then under
    ``/usr/local/cuda``.  Raises ``RuntimeError`` listing every place
    tried when none has it."""
    tried: List[str] = ["PATH"]
    found = shutil.which("nvcc")
    if found:
        return found
    homes = [("CUDA_HOME", os.environ.get("CUDA_HOME")),
             ("CUDA_PATH", os.environ.get("CUDA_PATH"))]
    from torch.utils import cpp_extension
    homes.append(("torch.utils.cpp_extension.CUDA_HOME",
                  cpp_extension.CUDA_HOME))
    homes.append(("default", "/usr/local/cuda"))
    for label, home in homes:
        if not home:
            tried.append(f"{label} (unset)")
            continue
        cand = os.path.join(home, "bin", "nvcc")
        tried.append(f"{label}: {cand}")
        if os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError("nvcc not found; tried " + "; ".join(tried))


def build_dir() -> Path:
    """``BUILD_DIR``, made here if need be.  Raises ``RuntimeError``
    naming it when it cannot be created, cannot be written, or is on a
    ``noexec`` mount (a library there could not be loaded)."""
    path = BUILD_DIR
    try:
        path.mkdir(parents=True, exist_ok=True)
    except OSError as e:
        fault = f"cannot be created ({e})"
    else:
        if not os.access(path, os.W_OK | os.X_OK):
            fault = "is not writable"
        elif os.statvfs(path).f_flag & os.ST_NOEXEC:
            fault = "is on a noexec mount (a library there cannot be loaded)"
        else:
            return path
    raise RuntimeError(f"kernel build directory {path} {fault}")


class _Build(NamedTuple):
    proc: subprocess.Popen
    tmp: Path
    lib: Path
    scratch: Path


class CudaKernel:
    """One ``csrc`` source, its C entry point and its launch count."""

    def __init__(self, name: str, source: str, symbol: str,
                 argtypes: Sequence):
        self.name = name
        self.source = CSRC / source
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.launches = 0
        self._fn = None
        self._err = None
        KERNELS[name] = self

    def library_path(self) -> Path:
        key = hashlib.sha256(self.source.read_bytes()
                             + " ".join(NVCC_FLAGS).encode()).hexdigest()
        return build_dir() / f"{self.source.stem}-{key[:16]}.so"

    def start_build(self) -> Optional[_Build]:
        """Start ``nvcc`` for this source unless its library exists;
        returns the running build (or ``None``).  The library is written
        under a temporary name and renamed into place when complete."""
        lib = self.library_path()
        if lib.exists():
            return None
        nvcc = nvcc_path()
        tmp = lib.with_name(f".{lib.name}.{os.getpid()}.tmp")
        # nvcc's own temporary files, one directory per build: the builds
        # of build_all run at once and each removes its directory when done
        scratch = lib.parent / f"tmp-{lib.stem}-{os.getpid()}"
        scratch.mkdir(exist_ok=True)
        with open(lib.with_suffix(".log"), "w") as log:
            proc = subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(self.source)],
                stdout=log, stderr=subprocess.STDOUT,
                env=dict(os.environ, TMPDIR=str(scratch)))
        return _Build(proc, tmp, lib, scratch)

    def build_log(self) -> str:
        """The compiler's output of the last build (``-Xptxas -v``:
        registers, shared memory and spills of each kernel)."""
        log = self.library_path().with_suffix(".log")
        return log.read_text() if log.exists() else ""

    def _load(self):
        if self._fn is None:
            _finish([self.start_build()])
            lib = ctypes.CDLL(str(self.library_path()))
            fn = getattr(lib, self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            err = getattr(lib, self.symbol + "_error")
            err.argtypes = [ctypes.c_int]
            err.restype = ctypes.c_char_p
            self._fn, self._err = fn, err
        return self._fn

    def launch(self, device: torch.device, *args) -> None:
        """Call the C entry point on ``device``'s current stream (the
        stream is appended as the last argument) and count the launch."""
        fn = self._load()
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            rc = fn(*args, stream)
        if rc != 0:
            raise RuntimeError(f"{self.name}: CUDA launch failed with error "
                               f"{rc} ({self._err(rc).decode()})")
        self.launches += 1


def _finish(builds: Iterable[Optional[_Build]]) -> None:
    failed: List[str] = []
    for b in builds:
        if b is None:
            continue
        rc = b.proc.wait()
        shutil.rmtree(b.scratch, ignore_errors=True)
        if rc == 0 and b.tmp.exists():
            os.replace(b.tmp, b.lib)
        else:
            log = b.lib.with_suffix(".log")
            failed.append(f"{b.proc.args[-1]} (nvcc exit {rc}):\n"
                          f"{log.read_text() if log.exists() else ''}")
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))


def build_all() -> float:
    """Build every kernel's library, one ``nvcc`` per source started
    together; returns the seconds it took."""
    t0 = time.perf_counter()
    builds: List[Optional[_Build]] = []
    try:
        for k in KERNELS.values():
            builds.append(k.start_build())
        _finish(builds)
    finally:
        for b in builds:
            if b is not None and b.proc.poll() is None:
                b.proc.kill()
                b.proc.wait()
    return time.perf_counter() - t0


def launch_counts() -> Dict[str, int]:
    return {name: k.launches for name, k in KERNELS.items()}


def reset_launch_counts() -> None:
    for k in KERNELS.values():
        k.launches = 0
