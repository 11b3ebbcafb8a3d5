"""PFCS kernels for NVIDIA Hopper: hand-written CUDA C++ (``csrc/``)
built for ``sm_90a`` at first use and bound with ``ctypes``.

``factorize.py`` — divisibility mask and squarefree factorization
``gcd.py``       — elementwise gcd
``engine.py``    — the trace engine's scans (a batch of traces through a
                   baseline system or PFCS, one thread block per trace,
                   its state in shared memory where it fits)
``ops.py``       — numpy-in, numpy-out wrappers (padding, int32/int64)
``ref.py``       — the plain PyTorch versions (CPU tensors, and the
                   yardstick the CUDA kernels are checked against)
``cuda.py``      — the ``nvcc`` build, the ``ctypes`` binding and the
                   launch counters
"""

from . import engine, factorize, gcd, ref
from .cuda import KERNELS, build_all, launch_counts, reset_launch_counts
from .ops import (INT32_SAFE_LIMIT, INT64_SAFE_LIMIT, divisibility_scan,
                  divisibility_scan_limbs, factorize_batch,
                  factorize_batch_exact, factorize_batch_limbs, gcd_batch,
                  gcd_batch_exact, gcd_batch_limbs)

__all__ = ["KERNELS", "build_all", "launch_counts", "reset_launch_counts",
           "engine", "factorize", "gcd", "ref", "INT32_SAFE_LIMIT",
           "INT64_SAFE_LIMIT", "divisibility_scan", "divisibility_scan_limbs",
           "factorize_batch", "factorize_batch_exact",
           "factorize_batch_limbs", "gcd_batch", "gcd_batch_exact",
           "gcd_batch_limbs"]
