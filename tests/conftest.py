"""Pytest settings shared by every test file.

``jax.experimental.enable_x64`` was removed in JAX 0.9.0, and the
reference (``repro.kernels.ops``, ``repro.core.engine.shard``,
``tests/test_kernels.py``) still imports it; it is set to
``jax.enable_x64`` when missing, before any test file is collected, so
the reference and its own kernel tests run unchanged as the port's
oracle.  Where JAX is not installed (a machine that runs only the port's
card tests) there is nothing to set.
"""

try:
    import jax
    import jax.experimental
except ImportError:
    jax = None

if jax is not None and not hasattr(jax.experimental, "enable_x64"):
    jax.experimental.enable_x64 = jax.enable_x64


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA card; skips when CUDA is absent")
