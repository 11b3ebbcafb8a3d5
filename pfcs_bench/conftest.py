"""Pytest settings of the benchmark's own tests."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA card; skips when CUDA is absent")
