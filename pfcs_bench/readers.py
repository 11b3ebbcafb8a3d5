"""Per-layer readers shared between names: a quantity reported in cells
that move different end-to-end metrics has one name for each, and the
files of the later names read it through ``same_as``."""

import importlib.util
from pathlib import Path

METRICS = Path(__file__).resolve().parent / "metrics"


def same_as(name: str):
    """The ``read`` of ``metrics/<name>.py``."""
    spec = importlib.util.spec_from_file_location(
        "pfcs_bench._metric_" + name.replace(".", "_"),
        METRICS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
