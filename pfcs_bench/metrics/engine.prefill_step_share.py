"""Share of the window's model calls that were single-slot prefill steps
(``ServingEngine._step_slot``), by the benchmark's counters at the
engine's boundary: each prompt token costs a whole-batch model call."""


def read(run):
    w = run["window"]
    if not w["model_calls"]:
        return None
    return 100.0 * w["prefill_calls"] / w["model_calls"]
