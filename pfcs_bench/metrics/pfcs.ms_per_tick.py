"""Host milliseconds a tick spends in the PFCS page tier: the benchmark's
``pfcs.touch_batch`` spans (which hold ``refresh_tables`` and so the
sharded successor-table rebuild with its kernel calls) in the window,
over the window's ticks."""


def read(run):
    w = run["window"]
    spans = [b - a for a, b in run["probe"].spans.get("pfcs.touch_batch", ())
             if a >= w["t0"] and b <= w["t1"]]
    ticks = sum(s["tick"] is not None
                for s in run["mirror"].steps[w["first_step"]:])
    return 1e3 * sum(spans) / ticks if ticks else None
