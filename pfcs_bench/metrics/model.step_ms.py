"""Mean wall milliseconds of one model decode call in the window, prefill
steps and ticks together, each call synchronised before and after (the
benchmark's ``model.decode_step`` span)."""


def read(run):
    w = run["window"]
    d = [b - a for a, b in run["probe"].spans.get("model.decode_step", ())
         if a >= w["t0"] and b <= w["t1"]]
    return 1e3 * sum(d) / len(d) if d else None
