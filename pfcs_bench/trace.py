"""Reading a ``torch.profiler`` trace of the traced slice: the device's
busy time, its operations by name, device time under the benchmark's
spans, and idle time by the host span open while the device waited.

The trace is exported as Chrome JSON into a temporary file under
``TMPDIR``, read, and deleted.  Device operations are the events of
category ``kernel``, ``gpu_memcpy`` and ``gpu_memset``; a kernel belongs
to a span when the runtime call that launched it (same ``correlation``)
lies inside one of the span's ``user_annotation`` intervals.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
from typing import Dict, List, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def export(prof) -> Dict:
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)
    finally:
        os.unlink(path)


def _union(iv: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def summarize(trace: Dict, span_names) -> Dict:
    """Busy seconds, device seconds by op name and under each span, and
    idle seconds by the innermost span open at each gap's middle."""
    ev = [e for e in trace.get("traceEvents", []) if e.get("ph") == "X"]
    dev = [e for e in ev if e.get("cat") in DEVICE_CATS]
    launch_ts = {e["args"]["correlation"]: e["ts"] for e in ev
                 if e.get("cat") in ("cuda_runtime", "cuda_driver")
                 and "correlation" in e.get("args", {})}
    spans = [e for e in ev if e.get("cat") == "user_annotation"
             and e.get("name") in span_names]
    busy_iv = _union([(e["ts"], e["ts"] + e["dur"]) for e in dev])
    busy = sum(b - a for a, b in busy_iv)
    by_op: Dict[str, float] = {}
    for e in dev:
        by_op[e["name"]] = by_op.get(e["name"], 0.0) + e["dur"]
    # device time under each span, by the launch's host time
    under: Dict[str, float] = {}
    per_name: Dict[str, Tuple[List[float], List[float]]] = {}
    for s in sorted(spans, key=lambda s: s["ts"]):
        st, en = per_name.setdefault(s["name"], ([], []))
        st.append(s["ts"])
        en.append(s["ts"] + s["dur"])
    for e in dev:
        t = launch_ts.get(e.get("args", {}).get("correlation"))
        if t is None:
            continue
        for name, (st, en) in per_name.items():
            i = bisect.bisect_right(st, t) - 1
            if i >= 0 and t <= en[i]:
                under[name] = under.get(name, 0.0) + e["dur"]
    # idle gaps, each named by the innermost span open at its middle: a
    # sweep over span starts and ends (spans on one thread nest)
    gaps = [((a1 + b0) / 2, b0 - a1) for (_, a1), (b0, _)
            in zip(busy_iv, busy_iv[1:]) if b0 > a1]
    marks = sorted([(s["ts"], 1, s["name"]) for s in spans]
                   + [(s["ts"] + s["dur"], 0, s["name"]) for s in spans])
    idle: Dict[str, float] = {}
    stack: List[str] = []
    j = 0
    for mid, length in sorted(gaps):
        while j < len(marks) and marks[j][0] <= mid:
            _, opening, name = marks[j]
            if opening:
                stack.append(name)
            elif name in stack:
                del stack[len(stack) - 1 - stack[::-1].index(name)]
            j += 1
        key = stack[-1] if stack else "outside_spans"
        idle[key] = idle.get(key, 0.0) + length
    top = lambda d: [[k[:160], v * 1e-6] for k, v in
                     sorted(d.items(), key=lambda kv: -kv[1])[:10]]
    return {"busy_s": busy * 1e-6,
            "under_s": {k: v * 1e-6 for k, v in under.items()},
            "op_s": {k: v * 1e-6 for k, v in by_op.items()},
            "device_ops": top(by_op), "idle_gaps": top(idle)}
