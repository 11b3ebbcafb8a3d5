"""The benchmark's own instruments around calls into the port: spans,
counters and a record of the PFCS kernel launches.

Spans are named regions (``torch.profiler.record_function``, so a traced
run's device work can be attributed to them) with host times kept in
memory; they are put around the engine's tick loop, its single-slot
prefill, the model's decode step, decode attention and the page tier.
They are only installed for a traced run.  Always installed, because the
correctness check needs them: the tiers each ``touch_batch`` returned,
the count of model calls, and every launch of the three PFCS kernels with
its inputs and outputs (references to the device tensors, no copies).
"""

from __future__ import annotations

import sys
import time
from contextlib import contextmanager
from typing import Callable, Dict, List, Tuple

import torch

#: the port's PFCS kernel entry points: (module, attribute)
KERNEL_SITES = (("repro_torch.kernels.factorize", "divisibility_mask"),
                ("repro_torch.kernels.ops", "factorize_squarefree"),
                ("repro_torch.kernels.gcd", "gcd"))


class Probe:
    def __init__(self, eng, trace: bool):
        self.trace = trace
        self.spans: Dict[str, List[Tuple[float, float]]] = {}
        self.tiers: List[str] = []
        self.launches: List[Dict] = []
        self.model_calls = 0
        self.prefill_calls = 0
        self.in_slice = False
        self._undo: List[Callable[[], None]] = []
        pages = eng.pages
        self._wrap(pages, "touch_batch", self._touch_batch, "pfcs.touch_batch")
        self._wrap(pages, "refresh_tables", None, "pfcs.refresh")
        self._wrap(eng, "step", None, "engine.tick")
        self._wrap(eng, "_admit", None, "engine.admit")
        self._wrap(eng, "_step_slot", self._count_prefill,
                   "engine.prefill_step")
        self._wrap(eng, "_decode", self._count_model, "model.decode_step",
                   sync=True)
        attn = sys.modules["repro_torch.models.attention"]
        self._wrap(attn, "decode_attention", None, "attn.decode")
        for mod, name in KERNEL_SITES:
            self._wrap(sys.modules[mod], name, self._recorder(name), None)

    # ------------------------------------------------------------------ #

    @contextmanager
    def span(self, name: str, sync: bool = False):
        if sync:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.profiler.record_function(name):
            yield
            if sync:
                torch.cuda.synchronize()
        self.spans.setdefault(name, []).append((t0, time.perf_counter()))

    def _wrap(self, obj, attr: str, hook, span_name, sync: bool = False):
        """Replace ``obj.attr`` by a call that runs ``hook(fn, *args)``
        (or ``fn`` itself) inside the span ``span_name`` when tracing."""
        fn = getattr(obj, attr)
        in_dict = attr in vars(obj)
        call = (lambda *a, **k: hook(fn, *a, **k)) if hook else fn
        if self.trace and span_name is not None:
            sync = sync and torch.cuda.is_available()

            def wrapped(*a, **k):
                with self.span(span_name, sync):
                    return call(*a, **k)
        elif hook is not None:
            wrapped = call
        else:
            return
        setattr(obj, attr, wrapped)
        self._undo.append(lambda: setattr(obj, attr, fn) if in_dict
                          else delattr(obj, attr))

    def restore(self) -> None:
        while self._undo:
            self._undo.pop()()

    # ------------------------------------------------------------------ #

    def _touch_batch(self, fn, items):
        out = fn(items)
        self.tiers.extend(out)
        return out

    def _count_prefill(self, fn, *a):
        self.prefill_calls += 1
        return fn(*a)

    def _count_model(self, fn, *a):
        self.model_calls += 1
        return fn(*a)

    def _recorder(self, name: str):
        def record(fn, *args):
            out = fn(*args)
            self.launches.append({"name": name, "args": args,
                                  "out": out if isinstance(out, tuple)
                                  else (out,), "in_slice": self.in_slice})
            return out
        return record
