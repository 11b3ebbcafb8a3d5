"""Run one cell of ``BENCHMARK.json`` once and print its result line.

    python3 -m pfcs_bench.run --workload phi3m.reason --seed 7 \\
        --seconds 40 --trace 0

A cell names a configuration (``configs/<name>.json``, the model as run
and the serving geometry, with its plain reference ``configs/<name>.py``)
and a traffic mix (``traffic/<name>.json``, read by ``loadgen.py``).  Each
per-layer metric is read by ``metrics/<name>.py``.  The harness finds
all of them by the names in ``BENCHMARK.json``.

Set-up (counted from process start): weights drawn from the seed on the
card, the engine built (``repro_torch.serving.ServingEngine`` with the
sharded PFCS page tier), the PFCS kernels built, then one engine step that
admits and prefills a request for every client and takes the first tick.
The window then drives ``ServingEngine.step()`` for ``--seconds``, each
client sending its next request as its last completes.  After the window
the program's state is freed and what it produced is compared with the
plain reference (``check.py``).  ``--trace 1`` adds the benchmark's spans
and profiles a slice of the window with ``torch.profiler``; its line
carries the per-layer metrics instead of the end-to-end ones.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Dict, Optional  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")

#: seconds of the window the traced run profiles, from its first
#: admission of a prompt two pages long or more
TRACE_SLICE_S = 4.0


def _load_py(path: Path):
    spec = importlib.util.spec_from_file_location(
        "pfcs_bench._" + path.stem.replace("-", "_").replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_cell(name: str) -> Dict:
    """The cell, its configuration, mix and metric lists, by name."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = next(w for w in bench["workloads"] if w["name"] == name)
    cfg = json.loads((HERE / "configs" / f"{cell['config']}.json")
                     .read_text())
    mix = json.loads((HERE / "traffic" / f"{cell['traffic']}.json")
                     .read_text())

    def listed(m):
        return name in m.get("workloads", [name])
    return {"cell": cell, "config": cfg, "mix": mix,
            "end_to_end": [m for m in bench["end_to_end"] if listed(m)],
            "per_layer": [m for m in bench["per_layer"] if listed(m)]}


def program_config(cfg: Dict, smoke: bool):
    """The port's ``ArchConfig`` for the configuration file's ``model``."""
    import dataclasses

    from repro_torch.configs import get_config

    m = dict(cfg["model"])
    if smoke:
        m.update(cfg["smoke"]["model"])
    base = get_config(cfg["program_arch"])
    kw = {}
    for k, v in m.items():
        cur = getattr(base, k)
        kw[k] = dataclasses.replace(cur, **v) if isinstance(v, dict) else v
    return base.replace(**kw), m


def _device_report(torch, device) -> Dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0}
    try:
        limit = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=30).stdout.split()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        limit = None
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": 1, "power_limit_w": limit}


def run_cell(name: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", smoke: bool = False,
             mix_override: Optional[Dict] = None, break_program=None,
             control: bool = False, t_start: float = T_START,
             steps: Optional[int] = None) -> Dict:
    """One run of cell ``name``; returns the result line's dict.

    ``smoke``, ``mix_override``: the configuration file's ``smoke`` sizes
    and another mix (CPU tests).  ``break_program(engine)`` plants a fault
    in the timed path (the check's own tests).  ``control``: also read
    the control (the reference with float8 weights) on the same calls
    and judge it by the configuration's limits (``control_correct``).
    ``steps``: end the window after that many engine steps instead of
    after ``seconds`` (CPU tests, whose pace depends on the host's load)."""
    import torch

    from pfcs_bench import check, reference
    from pfcs_bench.loadgen import ClosedLoop
    from pfcs_bench.probe import Probe
    from pfcs_bench.schedule import Mirror
    from pfcs_bench.weights import make_weights
    from repro_torch.models import build_model
    from repro_torch.serving import ServingEngine

    spec = load_cell(name)
    cfg_file = spec["config"]
    mix = dict(spec["mix"], **(mix_override or {}))
    cfg, m = program_config(cfg_file, smoke)
    serving = dict(cfg_file["serving"])
    if smoke:
        serving.update(cfg_file["smoke"]["serving"])
    ref = _load_py(HERE / "configs" / f"{spec['cell']['config']}.py")
    dev = torch.device(device)
    _warm_kernels(dev)

    model = build_model(cfg, device=device)
    params, flat = make_weights(model.param_specs(), seed, dev)
    eng = ServingEngine(
        model, params, max_batch=serving["max_batch"],
        max_seq=serving["max_seq"], page_size=serving["page_size"],
        hbm_pages=serving["hbm_pages"], kv=serving["kv"],
        prefetch_budget=serving["prefetch_budget"],
        reread_window=serving["reread_window"], shards=serving["shards"],
        device=device)
    probe = Probe(eng, trace)
    if break_program is not None:
        break_program(eng)
    loop = ClosedLoop(mix, serving["max_batch"], m["vocab_size"], seed)
    mirror = Mirror(serving["max_batch"])
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)

    def submit(r, t):
        eng.submit(r.prompt, r.max_new_tokens)
        mirror.submit(eng.queue[-1], t)

    def eng_step():
        eng.step()
        t = time.perf_counter()
        return [s.req_id if s is not None else None for s in eng.slots], t

    def one_step():
        rec = mirror.step(eng_step)
        for _ in rec["done"]:
            submit(loop.next(), rec["t"])
        return rec

    t = time.perf_counter()
    for r in loop.fill():
        submit(r, t)
    one_step()
    sync()
    # objects made in set-up live through the window: keep the collector's
    # full passes from walking them at the window's expense
    gc.collect()
    gc.freeze()
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    first_step = len(mirror.steps)
    calls0, prefill0 = probe.model_calls, probe.prefill_calls
    prof, slice_ = None, None
    paused = 0.0        # the traced run's own stop of the profiler
    page = serving["page_size"]
    while True:
        # the slice starts with an admission that registers a new chain
        # edge (a prompt of two pages or more), so it holds a PFCS refresh
        if trace and slice_ is None and (
                any(len(mirror.req[r]["prompt"]) > page
                    for r in mirror.queue)
                or time.perf_counter() - t0 > seconds / 2):
            prof, slice_ = _start_profile(torch, dev, probe, mirror)
        rec = one_step()
        now = rec["t"]
        over = (now - t0 - paused >= seconds if steps is None
                else len(mirror.steps) - first_step >= steps)
        if prof is not None and (now - slice_["t0"] >= TRACE_SLICE_S
                                 or over):
            # reading the trace takes seconds of host time that are the
            # benchmark's, not the program's: the window leaves them out
            _stop_profile(prof, slice_, probe, mirror, sync)
            paused = time.perf_counter() - slice_["t1"]
            prof = None
        if over:
            break
    t_end = time.perf_counter()
    gc.unfreeze()
    found = sorted({k.split(".")[0] for k in sys.modules}
                   & set(FORBIDDEN))
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    window = {"t0": t0, "t1": t_end, "seconds": t_end - t0 - paused,
              "first_step": first_step,
              "model_calls": probe.model_calls - calls0,
              "prefill_calls": probe.prefill_calls - prefill0}

    result = {"attempted": len(mirror.req),
              "failed": sum(r["eng_req"].state == "done"
                            and len(r["eng_req"].generated) != r["max_new"]
                            for r in mirror.req.values()),
              "context_rows": _context_rows(mirror, first_step)}
    ctx = {"m": m, "serving": serving, "mirror": mirror, "probe": probe,
           "window": window, "slice": slice_, "ref": ref, "peak": peak,
           "setup_s": setup_s, "cell": spec["cell"]["name"]}
    ctx["serve"] = _serve_values(ctx)
    if trace:
        metrics = _per_layer(spec, ctx)
        if slice_ is not None:
            result["breakdown"] = {"device_ops": slice_["sum"]["device_ops"],
                                   "idle_gaps": slice_["sum"]["idle_gaps"]}
    else:
        metrics = _end_to_end(spec, ctx)

    # the program's state goes before the reference runs
    pages = eng.pages
    eng.cache = None
    del eng, params, model
    probe.restore()
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    checks = _check(check, reference, ref, flat, m, serving, mirror, pages,
                    probe, seed, cfg_file, control)
    correct = all(v["value"] <= v["limit"] for k, v in checks.items()
                  if "limit" in v and not k.startswith("control_"))
    if control:
        result["control_correct"] = all(
            v["value"] <= v["limit"] for k, v in checks.items()
            if k.startswith("control_") and "limit" in v)
    device_info = _device_report(torch, dev)
    device_info["memory_peak_bytes"] = peak
    if trace and slice_ is not None:
        device_info["busy_s"] = slice_["sum"]["busy_s"]
        device_info["window_s"] = slice_["seconds"]
    result.update({"correct": correct, "metrics": metrics,
                   "device": device_info, "forbidden_modules": found,
                   "checks": checks})
    return result


def _warm_kernels(dev) -> None:
    """Build and load the three PFCS kernels before anything is timed
    (one launch each on a few values): the first refresh in the window
    must not pay ``nvcc`` or a module load."""
    import torch

    from repro_torch.kernels.factorize import (divisibility_mask,
                                               factorize_squarefree)
    from repro_torch.kernels.gcd import gcd
    if dev.type == "cuda":
        from repro_torch.kernels.cuda import KERNELS, Builds
        Builds([KERNELS[k] for k in ("divisibility_mask",
                                     "factorize_squarefree", "gcd")]).finish()
    c = torch.tensor([6, 10, 15], dtype=torch.int64, device=dev)
    p = torch.tensor([2, 3, 5], dtype=torch.int64, device=dev)
    divisibility_mask(c, p)
    factorize_squarefree(c, p)
    gcd(c, p)


def _context_rows(mirror, first_step: int) -> Dict:
    """Cache rows each live slot attends over in the window's ticks (its
    length before the call, plus the row the call writes): least, mean,
    most."""
    import numpy as np

    if first_step >= len(mirror.steps):
        return {}
    c0 = mirror.steps[first_step]["calls"][0]
    lens = mirror.lens()[c0:]
    served = np.stack(mirror.served[c0:])
    rows = lens[served >= 0] + 1
    if rows.size == 0:
        return {}
    return {"min": int(rows.min()), "mean": float(rows.mean()),
            "max": int(rows.max())}


def _start_profile(torch, dev, probe, mirror):
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize()
    prof = profile(activities=acts)
    prof.__enter__()
    probe.in_slice = True
    return prof, {"t0": time.perf_counter(), "first_call": len(mirror.tokens),
                  "first_step": len(mirror.steps)}


def _stop_profile(prof, slice_, probe, mirror, sync) -> None:
    from pfcs_bench import trace as tr

    sync()
    slice_["t1"] = time.perf_counter()
    slice_["seconds"] = slice_["t1"] - slice_["t0"]
    slice_["last_call"] = len(mirror.tokens)
    slice_["last_step"] = len(mirror.steps)
    probe.in_slice = False
    prof.__exit__(None, None, None)
    slice_["sum"] = tr.summarize(tr.export(prof), set(probe.spans))


def _serve_values(ctx) -> Dict:
    """Every end-to-end quantity, from the harness's own clock; a cell
    reports those that ``BENCHMARK.json`` lists for it, and per-layer
    readers may report others under names of their own."""
    import numpy as np

    mirror, w = ctx["mirror"], ctx["window"]
    t0 = w["t0"]
    steps = mirror.steps[w["first_step"]:]
    prompt_tokens = sum(len(mirror.req[r]["prompt"]) for s in steps
                        for r in s["admitted"])
    out_tokens = sum(len(s["touches"]) for s in steps)
    gaps, ttft = [], []
    for r in mirror.req.values():
        ts = r["token_t"]
        gaps += [b - a for a, b in zip(ts, ts[1:]) if b > t0]
        if ts and ts[0] > t0:
            ttft.append(ts[0] - r["submit_t"])
    values = {"tokens_per_s": (prompt_tokens + out_tokens) / w["seconds"],
              "itl_p95_ms": (float(np.percentile(gaps, 95)) * 1e3
                             if gaps else None),
              "ttft_p50_s": statistics.median(ttft) if ttft else None,
              "peak_mem_gb": ctx["peak"] / 1e9,
              "setup_s": ctx["setup_s"]}
    return values


def _end_to_end(spec, ctx) -> Dict:
    """The cell's end-to-end metrics."""
    values = ctx["serve"]
    return {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
            for m in spec["end_to_end"] if values.get(m["name"]) is not None}


def _per_layer(spec, ctx) -> Dict:
    out = {}
    for m in spec["per_layer"]:
        v = _load_py(HERE / "metrics" / f"{m['name']}.py").read(ctx)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


def _check(check, reference, ref, flat, m, serving, mirror, pages, probe,
           seed, cfg_file, control) -> Dict:
    import torch

    reference.no_tf32()
    # every slot, unless the configuration file names a smaller sample:
    # a fault confined to a few slots must not fall outside it
    slots = check.sample_slots(mirror, seed,
                               cfg_file.get("check_slots", mirror.b))
    hist = check.slot_histories(mirror, slots)
    with torch.no_grad():
        logits = ref.logits_at(flat, m, hist, serving["max_seq"],
                               reference.widen)
        got = check.gaps(logits, hist)
        limits = cfg_file["limits"]
        out = {k: dict({"value": got[k]},
                       **({"limit": limits[k]} if k in limits else {}))
               for k in check.GAP_NUMBERS}
        out["logit_gap"]["tokens"] = got["tokens"]
        out.update({
            "nonfinite_logits": {"value": got["nonfinite"], "limit": 0},
            "page_tier_mismatches": {
                "value": check.page_tier(mirror, pages, probe.tiers,
                                         serving), "limit": 0},
            "kernel_mismatches": {"value": check.kernels(probe.launches),
                                  "limit": 0,
                                  "launches": len(probe.launches)},
            "schedule_mismatches": {"value": mirror.mismatch, "limit": 0}})
        if control:
            low = ref.logits_at(flat, m, hist, serving["max_seq"],
                                reference.fp8_weights)
            ctl = check.gaps(logits, hist, [lg.argmax(1) for lg in low])
            out.update({"control_" + k: dict(
                {"value": ctl[k]},
                **({"limit": limits[k]} if k in limits else {}))
                for k in check.GAP_NUMBERS})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT / "src"))
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(ROOT / "artifacts" / "pfcs_bench" / sub)
    import torch

    # one process, one host thread for the program's CPU tensor ops: idle
    # worker threads would otherwise spin beside the thread that launches
    # the model's kernels
    torch.set_num_threads(1)
    spec = load_cell(a.workload)
    need = spec["cell"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        print(f"needs {need} CUDA device(s); torch.cuda.is_available()="
              f"{torch.cuda.is_available()}, device_count="
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 2
    res = run_cell(a.workload, a.seed, a.seconds, bool(a.trace))
    if res.pop("forbidden_modules"):
        print("forbidden modules loaded: "
              + ", ".join(sorted({k.split('.')[0] for k in sys.modules}
                                 & set(FORBIDDEN))), file=sys.stderr)
        return 3
    for k, v in res["checks"].items():
        print(f"check {k}: {v['value']!r}"
              + (f" limit {v['limit']!r}" if "limit" in v else ""),
              file=sys.stderr)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
