"""The readings the check's limits are set from, on the card:

    python3 -m pfcs_bench.control --workload phi3m.reason \\
        --seconds 40 --seeds 11 12 13

For each seed, one run of the cell (its window at the cell's own load)
whose result carries, beside the program's readings, the control's: the
reference with its weights rounded to float8 e4m3
(``reference.fp8_weights``), the next precision below the bfloat16 the
configuration states, read on the same calls as the gap of the token it
puts first, and judged by the configuration's own limits
(``control_correct``).  One JSON line a seed; the exit code is 1 where
any seed's control comes out correct (the limits then cannot tell it
from the program) or any program run does not, else 0.  The limit lies
between the largest program reading and the smallest control reading
(``PERF.md`` gives both).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from pfcs_bench import run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    a = ap.parse_args(argv)
    sys.path.insert(0, str(run.ROOT / "src"))
    bad = 0
    for seed in a.seeds:
        res = run.run_cell(a.workload, seed, a.seconds, False, control=True,
                           t_start=time.perf_counter())
        bad += res["control_correct"] or not res["correct"]
        print(json.dumps({"workload": a.workload, "seed": seed,
                          "correct": res["correct"],
                          "control_correct": res["control_correct"],
                          "checks": res["checks"],
                          "metrics": res["metrics"]}), flush=True)
    return int(bad > 0)


if __name__ == "__main__":
    sys.exit(main())
