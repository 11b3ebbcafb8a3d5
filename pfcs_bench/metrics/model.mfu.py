"""The model's useful FLOPs in the window over the window's seconds times
the H100's bf16 peak (989 TFLOP/s, data sheet), in percent.

Useful tokens: each prompt token prefilled (one a prefill call) and each
served token (one a live row of a tick).  A token costs 2 FLOPs per
weight it multiplies by (the configuration reference's
``matmul_params``) plus attention over the cache rows its call sees
(4 FLOPs per head dimension per row, per attention layer).  Rows fed 0
because the engine computes the whole batch count nothing."""

import numpy as np

from pfcs_bench.arith import BF16_FLOPS


def read(run):
    m, w, mirror, ref = run["m"], run["window"], run["mirror"], run["ref"]
    lens = mirror.lens()
    rows = run["serving"]["max_seq"]
    per_row = 4.0 * m["n_heads"] * m["head_dim"] * ref.attention_layers(m)
    flops = 0.0
    for st in mirror.steps[w["first_step"]:]:
        a, b = st["calls"]
        for c in range(a, b):
            if mirror.kind[c] == "tick":
                live = [i for i, _ in st["touches"]]
            else:
                live = list(np.flatnonzero(mirror.adv[c]))
            ctx = np.minimum(lens[c, live] + 1, rows)
            flops += (len(live) * 2.0 * ref.matmul_params(m)
                      + per_row * float(ctx.sum()))
    return 100.0 * flops / (w["seconds"] * BF16_FLOPS)
