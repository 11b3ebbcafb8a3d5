"""Decode attention's share of its roofline in the traced slice: the least
time its work could take over the device time of the operations launched
inside the benchmark's ``attn.decode`` region (``models/attention.py::
decode_attention``), in percent.

Work of one call, for every row of the batch: its valid K and V rows
(min(len + 1, max_seq)) read once in the cache's dtype, q and the output
once; 4 FLOPs per head dimension per row (``arith.decode_attention_work``);
the least time is the larger of the bytes over 3.35 TB/s and the FLOPs
over the bf16 peak.  Every model call runs it once per attention layer."""

import numpy as np

from pfcs_bench.arith import (BF16_FLOPS, bound_s, decode_attention_work)

_ELEM = {"bfloat16": 2, "float16": 2, "float32": 4}


def read(run):
    sl = run["slice"]
    if sl is None:
        return None
    dev_s = sl["sum"]["under_s"].get("attn.decode")
    if not dev_s:
        return None
    m, ref = run["m"], run["ref"]
    lens = run["mirror"].lens()
    rows = run["serving"]["max_seq"]
    elem = _ELEM[m["dtype"]]
    total = 0.0
    for c in range(sl["first_call"], sl["last_call"]):
        valid = np.minimum(lens[c] + 1, rows)
        by, fl = decode_attention_work(valid.tolist(), m["n_heads"],
                                       m["n_kv_heads"], m["head_dim"],
                                       elem, elem)
        total += ref.attention_layers(m) * bound_s(by, fl, BF16_FLOPS)
    return 100.0 * total / dev_s
