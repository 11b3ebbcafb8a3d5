"""The three PFCS kernels' share of their roofline in the traced slice:
the sum of each launch's least time over the sum of their device time
(kernels named ``divmask_kernel``, ``factorize_kernel``, ``gcd_kernel``),
in percent.  A launch's bytes and operations come from the shapes and
values it was launched with (``arith.pfcs_kernel_work``); its least time
is the larger of the bytes over 3.35 TB/s and the operations over the
card's 32-bit integer rate."""

from pfcs_bench.arith import (INT_OPS_PER_S, bound_s, euclid_steps,
                              pfcs_kernel_work)

_KERNELS = ("divmask_kernel", "factorize_kernel", "gcd_kernel")


def read(run):
    sl = run["slice"]
    if sl is None:
        return None
    dev_s = sum(v for k, v in sl["sum"]["op_s"].items()
                if any(n in k for n in _KERNELS))
    launches = [x for x in run["probe"].launches if x["in_slice"]]
    if not dev_s or not launches:
        return None
    total = 0.0
    for x in launches:
        a = x["args"]
        elem = a[0].element_size()
        if x["name"] == "gcd":
            w = pfcs_kernel_work("gcd", (a[0].numel(),), elem, euclid=
                                 euclid_steps(a[0].tolist(), a[1].tolist()))
        else:
            hits = (int(x["out"][0].sum())
                    if x["name"] == "factorize_squarefree" else 0)
            w = pfcs_kernel_work(x["name"], (a[0].numel(), a[1].numel()),
                                 elem, hits=hits)
        total += bound_s(*w, INT_OPS_PER_S)
    return 100.0 * total / dev_s
