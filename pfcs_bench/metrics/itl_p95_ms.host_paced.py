"""``itl_p95_ms`` in a cell whose host sets the pace: the 95th percentile
of every gap between consecutive served tokens of a request that ends in
the window, as the end-to-end metric of that name counts it.  Read per
layer there, moving ``peak_mem_gb``, for the reason
``tokens_per_s.host_paced`` gives."""


def read(run):
    return run["serve"]["itl_p95_ms"]
