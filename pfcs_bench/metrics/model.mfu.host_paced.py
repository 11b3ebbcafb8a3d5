"""``model.mfu`` in a cell whose host sets the pace: the same reading,
under a name that moves ``peak_mem_gb``, the one end-to-end metric such
a cell keeps besides ``setup_s`` (see ``tokens_per_s.host_paced``)."""

from pfcs_bench.readers import same_as

read = same_as("model.mfu")
