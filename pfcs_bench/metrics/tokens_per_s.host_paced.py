"""``tokens_per_s`` in a cell whose host sets the pace: prompt tokens
prefilled plus tokens served in the window, over the window's seconds,
as the end-to-end metric of that name counts them.  Such a cell's runs
swing with the host's speed by more than any bound allows, so there it
is read per layer and moves ``peak_mem_gb``, the one end-to-end metric
the cell keeps besides ``setup_s``."""


def read(run):
    return run["serve"]["tokens_per_s"]
