"""Share of the traced slice in which no operation ran on the card:
1 - (union of the device operations' intervals) / (the slice's length),
in percent, from the ``torch.profiler`` trace."""


def read(run):
    sl = run["slice"]
    if sl is None or not sl["sum"]["busy_s"]:
        return None
    return 100.0 * (1.0 - sl["sum"]["busy_s"] / sl["seconds"])
