"""host_ms_per_item: the host's milliseconds in each item's call, from the
call to its return (the dispatch cost: the program's Python and launches),
the mean over the untraced window's items. Entry point layer."""


def read(ctx):
    ms = ctx["host_ms"]
    return sum(ms) / len(ms) if ms else None
