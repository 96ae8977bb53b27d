"""device_idle_pct: the share of the untraced window, in %, in which no
operation ran on the card: 1 less the device's busy time an item (the
union of the device operations' intervals over the traced items, a
reading the profiler does not slow) times the items completed in the
untraced window, over the window's seconds. The traced segment's own
window runs slower than the untraced one, so its idle share is not used.
Device layer."""


def read(ctx):
    tr = ctx["trace"]
    if tr is None or not ctx.get("window_s"):
        return None
    busy_per_item = ctx["tracemod"].busy_seconds(tr) / tr.items
    return 100.0 * (1.0 - busy_per_item * ctx["completed"] / ctx["window_s"])
