"""host_blocked_ms: the host's milliseconds per item inside the blocking
CUDA calls that ``host_syncs_per_item`` counts, over the traced items. The
traced segment runs under CUPTI, which slows the host and so shortens its
waits: the reading is a floor of the untraced one. Host dispatch layer."""

from portbench import spans


def read(ctx):
    steps = spans.of(ctx)
    return None if steps is None else steps.blocked_ns / 1e6 / steps.items
