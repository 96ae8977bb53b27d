"""kernels_per_item: device kernels launched per item, counted from the
profiler's CUDA activity over the traced items (copies and sets are not
kernels). Host dispatch layer."""


def read(ctx):
    tr = ctx["trace"]
    if tr is None:
        return None
    n = sum(1 for op in tr.device_ops if ctx["tracemod"].is_kernel(op))
    return n / tr.items
