"""glue_device_ms: device milliseconds per item of the operations that are
not the program's hand-written kernels (every ``__global__`` of
``visionworkbench_torch/csrc``): PyTorch's kernels, copies and sets of the
plain tensor work; the harness's copy of the outputs to the host is left
out. Plain tensor work layer."""


def read(ctx):
    tr = ctx["trace"]
    if tr is None:
        return None
    tm, names = ctx["tracemod"], ctx["program_kernels"]
    ns = sum(op.end_ns - op.start_ns for op in tr.device_ops
             if not tm.is_output_copy(op) and not tm.kernel_matches(op, names))
    return ns / 1e6 / tr.items
