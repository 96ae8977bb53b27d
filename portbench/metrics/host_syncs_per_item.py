"""host_syncs_per_item: blocking CUDA calls (``cudaStreamSynchronize``,
``cudaDeviceSynchronize``, ``cudaEventSynchronize``, synchronous copies)
the host made inside an item's ``pyramid_correlate`` span, per item, over
the traced items (the program's spans mapped onto the profiler's clock by
``portbench/spans.py``; the harness's own waits between items are outside
every span). Host dispatch layer."""

from portbench import spans


def read(ctx):
    steps = spans.of(ctx)
    return None if steps is None else steps.syncs / steps.items
