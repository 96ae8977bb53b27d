"""em_device_ms: device milliseconds per item of the affine / Bayes-EM
subpixel refiner, the operations launched inside its ``em.*`` steps
(``em.inputs``, ``em.weights``, ``em.warp``, ``em.iter``, ``em.finish``:
the program's spans mapped onto the traced segment's trace by
``portbench/spans.py``; paired in launch order where the profiler lost
records: ``portbench.roofline_em.em_device_ns``). None where
the program names no such step. Subpixel refiner layer."""

from portbench import roofline_em, spans


def read(ctx):
    steps = spans.of(ctx)
    if steps is None:
        return None
    ns = roofline_em.em_device_ns(ctx.get("trace"), steps)
    return ns / 1e6 / steps.items if ns > 0 else None
