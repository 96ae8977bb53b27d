"""The least time the card could take for one item's affine / Bayes-EM
subpixel refinement: the work the refiner's formulation needs, counted
from the configuration's settings and the frame's shape, never from which
kernels ran (a fused refiner does the same work).

Operations are a floor of the formulation's arithmetic per pixel: per
window tap, EM pass and outer iteration, the affine offsets, one bilinear
sample, the mixture (EM only) and the tap's share of the normal equations'
moment sums; per window row, folding the row's moments into the 6x6
system; per pass, the Cholesky solve; once, the inputs (LoG of both frames,
the two derivatives) and the window weights. Bytes: the two frames and the
integer map read once, and the refined map written once an outer
iteration. The peaks are ``portbench/roofline.py``'s.

The refiner's device time, that least time's denominator, is that of the
operations launched inside the program's ``em.*`` steps
(:func:`em_device_ns`).
"""

from __future__ import annotations

import sys
from typing import List, Tuple

from portbench import spans
from portbench.reference.bayes_em import EM_ITERS, OUTER_ITERS
from portbench.roofline import least_seconds

# Per pixel, tap and pass: the affine offsets (ox, oy: a multiply and an
# add each, the per-row parts counted per row), and one bilinear sample of
# the warped frame (three lerps of a subtract, a multiply and an add).
TAP_SAMPLE_OPS = 4 + 9
# Per pixel, tap and pass: the residual I_e (1), the weight (1), the two
# weighted gradients (2), the three gradient products and two residual
# products (5), their moments (the products: 1, i and i^2 each, an add and
# a multiply-add: 3 x 5; the residual products: 1 and i: 2 x 3), the sum
# of residuals (1).
TAP_SYSTEM_OPS = 1 + 1 + 2 + 5 + 15 + 6 + 1
# Per pixel, tap and EM pass: the predicted residual (delta_x, delta_y: 4;
# the plane residual: 4), the noise residual (1), two exponents (4), two
# exponentials (2), the prior-weighted probabilities and their sum (5),
# two responsibilities (2), the mean-noise and responsibility sums (4).
TAP_EM_OPS = 8 + 1 + 4 + 2 + 5 + 2 + 4
# Per pixel, window row and pass: the row's 9 product moments and 4
# residual moments into the system's 21 + 6 entries and the residual sum.
ROW_OPS = 28
# Per pixel and pass: the unrolled 6x6 Cholesky (97), forward and back
# substitution (36 each).
SOLVE_OPS = 97 + 36 + 36
# Per pixel, once: the LoG of both frames (Gaussian 9 + 9 taps and the
# 3x3 Laplacian, a multiply and an add a tap: 2 x 54), the two derivatives
# (3 taps: 12), the window weights and valid count (3 a tap).
INPUT_OPS = 2 * 54 + 12
WEIGHT_OPS_PER_TAP = 3


def em_work(settings: dict, h: int, w: int) -> Tuple[float, float]:
    """(bytes, operations) of the refinement of one (h, w) item at the
    configuration's ``settings``; (0, 0) where the settings refine with
    neither ``em`` nor ``affine``."""
    mode = settings.get("subpixel", "none")
    if mode not in EM_ITERS:
        return 0.0, 0.0
    kw, kh = (int(v) for v in (settings.get("subpixel_kernel")
                               or settings.get("kernel_size", (21, 21))))
    em = EM_ITERS[mode]
    passes = OUTER_ITERS * max(em, 1)       # an unweighted pass where em is 0
    per_tap = TAP_SAMPLE_OPS + TAP_SYSTEM_OPS + (TAP_EM_OPS if em > 0 else 0)
    per_pass = kw * kh * per_tap + kh * ROW_OPS + SOLVE_OPS
    px = float(h) * float(w)
    ops = px * (passes * per_pass + INPUT_OPS + kw * kh * WEIGHT_OPS_PER_TAP)
    # two fp32 frames and the integer map (2 x fp32 and a validity byte)
    # read; the refined map written each outer iteration
    nbytes = px * (2 * 4 + 9 + OUTER_ITERS * 9)
    return nbytes, ops


def _is_em(name: str) -> bool:
    """A step name (``portbench.spans.step_names``) at or below an ``em.*``
    step."""
    return any(part.startswith("em.") for part in name.split("/"))


def em_step_ns(steps) -> int:
    """Device ns of the refiner's steps, the ``em.*`` rows of a
    ``portbench.spans.Steps`` (rows named ``.../em.<step>``, none inside
    another)."""
    return sum(r.device_ns for name, r in steps.rows.items()
               if name.rsplit("/", 1)[-1].startswith("em."))


def _paired_in_order(tr) -> List[Tuple[int, int]]:
    """Device operations (indices into ``tr.device_ops``) with the calls
    that launched them (indices into ``tr.host_ops``), the window's marker
    left out: the program and the harness run on one stream, so the card
    runs the operations in launch order, and each operation goes to the
    first launch of its kind after the one paired before it. Where every
    record is there, that is the n-th operation of a kind with the n-th
    launch of it; where records were lost at the trace's end, still so;
    a record lost inside the trace moves the operations after it of its
    kind onto earlier launches, up to the next operation of another kind."""
    calls = tr.host_ops
    launches = [j for j, c in enumerate(calls) if spans.call_kind(c.name)]
    marker = next((j for j in launches if spans.call_kind(calls[j].name) == "kernel"), None)
    launches = [j for j in launches if j != marker]
    out: List[Tuple[int, int]] = []
    k = 0
    for i, op in enumerate(tr.device_ops):
        kind = spans.op_kind(op.name)
        while k < len(launches) and spans.call_kind(calls[launches[k]].name) != kind:
            k += 1
        if k == len(launches):
            break
        out.append((i, launches[k]))
        k += 1
    return out


def em_device_ns(tr, steps) -> float:
    """Device ns of the operations launched inside the refiner's ``em.*``
    steps, over the traced items.

    Where the trace holds a device operation for each launch, the steps'
    own rows (``portbench/spans.py`` pairs the n-th operation of a kind
    with the n-th launch of it). The profiler can lose records (CUPTI's
    activity records; an item launches ~50k kernels): that pairing then
    fails, the rows hold no time of the kind, and the operations are
    paired by :func:`_paired_in_order` instead, with a line on standard
    error."""
    if tr is None:
        return em_step_ns(steps)
    calls = tr.host_ops
    n_ops = len(tr.device_ops) + 1                          # and the marker
    n_launches = sum(1 for c in calls if spans.call_kind(c.name))
    if n_ops == n_launches:
        return em_step_ns(steps)
    names = spans.step_names(steps.spans)
    ns = 0
    for i, j in _paired_in_order(tr):
        w = steps.where[j]
        if w >= 0 and _is_em(names[w]):
            op = tr.device_ops[i]
            ns += op.end_ns - op.start_ns
    print(f"[portbench] em: the trace holds {n_ops} device operations for {n_launches} "
          "launches: the refiner's operations paired in launch order", file=sys.stderr)
    return ns


def traced_share(ctx, steps):
    """The least time of the traced items' refinement over the device time
    of their ``em.*`` steps, in %; None where the steps saw no device time
    or the configuration does no such refinement."""
    if steps is None:
        return None
    ns = em_device_ns(ctx.get("trace"), steps)
    cell = ctx["cell"]
    traffic = cell["workload"]["traffic"]
    nbytes, ops = em_work(cell["config"]["settings"], int(traffic["height"]),
                          int(traffic["width"]))
    if ns <= 0 or ops <= 0:
        return None
    return 100.0 * least_seconds(nbytes, ops) * steps.items / (ns / 1e9)
