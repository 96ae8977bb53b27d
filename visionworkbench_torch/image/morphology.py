"""Connected components of a mask, and the blob filter (port of the part
of ``visionworkbench_tpu/image/morphology.py`` the correlator's
``blob_filter_area`` needs: ``blob_index``, ``blob_areas`` and
``remove_small_blobs``; ref ``BlobIndexThreaded``, ``BlobIndex.cc``, and
``disparity_blob_filter``, ``CorrelationView.cc:241-280``).

Labels propagate as in the JAX package: each pass takes the minimum over
the pixel and its 4 (or 8) neighbours inside the mask, then jumps every
label to its label's label. Labels only fall, and every label is the flat
index of a pixel of the same component, so the fixpoint is unique: the
minimum flat index of each component. The JAX package tests for a change
after every pass; on the card each test is a host sync, so the port tests
after every ``_CHECK_EVERY`` passes (extra passes at the fixpoint change
nothing, and no change over several passes means none in each of them).
"""

from __future__ import annotations

import torch

# Passes between two tests for the fixpoint (one host sync each).
_CHECK_EVERY = 4


def _neighbours_min(lbl: torch.Tensor, mask: torch.Tensor, big: int,
                    connectivity: int) -> torch.Tensor:
    h, w = lbl.shape
    p = lbl.new_full((h + 2, w + 2), big)
    p[1:h + 1, 1:w + 1] = lbl
    shifts = [(0, 1), (2, 1), (1, 0), (1, 2)]
    if connectivity == 8:
        shifts += [(0, 0), (0, 2), (2, 0), (2, 2)]
    out = lbl
    for dy, dx in shifts:
        out = torch.minimum(out, p[dy:dy + h, dx:dx + w])
    return torch.where(mask, out, big)


def _blob_labels(mask: torch.Tensor, connectivity: int = 4):
    """``(labels, passes)``: :func:`blob_index`'s labels and the number of
    propagation passes run."""
    if mask.dtype != torch.bool:
        mask = mask != 0
    h, w = mask.shape
    big = h * w
    flat_idx = torch.arange(big, dtype=torch.int32, device=mask.device).reshape(h, w)
    lbl = torch.where(mask, flat_idx, big)
    passes = 0
    while True:
        before = lbl
        for _ in range(_CHECK_EVERY):
            new = _neighbours_min(lbl, mask, big, connectivity).reshape(-1)
            # pointer jumping: follow each label's label to shortcut chains
            hop = new[torch.clamp(new, max=big - 1).long()]
            lbl = torch.where(new < big, torch.minimum(new, hop), new).reshape(h, w)
            passes += 1
        if torch.equal(lbl, before):
            break
    return torch.where(mask, lbl, -1), passes


def blob_index(mask: torch.Tensor, connectivity: int = 4) -> torch.Tensor:
    """Label the connected components of ``mask`` (H, W) (ref
    ``BlobIndexThreaded``, BlobIndex.cc): int32 labels, -1 outside the
    mask, else the minimum flat index of the component."""
    return _blob_labels(mask, connectivity)[0]


def blob_areas(labels: torch.Tensor) -> torch.Tensor:
    """Per-pixel area (int32) of the blob each pixel belongs to; 0 outside."""
    h, w = labels.shape
    flat = labels.reshape(-1)
    inside = flat >= 0
    safe = torch.where(inside, flat, 0).long()
    counts = torch.bincount(safe[inside], minlength=h * w).to(torch.int32)
    return torch.where(inside, counts[safe], 0).reshape(h, w)


def remove_small_blobs(mask: torch.Tensor, min_area: int,
                       connectivity: int = 4) -> torch.Tensor:
    """Keep only the components of area >= ``min_area`` (ref
    ``applyErodeView`` + ``BlobIndexThreaded`` in ``disparity_blob_filter``,
    CorrelationView.cc:241-280)."""
    area = blob_areas(blob_index(mask, connectivity))
    return (mask != 0) & (area >= min_area)
