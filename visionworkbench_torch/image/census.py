"""Census transforms (port of ``visionworkbench_tpu/image/census.py``; ref
``src/vw/Image/CensusTransform.h:44-300``).

Binary census at 3x3/5x5/7x7/9x9 and ternary census at the same sizes, with
the reference's sampling patterns and bit orders. Codes are packed into one
or two 32-bit words per pixel, (H, W, n_words). PyTorch's ``uint32`` takes
few operations, so the words are ``int32`` tensors holding the same bit
pattern as the JAX package's ``uint32`` words (bit 31, used by the 7x7 and
9x9 words, is the sign bit here). ``hamming_distance`` widens to ``int64``
before its shifts so that no shift sign-extends, and counts bits with a SWAR
popcount (PyTorch has no popcount).

Inputs are uint8-valued arrays (..., H, W), compared as int32; leading axes
are carried through, and border pixels within ``radius`` of the edge are
computed against replicated edges. ``census_positions`` gives each variant's
sample offsets in bit order, which the CUDA sweep (``csrc/sweep.cu``) uses
to compute the same codes in shared memory.
"""

from __future__ import annotations

from typing import List, Tuple

import torch

from visionworkbench_torch.core.exceptions import ArgumentErr

# The 32-position sparse 9x9 pattern (ref CensusTransform.h:130-155);
# offsets (c, r) from the window's top-left corner.
_PATTERN_9 = [
    (0, 0), (4, 0), (8, 0),
    (1, 1), (3, 1), (5, 1), (7, 1),
    (2, 2), (4, 2), (6, 2),
    (1, 3), (4, 3), (7, 3),
    (0, 4), (2, 4), (3, 4), (5, 4), (6, 4), (8, 4),
    (1, 5), (4, 5), (7, 5),
    (2, 6), (4, 6), (6, 6),
    (1, 7), (3, 7), (5, 7), (7, 7),
    (0, 8), (4, 8), (8, 8),
]

# The 32-position 7x7 ternary pattern (ref CensusTransform.h:232-250).
_PATTERN_7T = [
    (0, 0), (2, 0), (3, 0), (4, 0), (6, 0),
    (1, 1), (3, 1), (5, 1),
    (0, 2), (2, 2), (3, 2), (4, 2), (6, 2),
    (0, 3), (1, 3), (2, 3), (4, 3), (5, 3), (6, 3),
    (0, 4), (2, 4), (3, 4), (4, 4), (6, 4),
    (1, 5), (3, 5), (5, 5),
    (0, 6), (2, 6), (3, 6), (4, 6), (6, 6),
]


def _dense_positions(radius: int) -> List[Tuple[int, int]]:
    """Dense-window offsets in the reference's scan order: r from +radius
    down to -radius, c from +radius down to -radius, center skipped
    (CensusTransform.h:95-128)."""
    return [(c, r) for r in range(radius, -radius - 1, -1)
            for c in range(radius, -radius - 1, -1) if (r, c) != (0, 0)]


def _census3x3_positions() -> List[Tuple[int, int]]:
    """3x3 order: bits 7..0 for (-1,-1),(0,-1),(1,-1),(-1,0),(1,0),(-1,1),
    (0,1),(1,1) (CensusTransform.h:64-77), returned in ascending-bit order."""
    return list(reversed([(-1, -1), (0, -1), (1, -1), (-1, 0), (1, 0),
                          (-1, 1), (0, 1), (1, 1)]))


def census_positions(window: int, ternary: bool) -> List[Tuple[int, int]]:
    """Sample offsets (dc, dr) from the centre in bit order (ternary census
    takes bits 2i and 2i+1 at position i) of the reference's variants:
    binary 3x3/5x5/7x7 dense and 9x9 sparse, ternary 3x3/5x5 dense and
    7x7/9x9 sparse."""
    if window == 3:
        return _dense_positions(1) if ternary else _census3x3_positions()
    if window == 5:
        return _dense_positions(2)
    if window == 7:
        return ([(c - 3, r - 3) for (c, r) in _PATTERN_7T] if ternary
                else _dense_positions(3))
    if window == 9:
        return [(c - 4, r - 4) for (c, r) in _PATTERN_9]
    kind = "ternary census" if ternary else "census"
    raise ArgumentErr(f"{kind} window must be 3/5/7/9, got {window}")


def census_words(window: int, ternary: bool) -> int:
    """32-bit words per pixel of a variant's codes (1 or 2)."""
    bits = len(census_positions(window, ternary)) * (2 if ternary else 1)
    return (bits + 31) // 32


def _as_int(img) -> torch.Tensor:
    img = img if isinstance(img, torch.Tensor) else torch.as_tensor(img)
    return img.to(torch.int32)


def _edge_pad(x: torch.Tensor, radius: int) -> torch.Tensor:
    """Replicate-pad the last two axes by ``radius``."""
    h, w = x.shape[-2], x.shape[-1]
    rows = torch.arange(-radius, h + radius, device=x.device).clamp_(0, h - 1)
    cols = torch.arange(-radius, w + radius, device=x.device).clamp_(0, w - 1)
    return x.index_select(-2, rows).index_select(-1, cols)


def _shifted(padded, radius: int, dc: int, dr: int, h: int, w: int):
    return padded[..., radius + dr:radius + dr + h, radius + dc:radius + dc + w]


def _pack(img, window: int, ternary: bool, diff_threshold: int = 2) -> torch.Tensor:
    positions = census_positions(window, ternary)
    radius = window // 2
    center = _as_int(img)
    h, w = center.shape[-2], center.shape[-1]
    padded = _edge_pad(center, radius)
    low, high = center - diff_threshold, center + diff_threshold
    words = [torch.zeros_like(center) for _ in range(census_words(window, ternary))]
    for i, (dc, dr) in enumerate(positions):
        val = _shifted(padded, radius, dc, dr, h, w)
        if ternary:
            lo_bit, hi_bit = 2 * i, 2 * i + 1
            words[lo_bit // 32] |= (val >= low).to(torch.int32) << (lo_bit % 32)
            words[hi_bit // 32] |= (val > high).to(torch.int32) << (hi_bit % 32)
        else:
            words[i // 32] |= (val > center).to(torch.int32) << (i % 32)
    return torch.stack(words, -1)


def census_transform(img, window: int = 5) -> torch.Tensor:
    """Binary census codes, (..., H, W, n_words) int32 words (ref
    ``get_census_value_*``): window 3 -> 8 bits (1 word), 5 -> 24 bits (1),
    7 -> 48 bits (2), 9 -> the sparse 32-position pattern (1)."""
    return _pack(img, window, False)


def ternary_census_transform(img, window: int = 5,
                             diff_threshold: int = 2) -> torch.Tensor:
    """Ternary census codes, 2 bits per sample position (ref
    ``get_census_value_ternary_*``, CensusTransform.h:168-300)."""
    return _pack(img, window, True, diff_threshold)


def _popcount32(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each 32-bit pattern (SWAR), as int32; ``x`` is int32 and
    is widened to its unsigned value in int64 first."""
    x = x.to(torch.int64) & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) >> 24 & 0xFF).to(torch.int32)


def hamming_distance(codes_a, codes_b) -> torch.Tensor:
    """Per-pixel hamming distance between packed census codes (ref
    ``hamming_distance``, CensusTransform.h: XOR + popcount), int32."""
    return _popcount32(codes_a ^ codes_b).sum(-1, dtype=torch.int32)


def census_radius(window: int) -> int:
    return window // 2
