"""Shape bucketing.

XLA compiles one program per distinct input shape.  Scenes contain paths with
arbitrary bbox sizes and segment counts, so every device-side array dimension
is padded up to a small set of bucket sizes to bound recompilation.
"""

from __future__ import annotations

import numpy as np

# Pixel dimensions snap to multiples of this (and at least this) so tiles map
# onto the VPU lane layout (8, 128) reasonably.
_DIM_STEP = 32
_DIM_MIN = 32


def bucket_dim(n: int) -> int:
    """Bucket a pixel dimension: next power-of-two-ish size.

    Uses 1-2-3 spaced buckets (32, 48, 64, 96, 128, 192, 256, ...) which keeps
    padding waste under 50% while giving O(log) distinct shapes.
    """
    n = max(int(n), _DIM_MIN)
    b = _DIM_MIN
    while True:
        if n <= b:
            return b
        if n <= b + b // 2:
            return b + b // 2
        b *= 2


def bucket_count(n: int, minimum: int = 32) -> int:
    """Bucket an element count (segments, curves) to powers of two."""
    n = max(int(n), minimum)
    return 1 << int(np.ceil(np.log2(n)))


def pad_rows(arr: np.ndarray, rows: int, fill: float = 0.0) -> np.ndarray:
    """Pad axis 0 of `arr` up to `rows` with `fill`."""
    if arr.shape[0] == rows:
        return arr
    if arr.shape[0] > rows:
        raise ValueError(f"cannot pad {arr.shape[0]} rows into {rows}")
    pad = np.full((rows - arr.shape[0], *arr.shape[1:]), fill, dtype=arr.dtype)
    return np.concatenate([arr, pad], axis=0)
