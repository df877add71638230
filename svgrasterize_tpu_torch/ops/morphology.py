"""Morphology (feMorphology erode/dilate) as torch window pooling.

A copy of the JAX package's ops/morphology.py (reduce_window over the two
leading axes, VALID, stride 1 by default), which replaces the reference's
numpy stride-tricks pooling (svgrasterize.py:419-468).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def pooling(image: torch.Tensor, ksize: tuple[int, int],
            stride: tuple[int, int] | None = None, method: str = "max"):
    """Overlapping {min,max,mean} pooling over the leading two axes of an
    (h, w, ch) image; VALID windows."""
    ky, kx = ksize
    if stride is None:
        stride = (ky, kx)
    x = image.permute(2, 0, 1)[None]  # (1, ch, h, w)
    if method == "max":
        out = F.max_pool2d(x, (ky, kx), stride)
    elif method == "min":
        out = -F.max_pool2d(-x, (ky, kx), stride)
    elif method == "mean":
        out = F.avg_pool2d(x, (ky, kx), stride)
    else:
        raise ValueError(f"invalid pooling method: {method}")
    return out[0].permute(1, 2, 0)
