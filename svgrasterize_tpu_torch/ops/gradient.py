"""Gradient paint servers evaluated per pixel: the twin of the JAX package's
ops/gradient.py, as plain functions on tensors.

Linear gradients project pixel coordinates onto the gradient axis; radial
gradients solve the pixman two-circle interpolation equation
(svgrasterize.py:1544-1695).  The host precomposes all coordinate-space
transforms into a single affine matrix, so per pixel only: affine -> offset
field -> spread -> piecewise-linear stop lookup.  Tensors are f32 on one
device; the results land on the device of the stop tables.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.constants import DEVICE_FLOAT

SPREAD_PAD = "pad"
SPREAD_REPEAT = "repeat"
SPREAD_REFLECT = "reflect"


def pixel_grid(height: int, width: int, offset0: float, offset1: float, device="cuda"):
    """Pixel-center coordinates (h, w, 2) for a viewport at (offset0, offset1)."""
    r = torch.arange(height, dtype=torch.float32, device=device)[:, None].expand(height, width)
    c = torch.arange(width, dtype=torch.float32, device=device)[None, :].expand(height, width)
    return torch.stack([r + (offset0 + 0.5), c + (offset1 + 0.5)], dim=-1)


def apply_affine(points, matrix):
    """Apply a 2x3 affine (rows of [a, b, t]) to (..., 2) points."""
    m = matrix[:, :2]
    t = matrix[:, 2]
    return points @ m.T + t


def spread(offsets, mode: str):
    if mode == SPREAD_PAD:
        return offsets
    if mode == SPREAD_REPEAT:
        # fractional part, sign-preserving (numpy modf semantics, ref :1665)
        return offsets - torch.trunc(offsets)
    if mode == SPREAD_REFLECT:
        return torch.abs(torch.remainder(offsets + 1.0, 2.0) - 1.0)
    raise ValueError(f"invalid spread method: {mode}")


def interpolate_stops(offsets, stop_offsets, stop_colors):
    """Piecewise-linear RGBA lookup.

    offsets: (...); stop_offsets: (K,) ascending; stop_colors: (K, 4).
    Boundary/duplicate-stop semantics match the reference interpolator.
    """
    k = stop_offsets.shape[0]
    idx = torch.clamp(
        torch.searchsorted(stop_offsets, offsets.contiguous(), side="left"), 1, k - 1
    )
    o0 = stop_offsets[idx - 1]
    o1 = stop_offsets[idx]
    c0 = stop_colors[idx - 1]
    c1 = stop_colors[idx]
    span = o1 - o0
    ratio = torch.clamp(
        (offsets - o0) / torch.where(span > 1e-12, span, torch.ones_like(span)), 0.0, 1.0
    )
    # duplicate offsets are a hard step at the stop position (the reference
    # pair loop skips empty (o, o] intervals, so values above the duplicate
    # take the later color immediately, svgrasterize.py:1680-1683)
    ratio = torch.where(span > 1e-12, ratio, (offsets >= o1).to(ratio.dtype))
    ratio = ratio[..., None]
    return (1.0 - ratio) * c0 + ratio * c1


def linear_fill(height: int, width: int, viewport_offset, affine, p0, p1,
                stop_offsets, stop_colors, spread_method: str = SPREAD_PAD):
    """(height, width, 4) linear gradient; affine (2, 3) maps device pixels
    to gradient space, p0 / p1 (2,) its axis, stops (K,) / (K, 4)."""
    pixels = pixel_grid(height, width, float(viewport_offset[0]),
                        float(viewport_offset[1]), stop_offsets.device)
    pixels = apply_affine(pixels, affine)
    vec = p1 - p0
    t = ((pixels - p0) @ vec) / torch.clamp(vec @ vec, min=1e-30)
    return interpolate_stops(spread(t, spread_method), stop_offsets, stop_colors)


def radial_fill(height: int, width: int, viewport_offset, affine, center, radius,
                fcenter, fradius, stop_offsets, stop_colors,
                spread_method: str = SPREAD_PAD, has_focal: bool = False):
    """(height, width, 4) radial gradient; fcenter equals center when
    has_focal is False."""
    pixels = pixel_grid(height, width, float(viewport_offset[0]),
                        float(viewport_offset[1]), stop_offsets.device)
    pixels = apply_affine(pixels, affine)

    if not has_focal:
        rel = (pixels - center) / radius
        t = torch.sqrt(torch.sum(rel * rel, dim=-1))
        return interpolate_stops(spread(t, spread_method), stop_offsets, stop_colors)

    # two-circle (pixman) form: solve ||c(t) - p|| = r(t), keep the larger root
    cd = center - fcenter
    pd = pixels - fcenter
    rd = radius - fradius
    a = torch.sum(cd * cd) - rd * rd
    b = torch.sum(pd * cd, dim=-1) + fradius * rd
    c = torch.sum(pd * pd, dim=-1) - fradius * fradius
    det = b * b - a * c
    valid = det >= 0
    sq = torch.sqrt(torch.clamp(det, min=0.0))
    a_safe = torch.where(torch.abs(a) > 1e-30, a, torch.full_like(a, 1e-30))
    t = torch.maximum((b + sq) / a_safe, (b - sq) / a_safe)
    # exclude negative interpolated radius r(t)
    valid = torch.where(
        torch.abs(fradius - radius) > 1e-12,
        valid & (t > fradius / (fradius - radius)),
        valid,
    )
    out = interpolate_stops(spread(t, spread_method), stop_offsets, stop_colors)
    return torch.where(valid[..., None], out, torch.zeros_like(out))


def affine_2x3(transform) -> np.ndarray:
    """Host helper: 2x3 array from a Transform."""
    return np.asarray(transform.m[:2, :], dtype=DEVICE_FLOAT)
