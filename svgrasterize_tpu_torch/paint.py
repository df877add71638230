"""Paint server descriptors (host-side, immutable).

Colors are stored as premultiplied-alpha linear-RGB numpy arrays, the same
canonical form as the reference (svgrasterize.py:3581-3624).  Device
evaluation lives in ops/gradient.py; these NamedTuples are the scene-graph
facing API (parity: svgrasterize.py:1544-1713).
"""

from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np

from .core.transform import Transform
from .core import color as color_ops


class GradLinear(NamedTuple):
    p0: np.ndarray
    p1: np.ndarray
    stops: list  # [(offset, premult-linear rgba)]
    transform: Transform | None
    spread: str
    bbox_units: bool
    linear_rgb: bool | None


class GradRadial(NamedTuple):
    center: np.ndarray
    radius: float
    fcenter: np.ndarray | None
    fradius: float | None
    stops: list
    transform: Transform | None
    spread: str
    bbox_units: bool
    linear_rgb: bool | None


class Pattern(NamedTuple):
    scene: Any  # Scene
    scene_bbox_units: bool
    scene_view_box: tuple | None
    x: float
    y: float
    width: float
    height: float
    transform: Transform
    bbox_units: bool
    # real <pattern> grids anchor in the translation-free frame (reference
    # parity quirk, svgrasterize.py:1051/1073); anchored=True keeps the
    # draw transform's translation in the tiling frame instead, so
    # single-cell <image> placements stay content-aligned under rotation
    # (a rotation about a point is linear + translation — stripping the
    # translation shifts the cell modularly)
    anchored: bool = False

    def bbox(self):
        return (self.x, self.y, self.width, self.height)


class RasterImage:
    """Scene-like raster content (duck-typed .render, usable as a Pattern
    sub-scene).

    Wraps a straight-alpha sRGB uint8 (H, W, 4) array; render() maps the
    (0, 0, W, H) user box through the transform with bilinear resampling:
    positive axis-aligned (or axis-swapped) placements run as one
    bilinear resize, anything else (rotation, skew, flips) as an
    inverse-mapped bilinear gather at output pixel centers — edge pixels
    clamp, the enclosing rect geometry supplies the AA boundary.
    An <image> element lowers to a rect filled by a single-cell Pattern
    whose sub-scene is this object, so raster drawing rides the ordinary
    pattern paths (interpreter, batched executor, fused kernel) without a
    new scene node kind.
    """

    def __init__(self, array):
        self.array = np.ascontiguousarray(array)

    def render(self, transform, mask_only: bool = False, viewport=None,
               linear_rgb: bool = False):
        raise NotImplementedError(
            "raster images render through the interpreter, which this port "
            "does not have yet (ROADMAP queue 1 item 7)"
        )


def stops_to_arrays(stops, linear_rgb: bool):
    """Sorted stop arrays for the device interpolator, colorspace-adjusted.

    Gradients interpolate in sRGB unless rendering in linear RGB
    (ref svgrasterize.py:1686-1695).
    """
    offsets = np.array([o for o, _ in stops], dtype=np.float32)
    colors = np.stack([c for _, c in stops]).astype(np.float64)
    if not linear_rgb:
        colors = color_ops.pre_linear_to_pre_srgb(colors)
    return offsets, colors.astype(np.float32)
