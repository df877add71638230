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
               linear_rgb: bool = False, device="cuda"):
        import torch

        from .core.layer import Layer
        from .geom.hull import ConvexHull

        h, w = self.array.shape[:2]
        corners = transform(
            np.array([[0, 0], [w, 0], [0, h], [w, h]], dtype=np.float64)
        )
        lo = np.floor(corners.min(axis=0)).astype(int)
        hi = np.ceil(corners.max(axis=0)).astype(int)
        rows, cols = int(hi[0] - lo[0]), int(hi[1] - lo[1])
        if rows <= 0 or cols <= 0:
            return None
        img = torch.as_tensor(self.array, device=device).to(torch.float32) / 255.0
        m = transform.m
        simple = (
            (transform.is_axis_aligned and m[0, 0] > 0 and m[1, 1] > 0)
            or (transform.is_swap_axis_aligned and m[0, 1] > 0 and m[1, 0] > 0)
        )
        if simple:
            img = resize_bilinear(img, rows, cols)
        else:
            inv = [float(v) for v in transform.invert.m[:2].ravel()]
            f32 = torch.float32
            pr = torch.arange(rows, dtype=f32, device=device)[:, None] + (float(lo[0]) + 0.5)
            pc = torch.arange(cols, dtype=f32, device=device)[None, :] + (float(lo[1]) + 0.5)
            # user dim0 spans the array's W columns, dim1 its H rows
            fc = inv[0] * pr + inv[1] * pc + inv[2] - 0.5
            fr = inv[3] * pr + inv[4] * pc + inv[5] - 0.5
            fr = torch.clamp(fr, 0.0, float(h - 1))
            fc = torch.clamp(fc, 0.0, float(w - 1))
            r0 = torch.floor(fr).to(torch.int32)
            c0 = torch.floor(fc).to(torch.int32)
            r1 = torch.clamp(r0 + 1, max=h - 1)
            c1 = torch.clamp(c0 + 1, max=w - 1)
            wr = (fr - r0)[..., None]
            wc = (fc - c0)[..., None]
            r0, c0, r1, c1 = (v.long() for v in (r0, c0, r1, c1))
            img = (
                img[r0, c0] * (1 - wr) * (1 - wc)
                + img[r0, c1] * (1 - wr) * wc
                + img[r1, c0] * wr * (1 - wc)
                + img[r1, c1] * wr * wc
            )
        layer = Layer(img, (int(lo[0]), int(lo[1])), pre_alpha=False,
                      linear_rgb=False)
        layer = layer.convert(pre_alpha=True, linear_rgb=linear_rgb)
        if mask_only:
            alpha_only = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=layer.image.dtype,
                                      device=layer.image.device)
            layer = Layer(layer.image * alpha_only, layer.offset, True, linear_rgb)
        return layer, ConvexHull(corners)


def resize_bilinear(image, rows: int, cols: int):
    """Resize an (H, W, C) image to (rows, cols, C) by linear interpolation at
    pixel centres, antialiased when it shrinks (jax.image.resize's "linear"
    method: the triangle kernel widens by the scale factor)."""
    import torch.nn.functional as F

    x = image.permute(2, 0, 1)[None]
    out = F.interpolate(x, size=(rows, cols), mode="bilinear", align_corners=False,
                        antialias=True)
    return out[0].permute(1, 2, 0)


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
