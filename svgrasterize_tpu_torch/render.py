"""Path rasterization for the interpreter: a Path is flattened on the host,
its winding field computed on the device (the whole-image winding kernel:
one launch per render's batch of masks, MaskBatch and
ops/fused_exec.winding_batch, or ops/fused_exec.winding for a mask alone),
mapped by its fill rule, painted (solid, gradient, pattern) and returned as
a Layer.  The twin of the JAX package's render.py (parity: Path.mask /
Path.fill of the reference, svgrasterize.py:922-1103).

The JAX package pads every mask to a bucketed shape and its edge list to a
power-of-two count to bound XLA recompiles; only mask[:h, :w] ever leaves
its functions, so this port rasterizes at the exact (h, w) and the real
edge count.  Every tensor made here lives on `device`.
"""

from __future__ import annotations

import warnings
from collections import deque
from typing import NamedTuple

import numpy as np
import torch

from .core import color as color_ops
from .core.layer import Layer, merge_at
from .core.transform import Transform
from .geom.hull import ConvexHull
from .ops import fill_rule as fill_rule_ops, fused_exec, gradient as gradient_ops
from .ops.compose import COMPOSE_IN, compose
from .paint import GradLinear, GradRadial, Pattern, stops_to_arrays
from .utils.constants import DEVICE_FLOAT, FLATNESS


def _f32(values, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(values, DEVICE_FLOAT), device=device)


class MaskGeometry(NamedTuple):
    """The host half of a path mask: its device-space edges shifted to the
    mask's origin, where the mask sits, its size and the path's hull."""

    edges: np.ndarray  # (S, 4) f32 rows (a0, a1, b0, b1)
    offset: tuple  # (row, col) of the mask's origin
    size: tuple  # (h, w)
    hull: ConvexHull


def mask_geometry(path, transform: Transform, viewport) -> MaskGeometry | None:
    """Flatten a path and place its mask over its bbox (clamped to the
    viewport); None when the mask is empty."""
    lines = path.flatten(transform, FLATNESS)
    if lines.size == 0:
        return None
    pts = lines.reshape(-1, 2)
    min0, min1 = np.floor(pts.min(axis=0)).astype(int) - 1
    max0, max1 = np.ceil(pts.max(axis=0)).astype(int) + 1
    if viewport is not None:
        v0, v1, ve0, ve1 = viewport
        min0, min1 = max(v0, min0), max(v1, min1)
        max0, max1 = min(v0 + ve0, max0), min(v1 + ve1, max1)
    h, w = int(max0 - min0), int(max1 - min1)
    if h <= 0 or w <= 0:
        return None
    shifted = lines.reshape(-1, 4) - np.array([min0, min1, min0, min1])
    return MaskGeometry(np.asarray(shifted, DEVICE_FLOAT), (int(min0), int(min1)), (h, w),
                        ConvexHull(lines))


class MaskBatch:
    """The path masks of one interpreter render, rasterized together.

    Scene.render adds the host half (mask_geometry) of every mask it can
    foresee before anything renders; the first take() of a mask launches
    the winding kernel once for its whole batch (fused_exec.winding_batch).
    A batch holds at most BATCH_PIXELS field pixels, so a render of many
    large masks makes a few launches instead of holding every field at
    once.  take() hands out each added mask once; a mask nobody added
    (take returns None) is rasterized alone.
    """

    BATCH_PIXELS = 1 << 26  # 256 MiB of f32 fields

    def __init__(self, device):
        self.device = device
        self.added = self.taken = 0
        self._queues: dict = {}  # key -> deque of (geometry, (batch, index))
        # per batch [geometries, fields (None until launched), fields not
        # yet taken]
        self._batches: list = []
        self._pixels = 0  # field pixels of the newest batch

    @staticmethod
    def key(node, transform: Transform, viewport):
        """A mask's key: its scene node, transform and viewport."""
        return (id(node), transform.m.tobytes(),
                None if viewport is None else tuple(viewport))

    def add(self, key, geometry: MaskGeometry | None) -> None:
        """Queue a mask under key; geometry None records an empty mask."""
        slot = None
        if geometry is not None:
            h, w = geometry.size
            if not self._batches or self._pixels + h * w > self.BATCH_PIXELS:
                self._batches.append([[], None, 0])
                self._pixels = 0
            batch = self._batches[-1]
            slot = (len(self._batches) - 1, len(batch[0]))
            batch[0].append(geometry)
            batch[2] += 1
            self._pixels += h * w
        self._queues.setdefault(key, deque()).append((geometry, slot))
        self.added += 1

    def take(self, key):
        """(geometry, winding field) of the next mask added under key, both
        None for an empty mask; None when no mask is waiting there."""
        queue = self._queues.get(key)
        if not queue:
            return None
        geometry, slot = queue.popleft()
        self.taken += 1
        if slot is None:
            return None, None
        b, i = slot
        batch = self._batches[b]
        if batch[1] is None:
            geometries = batch[0]
            batch[1] = fused_exec.winding_batch(
                [g.edges for g in geometries], [g.size for g in geometries], self.device
            )
        field = batch[1][i]
        batch[2] -= 1
        if not batch[2]:  # every field handed out: the batch holds no memory
            batch[0] = batch[1] = None
        return geometry, field


def _mask_padded(path, transform: Transform, fill_rule: str | None, viewport, device,
                 gathered=None):
    """Rasterize a path's coverage over its bbox (clamped to the viewport).

    gathered: what MaskBatch.take returned for this mask, or None to
    flatten and rasterize it here (one launch of its own).  Returns (mask
    (h, w, 1) on device, offset, (h, w), hull) or None.
    """
    if gathered is None:
        geometry, wind = mask_geometry(path, transform, viewport), None
    else:
        geometry, wind = gathered
    if geometry is None:
        return None
    if wind is None:
        wind = fused_exec.winding(_f32(geometry.edges, device), *geometry.size)
    mask = fill_rule_ops.apply(wind, fill_rule)[..., None]
    return mask, geometry.offset, geometry.size, geometry.hull


def path_mask(path, transform: Transform, fill_rule: str | None = None, viewport=None,
              device="cuda", gathered=None):
    """Render a path as an alpha-only Layer. Returns (Layer, ConvexHull) or None.

    gathered: the mask's MaskBatch.take result, when a render gathered it."""
    result = _mask_padded(path, transform, fill_rule, viewport, device, gathered)
    if result is None:
        return None
    mask, offset, _size, hull = result
    return Layer(mask, offset, pre_alpha=True, linear_rgb=True), hull


def path_fill(
    path,
    transform: Transform,
    paint,
    fill_rule: str | None = None,
    viewport=None,
    linear_rgb: bool = True,
    device="cuda",
    gathered=None,
):
    """Fill a path with a paint server. Returns (Layer, ConvexHull) or None.

    gathered: the mask's MaskBatch.take result, when a render gathered it."""
    if paint is None:
        return None
    result = _mask_padded(path, transform, fill_rule, viewport, device, gathered)
    if result is None:
        return None
    mask, offset, (h, w), hull = result

    if isinstance(paint, np.ndarray) and paint.shape == (4,):
        color = paint
        if not linear_rgb:
            color = color_ops.pre_linear_to_pre_srgb(color)
        image = mask * _f32(color, device)
        return Layer(image, offset, pre_alpha=True, linear_rgb=linear_rgb), hull

    if isinstance(paint, (GradLinear, GradRadial)):
        if paint.linear_rgb is not None:
            linear_rgb = paint.linear_rgb
        if paint.bbox_units:
            user_tr = hull.bbox_transform(transform).invert
        else:
            user_tr = transform.invert
        # device pixel -> gradient space, as one affine
        to_grad = user_tr if paint.transform is None else paint.transform.invert @ user_tr
        affine = _f32(gradient_ops.affine_2x3(to_grad), device)
        stop_offsets, stop_colors = stops_to_arrays(paint.stops, linear_rgb)
        stop_offsets, stop_colors = _f32(stop_offsets, device), _f32(stop_colors, device)
        if isinstance(paint, GradLinear):
            grad = gradient_ops.linear_fill(
                h, w, offset, affine, _f32(paint.p0, device), _f32(paint.p1, device),
                stop_offsets, stop_colors, paint.spread,
            )
        else:
            has_focal = paint.fcenter is not None or paint.fradius is not None
            fcenter = paint.center if paint.fcenter is None else paint.fcenter
            fradius = paint.fradius or 0.0
            grad = gradient_ops.radial_fill(
                h, w, offset, affine, _f32(paint.center, device),
                _f32(paint.radius, device), _f32(fcenter, device), _f32(fradius, device),
                stop_offsets, stop_colors, paint.spread, has_focal,
            )
        image = compose(COMPOSE_IN, mask, grad)
        return Layer(image, offset, pre_alpha=True, linear_rgb=linear_rgb), hull

    if isinstance(paint, Pattern):
        layer = _fill_pattern(paint, mask, offset, hull, transform, linear_rgb, device)
        if layer is None:
            return None
        return layer, hull

    warnings.warn(f"fill method is not implemented: {paint}")
    return None


def pattern_texture(paint: Pattern, hull, transform: Transform, linear_rgb: bool,
                    device="cuda"):
    """Render the pattern sub-scene once and set up the tiling frame.

    Parity: svgrasterize.py:1049-1094 (the per-draw part of pattern fill).
    Returns (pat (th+1, tw+1, 4) image on device, repeat_tr, lo (2,) int,
    (tile_h, tile_w), the sub-scene layer) or None when the sub-scene
    renders empty.  `pat` keeps the sub-scene layer's (pre_alpha,
    linear_rgb) flags — callers convert.
    """
    from .frontend.svg import viewbox_transform

    pat_tr = transform if paint.anchored else transform.no_translate()
    if paint.scene_view_box:
        if paint.bbox_units:
            px, py, pw, ph = paint.bbox()
            _hx, _hy, hw, hh = hull.bbox(transform)
            bbox = (px * hw, py * hh, pw * hw, ph * hh)
        else:
            bbox = paint.bbox()
        pat_tr = pat_tr @ viewbox_transform(bbox, paint.scene_view_box)
    elif paint.scene_bbox_units:
        pat_tr = hull.bbox_transform(pat_tr)
    pat_tr = pat_tr @ paint.transform
    result = paint.scene.render(pat_tr, linear_rgb=linear_rgb, device=device)
    if result is None:
        return None
    pat_layer, _ = result

    repeat_tr = transform
    if paint.bbox_units:
        repeat_tr = hull.bbox_transform(repeat_tr)
    repeat_tr = repeat_tr @ paint.transform
    if not paint.anchored:
        repeat_tr = repeat_tr.no_translate()

    corners = repeat_tr(
        [[0, 0], [paint.width, 0], [0, paint.height], [paint.width, paint.height]]
    )
    hi = corners.max(axis=0).astype(int)
    lo = corners.min(axis=0).astype(int)
    tile_h, tile_w = hi[0] - lo[0], hi[1] - lo[1]

    pat = torch.zeros((tile_h + 1, tile_w + 1, 4), dtype=torch.float32, device=device)
    pat = merge_at(pat, pat_layer.image, (pat_layer.x - lo[0], pat_layer.y - lo[1]))
    return pat, repeat_tr, lo, (tile_h, tile_w), pat_layer


def _fill_pattern(paint: Pattern, mask, offset, hull, transform: Transform,
                  linear_rgb: bool, device):
    """Render the pattern sub-scene once, then tile it under the mask.

    Parity: svgrasterize.py:1049-1097.  The modular tiling index grid is
    computed on host (integer gather indices), the gather runs on device.
    """
    setup = pattern_texture(paint, hull, transform, linear_rgb, device)
    if setup is None:
        return None
    pat, repeat_tr, lo, (tile_h, tile_w), pat_layer = setup

    h, w = mask.shape[:2]
    r = np.arange(h, dtype=np.float64)[:, None] + offset[0] + 0.5
    c = np.arange(w, dtype=np.float64)[None, :] + offset[1] + 0.5
    pixels = np.stack(np.broadcast_arrays(r, c), axis=-1).reshape(-1, 2)
    offsets = repeat_tr.invert(pixels)
    offsets = repeat_tr(
        np.remainder(offsets - [paint.x, paint.y], [paint.width, paint.height])
    ).astype(int)
    offsets -= lo
    idx0 = torch.as_tensor(np.clip(offsets[:, 0], 0, tile_h).reshape(h, w), device=device)
    idx1 = torch.as_tensor(np.clip(offsets[:, 1], 0, tile_w).reshape(h, w), device=device)
    tiled = pat[idx0, idx1]
    image = compose(COMPOSE_IN, mask, tiled)
    return Layer(image, offset, pre_alpha=pat_layer.pre_alpha, linear_rgb=pat_layer.linear_rgb)
