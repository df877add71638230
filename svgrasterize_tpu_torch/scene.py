"""Scene IR: a retained-mode render graph with a host interpreter.

Eight node kinds mirroring the reference (svgrasterize.py:576-859): FILL,
STROKE, GROUP, OPACITY, CLIP, MASK, TRANSFORM, FILTER.  The batched render
path (render_plan.py) lowers the graph; the interpreter (Scene.render) walks
it on the host, and every pixel operation it triggers (rasterize, paint,
compose, filter) runs on the render's device.
"""

from __future__ import annotations

import io
import textwrap
from typing import Any

import numpy as np
import torch

from .core import color as color_ops
from .core.layer import Layer
from .core.transform import Transform
from .geom.hull import ConvexHull
from .ops.compose import COMPOSE_IN, COMPOSE_OVER
from .utils.constants import DEFAULT_TILE

RENDER_FILL = 0
RENDER_STROKE = 1
RENDER_GROUP = 2
RENDER_OPACITY = 3
RENDER_CLIP = 4
RENDER_MASK = 5
RENDER_TRANSFORM = 6
RENDER_FILTER = 7


class Scene(tuple):
    """Immutable scene node: (kind, args)."""

    __slots__ = ()

    def __new__(cls, kind: int, args: tuple):
        return tuple.__new__(cls, (kind, args))

    # --- constructors -----------------------------------------------------
    @classmethod
    def fill(cls, path, paint, fill_rule: str | None = None) -> "Scene":
        return cls(RENDER_FILL, (path, paint, fill_rule))

    @classmethod
    def stroke(cls, path, paint, width, linecap=None, linejoin=None) -> "Scene":
        return cls(RENDER_STROKE, (path, paint, width, linecap, linejoin))

    @classmethod
    def group(cls, children) -> "Scene":
        children = tuple(children)
        if not children:
            raise ValueError("group must contain at least one child")
        if len(children) == 1:
            return children[0]
        return cls(RENDER_GROUP, children)

    # --- combinators --------------------------------------------------------
    def opacity(self, opacity: float) -> "Scene":
        if opacity > 0.999:
            return self
        return Scene(RENDER_OPACITY, (self, opacity))

    def clip(self, clip: "Scene", bbox_units: bool = False) -> "Scene":
        return Scene(RENDER_CLIP, (self, clip, bbox_units))

    def mask(self, mask: "Scene", bbox_units: bool = False) -> "Scene":
        return Scene(RENDER_MASK, (self, mask, bbox_units))

    def transform(self, transform: Transform) -> "Scene":
        kind, args = self
        if kind == RENDER_TRANSFORM:
            target, inner = args
            return Scene(RENDER_TRANSFORM, (target, transform @ inner))
        return Scene(RENDER_TRANSFORM, (self, transform))

    def filter(self, filter) -> "Scene":
        return Scene(RENDER_FILTER, (self, filter))

    # --- interpreter ----------------------------------------------------------
    def render(
        self,
        transform: Transform,
        mask_only: bool = False,
        viewport=None,
        linear_rgb: bool = False,
        *,
        tile: int = DEFAULT_TILE,
        device="cuda",
    ):
        """Render the graph on `device`; returns (Layer, ConvexHull) or None.

        Groups rendered with a viewport batch their maximal runs of
        lowerable children through render_plan.render_group_hybrid (the
        batched path at `tile`), as the JAX package's interpreter does.
        Before anything renders, every path mask whose transform and
        viewport are known up front is gathered (_gather_masks) and the
        gathered masks are rasterized together, one winding launch per
        batch (render.MaskBatch); masks that depend on a rendered hull
        (bounding-box clip and mask content) are rasterized alone.
        """
        from .render import MaskBatch

        masks = MaskBatch(device)
        _gather_masks(self, transform, mask_only, viewport, linear_rgb, masks)
        return self._render(transform, mask_only, viewport, linear_rgb, tile=tile,
                            device=device, masks=masks)

    def _render(self, transform: Transform, mask_only: bool, viewport, linear_rgb: bool,
                *, tile: int, device, masks):
        """Scene.render's recursion; masks: the render's render.MaskBatch."""
        from . import render

        kind, args = self
        sub = dict(tile=tile, device=device, masks=masks)

        if kind in (RENDER_FILL, RENDER_STROKE):
            path, paint = args[:2]
            if not mask_only and paint is None:
                return None
            gathered = masks.take(render.MaskBatch.key(self, transform, viewport))
            fill_rule = args[2] if kind == RENDER_FILL else None
            if kind == RENDER_STROKE and gathered is None:
                path = path.stroke(*args[2:])
            if mask_only:
                return render.path_mask(path, transform, fill_rule, viewport, device,
                                        gathered)
            return render.path_fill(path, transform, paint, fill_rule, viewport,
                                    linear_rgb, device, gathered)

        if kind == RENDER_GROUP:
            from . import render_plan

            if not mask_only and viewport is not None and render_plan.HYBRID_ENABLED:
                # batch maximal runs of lowerable children into single dispatches
                results = render_plan.render_group_hybrid(
                    args, transform, viewport, linear_rgb, **sub
                )
            else:
                results = [
                    r
                    for child in args
                    if (r := child._render(transform, mask_only, viewport, linear_rgb, **sub))
                    is not None
                ]
            if not results:
                return None
            layers = [layer for layer, _ in results]
            hulls = [hull for _, hull in results]
            group = Layer.compose(layers, COMPOSE_OVER, linear_rgb)
            if group is None:
                return None
            return group, ConvexHull.merge(hulls)

        if kind == RENDER_OPACITY:
            target, opacity = args
            result = target._render(transform, mask_only, viewport, linear_rgb, **sub)
            if result is None:
                return None
            layer, hull = result
            return layer.opacity(opacity, linear_rgb), hull

        if kind == RENDER_CLIP:
            target, clip_scene, bbox_units = args
            result = target._render(transform, mask_only, viewport, linear_rgb, **sub)
            if result is None:
                return None
            image, hull = result
            if bbox_units:
                transform = hull.bbox_transform(transform)
            clip_result = clip_scene._render(transform, True, viewport, linear_rgb, **sub)
            if clip_result is None:
                return None
            clip_mask, _ = clip_result
            out = Layer.compose([clip_mask, image], COMPOSE_IN, linear_rgb)
            if out is None:
                return None
            return out, hull

        if kind == RENDER_MASK:
            target, mask_scene, bbox_units = args
            result = target._render(transform, mask_only, viewport, linear_rgb, **sub)
            if result is None:
                return None
            image, hull = result
            if bbox_units:
                transform = hull.bbox_transform(transform)
            mask_result = mask_scene._render(transform, mask_only, viewport, linear_rgb, **sub)
            if mask_result is None:
                return None
            mask_layer, _ = mask_result
            # mask value = luminance * alpha
            mask_layer = mask_layer.convert(pre_alpha=False, linear_rgb=linear_rgb)
            lum = torch.as_tensor(color_ops.MASK_LUMINANCE, dtype=mask_layer.image.dtype,
                                  device=mask_layer.image.device)
            value = (mask_layer.image[..., :3] @ lum) * mask_layer.image[..., 3]
            mask_layer = Layer(value[..., None], mask_layer.offset, False, linear_rgb)
            out = Layer.compose([mask_layer, image], COMPOSE_IN, linear_rgb)
            if out is None:
                return None
            return out, hull

        if kind == RENDER_TRANSFORM:
            target, inner = args
            return target._render(transform @ inner, mask_only, viewport, linear_rgb, **sub)

        if kind == RENDER_FILTER:
            target, flt = args
            result = target._render(transform, mask_only, viewport, linear_rgb, **sub)
            if result is None:
                return None
            image, hull = result
            # crop the source to the reference's layer extent (floor(min)-1
            # .. ceil(max)+1 of the geometry, svgrasterize.py:966-967):
            # valid-mode morphology pooling makes the layer EXTENT part of
            # the semantics (the window anchors at the layer corner), so a
            # source larger than that diverges from the reference there
            image = _crop_to_content(image, hull)
            return flt(transform, image), hull

        raise ValueError(f"unhandled scene kind: {kind}")

    # --- utilities --------------------------------------------------------------
    def to_path(self, transform: Transform):
        """Flatten the whole scene into one Path (testing/`--as-path`)."""
        from .geom.path import Path

        def walk(scene: "Scene", transform: Transform):
            kind, args = scene
            if kind == RENDER_FILL:
                yield args[0].transform(transform)
            elif kind == RENDER_STROKE:
                path, _paint, width, linecap, linejoin = args
                yield path.transform(transform).stroke(width, linecap, linejoin)
            elif kind == RENDER_GROUP:
                for child in args:
                    yield from walk(child, transform)
            elif kind in (RENDER_OPACITY, RENDER_FILTER):
                yield from walk(args[0], transform)
            elif kind in (RENDER_CLIP, RENDER_MASK):
                yield from walk(args[0], transform)
            elif kind == RENDER_TRANSFORM:
                target, inner = args
                yield from walk(target, transform @ inner)
            else:
                raise ValueError(f"unhandled scene kind: {kind}")

        subpaths = [sub for path in walk(self, transform) for sub in path.subpaths]
        return Path(subpaths)

    def __repr__(self) -> str:
        out = io.StringIO()
        _repr_rec(self, out, 0)
        return out.getvalue()[:-1]


def _gather_masks(scene: Scene, transform: Transform, mask_only: bool, viewport,
                  linear_rgb: bool, masks) -> None:
    """Add to masks (a render.MaskBatch) the geometry of every FILL and
    STROKE mask that Scene._render will rasterize under this node, in the
    order it will: the walk follows _render through groups, transforms,
    opacity, filter, clip and mask targets, and clip / mask content in user
    units.  It skips the children render_group_hybrid lowers (the same
    can_lower test under the same conditions) and content in bounding-box
    units, whose transform depends on the target's rendered hull."""
    from . import render_plan
    from .render import MaskBatch, mask_geometry

    kind, args = scene
    if kind in (RENDER_FILL, RENDER_STROKE):
        path, paint = args[:2]
        if mask_only or paint is not None:  # path_fill draws nothing without a paint
            if kind == RENDER_STROKE:
                path = path.stroke(*args[2:])
            masks.add(MaskBatch.key(scene, transform, viewport),
                      mask_geometry(path, transform, viewport))
    elif kind == RENDER_GROUP:
        hybrid = not mask_only and viewport is not None and render_plan.HYBRID_ENABLED
        for child in args:
            if not (hybrid and render_plan.can_lower(child, linear_rgb)):
                _gather_masks(child, transform, mask_only, viewport, linear_rgb, masks)
    elif kind in (RENDER_OPACITY, RENDER_FILTER):
        _gather_masks(args[0], transform, mask_only, viewport, linear_rgb, masks)
    elif kind in (RENDER_CLIP, RENDER_MASK):
        target, content, bbox_units = args
        _gather_masks(target, transform, mask_only, viewport, linear_rgb, masks)
        if not bbox_units:
            content_mask_only = True if kind == RENDER_CLIP else mask_only
            _gather_masks(content, transform, content_mask_only, viewport, linear_rgb, masks)
    elif kind == RENDER_TRANSFORM:
        target, inner = args
        _gather_masks(target, transform @ inner, mask_only, viewport, linear_rgb, masks)


def _crop_to_content(layer: Layer, hull: ConvexHull) -> Layer:
    """Crop a layer to the reference's mask-extent convention:
    floor(min)-1 .. ceil(max)+1 of the subtree geometry, intersected with
    the layer's own extent (which is already viewport-clamped)."""
    pts = hull.raw_points
    if len(pts) == 0:
        return layer
    r0 = max(int(np.floor(pts[:, 0].min())) - 1, layer.x)
    c0 = max(int(np.floor(pts[:, 1].min())) - 1, layer.y)
    r1 = min(int(np.ceil(pts[:, 0].max())) + 1, layer.x + layer.height)
    c1 = min(int(np.ceil(pts[:, 1].max())) + 1, layer.y + layer.width)
    if r1 <= r0 or c1 <= c0:
        return layer
    if (r0, c0) == (layer.x, layer.y) and (r1 - r0, c1 - c0) == (layer.height, layer.width):
        return layer
    image = layer.image[r0 - layer.x : r1 - layer.x, c0 - layer.y : c1 - layer.y]
    return Layer(image, (r0, c0), layer.pre_alpha, layer.linear_rgb)


def _format_paint(paint: Any) -> str:
    if isinstance(paint, np.ndarray):
        return "#" + "".join(f"{c:02x}" for c in (np.clip(paint, 0, 1) * 255).astype(np.uint8))
    return str(paint)


_INDENT = "  "


def _repr_rec(scene: Scene, out: io.StringIO, depth: int) -> None:
    kind, args = scene
    out.write(_INDENT * depth)
    if kind == RENDER_FILL:
        path, paint, fill_rule = args
        out.write(f"FILL fill_rule:{fill_rule} paint:{_format_paint(paint)}\n")
        out.write(textwrap.indent(repr(path), _INDENT * (depth + 1)))
        out.write("\n")
    elif kind == RENDER_STROKE:
        path, paint, width, linecap, linejoin = args
        out.write(
            f"STROKE width:{width} linecap:{linecap} "
            f"linejoin:{linejoin} paint:{_format_paint(paint)}\n"
        )
        out.write(textwrap.indent(repr(path), _INDENT * (depth + 1)))
        out.write("\n")
    elif kind == RENDER_GROUP:
        out.write("GROUP\n")
        for child in args:
            _repr_rec(child, out, depth + 1)
    elif kind == RENDER_OPACITY:
        out.write(f"OPACITY {args[1]}\n")
        _repr_rec(args[0], out, depth + 1)
    elif kind == RENDER_CLIP:
        out.write(f"CLIP bbox_units:{args[2]}\n")
        out.write(_INDENT * (depth + 1) + "CLIP_PATH\n")
        _repr_rec(args[1], out, depth + 2)
        out.write(_INDENT * (depth + 1) + "CLIP_TARGET\n")
        _repr_rec(args[0], out, depth + 2)
    elif kind == RENDER_MASK:
        out.write(f"MASK bbox_units:{args[2]}\n")
        out.write(_INDENT * (depth + 1) + "MASK_PATH\n")
        _repr_rec(args[1], out, depth + 2)
        out.write(_INDENT * (depth + 1) + "MASK_TARGET\n")
        _repr_rec(args[0], out, depth + 2)
    elif kind == RENDER_TRANSFORM:
        out.write(f"TRANSFORM {args[1]}\n")
        _repr_rec(args[0], out, depth + 1)
    elif kind == RENDER_FILTER:
        out.write(f"FILTER {args[1]}\n")
        _repr_rec(args[0], out, depth + 1)
    else:
        raise ValueError(f"unhandled scene kind: {kind}")
