"""Scene IR: a retained-mode render graph.

Eight node kinds mirroring the reference (svgrasterize.py:576-859): FILL,
STROKE, GROUP, OPACITY, CLIP, MASK, TRANSFORM, FILTER.  The batched render
path (render_plan.py) lowers the graph; the per-path interpreter is not
ported yet, so Scene.render raises.
"""

from __future__ import annotations

import io
import textwrap
from typing import Any

import numpy as np

from .core.transform import Transform

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
    ):
        """The per-path interpreter; not ported yet (ROADMAP queue 1 item 7).

        Scenes the batched path cannot lower have no other route in this
        port, so this raises instead of rendering something else.
        """
        raise NotImplementedError(
            "Scene.render (the interpreter) is not ported yet "
            "(ROADMAP queue 1 item 7)"
        )

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
