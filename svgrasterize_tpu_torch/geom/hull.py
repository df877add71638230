"""Convex hulls and objectBoundingBox transforms.

Parity target: svgrasterize.py:1963-2029.  Points are kept
in the presentation (device) coordinate system so merging is free of
transform round-trips.

Hull vertex computation is LAZY: bounding boxes (the overwhelmingly common
query — gradients, patterns, bbox-units clips) only need min/max over the
raw points, so the chain is never built unless .points is accessed.  When it
is, scipy's qhull is used if available, with a pure-numpy monotone chain as
the fallback.  Merging concatenates raw point sets, collapsing through the
hull only when the set grows large.
"""

from __future__ import annotations

from typing import Iterable

import numpy as np

from ..utils.constants import FLOAT
from ..core.transform import Transform

_REDUCE_THRESHOLD = 4096  # collapse raw points to hull vertices beyond this


class ConvexHull:
    __slots__ = ("_raw", "_hull")

    def __init__(self, points):
        self._raw = np.asarray(points, dtype=FLOAT).reshape(-1, 2)
        self._hull: np.ndarray | None = None

    @property
    def points(self) -> np.ndarray:
        """Hull vertices in CCW order (computed on first access)."""
        if self._hull is None:
            self._hull = _hull_vertices(self._raw)
        return self._hull

    @property
    def raw_points(self) -> np.ndarray:
        """The underlying point set (device coords), without hull reduction."""
        return self._raw

    @classmethod
    def merge(cls, hulls: Iterable["ConvexHull"]) -> "ConvexHull":
        parts = []
        for h in hulls:
            if h is None:
                continue
            raw = h._hull if h._hull is not None else h._raw
            if len(raw):
                parts.append(raw if len(raw) <= _REDUCE_THRESHOLD else h.points)
        if not parts:
            return cls(np.zeros((0, 2)))
        merged = cls(np.concatenate(parts, axis=0))
        if len(merged._raw) > _REDUCE_THRESHOLD:
            merged._raw = _hull_vertices(merged._raw)
        return merged

    def bbox(self, transform: Transform):
        """Bounding box (x, y, w, h) in user space (inverse-transformed)."""
        if len(self._raw) == 0:
            return (0.0, 0.0, 0.0, 0.0)
        points = transform.invert(self._raw)
        lo = points.min(axis=0)
        hi = points.max(axis=0)
        return (lo[0], lo[1], hi[0] - lo[0], hi[1] - lo[1])

    def bbox_transform(self, transform: Transform) -> Transform:
        """Transform mapping the unit square onto this hull's user-space bbox."""
        x, y, w, h = self.bbox(transform)
        if w <= 0 and h <= 0:
            return transform
        return transform.translate(x, y).scale(w, h)

    def path(self):
        from .path import Path, PATH_CLOSED, PATH_LINE

        pts = self.points.tolist()
        segs = [(PATH_LINE, [a, b]) for a, b in zip(pts, pts[1:])]
        segs.append((PATH_CLOSED, [pts[-1], pts[0]]))
        return Path([segs])


def _hull_vertices(pts: np.ndarray) -> np.ndarray:
    if len(pts) <= 2:
        return pts.copy()
    try:
        from scipy.spatial import ConvexHull as _QHull
        from scipy.spatial import QhullError

        try:
            qh = _QHull(pts)
            return pts[qh.vertices]
        except QhullError:
            pass  # degenerate (collinear) input: fall through
    except ImportError:
        pass
    return _monotone_chain(pts)


def _monotone_chain(pts: np.ndarray) -> np.ndarray:
    """Andrew's monotone chain; returns hull vertices in CCW order."""
    order = np.lexsort((pts[:, 1], pts[:, 0]))
    pts = pts[order]

    def build(points):
        out: list[np.ndarray] = []
        for p in points:
            while len(out) >= 2 and _cross(out[-2], out[-1], p) <= 0:
                out.pop()
            if not out or not np.array_equal(out[-1], p):
                out.append(p)
        return out

    lower = build(pts)
    upper = build(pts[::-1])
    hull = lower + upper[1:-1]
    return np.asarray(hull, dtype=FLOAT)


def _cross(o, a, b) -> float:
    return (a[0] - o[0]) * (b[1] - o[1]) - (b[0] - o[0]) * (a[1] - o[1])