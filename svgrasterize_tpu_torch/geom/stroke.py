"""Stroke expansion: convert a path outline into a fillable path.

Strategy (same as the reference, svgrasterize.py:1105-1180, 1466-1538,
2113-2179): offset every segment to both sides (Tiller-Hanson for cubics),
stitch consecutive offset curves with joins, and close the loop with caps —
so the rasterizer only ever fills.  All geometry is host-side numpy; stroke
expansion is tiny compared to pixel work.
"""

from __future__ import annotations

import math

import numpy as np

from ..utils.constants import EPSILON, FLOAT
from . import arc as arc_ops
from . import bezier

CAP_BUTT = "butt"
CAP_ROUND = "round"
CAP_SQUARE = "square"
JOIN_MITER = "miter"
JOIN_ROUND = "round"
JOIN_BEVEL = "bevel"

# tangent-offset constant approximating a circle quarter with one cubic
CIRCLE_KAPPA = 4 * (math.sqrt(2) - 1) / 3

MAX_OFFSET_PIECES = 16


# ------------------------------------------------------------------------------
# line helpers
# ------------------------------------------------------------------------------
def line_offset(line, distance):
    """Offset a 2-point line by `distance` along its left normal; None if degenerate."""
    (x0, y0), (x1, y1) = line
    vx, vy = x1 - x0, y1 - y0
    sq = vx * vx + vy * vy
    if sq < EPSILON:
        return None
    inv = distance / math.sqrt(sq)
    nx, ny = -vy * inv, vx * inv
    return np.array([[x0 + nx, y0 + ny], [x1 + nx, y1 + ny]], dtype=FLOAT)


def line_intersect(l0, l1):
    """Intersection of two infinite lines given as segments.

    Returns (point, t0, t1) with t the segment parameters, or (None, 0, 0)
    for (near-)parallel lines.
    """
    (x1, y1), (x2, y2) = l0
    (x3, y3), (x4, y4) = l1
    det = (x4 - x3) * (y1 - y2) - (x1 - x2) * (y4 - y3)
    if abs(det) < EPSILON:
        return None, 0.0, 0.0
    t0 = ((y3 - y4) * (x1 - x3) + (x4 - x3) * (y1 - y3)) / det
    t1 = ((y1 - y2) * (x1 - x3) + (x2 - x1) * (y1 - y3)) / det
    return np.array([x1 + t0 * (x2 - x1), y1 + t0 * (y2 - y1)], dtype=FLOAT), t0, t1


# ------------------------------------------------------------------------------
# cubic offset (Tiller-Hanson)
# ------------------------------------------------------------------------------
def _cross2(a, b) -> float:
    return float(a[0] * b[1] - a[1] * b[0])


def _offset_needs_split(curve) -> bool:
    """Heuristic: is the curve too bent for a single-piece polygon offset?"""
    c0, c1, c2, c3 = curve
    base = c3 - c0
    # control polygon folds back on itself
    if np.dot(base, c2 - c1) < 0:
        return True
    # control points on opposite sides of the baseline (inflection)
    if _cross2(base, c1 - c0) * _cross2(base, c2 - c0) < 0:
        return True
    # strongly curved: centroid far from the curve midpoint
    centroid = curve.sum(axis=0) / 4
    midpoint = bezier.cubic_eval(curve, 0.5)
    dev = float(((centroid - midpoint) ** 2).sum())
    diag = float(((curve.max(axis=0) - curve.min(axis=0)) ** 2).sum())
    return dev * 100 > diag


def cubic_offset(curve, distance):
    """Offset one cubic; returns a list of curves (each an (n<=4, 2) array).

    Tiller-Hanson: offset each control-polygon leg, re-intersect neighbouring
    legs to recover control points.  Curves that are too bent are split at
    t=0.5 first (bounded to MAX_OFFSET_PIECES pieces).
    """
    curve = np.asarray(curve, dtype=FLOAT)
    pieces: list[np.ndarray] = []
    stack = [curve]
    while stack:
        cur = stack.pop()
        if len(pieces) < MAX_OFFSET_PIECES and _offset_needs_split(cur):
            lo, hi = bezier.cubic_split_half(cur)
            stack.append(hi)
            stack.append(lo)
            continue

        points: list[np.ndarray] = []
        skipped = 0
        prev_leg = None
        for a, b in zip(cur, cur[1:]):
            if np.allclose(a, b):
                skipped += 1
                continue
            off = line_offset([a, b], distance)
            o0, o1 = off
            if prev_leg is not None:
                hit, _, _ = line_intersect(prev_leg, off)
                o0 = hit if hit is not None else (prev_leg[1] + o0) / 2
            points.extend([o0] * (skipped + 1))
            skipped = 0
            prev_leg = (o0, o1)
        if prev_leg is None:
            continue  # fully degenerate
        points.extend([prev_leg[1]] * (skipped + 1))
        if pieces and not np.allclose(points[0], pieces[-1][-1]):
            # splits can leave a gap on the convex side; bridge with a round cap
            pieces.extend(cap_between(points[0], pieces[-1][-1], CAP_ROUND))
        pieces.append(np.asarray(points, dtype=FLOAT))
    return pieces


# ------------------------------------------------------------------------------
# caps and joins
# ------------------------------------------------------------------------------
def cap_between(p0, p1, linecap=None):
    """Curves connecting endpoint p0 to endpoint p1 with the given cap style."""
    linecap = linecap or CAP_BUTT
    p0 = np.asarray(p0, dtype=FLOAT)
    p1 = np.asarray(p1, dtype=FLOAT)
    if np.allclose(p0, p1):
        return []
    if linecap == CAP_BUTT:
        return [np.array([p0, p1])]
    if linecap == CAP_ROUND:
        chord = p1 - p0
        radius = float(np.linalg.norm(chord)) / 2
        unit = chord / (2 * radius)
        normal = np.array([-unit[1], unit[0]])
        k = CIRCLE_KAPPA * radius
        center = (p0 + p1) / 2
        apex = center + normal * radius
        return [
            np.array([p0, p0 + normal * k, apex - unit * k, apex]),
            np.array([apex, apex + unit * k, p1 + normal * k, p1]),
        ]
    if linecap == CAP_SQUARE:
        chord = p1 - p0
        normal = np.array([-chord[1], chord[0]])
        corners = [p0, p0 + normal / 2, p1 + normal / 2, p1]
        return [np.array([a, b]) for a, b in zip(corners, corners[1:])]
    raise ValueError(f"unknown line cap: {linecap}")


def _end_tangents(curve):
    """First and last non-degenerate control-polygon legs of a curve."""
    legs = [
        (a, b) for a, b in zip(curve, curve[1:]) if not np.allclose(a, b)
    ]
    if not legs:
        return None, None
    return legs[0], legs[-1]


def join_between(c0, c1, linejoin=None, miterlimit: float = 4):
    """Curves joining the end of offset curve c0 to the start of c1.

    linejoin may be a ("miter", limit) pair to carry stroke-miterlimit
    through the Scene tuple without widening it (SVG default limit 4)."""
    if isinstance(linejoin, (tuple, list)):
        linejoin, miterlimit = linejoin
    linejoin = linejoin or JOIN_MITER
    if linejoin == JOIN_BEVEL:
        return [np.array([c0[-1], c1[0]], dtype=FLOAT)]
    _, out_leg = _end_tangents(c0)
    in_leg, _ = _end_tangents(c1)
    if out_leg is None or in_leg is None:
        return [np.array([c0[-1], c1[0]], dtype=FLOAT)]
    if np.allclose(out_leg[-1], in_leg[0]):
        return []
    apex, t0, t1 = line_intersect(out_leg, in_leg)
    if apex is None or (0 <= t0 <= 1 and 0 <= t1 <= 1):
        # tangents intersect inside the segments (concave side) or are parallel
        return [np.array([c0[-1], c1[0]], dtype=FLOAT)]
    if abs(t0) < miterlimit and abs(t1) < miterlimit:
        if linejoin == JOIN_MITER:
            return [np.array([c0[-1], apex]), np.array([apex, c1[0]])]
        if linejoin == JOIN_ROUND:
            # approximated with a quad through the miter apex
            return [np.array([c0[-1], apex, c1[0]])]
    return [np.array([c0[-1], c1[0]], dtype=FLOAT)]


# ------------------------------------------------------------------------------
# stroke expansion driver
# ------------------------------------------------------------------------------
def stroke_path(path, width: float, linecap: str | None = None, linejoin: str | None = None):
    """Expand `path` into its stroked outline as a new fillable Path."""
    from .path import (
        PATH_ARC,
        PATH_CLOSED,
        PATH_CUBIC,
        PATH_LINE,
        PATH_QUAD,
        PATH_UNCLOSED,
        Path,
    )

    kind_by_len = {2: PATH_LINE, 3: PATH_QUAD, 4: PATH_CUBIC}
    half = width / 2
    outputs: list[list] = []

    for sub in path:
        if not sub:
            continue
        forward: list[np.ndarray] = []
        backward: list[np.ndarray] = []
        closed = False
        for kind, payload in sub:
            if kind in (PATH_LINE, PATH_CLOSED):
                closed = kind == PATH_CLOSED
                line = np.asarray(payload, dtype=FLOAT)
                fwd = line_offset(line, half)
                if fwd is None:
                    continue
                forward.append(fwd)
                backward.append(line_offset(line, -half))
            elif kind == PATH_UNCLOSED:
                closed = False
            else:
                if kind == PATH_CUBIC:
                    cubics = [np.asarray(payload, dtype=FLOAT)]
                elif kind == PATH_QUAD:
                    cubics = [bezier.quad_to_cubic(payload)]
                elif kind == PATH_ARC:
                    cubics = list(arc_ops.to_cubics(*payload))
                else:
                    raise ValueError(f"unsupported segment kind: {kind}")
                closed = False
                for cubic in cubics:
                    forward.extend(cubic_offset(cubic, half))
                    backward.extend(cubic_offset(cubic, -half))
        if not forward:
            continue

        def stitched(curve_list):
            """Curves connected by joins, in order."""
            chain: list[np.ndarray] = []
            for curve in curve_list:
                if chain:
                    chain.extend(join_between(chain[-1], curve, linejoin))
                chain.append(curve)
            return chain

        def sealed(chain):
            """Exactly-closed contour: snap each curve's start to the previous
            curve's end and the last end to the first start.  Joins/caps skip
            the bridge when endpoints are allclose (rtol leaves ~1e-4 gaps at
            typical coordinates), and any net-dy gap in a contour leaks that
            much winding to every pixel right of it — visible as stray
            almost-transparent pixels outside the stroke."""
            out = []
            prev_end = None
            for curve in chain:
                c = np.array(curve, dtype=FLOAT)
                if prev_end is not None:
                    c[0] = prev_end
                prev_end = c[-1]
                out.append(c)
            out[-1][-1] = out[0][0]
            return out

        chain = stitched(forward)
        if closed:
            chain.extend(join_between(chain[-1], chain[0], linejoin))
            outputs.append([(kind_by_len[len(c)], c) for c in sealed(chain)])
            chain = []
        else:
            chain.extend(cap_between(chain[-1][-1], backward[-1][-1], linecap))

        for curve in (list(reversed(c)) for c in reversed(backward)):
            curve = np.asarray(curve, dtype=FLOAT)
            if chain:
                chain.extend(join_between(chain[-1], curve, linejoin))
            chain.append(curve)
        if closed:
            chain.extend(join_between(chain[-1], chain[0], linejoin))
        else:
            chain.extend(cap_between(chain[-1][-1], chain[0][0], linecap))
        outputs.append([(kind_by_len[len(c)], c) for c in sealed(chain)])

    return Path(outputs)
