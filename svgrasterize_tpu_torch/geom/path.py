"""Path core: segment taxonomy, SVG path-data codec, flattening, transforms.

Segment model matches the reference's (svgrasterize.py:865-908):
subpaths are lists of (kind, payload) where the payload is a point list, and a
terminating CLOSED/UNCLOSED segment records the implicit closing edge (fills
always close; strokes only close CLOSED subpaths).
"""

from __future__ import annotations

import io
import re
from typing import Iterator

import numpy as np

from ..utils.constants import FLOAT, FLOAT_RE, FLATNESS
from ..core.transform import Transform
from . import arc as arc_ops
from . import bezier

PATH_LINE = 0
PATH_QUAD = 1
PATH_CUBIC = 2
PATH_ARC = 3
PATH_CLOSED = 4
PATH_UNCLOSED = 5
PATH_LINES = {PATH_LINE, PATH_CLOSED, PATH_UNCLOSED}

FILL_NONZERO = "nonzero"
FILL_EVENODD = "evenodd"

_TOKEN_RE = re.compile(r"[MmZzLlHhVvCcSsQqTtAa]|" + FLOAT_RE.pattern)
# argument count per command letter (lowercased)
_ARITY = {"m": 2, "z": 0, "l": 2, "h": 1, "v": 1, "c": 6, "s": 4, "q": 4, "t": 2, "a": 7}


def _nonzero_dir(candidates):
    """First candidate direction with nonzero length (degenerate controls)."""
    for c in candidates:
        c = np.asarray(c, dtype=FLOAT)
        if np.linalg.norm(c) > 1e-12:
            return c
    return np.array([1.0, 0.0], dtype=FLOAT)


class Path:
    """A sequence of subpaths; the unit of filling and stroking."""

    __slots__ = ("subpaths",)

    def __init__(self, subpaths):
        self.subpaths = subpaths

    def __iter__(self) -> Iterator[list]:
        return iter(self.subpaths)

    def __bool__(self) -> bool:
        return bool(self.subpaths)

    def is_empty(self) -> bool:
        return not self.subpaths

    # --- geometry ---------------------------------------------------------
    def segments_as_curves(self):
        """Split into raw line segments (N, 2, 2) and cubics (M, 4, 2).

        Quads are degree-elevated; arcs are sliced into cubics; CLOSED and
        UNCLOSED terminators contribute their implicit closing line.
        """
        lines: list = []
        cubics: list = []
        for sub in self.subpaths:
            for kind, payload in sub:
                if kind in PATH_LINES:
                    lines.append(payload)
                elif kind == PATH_CUBIC:
                    cubics.append(payload)
                elif kind == PATH_QUAD:
                    cubics.append(bezier.quad_to_cubic(payload))
                elif kind == PATH_ARC:
                    cubics.extend(arc_ops.to_cubics(*payload))
                else:
                    raise ValueError(f"unsupported segment kind: {kind}")
        lines_arr = np.asarray(lines, dtype=FLOAT).reshape(-1, 2, 2)
        cubics_arr = np.asarray(cubics, dtype=FLOAT).reshape(-1, 4, 2)
        return lines_arr, cubics_arr

    def flatten(self, transform: Transform, tolerance: float = FLATNESS) -> np.ndarray:
        """Transform into device space and flatten everything to lines (K, 2, 2)."""
        lines, cubics = self.segments_as_curves()
        lines = transform(lines)
        cubics = transform(cubics)
        if cubics.size:
            flat = bezier.flatten_cubics(cubics, tolerance)
            lines = np.concatenate([lines, flat]) if lines.size else flat
        return lines

    def vertex_frames(self):
        """Marker frames: per-subpath [(point (2,), dir_in, dir_out)].

        dir_in/dir_out are unnormalized tangent vectors into/out of each
        vertex (None at open ends).  Used by SVG marker placement — a
        feature the reference does not support at all.
        """
        frames_all = []
        for sub in self.subpaths:
            segs = []  # (start, end, tan_start, tan_end)
            closed = False
            for kind, payload in sub:
                if kind == PATH_UNCLOSED:
                    continue
                p = None if kind == PATH_ARC else np.asarray(payload, dtype=FLOAT)
                if kind in PATH_LINES:  # LINE / CLOSED share the layout
                    if kind == PATH_CLOSED:
                        closed = True
                        if np.linalg.norm(p[1] - p[0]) < 1e-12:
                            continue  # zero-length closing edge
                    d = p[1] - p[0]
                    segs.append((p[0], p[1], d, d))
                elif kind == PATH_QUAD:
                    t0 = _nonzero_dir([p[1] - p[0], p[2] - p[0]])
                    t1 = _nonzero_dir([p[2] - p[1], p[2] - p[0]])
                    segs.append((p[0], p[2], t0, t1))
                elif kind == PATH_CUBIC:
                    t0 = _nonzero_dir([p[1] - p[0], p[2] - p[0], p[3] - p[0]])
                    t1 = _nonzero_dir([p[3] - p[2], p[3] - p[1], p[3] - p[0]])
                    segs.append((p[0], p[3], t0, t1))
                elif kind == PATH_ARC:
                    cubics = arc_ops.to_cubics(*payload)
                    if not len(cubics):
                        continue
                    c0, c1 = np.asarray(cubics[0]), np.asarray(cubics[-1])
                    segs.append(
                        (c0[0], c1[3], _nonzero_dir([c0[1] - c0[0]]),
                         _nonzero_dir([c1[3] - c1[2]]))
                    )
            if not segs:
                continue
            frames = []
            n = len(segs)
            for i, (start, _end, tan_in, _tan_out) in enumerate(segs):
                if i == 0:
                    d_in = segs[-1][3] if closed else None
                else:
                    d_in = segs[i - 1][3]
                frames.append((start, d_in, tan_in))
            if not closed:
                frames.append((segs[-1][1], segs[-1][3], None))
            frames_all.append(frames)
        return frames_all

    def polylines(self, tolerance: float = 0.25) -> list:
        """Flatten each subpath into ((M, 2) points, closed) polylines.

        Curves flatten at `tolerance` user units; closed subpaths include
        the closing edge so the polyline ends at its start point.  Shared
        by dashing and textPath layout.
        """
        out = []
        for sub in self.subpaths:
            sub_closed = any(kind == PATH_CLOSED for kind, _ in sub)
            pts: list = []
            for kind, payload in sub:
                if kind == PATH_UNCLOSED:
                    continue
                if kind in PATH_LINES:
                    seg_pts = np.asarray(payload, dtype=FLOAT)
                else:
                    if kind == PATH_QUAD:
                        cubics = bezier.quad_to_cubic(np.asarray(payload, FLOAT))[None]
                    elif kind == PATH_CUBIC:
                        cubics = np.asarray(payload, dtype=FLOAT)[None]
                    else:
                        cubics = np.asarray(arc_ops.to_cubics(*payload))
                    flat = bezier.flatten_cubics(cubics, tolerance)
                    if not flat.size:
                        continue
                    seg_pts = np.concatenate([flat[:, 0], flat[-1:, 1]], axis=0)
                if not pts:
                    pts.append(seg_pts[0])
                pts.extend(seg_pts[1:])
            if len(pts) >= 2:
                out.append((np.asarray(pts, dtype=FLOAT), sub_closed))
        return out

    def dash(self, dashes, offset: float = 0.0, tolerance: float = 0.25) -> "Path":
        """Split into "on" dash runs per SVG stroke-dasharray (+dashoffset).

        Curves are flattened at `tolerance` user units first; every "on"
        run becomes an open subpath, so stroking applies caps at dash ends.
        The reference has no dashing support.  On a closed subpath whose
        start falls inside an "on" period, the trailing dash wraps the
        seam and merges with the leading dash (SVG 11.4: the closure gets
        a line JOIN, not two caps); a dash pattern that never switches off
        keeps the subpath closed.
        """
        dashes = [float(v) for v in dashes]
        if len(dashes) % 2:
            dashes = dashes + dashes
        total = sum(dashes)
        if total <= 0 or any(v < 0 for v in dashes):
            return self

        def lines_subpath(points, closed=False):
            if closed and np.allclose(points[0], points[-1]):
                points = points[:-1]
            sub = [
                (PATH_LINE, [points[i].tolist(), points[i + 1].tolist()])
                for i in range(len(points) - 1)
            ]
            sub.append(
                (
                    PATH_CLOSED if closed else PATH_UNCLOSED,
                    [points[-1].tolist(), points[0].tolist()],
                )
            )
            return sub

        out_subs = []
        for points, sub_closed in self.polylines(tolerance):
            if len(points) < 2:
                continue
            lengths = np.linalg.norm(points[1:] - points[:-1], axis=1)

            idx = 0
            phase = offset % total
            while phase >= dashes[idx] - 1e-12:
                phase -= dashes[idx]
                idx = (idx + 1) % len(dashes)
            on = idx % 2 == 0
            started_on = on
            runs: list = []
            current: list = [points[0]] if on else []
            for i, seg_len in enumerate(lengths):
                a, b, length = points[i], points[i + 1], float(seg_len)
                if length <= 1e-12:
                    continue
                s = 0.0
                while s < length - 1e-12:
                    step = min(dashes[idx] - phase, length - s)
                    s += step
                    cut = a + (b - a) * (s / length)
                    if on:
                        current.append(cut)
                    phase += step
                    if phase >= dashes[idx] - 1e-12:
                        idx = (idx + 1) % len(dashes)
                        phase = 0.0
                        if on:
                            if len(current) >= 2:
                                runs.append(current)
                            current = []
                            on = False
                        else:
                            on = True
                            current = [cut]
            trailing = on and len(current) >= 2
            if trailing:
                runs.append(current)
            if sub_closed and trailing and started_on:
                if len(runs) == 1:
                    # the pattern never switched off around the loop
                    out_subs.append(lines_subpath(runs[0], closed=True))
                    continue
                # the trailing dash ends at the subpath seam where the
                # leading dash starts: join them across the closure
                runs[0] = runs.pop() + runs[0][1:]
            out_subs.extend(lines_subpath(r) for r in runs)
        return Path(out_subs)

    def transform(self, transform: Transform) -> "Path":
        out = []
        for sub in self.subpaths:
            if not sub:
                continue
            new_sub = []
            for kind, payload in sub:
                if kind == PATH_ARC:
                    for cubic in arc_ops.to_cubics(*payload):
                        new_sub.append((PATH_CUBIC, transform(cubic).tolist()))
                else:
                    new_sub.append((kind, transform(np.asarray(payload, dtype=FLOAT)).tolist()))
            out.append(new_sub)
        return Path(out)

    def stroke(self, width: float, linecap: str | None = None, linejoin: str | None = None) -> "Path":
        from .stroke import stroke_path

        return stroke_path(self, width, linecap, linejoin)

    # --- rasterization entry points (device) -------------------------------
    def mask(self, transform: Transform, fill_rule: str | None = None, viewport=None,
             device="cuda"):
        from ..render import path_mask

        return path_mask(self, transform, fill_rule, viewport, device)

    def fill(self, transform: Transform, paint, fill_rule: str | None = None, viewport=None,
             linear_rgb: bool = True, device="cuda"):
        from ..render import path_fill

        return path_fill(self, transform, paint, fill_rule, viewport, linear_rgb, device)

    # --- codec -------------------------------------------------------------
    @staticmethod
    def from_svg(text: str) -> "Path":
        """Parse SVG path data (full M/L/H/V/C/S/Q/T/A/Z, absolute + relative)."""
        tokens = _TOKEN_RE.findall(text)
        # validate we consumed everything but separators
        residue = _TOKEN_RE.sub("", text).strip(" \t\r\n,")
        if residue:
            raise ValueError(f"invalid path data near: {residue[:20]!r}")

        subpaths: list[list] = []
        current: list = []
        pos = np.zeros(2, dtype=FLOAT)
        start = np.zeros(2, dtype=FLOAT)
        reflect_cubic: np.ndarray | None = None
        reflect_quad: np.ndarray | None = None

        idx = 0
        n = len(tokens)

        def take(count: int) -> list[float]:
            nonlocal idx
            if idx + count > n:
                raise ValueError("unexpected end of path data")
            vals = tokens[idx : idx + count]
            idx += count
            return [float(v) for v in vals]

        def take_flag() -> float:
            # SVG 1.1 path grammar: an arc flag is a single '0'/'1' that
            # needs no separator from the following number.  The float
            # tokenizer greedily merges minified input like "a25 25 0 0175
            # 25" — split the leading flag char off and leave the remainder
            # in the stream.  (The reference documents that it breaks on
            # this, svgrasterize.py:1372-1374.)
            nonlocal idx
            if idx >= n:
                raise ValueError("unexpected end of path data")
            tok = tokens[idx]
            if tok in ("0", "1"):
                idx += 1
                return float(tok)
            if tok[0] in "01":
                tokens[idx] = tok[1:]
                return float(tok[0])
            raise ValueError(f"invalid arc flag: {tok!r}")

        def flush_open():
            nonlocal current
            if current:
                current.append((PATH_UNCLOSED, [pos.tolist(), start.tolist()]))
                subpaths.append(current)
                current = []

        cmd = None
        while idx < n:
            token = tokens[idx]
            if token.isalpha() and token.lower() in _ARITY:
                cmd = token
                idx += 1
                if cmd in "Zz":
                    current.append((PATH_CLOSED, [pos.tolist(), start.tolist()]))
                    subpaths.append(current)
                    current = []
                    pos = start.copy()
                    reflect_cubic = reflect_quad = None
                    continue
            elif cmd is None:
                raise ValueError(f"path data must start with a command: {token!r}")
            elif cmd in "Zz":
                raise ValueError("'z' takes no arguments")

            rel = cmd.islower()
            low = cmd.lower()

            def absolute(point):
                return pos + point if rel else np.asarray(point, dtype=FLOAT)

            if low == "m":
                move = take(2)
                flush_open()
                pos = absolute(move)
                start = pos.copy()
                cmd = "l" if rel else "L"  # extra pairs are implicit linetos
                reflect_cubic = reflect_quad = None
            elif low == "l":
                dst = absolute(take(2))
                current.append((PATH_LINE, [pos.tolist(), dst.tolist()]))
                pos = dst
                reflect_cubic = reflect_quad = None
            elif low == "h":
                (x,) = take(1)
                dst = np.array([pos[0] + x if rel else x, pos[1]], dtype=FLOAT)
                current.append((PATH_LINE, [pos.tolist(), dst.tolist()]))
                pos = dst
                reflect_cubic = reflect_quad = None
            elif low == "v":
                (y,) = take(1)
                dst = np.array([pos[0], pos[1] + y if rel else y], dtype=FLOAT)
                current.append((PATH_LINE, [pos.tolist(), dst.tolist()]))
                pos = dst
                reflect_cubic = reflect_quad = None
            elif low == "c":
                vals = take(6)
                c0, c1, p1 = (absolute(vals[i : i + 2]) for i in (0, 2, 4))
                current.append((PATH_CUBIC, [pos.tolist(), c0.tolist(), c1.tolist(), p1.tolist()]))
                reflect_cubic = 2 * p1 - c1
                reflect_quad = None
                pos = p1
            elif low == "s":
                vals = take(4)
                c1, p1 = (absolute(vals[i : i + 2]) for i in (0, 2))
                c0 = pos if reflect_cubic is None else reflect_cubic
                current.append((PATH_CUBIC, [pos.tolist(), np.asarray(c0).tolist(), c1.tolist(), p1.tolist()]))
                reflect_cubic = 2 * p1 - c1
                reflect_quad = None
                pos = p1
            elif low == "q":
                vals = take(4)
                c0, p1 = (absolute(vals[i : i + 2]) for i in (0, 2))
                current.append((PATH_QUAD, [pos.tolist(), c0.tolist(), p1.tolist()]))
                reflect_quad = 2 * p1 - c0
                reflect_cubic = None
                pos = p1
            elif low == "t":
                p1 = absolute(take(2))
                c0 = pos if reflect_quad is None else reflect_quad
                current.append((PATH_QUAD, [pos.tolist(), np.asarray(c0).tolist(), p1.tolist()]))
                reflect_quad = 2 * p1 - np.asarray(c0)
                reflect_cubic = None
                pos = p1
            elif low == "a":
                rx, ry, rot = take(3)
                large = take_flag()
                sweep = take_flag()
                dx, dy = take(2)
                dst = absolute([dx, dy])
                src = pos.copy()
                pos = dst
                if rx == 0 or ry == 0:
                    current.append((PATH_LINE, [src.tolist(), dst.tolist()]))
                else:
                    params = arc_ops.endpoint_to_center(
                        src, dst, rx, ry, rot, large > 0.001, sweep > 0.001
                    )
                    current.append((PATH_ARC, params))
                reflect_cubic = reflect_quad = None
            else:
                raise ValueError(f"unsupported command: {cmd!r}")

        flush_open()
        return Path(subpaths)

    def to_svg(self) -> str:
        """Serialize to SVG path data (arcs are emitted as cubics)."""
        out = io.StringIO()
        for sub in self.subpaths:
            if not sub:
                continue
            prev = None
            for kind, payload in sub:
                if kind == PATH_LINE:
                    (x0, y0), (x1, y1) = payload
                    if prev is None:
                        out.write(f"M{x0:g},{y0:g} ")
                    elif prev != PATH_LINE:
                        out.write("L")
                    out.write(f"{x1:g},{y1:g} ")
                    prev = PATH_LINE
                elif kind == PATH_QUAD:
                    (x0, y0), (cx, cy), (x1, y1) = payload
                    if prev is None:
                        out.write(f"M{x0:g},{y0:g} ")
                    if prev != PATH_QUAD:
                        out.write("Q")
                    out.write(f"{cx:g},{cy:g} {x1:g},{y1:g} ")
                    prev = PATH_QUAD
                elif kind in (PATH_CUBIC, PATH_ARC):
                    cubics = arc_ops.to_cubics(*payload) if kind == PATH_ARC else [payload]
                    for cub in cubics:
                        (x0, y0), (ax, ay), (bx, by), (x1, y1) = np.asarray(cub)
                        if prev is None:
                            out.write(f"M{x0:g},{y0:g} ")
                        if prev != PATH_CUBIC:
                            out.write("C")
                        out.write(f"{ax:g},{ay:g} {bx:g},{by:g} {x1:g},{y1:g} ")
                        prev = PATH_CUBIC
                elif kind == PATH_CLOSED:
                    out.write("Z ")
                    prev = None
                elif kind == PATH_UNCLOSED:
                    prev = None
                else:
                    raise ValueError(f"unhandled segment kind: {kind}")
            out.write("\n")
        return out.getvalue()[:-1]

    def __repr__(self) -> str:
        if not self.subpaths:
            return "EMPTY"
        names = {PATH_LINE: "LINE", PATH_QUAD: "QUAD", PATH_CUBIC: "CUBIC"}
        out = io.StringIO()
        for sub in self.subpaths:
            for kind, payload in sub:
                if kind in names:
                    coords = " ".join(f"{x:.4g},{y:.4g}" for x, y in payload)
                    out.write(f"{names[kind]} {coords}\n")
                elif kind == PATH_ARC:
                    center, rx, ry, phi, eta, eta_delta = payload
                    out.write(
                        f"ARC {center[0]:.4g},{center[1]:.4g} {rx:.4g} {ry:.4g} "
                        f"{phi:.3g} {eta:.3g} {eta_delta:.3g}\n"
                    )
                elif kind == PATH_CLOSED:
                    out.write("CLOSE\n")
        return out.getvalue()[:-1]
