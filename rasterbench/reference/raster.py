"""The plain reference renderer of the benchmark's documents.

Plain PyTorch (and NumPy for the geometry), written from the SVG semantics
of the documents' generators alone: it imports nothing of the program under
test, and renders the documents' records (docs/*.py), not the program's
scene, plan or tables.

Semantics, as the system's renderer defines them (upstream svgrasterize.py):

- device space is user space times the viewport's scale; a pixel's value is
  its exact area coverage: each edge adds, to every pixel of each row it
  crosses, its signed height in that row times the share of that height
  that lies left of the pixel's right side; nonzero coverage is
  min(|winding|, 1), evenodd |((winding + 1) mod 2) - 1|;
- curves are flattened finely here (FLATNESS device pixels), so the
  reference stands for the true curve;
- paint is premultiplied sRGB; gradient stops are premultiplied by their
  stop-opacity and interpolated piecewise-linearly; objectBoundingBox
  gradients map the unit square onto the shape's user-space bounding box;
  spreads: pad clamps, repeat takes t - trunc(t) (numpy's modf, as the
  system does: negative t keeps its sign and clamps to the first stop),
  reflect |((t + 1) mod 2) - 1|; radial gradients use the two-circle form
  with the focal radius 0, and paint only where t > 0;
- fill-opacity multiplies the premultiplied paint; a user-space clipPath
  multiplies the draw's coverage by the clip shape's nonzero coverage;
- draws compose OVER in document order onto a transparent canvas.

Every tensor computation runs in `dtype`, so the same code in a lower
precision is the benchmark's control.
"""

from __future__ import annotations

import math

import numpy as np
import torch

FLATNESS = 0.02  # device pixels between a flattened curve and the curve


# ----------------------------------------------------------------------------
# geometry (NumPy, float64, device coordinates: x = column, y = row)
# ----------------------------------------------------------------------------
def _cubic_points(p0, p1, p2, p3, scale: float) -> np.ndarray:
    """Points of a cubic after p0, flattened within FLATNESS device pixels
    (Wang's bound on uniform subdivisions)."""
    pts = np.array([p0, p1, p2, p3], np.float64) * scale
    m = max(np.linalg.norm(pts[0] - 2 * pts[1] + pts[2]),
            np.linalg.norm(pts[1] - 2 * pts[2] + pts[3]))
    n = max(1, int(math.ceil(math.sqrt(3.0 * m / (4.0 * FLATNESS)))))
    t = np.arange(1, n + 1, dtype=np.float64)[:, None] / n
    u = 1.0 - t
    return (u ** 3 * pts[0] + 3 * u * u * t * pts[1] + 3 * u * t * t * pts[2]
            + t ** 3 * pts[3])


def _ring_edges(rings) -> np.ndarray:
    """(E, 4) edges [x0, y0, x1, y1] of closed rings of points."""
    out = []
    for ring in rings:
        ring = np.asarray(ring, np.float64).reshape(-1, 2)
        if len(ring) >= 2:
            out.append(np.concatenate([ring, np.roll(ring, -1, axis=0)], axis=1))
    return np.concatenate(out) if out else np.zeros((0, 4))


def circle_ring(cx: float, cy: float, r: float, scale: float) -> np.ndarray:
    """An inscribed polygon of a circle within FLATNESS device pixels."""
    rd = r * scale
    if rd <= 0:
        return np.zeros((0, 2))
    n = max(8, int(math.ceil(math.pi / math.acos(max(-1.0, 1.0 - FLATNESS / rd)))))
    n += -n % 4  # the four extreme points are vertices: the bbox is exact
    a = np.arange(n, dtype=np.float64) * (2 * math.pi / n)
    return np.stack([cx + r * np.cos(a), cy + r * np.sin(a)], axis=1) * scale


def path_rings(cmds, scale: float) -> list:
    """Closed device-space rings of a path's commands (M, L, Q, T, C, Z, all
    absolute); every subpath is closed for filling."""
    rings, ring = [], []
    cur = start = np.zeros(2)
    last_q = None  # the previous quadratic's control point, for T
    for cmd in cmds:
        op, args = cmd[0], np.asarray(cmd[1:], np.float64)
        if op == "M":
            if len(ring) > 1:
                rings.append(np.array(ring))
            cur = start = args[:2]
            ring = [cur * scale]
            last_q = None
        elif op == "L":
            cur = args[:2]
            ring.append(cur * scale)
            last_q = None
        elif op in ("Q", "T"):
            if op == "Q":
                ctrl, end = args[:2], args[2:4]
            else:
                ctrl = cur if last_q is None else 2 * cur - last_q
                end = args[:2]
            c1 = cur + 2.0 / 3.0 * (ctrl - cur)
            c2 = end + 2.0 / 3.0 * (ctrl - end)
            ring.extend(_cubic_points(cur, c1, c2, end, scale))
            cur, last_q = end, ctrl
        elif op == "C":
            ring.extend(_cubic_points(cur, args[:2], args[2:4], args[4:6], scale))
            cur = args[4:6]
            last_q = None
        elif op == "Z":
            if len(ring) > 1:
                rings.append(np.array(ring))
            ring = [start * scale]
            cur = start
            last_q = None
        else:
            raise ValueError(f"path command {op!r}")
    if len(ring) > 1:
        rings.append(np.array(ring))
    return rings


def shape_edges(item: dict, scale: float) -> np.ndarray:
    """(E, 4) device-space edges of a record's shape."""
    kind = item["shape"]
    if kind == "rect":
        x, y, w, h = item["x"], item["y"], item["w"], item["h"]
        ring = np.array([[x, y], [x + w, y], [x + w, y + h], [x, y + h]]) * scale
        return _ring_edges([ring])
    if kind == "circle":
        return _ring_edges([circle_ring(item["cx"], item["cy"], item["r"], scale)])
    if kind == "path":
        return _ring_edges(path_rings(item["d"], scale))
    raise ValueError(f"shape {kind!r}")


def clip_edges(clip: dict, scale: float) -> np.ndarray:
    """(E, 4) device-space edges of a user-space clipPath's one shape."""
    if clip["kind"] == "circle":
        return _ring_edges([circle_ring(clip["cx"], clip["cy"], clip["r"], scale)])
    x, y, w, h = clip["x"], clip["y"], clip["w"], clip["h"]
    pts = np.array([[x, y], [x + w, y], [x + w, y + h], [x, y + h]], np.float64)
    a, cx, cy = clip.get("rotate", (0.0, 0.0, 0.0))
    ca, sa = math.cos(math.radians(a)), math.sin(math.radians(a))
    dx, dy = pts[:, 0] - cx, pts[:, 1] - cy
    pts = np.stack([cx + dx * ca - dy * sa, cy + dx * sa + dy * ca], axis=1)
    return _ring_edges([pts * scale])


def edges_box(edges: np.ndarray, height: int, width: int):
    """(r0, r1, c0, c1): the canvas pixels the edges can cover, or None."""
    if len(edges) == 0:
        return None
    xs, ys = edges[:, 0::2], edges[:, 1::2]
    r0, r1 = max(0, int(math.floor(ys.min()))), min(height, int(math.ceil(ys.max())))
    c0, c1 = max(0, int(math.floor(xs.min()))), min(width, int(math.floor(xs.max())) + 1)
    if r0 >= r1 or c0 >= c1:
        return None
    return r0, r1, c0, c1


# ----------------------------------------------------------------------------
# coverage
# ----------------------------------------------------------------------------
def _expand(counts: torch.Tensor):
    """(owner, k) of every k < counts[owner], in owner order."""
    owner = torch.repeat_interleave(torch.arange(len(counts), device=counts.device), counts)
    start = torch.cumsum(counts, 0) - counts
    return owner, torch.arange(len(owner), device=counts.device) - start[owner]


def winding(edges: np.ndarray, box, dtype, device) -> torch.Tensor:
    """(r1 - r0, c1 - c0) exact-area winding of edges over a box of pixels."""
    r0, r1, c0, c1 = box
    h, w = r1 - r0, c1 - c0
    acc = torch.zeros(h * w, dtype=dtype, device=device)
    delta = torch.zeros(h, w + 1, dtype=dtype, device=device)
    e = edges[edges[:, 1] != edges[:, 3]] - np.array([c0, r0, c0, r0], np.float64)
    if len(e):
        x0, y0, x1, y1 = torch.as_tensor(e, device=device).to(dtype).unbind(1)
        down = y1 > y0
        sign = torch.where(down, 1.0, -1.0).to(dtype)
        ylo, yhi = torch.where(down, y0, y1), torch.where(down, y1, y0)
        xlo, xhi = torch.where(down, x0, x1), torch.where(down, x1, x0)
        slope = (xhi - xlo) / (yhi - ylo)
        rlo = torch.floor(ylo).long().clamp(0, h)
        rhi = torch.ceil(yhi).long().clamp(0, h)
        # one pair per (edge, row) the edge crosses
        ei, k = _expand((rhi - rlo).clamp(min=0))
        row = rlo[ei] + k
        rowf = row.to(dtype)
        lo = torch.maximum(ylo[ei], rowf)
        hi = torch.minimum(yhi[ei], rowf + 1)
        s = sign[ei] * (hi - lo).clamp(min=0)
        xa = xlo[ei] + slope[ei] * (lo - ylo[ei])
        xb = xlo[ei] + slope[ei] * (hi - ylo[ei])
        cmin = torch.floor(torch.minimum(xa, xb)).long()
        cmax = torch.floor(torch.maximum(xa, xb)).long()
        # every pixel right of the pair's last cell gets its whole height
        delta.index_put_((row, (cmax + 1).clamp(0, w)), s, accumulate=True)
        # the cells the pair crosses get the share left of their right side
        lo_c, hi_c = cmin.clamp(min=0), cmax.clamp(max=w - 1)
        pi, k = _expand((hi_c - lo_c + 1).clamp(min=0))
        col = lo_c[pi] + k
        right = col.to(dtype) + 1
        g0, g1 = right - xa[pi], right - xb[pi]
        a, b = torch.minimum(g0, g1), torch.maximum(g0, g1)
        u0, u1 = a.clamp(0, 1), b.clamp(0, 1)
        span = b - a
        safe = torch.where(span > 0, span, torch.ones_like(span))
        mean = ((u1 - u0) / safe * (u0 + u1) * 0.5
                + (torch.clamp(b, min=1) - torch.clamp(a, min=1)) / safe)
        mean = torch.where(span > 0, mean, u0)
        acc.index_put_((row[pi] * w + col,), s[pi] * mean, accumulate=True)
    return acc.view(h, w) + torch.cumsum(delta, 1)[:, :w]


def coverage(edges: np.ndarray, rule: str, box, dtype, device) -> torch.Tensor:
    wind = winding(edges, box, dtype, device)
    if rule == "evenodd":
        return torch.abs(torch.remainder(wind + 1.0, 2.0) - 1.0)
    return torch.clamp(torch.abs(wind), 0.0, 1.0)


# ----------------------------------------------------------------------------
# paint
# ----------------------------------------------------------------------------
def _premul(rgb, opacity: float = 1.0) -> list:
    return [rgb[0] / 255.0 * opacity, rgb[1] / 255.0 * opacity, rgb[2] / 255.0 * opacity,
            opacity]


def _spread(t: torch.Tensor, spread: str) -> torch.Tensor:
    if spread == "repeat":
        return t - torch.trunc(t)
    if spread == "reflect":
        return torch.abs(torch.remainder(t + 1.0, 2.0) - 1.0)
    return t


def _stops(t: torch.Tensor, stops, dtype, device) -> torch.Tensor:
    """(..., 4) piecewise-linear premultiplied colour of t over the stops."""
    colors = [torch.tensor(_premul(rgb, a), dtype=dtype, device=device)
              for _o, rgb, a in stops]
    out = colors[0].expand(*t.shape, 4).clone()
    for i in range(1, len(stops)):
        o0, o1 = stops[i - 1][0], stops[i][0]
        if o1 - o0 > 1e-12:
            ratio = torch.clamp((t - o0) / (o1 - o0), 0.0, 1.0)
        else:
            ratio = (t >= o1).to(dtype)
        out = out + ratio[..., None] * (colors[i] - colors[i - 1])
    return out


def gradient(grad: dict, bbox, box, scale: float, dtype, device) -> torch.Tensor:
    """(h, w, 4) premultiplied paint of an objectBoundingBox gradient over a
    box of pixels; bbox: the shape's user-space (x, y, w, h)."""
    r0, r1, c0, c1 = box
    bx, by, bw, bh = bbox
    rows = torch.arange(r0, r1, device=device).to(dtype) + 0.5
    cols = torch.arange(c0, c1, device=device).to(dtype) + 0.5
    v = ((rows / scale - by) / bh)[:, None]
    u = ((cols / scale - bx) / bw)[None, :]
    if grad["kind"] == "linear":
        dx, dy = grad["x2"] - grad["x1"], grad["y2"] - grad["y1"]
        t = ((u - grad["x1"]) * dx + (v - grad["y1"]) * dy) / (dx * dx + dy * dy)
        valid = None
    else:
        cdx, cdy = grad["cx"] - grad["fx"], grad["cy"] - grad["fy"]
        pdx, pdy = u - grad["fx"], v - grad["fy"]
        a = cdx * cdx + cdy * cdy - grad["r"] ** 2
        b = pdx * cdx + pdy * cdy
        c = pdx * pdx + pdy * pdy
        det = b * b - a * c
        sq = torch.sqrt(torch.clamp(det, min=0.0))
        t = torch.maximum((b + sq) / a, (b - sq) / a)
        valid = (det >= 0) & (t > 0)
    out = _stops(_spread(t, grad["spread"]), grad["stops"], dtype, device)
    if valid is not None:
        out = torch.where(valid[..., None], out, torch.zeros_like(out))
    return out


# ----------------------------------------------------------------------------
# the document
# ----------------------------------------------------------------------------
def render(doc: dict, height: int, width: int, scale: float, *, tile: int | None = None,
           dtype=torch.float32, device="cpu") -> torch.Tensor:
    """(height, width, 4) premultiplied sRGB canvas of a pass-free document's
    records at `scale` device pixels per user unit (the tile does not change
    a pass-free document's pixels)."""
    canvas = torch.zeros(height, width, 4, dtype=dtype, device=device)
    clip_cache = {}
    for item in doc["items"]:
        edges = shape_edges(item, scale)
        box = edges_box(edges, height, width)
        if box is None:
            continue
        cov = coverage(edges, item["rule"], box, dtype, device)
        if item["clip"] is not None:
            cid = item["clip"]
            if cid not in clip_cache:
                clip_cache[cid] = clip_edges(doc["clips"][cid], scale)
            cov = cov * coverage(clip_cache[cid], "nonzero", box, dtype, device)
        kind, value = item["paint"]
        if kind == "solid":
            paint = torch.tensor(_premul(value), dtype=dtype, device=device)
        else:
            xs, ys = edges[:, 0::2] / scale, edges[:, 1::2] / scale
            bbox = (xs.min(), ys.min(), xs.max() - xs.min(), ys.max() - ys.min())
            paint = gradient(doc["gradients"][value], bbox, box, scale, dtype, device)
        src = paint * (cov * item["opacity"])[..., None]
        r0, r1, c0, c1 = box
        dst = canvas[r0:r1, c0:c1]
        canvas[r0:r1, c0:c1] = src + dst * (1.0 - src[..., 3:])
    return canvas
