"""The plain reference renderer of documents with isolation passes.

Plain PyTorch on top of reference.raster's geometry, coverage and paint, for
the records of docs/pass_doc.py.  It imports nothing of the program under
test.  Semantics, as the system's renderer defines them (upstream
svgrasterize.py):

- a group with opacity, a mask or a clip renders its children in isolation
  (premultiplied sRGB, OVER), then multiplies the result by its opacity, by
  its clip shape's nonzero coverage, or by its mask's value, and composes it
  OVER its parent.  A mask's content is the objectBoundingBox rect of the
  group's bounding box filled with its gradient; its value is the luminance
  weights (0.2125, 0.7154, 0.072) dotted with the premultiplied sRGB content;
- the canvas is rendered on whole tiles of the configuration's tile size:
  a filter's source is the element over those tiles, so where the canvas
  is no whole number of tiles, the source reaches past its bottom or right
  edge to the last tile's end (and no further);
- a filter runs on the element's own layer, whose origin is one pixel
  outside its geometry (clamped at the canvas's edge), in linear RGB:
  SourceGraphic is the layer in straight alpha, SourceAlpha its alpha alone;
  feGaussianBlur convolves straight values with a kernel of
  2 * floor(2.5 sigma) + 1 taps per axis, sampled at pixel centres and
  normalised, and places the result at int(origin - taps / 2) (truncation
  toward zero, so it lands one pixel before centred where the origin is past
  half the kernel); feOffset moves a layer to int(origin + d); feMerge is
  OVER on premultiplied values; feColorMatrix multiplies straight values and
  clamps to [0, 1]; feComposite's named operators work on premultiplied
  values and arithmetic on straight ones, clamped; the result returns to
  premultiplied sRGB and composes OVER its parent.  A filter's output is not
  clipped to a filter region;
- un-premultiplying divides where alpha > 1e-4 and clamps to [0, 1]; the
  sRGB transfer is the exact piecewise 2.4-gamma curve.

Every tensor computation runs in `dtype` (the control runs it lower).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from rasterbench.reference import raster

LUMINANCE = (0.2125, 0.7154, 0.072)


# ----------------------------------------------------------------------------
# colour state
# ----------------------------------------------------------------------------
def _to_straight(img):
    rgb, a = img[..., :3], img[..., 3:]
    safe = torch.where(a > 0.0001, a, torch.ones_like(a))
    rgb = torch.where(a > 0.0001, rgb / safe, rgb)
    return torch.clamp(torch.cat([rgb, a], -1), 0.0, 1.0)


def _to_pre(img):
    return torch.cat([img[..., :3] * img[..., 3:], img[..., 3:]], -1)


def _srgb_to_linear(img):
    rgb = img[..., :3]
    lo = rgb / 12.92
    hi = torch.clamp((rgb + 0.055) / 1.055, min=1e-12) ** 2.4
    return torch.cat([torch.where(rgb <= 0.04045, lo, hi), img[..., 3:]], -1)


def _linear_to_srgb(img):
    rgb = img[..., :3]
    lo = rgb * 12.92
    hi = 1.055 * torch.clamp(rgb, min=1e-12) ** (1.0 / 2.4) - 0.055
    return torch.cat([torch.where(rgb <= 0.0031308, lo, hi), img[..., 3:]], -1)


class _Layer:
    """A filter value over the element's window: its image, whether it is
    premultiplied and linear, and its origin (row, column) on the canvas."""

    def __init__(self, img, pre: bool, lin: bool, origin):
        self.img, self.pre, self.lin, self.origin = img, pre, lin, tuple(origin)

    def convert(self, pre: bool, lin: bool) -> "_Layer":
        img, cur_pre = self.img, self.pre
        if self.lin != lin:
            if cur_pre:
                img, cur_pre = _to_straight(img), False
            img = _srgb_to_linear(img) if lin else _linear_to_srgb(img)
        if cur_pre != pre:
            img = _to_pre(img) if pre else _to_straight(img)
        return _Layer(img, pre, lin, self.origin)


def _shift(img, dr: int, dc: int):
    """img moved by (dr, dc) pixels within its window, zeros coming in."""
    out = torch.zeros_like(img)
    h, w = img.shape[:2]
    rs, rd = (slice(0, h - dr), slice(dr, h)) if dr >= 0 else (slice(-dr, h), slice(0, h + dr))
    cs, cd = (slice(0, w - dc), slice(dc, w)) if dc >= 0 else (slice(-dc, w), slice(0, w + dc))
    out[rd, cd] = img[rs, cs]
    return out


# ----------------------------------------------------------------------------
# filter primitives
# ----------------------------------------------------------------------------
def _taps(sigma: float) -> int:
    return 2 * int(math.floor(2.5 * sigma)) + 1


def _gauss(sigma: float, dtype, device):
    n = _taps(sigma)
    r = np.arange(n, dtype=np.float64) - n / 2 + 0.5
    k = np.exp(-r * r / (2 * sigma * sigma))
    return torch.as_tensor(k / k.sum(), device=device).to(dtype)


def _blur(layer: _Layer, sigma_rc, dtype) -> _Layer:
    layer = layer.convert(pre=False, lin=True)
    x = layer.img.permute(2, 0, 1)[None]
    kr = _gauss(sigma_rc[0], dtype, x.device)
    kc = _gauss(sigma_rc[1], dtype, x.device)
    x = F.conv2d(x, kr.view(1, 1, -1, 1).expand(4, 1, -1, 1), padding=(len(kr) // 2, 0),
                 groups=4)
    x = F.conv2d(x, kc.view(1, 1, 1, -1).expand(4, 1, 1, -1), padding=(0, len(kc) // 2),
                 groups=4)
    origin = tuple(int(o - len(k) / 2) for o, k in zip(layer.origin, (kr, kc)))
    centred = tuple(o - len(k) // 2 for o, k in zip(layer.origin, (kr, kc)))
    img = _shift(x[0].permute(1, 2, 0), origin[0] - centred[0], origin[1] - centred[1])
    return _Layer(img, False, True, origin)


def _offset(layer: _Layer, d_rc) -> _Layer:
    moved = tuple(int(o + d) for o, d in zip(layer.origin, d_rc))
    img = _shift(layer.img, moved[0] - layer.origin[0], moved[1] - layer.origin[1])
    return _Layer(img, layer.pre, layer.lin, moved)


def _matrix(kind: str, value: float) -> np.ndarray:
    if kind == "saturate":
        s = value
        return np.array([[0.213 + 0.787 * s, 0.715 - 0.715 * s, 0.072 - 0.072 * s],
                         [0.213 - 0.213 * s, 0.715 + 0.285 * s, 0.072 - 0.072 * s],
                         [0.213 - 0.213 * s, 0.715 - 0.715 * s, 0.072 + 0.928 * s]])
    c, s = math.cos(math.radians(value)), math.sin(math.radians(value))
    return np.array([
        [0.213 + 0.787 * c - 0.213 * s, 0.715 - 0.715 * c - 0.715 * s, 0.072 - 0.072 * c + 0.928 * s],
        [0.213 - 0.213 * c + 0.143 * s, 0.715 + 0.285 * c + 0.140 * s, 0.072 - 0.072 * c - 0.283 * s],
        [0.213 - 0.213 * c - 0.787 * s, 0.715 - 0.715 * c + 0.715 * s, 0.072 + 0.928 * c + 0.072 * s],
    ])


def _color_matrix(layer: _Layer, matrix, dtype) -> _Layer:
    layer = layer.convert(pre=False, lin=True)
    m = torch.as_tensor(_matrix(*matrix), device=layer.img.device).to(dtype)
    rgb = (layer.img[..., :3, None] * m.T[None, None]).sum(-2)
    img = torch.clamp(torch.cat([rgb, layer.img[..., 3:]], -1), 0.0, 1.0)
    return _Layer(img, False, True, layer.origin)


def _composite(src: _Layer, dst: _Layer, operator) -> _Layer:
    origin = tuple(min(a, b) for a, b in zip(src.origin, dst.origin))
    if isinstance(operator, (tuple, list)):
        _name, k1, k2, k3, k4 = operator
        s, d = src.convert(False, True).img, dst.convert(False, True).img
        return _Layer(torch.clamp(k1 * s * d + k2 * s + k3 * d + k4, 0.0, 1.0), False, True,
                      origin)
    s, d = src.convert(True, True).img, dst.convert(True, True).img
    sa, da = s[..., 3:], d[..., 3:]
    img = {"over": lambda: s + d * (1 - sa), "in": lambda: s * da,
           "out": lambda: s * (1 - da), "atop": lambda: s * da + d * (1 - sa),
           "xor": lambda: s * (1 - da) + d * (1 - sa)}[operator]()
    return _Layer(img, True, True, origin)


# ----------------------------------------------------------------------------
# the document
# ----------------------------------------------------------------------------
class _Doc:
    def __init__(self, doc, height, width, scale, dtype, device, tile):
        self.doc, self.h, self.w, self.scale = doc, height, width, scale
        self.dtype, self.device = dtype, device
        self.edges_of = {}
        # a filter's source reaches over the canvas's whole tiles
        self.source_limit = (-(-height // tile) * tile, -(-width // tile) * tile)

    def edges(self, item):
        key = id(item)
        if key not in self.edges_of:
            self.edges_of[key] = raster.shape_edges(item, self.scale)
        return self.edges_of[key]

    def margin(self, fid) -> int:
        m = 0
        for prim in self.doc["filters"][fid]:
            if prim["op"] == "blur":
                m += _taps(max(prim["std"]) * self.scale) // 2 + 2
            elif prim["op"] == "offset":
                m += int(math.ceil(max(abs(prim["dx"]), abs(prim["dy"])) * self.scale)) + 2
        return m

    def extent(self, item):
        """(r0, r1, c0, c1) of the canvas pixels an item can touch, or None."""
        if "group" in item:
            boxes = [b for b in (self.extent(c) for c in item["children"]) if b]
            if not boxes:
                return None
            return (min(b[0] for b in boxes), max(b[1] for b in boxes),
                    min(b[2] for b in boxes), max(b[3] for b in boxes))
        box = raster.edges_box(self.edges(item), self.h, self.w)
        if box is None or "filter" not in item:
            return box
        m = self.margin(item["filter"])
        return (max(0, box[0] - m), min(self.h, box[1] + m),
                max(0, box[2] - m), min(self.w, box[3] + m))

    def user_bbox(self, items):
        pts = np.concatenate([self.edges(i)[:, :2] for i in _leaves(items)]) / self.scale
        lo, hi = pts.min(0), pts.max(0)
        return lo[0], lo[1], hi[0] - lo[0], hi[1] - lo[1]

    def shape_layer(self, item, box):
        """(h, w, 4) premultiplied sRGB of one filled shape over a box."""
        edges = self.edges(item)
        cov = raster.coverage(edges, item["rule"], box, self.dtype, self.device)
        kind, value = item["paint"]
        if kind == "solid":
            paint = torch.tensor(raster._premul(value), dtype=self.dtype, device=self.device)
        else:
            xs, ys = edges[:, 0::2] / self.scale, edges[:, 1::2] / self.scale
            bbox = (xs.min(), ys.min(), xs.max() - xs.min(), ys.max() - ys.min())
            paint = raster.gradient(self.doc["gradients"][value], bbox, box, self.scale,
                                    self.dtype, self.device)
        return paint * (cov * item["opacity"])[..., None]

    def filtered(self, item, box):
        """(h, w, 4) premultiplied sRGB of a filtered shape over a box.

        The shape renders over the canvas part of the box; the filter runs
        over the box grown by its margin past the canvas, where the source
        is empty, so a result moved back into the box is whole."""
        edges = self.edges(item)
        pad = self.margin(item["filter"])
        h, w = box[1] - box[0] + 2 * pad, box[3] - box[2] + 2 * pad
        src = torch.zeros(h, w, 4, dtype=self.dtype, device=self.device)
        lim = self.source_limit
        sbox = (max(box[0] - pad, 0), min(box[1] + pad, lim[0]),
                max(box[2] - pad, 0), min(box[3] + pad, lim[1]))
        if sbox[0] < sbox[1] and sbox[2] < sbox[3]:
            src[sbox[0] - box[0] + pad:sbox[1] - box[0] + pad,
                sbox[2] - box[2] + pad:sbox[3] - box[2] + pad] = self.shape_layer(item, sbox)
        rows, cols = edges[:, 1::2], edges[:, 0::2]
        origin = (max(int(math.floor(rows.min())) - 1, 0), max(int(math.floor(cols.min())) - 1, 0))
        stack = {
            "SourceGraphic": _Layer(src, True, False, origin).convert(pre=False, lin=True),
            "SourceAlpha": _Layer(torch.cat([torch.zeros_like(src[..., :3]), src[..., 3:]], -1),
                                  True, True, origin),
        }
        out = None
        for prim in self.doc["filters"][item["filter"]]:
            op = prim["op"]
            if op == "blur":
                sx, sy = prim["std"]
                out = _blur(stack[prim["input"]], (sy * self.scale, sx * self.scale), self.dtype)
            elif op == "offset":
                out = _offset(stack[prim["input"]], (prim["dy"] * self.scale,
                                                     prim["dx"] * self.scale))
            elif op == "merge":
                bottom, top = (stack[n] for n in prim["inputs"])
                out = _composite(top, bottom, "over")
            elif op == "matrix":
                out = _color_matrix(stack[prim["input"]], prim["matrix"], self.dtype)
            elif op == "composite":
                src_l, dst_l = (stack[n] for n in prim["inputs"])
                out = _composite(src_l, dst_l, prim["operator"])
            else:
                raise ValueError(f"filter primitive {op!r}")
            stack[prim["result"]] = out
        return out.convert(pre=True, lin=False).img[pad:h - pad, pad:w - pad]

    def mask_value(self, group, box):
        """(h, w) mask of a group: its bbox rect's coverage times the
        luminance of its gradient."""
        bx, by, bw, bh = self.user_bbox(group["children"])
        rect = dict(shape="rect", x=bx, y=by, w=bw, h=bh)
        cov = raster.coverage(raster.shape_edges(rect, self.scale), "nonzero", box,
                              self.dtype, self.device)
        grad = self.doc["gradients"][self.doc["masks"][group["value"]]["gradient"]]
        paint = raster.gradient(grad, (bx, by, bw, bh), box, self.scale, self.dtype, self.device)
        lum = torch.tensor(LUMINANCE, dtype=self.dtype, device=self.device)
        return (paint[..., :3] * cov[..., None] * lum).sum(-1)

    def draw(self, item, buf, origin) -> None:
        """Compose an item OVER buf, whose pixel (0, 0) is canvas origin."""
        ext = self.extent(item)
        if ext is None:
            return
        r0, c0 = origin
        box = (max(ext[0], r0), min(ext[1], r0 + buf.shape[0]),
               max(ext[2], c0), min(ext[3], c0 + buf.shape[1]))
        if box[0] >= box[1] or box[2] >= box[3]:
            return
        if "group" in item:
            layer = torch.zeros(box[1] - box[0], box[3] - box[2], 4, dtype=self.dtype,
                                device=self.device)
            for child in item["children"]:
                self.draw(child, layer, (box[0], box[2]))
            if item["group"] == "opacity":
                layer = layer * item["value"]
            elif item["group"] == "clip":
                clip = raster.clip_edges(self.doc["clips"][item["value"]], self.scale)
                layer = layer * raster.coverage(clip, "nonzero", box, self.dtype,
                                                self.device)[..., None]
            else:
                layer = layer * self.mask_value(item, box)[..., None]
        elif "filter" in item:
            layer = self.filtered(item, box)
        else:
            layer = self.shape_layer(item, box)
        dst = buf[box[0] - r0:box[1] - r0, box[2] - c0:box[3] - c0]
        buf[box[0] - r0:box[1] - r0, box[2] - c0:box[3] - c0] = layer + dst * (1 - layer[..., 3:])


def _leaves(items):
    for item in items:
        if "group" in item:
            yield from _leaves(item["children"])
        else:
            yield item


def render(doc: dict, height: int, width: int, scale: float, *, tile: int,
           dtype=torch.float32, device="cpu") -> torch.Tensor:
    """(height, width, 4) premultiplied sRGB canvas of a document's records,
    rendered on a grid of tile x tile pixels (a filter's source reaches over
    the grid's last row and column of tiles, past the canvas)."""
    canvas = torch.zeros(height, width, 4, dtype=dtype, device=device)
    d = _Doc(doc, height, width, scale, dtype, device, tile)
    with torch.backends.cudnn.flags(enabled=torch.backends.cudnn.enabled, allow_tf32=False):
        for item in doc["items"]:
            d.draw(item, canvas, (0, 0))
    return canvas
