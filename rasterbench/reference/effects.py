"""The plain reference renderer of documents with lighting, morphology,
flood and turbulence filters.

Plain PyTorch for the records of docs/effects_doc.py, on top of
reference.passes (its document walk, blur, offset, colour matrix, composite
and colour state) and reference.raster (geometry, coverage, paint).  It
imports nothing of the program under test.  Semantics, as the system's
renderer defines them, beyond those of reference.passes:

- every filter value has an extent, a box of canvas pixels; its origin is
  the box's first pixel.  A filter's source extends one pixel past its
  geometry on each side, clipped to the tiles the geometry touches (a tile
  is the configuration's tile; its tiles start at the canvas's origin);
  feGaussianBlur grows it by its taps less one (placed as reference.passes
  places it), feOffset moves it, feComposite `in` takes the two extents'
  intersection and every other operator and feMerge their union;
- feFlood fills SourceGraphic's extent with its colour (straight alpha,
  the colour's sRGB value taken to linear RGB);
- feMorphology takes the premultiplied value and, over a window of
  int(2 r scale) device pixels on each axis, its maximum (dilate) or its
  minimum (erode) starting at each pixel: a VALID window whose result keeps
  the origin and is the window less one pixel shorter on each axis.  This
  is upstream svgrasterize.py's pooling, not SVG's centred 2r + 1 window;
- feDiffuseLighting and feSpecularLighting take the surface normal from
  the SVG 1.1 interior Sobel kernels on the straight alpha, at every pixel
  of the input's extent with zero alpha outside it (the spec's edge kernels
  are not used), kernelUnitLength one device pixel, and the surface height
  surfaceScale times the alpha; lights are placed in device pixels through
  the user-to-device scale (a point light's z times the scale), and a pixel
  is lit at its centre.  N.L, and N.H with H = L + (0, 0, 1), are the
  spec's; the diffuse result is opaque over its extent, the specular one's
  alpha the maximum of its colour channels, both straight and clamped to
  [0, 1]; lighting-color is taken to linear RGB;
- feTurbulence fills SourceGraphic's extent: the spec's lattice set-up
  (its Park-Miller generator) and noise2, at each device pixel's centre
  mapped to user space; fractalNoise sums noise2 / 2^octave and maps the
  sum s to (s + 1) / 2, clamped to [0, 1], one lattice per channel; the
  result is straight alpha in the filter's colour space;
- filter regions and stitchTiles are not used (the documents give none).

Every tensor computation runs in `dtype` (the control runs it lower); the
noise lattice is set up in float64 on the host, as the spec's C does, and
taken to `dtype`.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from rasterbench.reference import passes, raster

# the SVG 1.1 interior Sobel kernels (rows: y, the device row; columns: x)
SOBEL_X = np.array([[-1.0, 0.0, 1.0], [-2.0, 0.0, 2.0], [-1.0, 0.0, 1.0]]) / 4.0
SOBEL_Y = SOBEL_X.T.copy()

# the spec's feTurbulence constants
B_SIZE = 0x100
BM = 0xFF
PERLIN_N = 0x1000
RAND_M = 2147483647  # 2**31 - 1
RAND_A = 16807  # 7**5; primitive root of m
RAND_Q = 127773  # m / a
RAND_R = 2836  # m % a


# ----------------------------------------------------------------------------
# feTurbulence, from the SVG 1.1 text's C
# ----------------------------------------------------------------------------
def _c_mod(a: int, b: int) -> int:
    """C's % on longs: the remainder takes the dividend's sign."""
    return int(math.fmod(a, b))


def _setup_seed(seed: int) -> int:
    if seed <= 0:
        seed = -_c_mod(seed, RAND_M - 1) + 1
    if seed > RAND_M - 1:
        seed = RAND_M - 1
    return seed


def _random(seed: int) -> int:
    result = RAND_A * (seed % RAND_Q) - RAND_R * (seed // RAND_Q)
    if result <= 0:
        result += RAND_M
    return result


def lattice(seed: int):
    """The spec's init(lSeed): (uLatticeSelector (B_SIZE * 2 + 2,) int64,
    fGradient (4, B_SIZE * 2 + 2, 2) float64)."""
    seed = _setup_seed(int(seed))
    selector = np.zeros(B_SIZE + B_SIZE + 2, np.int64)
    grad = np.zeros((4, B_SIZE + B_SIZE + 2, 2), np.float64)
    for k in range(4):
        for i in range(B_SIZE):
            selector[i] = i
            for j in range(2):
                seed = _random(seed)
                grad[k, i, j] = float((seed % (B_SIZE + B_SIZE)) - B_SIZE) / B_SIZE
            s = math.sqrt(grad[k, i, 0] * grad[k, i, 0] + grad[k, i, 1] * grad[k, i, 1])
            grad[k, i, 0] /= s
            grad[k, i, 1] /= s
    i = B_SIZE - 1
    while i:
        k = selector[i]
        seed = _random(seed)
        j = seed % B_SIZE
        selector[i] = selector[j]
        selector[j] = k
        i -= 1
    for i in range(B_SIZE + 2):
        selector[B_SIZE + i] = selector[i]
        grad[:, B_SIZE + i] = grad[:, i]
    return selector, grad


def _noise2(selector, grad, vx, vy):
    """The spec's noise2 of one channel's lattice at points (vx, vy)."""
    t = vx + PERLIN_N
    bx0 = t.to(torch.int64) & BM
    bx1 = (bx0 + 1) & BM
    rx0 = t - torch.trunc(t)
    rx1 = rx0 - 1.0
    t = vy + PERLIN_N
    by0 = t.to(torch.int64) & BM
    by1 = (by0 + 1) & BM
    ry0 = t - torch.trunc(t)
    ry1 = ry0 - 1.0
    i, j = selector[bx0], selector[bx1]
    b00, b10 = selector[i + by0], selector[j + by0]
    b01, b11 = selector[i + by1], selector[j + by1]
    sx = rx0 * rx0 * (3.0 - 2.0 * rx0)
    sy = ry0 * ry0 * (3.0 - 2.0 * ry0)
    u = rx0 * grad[b00, 0] + ry0 * grad[b00, 1]
    v = rx1 * grad[b10, 0] + ry0 * grad[b10, 1]
    a = u + sx * (v - u)
    u = rx0 * grad[b01, 0] + ry1 * grad[b01, 1]
    v = rx1 * grad[b11, 0] + ry1 * grad[b11, 1]
    b = u + sx * (v - u)
    return a + sy * (b - a)


def turbulence(prim: dict, x, y, dtype):
    """(..., 4) straight RGBA of feTurbulence at user-space points x, y."""
    selector, grad = lattice(prim["seed"])
    selector = torch.as_tensor(selector, device=x.device)
    grad = torch.as_tensor(grad, device=x.device).to(dtype)
    fx, fy = prim["base_frequency"]
    fractal = prim["kind"] == "fractalNoise"
    channels = []
    for k in range(4):
        vx, vy = x * fx, y * fy
        total, ratio = torch.zeros_like(x), 1.0
        for _octave in range(prim["octaves"]):
            n = _noise2(selector, grad[k], vx, vy)
            total = total + (n if fractal else torch.abs(n)) / ratio
            vx, vy, ratio = vx * 2.0, vy * 2.0, ratio * 2.0
        channels.append((total + 1.0) / 2.0 if fractal else total)
    return torch.clamp(torch.stack(channels, -1), 0.0, 1.0)


# ----------------------------------------------------------------------------
# a filter value with its extent
# ----------------------------------------------------------------------------
class _Value:
    """A filter value: a passes._Layer over the filter's window (zero
    outside its extent) and its extent (r0, r1, c0, c1) in canvas pixels."""

    def __init__(self, layer: passes._Layer, ext):
        self.layer, self.ext = layer, tuple(int(v) for v in ext)


def _union(a, b):
    return min(a[0], b[0]), max(a[1], b[1]), min(a[2], b[2]), max(a[3], b[3])


def _meet(a, b):
    r0, c0 = max(a[0], b[0]), max(a[2], b[2])
    return r0, max(r0, min(a[1], b[1])), c0, max(c0, min(a[3], b[3]))


def _srgb_channel(v: int) -> float:
    """An 8-bit sRGB colour channel in linear RGB."""
    c = v / 255.0
    return c / 12.92 if c <= 0.04045 else ((c + 0.055) / 1.055) ** 2.4


class _Doc(passes._Doc):
    def __init__(self, doc, height, width, scale, dtype, device, tile):
        super().__init__(doc, height, width, scale, dtype, device, tile)
        self.tile = tile
        self.win = None  # (r0, r1, c0, c1): the filter being run's window

    def margin(self, fid) -> int:
        m = super().margin(fid)
        for prim in self.doc["filters"][fid]:
            if prim["op"] == "morphology":
                m += self.window(prim) + 2
        return m

    def window(self, prim) -> int:
        return int(2 * prim["radius"] * self.scale)

    def source_extent(self, edges):
        """One pixel past the geometry on each side, clipped to the tiles
        the geometry touches and to the grid of whole tiles."""
        rows, cols = edges[:, 1::2], edges[:, 0::2]
        t = self.tile
        out = []
        for lo, hi, limit in ((rows.min(), rows.max(), self.source_limit[0]),
                              (cols.min(), cols.max(), self.source_limit[1])):
            first = max(int(math.floor(lo / t)), 0) * t
            last = min((int(math.floor((hi - 1e-9) / t)) + 1) * t, limit)
            out += [max(int(math.floor(lo)) - 1, first), min(int(math.ceil(hi)) + 1, last)]
        return tuple(out)

    def filtered(self, item, box):
        """(h, w, 4) premultiplied sRGB of a filtered shape over a box."""
        edges = self.edges(item)
        ext = self.source_extent(edges)
        pad = self.margin(item["filter"])
        win = (min(ext[0], box[0]) - pad, max(ext[1], box[1]) + pad,
               min(ext[2], box[2]) - pad, max(ext[3], box[3]) + pad)
        h, w = win[1] - win[0], win[3] - win[2]
        src = torch.zeros(h, w, 4, dtype=self.dtype, device=self.device)
        if ext[0] < ext[1] and ext[2] < ext[3]:
            src[ext[0] - win[0]:ext[1] - win[0], ext[2] - win[2]:ext[3] - win[2]] = \
                self.shape_layer(item, (ext[0], ext[1], ext[2], ext[3]))
        stack = self.sources(src, ext, win)
        out = None
        for prim in self.doc["filters"][item["filter"]]:
            out = self.primitive(prim, stack)
            stack[prim["result"]] = out
        img = out.layer.convert(pre=True, lin=False).img
        return img[box[0] - win[0]:box[1] - win[0], box[2] - win[2]:box[3] - win[2]]

    def sources(self, src, ext, win) -> dict:
        """The chain's stack of named values at its start: SourceGraphic and
        SourceAlpha of `src`, the premultiplied sRGB source over the window
        `win` (zero outside its extent `ext`), which becomes the window of
        the filter being run."""
        self.win = win
        origin = (ext[0], ext[2])
        alpha = torch.cat([torch.zeros_like(src[..., :3]), src[..., 3:]], -1)
        return {
            "SourceGraphic": _Value(passes._Layer(src, True, False, origin).convert(
                pre=False, lin=True), ext),
            "SourceAlpha": _Value(passes._Layer(alpha, True, True, origin), ext),
        }

    # -- one primitive ------------------------------------------------------
    def mask(self, img, ext):
        """img (the window) with everything outside ext zeroed."""
        win = self.win
        keep = torch.zeros(img.shape[:2], dtype=torch.bool, device=img.device)
        keep[max(ext[0] - win[0], 0):max(ext[1] - win[0], 0),
             max(ext[2] - win[2], 0):max(ext[3] - win[2], 0)] = True
        return torch.where(keep[..., None], img, torch.zeros((), dtype=img.dtype,
                                                             device=img.device))

    def value(self, img, pre, ext) -> _Value:
        return _Value(passes._Layer(self.mask(img, ext), pre, True, (ext[0], ext[2])), ext)

    def primitive(self, prim, stack) -> _Value:
        op = prim["op"]
        if op == "blur":
            src = stack[prim["input"]]
            sx, sy = prim["std"]
            sigma = (sy * self.scale, sx * self.scale)
            layer = passes._blur(src.layer, sigma, self.dtype)
            kh, kw = passes._taps(sigma[0]), passes._taps(sigma[1])
            r0, c0 = layer.origin
            e = src.ext
            return _Value(layer, (r0, r0 + e[1] - e[0] + kh - 1, c0, c0 + e[3] - e[2] + kw - 1))
        if op == "offset":
            src = stack[prim["input"]]
            layer = passes._offset(src.layer, (prim["dy"] * self.scale, prim["dx"] * self.scale))
            dr, dc = (a - b for a, b in zip(layer.origin, src.layer.origin))
            e = src.ext
            return _Value(layer, (e[0] + dr, e[1] + dr, e[2] + dc, e[3] + dc))
        if op == "matrix":
            src = stack[prim["input"]]
            return _Value(passes._color_matrix(src.layer, prim["matrix"], self.dtype), src.ext)
        if op in ("merge", "composite"):
            if op == "merge":
                (bottom, top), operator = (stack[n] for n in prim["inputs"]), "over"
            else:
                top, bottom = (stack[n] for n in prim["inputs"])
                operator = prim["operator"]
            ext = _meet(top.ext, bottom.ext) if operator == "in" else _union(top.ext, bottom.ext)
            layer = passes._composite(top.layer, bottom.layer, operator)
            return self.value(layer.img, layer.pre, ext)
        if op == "morphology":
            return self.morphology(prim, stack[prim["input"]])
        if op == "flood":
            ext = stack["SourceGraphic"].ext
            rgba = [_srgb_channel(v) for v in prim["color"]] + [prim["opacity"]]
            win = self.win
            img = torch.tensor(rgba, dtype=self.dtype, device=self.device).expand(
                win[1] - win[0], win[3] - win[2], 4)
            return self.value(img, False, ext)
        if op == "turbulence":
            ext = stack["SourceGraphic"].ext
            rows, cols = self.centres()
            x = (cols / self.scale).expand(len(rows), len(cols[0]))
            y = (rows / self.scale).expand(len(rows), len(cols[0]))
            return self.value(turbulence(prim, x, y, self.dtype), False, ext)
        if op in ("diffuse", "specular"):
            return self.lighting(prim, stack[prim["input"]])
        raise ValueError(f"filter primitive {op!r}")

    def centres(self):
        """(rows (h, 1), cols (1, w)): the window's pixel centres, in canvas
        pixels."""
        win = self.win
        rows = torch.arange(win[0], win[1], device=self.device).to(self.dtype) + 0.5
        cols = torch.arange(win[2], win[3], device=self.device).to(self.dtype) + 0.5
        return rows[:, None], cols[None, :]

    def morphology(self, prim, src: _Value) -> _Value:
        k = self.window(prim)
        if k < 1:
            return src
        x = src.layer.convert(pre=True, lin=True).img.permute(2, 0, 1)[None]
        if prim["operator"] == "dilate":
            pooled = F.max_pool2d(x, k, 1)
        else:
            pooled = -F.max_pool2d(-x, k, 1)
        img = torch.zeros_like(x)
        img[..., :pooled.shape[2], :pooled.shape[3]] = pooled
        e = src.ext
        ext = (e[0], max(e[0], e[1] - k + 1), e[2], max(e[2], e[3] - k + 1))
        return self.value(img[0].permute(1, 2, 0), True, ext)

    def lighting(self, prim, src: _Value) -> _Value:
        a = src.layer.convert(pre=False, lin=True).img[..., 3]
        ss = prim["surface_scale"]

        def sobel(kernel):
            k = torch.as_tensor(kernel, device=self.device).to(self.dtype)
            return F.conv2d(a[None, None], k[None, None], padding=1)[0, 0]

        n_r, n_c = -ss * sobel(SOBEL_Y), -ss * sobel(SOBEL_X)
        inv_norm = 1.0 / torch.sqrt(n_r * n_r + n_c * n_c + 1.0)
        light = prim["light"]
        if light[0] == "distant":
            az, el = math.radians(light[1]), math.radians(light[2])
            # device rows run along user y, columns along user x
            l_r = torch.full_like(a, math.sin(az) * math.cos(el))
            l_c = torch.full_like(a, math.cos(az) * math.cos(el))
            l_z = torch.full_like(a, math.sin(el))
        else:
            _kind, lx, ly, lz = light
            rows, cols = self.centres()
            l_r = ly * self.scale - rows
            l_c = lx * self.scale - cols
            l_z = lz * self.scale - ss * a
            norm = torch.sqrt(l_r * l_r + l_c * l_c + l_z * l_z)
            l_r, l_c, l_z = l_r / norm, l_c / norm, l_z / norm
        color = torch.tensor([_srgb_channel(v) for v in prim["color"]], dtype=self.dtype,
                             device=self.device)
        if prim["op"] == "diffuse":
            n_dot_l = (n_r * l_r + n_c * l_c + l_z) * inv_norm
            rgb = prim["constant"] * torch.clamp(n_dot_l, min=0.0)[..., None] * color
            img = torch.cat([rgb, torch.ones_like(rgb[..., :1])], -1)
        else:
            h_z = l_z + 1.0
            h_norm = torch.sqrt(l_r * l_r + l_c * l_c + h_z * h_z)
            n_dot_h = (n_r * l_r + n_c * l_c + h_z) * inv_norm / h_norm
            spec = prim["constant"] * torch.clamp(n_dot_h, min=0.0) ** prim["exponent"]
            rgb = torch.clamp(spec[..., None] * color, 0.0, 1.0)
            img = torch.cat([rgb, rgb.amax(-1, keepdim=True)], -1)
        return self.value(torch.clamp(img, 0.0, 1.0), False, src.ext)


def apply_primitive(prim: dict, image: torch.Tensor, offset, scale: float):
    """One primitive record run on `image`, the premultiplied sRGB (h, w, 4)
    source whose first pixel is canvas pixel `offset` (row, column), in its
    dtype and on its device: the result's extent (r0, r1, c0, c1) and its
    straight linear-RGB pixels over that extent."""
    h, w = image.shape[:2]
    ext = (offset[0], offset[0] + h, offset[1], offset[1] + w)
    d = _Doc(dict(filters={"f": [prim]}, items=[]), ext[1], ext[3], scale, image.dtype,
             image.device, 1)
    pad = d.margin("f") + 1
    win = (ext[0] - pad, ext[1] + pad, ext[2] - pad, ext[3] + pad)
    src = torch.zeros(h + 2 * pad, w + 2 * pad, 4, dtype=image.dtype, device=image.device)
    src[pad:pad + h, pad:pad + w] = image
    out = d.primitive(prim, d.sources(src, ext, win))
    r0, r1, c0, c1 = out.ext
    img = out.layer.convert(pre=False, lin=True).img
    return out.ext, img[r0 - win[0]:r1 - win[0], c0 - win[2]:c1 - win[2]]


def render(doc: dict, height: int, width: int, scale: float, *, tile: int,
           dtype=torch.float32, device="cpu") -> torch.Tensor:
    """(height, width, 4) premultiplied sRGB canvas of an effects document's
    records, rendered on a grid of tile x tile pixels (a filter's source
    reaches over the grid's last row and column of tiles, past the
    canvas).  TF32 is off for every convolution and matrix product."""
    canvas = torch.zeros(height, width, 4, dtype=dtype, device=device)
    d = _Doc(doc, height, width, scale, dtype, device, tile)
    matmul_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.backends.cudnn.flags(enabled=torch.backends.cudnn.enabled,
                                        allow_tf32=False):
            for item in doc["items"]:
                d.draw(item, canvas, (0, 0))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul_tf32
    return canvas
