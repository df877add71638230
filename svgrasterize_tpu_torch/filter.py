"""SVG filter engine: an SSA-style op list interpreted over Layers.

The Filter holds named results plus a list of (kind, attrs, input-indices);
execution seeds a stack with [SourceAlpha, SourceGraphic] and pushes each
primitive's result (parity: svgrasterize.py:1718-1957).  Implemented
primitives: ALL 15 kinds the reference declares — it executes only 7
(svgrasterize.py:1718-1732 vs :1834-1900) — plus SVG2's feDropShadow:
feOffset, feMerge, feBlend (all 16 modes), feComposite (Porter-Duff +
arithmetic), feGaussianBlur, feColorMatrix, feMorphology, feFlood, feTile,
feComponentTransfer, feTurbulence (spec-exact Perlin), feConvolveMatrix,
feDisplacementMap, feDiffuseLighting, feSpecularLighting (distant/point/
spot lights).
All pixel math runs in torch on the source layer's device; filters operate
in straight-alpha linear RGB (or sRGB, per color-interpolation-filters).  A
copy of the JAX package's filter.py; feImage renders its fragment through
the interpreter (Scene.render) on that device, or resizes its raster.
"""

from __future__ import annotations

import math
import warnings
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from .core.layer import Layer
from .core.transform import Transform
from .ops import blur as blur_ops
from .utils import profiling

FE_BLEND = 0
FE_COLOR_MATRIX = 1
FE_COMPONENT_TRANSFER = 2
FE_COMPOSITE = 3
FE_CONVOLVE_MATRIX = 4
FE_DIFFUSE_LIGHTING = 5
FE_DISPLACEMENT_MAP = 6
FE_FLOOD = 7
FE_GAUSSIAN_BLUR = 8
FE_MERGE = 9
FE_MORPHOLOGY = 10
FE_OFFSET = 11
FE_SPECULAR_LIGHTING = 12
FE_TILE = 13
FE_TURBULENCE = 14
FE_DROP_SHADOW = 15  # SVG2 convenience primitive
FE_IMAGE = 16  # intra-document fragment references
# each primitive's span (utils.profiling), by kind
FE_SPANS = {
    FE_BLEND: "fe.blend", FE_COLOR_MATRIX: "fe.color_matrix",
    FE_COMPONENT_TRANSFER: "fe.component_transfer", FE_COMPOSITE: "fe.composite",
    FE_CONVOLVE_MATRIX: "fe.convolve_matrix", FE_DIFFUSE_LIGHTING: "fe.diffuse_lighting",
    FE_DISPLACEMENT_MAP: "fe.displacement_map", FE_FLOOD: "fe.flood",
    FE_GAUSSIAN_BLUR: "fe.blur", FE_MERGE: "fe.merge", FE_MORPHOLOGY: "fe.morphology",
    FE_OFFSET: "fe.offset", FE_SPECULAR_LIGHTING: "fe.specular_lighting", FE_TILE: "fe.tile",
    FE_TURBULENCE: "fe.turbulence", FE_DROP_SHADOW: "fe.drop_shadow", FE_IMAGE: "fe.image",
}

FE_SOURCE_ALPHA = "SourceAlpha"
FE_SOURCE_GRAPHIC = "SourceGraphic"

COLOR_MATRIX_LUM = np.array(
    [[0, 0, 0, 0, 0], [0, 0, 0, 0, 0], [0, 0, 0, 0, 0], [0.2125, 0.7154, 0.0721, 0, 0]],
    dtype=np.float64,
)
# hueRotate basis: identity/cos/sin components (SVG spec feColorMatrix tables)
_HUE_BASIS = np.array(
    [
        [[0.213, 0.715, 0.072], [0.213, 0.715, 0.072], [0.213, 0.715, 0.072]],
        [[0.787, -0.715, -0.072], [-0.213, 0.285, -0.072], [-0.213, -0.715, 0.928]],
        [[-0.213, -0.715, 0.928], [0.143, 0.140, -0.283], [-0.787, 0.715, 0.072]],
    ],
    dtype=np.float64,
)


def color_matrix_hue_rotate(angle: float) -> np.ndarray:
    matrix = np.eye(4, 5)
    matrix[:3, :3] = np.dot(_HUE_BASIS.T, [1, math.cos(angle), math.sin(angle)]).T
    return matrix


def color_matrix_saturate(value: float) -> np.ndarray:
    matrix = np.eye(4, 5)
    matrix[:3, :3] = np.dot(_HUE_BASIS.T, [1, value, 0]).T
    return matrix


class Filter(NamedTuple):
    names: dict  # result name -> stack index
    filters: list  # [(kind, attrs, input indices)]
    regions: tuple = ()  # per-primitive subregion (x, y, w, h) | None
    # operating color space (SVG color-interpolation-filters): True =
    # linearRGB (the spec default, and the only space the reference
    # supports); False = sRGB, which Inkscape exports set routinely
    linear: bool = True

    @classmethod
    def empty(cls, linear: bool = True) -> "Filter":
        return cls({FE_SOURCE_ALPHA: 0, FE_SOURCE_GRAPHIC: 1}, [], (), linear)

    def add_filter(self, kind, attrs, inputs, result) -> "Filter":
        names = self.names.copy()
        filters = self.filters.copy()
        args = []
        for name in inputs:
            if name is None:
                args.append(len(filters) + 1)  # previous result
            else:
                idx = self.names.get(name)
                if idx is None:
                    warnings.warn(f"unknown filter result name: {name}")
                    args.append(len(filters) + 1)
                else:
                    args.append(idx)
        if result is not None:
            names[result] = len(filters) + 2
        filters.append((kind, attrs, args))
        return Filter(names, filters, (*self.regions, None), self.linear)

    def set_region(self, region) -> "Filter":
        """Attach an x/y/width/height primitive subregion (SVG 15.7.5) to
        the most recently added primitive; its result is clipped to the
        region.  The reference ignores subregions entirely."""
        if region is None or not self.filters:
            return self
        return Filter(self.names, self.filters, (*self.regions[:-1], region),
                      self.linear)

    # builder helpers ------------------------------------------------------
    def offset(self, dx, dy, input=None, result=None):
        return self.add_filter(FE_OFFSET, (dx, dy), [input], result)

    def merge(self, inputs, result=None):
        return self.add_filter(FE_MERGE, tuple(), inputs, result)

    def blur(self, std_x, std_y=None, input=None, result=None):
        return self.add_filter(FE_GAUSSIAN_BLUR, (std_x, std_y), [input], result)

    def blend(self, in1, in2, mode=None, result=None):
        return self.add_filter(FE_BLEND, (mode,), [in1, in2], result)

    def composite(self, in1, in2, mode=None, result=None):
        return self.add_filter(FE_COMPOSITE, (mode,), [in1, in2], result)

    def color_matrix(self, input, matrix, result=None):
        return self.add_filter(FE_COLOR_MATRIX, (matrix,), [input], result)

    def morphology(self, rx, ry, method, input, result=None):
        return self.add_filter(FE_MORPHOLOGY, (rx, ry, method), [input], result)

    # primitives beyond the reference's executed set (it declares these
    # kinds but has no interpreter cases: svgrasterize.py:1718-1732 vs
    # :1834-1900).  Flood/tile/turbulence have no real input; they take the
    # SourceGraphic so its extent defines the output region (this engine,
    # like the reference, does not track per-primitive filter subregions).
    def flood(self, color, region=None, result=None):
        """color: straight-alpha linear-RGB (4,); region: user-space
        (x, y, w, h) or None for the source extent."""
        return self.add_filter(FE_FLOOD, (np.asarray(color, np.float64), region),
                               [FE_SOURCE_GRAPHIC], result)

    def tile(self, input=None, result=None):
        return self.add_filter(FE_TILE, (), [input, FE_SOURCE_GRAPHIC], result)

    def component_transfer(self, funcs, input=None, result=None):
        """funcs: {channel 0..3: (kind, *params)} with kind table/discrete/
        linear/gamma; missing channels pass through."""
        return self.add_filter(FE_COMPONENT_TRANSFER, (funcs,), [input], result)

    def turbulence(self, base_fx, base_fy, octaves=1, seed=0, fractal=False,
                   region=None, result=None):
        return self.add_filter(
            FE_TURBULENCE, (base_fx, base_fy, int(octaves), int(seed), fractal, region),
            [FE_SOURCE_GRAPHIC], result,
        )

    def drop_shadow(self, dx, dy, std, color, input=None, result=None):
        """color: straight-alpha linear-RGB (4,) shadow paint."""
        return self.add_filter(
            FE_DROP_SHADOW, (dx, dy, std, np.asarray(color, np.float64)), [input], result
        )

    def convolve_matrix(self, kernel, divisor=None, bias=0.0, preserve_alpha=False,
                        input=None, result=None):
        """kernel: (orderY, orderX) row-major as authored in kernelMatrix."""
        kernel = np.asarray(kernel, np.float64)
        if divisor is None:
            s = kernel.sum()
            divisor = s if abs(s) > 1e-12 else 1.0
        return self.add_filter(
            FE_CONVOLVE_MATRIX, (kernel, float(divisor), float(bias), bool(preserve_alpha)),
            [input], result,
        )

    def displacement_map(self, scale, x_channel=0, y_channel=0, in1=None, in2=None,
                         result=None):
        return self.add_filter(
            FE_DISPLACEMENT_MAP, (float(scale), int(x_channel), int(y_channel)),
            [in1, in2], result,
        )

    def image(self, scene, region=None, result=None):
        """feImage of an intra-document fragment: `scene` renders fresh as
        the primitive's output (region: user-space (x, y, w, h) placement
        or None for the scene's natural position)."""
        return self.add_filter(FE_IMAGE, (scene, region), [FE_SOURCE_GRAPHIC], result)

    def diffuse_lighting(self, surface_scale, kd, color, light, input=None, result=None):
        """light: ("distant", azimuth_rad, elevation_rad) |
        ("point", x, y, z) | ("spot", x, y, z, px, py, pz, exp, cone_or_None);
        color: straight linear-RGB (3,)."""
        return self.add_filter(
            FE_DIFFUSE_LIGHTING,
            (float(surface_scale), float(kd), None, np.asarray(color, np.float64), light),
            [input], result,
        )

    def specular_lighting(self, surface_scale, ks, exponent, color, light,
                          input=None, result=None):
        return self.add_filter(
            FE_SPECULAR_LIGHTING,
            (float(surface_scale), float(ks), float(exponent),
             np.asarray(color, np.float64), light),
            [input], result,
        )


    # interpreter ------------------------------------------------------------
    def prepare(self, transform: Transform, device) -> "FilterConsts":
        """The chain's device constants for `transform` on `device` (blur
        taps, color matrices, flood colors, noise tables, convolution
        kernels, feImage results).  A serving program prepares each chain
        once at upload, so its frames copy nothing from the host."""
        dev = torch.device(device)
        return FilterConsts(
            _upload([0.0, 0.0, 0.0, 1.0], dev),
            [_prepare_primitive(kind, attrs, transform, self.linear, dev)
             for kind, attrs, _inputs in self.filters],
        )

    def seeds(self, source: Layer, consts: "FilterConsts") -> tuple:
        """The chain's first two stack entries made from `source`:
        SourceAlpha (its alpha times consts.amask, premultiplied) and
        SourceGraphic (straight alpha), both in the chain's colorspace."""
        linear = self.linear
        alpha = Layer(
            source.image[..., -1:] * consts.amask, source.offset, pre_alpha=True,
            linear_rgb=linear,
        )
        return alpha, source.convert(pre_alpha=False, linear_rgb=linear)

    def __call__(self, transform: Transform, source: Layer,
                 consts: "FilterConsts | None" = None, seeds: tuple | None = None) -> Layer:
        """Run the chain on `source`; consts: prepare(transform, device)
        made beforehand (made here when None); seeds: seeds(source, consts)
        made beforehand (made here when None)."""
        if consts is None:
            consts = self.prepare(transform, source.image.device)
        linear = self.linear
        stack = list(self.seeds(source, consts) if seeds is None else seeds)
        regions = (*self.regions, *([None] * (len(self.filters) - len(self.regions))))
        for (kind, attrs, inputs), region, const in zip(self.filters, regions,
                                                        consts.primitives):
            with profiling.stage(FE_SPANS[kind]):
                args = [stack[i] for i in inputs]
                out = _apply(kind, attrs, args, transform, linear, const)
                if region is not None:
                    out = _crop_to_region(out, region, transform)
            stack.append(out)
        return stack[-1]


class FilterConsts(NamedTuple):
    """A filter chain's device constants (Filter.prepare)."""

    amask: torch.Tensor  # (4,) f32: the SourceAlpha channel mask
    primitives: list  # per primitive: what _prepare_primitive made, or None


def _upload(values, device) -> torch.Tensor:
    """Host constants as an f32 tensor on `device`."""
    return torch.as_tensor(np.asarray(values, np.float32), device=device)


def _same_kernel(kernel: np.ndarray, device) -> torch.Tensor:
    """A 2D kernel flipped for _convolve_same (a true convolution is a
    cross-correlation with the flipped kernel), f32 on `device`."""
    return _upload(np.ascontiguousarray(kernel[::-1, ::-1]), device)


def _prepare_primitive(kind: int, attrs: tuple, transform: Transform, linear: bool,
                       device):
    """The device constants one primitive reads (see _apply), or None."""
    if kind == FE_GAUSSIAN_BLUR:
        std_x, std_y = attrs
        kernel = blur_ops.gaussian_kernel(transform, (std_x, std_x if std_y is None else std_y))
        return None if kernel is None else blur_ops.upload_kernel(kernel, device)
    if kind == FE_COLOR_MATRIX:
        (matrix,) = attrs
        if not isinstance(matrix, np.ndarray) or matrix.shape != (4, 5):
            return None
        return _upload(matrix[:, :4], device), _upload(matrix[:, 4], device)
    if kind == FE_FLOOD:
        return _upload(attrs[0], device)
    if kind == FE_TURBULENCE:
        from .ops.turbulence import lattice_tables

        selector, gradient = lattice_tables(attrs[3])
        selector = torch.as_tensor(selector, device=device)  # int32: csrc/fe_turbulence.cu's
        return (selector if selector.is_cuda else selector.long()), _upload(gradient, device)
    if kind == FE_DROP_SHADOW:
        _dx, _dy, std, color = attrs
        kernel = blur_ops.gaussian_kernel(transform, (std, std))
        taps = None if kernel is None else blur_ops.upload_kernel(kernel, device)
        return taps, _upload(color[:3], device)
    if kind == FE_CONVOLVE_MATRIX:
        kernel, divisor, _bias, _preserve_alpha = attrs
        return _same_kernel(np.asarray(kernel, np.float64) / divisor, device)
    if kind in (FE_DIFFUSE_LIGHTING, FE_SPECULAR_LIGHTING):
        # the spec's normal is a cross-correlation with its Sobel kernels,
        # that is a true convolution with the kernels negated (turned half
        # round, an antisymmetric kernel changes sign)
        return (_same_kernel(-_SOBEL / 4.0, device), _same_kernel(-_SOBEL.T / 4.0, device),
                _upload(attrs[3], device))
    if kind == FE_IMAGE:
        scene, region = attrs
        if isinstance(scene, tuple) and scene[0] == "raster":
            # external raster resource (PNG): stretched onto its subregion
            # (or its intrinsic pixel size in user units), axis-aligned —
            # rotation of the placement box is not applied
            from .paint import resize_bilinear

            raster = np.asarray(scene[1], dtype=np.float64) / 255.0
            if region is None:
                region = (0.0, 0.0, float(raster.shape[1]), float(raster.shape[0]))
            offset, (h, w) = _output_region(region, None, transform)
            image = resize_bilinear(
                torch.as_tensor(raster, device=device).to(torch.float32), h, w)
            layer = Layer(image, offset, pre_alpha=False, linear_rgb=False)
            return layer.convert(pre_alpha=False, linear_rgb=linear)
        tr = transform
        if region is not None:
            tr = transform @ Transform().translate(region[0], region[1])
        result = scene.render(tr, linear_rgb=linear, device=device)
        return None if result is None else result[0].convert(pre_alpha=False,
                                                              linear_rgb=linear)
    return None


def _apply(kind: int, attrs: tuple, inputs: list, transform: Transform,
           linear: bool, const) -> Layer:
    """One primitive's result; const: its _prepare_primitive constants."""
    if kind == FE_OFFSET:
        dx, dy = attrs
        (layer,) = inputs
        x, y = layer.offset
        tx, ty = transform(transform.invert(np.array([x, y], dtype=np.float64)) + [dx, dy])
        return layer.translate(int(tx) - x, int(ty) - y)

    if kind == FE_MERGE:
        return Layer.compose(inputs, linear_rgb=linear)

    if kind == FE_BLEND:
        from .ops.compose import BLEND_MODES

        (mode,) = attrs
        in1, in2 = inputs
        if mode is None or mode == "normal":
            return Layer.compose([in2, in1], linear_rgb=linear)
        if mode in BLEND_MODES:
            return Layer.compose([in2, in1], mode, linear_rgb=linear)
        warnings.warn(f"unsupported blend mode {mode!r}; using OVER")
        return Layer.compose([in2, in1], linear_rgb=linear)

    if kind == FE_COMPOSITE:
        (mode,) = attrs
        in1, in2 = inputs
        return Layer.compose([in2, in1], mode, linear_rgb=linear)

    if kind == FE_GAUSSIAN_BLUR:
        (layer,) = inputs
        if const is None:  # sub-pixel blur: a no-op
            return layer
        return layer.convolve(const, linear)

    if kind == FE_COLOR_MATRIX:
        (matrix,) = attrs
        (layer,) = inputs
        if const is None:
            warnings.warn(f"invalid color matrix: {matrix}")
            return layer
        return layer.color_matrix(const, linear)

    if kind == FE_MORPHOLOGY:
        rx, ry, method = attrs
        (layer,) = inputs
        # user-space radii scaled into device pixels; rotation is ignored
        unit = transform.apply_vectors(np.array([[rx, 0.0], [0.0, ry]]))
        size0 = int(np.linalg.norm(unit[0]) * 2)
        size1 = int(np.linalg.norm(unit[1]) * 2)
        if size0 < 1 or size1 < 1:
            return layer
        return layer.morphology(size0, size1, method, linear)

    if kind == FE_FLOOD:
        _color, region = attrs
        (source,) = inputs
        offset, (h, w) = _output_region(region, source, transform)
        image = const.expand(h, w, 4)
        return Layer(image, offset, pre_alpha=False, linear_rgb=linear)

    if kind == FE_TILE:
        tile, source = inputs
        # the input layer's extent is the tile; it repeats across the
        # source's extent (subregion tracking approximated by extents)
        dev = tile.image.device
        rows = (torch.arange(source.height, device=dev) + source.x - tile.x) % tile.height
        cols = (torch.arange(source.width, device=dev) + source.y - tile.y) % tile.width
        image = tile.image[rows[:, None], cols[None, :]]
        return Layer(image, source.offset, tile.pre_alpha, tile.linear_rgb)

    if kind == FE_COMPONENT_TRANSFER:
        (funcs,) = attrs
        (layer,) = inputs
        layer = layer.convert(pre_alpha=False, linear_rgb=linear)
        chans = [
            _transfer_channel(layer.image[..., c], funcs.get(c)) for c in range(4)
        ]
        return Layer(
            torch.clamp(torch.stack(chans, dim=-1), 0.0, 1.0),
            layer.offset, pre_alpha=False, linear_rgb=linear,
        )

    if kind == FE_TURBULENCE:
        base_fx, base_fy, octaves, _seed, fractal, region = attrs
        (source,) = inputs
        offset, (h, w) = _output_region(region, source, transform)
        if source.image.is_cuda:  # csrc/fe_turbulence.cu, the same arithmetic in one launch
            from .ops.fused_exec import fe_turbulence as noise
        else:
            from .ops.turbulence import turbulence_region as noise
        selector, gradient = const
        # device pixel centers -> user space (the spec evaluates noise in
        # user coordinates; baseFrequency is per user unit)
        image = noise(selector, gradient, offset, (h, w), transform.invert.m[:2],
                      float(base_fx), float(base_fy), max(octaves, 1), bool(fractal))
        return Layer(image, offset, pre_alpha=False, linear_rgb=linear)

    if kind == FE_DROP_SHADOW:
        dx, dy, _std, color = attrs
        taps, rgb = const
        (layer,) = inputs
        alpha = layer.convert(pre_alpha=False, linear_rgb=linear).image[..., -1:]
        zeros_rgb = alpha.new_zeros((*alpha.shape[:2], 3))
        shadow = Layer(
            torch.cat([zeros_rgb, alpha], dim=-1),
            layer.offset, pre_alpha=False, linear_rgb=linear,
        )
        if taps is not None:
            shadow = shadow.convolve(taps, linear)
        shadow = _apply(FE_OFFSET, (dx, dy), [shadow], transform, linear, None)
        rgb = rgb.expand(*shadow.image.shape[:2], 3)
        tinted = Layer(
            torch.cat([rgb, shadow.image[..., -1:] * float(color[3])], dim=-1),
            shadow.offset, pre_alpha=False, linear_rgb=linear,
        )
        return Layer.compose([tinted, layer], linear_rgb=linear)

    if kind == FE_CONVOLVE_MATRIX:
        _kernel, _divisor, bias, preserve_alpha = attrs
        (layer,) = inputs
        # the spec convolves premultiplied pixels (unless preserveAlpha);
        # kernelMatrix is applied rotated 180deg, i.e. a true convolution.
        # Edge mode: zero fill ('none'); 'duplicate'/'wrap' degrade to it.
        pre = layer.convert(pre_alpha=not preserve_alpha, linear_rgb=linear)
        image = _convolve_same(pre.image, const)
        image = image + float(bias)
        if preserve_alpha:
            image = torch.cat([image[..., :3], pre.image[..., -1:]], dim=-1)
        return Layer(image, pre.offset, pre_alpha=not preserve_alpha, linear_rgb=linear)

    if kind == FE_DISPLACEMENT_MAP:
        scale, x_chan, y_chan = attrs
        in1, in2 = inputs
        src = in1.convert(pre_alpha=False, linear_rgb=linear)
        dmap = in2.convert(pre_alpha=False, linear_rgb=linear)
        h, w = src.height, src.width
        dev = src.image.device
        rows = torch.arange(h, device=dev)[:, None].expand(h, w)
        cols = torch.arange(w, device=dev)[None, :].expand(h, w)
        # sample the displacement channels over in1's extent (transparent
        # black where in2 is undefined)
        mr = torch.clamp(rows + (src.x - dmap.x), 0, dmap.height - 1)
        mc = torch.clamp(cols + (src.y - dmap.y), 0, dmap.width - 1)
        inside = (
            (rows + (src.x - dmap.x) >= 0) & (rows + (src.x - dmap.x) < dmap.height)
            & (cols + (src.y - dmap.y) >= 0) & (cols + (src.y - dmap.y) < dmap.width)
        )
        dvals = torch.where(inside[..., None], dmap.image[mr, mc],
                            torch.zeros((), device=dev))
        # displacement is in user units along user x/y; map into device px
        dx_u = float(scale) * (dvals[..., x_chan] - 0.5)
        dy_u = float(scale) * (dvals[..., y_chan] - 0.5)
        m = transform.m
        d0 = float(m[0, 0]) * dx_u + float(m[0, 1]) * dy_u
        d1 = float(m[1, 0]) * dx_u + float(m[1, 1]) * dy_u
        r_src = torch.round(rows + d0)
        c_src = torch.round(cols + d1)
        sr = torch.clamp(r_src.to(torch.int32), 0, h - 1).long()
        sc = torch.clamp(c_src.to(torch.int32), 0, w - 1).long()
        valid = (r_src >= 0) & (r_src < h) & (c_src >= 0) & (c_src < w)
        image = torch.where(valid[..., None], src.image[sr, sc],
                            torch.zeros((), device=dev))
        return Layer(image, src.offset, pre_alpha=False, linear_rgb=linear)

    if kind == FE_IMAGE:
        (source,) = inputs
        if const is None:  # the fragment rendered nothing
            offset, (h, w) = _output_region(None, source, transform)
            return Layer(
                source.image.new_zeros((h, w, 4)), offset,
                pre_alpha=True, linear_rgb=linear,
            )
        return const

    if kind in (FE_DIFFUSE_LIGHTING, FE_SPECULAR_LIGHTING):
        surface_scale, k, exponent, _color, light = attrs
        sobel_r, sobel_c, color = const
        (layer,) = inputs
        a = layer.convert(pre_alpha=False, linear_rgb=linear).image[..., 3]
        # surface normal from the alpha height map (spec 15.14; the Sobel
        # factors are the spec's interior-pixel kernels, computed here in
        # device axes with kernelUnitLength = 1 device pixel)
        grad_r = _convolve_same(a[..., None], sobel_r)[..., 0]
        grad_c = _convolve_same(a[..., None], sobel_c)[..., 0]
        nr = -surface_scale * grad_r
        nc = -surface_scale * grad_c
        inv_norm = 1.0 / torch.sqrt(nr * nr + nc * nc + 1.0)
        z_surf = surface_scale * a

        l_r, l_c, l_z, atten = _light_vector(light, layer, transform, z_surf)
        n_dot_l = (nr * l_r + nc * l_c + l_z) * inv_norm
        if kind == FE_DIFFUSE_LIGHTING:
            value = k * torch.clamp(n_dot_l, min=0.0) * atten
            rgb = value[..., None] * color
            out = torch.cat([rgb, torch.ones_like(value)[..., None]], dim=-1)
        else:
            # H = (L + eye) / |L + eye| with eye = (0, 0, 1)
            hz = l_z + 1.0
            h_norm = torch.sqrt(l_r * l_r + l_c * l_c + hz * hz)
            h_norm = torch.clamp(h_norm, min=1e-9)
            n_dot_h = (nr * l_r + nc * l_c + hz) * inv_norm / h_norm
            value = k * torch.pow(torch.clamp(n_dot_h, min=0.0), exponent) * atten
            rgb = torch.clamp(value[..., None] * color, 0.0, 1.0)
            alpha = rgb.amax(dim=-1, keepdim=True)
            out = torch.cat([rgb, alpha], dim=-1)
        return Layer(torch.clamp(out, 0.0, 1.0), layer.offset, pre_alpha=False, linear_rgb=linear)

    raise ValueError(f"unsupported filter kind: {kind}")


_SOBEL = np.array([[-1.0, -2.0, -1.0], [0.0, 0.0, 0.0], [1.0, 2.0, 1.0]])


def _light_vector(light, layer: Layer, transform: Transform, z_surf):
    """Per-pixel unit light vector (rows, cols, z) + spot attenuation.

    Positions/directions are authored in user space; they are mapped into
    the device frame (where the surface normal is computed) through the
    presentation transform.  Returns (l_r, l_c, l_z, attenuation).
    """
    kind = light[0]
    if kind == "distant":
        _k, azimuth, elevation = light
        d = transform.apply_vectors(
            np.array([[math.cos(azimuth) * math.cos(elevation),
                       math.sin(azimuth) * math.cos(elevation)]])
        )[0]
        xy = np.hypot(d[0], d[1])
        user_xy = math.cos(elevation)
        if user_xy > 1e-9 and xy > 1e-9:
            d = d / xy * user_xy  # keep |L| = 1 after the device mapping
        lz = math.sin(elevation)
        one = torch.ones_like(z_surf)
        return (float(d[0]) * one, float(d[1]) * one,
                torch.full_like(z_surf, lz), 1.0)

    # point / spot: position in user space -> device pixels
    pos = transform(np.array([light[1], light[2]], dtype=np.float64))
    scale = float(np.sqrt(abs(np.linalg.det(transform.m[:2, :2])))) or 1.0
    pz = light[3] * scale
    h, w = z_surf.shape
    dev = z_surf.device
    rows = torch.arange(h, dtype=z_surf.dtype, device=dev)[:, None] + layer.x + 0.5
    cols = torch.arange(w, dtype=z_surf.dtype, device=dev)[None, :] + layer.y + 0.5
    l_r = float(pos[0]) - rows
    l_c = float(pos[1]) - cols
    l_z = float(pz) - z_surf
    norm = torch.sqrt(l_r * l_r + l_c * l_c + l_z * l_z)
    norm = torch.clamp(norm, min=1e-9)
    l_r, l_c, l_z = l_r / norm, l_c / norm, l_z / norm
    if kind == "point":
        return l_r, l_c, l_z, 1.0

    _k, _x, _y, _z, px, py, pzu, spec_exp, cone = light
    at = transform(np.array([px, py], dtype=np.float64))
    s = np.array([at[0] - pos[0], at[1] - pos[1], (pzu - light[3]) * scale])
    s_norm = np.linalg.norm(s)
    if s_norm < 1e-9:
        return l_r, l_c, l_z, 1.0
    s = s / s_norm
    minus_l_dot_s = -(l_r * float(s[0]) + l_c * float(s[1]) + l_z * float(s[2]))
    atten = torch.pow(torch.clamp(minus_l_dot_s, min=0.0), spec_exp)
    if cone is not None:
        atten = torch.where(minus_l_dot_s < math.cos(cone),
                            torch.zeros((), device=dev), atten)
    return l_r, l_c, l_z, atten


def _convolve_same(image, flipped: torch.Tensor):
    """SAME-extent true convolution of every channel with a 2D kernel,
    given flipped (_same_kernel) on the image's device (XLA's SAME padding:
    the odd pixel of an even kernel's padding goes after).  cuDNN's TF32 is
    switched off where it runs."""
    kh, kw = flipped.shape
    ch = image.shape[-1]
    x = image.permute(2, 0, 1)[None]
    k = flipped[None, None].expand(ch, 1, kh, kw).contiguous()
    x = F.pad(x, ((kw - 1) // 2, kw - 1 - (kw - 1) // 2,
                  (kh - 1) // 2, kh - 1 - (kh - 1) // 2))
    with torch.backends.cudnn.flags(
        enabled=torch.backends.cudnn.enabled,
        benchmark=torch.backends.cudnn.benchmark,
        deterministic=torch.backends.cudnn.deterministic,
        allow_tf32=False,
    ):
        out = F.conv2d(x, k, groups=ch)
    return out[0].permute(1, 2, 0)


def _crop_to_region(layer: Layer, region, transform: Transform) -> Layer:
    """Clip a primitive's result to its device-mapped subregion box."""
    x, y, w, h = region
    corners = transform(
        np.array([[x, y], [x + w, y], [x, y + h], [x + w, y + h]], dtype=np.float64)
    )
    lo = np.floor(corners.min(axis=0)).astype(int)
    hi = np.ceil(corners.max(axis=0)).astype(int)
    r0 = max(int(lo[0]), layer.x)
    c0 = max(int(lo[1]), layer.y)
    r1 = min(int(hi[0]), layer.x + layer.height)
    c1 = min(int(hi[1]), layer.y + layer.width)
    if r0 >= r1 or c0 >= c1:
        return Layer(
            layer.image.new_zeros((1, 1, 4)), (int(lo[0]), int(lo[1])),
            layer.pre_alpha, layer.linear_rgb,
        )
    image = layer.image[r0 - layer.x : r1 - layer.x, c0 - layer.y : c1 - layer.y]
    return Layer(image, (r0, c0), layer.pre_alpha, layer.linear_rgb)


def _output_region(region, source: Layer, transform: Transform):
    """Device-space (offset, (h, w)) for a no-input primitive: the explicit
    user-space subregion when given, else the source graphic's extent."""
    if region is None:
        return source.offset, (source.height, source.width)
    x, y, w, h = region
    corners = transform(
        np.array([[x, y], [x + w, y], [x, y + h], [x + w, y + h]], dtype=np.float64)
    )
    lo = np.floor(corners.min(axis=0)).astype(int)
    hi = np.ceil(corners.max(axis=0)).astype(int)
    return (int(lo[0]), int(lo[1])), (int(hi[0] - lo[0]), int(hi[1] - lo[1]))


def _transfer_channel(values, fn):
    """One feComponentTransfer transfer function (SVG 1.1 15.11.2)."""
    if fn is None or fn[0] == "identity":
        return values
    kind = fn[0]
    if kind == "table":
        table = np.asarray(fn[1], dtype=np.float64)
        n = len(table)
        if n == 0:
            return values
        if n == 1:
            return torch.full_like(values, float(table[0]))
        t = values * (n - 1)
        out = torch.full_like(values, float(table[0]))
        for k in range(1, n):
            out = out + torch.clamp(t - (k - 1), 0.0, 1.0) * float(table[k] - table[k - 1])
        return out
    if kind == "discrete":
        table = np.asarray(fn[1], dtype=np.float64)
        n = len(table)
        if n == 0:
            return values
        out = torch.full_like(values, float(table[0]))
        for k in range(1, n):
            out = out + (values >= k / n).to(values.dtype) * float(table[k] - table[k - 1])
        return out
    if kind == "linear":
        _kind, slope, intercept = fn
        return values * float(slope) + float(intercept)
    if kind == "gamma":
        _kind, amplitude, exponent, offset = fn
        return (float(amplitude) * torch.pow(torch.clamp(values, min=0.0), float(exponent))
                + float(offset))
    warnings.warn(f"unknown transfer function type: {kind}")
    return values
