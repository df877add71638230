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
This port carries the node and builder classes that the SVG frontend
builds; executing a filter needs the isolation-pass slice (ROADMAP queue 1
item 8), so calling a Filter raises NotImplementedError.
"""

from __future__ import annotations

import math
import warnings
from typing import NamedTuple

import numpy as np

from .core.transform import Transform

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
    def __call__(self, transform: Transform, source):
        raise NotImplementedError(
            "filter execution needs the isolation-pass slice "
            "(ROADMAP queue 1 item 8)"
        )
