"""Sparse offset image tiles ("layers") and their composition.

A Layer is a torch image (H, W, C) plus an integer offset into an implicit
infinite canvas, carrying lazy color-state flags (premultiplied? linear?),
as in the reference (svgrasterize.py:44-416).  A copy of the JAX package's
core/layer.py: conversion and merging are pure (no in-place mutation of a
layer's image), and every image stays on the device it was made on.

Axis convention: image axis 0 is the first coordinate produced by the render
transform.  The CLI prepends the swap matrix(0,1,0,1,0,0), which makes axis 0
the image row (user y) — identical to the reference (svgrasterize.py:3823).
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch

from . import color as color_ops
from ..ops import compose as compose_ops
from ..ops.compose import COMPOSE_IN, COMPOSE_OVER, COMPOSE_PRE_ALPHA


class Layer:
    __slots__ = ("image", "offset", "pre_alpha", "linear_rgb")

    def __init__(self, image, offset: tuple[int, int], pre_alpha: bool, linear_rgb: bool):
        if not isinstance(image, torch.Tensor):
            image = torch.as_tensor(np.asarray(image, np.float32))
        self.image = image
        self.offset = (int(offset[0]), int(offset[1]))
        self.pre_alpha = bool(pre_alpha)
        self.linear_rgb = bool(linear_rgb)

    # --- geometry --------------------------------------------------------
    @property
    def x(self) -> int:
        return self.offset[0]

    @property
    def y(self) -> int:
        return self.offset[1]

    @property
    def height(self) -> int:
        return self.image.shape[0]

    @property
    def width(self) -> int:
        return self.image.shape[1]

    @property
    def channels(self) -> int:
        return self.image.shape[2]

    @property
    def bbox(self) -> tuple[int, int, int, int]:
        # (offset0, offset1, extent0, extent1) — extent0 runs along axis 0
        return (*self.offset, *self.image.shape[:2])

    def translate(self, dx: int, dy: int) -> "Layer":
        return Layer(self.image, (self.x + dx, self.y + dy), self.pre_alpha, self.linear_rgb)

    # --- color state -------------------------------------------------------
    def convert(self, pre_alpha: bool | None = None, linear_rgb: bool | None = None) -> "Layer":
        """Lazily convert alpha mode / colorspace, only when they differ."""
        pre_alpha = self.pre_alpha if pre_alpha is None else pre_alpha
        linear_rgb = self.linear_rgb if linear_rgb is None else linear_rgb

        if self.channels == 1:
            # single channel is alpha-only: colorspace-free
            return Layer(self.image, self.offset, pre_alpha, linear_rgb)

        image = self.image
        cur_pre, cur_lin = self.pre_alpha, self.linear_rgb
        if cur_lin != linear_rgb:
            if cur_pre:
                image = color_ops.pre_to_straight_alpha(image)
                cur_pre = False
            image = color_ops.srgb_to_linear(image) if linear_rgb else color_ops.linear_to_srgb(image)
            cur_lin = linear_rgb
        if cur_pre != pre_alpha:
            if pre_alpha:
                image = color_ops.straight_to_pre_alpha(image)
            else:
                image = color_ops.pre_to_straight_alpha(image)
            cur_pre = pre_alpha
        if image is self.image:
            return self
        return Layer(image, self.offset, cur_pre, cur_lin)

    # --- pixel operations ---------------------------------------------------
    def opacity(self, opacity: float, linear_rgb: bool = False) -> "Layer":
        layer = self.convert(pre_alpha=True, linear_rgb=linear_rgb)
        return Layer(layer.image * float(opacity), layer.offset, True, linear_rgb)

    def background(self, bg_color) -> "Layer":
        layer = self.convert(pre_alpha=True, linear_rgb=True)
        bg = torch.as_tensor(
            np.asarray(bg_color, np.float32), device=layer.image.device
        )
        image = compose_ops.over(bg[None, None, :], layer.image)
        return Layer(image, layer.offset, True, True)

    def color_matrix(self, matrix, linear_rgb: bool = True) -> "Layer":
        """Apply a 4x5 affine color matrix (feColorMatrix semantics).

        matrix: the (4, 5) array, or its (4, 4) and (4,) parts as f32
        tensors on the layer's device (Filter.prepare uploads them once).
        linear_rgb selects the operating space (the filter chain's
        color-interpolation-filters)."""
        layer = self.convert(pre_alpha=False, linear_rgb=linear_rgb)
        if isinstance(matrix, tuple):
            m, b = matrix
        else:
            matrix = np.asarray(matrix)
            if matrix.shape != (4, 5):
                raise ValueError("expected 4x5 color matrix")
            dev = layer.image.device
            m = torch.as_tensor(matrix[:, :4].astype(np.float32), device=dev)
            b = torch.as_tensor(matrix[:, 4].astype(np.float32), device=dev)
        image = torch.clamp(layer.image @ m.T + b, 0, 1)
        return Layer(image, layer.offset, False, linear_rgb)

    def convolve(self, kernel, linear_rgb: bool = True) -> "Layer":
        """Full 2D convolution of every channel with `kernel` (feGaussianBlur).

        kernel: a (kh, kw) array, or its blur.BlurTaps on the layer's
        device (Filter.prepare uploads them once).  Rank-1 kernels
        (axis-aligned blurs) run as two band matmuls — kh + kw taps per
        pixel instead of kh * kw — or, for a 4-channel layer on the card, as
        csrc/fe_blur.cu, which un-premultiplies as it loads where the
        colorspace stays.  linear_rgb selects the operating space
        (color-interpolation-filters)."""
        from ..ops import blur

        if not isinstance(kernel, blur.BlurTaps):
            kernel = blur.upload_kernel(np.asarray(kernel), self.image.device)
        kh, kw = kernel.shape
        if kernel.full is None and self.channels == 4 and self.image.is_cuda:
            from ..ops import fused_exec

            unpremultiply = self.pre_alpha and self.linear_rgb == linear_rgb
            layer = self if unpremultiply else self.convert(pre_alpha=False,
                                                            linear_rgb=linear_rgb)
            image = fused_exec.fe_blur(layer.image.contiguous(), kernel, unpremultiply)
        else:
            layer = self.convert(pre_alpha=False, linear_rgb=linear_rgb)
            if kernel.full is None:
                image = blur.convolve_separable(layer.image, kernel.u, kernel.v)
            else:
                image = blur.convolve_full(layer.image, kernel.full)
        # the reference truncates x - k/2 toward zero, which shifts the blur
        # by one pixel whenever x > k/2; reproduced bit-for-bit (callers feed
        # bbox-tight layers so the same x reaches this formula)
        offset = (int(layer.x - kh / 2), int(layer.y - kw / 2))
        return Layer(image, offset, False, linear_rgb)

    def morphology(self, size0: int, size1: int, method: str,
                   linear_rgb: bool = True) -> "Layer":
        from ..ops import morphology

        layer = self.convert(pre_alpha=True, linear_rgb=linear_rgb)
        image = morphology.pooling(layer.image, (size0, size1), stride=(1, 1), method=method)
        return Layer(image, layer.offset, True, linear_rgb)

    # --- composition -----------------------------------------------------------
    @staticmethod
    def compose(layers: Sequence["Layer"], method=COMPOSE_OVER, linear_rgb: bool = False) -> "Layer | None":
        """Compose layers (in paint order) with a Porter-Duff operator.

        Named operators run on premultiplied alpha; the union of bboxes is
        used except for IN which uses the intersection.
        """
        layers = [l for l in layers if l is not None]
        if not layers:
            return None
        if len(layers) == 1:
            return layers[0]
        # named Porter-Duff operators and blend modes work on premultiplied
        pre_alpha = method in COMPOSE_PRE_ALPHA or isinstance(method, str)
        images = [(l.convert(pre_alpha=pre_alpha, linear_rgb=linear_rgb).image, l.offset) for l in layers]
        blend = lambda dst, src: compose_ops.compose(method, dst, src)
        if method == COMPOSE_IN:
            result = merge_intersect(images, blend)
        elif method == COMPOSE_OVER:
            result = merge_union(images, full=False, blend=blend)
        else:
            result = merge_union(images, full=True, blend=blend)
        if result is None:
            return None
        image, offset = result
        return Layer(image, offset, pre_alpha, linear_rgb)

    # --- output -----------------------------------------------------------------
    def to_numpy(self) -> np.ndarray:
        return self.image.detach().cpu().numpy()

    def write_png(self, output=None):
        from . import png

        if self.channels != 4:
            raise ValueError("only RGBA layers can be encoded")
        layer = self.convert(pre_alpha=False, linear_rgb=False)
        return png.write_png(layer.to_numpy(), output)

    def __repr__(self):
        return (
            f"Layer(offset={self.offset}, shape={tuple(self.image.shape)}, "
            f"pre_alpha={self.pre_alpha}, linear_rgb={self.linear_rgb})"
        )


# ------------------------------------------------------------------------------
# canvas merge helpers
# ------------------------------------------------------------------------------
def _expand(image, bbox, full_bbox):
    """Place `image` (at bbox) into a zero canvas covering full_bbox."""
    x0, y0, h, w = full_bbox
    out = image.new_zeros((h, w, image.shape[2]))
    r, c = bbox[0] - x0, bbox[1] - y0
    out[r:r + image.shape[0], c:c + image.shape[1]] = image
    return out


def merge_union(images, full: bool, blend: Callable):
    """Blend layers into one image covering the union of their bboxes.

    With full=False (valid only for OVER) each layer is blended only over its
    own sub-window, skipping work on untouched pixels.
    """
    if not images:
        return None
    if len(images) == 1:
        return images[0]

    min0 = min(off[0] for _, off in images)
    min1 = min(off[1] for _, off in images)
    max0 = max(off[0] + img.shape[0] for img, off in images)
    max1 = max(off[1] + img.shape[1] for img, off in images)
    h, w = max0 - min0, max1 - min1

    channels = max(img.shape[2] for img, _ in images)

    if full:
        out = None
        for img, off in images:
            img_full = _expand(_as_channels(img, channels), (off[0], off[1]), (min0, min1, h, w))
            out = img_full if out is None else blend(out, img_full)
    else:
        out = images[0][0].new_zeros((h, w, channels))
        for index, (img, off) in enumerate(images):
            r, c = off[0] - min0, off[1] - min1
            img = _as_channels(img, channels)
            ih, iw = img.shape[:2]
            if index == 0:
                out[r:r + ih, c:c + iw] = img
            else:
                out[r:r + ih, c:c + iw] = blend(out[r:r + ih, c:c + iw], img)
    return out, (min0, min1)


def merge_intersect(images, blend: Callable):
    """Blend layers over the intersection of their bboxes (COMPOSE_IN)."""
    if not images:
        return None
    if len(images) == 1:
        return images[0]

    min0 = max(off[0] for _, off in images)
    min1 = max(off[1] for _, off in images)
    max0 = min(off[0] + img.shape[0] for img, off in images)
    max1 = min(off[1] + img.shape[1] for img, off in images)
    if min0 >= max0 or min1 >= max1:
        return None
    h, w = max0 - min0, max1 - min1

    (first, foff), *rest = images
    out = first[min0 - foff[0]:min0 - foff[0] + h, min1 - foff[1]:min1 - foff[1] + w]
    if out.shape[2] == 1:
        out = out.expand(h, w, 4)
    for img, off in rest:
        window = img[min0 - off[0]:min0 - off[0] + h, min1 - off[1]:min1 - off[1] + w]
        out = blend(out, window)
    return out, (min0, min1)


def merge_at(base, overlay, offset, blend=compose_ops.over):
    """Blend `overlay` onto `base` at `offset`, clipping to base bounds."""
    r, c = offset
    bh, bw = base.shape[:2]
    oh, ow = overlay.shape[:2]
    # clip overlay to the base window
    r0, r1 = max(r, 0), min(r + oh, bh)
    c0, c1 = max(c, 0), min(c + ow, bw)
    if r0 >= r1 or c0 >= c1:
        return base
    overlay = overlay[r0 - r : r1 - r, c0 - c : c1 - c]
    out = base.clone()
    window = base[r0:r1, c0:c1]
    out[r0:r1, c0:c1] = torch.clamp(blend(window, overlay), 0, 1)
    return out


def _as_channels(img, channels: int):
    if img.shape[2] == channels:
        return img
    return img.expand(*img.shape[:2], channels)


def canvas_create(width: int, height: int, bg=None, device="cuda"):
    """Create an (h, w, 4) canvas on `device` and the row/col render
    transform."""
    from .transform import Transform

    if bg is None:
        canvas = torch.zeros((height, width, 4), dtype=torch.float32, device=device)
    else:
        bg = torch.as_tensor(np.asarray(bg, np.float32), device=device)
        canvas = bg.expand(height, width, 4).clone()
    return canvas, Transform().matrix(0, 1, 0, 1, 0, 0)


Canvas = canvas_create
