"""Offset image tiles ("layers"): the minimal set the render path uses.

A Layer is a torch image (H, W, C) plus an integer offset into an implicit
infinite canvas, carrying lazy color-state flags (premultiplied? linear?),
as in the reference (svgrasterize.py:44-416).  This port carries what the
one-shot render and the CLI need (conversion, background, PNG output and
merge_at); layer composition, filters and morphology arrive with the
interpreter and isolation-pass slices.

Axis convention: image axis 0 is the first coordinate produced by the render
transform.  The CLI prepends the swap matrix(0,1,0,1,0,0), which makes axis 0
the image row (user y) — identical to the reference (svgrasterize.py:3823).
"""

from __future__ import annotations

import numpy as np
import torch

from . import color as color_ops
from ..ops import compose as compose_ops


class Layer:
    __slots__ = ("image", "offset", "pre_alpha", "linear_rgb")

    def __init__(self, image, offset: tuple[int, int], pre_alpha: bool, linear_rgb: bool):
        if not isinstance(image, torch.Tensor):
            image = torch.as_tensor(np.asarray(image, np.float32))
        self.image = image
        self.offset = (int(offset[0]), int(offset[1]))
        self.pre_alpha = bool(pre_alpha)
        self.linear_rgb = bool(linear_rgb)

    @property
    def channels(self) -> int:
        return self.image.shape[2]

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

    def background(self, bg_color) -> "Layer":
        layer = self.convert(pre_alpha=True, linear_rgb=True)
        bg = torch.as_tensor(
            np.asarray(bg_color, np.float32), device=layer.image.device
        )
        image = compose_ops.over(bg[None, None, :], layer.image)
        return Layer(image, layer.offset, True, True)

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
