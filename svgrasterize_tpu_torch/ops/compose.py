"""Porter-Duff composition ops (torch).

All operators take premultiplied-alpha images except the arithmetic mode
which is defined on raw channel values.  Parity: the five named operators and
the feComposite arithmetic mode of svgrasterize.py:277-298.  A copy of the
JAX package's ops/compose.py; the operator ids match it, and the SVG
frontend writes them into the scene graph.
"""

from __future__ import annotations

import torch

COMPOSE_OVER = 0
COMPOSE_OUT = 1
COMPOSE_IN = 2
COMPOSE_ATOP = 3
COMPOSE_XOR = 4
# Named operators defined on premultiplied alpha; arithmetic mode is a
# (k1, k2, k3, k4) tuple and is computed on straight values.
COMPOSE_PRE_ALPHA = {COMPOSE_OVER, COMPOSE_OUT, COMPOSE_IN, COMPOSE_ATOP, COMPOSE_XOR}


def _alpha_of(img):
    return img[..., -1:] if img.ndim == 3 else img


# separable blend modes (W3C compositing spec, premultiplied forms); the
# reference degrades all of these to OVER (svgrasterize.py:1877)
BLEND_MODES = {"normal", "multiply", "screen", "darken", "lighten"}


def _blend(mode: str, dst, src):
    """Blend premultiplied `src` over `dst` with a separable blend mode."""
    src_a = _alpha_of(src)
    dst_a = _alpha_of(dst)
    if mode == "normal":
        return src + dst * (1 - src_a)
    if mode == "screen":
        return src + dst - src * dst
    if mode == "multiply":
        color = src * dst + src * (1 - dst_a) + dst * (1 - src_a)
    elif mode == "darken":
        color = torch.minimum(src * dst_a, dst * src_a) + src * (1 - dst_a) + dst * (1 - src_a)
    elif mode == "lighten":
        color = torch.maximum(src * dst_a, dst * src_a) + src * (1 - dst_a) + dst * (1 - src_a)
    else:
        raise ValueError(f"invalid blend mode: {mode}")
    alpha = src_a + dst_a * (1 - src_a)
    if color.ndim == 3 and color.shape[-1] > 1:
        color = torch.cat([color[..., :-1], alpha], dim=-1)
    return color


def compose(mode, dst, src):
    """Compose premultiplied `src` onto `dst` with the given operator.

    `mode` is a COMPOSE_* int, a 4-tuple (k1, k2, k3, k4) for the feComposite
    arithmetic operator, or a blend-mode name from BLEND_MODES.  Broadcasting
    follows torch rules, so a single-channel alpha mask composes against an
    RGBA image directly.
    """
    if isinstance(mode, str):
        return _blend(mode, dst, src)
    src_a = _alpha_of(src)
    dst_a = _alpha_of(dst)
    if isinstance(mode, tuple) and len(mode) == 4:
        k1, k2, k3, k4 = (float(k) for k in mode)
        return torch.clamp(k1 * src * dst + k2 * src + k3 * dst + k4, 0, 1)
    if mode == COMPOSE_OVER:
        return src + dst * (1 - src_a)
    if mode == COMPOSE_OUT:
        return src * (1 - dst_a)
    if mode == COMPOSE_IN:
        return src * dst_a
    if mode == COMPOSE_ATOP:
        return src * dst_a + dst * (1 - src_a)
    if mode == COMPOSE_XOR:
        return src * (1 - dst_a) + dst * (1 - src_a)
    raise ValueError(f"invalid compose mode: {mode}")


def over(dst, src):
    """Premultiplied `src` OVER `dst` (broadcasting rules)."""
    return compose(COMPOSE_OVER, dst, src)
