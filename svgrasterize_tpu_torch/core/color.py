"""Color management: sRGB <-> linear, premultiplied <-> straight alpha.

Works on both numpy arrays (host, e.g. parsed paint colors) and torch
tensors (device images) — all functions are pure and allocation-returning,
unlike the reference's in-place style (svgrasterize.py:471-503).  The
transfer curve is the exact piecewise sRGB 2.4-gamma.
"""

from __future__ import annotations

import numpy as np
import torch


def _where(cond, a, b):
    if isinstance(cond, torch.Tensor):
        return torch.where(cond, a, b)
    return np.where(cond, a, b)


def _cat(parts):
    if isinstance(parts[0], torch.Tensor):
        return torch.cat(parts, dim=-1)
    return np.concatenate(parts, axis=-1)


def _clip01(x):
    if isinstance(x, torch.Tensor):
        return torch.clamp(x, 0.0, 1.0)
    return np.clip(x, 0, 1)


def _maximum(x, floor: float):
    if isinstance(x, torch.Tensor):
        return torch.clamp(x, min=floor)
    return np.maximum(x, floor)


def pre_to_straight_alpha(rgba):
    """Un-premultiply alpha: rgb / a where a > ~0, clipped to [0, 1]."""
    rgb = rgba[..., :-1]
    alpha = rgba[..., -1:]
    safe = _where(alpha > 0.0001, alpha, 1.0)
    rgb = _where(alpha > 0.0001, rgb / safe, rgb)
    return _clip01(_cat([rgb, alpha]))


def straight_to_pre_alpha(rgba):
    """Premultiply alpha."""
    return _cat([rgba[..., :-1] * rgba[..., -1:], rgba[..., -1:]])


def linear_to_srgb(rgba):
    """Linear RGB -> sRGB on the color channels; alpha untouched."""
    rgb = rgba[..., :-1]
    lo = rgb * 12.92
    # guard the power against negative inputs (clamped by the select anyway)
    hi = 1.055 * _maximum(rgb, 1e-12) ** (1.0 / 2.4) - 0.055
    rgb = _where(rgb <= 0.0031308, lo, hi)
    return _cat([rgb, rgba[..., -1:]])


def srgb_to_linear(rgba):
    """sRGB -> linear RGB on the color channels; alpha untouched."""
    rgb = rgba[..., :-1]
    lo = rgb / 12.92
    hi = _maximum((rgb + 0.055) / 1.055, 1e-12) ** 2.4
    rgb = _where(rgb <= 0.04045, lo, hi)
    return _cat([rgb, rgba[..., -1:]])


def pre_linear_to_pre_srgb(rgba):
    """Premultiplied linear -> premultiplied sRGB (used for solid paints)."""
    return straight_to_pre_alpha(linear_to_srgb(pre_to_straight_alpha(rgba)))


# Rec.709-ish luminance weights used by SVG masks (svgrasterize.py:735).
MASK_LUMINANCE = np.array([0.2125, 0.7154, 0.072])
