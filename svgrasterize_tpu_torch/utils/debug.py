"""Debug visualization helpers (parity: svgrasterize.py:2484-2558, 220-232).

The twin of the JAX package's utils/debug.py.  Curve sampling draws
parametric curves as supersampled dots into a numpy canvas — used for
eyeballing geometry kernels, never on the render path.  `show_layer`
prints an image, wherever it lives, to a truecolor terminal.
"""

from __future__ import annotations

import sys

import numpy as np

from ..geom import bezier

_DISC_TAPS = 5


def point_mask(radius: float = 1.2, taps: int = _DISC_TAPS) -> np.ndarray:
    """Supersampled disc coverage stamp of ceil(2r)^2 pixels."""
    size = int(np.ceil(2 * radius))
    sub = (np.arange(size * taps) + 0.5) / taps - size / 2
    xx, yy = np.meshgrid(sub, sub)
    inside = (xx * xx + yy * yy) <= radius * radius
    return inside.reshape(size, taps, size, taps).mean(axis=(1, 3))


def put_point(canvas: np.ndarray, center, stamp: np.ndarray) -> None:
    """Max-blend a coverage stamp onto a 2D canvas at `center` (row, col)."""
    h, w = canvas.shape[:2]
    s = stamp.shape[0]
    r = int(round(center[0] - s / 2))
    c = int(round(center[1] - s / 2))
    r0, r1 = max(r, 0), min(r + s, h)
    c0, c1 = max(c, 0), min(c + s, w)
    if r0 >= r1 or c0 >= c1:
        return
    window = canvas[r0:r1, c0:c1]
    np.maximum(window, stamp[r0 - r : r1 - r, c0 - c : c1 - c], out=window)


def sample_curve(canvas: np.ndarray, curve, samples: int = 64, radius: float = 1.2):
    """Plot a cubic bezier (4, 2 control points) onto `canvas` by sampling."""
    curve = np.asarray(curve, dtype=np.float64)
    stamp = point_mask(radius)
    ts = np.linspace(0.0, 1.0, samples)
    pts = bezier.cubic_eval(np.broadcast_to(curve, (samples, 4, 2)), ts)
    for pt in pts:
        put_point(canvas, pt, stamp)
    return canvas


def sample_curve_points(canvas: np.ndarray, points, radius: float = 2.0):
    """Plot raw control/vertex points onto `canvas`."""
    stamp = point_mask(radius)
    for pt in np.asarray(points, dtype=np.float64).reshape(-1, 2):
        put_point(canvas, pt, stamp)
    return canvas


def show_layer(layer, out=sys.stdout) -> None:
    """Print a Layer to a truecolor terminal (two pixels per character);
    the image is copied to the host first."""
    image = layer.convert(pre_alpha=False, linear_rgb=False).image.detach().cpu().numpy()
    rgb = np.round(np.clip(image[..., :3], 0, 1) * 255).astype(np.uint8)
    if rgb.shape[0] % 2:
        rgb = np.concatenate([rgb, np.zeros((1, *rgb.shape[1:]), np.uint8)])
    for r in range(0, rgb.shape[0], 2):
        line = []
        for c in range(rgb.shape[1]):
            top = rgb[r, c]
            bot = rgb[r + 1, c]
            line.append(
                f"\x1b[38;2;{top[0]};{top[1]};{top[2]}m"
                f"\x1b[48;2;{bot[0]};{bot[1]};{bot[2]}m▀"
            )
        out.write("".join(line) + "\x1b[0m\n")
