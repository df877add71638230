"""Anti-aliased signed-coverage rasterization of one edge list: the twin of
the JAX package's ops/coverage.py, and the plain version of the whole-image
winding kernel (csrc/winding.cu, wrapper ops/fused_exec.winding).

For an edge (a line segment) and a pixel cell (r, c), clip the edge to the
row slab [r, r+1] giving a linear function X(y) over [y_lo, y_hi].  The
edge's contribution to the pixel's winding-with-fractional-coverage is

    sign(dy) * (y_hi - y_lo) * mean_y clamp((c + 1) - X(y), 0, 1)

and the mean of the clamped linear function has a closed form through the
antiderivative C(t) = 0 (t <= 0) | t^2/2 (0 < t < 1) | t - 1/2 (t >= 1):
(C(g1) - C(g0)) / (g1 - g0).  Summed over all edges this is the exact
signed trapezoid area of the reference's accumulate-then-cumsum scanline.

Boundary semantics match the reference: rows outside [0, H) are dropped,
columns clamp on the left (area left of column 0 counts fully) and drop on
the right.
"""

from __future__ import annotations

import torch

# elements per (lists, edges, H, W) temporary of winding_fields
_BUDGET = 1 << 22


def clamp_antideriv(t):
    """Antiderivative of clamp(t, 0, 1)."""
    return torch.where(
        t <= 0, torch.zeros_like(t), torch.where(t >= 1, t - 0.5, 0.5 * t * t)
    )


def _chunk_winding(lines, rows, cols):
    """Winding contribution of a chunk of edges of many edge lists.

    lines: (C, E, 4) rows [a0, a1, b0, b1] — endpoints in (row, col) coords;
    rows: (H, 1) row indices; cols: (W,) column indices.  Returns (C, H, W).
    """
    a0, a1, b0, b1 = lines.unbind(-1)                    # (C, E)
    sign = torch.sign(b0 - a0)[..., None, None]
    y_lo = torch.minimum(a0, b0)
    y_hi = torch.maximum(a0, b0)
    x_at_lo = torch.where(a0 <= b0, a1, b1)
    x_at_hi = torch.where(a0 <= b0, b1, a1)
    dy_seg = y_hi - y_lo
    slope = (x_at_hi - x_at_lo) / torch.where(dy_seg > 0, dy_seg, torch.ones_like(dy_seg))
    y_lo4 = y_lo[..., None, None]
    slope4 = slope[..., None, None]

    # clip each edge to each row slab
    lo = torch.maximum(y_lo4, rows)                      # (C, E, H, 1)
    hi = torch.minimum(y_hi[..., None, None], rows + 1.0)
    dy = torch.clamp(hi - lo, min=0.0)
    x_lo = x_at_lo[..., None, None] + slope4 * (lo - y_lo4)
    x_hi = x_at_lo[..., None, None] + slope4 * (hi - y_lo4)

    # per-column clamped mean of (c + 1) - X(y)
    g0 = (cols + 1.0) - x_lo                             # (C, E, H, W)
    g1 = (cols + 1.0) - x_hi
    den = g1 - g0
    safe = torch.abs(den) > 1e-7
    mean = torch.where(
        safe,
        (clamp_antideriv(g1) - clamp_antideriv(g0))
        / torch.where(safe, den, torch.ones_like(den)),
        torch.clamp(0.5 * (g0 + g1), 0.0, 1.0),
    )
    return (sign * dy * mean).sum(dim=1)


def winding_fields(lines, height: int, width: int):
    """Winding fields of many edge lists: (C, S, 4) f32 -> (C, H, W) f32.

    Edges are taken in chunks that keep each temporary under _BUDGET
    elements; zero and horizontal rows contribute nothing.
    """
    c, s, _ = lines.shape
    dev = lines.device
    rows = torch.arange(height, dtype=torch.float32, device=dev).view(height, 1)
    cols = torch.arange(width, dtype=torch.float32, device=dev)
    acc = torch.zeros((c, height, width), dtype=torch.float32, device=dev)
    step = max(1, _BUDGET // max(c * height * width, 1))
    for e0 in range(0, s, step):
        acc += _chunk_winding(lines[:, e0:e0 + step], rows, cols)
    return acc


def winding(lines, height: int, width: int):
    """Exact AA winding field of an edge list: (S, 4) f32 -> (height, width).

    The plain version of the whole-image winding kernel; zero rows and
    horizontal rows contribute nothing, so any padding is allowed.
    """
    return winding_fields(lines.to(torch.float32)[None], height, width)[0]

