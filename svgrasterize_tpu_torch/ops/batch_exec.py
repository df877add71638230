"""Plain PyTorch executor of a lowered plan: the twin of the JAX package's
ops/batch_exec.py, and the plain version of both CUDA kernels.

The host lowers a scene into a flat, (tile, z)-sorted list of work items
(render_plan.py); this module runs them with ordinary tensor operations:

    1. winding for every work item by the closed-form clamped-trapezoid
       area (ops/coverage.py), vectorised over
       (items, edges, T, T) in chunks; big segment classes run in a
       pre-pass (_prepass_winding) and replace the inline winding
    2. carry, fill rule, clip field, the 1e-6 floor, opacity
    3. the mask luminance of an isolation pass's pool row (mask items)
    4. paint (solid, linear, radial, a pattern tile of the plan's atlas, a
       pool row of an isolation pass for texture items, collapsed-run field)
    5. per-tile premultiplied OVER in z order: each item's rank within its
       tile run is computed, then ranks 0..max each compose all their items
       into their (distinct) tiles with one index_put_

It also holds the plain version of the pool row writer (_pool_rows).
ops/fused_exec.py wraps the CUDA kernels; its wrappers call the functions
here for tensors on the CPU.  Every function takes tensors on one device and
returns tensors on that device.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import coverage

# paint kinds (must match render_plan.PAINT_* of the JAX package)
PAINT_SOLID = 0
PAINT_LINEAR = 1
PAINT_RADIAL = 2
PAINT_PATTERN = 3

# gradient-stop table cap: stop tables are packed to the SCENE's real
# maximum (render_plan k_bucket), so this only bounds the worst case
MAX_STOPS = 64
CHUNK_ITEMS = 128  # lowering pads item counts to multiples of this
SMALL_SEGS = 64  # per-item inline segment budget
CHUNK_BIG = 32  # lowering pads big-class row counts to multiples of this

# Packed per-item parameter columns (plan_from_lowered writes them; the
# CUDA kernel reads the same columns, see csrc/kernels.h).
I_KIND, I_RULE, I_SPREAD, I_BIG, I_CLIP, I_FIELD, I_TEX, I_MASK, I_PAT = range(9)
I_PAT_LO, I_PAT_MAX = 9, 11                # 2 columns each
N_IPARAMS = 13
(F_OPACITY, F_TILE_R, F_TILE_C,
 F_COLOR) = range(4)                       # color: 4 columns
F_AFFINE = 7                               # 6 columns, row-major 2x3
F_P0, F_P1, F_CENTER, F_FCENTER = 13, 15, 17, 19   # 2 columns each
F_RADIUS, F_FRADIUS = 21, 22
F_PAT_FWD = 24                             # 6 columns, row-major 2x3
F_PAT_XY, F_PAT_WH = 30, 32                # 2 columns each
N_FPARAMS = 34

# SVG mask value = luminance x alpha; on premultiplied pixels that is the
# luminance weights dotted with the premultiplied rgb (f32, as the JAX
# package's batch_exec._MASK_LUM and csrc/scene.cu)
MASK_LUM = (0.2125, 0.7154, 0.072)


class DevicePlan(NamedTuple):
    """A lowered item stream (the main stream or a pass group's) as tensors
    on one device.

    Per-item arrays have leading dim N, sorted by (tile_id, z); padding
    items carry tile_id == num_tiles.  Texture and mask items (iparams
    columns I_TEX, I_MASK >= 0) read rows of the isolation-pass pool that
    the executors take as an argument.
    """

    tile: int
    grid: tuple  # (grid_h, grid_w) canvas tiles
    lines: torch.Tensor  # (N, S, 4) f32 tile-local inline edges (a0, a1, b0, b1)
    carry: torch.Tensor  # (N, T) f32 per-row winding carried in from the left
    tile_id: torch.Tensor  # (N,) i32
    iparams: torch.Tensor  # (N, N_IPARAMS) i32, columns I_*
    fparams: torch.Tensor  # (N, N_FPARAMS) f32, columns F_*
    stop_offsets: torch.Tensor  # (N, K) f32
    stop_colors: torch.Tensor  # (N, K, 4) f32 premultiplied
    bigs: tuple  # per width class (M_c, S_c, 4) f32 edge lists
    clips: torch.Tensor | None  # (U, T, T) f32 clip coverage fields
    field: torch.Tensor | None  # (F, T, T, 4) f32 collapsed-run paint fields
    reads_pool: bool = False  # some item has tex_idx or mask_idx >= 0
    patterns: torch.Tensor | None = None  # (Q, TH, TW, 4) f32 pattern-tile atlas
    runs: torch.Tensor | None = None  # (num_tiles + 1,) i32 tile_runs, the scene kernel's

    @property
    def num_tiles(self) -> int:
        return self.grid[0] * self.grid[1]


def tile_runs(tile_id, num_tiles: int) -> np.ndarray:
    """(num_tiles + 1,) int32 run table of a sorted tile_id stream: tile t's
    items are [runs[t], runs[t + 1]) (padding items, at num_tiles, follow
    the last run).  Made once per plan at upload; the scene kernel reads
    its tile's run from it."""
    return np.searchsorted(np.asarray(tile_id), np.arange(num_tiles + 1),
                           side="left").astype(np.int32)


def _prepass_winding(arrays, t_size: int):
    """Winding fields for padded big-class edge lists (M_c, S_c, 4).

    Plain version of the prepass kernel: concatenates the per-class fields
    plus a trailing zero scratch row into one (sum M_c + 1, T, T) stack.
    Returns None when there are no rows.
    """
    winds = []
    for arr in arrays:
        if arr is None or arr.shape[0] == 0:
            continue
        for r0 in range(0, arr.shape[0], CHUNK_BIG):
            winds.append(coverage.winding_fields(arr[r0:r0 + CHUNK_BIG], t_size, t_size))
    if not winds:
        return None
    winds.append(torch.zeros((1, t_size, t_size), dtype=torch.float32,
                             device=winds[0].device))
    return torch.cat(winds, dim=0)


def _coverage(wind, rule):
    """rule: per-item (C, 1, 1) bool, True for evenodd."""
    nonzero = torch.clamp(torch.abs(wind), 0.0, 1.0)
    evenodd = torch.abs(torch.remainder(wind + 1.0, 2.0) - 1.0)
    return torch.where(rule, evenodd, nonzero)


def _spread(t, mode):
    """Spread by integer mode: 0 pad, 1 repeat, 2 reflect."""
    repeat = t - torch.trunc(t)
    reflect = torch.abs(torch.remainder(t + 1.0, 2.0) - 1.0)
    return torch.where(mode == 0, t, torch.where(mode == 1, repeat, reflect))


def _interp_stops(t, offsets, colors):
    """Telescoping piecewise-linear stop lookup.

    t (C, T, T); offsets (C, K); colors (C, K, 4) -> (C, T, T, 4).
    """
    k = offsets.shape[1]
    out = colors[:, 0, None, None, :].expand(*t.shape, 4)
    for i in range(1, k):
        o_prev = offsets[:, i - 1, None, None]
        o_cur = offsets[:, i, None, None]
        span = o_cur - o_prev
        ok = span > 1e-12
        ratio = torch.clamp(
            (t - o_prev) / torch.where(ok, span, torch.ones_like(span)), 0.0, 1.0
        )
        # duplicate offsets (zero span) step at the stop position
        ratio = torch.where(ok, ratio, (t >= o_cur).to(t.dtype))
        out = out + ratio[..., None] * (colors[:, i] - colors[:, i - 1])[:, None, None, :]
    return out


def _paint(fp, ip, stop_offsets, stop_colors, t_size: int, patterns=None):
    """Each item's paint over its tile -> (C, T, T, 4) premultiplied.

    fp / ip are the items' packed parameter rows; the math is the JAX
    package's batch_exec._paint_item, vectorised over items.  patterns is
    the plan's pattern-tile atlas (Q, TH, TW, 4), or None when no item
    paints a pattern.
    """
    dev = fp.device
    col = lambda j: fp[:, j, None, None]                 # (C, 1, 1)
    iota = torch.arange(t_size, dtype=torch.float32, device=dev)
    rows = (iota.view(1, t_size, 1) + col(F_TILE_R)) + 0.5
    cols = (iota.view(1, 1, t_size) + col(F_TILE_C)) + 0.5
    a = F_AFFINE
    gx = rows * col(a) + cols * col(a + 1) + col(a + 2)  # (C, T, T)
    gy = rows * col(a + 3) + cols * col(a + 4) + col(a + 5)

    # linear: project onto the gradient axis
    vec0 = col(F_P1) - col(F_P0)
    vec1 = col(F_P1 + 1) - col(F_P0 + 1)
    denom = torch.clamp(vec0 * vec0 + vec1 * vec1, min=1e-30)
    t_lin = ((gx - col(F_P0)) * vec0 + (gy - col(F_P0 + 1)) * vec1) / denom

    # radial: two-circle equation (focal form; fcenter == center when unused)
    radius = col(F_RADIUS)
    fradius = col(F_FRADIUS)
    cd0 = col(F_CENTER) - col(F_FCENTER)
    cd1 = col(F_CENTER + 1) - col(F_FCENTER + 1)
    pd0 = gx - col(F_FCENTER)
    pd1 = gy - col(F_FCENTER + 1)
    rd = radius - fradius
    a_q = cd0 * cd0 + cd1 * cd1 - rd * rd
    b_q = pd0 * cd0 + pd1 * cd1 + fradius * rd
    c_q = pd0 * pd0 + pd1 * pd1 - fradius * fradius
    det = b_q * b_q - a_q * c_q
    sq = torch.sqrt(torch.clamp(det, min=0.0))
    a_safe = torch.where(torch.abs(a_q) > 1e-30, a_q, torch.full_like(a_q, 1e-30))
    t_rad = torch.maximum((b_q + sq) / a_safe, (b_q - sq) / a_safe)
    rad_valid = det >= 0
    has_rd = torch.abs(rd) > 1e-12
    lim = fradius / torch.where(has_rd, fradius - radius, torch.ones_like(rd))
    rad_valid = torch.where(has_rd, rad_valid & (t_rad > lim), rad_valid)

    kind = ip[:, I_KIND, None, None]
    t = torch.where(kind == PAINT_LINEAR, t_lin, t_rad)
    grad = _interp_stops(
        _spread(t, ip[:, I_SPREAD, None, None]), stop_offsets, stop_colors
    )
    grad = torch.where(
        ((kind == PAINT_RADIAL) & ~rad_valid)[..., None],
        torch.zeros_like(grad), grad,
    )
    solid = fp[:, None, None, F_COLOR:F_COLOR + 4].expand_as(grad)
    out = torch.where((kind == PAINT_SOLID)[..., None], solid, grad)
    if patterns is None:
        return out

    # pattern user space -> modular cell -> atlas pixels (truncation toward
    # zero, then the clamp to the tile)
    f = F_PAT_FWD
    q0 = torch.remainder(gx - col(F_PAT_XY), col(F_PAT_WH))
    q1 = torch.remainder(gy - col(F_PAT_XY + 1), col(F_PAT_WH + 1))
    s0 = q0 * col(f) + q1 * col(f + 1) + col(f + 2)
    s1 = q0 * col(f + 3) + q1 * col(f + 4) + col(f + 5)
    icol = lambda j: ip[:, j, None, None]                # (C, 1, 1)
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    i0 = torch.minimum(torch.maximum(s0.to(torch.int32) - icol(I_PAT_LO), zero),
                       icol(I_PAT_MAX))
    i1 = torch.minimum(torch.maximum(s1.to(torch.int32) - icol(I_PAT_LO + 1), zero),
                       icol(I_PAT_MAX + 1))
    q, th, tw, _ = patterns.shape
    flat = patterns.reshape(q, th * tw, 4)
    pidx = torch.clamp(ip[:, I_PAT], min=0).long()[:, None, None]
    pat = flat[pidx, (i0 * tw + i1).long()]
    return torch.where((kind == PAINT_PATTERN)[..., None], pat, out)


def _compose_runs(canvas, tile_id, rgba):
    """Premultiplied OVER of z-sorted items into their tiles, in place.

    canvas (num_tiles + 1, T, T, 4) with a scratch last row; tile_id (C,)
    sorted.  Items of equal rank within their tile run touch distinct
    tiles, so each rank composes in one index_put_.
    """
    c = tile_id.shape[0]
    idx = torch.arange(c, device=tile_id.device)
    starts = torch.ones(c, dtype=torch.bool, device=tile_id.device)
    starts[1:] = tile_id[1:] != tile_id[:-1]
    run_start = torch.cummax(torch.where(starts, idx, torch.zeros_like(idx)), 0).values
    rank = idx - run_start
    for r in range(int(rank.max()) + 1):
        sel = torch.nonzero(rank == r).squeeze(1)
        ids = tile_id[sel]
        src = rgba[sel]
        canvas.index_put_((ids,), src + canvas[ids] * (1.0 - src[..., 3:]))


def _scene_tiles(plan: DevicePlan, big_wind, pool=None):
    """Plain version of the scene kernel: the canvas (num_tiles, T, T, 4).

    big_wind is the prepass stack (or None when the plan has no big
    classes); items with big_idx >= 0 take their winding from it.  pool
    (P, T, T, 4) holds the isolation-pass rows that texture and mask items
    read (None when the plan reads none).  The order of operations is the
    JAX package's batch_exec._raster_item: coverage x clip, the 1e-6
    floor, x opacity, x mask luminance, then the paint — a pool row for
    texture items, overridden last by a collapsed-run field.
    """
    t = plan.tile
    num_tiles = plan.num_tiles
    n = plan.tile_id.shape[0]
    dev = plan.lines.device
    canvas = torch.zeros((num_tiles + 1, t, t, 4), dtype=torch.float32, device=dev)
    for c0 in range(0, n, CHUNK_ITEMS):
        sl = slice(c0, c0 + CHUNK_ITEMS)
        tile_id = plan.tile_id[sl].long()
        ip = plan.iparams[sl]
        fp = plan.fparams[sl]
        wind = coverage.winding_fields(plan.lines[sl], t, t)
        big_idx = ip[:, I_BIG]
        if big_wind is not None:
            rows = torch.where(big_idx >= 0, big_idx, big_wind.shape[0] - 1)
            wind = torch.where((big_idx >= 0)[:, None, None], big_wind[rows.long()], wind)
        mask = _coverage(
            wind + plan.carry[sl][:, :, None], (ip[:, I_RULE] != 0)[:, None, None]
        )
        if plan.clips is not None:
            cidx = ip[:, I_CLIP]
            clip = plan.clips[torch.clamp(cidx, min=0).long()]
            mask = mask * torch.where((cidx >= 0)[:, None, None], clip,
                                      torch.ones_like(clip))
        mask = torch.where(mask < 1e-6, torch.zeros_like(mask), mask)
        mask = mask * fp[:, F_OPACITY, None, None]
        if pool is not None:
            midx = ip[:, I_MASK]
            m = pool[torch.clamp(midx, min=0).long()]
            lum = m[..., 0] * MASK_LUM[0] + m[..., 1] * MASK_LUM[1] + m[..., 2] * MASK_LUM[2]
            mask = mask * torch.where((midx >= 0)[:, None, None], lum,
                                      torch.ones_like(lum))
        paint = _paint(fp, ip, plan.stop_offsets[sl], plan.stop_colors[sl], t,
                       plan.patterns)
        if pool is not None:
            tidx = ip[:, I_TEX]
            tex = pool[torch.clamp(tidx, min=0).long()]
            paint = torch.where((tidx >= 0)[:, None, None, None], tex, paint)
        if plan.field is not None:
            fidx = ip[:, I_FIELD]
            field = plan.field[torch.clamp(fidx, min=0).long()]
            paint = torch.where((fidx >= 0)[:, None, None, None], field, paint)
        _compose_runs(canvas, torch.clamp(tile_id, max=num_tiles), mask[..., None] * paint)
    return canvas[:num_tiles]


def execute_items(plan: DevicePlan, pool=None):
    """Whole-plan execution in plain PyTorch: (num_tiles, T, T, 4) f32.

    Twin of the JAX package's batch_exec.execute_items.
    """
    return _scene_tiles(plan, _prepass_winding(plan.bigs, plan.tile), pool)


def _pool_rows(pool, src, src_idx, dst_idx):
    """Plain version of the pool row writer: pool[dst_idx] = src[src_idx],
    in place; returns pool.

    pool (P, T, T, 4), src (R, T, T, 4); src_idx / dst_idx (n,) int32.
    """
    pool[dst_idx.long()] = src[src_idx.long()]
    return pool
