"""Host lowering and execution of the batched render path.

Lowering (numpy, a copy of the JAX package's render_plan.py lowering half)
compiles a whole scene into the batched form the executors run:

  * the canvas is a grid of T x T tiles (T is an explicit argument)
  * every FILL/STROKE draw is flattened on host (one batched flatten per
    subtree) and *binned*: each tile the draw overlaps gets its edges in
    tile-local coordinates; edges entirely LEFT of a tile become an exact
    per-row winding carry vector (_bin_draws) added after rasterization —
    interior tiles of a large shape carry no segments at all
  * clip coverage (the union of per-part rule coverages, matching the
    reference's mask_only OVER composition) is precomputed on host per
    (clip, tile), deduplicated by content, and multiplied in by the
    executors; heavy draw edge lists group into per-width segment
    classes (_pack)
  * items sort by (tile, z) so per-tile composition walks each tile's run
    in z order
  * isolation groups (opacity over a group, masks, filters, nested or
    anti-aliased multi-draw clips) lower to passes whose output tiles land
    in a pass pool; passes merge into one program per dependency level
    (_plan_groups), and their tiles re-enter the parent stream as texture
    or mask items

Execution uploads the plan once (upload_program) and runs it
(run_program): each level's program, its post stage (filter chains,
batched blur chunks, pool row writes), then the main stream.  The ops go
through ops/fused_exec, whose wrappers launch the CUDA kernels on a CUDA
device and the plain PyTorch versions on the CPU.

Pattern paints render their tile once, at lowering time, through the
interpreter (render.pattern_texture) into the plan's pattern atlas; the
executors gather from it.  Scenes the batched path cannot express (per-paint
colorspace overrides, > MAX_STOPS stops) lower to None, and the interpreter
(Scene.render) batches their lowerable group runs through
render_group_hybrid.
"""

from __future__ import annotations

import hashlib
import math
from typing import Any, NamedTuple

import numpy as np
import torch

from .core import color as color_ops
from .core.layer import Layer
from .core.transform import Transform
from .geom.hull import ConvexHull
from .ops import batch_exec as be
from .ops import fused_exec
from .ops.batch_exec import (
    CHUNK_ITEMS,
    DevicePlan,
    MAX_STOPS,
    PAINT_LINEAR,
    PAINT_PATTERN,
    PAINT_RADIAL,
    PAINT_SOLID,
)
from .paint import GradLinear, GradRadial, Pattern, stops_to_arrays
from .scene import (
    RENDER_CLIP,
    RENDER_FILL,
    RENDER_FILTER,
    RENDER_GROUP,
    RENDER_MASK,
    RENDER_OPACITY,
    RENDER_STROKE,
    RENDER_TRANSFORM,
)
from .utils.constants import DEFAULT_TILE, DEVICE_FLOAT, FLATNESS

# interpreter group-run batching switch (tests disable it to get a pure
# per-path oracle)
HYBRID_ENABLED = True

_FILL_RULE_ID = {None: 0, "nonzero": 0, "evenodd": 1}


class _Unsupported(Exception):
    """Scene contains a node the batched path cannot lower."""


def _subtree_hull(scene, transform: Transform) -> ConvexHull:
    """Hull of a subtree's draw geometry (device coords).

    Matches the hull Scene.render returns for the subtree — clips, masks,
    filters, and opacity do not shrink it (parity: svgrasterize.py:649-752)
    — so objectBoundingBox clip/mask transforms can be resolved at lowering
    time without rendering the target first.
    """
    hulls: list = []

    def walk(scene, tr):
        kind, args = scene
        if kind == RENDER_FILL:
            if args[1] is None:
                return  # paintless fill renders (and bounds) nothing
            lines = args[0].flatten(tr, FLATNESS)
            if lines.size:
                hulls.append(ConvexHull(lines))
        elif kind == RENDER_STROKE:
            path, paint, width, linecap, linejoin = args
            if paint is None:
                return
            lines = path.stroke(width, linecap, linejoin).flatten(tr, FLATNESS)
            if lines.size:
                hulls.append(ConvexHull(lines))
        elif kind == RENDER_GROUP:
            for child in args:
                walk(child, tr)
        elif kind == RENDER_TRANSFORM:
            walk(args[0], tr @ args[1])
        elif kind in (RENDER_OPACITY, RENDER_FILTER, RENDER_CLIP, RENDER_MASK):
            walk(args[0], tr)
        else:
            raise _Unsupported(f"scene kind {kind}")

    walk(scene, transform)
    return ConvexHull.merge(hulls)


class _Clip(NamedTuple):
    """A clip active for a subtree: its scene, its transform and the cache
    key derived from both by content (_clip_key)."""

    scene: Any
    transform: Transform
    key: tuple


def _clip_key(clip_scene, transform: Transform) -> tuple:
    """Content key of a clip: a digest of the clip scene's fills (their
    segment arrays and fill rules), groups and transforms in walk order,
    plus the clip transform's matrix bytes.

    Content-equal clip scenes built as separate objects share cache
    entries, and no key outlives or aliases its scene (object ids are
    reused once an object dies).  Node kinds _clip_parts rejects add only
    their kind: it raises on them before anything is cached.
    """
    digest = hashlib.blake2b(digest_size=16)

    def walk(scene):
        kind, args = scene
        digest.update(b"%d;" % kind)
        if kind == RENDER_FILL:
            for arr in args[0].segments_as_curves():
                digest.update(b"%d;" % arr.shape[0])
                digest.update(arr.tobytes())
            digest.update(str(args[2]).encode())
        elif kind == RENDER_GROUP:
            digest.update(b"%d;" % len(args))
            for child in args:
                walk(child)
        elif kind == RENDER_TRANSFORM:
            digest.update(args[1].m.tobytes())
            walk(args[0])

    walk(clip_scene)
    return digest.digest(), transform.m.tobytes()


def _collect_draws(scene, transform: Transform, opacity: float, clip, out: list) -> None:
    """clip: None or the _Clip active for this subtree."""
    kind, args = scene
    if kind == RENDER_FILL:
        path, paint, fill_rule = args
        out.append(("draw", path, transform, paint, fill_rule, opacity, clip))
    elif kind == RENDER_STROKE:
        path, paint, width, linecap, linejoin = args
        outline = path.stroke(width, linecap, linejoin)
        out.append(("draw", outline, transform, paint, None, opacity, clip))
    elif kind == RENDER_GROUP:
        for child in args:
            _collect_draws(child, transform, opacity, clip, out)
    elif kind == RENDER_TRANSFORM:
        target, inner = args
        _collect_draws(target, transform @ inner, opacity, clip, out)
    elif kind == RENDER_OPACITY:
        target, value = args
        # opacity over a single draw folds into its paint; opacity over a
        # group needs isolation -> rendered as a separate pass whose tiles
        # re-enter the parent stream as texture items
        if target[0] in (RENDER_FILL, RENDER_STROKE):
            _collect_draws(target, transform, opacity * value, clip, out)
        else:
            out.append(("pass", target, transform, opacity * value, clip))
    elif kind == RENDER_CLIP:
        target, clip_scene, bbox_units = args
        if clip is not None:
            # nested clip: isolate the inner clip chain as a pass; the outer
            # clip multiplies its texture items (alpha products commute)
            out.append(("pass", scene, transform, opacity, clip))
            return
        clip_tr = transform
        if bbox_units:
            hull = _subtree_hull(target, transform)
            if len(hull.raw_points) == 0:
                return  # target renders nothing (interpreter returns None)
            clip_tr = hull.bbox_transform(transform)
        # group-level clip semantics (reference svgrasterize.py:698-715):
        # the subtree composes in isolation FIRST, then multiplies by the
        # clip coverage once.  A single record is identical either way, and
        # a BINARY clip (exact 0/1 coverage everywhere) distributes over
        # composition, so both keep the cheap per-item multiply; several
        # records under a clip with AA edges diverge wherever they overlap,
        # so those isolate as a pass whose texture items carry the clip.
        clip_of = _Clip(clip_scene, clip_tr, _clip_key(clip_scene, clip_tr))
        sub: list = []
        _collect_draws(target, transform, opacity, clip_of, sub)
        if len(sub) > 1 and not _clip_is_binary(clip_scene, clip_tr):
            out.append(("pass", target, transform, opacity, clip_of))
        else:
            out.extend(sub)
    elif kind == RENDER_MASK:
        target, mask_scene, bbox_units = args
        mask_tr = transform
        if bbox_units:
            hull = _subtree_hull(target, transform)
            if len(hull.raw_points) == 0:
                return
            mask_tr = hull.bbox_transform(transform)
        out.append(("mask", target, mask_scene, transform, mask_tr, opacity, clip))
    elif kind == RENDER_FILTER:
        target, flt = args
        out.append(("filter", target, flt, transform, opacity, clip))
    else:
        raise _Unsupported(f"scene kind {kind}")


def _clip_parts(clip_scene, transform: Transform):
    """Flatten a clip scene to per-fill (edge list, fill rule id) parts.

    Clip coverage follows the reference's mask_only render exactly
    (svgrasterize.py:698-715 + the group OVER merge): each
    fill contributes rule(winding) coverage and the fills compose with
    OVER, i.e. the clip mask is the alpha UNION  1 - prod(1 - cov_p).
    The parts stay separate here; _Builder._clip_tile turns them into a
    precomputed per-tile coverage field, so per-part rules (including
    evenodd in a multi-path clip) and overlapping / opposite-orientation
    parts are exact.
    """
    parts: list = []

    def walk(scene, tr):
        kind, args = scene
        if kind == RENDER_FILL:
            flat = args[0].flatten(tr, FLATNESS)
            if flat.size:
                parts.append((flat.reshape(-1, 4), _FILL_RULE_ID.get(args[2], 0)))
        elif kind == RENDER_GROUP:
            for child in args:
                walk(child, tr)
        elif kind == RENDER_TRANSFORM:
            walk(args[0], tr @ args[1])
        else:
            raise _Unsupported(f"clip scene kind {kind}")

    walk(clip_scene, transform)
    if not parts:
        raise _Unsupported("empty clip")
    return parts


def _clip_is_binary(clip_scene, clip_tr: Transform) -> bool:
    """True when the clip's coverage is exactly 0/1 at every pixel: all
    flattened edges axis-aligned on integer pixel boundaries (viewport
    clips of nested <svg>/<symbol>/<marker> are the common case; the
    union of binary part masks is itself binary).  A binary clip
    multiplied into each draw equals the reference's group-layer
    COMPOSE_IN exactly, so such clips skip the isolation pass
    (material-design: 936 nested-svg viewport clips stay one program)."""
    try:
        parts = _clip_parts(clip_scene, clip_tr)
    except _Unsupported:
        return False  # the normal path re-raises with context
    for edges, _rule in parts:
        if edges.shape[0] == 0:
            continue
        axis_aligned = (edges[:, 0] == edges[:, 2]) | (edges[:, 1] == edges[:, 3])
        if not (axis_aligned.all() and np.all(edges == np.round(edges))):
            return False
    return True


def _host_winding(edges: np.ndarray, tile: int) -> np.ndarray:
    """Numpy (f64) twin of ops/coverage.py's closed-form AA winding.

    Same clamped-trapezoid formulation as the device kernels (see
    ops/coverage.py for the derivation; the reference's scalar algorithm
    is svgrasterize.py:2213-2304), evaluated on host at
    lowering time for scene-static clip coverage fields.  f64 throughout —
    the executors consume the resulting field verbatim, so host/device fp
    agreement is not required, only accuracy.
    """
    return _edge_contrib(edges.astype(np.float64), tile).sum(axis=0)


def _host_winding_batch(edge_arrays: list, tile: int) -> np.ndarray:
    """Per-record winding fields for many edge lists in one batched pass.

    The naive per-record _host_winding loop pays numpy dispatch overhead
    per record (~6 ms each at tile 32); static-run collapse needs fields
    for ~1M tile-local edges on material-design.  Row-compacted: each edge
    only contributes on the tile rows intersecting [y_lo, y_hi), and
    0.1px-flattened demo edges span ~1-2 of a 32-row tile, so expanding to
    (edge, row) pairs and evaluating (pairs, tile) column vectors cuts the
    full (S, tile, tile) formulation's memory traffic ~10x (the entire
    cost of this pass; measured 3.7 s -> 0.35 s on material's collapse).
    Pairs reduce into the output by a sorted (owner, row) key.

    Returns (R, tile, tile) f32: the per-edge temporaries dominate wall
    time, the executors consume f32, and worst-case winding error on dense
    adversarial edge sets is ~4e-4 (measured vs the f64 oracle on random
    near-vertical + integer axis-aligned edges; typical demo tiles ~1e-6)
    — test_collapse's 1e-3 atol sits above that bound.
    """
    counts = np.array([a.shape[0] for a in edge_arrays], np.int64)
    n_rec = len(edge_arrays)
    out = np.zeros((n_rec, tile, tile), np.float32)
    total = int(counts.sum())
    if total == 0:
        return out
    e = np.concatenate(
        [a for a in edge_arrays if a.shape[0]], axis=0
    ).astype(np.float32)
    owner = np.repeat(np.arange(n_rec, dtype=np.int64), counts)
    a0, a1, b0, b1 = e[:, 0], e[:, 1], e[:, 2], e[:, 3]
    sign = np.sign(b0 - a0)
    y_lo = np.minimum(a0, b0)
    y_hi = np.maximum(a0, b0)
    x_at_lo = np.where(a0 <= b0, a1, b1)
    x_at_hi = np.where(a0 <= b0, b1, a1)
    dy_seg = y_hi - y_lo
    slope = (x_at_hi - x_at_lo) / np.where(dy_seg > 0, dy_seg, 1.0)
    r0 = np.clip(np.floor(y_lo), 0.0, float(tile)).astype(np.int64)
    r1 = np.clip(np.ceil(y_hi), 0.0, float(tile)).astype(np.int64)
    n_rows = np.where(sign != 0, np.maximum(r1 - r0, 0), 0)
    cum = np.concatenate([[0], np.cumsum(n_rows)])
    cols = np.arange(tile, dtype=np.float32)[None, :] + 1.0
    out2 = out.reshape(n_rec * tile, tile)
    # chunk by pair budget so the (pairs, tile) temporaries stay ~32 MB
    pair_budget = max(1024, (1 << 23) // tile)
    lo_i = 0
    while lo_i < total:
        hi_i = int(np.searchsorted(cum, cum[lo_i] + pair_budget, "right")) - 1
        hi_i = max(hi_i, lo_i + 1)
        n_pairs = int(cum[hi_i] - cum[lo_i])
        if n_pairs == 0:
            lo_i = hi_i
            continue
        c = n_rows[lo_i:hi_i]
        idx = np.repeat(np.arange(lo_i, hi_i), c)
        offs = np.arange(n_pairs) - np.repeat(cum[lo_i:hi_i] - cum[lo_i], c)
        row = r0[idx] + offs
        rowf = row.astype(np.float32)
        lo_y = np.maximum(y_lo[idx], rowf)
        hi_y = np.minimum(y_hi[idx], rowf + 1.0)
        dy = np.maximum(hi_y - lo_y, 0.0)
        sl = slope[idx]
        xl = x_at_lo[idx] + sl * (lo_y - y_lo[idx])
        xh = x_at_lo[idx] + sl * (hi_y - y_lo[idx])
        # per-column mean of clip(t,0,1) over t in [cols-xmax, cols-xmin]:
        # bounded quadratic part K(t)=clip(t,0,1)^2/2 plus the exact
        # above-1 interval fraction.  The naive antiderivative difference
        # (F(g1)-F(g0))/den cancels catastrophically in f32 when |g|>>1
        # (error ~eps*|g|/|den|); every term here is bounded, so error
        # stays ~1e-7/d.  Near-vertical rows (d < 1e-3, common: rect
        # edges) evaluate on the interval widened to 1e-3 about its
        # center — measured error up to ~4e-4 per winding value on
        # adversarial near-vertical/axis-aligned fuzz (vs f64 oracle),
        # and it deletes the per-column midpoint-fallback select
        xmin = np.minimum(xl, xh)
        d = np.maximum(xl, xh) - xmin
        d_eff = np.maximum(d, 1e-3)
        dinv = 1.0 / d_eff
        hi_g = cols - (xmin - 0.5 * (d_eff - d))[:, None]
        lo_g = hi_g - d_eff[:, None]
        num = _quad_part(hi_g)
        num -= _quad_part(lo_g)
        num += np.clip(hi_g - 1.0, 0.0, d_eff[:, None])
        num *= (sign[idx] * dy * dinv)[:, None]
        mean = num
        key = owner[idx] * tile + row
        order = np.argsort(key, kind="stable")
        key_s = key[order]
        bounds = np.concatenate([[0], 1 + np.nonzero(np.diff(key_s))[0]])
        out2[key_s[bounds]] += np.add.reduceat(mean[order], bounds, axis=0)
        lo_i = hi_i
    return out


def _antideriv(t: np.ndarray) -> np.ndarray:
    """Piecewise 0 / 0.5 t^2 / t - 0.5 antiderivative of the clamped pixel
    overlap, without nested np.where — these temporaries dominate wall
    time in the batched winding passes."""
    u = np.clip(t, 0.0, 1.0)
    u *= u
    u *= 0.5
    u += np.maximum(t - 1.0, 0.0)
    return u


def _quad_part(t: np.ndarray) -> np.ndarray:
    """clip(t,0,1)^2 / 2 — the bounded quadratic piece of _antideriv
    (values in [0, 0.5], so f32 differences don't cancel)."""
    u = np.clip(t, 0.0, 1.0)
    u *= u
    u *= 0.5
    return u


def _edge_contrib(edges: np.ndarray, tile: int) -> np.ndarray:
    """(S, tile, tile) per-edge winding contributions (see _host_winding).

    Computes in the caller's dtype: f64 for clip fields (_host_winding),
    f32 for the collapse batch where temporaries dominate wall time.
    """
    if edges.shape[0] == 0:
        return np.zeros((0, tile, tile), edges.dtype)
    e = edges if edges.dtype in (np.float32, np.float64) else edges.astype(np.float64)
    a0, a1, b0, b1 = e[:, 0], e[:, 1], e[:, 2], e[:, 3]
    rows = np.arange(tile, dtype=e.dtype)[None, :, None]  # (1,T,1)
    cols = np.arange(tile, dtype=e.dtype)[None, None, :]  # (1,1,T)
    sign = np.sign(b0 - a0)[:, None, None]
    y_lo = np.minimum(a0, b0)
    y_hi = np.maximum(a0, b0)
    x_at_lo = np.where(a0 <= b0, a1, b1)
    x_at_hi = np.where(a0 <= b0, b1, a1)
    dy_seg = y_hi - y_lo
    slope = (x_at_hi - x_at_lo) / np.where(dy_seg > 0, dy_seg, 1.0)
    lo = np.maximum(y_lo[:, None, None], rows)
    hi = np.minimum(y_hi[:, None, None], rows + 1.0)
    dy = np.maximum(hi - lo, 0.0)
    x_lo = x_at_lo[:, None, None] + slope[:, None, None] * (lo - y_lo[:, None, None])
    x_hi = x_at_lo[:, None, None] + slope[:, None, None] * (hi - y_lo[:, None, None])
    g0 = (cols + 1.0) - x_lo
    g1 = (cols + 1.0) - x_hi

    # g1 - g0 == slope (lo - hi): constant along columns, so den/safe stay
    # (S, T, 1) instead of full (S, T, T)
    den = slope[:, None, None] * (lo - hi)
    safe = np.abs(den) > 1e-12
    num = _antideriv(g1)
    num -= _antideriv(g0)
    num /= np.where(safe, den, 1.0)
    mid = 0.5 * (g0 + g1)
    np.clip(mid, 0.0, 1.0, out=mid)
    mean = np.where(safe, num, mid)
    mean *= sign * dy
    return mean


def _paint_fields_np(
    params_list, tile_rs, tile_cs, tile: int, pattern_tiles=None,
) -> np.ndarray:
    """Batched numpy twin of the executors' paint evaluation for the
    scene-static paint kinds — same affine, spread, telescoping stop
    interpolation, pixman two-circle radial math, and (with pattern_tiles,
    the builder's host tile list) the pattern modular gather incl. the
    reference's int truncation — evaluated on host at lowering time so
    gradient- and pattern-painted runs can static-collapse.  Returns
    (L, tile, tile, 4) f32 premultiplied RGBA.
    """
    L = len(params_list)
    f32 = np.float32
    # records binned from the same draw share ONE params dict; dedup by
    # identity so the per-key scalar tables build over unique paints and
    # members gather by index
    uniq: list = []
    seen: dict = {}
    uidx = np.empty(L, np.int64)
    for i, p in enumerate(params_list):
        j = seen.get(id(p))
        if j is None:
            j = len(uniq)
            seen[id(p)] = j
            uniq.append(p)
        uidx[i] = j
    tab = lambda k: np.stack([np.asarray(p[k], f32) for p in uniq])
    all_kinds = np.array([int(p["kind"]) for p in uniq])[uidx]
    result = np.empty((L, tile, tile, 4), f32)
    sol = np.nonzero(all_kinds == PAINT_SOLID)[0]
    if len(sol):
        result[sol] = tab("color")[uidx[sol]][:, None, None, :]
    for i in np.nonzero(all_kinds == PAINT_PATTERN)[0]:
        p = params_list[i]
        tex = pattern_tiles[int(p["pat_idx"])]
        m = np.asarray(p["affine"], f32)
        rows = (np.arange(tile, dtype=f32) + 0.5) + f32(tile_rs[i])
        cols = (np.arange(tile, dtype=f32) + 0.5) + f32(tile_cs[i])
        gx = rows[:, None] * m[0, 0] + cols[None, :] * m[0, 1] + m[0, 2]
        gy = rows[:, None] * m[1, 0] + cols[None, :] * m[1, 1] + m[1, 2]
        fwd = np.asarray(p["pat_fwd"], f32)
        q0 = np.remainder(gx - f32(p["pat_xy"][0]), f32(p["pat_wh"][0]))
        q1 = np.remainder(gy - f32(p["pat_xy"][1]), f32(p["pat_wh"][1]))
        s0 = q0 * fwd[0, 0] + q1 * fwd[0, 1] + fwd[0, 2]
        s1 = q0 * fwd[1, 0] + q1 * fwd[1, 1] + fwd[1, 2]
        i0 = np.clip(
            s0.astype(np.int32) - int(p["pat_lo"][0]), 0, int(p["pat_max"][0])
        )
        i1 = np.clip(
            s1.astype(np.int32) - int(p["pat_lo"][1]), 0, int(p["pat_max"][1])
        )
        result[i] = np.asarray(tex, f32).reshape(-1, 4)[
            i0 * tex.shape[1] + i1
        ]
    g_idx = np.nonzero(
        (all_kinds == PAINT_LINEAR) | (all_kinds == PAINT_RADIAL)
    )[0]
    if not len(g_idx):
        return result
    # gradient math only on the gradient subset (solid-heavy plans —
    # material is ~all solids — would pay ~25 wasted passes otherwise)
    gsel = uidx[g_idx]
    tile_rs = np.asarray(tile_rs, f32)[g_idx]
    tile_cs = np.asarray(tile_cs, f32)[g_idx]
    L = len(g_idx)
    get = lambda k: tab(k)[gsel]
    kind = all_kinds[g_idx]
    m = get("affine")                      # (L,2,3)
    rows = (np.arange(tile, dtype=f32) + 0.5)[None, :, None] \
        + np.asarray(tile_rs, f32)[:, None, None]
    cols = (np.arange(tile, dtype=f32) + 0.5)[None, None, :] \
        + np.asarray(tile_cs, f32)[:, None, None]
    gx = rows * m[:, 0, 0, None, None] + cols * m[:, 0, 1, None, None] \
        + m[:, 0, 2, None, None]
    gy = rows * m[:, 1, 0, None, None] + cols * m[:, 1, 1, None, None] \
        + m[:, 1, 2, None, None]

    p0 = get("p0")
    p1 = get("p1")
    vec = p1 - p0
    denom = np.maximum(vec[:, 0] ** 2 + vec[:, 1] ** 2, 1e-30)
    t_lin = (
        (gx - p0[:, 0, None, None]) * vec[:, 0, None, None]
        + (gy - p0[:, 1, None, None]) * vec[:, 1, None, None]
    ) / denom[:, None, None]

    center = get("center")
    fc = get("fcenter")
    radius = get("radius")
    fradius = get("fradius")
    cd = center - fc
    pd0 = gx - fc[:, 0, None, None]
    pd1 = gy - fc[:, 1, None, None]
    rd = radius - fradius
    a = cd[:, 0] ** 2 + cd[:, 1] ** 2 - rd * rd
    b = pd0 * cd[:, 0, None, None] + pd1 * cd[:, 1, None, None] \
        + (fradius * rd)[:, None, None]
    c = pd0 * pd0 + pd1 * pd1 - (fradius * fradius)[:, None, None]
    det = b * b - a[:, None, None] * c
    sq = np.sqrt(np.maximum(det, 0.0))
    a_safe = np.where(np.abs(a) > 1e-30, a, 1e-30)[:, None, None]
    t_rad = np.maximum((b + sq) / a_safe, (b - sq) / a_safe)
    rad_valid = det >= 0
    lim = fradius / np.where(np.abs(rd) > 1e-12, fradius - radius, 1.0)
    rad_valid = np.where(
        (np.abs(rd) > 1e-12)[:, None, None],
        rad_valid & (t_rad > lim[:, None, None]),
        rad_valid,
    )

    t = np.where((kind == PAINT_LINEAR)[:, None, None], t_lin, t_rad)
    mode = np.array([int(p["spread"]) for p in uniq])[gsel][:, None, None]
    t = np.where(
        mode == 0, t,
        np.where(mode == 1, t - np.trunc(t),
                 np.abs(np.remainder(t + 1.0, 2.0) - 1.0)),
    )
    offsets = get("stop_offsets")          # (L,K)
    colors = get("stop_colors")            # (L,K,4)
    k_max = max(
        (int(p["_n_stops"]) for p in uniq
         if int(p["kind"]) in (PAINT_LINEAR, PAINT_RADIAL)),
        default=1,
    )
    grad = np.broadcast_to(
        colors[:, 0][:, None, None, :], (L, tile, tile, 4)
    ).copy()
    for i in range(1, k_max):
        span = offsets[:, i] - offsets[:, i - 1]
        ratio = np.clip(
            (t - offsets[:, i - 1, None, None])
            / np.where(span > 1e-12, span, 1.0)[:, None, None],
            0.0, 1.0,
        )
        ratio = np.where(
            (span > 1e-12)[:, None, None], ratio,
            (t >= offsets[:, i, None, None]).astype(f32),
        )
        grad += ratio[..., None] * (
            colors[:, i] - colors[:, i - 1]
        )[:, None, None, :]
    grad = np.where(
        ((kind == PAINT_RADIAL)[:, None, None] & ~rad_valid)[..., None],
        0.0, grad,
    )
    result[g_idx] = grad.astype(f32)
    return result


def _coverage_np(wind: np.ndarray, rule: int) -> np.ndarray:
    """Host twin of the executors' fill-rule coverage mapping."""
    if rule:
        return np.abs(np.remainder(wind + 1.0, 2.0) - 1.0)
    return np.clip(np.abs(wind), 0.0, 1.0)


def _union_cov_field(parts_tile: list, tile: int) -> np.ndarray:
    """Union clip coverage of tile-local parts [(edges, carry, rule)].

    OVER-composition of the part masks: 1 - prod(1 - rule(wind + carry)).
    Returns a (tile, tile) f64 field.
    """
    inv = np.ones((tile, tile))
    for edges, carry, rule in parts_tile:
        wind = _host_winding(edges, tile) + carry.astype(np.float64)[:, None]
        inv *= 1.0 - _coverage_np(wind, rule)
    return 1.0 - inv


def _paint_params(paint, hull: ConvexHull, transform: Transform, linear_rgb: bool):
    """Resolve a paint to the per-item param dict fields (numpy scalars/arrays)."""
    zeros2 = np.zeros(2, DEVICE_FLOAT)
    base = {
        "_n_stops": 1,  # real stop count (host-only; packing trims the tables)
        "kind": PAINT_SOLID,
        "color": np.zeros(4, DEVICE_FLOAT),
        "affine": np.zeros((2, 3), DEVICE_FLOAT),
        "p0": zeros2,
        "p1": zeros2,
        "center": zeros2,
        "fcenter": zeros2,
        "radius": np.float32(0),
        "fradius": np.float32(0),
        "spread": np.int32(0),
        "stop_offsets": np.ones(MAX_STOPS, DEVICE_FLOAT),
        "stop_colors": np.zeros((MAX_STOPS, 4), DEVICE_FLOAT),
        "pat_idx": np.int32(-1),
        "pat_fwd": np.zeros((2, 3), DEVICE_FLOAT),
        "pat_xy": np.zeros(2, DEVICE_FLOAT),
        "pat_wh": np.ones(2, DEVICE_FLOAT),
        "pat_lo": np.zeros(2, np.int32),
        "pat_max": np.zeros(2, np.int32),
    }

    if isinstance(paint, np.ndarray) and paint.shape == (4,):
        color = paint
        if not linear_rgb:
            color = color_ops.pre_linear_to_pre_srgb(color)
        base["color"] = color.astype(DEVICE_FLOAT)
        return base

    if isinstance(paint, (GradLinear, GradRadial)):
        if paint.linear_rgb is not None and paint.linear_rgb != linear_rgb:
            raise _Unsupported("per-paint colorspace override")
        if paint.bbox_units:
            user_tr = hull.bbox_transform(transform).invert
        else:
            user_tr = transform.invert
        to_grad = user_tr if paint.transform is None else paint.transform.invert @ user_tr
        offsets, colors = stops_to_arrays(paint.stops, linear_rgb)
        k = len(offsets)
        if k > MAX_STOPS:
            raise _Unsupported(f"{k} gradient stops > {MAX_STOPS}")
        base["affine"] = to_grad.m[:2, :].astype(DEVICE_FLOAT)
        base["spread"] = np.int32({"pad": 0, "repeat": 1, "reflect": 2}[paint.spread])
        stop_offsets = np.ones(MAX_STOPS, DEVICE_FLOAT)
        stop_offsets[:k] = offsets
        stop_colors = np.broadcast_to(colors[-1], (MAX_STOPS, 4)).copy()
        stop_colors[:k] = colors
        base["stop_offsets"] = stop_offsets
        base["stop_colors"] = stop_colors.astype(DEVICE_FLOAT)
        base["_n_stops"] = k
        if isinstance(paint, GradLinear):
            base["kind"] = PAINT_LINEAR
            base["p0"] = np.asarray(paint.p0, DEVICE_FLOAT)
            base["p1"] = np.asarray(paint.p1, DEVICE_FLOAT)
        else:
            base["kind"] = PAINT_RADIAL
            base["center"] = np.asarray(paint.center, DEVICE_FLOAT)
            base["radius"] = np.float32(paint.radius)
            fc = paint.center if paint.fcenter is None else paint.fcenter
            base["fcenter"] = np.asarray(fc, DEVICE_FLOAT)
            base["fradius"] = np.float32(paint.fradius or 0.0)
        return base

    raise _Unsupported(f"paint {type(paint).__name__}")


_NO_EDGES = np.zeros((0, 4), dtype=DEVICE_FLOAT)
_UNCLIPPED = object()  # _clip_tile: full coverage, no clip row needed
_CARRY_CONSTS: dict = {}  # tile -> (row indices f64, zero carry, ones carry)


def _carry_consts(tile: int):
    consts = _CARRY_CONSTS.get(tile)
    if consts is None:
        consts = (
            np.arange(tile, dtype=np.float64),
            np.zeros(tile, dtype=DEVICE_FLOAT),
            np.ones(tile, dtype=DEVICE_FLOAT),
        )
        _CARRY_CONSTS[tile] = consts
    return consts


def _band_split_batch(edges: np.ndarray, tile: int, owner: np.ndarray):
    """Split edges at 8-row band boundaries, preserving order and owners.

    The JAX package's TPU kernel evaluates each winding pass on the 8-row
    band its edges live in, which requires every edge to sit inside one
    band.  The port's executors do not need the split, but keep it so the
    plan stays bit-identical to the JAX package's.  Splitting is
    semantically exact: split points land on row boundaries, so each
    row's coverage comes entirely from one piece (the other contributes a
    hard zero), identical to the unsplit edge up to fp rounding of the
    split x.  Components: [:, 0]/[:, 2] are row coords, [:, 1]/[:, 3]
    columns (see csrc/winding.cuh).

    Batched over the whole plan: owner[i] labels each edge's source
    record, pieces stay contiguous per source (split back with
    np.bincount(owner_out)).  Called once per _pack — per-record calls
    spent ~45% of dense-scene lowering in numpy dispatch.
    """
    cur, own = edges, owner
    for c in range(8, tile, 8):
        y0 = cur[:, 0]
        y1 = cur[:, 2]
        cross = (np.minimum(y0, y1) < c) & (np.maximum(y0, y1) > c)
        if not cross.any():
            continue
        reps = 1 + cross.astype(np.int64)
        out = np.repeat(cur, reps, axis=0)
        own = np.repeat(own, reps)
        last = np.cumsum(reps) - 1          # each edge's final output slot
        sp = cur[cross]
        t = (c - sp[:, 0]) / (sp[:, 2] - sp[:, 0])
        xc = sp[:, 1] + t * (sp[:, 3] - sp[:, 1])
        out[last[cross] - 1, 2] = c
        out[last[cross] - 1, 3] = xc
        out[last[cross], 0] = c
        out[last[cross], 1] = xc
        cur = out
    return cur, own


def _band_split(edges: np.ndarray, tile: int) -> np.ndarray:
    """Single-array convenience wrapper over _band_split_batch."""
    if edges.shape[0] == 0:
        return edges
    return _band_split_batch(
        edges, tile, np.zeros(edges.shape[0], np.int64)
    )[0]


def _edge_extents(lines):
    r_lo = np.minimum(lines[:, 0], lines[:, 2])
    r_hi = np.maximum(lines[:, 0], lines[:, 2])
    c_lo = np.minimum(lines[:, 1], lines[:, 3])
    c_hi = np.maximum(lines[:, 1], lines[:, 3])
    return r_lo, r_hi, c_lo, c_hi


def _bin_draws(draw_lines: list, grid_h: int, grid_w: int, tile: int):
    """Bin MANY draws' edges into tiles in one vectorized pass; yields
    (draw_index, ti, tj, edges, carry) grouped per (draw, tile).

    The host hot loop of lowering.  Through round 4 this was a Python
    loop per (draw, tile-row, tile-col) of small numpy ops (~70 us per
    draw of pure call overhead at material scale); now every edge of
    every draw expands to its covered (tile-row) pairs at once, signed
    row-overlap vectors batch as one clipped-interval computation, and
    per-tile edge lists come from one stable argsort of flat slot keys.
    The winding carry (edges fully left of a tile contribute sign(dy) x
    row-overlap to every column right of them) accumulates per draw row
    as a segmented cumsum over a flat slot buffer: each (draw, tile-row)
    owns a slab of (window-cols + 1) slots, pairs scatter-add their
    overlap vector at their first fully-left column, and a global cumsum
    minus the slab-start prefix yields every tile's carry.  Same values
    as the loop formulation up to fp association in the carry sums
    (~1e-13 in f64, below the f32 output resolution).
    """
    sizes = [d.shape[0] for d in draw_lines]
    n_draws = len(draw_lines)
    if n_draws == 0:
        return
    lines = np.concatenate(draw_lines) if n_draws > 1 else draw_lines[0]
    owner = np.repeat(np.arange(n_draws), sizes)
    r_lo, r_hi, c_lo, c_hi = _edge_extents(lines)
    rows_idx = _carry_consts(tile)[0]

    # per-draw tile windows (clipped to the grid)
    seg = np.cumsum([0] + sizes[:-1])
    tr0d = np.maximum(
        np.floor(np.minimum.reduceat(r_lo, seg) / tile).astype(np.int64), 0
    )
    tr1d = np.minimum(
        np.floor((np.maximum.reduceat(r_hi, seg) - 1e-9) / tile).astype(np.int64) + 1,
        grid_h,
    )
    tc0d = np.maximum(
        np.floor(np.minimum.reduceat(c_lo, seg) / tile).astype(np.int64), 0
    )
    tc1d = np.minimum(
        np.floor((np.maximum.reduceat(c_hi, seg) - 1e-9) / tile).astype(np.int64) + 1,
        grid_w,
    )
    n_rows_d = np.maximum(tr1d - tr0d, 0)
    n_cols_d = np.maximum(tc1d - tc0d, 0)
    live_d = (n_rows_d > 0) & (n_cols_d > 0)
    n_rows_d *= live_d
    n_cols_d *= live_d

    # flat slot layout: each (draw, tile-row) owns n_cols+1 slots (the +1
    # absorbs carry buckets past the window); slabs are contiguous
    row_of_draw = np.cumsum(n_rows_d) - n_rows_d        # first row id per draw
    total_rows = int(n_rows_d.sum())
    if total_rows == 0:
        return
    d_of_row = np.repeat(np.arange(n_draws), n_rows_d)
    ti_of_row = (
        np.arange(total_rows) - np.repeat(row_of_draw, n_rows_d)
        + np.repeat(tr0d, n_rows_d)
    )
    slab_len = n_cols_d[d_of_row] + 1
    slab_start = np.cumsum(slab_len) - slab_len          # per row id
    total_slots = int(slab_len.sum())

    # (edge, tile-row) pair expansion over each edge's covered row span
    # intersected with its draw's window (empty intersection -> count 0)
    e_tr0 = np.maximum(np.floor(r_lo / tile).astype(np.int64), tr0d[owner])
    e_tr1 = np.minimum(
        np.floor((r_hi - 1e-9) / tile).astype(np.int64), tr1d[owner] - 1
    )
    counts = np.maximum(e_tr1 - e_tr0 + 1, 0) * live_d[owner]
    total = int(counts.sum())
    if total == 0:
        return
    eidx = np.repeat(np.arange(lines.shape[0]), counts)
    starts = np.cumsum(counts) - counts
    ti_pair = (
        np.arange(total) - np.repeat(starts, counts) + np.repeat(e_tr0, counts)
    )
    d_pair = owner[eidx]
    row_pair = row_of_draw[d_pair] + (ti_pair - tr0d[d_pair])
    a0 = lines[eidx, 0] - ti_pair * tile
    b0 = lines[eidx, 2] - ti_pair * tile
    lo = np.minimum(a0, b0)[:, None]
    hi = np.maximum(a0, b0)[:, None]
    overlap = np.clip(
        np.minimum(hi, rows_idx + 1.0) - np.maximum(lo, rows_idx), 0.0, None
    )
    signed = np.sign(b0 - a0)[:, None] * overlap  # (P, tile)

    # carry: scatter each pair's overlap vector at its first fully-left
    # column, then segmented cumsum along every row slab (global cumsum
    # minus the slab-start prefix; cross-slab magnitudes stay ~tile, so
    # the subtraction error is ~1e-12 f64 — invisible in the f32 output)
    e_tc0 = np.floor(c_lo / tile).astype(np.int64)
    e_tc_last = np.floor((c_hi - 1e-9) / tile).astype(np.int64)
    carry_flat = np.zeros((total_slots, tile))
    bucket = slab_start[row_pair] + np.clip(
        e_tc_last[eidx] + 1 - tc0d[d_pair], 0, n_cols_d[d_pair]
    )
    np.add.at(carry_flat, bucket, signed)
    csum = np.cumsum(carry_flat, axis=0)
    base = np.concatenate(
        [np.zeros((1, tile)), csum[slab_start[1:] - 1]], axis=0
    )
    carry_flat = csum - np.repeat(base, slab_len, axis=0)
    carry_live = np.abs(carry_flat).max(axis=1) > 0.0
    # the +1 overflow slot of each slab never names a real tile
    carry_live[slab_start + n_cols_d[d_of_row]] = False

    # per-tile edge lists: expand each pair over its kept column span;
    # the flat slot id doubles as the (draw, ti, tj) group key
    span0 = np.maximum(e_tc0[eidx], tc0d[d_pair])
    span1 = np.minimum(e_tc_last[eidx], tc1d[d_pair] - 1)
    ccounts = np.maximum(span1 - span0 + 1, 0)
    totc = int(ccounts.sum())
    if totc:
        pidx = np.repeat(np.arange(total), ccounts)
        cstarts = np.cumsum(ccounts) - ccounts
        tj_pair = (
            np.arange(totc) - np.repeat(cstarts, ccounts)
            + np.repeat(span0, ccounts)
        )
        entries = np.empty((totc, 4), dtype=lines.dtype)
        entries[:, 0] = a0[pidx]
        entries[:, 2] = b0[pidx]
        entries[:, 1] = lines[eidx[pidx], 1] - tj_pair * tile
        entries[:, 3] = lines[eidx[pidx], 3] - tj_pair * tile
        key = slab_start[row_pair[pidx]] + (tj_pair - tc0d[d_pair[pidx]])
        order = np.argsort(key, kind="stable")  # edge order kept per tile
        key_s = key[order]
        entries = entries[order]
        bounds = np.concatenate(
            [[0], 1 + np.nonzero(np.diff(key_s))[0], [totc]]
        )
        edge_keys = key_s[bounds[:-1]]
    else:
        bounds = np.array([0])
        edge_keys = np.zeros(0, np.int64)

    # yield tiles with edges and/or carry (all lookups pre-vectorized:
    # this loop runs per emitted tile, thousands of times on demo scenes)
    all_keys = np.union1d(edge_keys, np.nonzero(carry_live)[0])
    row_of_slot = np.searchsorted(slab_start, all_keys, side="right") - 1
    d_arr = d_of_row[row_of_slot]
    ti_arr = ti_of_row[row_of_slot]
    tj_arr = tc0d[d_arr] + (all_keys - slab_start[row_of_slot])
    e_pos = np.searchsorted(edge_keys, all_keys)
    if len(edge_keys):
        has_edge = (e_pos < len(edge_keys)) & (
            edge_keys[np.minimum(e_pos, len(edge_keys) - 1)] == all_keys
        )
    else:
        has_edge = np.zeros(len(all_keys), bool)
    live_arr = carry_live[all_keys]
    carry_f32 = carry_flat[all_keys].astype(DEVICE_FLOAT)
    zero_carry = _carry_consts(tile)[1]
    for idx in range(len(all_keys)):
        i = e_pos[idx]
        edges = entries[bounds[i]:bounds[i + 1]] if has_edge[idx] else _NO_EDGES
        carry = carry_f32[idx] if live_arr[idx] else zero_carry
        yield int(d_arr[idx]), int(ti_arr[idx]), int(tj_arr[idx]), edges, carry


def _filter_margin(flt, transform: Transform) -> tuple[int, int]:
    """Conservative device-pixel growth of a filter chain in (rows, cols)."""
    from .filter import FE_DROP_SHADOW, FE_GAUSSIAN_BLUR, FE_MORPHOLOGY, FE_OFFSET
    from .ops import blur as blur_ops

    mr = mc = 0.0
    for kind, attrs, _inputs in flt.filters:
        if kind == FE_GAUSSIAN_BLUR:
            std_x, std_y = attrs
            kernel = blur_ops.gaussian_kernel(transform, (std_x, std_x if std_y is None else std_y))
            if kernel is not None:
                mr += kernel.shape[0]
                mc += kernel.shape[1]
        elif kind == FE_OFFSET:
            dx, dy = attrs
            moved = transform.apply_vectors(np.array([[dx, dy]]))[0]
            mr += abs(moved[0])
            mc += abs(moved[1])
        elif kind == FE_MORPHOLOGY:
            rx, ry, _method = attrs
            unit = transform.apply_vectors(np.array([[rx, 0.0], [0.0, ry]]))
            mr += 2 * float(np.linalg.norm(unit[0]))
            mc += 2 * float(np.linalg.norm(unit[1]))
        elif kind == FE_DROP_SHADOW:
            dx, dy, std, _color = attrs
            kernel = blur_ops.gaussian_kernel(transform, (std, std))
            if kernel is not None:
                mr += kernel.shape[0]
                mc += kernel.shape[1]
            moved = transform.apply_vectors(np.array([[dx, dy]]))[0]
            mr += abs(moved[0])
            mc += abs(moved[1])
    return int(np.ceil(mr)), int(np.ceil(mc))


def _bucket(count: int, minimum: int = 32) -> int:
    size = minimum
    while size < count:
        size *= 2
    return size


def _round_count(count: int, step: int) -> int:
    """Round a row count up to step * {1..6, 8, 10, .., 16, 20, .., 32, 40 ..}.

    Pow2 rounding wastes up to 50% of the winding work on padding rows; this
    set keeps waste under ~17% while bounding the number of distinct
    array shapes.
    """
    need = -(-count // step)
    if need > 6:
        granule = 2
        while need > 8 * granule:
            granule *= 2
        need = -(-need // granule) * granule
    return need * step


class _Pass:
    """One isolation pass: raw records + where its output lands in the pool."""

    __slots__ = ("records", "src_tiles", "out_tiles", "post", "pool_base", "refs")

    def __init__(self, records, src_tiles, out_tiles, post, pool_base, refs):
        self.records = records
        self.src_tiles = src_tiles
        self.out_tiles = out_tiles
        self.post = post
        self.pool_base = pool_base
        self.refs = refs


class _Builder:
    """Lowers a scene into one or more packed passes over a shared tile grid.

    Isolation groups (opacity over a group, masks, filters, nested or
    anti-aliased multi-draw clips) become separate passes rendered before
    the stream that references them: each output tile of a pass re-enters
    its parent stream as a texture item gathered from the pass pool.
    """

    def __init__(self, viewport, linear_rgb: bool, tile: int = DEFAULT_TILE,
                 device="cuda"):
        v0, v1, h, w = viewport
        self.tile = int(tile)
        self.v0, self.v1 = v0, v1
        self.grid_h = math.ceil(h / self.tile)
        self.grid_w = math.ceil(w / self.tile)
        self.num_tiles = self.grid_h * self.grid_w
        self.shift = np.array([v0, v1, v0, v1], dtype=np.float64)
        self.linear_rgb = linear_rgb
        self.device = device  # where pattern tiles render (_pattern_params)
        self.clip_flat_cache: dict = {}  # clip_key -> [(lines, extents, rule)]
        self.clip_tile_cache: dict = {}  # (clip_key, ti, tj) -> tile result
        self.clip_cov_cache: dict = {}   # parts content key -> tile result
        self.clip_cov_dedup: dict = {}   # coverage f32 bytes -> canonical array
        self.passes: list = []  # [_Pass] in emission order; merged by _plan_groups
        self.pool_size = 0
        self.all_points: list = []
        self.patterns: list = []  # host copies of rendered pattern tiles
        self.pattern_cache: dict = {}
        self._blank_params = _paint_params(
            np.zeros(4, dtype=np.float64), None, Transform(), linear_rgb
        )

    # -- clip helpers -------------------------------------------------------
    def _clip_tile(self, clip, ti: int, tj: int):
        """Tile-local clip coverage for tile (ti, tj).

        Returns _UNCLIPPED (full coverage — the record needs no clip
        reference), None (zero coverage — the tile is invisible, skip the
        record), or a deduplicated (tile, tile) f32 coverage field: the
        alpha UNION of the clip's per-part rule coverages, precomputed on
        host (see _union_cov_field) so the executors just multiply it in.
        """
        if clip is None:
            return _UNCLIPPED
        # keyed by content (_clip_key): an id-based key collides once a
        # dead scene's or transform's id is reused by a later clip
        clip_key = clip.key
        tiles_map = self.clip_flat_cache.get(clip_key)
        if tiles_map is None:
            # bin every part over its whole tile window in one batched
            # pass (round 5: the old per-(part, tile) lazy _row_bin /
            # _col_bin evaluation cost ~0.27 s of material's lower).
            # Tiles outside every part's window read as None (invisible)
            # — the old path computed those as exact-zero or ~1e-16
            # carry residues of closed contours, invisible either way
            parts = []
            for lines, rule in _clip_parts(clip.scene, clip.transform):
                parts.append((lines - self.shift, rule))
            tiles_map = {}
            if parts:
                for p, ti_, tj_, edges, carry in _bin_draws(
                    [p[0] for p in parts], self.grid_h, self.grid_w, self.tile
                ):
                    tiles_map.setdefault((ti_, tj_), []).append(
                        (edges, carry, parts[p][1])
                    )
            self.clip_flat_cache[clip_key] = tiles_map
        tile_key = (clip_key, ti, tj)
        cached = self.clip_tile_cache.get(tile_key, False)
        if cached is not False:
            return cached
        result = self._clip_cov_of(tiles_map.get((ti, tj), []))
        self.clip_tile_cache[tile_key] = result
        return result

    def _clip_cov_of(self, parts_tile: list):
        """Coverage field of live tile-local parts, with fast paths.

        Deduplicated twice: by part content (skip recomputing the union)
        and by the resulting coverage bytes (identical fields from
        different clip scenes share one packed row).
        """
        if not parts_tile:
            return None  # no part reaches this tile
        for edges, carry, rule in parts_tile:
            # carry-only part covering every pixel -> the union is full
            if edges.shape[0] == 0 and np.all(
                _coverage_np(carry.astype(np.float64), rule) >= 1.0
            ):
                return _UNCLIPPED
        key = tuple(
            (e.tobytes(), c.tobytes(), r) for e, c, r in parts_tile
        )
        result = self.clip_cov_cache.get(key, False)
        if result is not False:
            return result
        cov = np.ascontiguousarray(
            _union_cov_field(parts_tile, self.tile).astype(DEVICE_FLOAT)
        )
        if not cov.any():
            result = None
        elif np.all(cov >= 1.0):
            result = _UNCLIPPED
        else:
            b = cov.tobytes()
            result = self.clip_cov_dedup.setdefault(b, cov)
        self.clip_cov_cache[key] = result
        return result

    # -- pattern paints -------------------------------------------------------
    def _pattern_params(self, paint: Pattern, hull: ConvexHull, transform: Transform):
        """Resolve a Pattern paint: render its tile once, return item params.

        The tile renders through the interpreter (render.pattern_texture)
        on self.device, is cached per (paint, transform[, target bbox]) —
        the builder lives only as long as the scene it walks — and is
        appended to the scene's pattern atlas; the item carries the modular
        gather frame (parity: svgrasterize.py:1049-1094).  Returns None when
        the pattern draws nothing (the reference skips the fill, :1053-1056).
        """
        if paint.width <= 0 or paint.height <= 0:
            return None
        key = (id(paint), transform.m.tobytes())
        if paint.bbox_units or paint.scene_bbox_units:
            key = (*key, tuple(np.round(hull.bbox(transform), 6)))
        if key in self.pattern_cache:
            return self.pattern_cache[key]

        from .render import pattern_texture

        setup = pattern_texture(paint, hull, transform, self.linear_rgb, self.device)
        if setup is None:
            self.pattern_cache[key] = None
            return None
        pat, repeat_tr, lo, (tile_h, tile_w), pat_layer = setup
        layer = Layer(pat, (0, 0), pat_layer.pre_alpha, pat_layer.linear_rgb)
        tex = np.asarray(
            layer.convert(pre_alpha=True, linear_rgb=self.linear_rgb).to_numpy(),
            dtype=DEVICE_FLOAT,
        )
        params = dict(self._blank_params)
        params["kind"] = np.int32(PAINT_PATTERN)
        params["affine"] = repeat_tr.invert.m[:2, :].astype(DEVICE_FLOAT)
        params["pat_fwd"] = repeat_tr.m[:2, :].astype(DEVICE_FLOAT)
        params["pat_xy"] = np.array([paint.x, paint.y], DEVICE_FLOAT)
        params["pat_wh"] = np.array([paint.width, paint.height], DEVICE_FLOAT)
        params["pat_lo"] = np.asarray(lo, np.int32)
        params["pat_max"] = np.array([tile_h, tile_w], np.int32)
        params["pat_idx"] = np.int32(len(self.patterns))
        self.patterns.append(tex)
        self.pattern_cache[key] = params
        return params

    # -- pass emission --------------------------------------------------------
    def _finish_pass(self, sub_records: list, out_tiles=None, post=None):
        """Record sorted records as a pass; returns {tile_id: pool_idx}.

        Packing is deferred to _plan_groups so that independent passes merge
        into one program per dependency level.
        """
        sub_records.sort(key=lambda r: (r[0], r[1]))
        src_tiles = sorted({r[0] for r in sub_records})
        if out_tiles is None:
            out_tiles = src_tiles
        base = self.pool_size
        self.pool_size += len(out_tiles)
        refs = sorted(
            {r[10] for r in sub_records if r[10] >= 0}
            | {r[11] for r in sub_records if r[11] >= 0}
        )
        self.passes.append(_Pass(sub_records, src_tiles, list(out_tiles), post, base, refs))
        return {tile: base + rank for rank, tile in enumerate(out_tiles)}

    def _emit_pass(self, scene, transform: Transform):
        """Lower a subtree as an isolation pass; returns {tile_id: pool_idx}."""
        sub_records = self.build(scene, transform)
        if not sub_records:
            return None
        return self._finish_pass(sub_records)

    def _emit_filter_pass(self, target, flt, transform: Transform):
        """Lower filter(target): the pass output is the filtered, grown region."""
        points_start = len(self.all_points)
        sub_records = self.build(target, transform)
        if not sub_records:
            return None
        # bbox-tight source region (the reference filters bbox-tight layers;
        # its blur placement truncation is offset-dependent, so the same
        # origin must reach the convolution)
        pts = np.concatenate(self.all_points[points_start:], axis=0)
        content_bbox = (
            int(np.floor(pts[:, 0].min())) - 1,
            int(np.floor(pts[:, 1].min())) - 1,
            int(np.ceil(pts[:, 0].max())) + 1,
            int(np.ceil(pts[:, 1].max())) + 1,
        )
        src_tiles = sorted({r[0] for r in sub_records})
        mr, mc = _filter_margin(flt, transform)
        rows = [t // self.grid_w for t in src_tiles]
        cols = [t % self.grid_w for t in src_tiles]
        ti0 = max(min(rows) - -(-mr // self.tile), 0)
        ti1 = min(max(rows) + -(-mr // self.tile), self.grid_h - 1)
        tj0 = max(min(cols) - -(-mc // self.tile), 0)
        tj1 = min(max(cols) + -(-mc // self.tile), self.grid_w - 1)
        dst_tiles = [
            ti * self.grid_w + tj
            for ti in range(ti0, ti1 + 1)
            for tj in range(tj0, tj1 + 1)
        ]
        post = (flt, transform, content_bbox)
        return self._finish_pass(sub_records, out_tiles=dst_tiles, post=post)

    def _texture_record(self, tile: int, z: int, opacity, clip, tex_idx: int, mask_idx: int):
        ti, tj = divmod(tile, self.grid_w)
        clip_cov = self._clip_tile(clip, ti, tj)
        if clip_cov is None:
            return None
        return (
            tile, z, _NO_EDGES, _carry_consts(self.tile)[2],
            None if clip_cov is _UNCLIPPED else clip_cov,
            self._blank_params, 0, opacity, ti * self.tile, tj * self.tile,
            tex_idx, mask_idx,
        )

    # -- lowering -----------------------------------------------------------
    def _flatten_draws(self, draws: list) -> dict:
        """Flatten all draw geometry in one batched pass: {draw index: lines}.

        Per-draw flattening spends most of its time in numpy dispatch on
        small curve arrays; concatenating every draw's (transformed) cubics
        into one flatten_cubics call amortizes it (material-design lowering:
        the flatten share drops ~3x).
        """
        from .geom import bezier

        line_parts: dict = {}
        cubic_parts: list = []
        cubic_owner: list = []
        for z, entry in enumerate(draws):
            if entry[0] != "draw" or entry[3] is None:
                continue
            path, tr = entry[1], entry[2]
            lines, cubics = path.segments_as_curves()
            line_parts[z] = tr(lines) if lines.size else lines
            if cubics.size:
                cubic_parts.append(tr(cubics))
                cubic_owner.append(z)
        out: dict = {}
        if cubic_parts:
            counts = np.array([c.shape[0] for c in cubic_parts])
            stacked = np.concatenate(cubic_parts, axis=0)
            flat, per_curve = bezier.flatten_cubics_counts(stacked, FLATNESS)
            # split the flattened stream back into per-draw chunks (the
            # flatten returns segments grouped by source curve)
            per_draw = np.add.reduceat(per_curve, np.concatenate([[0], np.cumsum(counts)[:-1]]))
            splits = np.cumsum(per_draw)[:-1]
            pieces = np.split(flat, splits)
            for z, piece in zip(cubic_owner, pieces):
                lines = line_parts[z]
                out[z] = np.concatenate([lines, piece]) if lines.size else piece
        for z, lines in line_parts.items():
            if z not in out:
                out[z] = lines
        return out

    def build(self, scene, transform: Transform) -> list:
        """Subtree -> record list (z-sorted later); may append nested passes."""
        draws: list = []
        _collect_draws(scene, transform, 1.0, None, draws)
        flattened = self._flatten_draws(draws)

        records: list = []
        plain: list = []  # (z, flat lines, params, rule, opacity, clip)
        for z, entry in enumerate(draws):
            if entry[0] == "pass":
                _tag, target, tr, opacity, clip = entry
                pool_of_tile = self._emit_pass(target, tr)
                if pool_of_tile is None:
                    continue
                for tile, pool_idx in pool_of_tile.items():
                    record = self._texture_record(tile, z, opacity, clip, pool_idx, -1)
                    if record is not None:
                        records.append(record)
                continue

            if entry[0] == "mask":
                _tag, target, mask_scene, tr, mask_tr, opacity, clip = entry
                target_tiles = self._emit_pass(target, tr)
                if target_tiles is None:
                    continue
                mask_tiles = self._emit_pass(mask_scene, mask_tr)
                if mask_tiles is None:
                    continue  # empty mask hides the target entirely
                for tile in sorted(set(target_tiles) & set(mask_tiles)):
                    record = self._texture_record(
                        tile, z, opacity, clip, target_tiles[tile], mask_tiles[tile]
                    )
                    if record is not None:
                        records.append(record)
                continue

            if entry[0] == "filter":
                _tag, target, flt, tr, opacity, clip = entry
                pool_of_tile = self._emit_filter_pass(target, flt, tr)
                if pool_of_tile is None:
                    continue
                for tile, pool_idx in pool_of_tile.items():
                    record = self._texture_record(tile, z, opacity, clip, pool_idx, -1)
                    if record is not None:
                        records.append(record)
                continue

            _tag, path, tr, paint, fill_rule, opacity, clip = entry
            if paint is None:
                continue
            lines = flattened.get(z)
            if lines is None or lines.size == 0:
                continue
            self.all_points.append(lines[:, 0])
            flat = lines.reshape(-1, 4) - self.shift
            if isinstance(paint, Pattern):
                params = self._pattern_params(paint, ConvexHull(lines), tr)
                if params is None:
                    continue  # empty pattern scene draws nothing
            else:
                params = _paint_params(paint, ConvexHull(lines), tr, self.linear_rgb)
            rule = _FILL_RULE_ID.get(fill_rule)
            if rule is None:
                raise _Unsupported(f"fill rule {fill_rule}")
            plain.append((z, flat, params, rule, opacity, clip))

        # all plain draws bin in ONE vectorized pass (records z-sort later;
        # passes above already emitted their pool rows in z order)
        for di, ti, tj, edges, carry in _bin_draws(
            [p[1] for p in plain], self.grid_h, self.grid_w, self.tile
        ):
            z, _flat, params, rule, opacity, clip = plain[di]
            clip_cov = self._clip_tile(clip, ti, tj)
            if clip_cov is None:
                continue  # zero clip coverage: the tile is invisible
            records.append(
                (ti * self.grid_w + tj, z, edges, carry,
                 None if clip_cov is _UNCLIPPED else clip_cov,
                 params, rule, opacity, ti * self.tile, tj * self.tile,
                 -1, -1)
            )
        return records

    # -- packing ------------------------------------------------------------
    @staticmethod
    def _cull_occluded(records: list) -> list:
        """Drop records hidden behind a full-tile opaque solid in their tile.

        A record with no inline edges, full-coverage carry rows, no clip /
        texture / mask, opacity 1 and a solid premultiplied color with
        alpha exactly 1 composes to exactly its own color: alpha==1 makes
        acc*(1-alpha) an exact f32 zero, so every earlier record of the
        same tile in the stream is dead weight.  Interior tiles of large
        opaque shapes (backgrounds, cards) hit this constantly — the item
        stream is the executors' unit of work, so this is a free device-
        time win with bit-identical output.
        """
        last_occ: dict[int, int] = {}
        for i, r in enumerate(records):
            params = r[5]
            if (
                r[2].shape[0] == 0           # no inline edges
                and r[4] is None             # no clip coverage
                and r[10] < 0 and r[11] < 0  # no texture / mask compose
                and r[7] >= 1.0              # group opacity
                and params["kind"] == PAINT_SOLID
                and float(params["color"][3]) >= 1.0
            ):
                cov = _coverage_np(r[3].astype(np.float64), r[6])
                if (cov >= 1.0).all():
                    last_occ[r[0]] = i
        if not last_occ:
            return records
        return [
            r for i, r in enumerate(records) if i >= last_occ.get(r[0], -1)
        ]

    def _collapse_runs(self, records: list):
        """Collapse z-consecutive scene-static solid items per tile into one
        precomposed full-coverage "field" item.

        Every item costs the executors a full tile of winding, paint and
        compose work, so fewer, fatter items are cheaper.  A run of
        consecutive same-tile records whose paint is a solid or a gradient
        with no pool reads is scene-static end to end: each member's coverage
        (winding + carry, fill rule, precomputed clip, opacity) and its
        premultiplied color are known at lowering time, so the run's
        OVER-composite is a fixed premultiplied RGBA field P whose alpha
        plane is A = 1 - prod(1 - a_i cov_i).  Emitting P as ONE
        full-coverage item (ones carry, no edges, rule 0) reproduces the
        run exactly in both executors: acc' = P + acc (1 - A).  The
        executors read P from the field stack by the item's field_idx.

        Returns (records, field_stack | None) where field_stack is
        (F, T, T, 4) f32 premultiplied RGBA, referenced by the replacement
        records' params["_field_row"].
        """
        if len(records) < 2:
            return records, None

        # gradient and pattern paints are scene-static per pixel too (the
        # atlas tiles render at lowering time), so their runs collapse as
        # well — the host evaluates the same affine/spread/stop math and
        # pattern gather as the device (_paint_fields_np).  Pool-reading
        # items (tex/mask) stay out: the pool is not scene-static.
        kinds_ok = (PAINT_SOLID, PAINT_LINEAR, PAINT_RADIAL, PAINT_PATTERN)

        def eligible(r):
            p = r[5]
            # "_field_row" excludes already-emitted field records (their
            # winding comes from an empty edge array and a zero dummy
            # color, so a second collapse pass would dissolve them into
            # transparent zeros) — makes the collapse idempotent.
            return (
                p["kind"] in kinds_ok
                and (p["kind"] == PAINT_PATTERN or int(p["pat_idx"]) < 0)
                and "_field_row" not in p
                and r[10] < 0 and r[11] < 0
            )

        runs: list = []  # (start, end) half-open index ranges
        i, n = 0, len(records)
        while i < n:
            if not eligible(records[i]):
                i += 1
                continue
            j = i
            while (j + 1 < n and records[j + 1][0] == records[i][0]
                   and eligible(records[j + 1])):
                j += 1
            if j > i:
                runs.append((i, j + 1))
            i = j + 1
        if not runs:
            return records, None

        members = [k for i0, i1 in runs for k in range(i0, i1)]
        winds = _host_winding_batch(
            [records[k][2] for k in members], self.tile
        )
        T = self.tile
        # batched member coverages, mirroring batch_exec._raster_item's
        # mask semantics exactly: winding carry, fill rule, precomputed
        # clip, the 1e-6 floor, then opacity (f32 — the executors consume
        # f32 fields; test_collapse's 1e-3 atol covers the accumulation)
        winds += np.stack(
            [records[k][3] for k in members]
        ).astype(np.float32)[:, :, None]
        rules = np.array(
            [records[k][6] for k in members], bool
        )[:, None, None]
        cov = np.where(
            rules,
            np.abs(np.remainder(winds + 1.0, 2.0) - 1.0),
            np.clip(np.abs(winds), 0.0, 1.0),
        )
        for m, k in enumerate(members):
            if records[k][4] is not None:
                cov[m] *= records[k][4]
        cov = np.where(cov < 1e-6, 0.0, cov)
        cov *= np.array(
            [records[k][7] for k in members], np.float32
        )[:, None, None]
        # per-member (T,T,4) paint fields, evaluated in chunks (the whole
        # array is M x 16 KB at tile 32; chunking bounds the gradient-math
        # temporaries).  v0/v1: gradient affines expect canvas coords, the
        # same origin _pack writes into items["tile_r"/"tile_c"]
        paints = np.empty((len(members), T, T, 4), np.float32)
        for lo in range(0, len(members), 1024):
            part = members[lo : lo + 1024]
            paints[lo : lo + len(part)] = _paint_fields_np(
                [records[k][5] for k in part],
                [records[k][8] + self.v0 for k in part],
                [records[k][9] + self.v1 for k in part],
                T, pattern_tiles=self.patterns,
            )
        # run OVER-composites via suffix products,
        # P = sum_k paint_k cov_k prod_{j>k}(1 - a_j(x,y) cov_j),
        # vectorized per run-LENGTH bucket (a per-run loop paid ~10 small
        # numpy dispatches x ~1000 runs ~ 0.4 s of the material lower)
        from collections import defaultdict

        lens = [i1 - i0 for i0, i1 in runs]
        starts = np.concatenate([[0], np.cumsum(lens)])[:-1]
        by_len: dict = defaultdict(list)
        for ri, ln in enumerate(lens):
            by_len[ln].append(ri)
        P_all = np.empty((len(runs), T, T, 4), np.float32)
        for ln, idxs in by_len.items():
            mi = (starts[idxs][:, None] + np.arange(ln)).ravel()
            c = cov[mi].reshape(len(idxs), ln, T, T)
            pa = paints[mi].reshape(len(idxs), ln, T, T, 4)
            q = 1.0 - pa[..., 3] * c
            sp = np.cumprod(q[:, ::-1], axis=1)[:, ::-1]
            sp[:, :-1] = sp[:, 1:]
            sp[:, -1] = 1.0
            P_all[idxs] = ((c * sp)[..., None] * pa).sum(axis=1)

        empty = np.zeros((0, 4), DEVICE_FLOAT)
        ones = np.ones(T, DEVICE_FLOAT)
        fields: list = []
        out: list = []
        pos = 0
        for ri, (i0, i1) in enumerate(runs):
            out.extend(records[pos:i0])
            pos = i1
            P = P_all[ri]
            first = records[i0]
            params = _paint_params(
                np.zeros(4, DEVICE_FLOAT), None, None, True
            )
            params["_field_row"] = len(fields)
            fields.append(P)
            out.append((
                first[0], first[1], empty, ones, None, params,
                0, 1.0, first[8], first[9], -1, -1,
            ))
        out.extend(records[pos:])
        return out, np.stack(fields).astype(DEVICE_FLOAT)

    def _pack(self, records: list, pad_tile: int | None = None):
        """Sorted records -> (items dict, big-class tuple, clip array).

        pad_tile: tile id written into padding items (past every real
        tile) — the canvas tile count for the main stream, the virtual row
        count for merged pass groups.

        Items over SMALL_SEGS edges go to per-width class arrays (the big
        pre-pass); each class pads to its own power-of-two width, so one
        1000-segment path does not inflate every heavy item to its width.
        Clip coverage fields (host-precomputed, _clip_tile) are deduplicated
        by identity, packed as (U, T, T) rows, and referenced by index.
        """
        from .ops.batch_exec import CHUNK_BIG, SMALL_SEGS

        records = self._cull_occluded(records)
        records, field_stack = self._collapse_runs(records)
        if pad_tile is None:
            pad_tile = self.num_tiles
        n = len(records)
        # small passes pad to a small power of two; large ones to an
        # economically-rounded count of full chunks
        if n <= CHUNK_ITEMS:
            n_pad = _bucket(n, minimum=16)
        else:
            n_pad = _round_count(n, CHUNK_ITEMS)

        # band-split every edge list as the JAX package does (see
        # _band_split_batch); one batched call
        # over the whole plan, dedup'd by array identity (clip coverage is
        # a precomputed field now — only draw edges need banding)
        band_cache: dict[int, np.ndarray] = {}
        uniques: list[np.ndarray] = []
        for r in records:
            arr = r[2]
            if arr.shape[0] and id(arr) not in band_cache:
                band_cache[id(arr)] = arr  # placeholder, filled below
                uniques.append(arr)
        if uniques:
            counts = np.array([a.shape[0] for a in uniques])
            owner = np.repeat(np.arange(len(uniques)), counts)
            split, own_out = _band_split_batch(
                np.concatenate(uniques, axis=0), self.tile, owner
            )
            bounds = np.cumsum(np.bincount(own_out, minlength=len(uniques)))
            pieces = np.split(split, bounds[:-1])
            for arr, piece in zip(uniques, pieces):
                band_cache[id(arr)] = piece

        def banded(arr: np.ndarray) -> np.ndarray:
            out = band_cache.get(id(arr))
            return out if out is not None else arr

        # segment-class scheduling: the inline budget adapts to the scene's
        # MEDIAN edge count (winding cost is linear in the padded width, so
        # a handful of complex tiles must not tax the typical item); heavier
        # edge lists group into per-width class arrays for the pre-pass
        seg_counts = np.array([banded(r[2]).shape[0] for r in records])
        median = int(np.median(seg_counts[seg_counts > 0])) if (seg_counts > 0).any() else 0
        s_bucket = min(_bucket(max(median, 1), 8), SMALL_SEGS)
        widths = sorted(
            {_bucket(banded(r[2]).shape[0], 2 * s_bucket) for r in records
             if banded(r[2]).shape[0] > s_bucket}
        )
        class_of_width = {w: c for c, w in enumerate(widths)}
        class_rows: list[list] = [[] for _ in widths]

        # clip coverage rows, deduplicated by array identity: _clip_tile
        # already dedups by content (material-design: 935 clip scenes share
        # ~100 unique tile-local fields), so identical tiles arrive as one
        # ndarray object
        clip_index: dict[int, int] = {}
        clip_arrays: list[np.ndarray] = []
        for r in records:
            cov = r[4]
            if cov is None:
                continue
            if id(cov) not in clip_index:
                clip_index[id(cov)] = len(clip_arrays)
                clip_arrays.append(cov)
        if clip_arrays:
            u = len(clip_arrays)
            u_pad = _bucket(u, 8) if u <= CHUNK_BIG else _round_count(u, CHUNK_BIG)
            clips = np.zeros((u_pad, self.tile, self.tile), DEVICE_FLOAT)
            for i, a in enumerate(clip_arrays):
                clips[i] = a
        else:
            clips = np.zeros((0, self.tile, self.tile), DEVICE_FLOAT)

        # stop tables shrink to the scene's real maximum (paint evaluation
        # cost is linear in the table width)
        k_bucket = _bucket(max(r[5]["_n_stops"] for r in records), minimum=4)
        k_bucket = min(k_bucket, MAX_STOPS)

        items = {
            "lines": np.zeros((n_pad, s_bucket, 4), DEVICE_FLOAT),
            "carry": np.zeros((n_pad, self.tile), DEVICE_FLOAT),
            "big_idx": np.full(n_pad, -1, np.int32),
            "tex_idx": np.full(n_pad, -1, np.int32),
            "mask_idx": np.full(n_pad, -1, np.int32),
            "clip_idx": np.full(n_pad, -1, np.int32),
            "tile_id": np.full(n_pad, pad_tile, np.int32),
            "fill_rule": np.zeros(n_pad, np.int32),
            "opacity": np.zeros(n_pad, DEVICE_FLOAT),
            "tile_r": np.zeros(n_pad, DEVICE_FLOAT),
            "tile_c": np.zeros(n_pad, DEVICE_FLOAT),
            "kind": np.zeros(n_pad, np.int32),
            "color": np.zeros((n_pad, 4), DEVICE_FLOAT),
            "affine": np.zeros((n_pad, 2, 3), DEVICE_FLOAT),
            "p0": np.zeros((n_pad, 2), DEVICE_FLOAT),
            "p1": np.zeros((n_pad, 2), DEVICE_FLOAT),
            "center": np.zeros((n_pad, 2), DEVICE_FLOAT),
            "fcenter": np.zeros((n_pad, 2), DEVICE_FLOAT),
            "radius": np.zeros(n_pad, DEVICE_FLOAT),
            "fradius": np.zeros(n_pad, DEVICE_FLOAT),
            "spread": np.zeros(n_pad, np.int32),
            "n_stops": np.zeros(n_pad, np.int32),
            "stop_offsets": np.ones((n_pad, k_bucket), DEVICE_FLOAT),
            "stop_colors": np.zeros((n_pad, k_bucket, 4), DEVICE_FLOAT),
            "pat_idx": np.full(n_pad, -1, np.int32),
            "pat_fwd": np.zeros((n_pad, 2, 3), DEVICE_FLOAT),
            "pat_xy": np.zeros((n_pad, 2), DEVICE_FLOAT),
            "pat_wh": np.ones((n_pad, 2), DEVICE_FLOAT),
            "pat_lo": np.zeros((n_pad, 2), np.int32),
            "pat_max": np.zeros((n_pad, 2), np.int32),
        }
        if field_stack is not None:
            # collapsed-run paint fields (_collapse_runs): the (F, T, T, 4)
            # stack is plan-global (NOT per-item — every consumer that
            # slices/permutes/shards the per-item arrays must pass it
            # through whole), referenced by field_idx
            f_pad = _bucket(field_stack.shape[0], 8)
            stack = np.zeros((f_pad, self.tile, self.tile, 4), DEVICE_FLOAT)
            stack[: field_stack.shape[0]] = field_stack
            items["field"] = stack
            items["field_idx"] = np.full(n_pad, -1, np.int32)
        for i, (tile_id, _z, edges, carry, clip_cov, params,
                rule, opacity, tr_origin, tc_origin, tex_idx, mask_idx) in enumerate(records):
            edges = banded(edges)
            if edges.shape[0] > s_bucket:
                cls = class_of_width[_bucket(edges.shape[0], 2 * s_bucket)]
                class_rows[cls].append((i, edges))
            else:
                items["lines"][i, : edges.shape[0]] = edges
            items["carry"][i] = carry
            items["tex_idx"][i] = tex_idx
            items["mask_idx"][i] = mask_idx
            if clip_cov is not None:
                items["clip_idx"][i] = clip_index[id(clip_cov)]
            items["tile_id"][i] = tile_id
            items["fill_rule"][i] = rule
            items["opacity"][i] = opacity
            # gradient affines expect canvas coordinates: add viewport origin
            items["tile_r"][i] = tr_origin + self.v0
            items["tile_c"][i] = tc_origin + self.v1
            for key in (
                "kind", "color", "affine", "p0", "p1", "center", "fcenter",
                "radius", "fradius", "spread",
                "pat_idx", "pat_fwd", "pat_xy", "pat_wh", "pat_lo", "pat_max",
            ):
                items[key][i] = params[key]
            items["n_stops"][i] = min(params["_n_stops"], k_bucket)
            items["stop_offsets"][i] = params["stop_offsets"][:k_bucket]
            items["stop_colors"][i] = params["stop_colors"][:k_bucket]
            if field_stack is not None:
                items["field_idx"][i] = params.get("_field_row", -1)

        # pack big classes; big_idx is a row into the concatenated stack
        bigs: list[np.ndarray] = []
        offset = 0
        for width, rows in zip(widths, class_rows):
            m = len(rows)
            m_pad = _bucket(m, 8) if m <= CHUNK_BIG else _round_count(m, CHUNK_BIG)
            arr = np.zeros((m_pad, width, 4), DEVICE_FLOAT)
            for row, (i, edges) in enumerate(rows):
                arr[row, : edges.shape[0]] = edges
                items["big_idx"][i] = offset + row
            bigs.append(arr)
            offset += m_pad
        return items, tuple(bigs), clips


def _plan_groups(builder: "_Builder") -> list:
    """Merge independent isolation passes into per-level programs.

    A pass depends only on pool rows written by passes emitted before it, so
    leveling by referenced owners gives a correct topological batching: every
    level is one packed program over a *virtual row space* (the concatenation
    of its passes' output/source tiles), followed by the level's post stage
    (pool rows of plain passes, filter post-ops of filter passes).

    Pool rows are renumbered into the post stage's emission order — level
    by level, per-part outputs first, then each batched-blur chunk's
    (ops/filter_batch) — so each level's outputs form one contiguous block
    ("pool_lo" + "pool_n" on the group), as in the JAX package.
    Returns (groups, lut) where lut maps emission-order pool rows to the
    new order; the caller remaps the main stream's tex/mask references.
    """
    from .ops import filter_batch

    passes = builder.passes
    if not passes:
        return [], None
    owner = np.zeros(builder.pool_size, np.int32)
    for i, p in enumerate(passes):
        owner[p.pool_base : p.pool_base + len(p.out_tiles)] = i
    level = [0] * len(passes)
    for i, p in enumerate(passes):
        if p.refs:
            level[i] = 1 + max(level[int(owner[r])] for r in p.refs)

    lut = np.zeros(max(builder.pool_size, 1), np.int32)
    new_row = 0
    groups = []
    for lev in range(max(level) + 1):
        members = [p for i, p in enumerate(passes) if level[i] == lev]
        pool_lo = new_row
        row = 0
        merged: list = []
        parts: list = []
        for p in members:
            # filter passes render their source tiles; the post-op produces
            # the (grown) out_tiles. Plain passes output what they render.
            row_tiles = p.src_tiles if p.post is not None else p.out_tiles
            rank = {t: k for k, t in enumerate(row_tiles)}
            for r in p.records:
                merged.append((row + rank[r[0]],) + r[1:])
            parts.append(
                {
                    "row_start": row,
                    "n_rows": len(row_tiles),
                    "src_tiles": p.src_tiles,
                    "out_tiles": p.out_tiles,
                    "post": p.post,
                    "pool_base": None,  # assigned below, in emission order
                }
            )
            row += len(row_tiles)

        chunk_groups, batched = filter_batch.plan_level(
            parts, builder.grid_w, (builder.v0, builder.v1), builder.tile
        )

        def assign(pi):
            nonlocal new_row
            n = len(members[pi].out_tiles)
            parts[pi]["pool_base"] = new_row
            base = members[pi].pool_base
            lut[base : base + n] = np.arange(new_row, new_row + n)
            new_row += n

        for pi in range(len(parts)):
            if pi not in batched:
                assign(pi)
        for grp, _lin in chunk_groups:
            for pi, spec in grp:
                assign(pi)
                spec["pool_base"] = parts[pi]["pool_base"]
        chunks = filter_batch.build_chunks(chunk_groups, builder.grid_w, builder.tile)

        merged.sort(key=lambda r: (r[0], r[1]))
        items, bigs, clips = builder._pack(merged, pad_tile=row)
        for key in ("tex_idx", "mask_idx"):
            arr = items[key]
            items[key] = np.where(arr >= 0, lut[np.maximum(arr, 0)], arr)
        groups.append(
            {
                "items": items,
                "bigs": bigs,
                "clips": clips,
                "rows": row,
                "parts": parts,
                "pool_lo": pool_lo,
                "pool_n": new_row - pool_lo,
                "_blur_batch": (chunks, batched),
                "needs_pool": any(p.refs for p in members),
            }
        )
    return groups, lut


class Lowered(NamedTuple):
    """A fully lowered scene: packed host arrays + the pass schedule."""

    items: dict  # main-stream per-item arrays (leading dim N)
    bigs: tuple  # heavy edge lists, one (M_c, S_c, 4) array per width class
    clips: Any  # deduplicated (U, T, T) precomputed clip coverage fields
    grid: tuple  # (grid_h, grid_w) canvas tiles
    hull: Any  # ConvexHull of all draw geometry
    groups: list  # merged isolation-pass programs (see _plan_groups)
    patterns: Any  # (Q, TH, TW, 4) pattern-tile atlas or None
    tile: int  # canvas tile size this plan was lowered for


def lower_scene(scene, transform: Transform, viewport, linear_rgb: bool,
                tile: int = DEFAULT_TILE, *, device="cuda"):
    """Lower a scene to packed host arrays; None if unsupported.

    viewport: (origin0, origin1, extent0, extent1) in device pixels.
    Returns a Lowered plan: the main item stream, its segment-class and
    clip arrays, the merged isolation-pass groups whose pooled output tiles
    the main items reference by tex_idx/mask_idx, and the pattern atlas.
    Pattern tiles render through the interpreter on `device`, the one step
    of lowering that touches a device (a scene without patterns never
    does).  Scenes the batched path cannot express (per-paint colorspace
    overrides, > MAX_STOPS stops) return None, as in the JAX package, whose
    callers then use the interpreter.
    """
    builder = _Builder(viewport, linear_rgb, tile, device)
    try:
        records = builder.build(scene, transform)
    except _Unsupported:
        return None
    if not records:
        return None
    records.sort(key=lambda r: (r[0], r[1]))
    items, bigs, clips = builder._pack(records)
    if builder.all_points:
        hull = ConvexHull(np.concatenate(builder.all_points, axis=0))
    else:
        hull = ConvexHull(np.zeros((0, 2)))
    groups, pool_lut = _plan_groups(builder)
    if pool_lut is not None:
        for key in ("tex_idx", "mask_idx"):
            arr = items[key]
            items[key] = np.where(arr >= 0, pool_lut[np.maximum(arr, 0)], arr)
    if builder.patterns:
        p_h = _bucket(max(t.shape[0] for t in builder.patterns), minimum=8)
        p_w = _bucket(max(t.shape[1] for t in builder.patterns), minimum=8)
        patterns = np.zeros((len(builder.patterns), p_h, p_w, 4), DEVICE_FLOAT)
        for i, t in enumerate(builder.patterns):
            patterns[i, : t.shape[0], : t.shape[1]] = t
    else:
        patterns = None
    return Lowered(
        items, bigs, clips, (builder.grid_h, builder.grid_w), hull, groups, patterns,
        builder.tile,
    )


# ----------------------------------------------------------------------------
# execution
# ----------------------------------------------------------------------------
def _upload_items(items, bigs, clips, tile: int, grid, device, patterns=None) -> DevicePlan:
    """Upload one packed item stream (the main stream or a pass group's) to
    `device`; per-item scalar parameters pack into the iparams / fparams
    columns the executors read.  patterns: the plan's pattern atlas (an
    uploaded tensor, shared by every stream of the plan), or None."""
    kind = np.asarray(items["kind"])
    if patterns is None and (kind == PAINT_PATTERN).any():
        raise ValueError("the item stream paints patterns, the plan has no atlas")
    n = kind.shape[0]
    ip = np.zeros((n, be.N_IPARAMS), np.int32)
    ip[:, be.I_KIND] = kind
    ip[:, be.I_RULE] = items["fill_rule"]
    ip[:, be.I_SPREAD] = items["spread"]
    ip[:, be.I_BIG] = items["big_idx"]
    ip[:, be.I_CLIP] = items["clip_idx"]
    ip[:, be.I_FIELD] = items["field_idx"] if "field_idx" in items else -1
    ip[:, be.I_TEX] = items["tex_idx"]
    ip[:, be.I_MASK] = items["mask_idx"]
    ip[:, be.I_PAT] = items["pat_idx"]
    ip[:, be.I_PAT_LO:be.I_PAT_LO + 2] = items["pat_lo"]
    ip[:, be.I_PAT_MAX:be.I_PAT_MAX + 2] = items["pat_max"]
    fp = np.zeros((n, be.N_FPARAMS), np.float32)
    fp[:, be.F_OPACITY] = items["opacity"]
    fp[:, be.F_TILE_R] = items["tile_r"]
    fp[:, be.F_TILE_C] = items["tile_c"]
    fp[:, be.F_COLOR:be.F_COLOR + 4] = items["color"]
    fp[:, be.F_AFFINE:be.F_AFFINE + 6] = np.asarray(items["affine"]).reshape(n, 6)
    for col, key in ((be.F_P0, "p0"), (be.F_P1, "p1"), (be.F_CENTER, "center"),
                     (be.F_FCENTER, "fcenter")):
        fp[:, col:col + 2] = items[key]
    fp[:, be.F_RADIUS] = items["radius"]
    fp[:, be.F_FRADIUS] = items["fradius"]
    fp[:, be.F_PAT_FWD:be.F_PAT_FWD + 6] = np.asarray(items["pat_fwd"]).reshape(n, 6)
    fp[:, be.F_PAT_XY:be.F_PAT_XY + 2] = items["pat_xy"]
    fp[:, be.F_PAT_WH:be.F_PAT_WH + 2] = items["pat_wh"]

    dev = torch.device(device)

    def up(a, dtype=np.float32):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=dtype)).to(dev)

    field = items.get("field")
    return DevicePlan(
        tile=int(tile),
        grid=tuple(int(g) for g in grid),
        lines=up(items["lines"]),
        carry=up(items["carry"]),
        tile_id=up(items["tile_id"], np.int32),
        iparams=up(ip, np.int32),
        fparams=up(fp),
        stop_offsets=up(items["stop_offsets"]),
        stop_colors=up(items["stop_colors"]),
        bigs=tuple(up(b) for b in bigs),
        clips=up(clips) if clips is not None and clips.shape[0] else None,
        field=up(field) if field is not None else None,
        reads_pool=bool((ip[:, be.I_TEX] >= 0).any() or (ip[:, be.I_MASK] >= 0).any()),
        patterns=patterns if (kind == PAINT_PATTERN).any() else None,
        runs=up(be.tile_runs(items["tile_id"], int(np.prod(grid))), np.int32),
    )


def _upload_atlas(lowered, device):
    if lowered.patterns is None:
        return None
    return torch.from_numpy(np.ascontiguousarray(lowered.patterns, np.float32)).to(
        torch.device(device))


def plan_from_lowered(lowered, device, patterns=None) -> DevicePlan:
    """Upload a Lowered plan's main item stream to `device` as a DevicePlan.

    Takes a Lowered NamedTuple of numpy arrays from either package (keys
    starting with "_", such as the JAX package's "_device_cache", are
    ignored), so the JAX lowering can feed the port's executors.  Its
    isolation-pass groups upload with upload_program.  patterns: the
    plan's atlas already on `device` (uploaded here when None).
    """
    if patterns is None:
        patterns = _upload_atlas(lowered, device)
    return _upload_items(lowered.items, lowered.bigs, lowered.clips,
                         lowered.tile, lowered.grid, device, patterns)


class _PartFilter(NamedTuple):
    """A filter part whose chain runs per frame (not a batched blur), with
    what a frame of it reads made once at upload: its chain's device
    constants and the index tensors of its spans, so a frame uploads
    nothing (a CUDA graph can capture it)."""

    flt: Any  # its filter.Filter
    transform: Transform
    content_bbox: tuple  # the source's bbox, device pixels
    rows: tuple  # (first, count) of its rows in the level's canvas
    span: tuple  # (si0, sj0, nsi, nsj): its source tiles' span, in tiles
    local: torch.Tensor  # (count,) int64: each source row's tile in the span
    out: tuple  # (di0, dj0, nti, ntj): its out tiles' span, in tiles
    consts: Any  # flt.prepare(transform, device)
    src_idx: torch.Tensor  # (n_out,) int32: each out tile's row in the out span
    dst_idx: torch.Tensor  # (n_out,) int32: its pool row


def _tile_span(tiles, grid_w: int):
    """(i0, j0, ni, nj) of the row-major tile span holding `tiles`, and
    each tile's row in it."""
    rows = [int(t) // grid_w for t in tiles]
    cols = [int(t) % grid_w for t in tiles]
    i0, j0 = min(rows), min(cols)
    nj = max(cols) - j0 + 1
    return (i0, j0, max(rows) - i0 + 1, nj), [(r - i0) * nj + (c - j0)
                                              for r, c in zip(rows, cols)]


def _upload_part_filter(part, grid_w: int, dst: range, device) -> _PartFilter:
    flt, transform, content_bbox = part["post"]
    span, local = _tile_span(part["src_tiles"], grid_w)
    out, out_local = _tile_span(part["out_tiles"], grid_w)

    def rows(values, dtype):
        return torch.as_tensor(np.asarray(values, dtype), device=device)

    return _PartFilter(
        flt=flt, transform=transform, content_bbox=tuple(content_bbox),
        rows=(int(part["row_start"]), int(part["n_rows"])), span=span,
        local=rows(local, np.int64), out=out, consts=flt.prepare(transform, device),
        src_idx=rows(out_local, np.int32), dst_idx=rows(list(dst), np.int32),
    )


class _Level(NamedTuple):
    """One dependency level of isolation passes, on the device."""

    plan: Any  # its merged pass program, grid (1, rows): a DevicePlan, or a
    # parallel.scene.ShardedPlan when the program is sharded over a mesh
    needs_pool: bool  # its items read rows of earlier levels
    copy_rows: tuple | None  # (canvas rows, pool rows) of its plain passes
    filters: list  # its filter parts that are not batched: _PartFilter each
    blur: Any  # its batched blur chunks (filter_batch.pack_level), or None


class DeviceProgram(NamedTuple):
    """A Lowered plan on the device: the pass levels in order, the main
    stream, and the pool size their rows need."""

    levels: list
    main: Any  # a DevicePlan, or a parallel.scene.ShardedPlan over a mesh
    pool_rows: int
    tile: int
    grid: tuple
    device: torch.device  # where the pool, the post stage and the canvas live


def upload_program(lowered, device, mesh=None) -> DeviceProgram:
    """Upload every item stream, pool index, blur chunk and filter chain
    constant of a Lowered plan once; run_program then renders it any
    number of times.

    mesh: a parallel.mesh.Mesh to shard every item stream (each level's
    pass program and the main stream) over, by tiles: each is partitioned
    here once (parallel.scene.sharded_exec_fn), one DevicePlan per shard
    on that shard's device.  The pool, the post stage and the assembled
    canvas stay on `device`, unsharded, as in the JAX package.
    """
    from .ops import filter_batch

    dev = torch.device(device)
    atlas = _upload_atlas(lowered, dev)  # pass groups can paint patterns too
    if mesh is None:
        def upload(items, bigs, clips, grid):
            return _upload_items(items, bigs, clips, lowered.tile, grid, dev, atlas)
    else:
        from .parallel.scene import sharded_exec_fn

        partition = sharded_exec_fn(mesh)

        def upload(items, bigs, clips, grid):
            return partition(items, bigs, clips, lowered.tile, grid, dev, lowered.patterns)

    def rows(values):
        return torch.as_tensor(np.asarray(values, np.int32), device=dev)

    levels = []
    pool_total = 0
    for g in lowered.groups:
        chunks, batched = g["_blur_batch"]
        copy_src, copy_dst, filters = [], [], []
        for pi, p in enumerate(g["parts"]):
            n_out = len(p["out_tiles"])
            pool_total = max(pool_total, p["pool_base"] + n_out)
            if pi in batched:
                continue
            dst = range(p["pool_base"], p["pool_base"] + n_out)
            if p["post"] is None:
                copy_src.extend(range(p["row_start"], p["row_start"] + p["n_rows"]))
                copy_dst.extend(dst)
            else:
                filters.append(_upload_part_filter(p, lowered.grid[1], dst, dev))
        levels.append(_Level(
            plan=upload(g["items"], g["bigs"], g["clips"], (1, g["rows"])),
            needs_pool=bool(g["needs_pool"]),
            copy_rows=(rows(copy_src), rows(copy_dst)) if copy_src else None,
            filters=filters,
            blur=filter_batch.pack_level(chunks, lowered.tile, dev),
        ))
    main = upload(lowered.items, lowered.bigs, lowered.clips, tuple(lowered.grid))
    return DeviceProgram(levels, main, pool_total, int(lowered.tile), tuple(lowered.grid),
                         dev)


class _Ops(NamedTuple):
    """The executors a program runs through."""

    execute: Any  # (DevicePlan, pool | None) -> canvas tiles
    blur: Any  # (canvas, BlurLevel, tile, linear_rgb) -> the level's out-span tiles
    pool_rows: Any  # (pool, src, src_idx, dst_idx) -> pool, in place


# the kernel wrappers (plain versions for CPU tensors only), and the plain
# PyTorch versions on any device: the oracle the kernels are held against
KERNEL_OPS = _Ops(fused_exec.execute_items_fused, fused_exec.blur_chunk,
                  fused_exec.pool_rows)


def _plain_ops() -> _Ops:
    from .ops import filter_batch

    return _Ops(be.execute_items, filter_batch.apply_level, be._pool_rows)


def new_pool(program: DeviceProgram):
    """The pass pool a program's levels write: (P, T, T, 4) f32 zeros, or
    None for a plan without isolation passes."""
    if not program.levels:
        return None
    t = program.tile
    return torch.zeros((program.pool_rows, t, t, 4), dtype=torch.float32,
                       device=program.device)


def run_program(program: DeviceProgram, viewport=(0, 0), linear_rgb: bool = False,
                pool=None, plain: bool = False):
    """Render a DeviceProgram: canvas tiles (num_tiles, T, T, 4) f32.

    The mirror of the JAX package's execute_lowered: each dependency
    level's pass program runs through the scene executor (reading the pool
    where its items reference earlier levels), its post stage writes the
    level's rows into the pool, and the main stream runs last.  pool:
    new_pool(program) to reuse across frames (every row is rewritten
    before it is read), or None for a fresh one.  plain=True runs the
    plain PyTorch versions of the kernels on the same tensors.
    """
    ops = _plain_ops() if plain else KERNEL_OPS
    if pool is None:
        pool = new_pool(program)
    for level in program.levels:
        canvas = _execute(ops, level.plan, pool if level.needs_pool else None)
        _apply_group_post(canvas, pool, level, viewport, linear_rgb, program.tile, ops)
    return _execute(ops, program.main, pool)


def _execute(ops: _Ops, plan, pool):
    """One item stream's canvas tiles: a DevicePlan through the scene
    executor, a sharded one (parallel.scene.ShardedPlan) shard by shard."""
    if isinstance(plan, DevicePlan):
        return ops.execute(plan, pool)
    from .parallel.scene import sharded_render_plan

    return sharded_render_plan(plan, ops.execute, pool)


def _apply_group_post(canvas, pool, level: _Level, viewport, linear_rgb, t_size,
                      ops: _Ops):
    """A level's post stage: its new rows written into the pool in place.

    One pool_rows launch per output block: the level's plain pass rows
    (straight from the canvas), each filter part's output tiles, and the
    out tiles of all its blur chunks (one blur launch, picked by the
    packed level's out_idx).  This replaces the JAX package's out-tile
    gather, row concatenation, permutation and level update.
    """
    if level.copy_rows is not None:
        ops.pool_rows(pool, canvas, *level.copy_rows)
    for part in level.filters:
        tiles = _apply_part_filter(canvas, part, viewport, linear_rgb, t_size)
        ops.pool_rows(pool, tiles, part.src_idx, part.dst_idx)
    if level.blur is not None:
        tiles = ops.blur(canvas, level.blur, t_size, linear_rgb)
        ops.pool_rows(pool, tiles, level.blur.out_idx, level.blur.pool_idx)


def _apply_part_filter(canvas, part: _PartFilter, viewport, linear_rgb, t_size):
    """Filter post-op for one merged-group part: assemble the pass's rendered
    rows into an image, run the filter chain, cut the grown result into the
    tiles of its out span, row-major (the part's out tiles are rows
    part.src_idx of it)."""
    from .core.layer import merge_at

    v0, v1 = int(viewport[0]), int(viewport[1])
    first, count = part.rows
    rows = canvas[first : first + count]

    # assemble the span of source tiles into one image
    si0, sj0, nsi, nsj = part.span
    span = canvas.new_zeros((nsi * nsj, t_size, t_size, 4))
    span[part.local] = rows
    image = span.reshape(nsi, nsj, t_size, t_size, 4)
    image = image.permute(0, 2, 1, 3, 4).reshape(nsi * t_size, nsj * t_size, 4)

    # bbox-tight source crop: the filter sees the same layer origin the
    # reference's interpreter would, so truncation-sensitive placement
    # (blur offsets) matches bit-for-bit
    content_bbox = part.content_bbox
    or_, oc = si0 * t_size, sj0 * t_size  # span origin in canvas pixels
    r0 = max(content_bbox[0] - v0 - or_, 0)
    c0 = max(content_bbox[1] - v1 - oc, 0)
    r1 = min(content_bbox[2] - v0 - or_, nsi * t_size)
    c1 = min(content_bbox[3] - v1 - oc, nsj * t_size)
    crop = image[r0:r1, c0:c1]
    layer = Layer(crop, (v0 + or_ + r0, v1 + oc + c0), pre_alpha=True, linear_rgb=linear_rgb)
    filtered = part.flt(part.transform, layer, part.consts).convert(
        pre_alpha=True, linear_rgb=linear_rgb)

    di0, dj0, nti, ntj = part.out
    dst = canvas.new_zeros((nti * t_size, ntj * t_size, 4))
    dst = merge_at(dst, filtered.image,
                   (filtered.x - v0 - di0 * t_size, filtered.y - v1 - dj0 * t_size))
    tiles = dst.reshape(nti, t_size, ntj, t_size, 4).permute(0, 2, 1, 3, 4)
    return tiles.reshape(nti * ntj, t_size, t_size, 4).contiguous()


def execute_lowered(lowered, device="cuda", viewport=(0, 0), linear_rgb: bool = False,
                    mesh=None):
    """Execute a Lowered plan on `device`: canvas tiles (num_tiles, T, T, 4)
    f32 premultiplied.

    viewport: the canvas origin (v0, v1) in device pixels (filter
    post-ops place their output by it).  On a CUDA device the plan runs
    through the CUDA kernels (prepass winding, scene tiles, blur chunk,
    pool rows); on the CPU through their plain PyTorch versions.  mesh:
    shard every item stream over it by tiles (upload_program).
    """
    return run_program(upload_program(lowered, device, mesh), viewport, linear_rgb)


def tiles_to_layer(tiles, grid, tile: int, viewport, linear_rgb: bool) -> Layer:
    """(num_tiles, T, T, 4) canvas tiles -> the viewport-sized Layer."""
    grid_h, grid_w = grid
    canvas = tiles.reshape(grid_h, grid_w, tile, tile, 4).permute(0, 2, 1, 3, 4)
    canvas = canvas.reshape(grid_h * tile, grid_w * tile, 4)
    v0, v1, h, w = viewport
    return Layer(
        canvas[: int(h), : int(w)], (int(v0), int(v1)), pre_alpha=True,
        linear_rgb=linear_rgb,
    )


def render_fast(scene, transform: Transform, viewport, linear_rgb: bool = False,
                *, tile: int = DEFAULT_TILE, device="cuda"):
    """Whole-scene batched render on `device`; returns (Layer, hull), or
    None when the batched path cannot express the scene."""
    lowered = lower_scene(scene, transform, viewport, linear_rgb, tile, device=device)
    if lowered is None:
        return None
    tiles = execute_lowered(lowered, device, viewport[:2], linear_rgb)
    layer = tiles_to_layer(tiles, lowered.grid, lowered.tile, viewport, linear_rgb)
    return layer, lowered.hull


class CompiledScene:
    """A scene lowered and uploaded once, rendered many times (serving).

    Every item stream, pool index, blur chunk and filter chain constant is
    uploaded once, and one pass pool serves every frame; each frame re-runs
    the pass levels and the main stream.  mesh: shard every item stream
    over a parallel.mesh.Mesh by tiles (upload_program).

    render_tiles_many(k) on a CUDA device replays one frame captured in a
    CUDA graph, so the host issues one graph launch per frame instead of
    the frame's kernel launches and tensor operations.  The graph is
    captured at the first call, once per instance: the instance fixes
    everything the captured work depends on (the plan, the viewport,
    linear_rgb, the device), so one graph can never serve another input.
    """

    def __init__(self, lowered, viewport, linear_rgb: bool, mesh=None, *, device="cuda"):
        self._lowered = lowered
        self._viewport = viewport
        self._linear_rgb = linear_rgb
        self._mesh = mesh
        self._program = upload_program(lowered, device, mesh)
        self._pool = new_pool(self._program)
        self._graph = None  # torch.cuda.CUDAGraph of one frame, captured on first use
        self._frame = None  # the tiles that graph writes
        self.replays = 0  # frames replayed from the graph
        self.frame_launches = None  # kernel launches of the captured frame, by kernel

    @property
    def tile(self) -> int:
        return self._lowered.tile

    @property
    def hull(self):
        return self._lowered.hull

    @property
    def plan(self):
        """The main item stream on the device."""
        return self._program.main

    @property
    def program(self) -> DeviceProgram:
        return self._program

    def render_tiles(self, plain: bool = False):
        """Raw canvas tiles (num_tiles, T, T, 4), premultiplied.

        plain=True renders through the plain PyTorch versions of the
        kernels on the same device tensors (their oracle)."""
        return run_program(self._program, self._viewport[:2], self._linear_rgb,
                           self._pool, plain=plain)

    def render_tiles_many(self, k: int):
        """Render k frames; returns the last one's tiles (num_tiles, T, T, 4),
        a tensor the caller owns.

        On a CUDA device each frame is a replay of the captured graph on the
        current stream (a failed capture raises); on the CPU each frame runs
        render_tiles.  Single-device plans only."""
        if self._mesh is not None:
            raise ValueError("render_tiles_many: single-device plans only")
        k = int(k)
        if k < 1:
            raise ValueError(f"render_tiles_many: k must be >= 1, got {k}")
        if self._program.device.type != "cuda":
            for _ in range(k):
                tiles = self.render_tiles()
            return tiles
        if self._graph is None:
            self._capture()
        for _ in range(k):
            self._graph.replay()
        self.replays += k
        return self._frame.clone()

    def _capture(self) -> None:
        """Capture one frame in a CUDA graph, after one eager frame on a
        side stream (it loads the kernels and sizes the caching
        allocator's blocks outside the capture)."""
        dev = self._program.device
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            self.render_tiles()
        torch.cuda.current_stream(dev).wait_stream(side)
        before = {k.__name__: k.launches for k in fused_exec.KERNELS}
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            frame = self.render_tiles()
        self.frame_launches = {k.__name__: k.launches - before[k.__name__]
                               for k in fused_exec.KERNELS}
        self._graph, self._frame = graph, frame

    def render(self) -> Layer:
        """Viewport-sized premultiplied Layer."""
        return tiles_to_layer(
            self.render_tiles(), self._lowered.grid, self._lowered.tile,
            self._viewport, self._linear_rgb,
        )

    def render_many(self, k: int) -> Layer:
        """k frames (render_tiles_many); the last one as a Layer."""
        return tiles_to_layer(
            self.render_tiles_many(k), self._lowered.grid, self._lowered.tile,
            self._viewport, self._linear_rgb,
        )


def compile_scene(scene, transform: Transform, viewport, linear_rgb: bool = False,
                  mesh=None, *, tile: int = DEFAULT_TILE, device="cuda"):
    """Lower a scene once for repeated rendering; None if unsupported.

    mesh: shard its item streams over a parallel.mesh.Mesh (CompiledScene);
    device: where the plan lowers and, with a mesh, where the pool and the
    assembled canvas live."""
    lowered = lower_scene(scene, transform, viewport, linear_rgb, tile, device=device)
    if lowered is None:
        return None
    return CompiledScene(lowered, viewport, linear_rgb, mesh, device=device)


def can_lower(scene, linear_rgb: bool, in_clip: bool = False) -> bool:
    """Cheap structural predicate: would lower_scene accept this subtree?

    Mirrors _collect_draws / _paint_params / _clip_parts checks without
    touching geometry, so the hybrid group renderer can partition children
    into batchable runs in O(nodes).
    """
    kind, args = scene
    if kind in (RENDER_FILL, RENDER_STROKE):
        paint = args[1]
        if paint is None:
            return True
        if isinstance(paint, np.ndarray):
            return True
        if isinstance(paint, (GradLinear, GradRadial)):
            if paint.linear_rgb is not None and paint.linear_rgb != linear_rgb:
                return False
            return len(paint.stops) <= MAX_STOPS
        if isinstance(paint, Pattern):
            # the tile is rendered through the interpreter at lowering time,
            # so any pattern content batches
            return True
        return False
    if kind == RENDER_GROUP:
        return all(can_lower(c, linear_rgb, in_clip) for c in args)
    if kind == RENDER_TRANSFORM:
        return can_lower(args[0], linear_rgb, in_clip)
    if kind == RENDER_OPACITY:
        # single draws fold; groups become isolation passes — both lower
        return can_lower(args[0], linear_rgb, in_clip)
    if kind == RENDER_CLIP:
        target, clip_scene, _bbox_units = args
        # nested clips isolate as passes, so in_clip does not block;
        # bbox-units resolve from the target hull at lowering time
        return _clip_scene_ok(clip_scene) and can_lower(target, linear_rgb, True)
    if kind == RENDER_MASK:
        target, mask_scene, _bbox_units = args
        return can_lower(target, linear_rgb, in_clip) and can_lower(
            mask_scene, linear_rgb, in_clip
        )
    if kind == RENDER_FILTER:
        return can_lower(args[0], linear_rgb, in_clip)
    return False


def _clip_scene_ok(scene) -> bool:
    # any mix of fill rules lowers: clip coverage is the precomputed
    # per-part union (_clip_tile), matching the reference's mask_only
    # OVER composition exactly
    def walk(scene) -> bool:
        kind, args = scene
        if kind == RENDER_FILL:
            return True
        if kind == RENDER_GROUP:
            return all(walk(c) for c in args)
        if kind == RENDER_TRANSFORM:
            return walk(args[0])
        return False

    return walk(scene)


def crop_layer_to_hull(layer: Layer, hull: ConvexHull, viewport) -> Layer:
    """Crop a viewport-sized layer down to its hull's bucketed bbox.

    Downstream layer ops (colorspace conversion, filters, composition) then
    run on content-sized tensors; the extent is the JAX package's (its
    bucketed dims keep XLA's set of compiled shapes small), so layer
    origins, and with them truncation-sensitive filter placement, match.
    """
    from .utils.buckets import bucket_dim

    pts = hull.raw_points
    if len(pts) == 0:
        return layer
    v0, v1, vh, vw = (int(x) for x in viewport)
    r0 = max(int(np.floor(pts[:, 0].min())) - 1, v0)
    c0 = max(int(np.floor(pts[:, 1].min())) - 1, v1)
    r1 = min(int(np.ceil(pts[:, 0].max())) + 1, v0 + vh)
    c1 = min(int(np.ceil(pts[:, 1].max())) + 1, v1 + vw)
    if r1 <= r0 or c1 <= c0:
        return layer
    h = bucket_dim(r1 - r0)
    w = bucket_dim(c1 - c0)
    if h >= layer.height and w >= layer.width:
        return layer
    # shift the window up-left so the bucketed extent stays inside the canvas
    r0 = max(min(r0, v0 + vh - h), v0)
    c0 = max(min(c0, v1 + vw - w), v1)
    h = min(h, layer.height)
    w = min(w, layer.width)
    image = layer.image[r0 - layer.x : r0 - layer.x + h, c0 - layer.y : c0 - layer.y + w]
    return Layer(image, (r0, c0), layer.pre_alpha, layer.linear_rgb)


def render_group_hybrid(children, transform: Transform, viewport, linear_rgb: bool,
                        *, tile: int = DEFAULT_TILE, device="cuda", masks):
    """Render a group's children, batching maximal runs of lowerable ones.

    Returns a list of (Layer, hull) results in paint order (callers compose
    with OVER); runs render through render_fast at `tile` on `device`,
    non-batchable children through the interpreter (Scene._render), which
    takes their path masks from `masks`, the render's render.MaskBatch.
    """
    from .scene import Scene

    results: list = []
    run: list = []
    sub = dict(tile=tile, device=device, masks=masks)

    def flush():
        if not run:
            return
        group = Scene.group(run) if len(run) > 1 else run[0]
        rendered = render_fast(group, transform, viewport, linear_rgb, tile=tile, device=device)
        if rendered is not None:
            layer, hull = rendered
            results.append((crop_layer_to_hull(layer, hull, viewport), hull))
        else:  # predicate was optimistic; render the run via the interpreter
            for child in run:
                out = child._render(transform, False, viewport, linear_rgb, **sub)
                if out is not None:
                    results.append(out)
        run.clear()

    for child in children:
        if viewport is not None and can_lower(child, linear_rgb):
            run.append(child)
            continue
        flush()
        out = child._render(transform, False, viewport, linear_rgb, **sub)
        if out is not None:
            results.append(out)
    flush()
    return results
