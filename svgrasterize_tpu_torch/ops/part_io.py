"""A filter part's entry and exit: the plain PyTorch versions of the part
kernels (csrc/part_io.cu, wrappers ops/fused_exec.part_entry and
part_exit).

A filter part whose chain runs per frame (render_plan._PartFilter) reads
its pass rows from the level's canvas and writes its out tiles into the
pass pool.  Its entry assembles the rows into the span image of its source
tiles, crops it to the source's bbox and makes the chain's two seeds
(Filter.seeds: SourceAlpha, and SourceGraphic in the chain's straight-alpha
colorspace); its exit converts the chain's result back to premultiplied
alpha in the canvas's colorspace, places it on a zero out span (merge_at's
OVER and clamp), cuts the span into its (T, T, 4) tiles and writes the
part's out tiles into their pool rows.
"""

from __future__ import annotations

from ..core.layer import Layer, merge_at
from .batch_exec import _pool_rows


def crop_window(part, viewport, t_size: int):
    """The part's source crop in its span image, (r0, r1, c0, c1) as slice
    bounds, and the crop's offset on the canvas.

    bbox-tight: the filter sees the same layer origin the reference's
    interpreter would, so truncation-sensitive placement (blur offsets)
    matches bit for bit."""
    v0, v1 = int(viewport[0]), int(viewport[1])
    si0, sj0, nsi, nsj = part.span
    content_bbox = part.content_bbox
    or_, oc = si0 * t_size, sj0 * t_size  # span origin in canvas pixels
    r0 = max(content_bbox[0] - v0 - or_, 0)
    c0 = max(content_bbox[1] - v1 - oc, 0)
    r1 = min(content_bbox[2] - v0 - or_, nsi * t_size)
    c1 = min(content_bbox[3] - v1 - oc, nsj * t_size)
    return (r0, r1, c0, c1), (v0 + or_ + r0, v1 + oc + c0)


def exit_offset(result: Layer, part, viewport, t_size: int) -> tuple:
    """Where the chain's result lies in the part's out span, in pixels."""
    di0, dj0, _nti, _ntj = part.out
    return (result.x - int(viewport[0]) - di0 * t_size,
            result.y - int(viewport[1]) - dj0 * t_size)


def part_entry(canvas, part, viewport, linear_rgb: bool, t_size: int):
    """The chain's seeds (SourceAlpha, SourceGraphic) of one part: its rows
    of the level's canvas (R, T, T, 4) assembled, cropped and converted."""
    first, count = part.rows
    rows = canvas[first : first + count]

    # assemble the span of source tiles into one image
    _si0, _sj0, nsi, nsj = part.span
    span = canvas.new_zeros((nsi * nsj, t_size, t_size, 4))
    span[part.local] = rows
    image = span.reshape(nsi, nsj, t_size, t_size, 4)
    image = image.permute(0, 2, 1, 3, 4).reshape(nsi * t_size, nsj * t_size, 4)

    (r0, r1, c0, c1), offset = crop_window(part, viewport, t_size)
    layer = Layer(image[r0:r1, c0:c1], offset, pre_alpha=True, linear_rgb=linear_rgb)
    return part.flt.seeds(layer, part.consts)


def part_exit(pool, result: Layer, part, viewport, linear_rgb: bool, t_size: int):
    """Write the chain's result into the part's pool rows in place; returns
    pool.  The out span is its out tiles' row-major span (part.out); the
    part's out tiles are rows part.src_idx of it, written to pool rows
    part.dst_idx."""
    filtered = result.convert(pre_alpha=True, linear_rgb=linear_rgb)
    _di0, _dj0, nti, ntj = part.out
    dst = filtered.image.new_zeros((nti * t_size, ntj * t_size, 4))
    dst = merge_at(dst, filtered.image, exit_offset(filtered, part, viewport, t_size))
    tiles = dst.reshape(nti, t_size, ntj, t_size, 4).permute(0, 2, 1, 3, 4)
    tiles = tiles.reshape(nti * ntj, t_size, t_size, 4).contiguous()
    return _pool_rows(pool, tiles, part.src_idx, part.dst_idx)
