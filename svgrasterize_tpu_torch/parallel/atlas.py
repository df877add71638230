"""Batch document rendering: many SVGs -> one sprite atlas, optionally
sharded by tiles.

The twin of the JAX package's parallel/atlas.py.  Every document is lowered
into the same tiled plan with a translate into its atlas slot, so the whole
batch becomes one z-sorted item stream — or one sharded over a mesh
(parallel/scene.py: documents land in disjoint tile ranges, so tile
sharding is also document sharding).  compile_atlas serves an atlas whose
documents repeat by rendering each unique document once.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..core.layer import Layer
from ..core.transform import Transform
from ..render_plan import (
    compile_scene,
    execute_lowered,
    lower_scene,
    tiles_to_layer,
)
from ..scene import Scene
from ..utils.constants import DEFAULT_TILE


def layout_grid(n: int, cell: int, cols: int | None = None, margin: int = 0):
    """Grid geometry for n cells: returns (cols, rows, width, height)."""
    cols = cols or max(1, round(math.sqrt(n)))
    rows = -(-n // cols) if n else 0
    step = cell + margin
    return cols, rows, cols * step + margin, rows * step + margin


def atlas_scene(scenes_sizes, cell: int, cols: int | None = None, margin: int = 0):
    """Compose documents into one scene laid out on a grid.

    scenes_sizes: [(scene, (width, height))]; each document is uniformly
    scaled into its cell.  Returns (combined_scene, (width, height)).
    """
    n = len(scenes_sizes)
    cols, _rows, width, height = layout_grid(n, cell, cols, margin)
    step = cell + margin
    placed = []
    for index, (scene, size) in enumerate(scenes_sizes):
        if scene is None:
            continue
        row, col = divmod(index, cols)
        w, h = size if size is not None else (cell, cell)
        scale = min(cell / w, cell / h)
        tr = (
            Transform()
            .translate(margin + col * step, margin + row * step)
            .scale(scale)
        )
        placed.append(scene.transform(tr))
    if not placed:
        return None, (width, height)
    return Scene.group(placed), (width, height)


# documents are authored in x/y; the canvas is indexed (row, col)
_SWAP = Transform().matrix(0, 1, 0, 1, 0, 0)


def render_atlas(
    scenes_sizes,
    cell: int = 128,
    cols: int | None = None,
    margin: int = 0,
    mesh=None,
    linear_rgb: bool = False,
    *,
    tile: int = DEFAULT_TILE,
    device="cuda",
):
    """Render a batch of documents into one atlas Layer on `device`.

    With a mesh, canvas tiles (and therefore documents) are sharded over
    its shards, and `device` holds the assembled canvas; otherwise one
    device executes the whole plan.  Falls back to the interpreter if the
    batch does not lower.
    """
    combined, (width, height) = atlas_scene(scenes_sizes, cell, cols, margin)
    if combined is None:
        return Layer(torch.zeros((height, width, 4), dtype=torch.float32, device=device),
                     (0, 0), True, linear_rgb)
    viewport = (0, 0, height, width)
    lowered = lower_scene(combined, _SWAP, viewport, linear_rgb, tile, device=device)
    if lowered is None:
        from ..core.layer import merge_at

        layer, _hull = combined.render(_SWAP, viewport=viewport, linear_rgb=linear_rgb,
                                       device=device)
        layer = layer.convert(pre_alpha=True, linear_rgb=linear_rgb)
        canvas = torch.zeros((height, width, 4), dtype=torch.float32, device=device)
        canvas = merge_at(canvas, layer.image, layer.offset)
        return Layer(canvas, (0, 0), pre_alpha=True, linear_rgb=linear_rgb)
    tiles = execute_lowered(lowered, device, viewport[:2], linear_rgb, mesh=mesh)
    return tiles_to_layer(tiles, lowered.grid, lowered.tile, viewport, linear_rgb)


class AtlasServer:
    """Serving handle for a sprite atlas (see compile_atlas): the compiled
    scene of its unique documents, and the tile rows that make the atlas of
    them (None when the compiled scene is the atlas itself)."""

    def __init__(self, compiled, rows, size, n_unique, n_docs, linear_rgb=False):
        self.compiled = compiled
        self._rows = rows
        self.size = size
        self.tile = compiled.tile
        self.n_unique = n_unique
        self.n_docs = n_docs
        self._linear_rgb = linear_rgb

    def _gather(self, tiles):
        if self._rows is None:
            return tiles
        zero = tiles.new_zeros((1, *tiles.shape[1:]))
        return torch.cat([tiles, zero]).index_select(0, self._rows)

    def render_tiles(self):
        """(atlas tiles, T, T, 4) canvas tiles, premultiplied."""
        return self._gather(self.compiled.render_tiles())

    def render_tiles_many(self, k: int):
        """k frames of the unique scene (CompiledScene.render_tiles_many,
        replays of its graph on the card), then the gather of the last."""
        return self._gather(self.compiled.render_tiles_many(k))

    def render(self) -> Layer:
        width, height = self.size
        t = self.tile
        grid = (-(-height // t), -(-width // t))
        return tiles_to_layer(self.render_tiles(), grid, t, (0, 0, height, width),
                              self._linear_rgb)


def compile_atlas(
    scenes_sizes, cell: int = 128, cols: int | None = None, margin: int = 0,
    linear_rgb: bool = False, *, tile: int = DEFAULT_TILE, device="cuda",
):
    """Compile a sprite atlas for serving, rendering each unique document
    once.

    Sprite atlases repeat documents (icon sets reuse glyphs and sprites),
    and serving cost is about proportional to item count, so rasterizing
    identical cells repeatedly pays once per copy.  This deduplicates
    documents by object identity plus size, compiles one scene over the
    unique-cell atlas, and serves the full atlas as a row gather of the
    unique canvas tiles (cells are tile-aligned, so a duplicate cell is
    exactly a run of duplicate tile rows).  Falls back to the plain
    combined plan when nothing repeats or the geometry is not tile-aligned.

    Returns an AtlasServer or None when the atlas cannot lower.
    """
    n = len(scenes_sizes)
    cols_n, _rows_n, width, height = layout_grid(n, cell, cols, margin)

    uniq: list = []
    uniq_of: list = []
    index_of: dict = {}
    for s, size in scenes_sizes:
        if s is None:
            uniq_of.append(-1)
            continue
        key = (id(s), tuple(size) if size is not None else None)
        if key not in index_of:
            index_of[key] = len(uniq)
            uniq.append((s, size))
        uniq_of.append(index_of[key])

    def _plain():
        combined, (w, h) = atlas_scene(scenes_sizes, cell, cols, margin)
        if combined is None:
            return None
        compiled = compile_scene(combined, _SWAP, (0, 0, h, w), linear_rgb,
                                 tile=tile, device=device)
        if compiled is None:
            return None
        return AtlasServer(compiled, None, (w, h), n, n, linear_rgb)

    if len(uniq) == n or not uniq:
        return _plain()

    combined_u, (wu, hu) = atlas_scene(uniq, cell, None, margin)
    compiled = compile_scene(combined_u, _SWAP, (0, 0, hu, wu), linear_rgb,
                             tile=tile, device=device)
    if compiled is None:
        return None
    t = compiled.tile
    if cell % t or margin % t:
        return _plain()  # tiles would straddle cell boundaries
    step = cell + margin
    cols_u = layout_grid(len(uniq), cell, None, margin)[0]
    gw_u = -(-wu // t)
    gh, gw = -(-height // t), -(-width // t)
    u_tiles = (-(-hu // t)) * gw_u
    rows = np.full(gh * gw, u_tiles, np.int32)  # default: the zero tile
    for r in range(gh):
        qy = r * t - margin
        if qy < 0 or qy % step >= cell:
            continue
        cell_row, off_r = qy // step, (qy % step) // t
        for c in range(gw):
            qx = c * t - margin
            if qx < 0 or qx % step >= cell:
                continue
            cell_col, off_c = qx // step, (qx % step) // t
            idx = cell_row * cols_n + cell_col
            if idx >= n or uniq_of[idx] < 0:
                continue
            urow, ucol = divmod(uniq_of[idx], cols_u)
            rows[r * gw + c] = (
                ((margin + urow * step) // t + off_r) * gw_u
                + (margin + ucol * step) // t + off_c
            )
    rows_dev = torch.as_tensor(rows.astype(np.int64), device=compiled.program.device)
    return AtlasServer(compiled, rows_dev, (width, height), len(uniq), n, linear_rgb)
