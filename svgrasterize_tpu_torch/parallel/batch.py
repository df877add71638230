"""Batched and mesh-sharded path fills.

The twin of the JAX package's parallel/batch.py.  `fill_batch` rasterizes a
batch of paths (padded edge lists) into AA-filled premultiplied RGBA tiles:
on a CUDA device their winding fields come from one launch of the
whole-image winding kernel (ops/fused_exec.winding_uniform, the batched
entry of winding_batch for lists already on the card), on the CPU from its
plain version (ops/coverage.winding).

`sharded_fill_batch` runs the same computation over a ("data", "seg") mesh:
the batch is split over "data" and each edge list over "seg"; each shard
computes the partial winding of its edge slice, and the partials are summed
(exact: winding is a sum over edges), which takes the place of JAX's psum;
across processes the sum is an all_reduce.  `sharded_render_step` adds the
composite: the tiles are folded with premultiplied OVER in batch order.
Each result is returned whole, on the mesh's first device of this process.
"""

from __future__ import annotations

import torch

from ..ops import fill_rule as fill_rule_ops
from ..ops import fused_exec


def _as_f32(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32).to(device)


def _windings(lines: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """(N, height, width) winding fields of the edge lists lines (N, S, 4),
    through the winding kernel on a CUDA device (one launch)."""
    return fused_exec.winding_uniform(lines.contiguous(), height, width)


def _fill(wind, colors, fill_rule):
    mask = fill_rule_ops.apply(wind, fill_rule)
    return mask[..., None] * colors[:, None, None, :]


def fill_batch(lines, colors, height: int, width: int, fill_rule: str | None = None,
               *, device="cuda"):
    """Rasterize a batch of paths into premultiplied RGBA tiles.

    lines: (N, S, 4) padded per-path edge lists (tile-local coords);
    colors: (N, 4) premultiplied RGBA (tensors or arrays, moved to
    `device`).  Returns (N, height, width, 4) f32 on `device`.
    """
    lines = _as_f32(lines, device)
    colors = _as_f32(colors, device)
    return _fill(_windings(lines, int(height), int(width)), colors, fill_rule)


def _sharded_winding(mesh, lines, height: int, width: int) -> torch.Tensor:
    """(N, height, width) winding over a ("data", "seg") mesh, summed over
    the "seg" shards (all_reduce across processes) on mesh.home."""
    a, b = mesh.devices.shape
    n, s = lines.shape[0], lines.shape[1]
    if n % a or s % b:
        raise ValueError(f"a batch of {n} lists of {s} edges does not split over a"
                         f" {a} x {b} mesh")
    rows, segs = n // a, s // b
    wind = torch.zeros((n, height, width), dtype=torch.float32, device=mesh.home)
    for d in mesh.local_shards:
        i, j = divmod(d, b)
        part = lines[i * rows:(i + 1) * rows, j * segs:(j + 1) * segs]
        partial = _windings(part.to(mesh.devices[i, j]), height, width)
        wind[i * rows:(i + 1) * rows] += partial.to(mesh.home)
    if mesh.group is not None:
        import torch.distributed as dist

        dist.all_reduce(wind, group=mesh.group)
    return wind


def sharded_fill_batch(mesh, lines, colors, height: int, width: int, fill_rule=None):
    """fill_batch over a ("data", "seg") mesh; (N, height, width, 4) on
    mesh.home."""
    wind = _sharded_winding(mesh, torch.as_tensor(lines, dtype=torch.float32), int(height),
                            int(width))
    return _fill(wind, _as_f32(colors, mesh.home), fill_rule)


def sharded_render_step(mesh, lines, colors, height: int, width: int, fill_rule=None):
    """Full sharded step: rasterize the batch, then composite it in paint
    order; returns the (height, width, 4) canvas with every path OVER-composed
    in batch order (a left fold: the JAX package's associative scan
    associates differently, so the two agree within rounding)."""
    tiles = sharded_fill_batch(mesh, lines, colors, height, width, fill_rule)
    canvas = tiles[0]
    for tile in tiles[1:]:
        canvas = tile + canvas * (1.0 - tile[..., -1:])
    return canvas
