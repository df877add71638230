"""Tile-sharded scene rendering: split a lowered plan's item streams over a
mesh's shards.

The twin of the JAX package's parallel/scene.py.  The canvas tile grid is
partitioned over the shards (tiles are balanced by item count, LPT-greedy
under a per-shard tile capacity) and each shard renders its tiles only:
z order is per tile, so tile ranges are embarrassingly parallel, and the
canvas assembles by one row gather.  The host arrays (_assign_tiles,
partition_plan) are the JAX package's bit for bit, at its defaults: the
balanced split and the shared row stacks (pool, pattern atlas, clips,
collapse fields) sub-selected per shard.

The port partitions each item stream once, when a program is uploaded
(sharded_exec_fn, called by render_plan.upload_program), into one
DevicePlan per shard on that shard's device; sharded_render_plan runs a
frame: each shard's prepass and scene kernels, its frame-dynamic pool rows
gathered by an index_select made at upload, and the canvas assembled on
the program's device (across processes, after an all_gather).  The post
stage (filters, blur levels, pool writes) runs unsharded, as in the JAX
package.
"""

from __future__ import annotations

import heapq
from typing import Any, NamedTuple

import numpy as np
import torch

from ..ops.batch_exec import CHUNK_BIG, CHUNK_ITEMS, DevicePlan
from ..utils.constants import DEVICE_FLOAT


def _pow2_pad(n: int, chunk: int) -> int:
    out = chunk
    while out < n:
        out *= 2
    return out


def _flatten_big_classes(bigs) -> np.ndarray:
    """Concatenate per-width big classes into one max-width array, keeping
    every class's padded row count so global big_idx rows stay valid."""
    arrays = list(bigs)
    if not arrays:
        return np.zeros((0, 0, 4), DEVICE_FLOAT)
    width = max(a.shape[1] for a in arrays)
    total = sum(a.shape[0] for a in arrays)
    out = np.zeros((total, width, 4), DEVICE_FLOAT)
    row = 0
    for a in arrays:
        out[row : row + a.shape[0], : a.shape[1]] = a
        row += a.shape[0]
    return out


def _assign_tiles(valid_tile_ids, num_tiles: int, n_devices: int,
                  tiles_per_dev: int):
    """(dev_of_tile, slot_of_tile, permuted): item-count-balanced tile split.

    The contiguous split (tile t -> device t // tiles_per_dev) keeps the
    canvas assembly a plain reshape but lets a scene whose heavy items
    cluster in one tile range idle most of the mesh.  This assigns tiles to
    devices LPT-greedy by per-tile item count under the fixed tiles_per_dev
    capacity, so max/mean item skew stays near 1 for any clustering; the
    canvas then needs a final row gather (sharded_render_plan applies it
    when `permuted`).
    """
    contiguous = (
        np.arange(num_tiles, dtype=np.int32) // tiles_per_dev,
        np.arange(num_tiles, dtype=np.int32) % tiles_per_dev,
        False,
    )
    if n_devices <= 1:
        return contiguous
    counts = np.bincount(valid_tile_ids, minlength=num_tiles)
    # heavy tiles first; zero-item tiles fill capacity at the end
    order = np.argsort(-counts, kind="stable")
    heap = [(0, d) for d in range(n_devices)]
    heapq.heapify(heap)
    used = np.zeros(n_devices, np.int64)
    dev_of_tile = np.zeros(num_tiles, np.int32)
    slot_of_tile = np.zeros(num_tiles, np.int32)
    for t in order:
        spill = []
        while True:
            load, d = heapq.heappop(heap)
            if used[d] < tiles_per_dev:
                break
            spill.append((load, d))
        for entry in spill:
            heapq.heappush(heap, entry)
        dev_of_tile[t] = d
        slot_of_tile[t] = used[d]
        used[d] += 1
        heapq.heappush(heap, (load + int(counts[t]), d))
    if (dev_of_tile == contiguous[0]).all() and (
        slot_of_tile == contiguous[1]
    ).all():
        return contiguous
    return dev_of_tile, slot_of_tile, True


def shard_balance(stacked: dict, tiles_per_dev: int) -> dict:
    """Per-device real-item balance of a partitioned plan.

    Returns {"counts": (n_devices,), "skew": max/mean} computed from the
    stacked tile_id (pads carry the device-local scratch id
    tiles_per_dev).  The mean is over the devices with work (the JAX
    package's says so but averages over every device, which inflates the
    skew of a plan that leaves a device idle); an all-empty plan reports
    skew 1.0.
    """
    tid = stacked["tile_id"]
    counts = (tid < tiles_per_dev).sum(axis=1)
    working = counts[counts > 0]
    mean = working.mean() if working.size else 0.0
    skew = float(counts.max() / mean) if mean > 0 else 1.0
    return {"counts": counts, "skew": skew}


def _subselect_rows(stacked: dict, keys: tuple, n_devices: int):
    """Per-device referenced-row selection for a shared row stack.

    Each shard references only the rows its items index, so this computes
    the (sorted, deduplicated) referenced-row list per device, remaps every
    index array in `keys` to sub-stack-local values IN PLACE, and returns
    the (n_devices, r_max) selection — the caller gathers those rows into
    a per-device sub-stack.  Returns None when nothing references the
    stack."""
    arrs = [stacked[k] for k in keys if k in stacked]
    if not arrs or not any((a >= 0).any() for a in arrs):
        return None
    hi = max(int(a.max()) for a in arrs)
    rows_per_dev = []
    for d in range(n_devices):
        vals = np.concatenate([a[d][a[d] >= 0].ravel() for a in arrs])
        rows_per_dev.append(np.unique(vals).astype(np.int32))
    r_max = max(1, max(len(r) for r in rows_per_dev))
    sel = np.zeros((n_devices, r_max), np.int32)
    for d in range(n_devices):
        r = rows_per_dev[d]
        sel[d, : len(r)] = r
        remap = np.full(hi + 1, -1, np.int32)
        remap[r] = np.arange(len(r), dtype=np.int32)
        for k in keys:
            if k not in stacked:
                continue
            a = stacked[k][d]
            stacked[k][d] = np.where(a >= 0, remap[np.clip(a, 0, hi)], a)
    return sel


def partition_plan(items: dict, big_lines, num_tiles: int, n_devices: int,
                   patterns=None, clips=None):
    """Split a lowered plan into per-device shards.

    Returns (stacked_items, stacked_big, tiles_per_device) where every array
    gains a leading device axis; tile ids are remapped device-local and
    padding items carry the device-local scratch id.

    big_lines may be a tuple of per-width class arrays (see
    render_plan._pack); classes are flattened into one max-width array here
    — per-device big row counts vary anyway, so the class split would not
    change the padded shard shape.

    patterns/clips: the scene-static shared row stacks as host numpy
    arrays; their per-device sub-stacks gather here and ride the items dict
    as "_sub_pat"/"_sub_clip".  The frame-dynamic pool's selection rides as
    "_sel_pool", gathered per frame.
    """
    if isinstance(big_lines, (tuple, list)):
        big_lines = _flatten_big_classes(big_lines)
    tiles_per_dev = -(-num_tiles // n_devices)
    tile_id = items["tile_id"]
    valid = tile_id < num_tiles
    dev_of_tile, slot_of_tile, permuted = _assign_tiles(
        tile_id[valid], num_tiles, n_devices, tiles_per_dev
    )
    safe_tid = np.clip(tile_id, 0, num_tiles - 1)
    device_of = np.where(valid, dev_of_tile[safe_tid], n_devices)  # padding -> drop

    counts = [(device_of == d).sum() for d in range(n_devices)]
    max_count = max(max(counts), 1)
    n_dev = CHUNK_ITEMS * _pow2_pad(-(-max_count // CHUNK_ITEMS), 1)

    big_counts = []
    big_rows_per_dev = []
    for d in range(n_devices):
        sel = device_of == d
        rows = items["big_idx"][sel]
        rows = np.unique(rows[rows >= 0])
        big_rows_per_dev.append(rows)
        big_counts.append(len(rows))
    if big_lines.shape[0] and max(big_counts):
        m_dev = CHUNK_BIG * max(1, _pow2_pad(-(-max(big_counts) // CHUNK_BIG), 1))
        s_big = big_lines.shape[1]
    else:
        m_dev, s_big = 0, 0

    items = {k: v for k, v in items.items() if not k.startswith("_")}
    # the collapsed-run field stack is plan-global: it is sub-selected per
    # device below, never split along the item axis
    field_stack = items.pop("field", None)
    # padding rows follow the single-device pack's pad conventions: index
    # fields pad with -1 (a zero would read as "uses row 0")
    pad_fill = {
        "big_idx": -1, "tex_idx": -1, "mask_idx": -1,
        "clip_idx": -1, "pat_idx": -1, "field_idx": -1,
        "stop_offsets": 1.0, "pat_wh": 1.0,
    }
    stacked = {
        k: np.full((n_devices, n_dev, *v.shape[1:]), pad_fill.get(k, 0), v.dtype)
        for k, v in items.items()
    }
    stacked_big = np.zeros((n_devices, m_dev, s_big, 4), DEVICE_FLOAT)

    for d in range(n_devices):
        sel = np.where(device_of == d)[0]
        if permuted and len(sel):
            # the scene kernel's run table needs each shard's tile ids
            # monotonic; the balanced assignment permutes slots, so re-sort
            # the shard by slot — z order within a tile is preserved
            # (stable), and tiles composite independently
            slots = slot_of_tile[np.clip(tile_id[sel], 0, num_tiles - 1)]
            sel = sel[np.argsort(slots, kind="stable")]
        k = len(sel)
        for key, value in items.items():
            shard = stacked[key][d]
            shard[:k] = value[sel]
            if key == "tile_id":
                shard[:k] = slot_of_tile[np.clip(value[sel], 0, num_tiles - 1)]
                shard[k:] = tiles_per_dev  # device-local scratch/drop id
            elif key == "big_idx" and k:
                rows = big_rows_per_dev[d]
                remap = np.full(big_lines.shape[0] + 1, -1, np.int32)
                remap[rows] = np.arange(len(rows), dtype=np.int32)
                shard[:k] = remap[np.where(shard[:k] >= 0, shard[:k], big_lines.shape[0])]
        if m_dev and len(big_rows_per_dev[d]):
            stacked_big[d, : len(big_rows_per_dev[d])] = big_lines[big_rows_per_dev[d]]

    for d in range(n_devices):
        k = (device_of == d).sum()
        stacked["tile_id"][d, k:] = tiles_per_dev

    if permuted:
        # canvas row position of every global tile: the assembled
        # (n_devices * tiles_per_dev) canvas is gathered by it to restore
        # the global tile order after the balanced split
        stacked["_pos"] = (
            dev_of_tile.astype(np.int64) * tiles_per_dev
            + slot_of_tile.astype(np.int64)
        )

    if (stacked["pat_idx"] >= 0).any():
        # per-shard companions of the JAX package's fused pattern pool,
        # kept so the host arrays match its own
        counts = [(stacked["pat_idx"][d] >= 0).sum() for d in range(n_devices)]
        qpad = _pow2_pad(max(max(counts), 1), 1)
        rows = np.zeros((n_devices, qpad), np.int32)
        pos = np.full((n_devices, n_dev), 1 << 30, np.int32)
        for d in range(n_devices):
            sel = np.nonzero(stacked["pat_idx"][d] >= 0)[0]
            if len(sel):
                rows[d, : len(sel)] = sel
                rows[d, len(sel) :] = sel[0]
                pos[d, sel] = np.arange(len(sel), dtype=np.int32)
        stacked["pat_rows"] = rows
        stacked["pat_pos"] = pos

    # shard the shared row stacks instead of replicating them: index arrays
    # remap to sub-stack-local rows here
    if field_stack is not None:
        sel_f = _subselect_rows(stacked, ("field_idx",), n_devices)
        if sel_f is not None:
            stacked["field"] = field_stack[sel_f]
        else:
            stacked["field"] = np.broadcast_to(
                field_stack[None], (n_devices, *field_stack.shape)
            ).copy()
    static_stacks = {"pat": patterns, "clip": clips}
    for name, keys in (
        ("pool", ("tex_idx", "mask_idx")),
        ("pat", ("pat_idx",)),
        ("clip", ("clip_idx",)),
    ):
        sel = _subselect_rows(stacked, keys, n_devices)
        if sel is None:
            continue
        static = static_stacks.get(name)
        if static is not None and isinstance(static, np.ndarray):
            # scene-static: gather the sub-stack on host once
            stacked["_sub_" + name] = np.ascontiguousarray(static[sel])
        else:
            stacked["_sel_" + name] = sel

    return stacked, stacked_big, tiles_per_dev


class Shard(NamedTuple):
    """One shard of a sharded item stream."""

    index: int  # its flat index in the mesh
    plan: DevicePlan | None  # its items on its device; None when it has none
    pool_rows: torch.Tensor | None  # (r,) int64 pool rows it reads, on the home device


class ShardedPlan(NamedTuple):
    """An item stream partitioned over a mesh (sharded_exec_fn): the shards
    this process runs, and how their canvases assemble."""

    shards: list  # Shard per local shard
    n_shards: int
    tiles_per_dev: int
    tile: int
    grid: tuple  # the whole stream's (grid_h, grid_w)
    pos: torch.Tensor | None  # (num_tiles,) int64 canvas row of each tile, or None
    home: torch.device  # where the pool and the assembled canvas live
    group: Any  # torch.distributed group over the shards' ranks, or None
    balance: dict  # shard_balance of the partition

    @property
    def num_tiles(self) -> int:
        return self.grid[0] * self.grid[1]


def sharded_exec_fn(mesh):
    """The partitioner render_plan.upload_program shards item streams with:
    partition(items, bigs, clips, tile, grid, home, patterns) -> ShardedPlan.

    It splits one packed item stream over the mesh's shards (all its
    entries, the "data" and "seg" axes flattened, as the JAX package
    does), once, and uploads each local shard's items, big classes, clip /
    field / pattern sub-stacks as a DevicePlan on that shard's device.
    patterns: the plan's pattern atlas as a host array, or None; home: the
    device of the pool and the assembled canvas."""
    from ..render_plan import _upload_items

    n_shards = mesh.size
    devices = list(mesh.devices.flat)

    def partition(items, bigs, clips, tile, grid, home, patterns=None):
        num_tiles = int(grid[0]) * int(grid[1])
        has_clips = clips is not None and clips.shape[0] > 0
        st_items, st_big, tpd = partition_plan(
            items, bigs, num_tiles, n_shards, patterns=patterns,
            clips=clips if has_clips else None,
        )
        keys = [k for k in st_items if not k.startswith("_") and k != "field"]
        pool_sel = st_items.get("_sel_pool")
        shards = []
        for d in mesh.local_shards:
            dev = devices[d]
            k = int((st_items["tile_id"][d] < tpd).sum())
            if k == 0:
                shards.append(Shard(d, None, None))
                continue
            # padding items (tile id tpd) are dropped: they follow the real
            # ones, and the run table never reaches them
            shard_items = {key: st_items[key][d][:k] for key in keys}
            if "field" in st_items:
                shard_items["field"] = st_items["field"][d]
            sub_clips = st_items["_sub_clip"][d] if "_sub_clip" in st_items else None
            sub_pat = st_items.get("_sub_pat")
            atlas = None if sub_pat is None else torch.from_numpy(
                np.ascontiguousarray(sub_pat[d], np.float32)).to(dev)
            big = (st_big[d],) if st_big.shape[1] else ()
            plan = _upload_items(shard_items, big, sub_clips, tile, (1, tpd), dev, atlas)
            rows = None if pool_sel is None else torch.as_tensor(
                pool_sel[d].astype(np.int64), device=home)
            shards.append(Shard(d, plan, rows))
        pos = st_items.get("_pos")
        return ShardedPlan(
            shards=shards, n_shards=n_shards, tiles_per_dev=tpd, tile=int(tile),
            grid=tuple(int(g) for g in grid),
            pos=None if pos is None else torch.as_tensor(pos, device=home),
            home=torch.device(home), group=mesh.group,
            balance=shard_balance(st_items, tpd),
        )

    return partition


def sharded_render_plan(plan: ShardedPlan, execute, pool=None):
    """Run a sharded item stream: canvas tiles (num_tiles, T, T, 4) on the
    home device.

    execute(DevicePlan, pool | None) renders one shard (the kernels, or
    their plain versions); each shard reads the pool rows it names, gathered
    from `pool` by the selection made at upload.  A shard without items
    renders transparent tiles.  Across processes every rank runs its own
    shards and all_gathers the others', so every rank ends with the whole
    canvas."""
    t = plan.tile
    parts = []
    for shard in plan.shards:
        if shard.plan is None:
            parts.append(torch.zeros((plan.tiles_per_dev, t, t, 4), dtype=torch.float32,
                                     device=plan.home))
            continue
        dev = shard.plan.lines.device
        sub_pool = None
        if shard.pool_rows is not None and pool is not None:
            sub_pool = pool.index_select(0, shard.pool_rows).to(dev)
        parts.append(execute(shard.plan, sub_pool).to(plan.home))
    canvas = torch.cat(parts) if len(parts) > 1 else parts[0]
    if plan.group is not None:
        import torch.distributed as dist

        gathered = [torch.empty_like(canvas) for _ in range(dist.get_world_size(plan.group))]
        dist.all_gather(gathered, canvas, group=plan.group)
        canvas = torch.cat(gathered)
    if plan.pos is not None:
        # balanced split: restore the global tile order
        return canvas.index_select(0, plan.pos)
    return canvas[: plan.num_tiles]
