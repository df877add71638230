"""Wrappers of the hand-written CUDA kernels (csrc/prepass.cu, csrc/scene.cu,
csrc/blur_chunk.cu, csrc/pool_rows.cu, csrc/winding.cu).

Each wrapper checks device, dtype, shape and contiguity, allocates the
output, launches its kernel on PyTorch's current stream through the ctypes
library (ops/cuda_lib.py) and raises if the launch returns a CUDA error.
Tensors on the CPU go to the kernel's plain PyTorch version
(ops/batch_exec.py, ops/filter_batch.apply_level, ops/coverage.winding)
instead; that is the only case that does.  A tensor on any other device
raises.

Each wrapper counts its kernel launches in its `launches` attribute, so a
run can show that its main path went through the kernels
(reset_launch_counts sets them all to 0).  The whole-image winding kernel
has two entries, `winding` (one list) and `winding_batch` (many lists,
one launch); both count on `winding.launches`.
"""

from __future__ import annotations

import ctypes
from collections.abc import Sequence
from typing import NamedTuple

import numpy as np
import torch

from . import batch_exec, coverage, filter_batch
from .batch_exec import MAX_STOPS, N_FPARAMS, N_IPARAMS, SMALL_SEGS, DevicePlan

# tile sizes the kernels are instantiated for (a template parameter)
KERNEL_TILES = (16, 32, 64)
# classes one prepass launch takes (csrc/kernels.h SVGR_PREPASS_MAX_CLASSES)
PREPASS_MAX_CLASSES = 32
# the whole-image winding kernel's output block (csrc/winding.cu) and the
# columns of its batch table (SVGR_WINDING_TABLE_COLS)
WINDING_BLOCK = (8, 128)
WINDING_TABLE_COLS = 6
_INT32_MAX = 2**31 - 1


def _kernel_device(device: torch.device, what: str) -> bool:
    """True for a CUDA device, False for the CPU; raises for anything else."""
    if device.type == "cuda":
        return True
    if device.type == "cpu":
        return False
    raise ValueError(f"{what}: unsupported device {device}")


def _check(t: torch.Tensor, name: str, dtype, shape, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if len(shape) != t.dim() or any(
        s is not None and s != d for s, d in zip(shape, t.shape)
    ):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _raise_on(rc: int, kernel: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{kernel} launch failed with CUDA error {rc}")


def _ptr(t):
    return None if t is None else t.data_ptr()


def prepass_winding(arrays, t_size: int):
    """Winding stack of the big segment classes: (sum M_c + 1, T, T) f32.

    arrays: per class (M_c, S_c, 4) f32 padded edge lists; the last row of
    the result is a zero scratch row.  Returns None when there are no rows.
    On the card one launch computes every class and the zero row.
    """
    arrays = [a for a in arrays if a is not None and a.shape[0]]
    if not arrays:
        return None
    device = arrays[0].device
    if not _kernel_device(device, "prepass_winding"):
        return batch_exec._prepass_winding(arrays, t_size)
    if t_size not in KERNEL_TILES:
        raise ValueError(f"prepass_winding: tile {t_size} not in {KERNEL_TILES}")
    n = len(arrays)
    if n > PREPASS_MAX_CLASSES:
        raise ValueError(f"prepass_winding: {n} classes > {PREPASS_MAX_CLASSES}")
    for i, a in enumerate(arrays):
        _check(a, f"class {i}", torch.float32, (None, None, 4), device)
    from . import cuda_lib

    lib = cuda_lib.load()
    total = sum(a.shape[0] for a in arrays)
    out = torch.empty((total + 1, t_size, t_size), dtype=torch.float32, device=device)
    rc = lib.svgr_prepass_winding(
        (ctypes.c_void_p * n)(*(a.data_ptr() for a in arrays)),
        (ctypes.c_int * n)(*(a.shape[0] for a in arrays)),
        (ctypes.c_int * n)(*(a.shape[1] for a in arrays)),
        n, out.data_ptr(), t_size, _stream(device),
    )
    _raise_on(rc, "prepass_winding")
    prepass_winding.launches += 1
    return out


prepass_winding.launches = 0


def scene_tiles(plan: DevicePlan, big_wind, pool=None):
    """Canvas tiles (num_tiles, T, T, 4) f32 premultiplied of a plan.

    big_wind: the prepass stack of plan.bigs, or None when it has none.
    pool: the isolation-pass pool (P, T, T, 4) that texture and mask items
    read; required when the plan reads it.
    """
    device = plan.lines.device
    if plan.reads_pool and pool is None:
        raise ValueError("scene_tiles: the plan reads the pass pool, none given")
    if not _kernel_device(device, "scene_tiles"):
        return batch_exec._scene_tiles(plan, big_wind, pool)
    t = plan.tile
    if t not in KERNEL_TILES:
        raise ValueError(f"scene_tiles: tile {t} not in {KERNEL_TILES}")
    n, segs, _ = plan.lines.shape
    k_stops = plan.stop_offsets.shape[1]
    if segs > SMALL_SEGS or not 1 <= k_stops <= MAX_STOPS:
        raise ValueError(f"scene_tiles: {segs} inline edges / {k_stops} stops")
    f32, i32 = torch.float32, torch.int32
    _check(plan.lines, "lines", f32, (n, segs, 4), device)
    _check(plan.carry, "carry", f32, (n, t), device)
    if plan.runs is None:
        raise ValueError("scene_tiles: the plan has no run table (batch_exec.tile_runs)")
    _check(plan.runs, "runs", i32, (plan.num_tiles + 1,), device)
    _check(plan.iparams, "iparams", i32, (n, N_IPARAMS), device)
    _check(plan.fparams, "fparams", f32, (n, N_FPARAMS), device)
    _check(plan.stop_offsets, "stop_offsets", f32, (n, k_stops), device)
    _check(plan.stop_colors, "stop_colors", f32, (n, k_stops, 4), device)
    if big_wind is not None:
        _check(big_wind, "big_wind", f32, (None, t, t), device)
    if plan.clips is not None:
        _check(plan.clips, "clips", f32, (None, t, t), device)
    if plan.field is not None:
        _check(plan.field, "field", f32, (None, t, t, 4), device)
    if pool is not None:
        _check(pool, "pool", f32, (None, t, t, 4), device)
    if plan.lines.data_ptr() % 16 or plan.stop_colors.data_ptr() % 16:
        raise ValueError("scene_tiles: lines and stop_colors must be 16-byte aligned")
    atlas = plan.patterns  # upload sets it for every plan with pattern items
    if atlas is not None:
        _check(atlas, "patterns", f32, (None, None, None, 4), device)
    from . import cuda_lib

    lib = cuda_lib.load()
    num_tiles = plan.num_tiles
    out = torch.empty((num_tiles, t, t, 4), dtype=f32, device=device)
    rc = lib.svgr_scene_tiles(
        plan.lines.data_ptr(), segs, plan.carry.data_ptr(),
        plan.runs.data_ptr(), plan.iparams.data_ptr(),
        plan.fparams.data_ptr(), plan.stop_offsets.data_ptr(),
        plan.stop_colors.data_ptr(), k_stops, _ptr(big_wind),
        _ptr(plan.clips), _ptr(plan.field), _ptr(pool), _ptr(atlas),
        0 if atlas is None else atlas.shape[1], 0 if atlas is None else atlas.shape[2],
        out.data_ptr(), num_tiles, t, _stream(device),
    )
    _raise_on(rc, "scene_tiles")
    scene_tiles.launches += 1
    return out


scene_tiles.launches = 0


def execute_items_fused(plan: DevicePlan, pool=None):
    """Whole-plan execution: the prepass, then the scene tiles."""
    return scene_tiles(plan, prepass_winding(plan.bigs, plan.tile), pool)


def blur_chunk(canvas, level: filter_batch.BlurLevel, t_size: int, linear_rgb: bool):
    """Every out-span tile (level.tiles, T, T, 4) f32 of a level's blur
    chunks, each chunk's at its first out tile (table column LT_OUT).

    canvas: the level's pass rows (R, T, T, 4); level: its chunks packed
    by filter_batch.pack_level on the canvas's device.  The level's pool
    update picks level.out_idx from the result.  On the card one launch
    computes every chunk.
    """
    device = canvas.device
    if not _kernel_device(device, "blur_chunk"):
        return filter_batch.apply_level(canvas, level, t_size, linear_rgb)
    t = t_size
    if t not in KERNEL_TILES:
        raise ValueError(f"blur_chunk: tile {t} not in {KERNEL_TILES}")
    n = level.table.shape[0]
    f32, i32 = torch.float32, torch.int32
    _check(canvas, "canvas", f32, (None, t, t, 4), device)
    _check(level.table, "table", i32, (n, filter_batch.LEVEL_TABLE_COLS), device)
    for name in ("lut", "src_alpha"):
        _check(getattr(level, name), name, i32, (None,), device)
    for name in ("bh", "bw"):
        _check(getattr(level, name), name, f32, (None,), device)
    for name in ("hband", "wband"):
        _check(getattr(level, name), name, i32, (None, 2), device)
    from . import cuda_lib

    lib = cuda_lib.load()
    out = torch.empty((level.tiles, t, t, 4), dtype=f32, device=device)
    rc = lib.svgr_blur_level(
        canvas.data_ptr(), canvas.shape[0], level.lut.data_ptr(), level.bh.data_ptr(),
        level.bw.data_ptr(), level.src_alpha.data_ptr(), level.hband.data_ptr(),
        level.wband.data_ptr(), level.table.data_ptr(), n, level.tiles,
        int(linear_rgb), out.data_ptr(), t, _stream(device),
    )
    _raise_on(rc, "blur_chunk")
    blur_chunk.launches += 1
    return out


blur_chunk.launches = 0


def pool_rows(pool, src, src_idx, dst_idx):
    """pool[dst_idx] = src[src_idx] in place; returns pool.

    pool (P, T, T, 4) and src (R, T, T, 4) f32; src_idx / dst_idx (n,)
    int32 on the same device (indices out of range are skipped on the
    card).
    """
    device = pool.device
    if not _kernel_device(device, "pool_rows"):
        return batch_exec._pool_rows(pool, src, src_idx, dst_idx)
    t = pool.shape[1]
    if t not in KERNEL_TILES:
        raise ValueError(f"pool_rows: tile {t} not in {KERNEL_TILES}")
    n = src_idx.shape[0]
    if n == 0:
        return pool
    f32, i32 = torch.float32, torch.int32
    _check(pool, "pool", f32, (None, t, t, 4), device)
    _check(src, "src", f32, (None, t, t, 4), device)
    _check(src_idx, "src_idx", i32, (n,), device)
    _check(dst_idx, "dst_idx", i32, (n,), device)
    from . import cuda_lib

    lib = cuda_lib.load()
    rc = lib.svgr_pool_rows(
        pool.data_ptr(), pool.shape[0], src.data_ptr(), src.shape[0],
        src_idx.data_ptr(), dst_idx.data_ptr(), n, t, _stream(device),
    )
    _raise_on(rc, "pool_rows")
    pool_rows.launches += 1
    return pool


pool_rows.launches = 0

def winding(lines, height: int, width: int):
    """Winding field (height, width) f32 of one edge list (S, 4) f32 in
    image pixel coordinates (rows a0, a1, b0, b1; zero rows are padding).

    The one-list case of winding_batch's kernel, on a list already on the
    card: its one table entry travels by value, nothing is uploaded."""
    device = lines.device
    if not _kernel_device(device, "winding"):
        return coverage.winding(lines, height, width)
    height, width = int(height), int(width)
    if height < 0 or width < 0:
        raise ValueError(f"winding: bad size {height} x {width}")
    _check(lines, "lines", torch.float32, (None, 4), device)
    out = torch.empty((height, width), dtype=torch.float32, device=device)
    if height == 0 or width == 0:
        return out
    from . import cuda_lib

    lib = cuda_lib.load()
    rc = lib.svgr_winding(lines.data_ptr(), lines.shape[0], out.data_ptr(),
                          height, width, _stream(device))
    _raise_on(rc, "winding")
    winding.launches += 1
    return out


winding.launches = 0


class WindingBatch(NamedTuple):
    """A batch of edge lists uploaded for one whole-image winding launch."""

    edges: torch.Tensor  # (sum S_i, 4) f32, the lists back to back
    table: torch.Tensor  # (n, WINDING_TABLE_COLS) int32, csrc/kernels.h
    sizes: tuple  # (h_i, w_i) per mask
    offsets: tuple  # each field's offset in the flat output
    pixels: int  # the flat output's length
    blocks: int  # the launch's blocks


def _mask_table(counts, sizes):
    """The (n, WINDING_TABLE_COLS) int64 table of a batch (edge offset,
    edge count, height, width, output offset, first block) and its totals
    (edges, pixels, blocks)."""
    counts = np.asarray(counts, np.int64).reshape(-1)
    hw = np.asarray(sizes, np.int64).reshape(-1, 2)
    rows, cols = WINDING_BLOCK
    pixels = hw[:, 0] * hw[:, 1]
    blocks = -(-hw[:, 0] // rows) * -(-hw[:, 1] // cols)

    def starts(x):
        return np.cumsum(x) - x

    table = np.stack([starts(counts), counts, hw[:, 0], hw[:, 1], starts(pixels),
                      starts(blocks)], axis=1)
    return table, (int(counts.sum()), int(pixels.sum()), int(blocks.sum()))


def upload_winding_batch(edge_lists, sizes, device) -> WindingBatch:
    """Pack edge lists and their table into one pinned host buffer and
    upload it with one copy.

    edge_lists: per mask an (S_i, 4) f32 array (numpy) in that mask's pixel
    coordinates; sizes: per mask (h_i, w_i); device: a CUDA device.
    """
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"upload_winding_batch: {device} is not a CUDA device")
    sizes = tuple((int(h), int(w)) for h, w in sizes)
    if len(edge_lists) != len(sizes):
        raise ValueError("upload_winding_batch: one size per edge list")
    if any(h < 0 or w < 0 for h, w in sizes):
        raise ValueError(f"upload_winding_batch: bad sizes {sizes}")
    lists = [np.asarray(e, np.float32).reshape(-1, 4) for e in edge_lists]
    table, (segs, pixels, blocks) = _mask_table([e.shape[0] for e in lists], sizes)
    n_edge = 4 * segs
    if max(pixels, blocks, n_edge) > _INT32_MAX:
        raise ValueError("upload_winding_batch: the batch exceeds 32-bit offsets")
    host = torch.empty(n_edge + table.size, dtype=torch.float32, pin_memory=True)
    buf = host.numpy()
    if n_edge:
        np.concatenate(lists, axis=0, out=buf[:n_edge].reshape(-1, 4))
    buf[n_edge:].view(np.int32)[:] = table.reshape(-1)
    dev_buf = host.to(device, non_blocking=True)
    return WindingBatch(
        edges=dev_buf[:n_edge].view(-1, 4),
        table=dev_buf[n_edge:].view(torch.int32).view(-1, WINDING_TABLE_COLS),
        sizes=sizes, offsets=tuple(int(o) for o in table[:, 4]),
        pixels=pixels, blocks=blocks,
    )


class BatchFields(Sequence):
    """The fields of one batch launch: item i is mask i's (h_i, w_i) field,
    a view of the flat output made when it is read (so a launch costs the
    host no per-mask work)."""

    def __init__(self, out: torch.Tensor, batch: WindingBatch):
        self.out, self._batch = out, batch

    def __len__(self) -> int:
        return len(self._batch.sizes)

    def __getitem__(self, i: int) -> torch.Tensor:
        (h, w), o = self._batch.sizes[i], self._batch.offsets[i]
        return self.out[o:o + h * w].view(h, w)


def launch_winding_batch(batch: WindingBatch) -> BatchFields:
    """One launch of the winding kernel over an uploaded batch."""
    device = batch.edges.device
    out = torch.empty(batch.pixels, dtype=torch.float32, device=device)
    if batch.blocks:
        from . import cuda_lib

        lib = cuda_lib.load()
        rc = lib.svgr_winding_batch(
            batch.edges.data_ptr(), batch.table.data_ptr(), len(batch.sizes),
            batch.blocks, out.data_ptr(), _stream(device),
        )
        _raise_on(rc, "winding_batch")
        winding.launches += 1
    return BatchFields(out, batch)


def winding_batch(edge_lists, sizes, device):
    """Winding fields (h_i, w_i) f32 of many edge lists (S_i, 4) f32, each
    in its own image pixel coordinates (zero rows are padding).

    On a CUDA device: the lists and a per-mask table travel in one pinned
    upload, and one launch of the winding kernel computes every field (the
    same kernel as `winding`, so each field equals its one-list result
    bit for bit), returned as BatchFields.  On the CPU: the plain version,
    coverage.winding per list, returned as a list.
    """
    device = torch.device(device)
    if not _kernel_device(device, "winding_batch"):
        return [coverage.winding(torch.as_tensor(np.asarray(e, np.float32)).reshape(-1, 4),
                                 int(h), int(w))
                for e, (h, w) in zip(edge_lists, sizes, strict=True)]
    return launch_winding_batch(upload_winding_batch(edge_lists, sizes, device))


def winding_uniform(lines, height: int, width: int):
    """Winding fields (N, height, width) f32 of N edge lists lines (N, S, 4)
    f32 of one size, in image pixel coordinates (zero rows are padding).

    On a CUDA device the lists are already there: one launch of the winding
    kernel computes every field (the batch table is the only upload).  On
    the CPU: the plain version, coverage.winding per list."""
    device = lines.device
    height, width = int(height), int(width)
    if not _kernel_device(device, "winding_uniform"):
        return torch.stack([coverage.winding(e, height, width) for e in lines]) \
            if lines.shape[0] else lines.new_zeros((0, height, width))
    _check(lines, "lines", torch.float32, (None, None, 4), device)
    n, segs, _ = lines.shape
    table, (_segs, pixels, blocks) = _mask_table([segs] * n, [(height, width)] * n)
    if max(pixels, blocks, 4 * n * segs) > _INT32_MAX:
        raise ValueError("winding_uniform: the batch exceeds 32-bit offsets")
    batch = WindingBatch(
        edges=lines.view(-1, 4),
        table=torch.from_numpy(table.astype(np.int32)).to(device),
        sizes=((height, width),) * n, offsets=tuple(int(o) for o in table[:, 4]),
        pixels=pixels, blocks=blocks,
    )
    return launch_winding_batch(batch).out.view(n, height, width)


KERNELS = (prepass_winding, scene_tiles, blur_chunk, pool_rows, winding)


def reset_launch_counts() -> None:
    for kernel in KERNELS:
        kernel.launches = 0
