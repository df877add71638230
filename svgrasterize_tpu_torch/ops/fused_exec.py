"""Wrappers of the hand-written CUDA kernels (csrc/prepass.cu, csrc/scene.cu,
csrc/blur_chunk.cu, csrc/pool_rows.cu, csrc/winding.cu, csrc/part_io.cu,
csrc/untile.cu, csrc/fe_blur.cu, csrc/fe_turbulence.cu).

Each wrapper checks device, dtype, shape and contiguity, allocates the
output, launches its kernel on PyTorch's current stream through the ctypes
library (ops/cuda_lib.py) and raises if the launch returns a CUDA error.
Tensors on the CPU go to the kernel's plain PyTorch version
(ops/batch_exec.py, ops/filter_batch.apply_level, ops/coverage.winding,
ops/part_io.py) instead; that is the only case that does.  A tensor on any
other device raises.  `untile`, `fe_blur` and `fe_turbulence` take CUDA
tensors alone: their plain versions are render_plan.tiles_to_layer's reshape
and permute, ops/blur.fe_blur and ops/turbulence.turbulence_region, and their
callers (tiles_to_layer, Layer.convolve, filter._apply) choose by the
device.

Each wrapper counts its kernel launches in its `launches` attribute, so a
run can show that its main path went through the kernels
(reset_launch_counts sets them all to 0).  The whole-image winding kernel
has two entries, `winding` (one list) and `winding_batch` (many lists,
one launch); both count on `winding.launches`.
"""

from __future__ import annotations

import ctypes
import functools
from collections.abc import Sequence
from typing import NamedTuple

import numpy as np
import torch

from ..core.layer import Layer
from . import batch_exec, coverage, filter_batch, part_io
from .batch_exec import MAX_STOPS, N_FPARAMS, N_IPARAMS, SMALL_SEGS, DevicePlan

# tile sizes the kernels are instantiated for (a template parameter)
KERNEL_TILES = (16, 32, 64, 128)
# classes one prepass launch takes (csrc/kernels.h SVGR_PREPASS_MAX_CLASSES)
PREPASS_MAX_CLASSES = 32
# the whole-image winding kernel's block (csrc/winding.cu, a row scanline): a
# band of 8 rows, one warp each, by a segment of 256 columns, whose partial
# cells and carries a warp keeps in shared memory.  Its work is the (edge,
# row) pairs and the cells they cross, not the pixels: small masks are
# paced by a block's latency times the waves of blocks, long lists by the
# instructions of the pairs' deposit steps; narrower segments cost small
# masks more waves, wider ones give long rows fewer warps.  And the columns
# of its batch table (SVGR_WINDING_TABLE_COLS)
WINDING_BLOCK = (8, 256)
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


def _gamma(source_linear: bool, target_linear: bool) -> int:
    """csrc/part_io.cu's colorspace step: 0 none, 1 to linear, 2 to sRGB."""
    if source_linear == target_linear:
        return 0
    return 1 if target_linear else 2


def part_entry(canvas, part, viewport, linear_rgb: bool, t_size: int):
    """A filter part's seeds (SourceAlpha, SourceGraphic) as Filter.seeds
    makes them from its source crop: canvas (R, T, T, 4) f32 holds the
    level's pass rows in the canvas's state (premultiplied, linear_rgb);
    part a render_plan._PartFilter.  One launch writes both images."""
    device = canvas.device
    if not _kernel_device(device, "part_entry"):
        return part_io.part_entry(canvas, part, viewport, linear_rgb, t_size)
    t = t_size
    if t not in KERNEL_TILES:
        raise ValueError(f"part_entry: tile {t} not in {KERNEL_TILES}")
    f32 = torch.float32
    _check(canvas, "canvas", f32, (None, t, t, 4), device)
    first, count = part.rows
    if first < 0 or count < 0 or first + count > canvas.shape[0]:
        raise ValueError(f"part_entry: rows {part.rows} of a canvas of {canvas.shape[0]}")
    _si0, _sj0, nsi, nsj = part.span
    _check(part.slots, "slots", torch.int32, (nsi * nsj,), device)
    amask = part.consts.amask
    _check(amask, "amask", f32, (4,), device)
    (r0, r1, c0, c1), offset = part_io.crop_window(part, viewport, t)
    rows, cols = range(nsi * t)[r0:r1], range(nsj * t)[c0:c1]  # slice bounds
    h, w = len(rows), len(cols)
    graphic = torch.empty((h, w, 4), dtype=f32, device=device)
    alpha = torch.empty((h, w, 4), dtype=f32, device=device)
    linear = part.flt.linear
    if h and w:
        from . import cuda_lib

        lib = cuda_lib.load()
        rc = lib.svgr_part_entry(
            canvas[first:].data_ptr(), count, part.slots.data_ptr(), nsj,
            rows.start, cols.start, h, w, _gamma(linear_rgb, linear), amask.data_ptr(),
            graphic.data_ptr(), alpha.data_ptr(), t, _stream(device),
        )
        _raise_on(rc, "part_entry")
        part_entry.launches += 1
    return (Layer(alpha, offset, pre_alpha=True, linear_rgb=linear),
            Layer(graphic, offset, pre_alpha=False, linear_rgb=linear))


part_entry.launches = 0


def part_exit(pool, result: Layer, part, viewport, linear_rgb: bool, t_size: int):
    """Write a filter part's chain result into its pool rows in place, as
    ops/part_io.part_exit does; returns pool.  result: the chain's Layer in
    any alpha mode and colorspace, 1 or 4 channels, any strides."""
    device = pool.device
    if not _kernel_device(device, "part_exit"):
        return part_io.part_exit(pool, result, part, viewport, linear_rgb, t_size)
    t = t_size
    if t not in KERNEL_TILES:
        raise ValueError(f"part_exit: tile {t} not in {KERNEL_TILES}")
    _check(pool, "pool", torch.float32, (None, t, t, 4), device)
    image = result.image
    if image.device != device or image.dtype != torch.float32 or image.dim() != 3 \
            or image.shape[2] not in (1, 4):
        raise ValueError(f"part_exit: result {tuple(image.shape)} {image.dtype} on"
                         f" {image.device}, expected (h, w, 1 or 4) f32 on {device}")
    n = part.src_idx.shape[0]
    _check(part.src_idx, "src_idx", torch.int32, (n,), device)
    _check(part.dst_idx, "dst_idx", torch.int32, (n,), device)
    if n == 0:
        return pool
    _di0, _dj0, nti, ntj = part.out
    off_r, off_c = part_io.exit_offset(result, part, viewport, t)
    h, w, channels = image.shape
    gamma = _gamma(result.linear_rgb, linear_rgb) if channels == 4 else 0
    from . import cuda_lib

    lib = cuda_lib.load()
    rc = lib.svgr_part_exit(
        pool.data_ptr(), pool.shape[0], image.data_ptr(), h, w, channels,
        *image.stride(), int(result.pre_alpha), gamma, off_r, off_c, ntj, nti * ntj,
        part.src_idx.data_ptr(), part.dst_idx.data_ptr(), n, t, _stream(device),
    )
    _raise_on(rc, "part_exit")
    part_exit.launches += 1
    return pool


part_exit.launches = 0


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
    sizes: Sequence  # (h_i, w_i) per mask
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


class _Staging:
    """upload_winding_batch's pinned host memory for one CUDA device: two
    grow-only buffers taken in turn, each guarded by an event recorded after
    the copy out of it.  A batch is packed while the previous batch's copy
    may still run; the host waits only for a copy two batches back."""

    def __init__(self):
        self.hosts = [None, None]
        self.copied = [torch.cuda.Event(), torch.cuda.Event()]
        self.turn = 0

    def take(self, n: int):
        """n f32 of the next buffer once its last copy is done, and the event
        to record after the copy out of it."""
        i, self.turn = self.turn, self.turn ^ 1
        self.copied[i].synchronize()  # at once unless that copy is still queued
        host = self.hosts[i]
        if host is None or host.numel() < n:
            host = self.hosts[i] = torch.empty(
                max(n, 2 * (0 if host is None else host.numel())), dtype=torch.float32,
                pin_memory=True)
        return host[:n], self.copied[i]


_staging: dict = {}  # CUDA device -> _Staging


def upload_winding_batch(edge_lists, sizes, device) -> WindingBatch:
    """Pack edge lists and their table into one of the device's pinned
    staging buffers and upload it with one copy.

    edge_lists: per mask an (S_i, 4) float array (numpy) in that mask's
    pixel coordinates; sizes: per mask (h_i, w_i); device: a CUDA device.
    """
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"upload_winding_batch: {device} is not a CUDA device")
    hw = np.array(sizes, np.int64).reshape(-1, 2)
    if len(edge_lists) != len(hw):
        raise ValueError("upload_winding_batch: one size per edge list")
    if (hw < 0).any():
        raise ValueError(f"upload_winding_batch: bad sizes {hw.tolist()}")
    table, (segs, pixels, blocks) = _mask_table([len(e) for e in edge_lists], hw)
    n_edge = 4 * segs
    if max(pixels, blocks, n_edge) > _INT32_MAX:
        raise ValueError("upload_winding_batch: the batch exceeds 32-bit offsets")
    if device not in _staging:
        _staging[device] = _Staging()
    host, copied = _staging[device].take(n_edge + table.size)
    buf = host.numpy()
    if n_edge:
        np.concatenate(edge_lists, axis=0, out=buf[:n_edge].reshape(-1, 4),
                       casting="same_kind")
    buf[n_edge:].view(np.int32)[:] = table.reshape(-1)
    dev_buf = host.to(device, non_blocking=True)
    copied.record(torch.cuda.current_stream(device))
    return WindingBatch(
        edges=dev_buf[:n_edge].view(-1, 4),
        table=dev_buf[n_edge:].view(torch.int32).view(-1, WINDING_TABLE_COLS),
        sizes=hw.tolist(), offsets=tuple(table[:, 4].tolist()),
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
    kernel computes every field; the batch table is uploaded once per
    shape and device (_uniform_batch) and reused.  On the CPU: the plain
    version, coverage.winding per list."""
    device = lines.device
    height, width = int(height), int(width)
    if not _kernel_device(device, "winding_uniform"):
        return torch.stack([coverage.winding(e, height, width) for e in lines]) \
            if lines.shape[0] else lines.new_zeros((0, height, width))
    _check(lines, "lines", torch.float32, (None, None, 4), device)
    n, segs, _ = lines.shape
    batch = _uniform_batch(n, segs, height, width, device)._replace(edges=lines.view(-1, 4))
    return launch_winding_batch(batch).out.view(n, height, width)


@functools.lru_cache(maxsize=64)
def _uniform_batch(n: int, segs: int, height: int, width: int, device) -> WindingBatch:
    """The WindingBatch of n lists of segs edges at height x width on device,
    its edges left empty; cached, so a repeated shape copies nothing."""
    table, (_segs, pixels, blocks) = _mask_table([segs] * n, [(height, width)] * n)
    if max(pixels, blocks, 4 * n * segs) > _INT32_MAX:
        raise ValueError("winding_uniform: the batch exceeds 32-bit offsets")
    return WindingBatch(
        edges=None, table=torch.from_numpy(table.astype(np.int32)).to(device),
        sizes=((height, width),) * n, offsets=tuple(table[:, 4].tolist()),
        pixels=pixels, blocks=blocks,
    )


def untile(tiles, grid, tile: int, viewport):
    """The viewport's pixels (h, w, 4) f32 of a frame's canvas tiles
    (grid_h * grid_w, T, T, 4) f32 on the card, in one launch.

    grid: (grid_h, grid_w) tiles; viewport: (v0, v1, h, w) with h <=
    grid_h * T and w <= grid_w * T.  The result is a contiguous tensor of its
    own, never a view of tiles.  A tensor on the CPU raises:
    render_plan.tiles_to_layer untiles it by reshape, permute and crop,
    this kernel's oracle."""
    device = tiles.device
    if not _kernel_device(device, "untile"):
        raise ValueError("untile: the tiles must be on a CUDA device")
    t = int(tile)
    if t not in KERNEL_TILES:
        raise ValueError(f"untile: tile {t} not in {KERNEL_TILES}")
    grid_h, grid_w = (int(g) for g in grid)
    h, w = int(viewport[2]), int(viewport[3])
    if not (0 <= h <= grid_h * t and 0 <= w <= grid_w * t):
        raise ValueError(f"untile: a {h} x {w} viewport on {grid_h} x {grid_w} tiles of {t}")
    _check(tiles, "tiles", torch.float32, (grid_h * grid_w, t, t, 4), device)
    if tiles.data_ptr() % 16:
        raise ValueError("untile: tiles must be 16-byte aligned")
    out = torch.empty((h, w, 4), dtype=torch.float32, device=device)
    if h and w:
        from . import cuda_lib

        lib = cuda_lib.load()
        rc = lib.svgr_untile(tiles.data_ptr(), grid_w, t, out.data_ptr(), h, w,
                             _stream(device))
        _raise_on(rc, "untile")
        untile.launches += 1
    return out


untile.launches = 0


# csrc/fe_blur.cu's block: the output pixels (rows, columns) it owns, and the
# shared memory its one-launch route may take (the default limit, so no
# opt-in); taps whose window and intermediate need more take two launches
FE_BLUR_TILE = (8, 32)
FE_BLUR_SHARED = 48 * 1024


def fe_blur_launches(kh: int, kw: int) -> int:
    """Launches csrc/fe_blur.cu makes for kh x kw taps: 1 where a block's
    input window, intermediate (float4 pixels) and taps fit FE_BLUR_SHARED,
    else 2 (u down the rows into a scratch layer, then v along them)."""
    rows, cols = FE_BLUR_TILE
    shared = 16 * (cols + kw - 1) * (2 * rows + kh - 1) + 4 * (kh + kw)
    return 1 if shared <= FE_BLUR_SHARED else 2


def fe_blur(image, taps, unpremultiply: bool):
    """A filter chain's separable blur on the card: the full convolution
    (h + kh - 1, w + kw - 1, 4) f32 of a layer image (h, w, 4) f32 with taps
    (a blur.BlurTaps that separates, its u and v on the image's device), each
    pixel un-premultiplied first when unpremultiply is set.  One launch, or
    two through a scratch layer for long taps (fe_blur_launches).  A tensor
    on the CPU raises: blur.fe_blur is the plain version, and Layer.convolve
    keeps its band matmuls there."""
    device = image.device
    if not _kernel_device(device, "fe_blur"):
        raise ValueError("fe_blur: the image must be on a CUDA device")
    if taps.full is not None or taps.u is None or taps.v is None:
        raise ValueError("fe_blur: the taps do not separate")
    kh, kw = (int(k) for k in taps.shape)
    f32 = torch.float32
    _check(image, "image", f32, (None, None, 4), device)
    _check(taps.u, "u", f32, (kh,), device)
    _check(taps.v, "v", f32, (kw,), device)
    if image.data_ptr() % 16:
        raise ValueError("fe_blur: image must be 16-byte aligned")
    h, w, _ = image.shape
    if max(h + kh, w + kw) > _INT32_MAX:
        raise ValueError(f"fe_blur: a {h} x {w} layer with {kh} x {kw} taps exceeds 32 bits")
    if not (h and w):
        return torch.zeros((h + kh - 1, w + kw - 1, 4), dtype=f32, device=device)
    out = torch.empty((h + kh - 1, w + kw - 1, 4), dtype=f32, device=device)
    launches = fe_blur_launches(kh, kw)
    scratch = None if launches == 1 else torch.empty((h + kh - 1, w, 4), dtype=f32,
                                                      device=device)
    from . import cuda_lib

    lib = cuda_lib.load()
    rc = lib.svgr_fe_blur(image.data_ptr(), h, w, taps.u.data_ptr(), kh, taps.v.data_ptr(),
                          kw, int(bool(unpremultiply)), _ptr(scratch), out.data_ptr(),
                          _stream(device))
    _raise_on(rc, "fe_blur")
    fe_blur.launches += launches
    return out


fe_blur.launches = 0


# the spec's lattice tables as csrc/fe_turbulence.cu stages them: 2 x 256 + 2
# entries (ops/turbulence.py lattice_tables)
TURBULENCE_TABLE = 514


def fe_turbulence(selector, gradient, offset, size, inverse, base_fx, base_fy,
                  octaves: int, fractal: bool):
    """A filter chain's feTurbulence on the card: (h, w, 4) f32, straight
    alpha, of the lattice tables selector (514,) int32 and gradient (4, 514,
    2) f32 (lattice_tables' arrays on a CUDA device) over h x w device
    pixels (size) from offset, each pixel centre taken to user space by
    inverse, the device-to-user transform's first two rows (2, 3).  One
    launch, none for an empty region.  A tensor on the CPU raises:
    turbulence.turbulence_region is the plain version, with these
    arguments, and filter._apply keeps it there."""
    device = selector.device
    if not _kernel_device(device, "fe_turbulence"):
        raise ValueError("fe_turbulence: the lattice tables must be on a CUDA device")
    _check(selector, "selector", torch.int32, (TURBULENCE_TABLE,), device)
    _check(gradient, "gradient", torch.float32, (4, TURBULENCE_TABLE, 2), device)
    if selector.data_ptr() % 16 or gradient.data_ptr() % 16:
        raise ValueError("fe_turbulence: selector and gradient must be 16-byte aligned")
    inverse = np.asarray(inverse, dtype=np.float64)
    if inverse.shape != (2, 3):
        raise ValueError(f"fe_turbulence: inverse has shape {inverse.shape}, expected (2, 3)")
    octaves = int(octaves)
    if octaves < 1:
        raise ValueError(f"fe_turbulence: {octaves} octaves, expected at least 1")
    h, w = (int(s) for s in size)
    off0, off1 = (int(o) for o in offset)
    if h < 0 or w < 0 or max(abs(off0) + h, abs(off1) + w) > _INT32_MAX:
        raise ValueError(f"fe_turbulence: a {h} x {w} region at {(off0, off1)}")
    out = torch.empty((h, w, 4), dtype=torch.float32, device=device)
    if h and w:
        from . import cuda_lib

        lib = cuda_lib.load()
        rc = lib.svgr_fe_turbulence(selector.data_ptr(), gradient.data_ptr(), off0, off1, h,
                                    w, *(float(v) for v in inverse.ravel()), float(base_fx),
                                    float(base_fy), octaves, int(bool(fractal)),
                                    out.data_ptr(), _stream(device))
        _raise_on(rc, "fe_turbulence")
        fe_turbulence.launches += 1
    return out


fe_turbulence.launches = 0


KERNELS = (prepass_winding, scene_tiles, blur_chunk, pool_rows, winding, part_entry,
           part_exit, untile, fe_blur, fe_turbulence)


def reset_launch_counts() -> None:
    for kernel in KERNELS:
        kernel.launches = 0
