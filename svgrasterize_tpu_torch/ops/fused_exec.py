"""Wrappers of the hand-written CUDA kernels (csrc/prepass.cu, csrc/scene.cu,
csrc/blur_chunk.cu, csrc/pool_rows.cu, csrc/winding.cu).

Each wrapper checks device, dtype, shape and contiguity, allocates the
output, launches its kernel on PyTorch's current stream through the ctypes
library (ops/cuda_lib.py) and raises if the launch returns a CUDA error.
Tensors on the CPU go to the kernel's plain PyTorch version
(ops/batch_exec.py, ops/filter_batch.apply_chunk, ops/coverage.winding)
instead; that is the only case that does.  A tensor on any other device
raises.

Each wrapper counts its kernel launches in its `launches` attribute, so a
run can show that its main path went through the kernels
(reset_launch_counts sets them all to 0).
"""

from __future__ import annotations

import torch

from . import batch_exec, coverage, filter_batch
from .batch_exec import MAX_STOPS, N_FPARAMS, N_IPARAMS, SMALL_SEGS, DevicePlan

# tile sizes the kernels are instantiated for (a template parameter)
KERNEL_TILES = (16, 32, 64)


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
    """
    arrays = [a for a in arrays if a is not None and a.shape[0]]
    if not arrays:
        return None
    device = arrays[0].device
    if not _kernel_device(device, "prepass_winding"):
        return batch_exec._prepass_winding(arrays, t_size)
    if t_size not in KERNEL_TILES:
        raise ValueError(f"prepass_winding: tile {t_size} not in {KERNEL_TILES}")
    for i, a in enumerate(arrays):
        _check(a, f"class {i}", torch.float32, (None, None, 4), device)
    from . import cuda_lib

    lib = cuda_lib.load()
    total = sum(a.shape[0] for a in arrays)
    out = torch.empty((total + 1, t_size, t_size), dtype=torch.float32, device=device)
    out[total].zero_()
    stream = _stream(device)
    row = 0
    for a in arrays:
        rc = lib.svgr_prepass_winding(
            a.data_ptr(), out[row].data_ptr(), a.shape[0], a.shape[1], t_size, stream
        )
        _raise_on(rc, "prepass_winding")
        prepass_winding.launches += 1
        row += a.shape[0]
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
    _check(plan.tile_id, "tile_id", i32, (n,), device)
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
    atlas = plan.patterns  # upload sets it for every plan with pattern items
    if atlas is not None:
        _check(atlas, "patterns", f32, (None, None, None, 4), device)
    from . import cuda_lib

    lib = cuda_lib.load()
    num_tiles = plan.num_tiles
    out = torch.empty((num_tiles, t, t, 4), dtype=f32, device=device)
    rc = lib.svgr_scene_tiles(
        plan.lines.data_ptr(), segs, plan.carry.data_ptr(),
        plan.tile_id.data_ptr(), n, plan.iparams.data_ptr(),
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


_GAMMA_CODE = {None: 0, "to_linear": 1, "to_srgb": 2}


def blur_chunk(canvas, ck: dict, t_size: int, linear_rgb: bool):
    """Every out-span tile (B * NOi * NOj, T, T, 4) f32 of a blur chunk.

    canvas: a level's pass rows (R, T, T, 4); ck: a chunk of
    ops/filter_batch.build_chunks with its arrays on the canvas's device
    (filter_batch.upload_chunk).  The level's pool update picks
    ck["out_idx"] from the result.
    """
    device = canvas.device
    if not _kernel_device(device, "blur_chunk"):
        return filter_batch.apply_chunk(canvas, ck, t_size, linear_rgb)
    t = t_size
    if t not in KERNEL_TILES:
        raise ValueError(f"blur_chunk: tile {t} not in {KERNEL_TILES}")
    B, nsi, nsj, noi, noj = ck["B"], ck["NSi"], ck["NSj"], ck["NOi"], ck["NOj"]
    f32, i32 = torch.float32, torch.int32
    _check(canvas, "canvas", f32, (None, t, t, 4), device)
    _check(ck["lut"], "lut", i32, (B, nsi * nsj), device)
    _check(ck["bh"], "bh", f32, (B, noi * t, nsi * t), device)
    _check(ck["bw"], "bw", f32, (B, noj * t, nsj * t), device)
    _check(ck["src_alpha"], "src_alpha", i32, (B,), device)
    gamma_in, gamma_out = filter_batch.gammas(ck["chain_linear"], linear_rgb)
    from . import cuda_lib

    lib = cuda_lib.load()
    out = torch.empty((B * noi * noj, t, t, 4), dtype=f32, device=device)
    rc = lib.svgr_blur_chunk(
        canvas.data_ptr(), canvas.shape[0], ck["lut"].data_ptr(),
        ck["bh"].data_ptr(), ck["bw"].data_ptr(), ck["src_alpha"].data_ptr(),
        B, nsi, nsj, noi, noj, _GAMMA_CODE[gamma_in], _GAMMA_CODE[gamma_out],
        out.data_ptr(), t, _stream(device),
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
    image pixel coordinates (rows a0, a1, b0, b1; zero rows are padding)."""
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

KERNELS = (prepass_winding, scene_tiles, blur_chunk, pool_rows, winding)


def reset_launch_counts() -> None:
    for kernel in KERNELS:
        kernel.launches = 0
