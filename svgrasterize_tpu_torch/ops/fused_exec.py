"""Wrappers of the hand-written CUDA kernels (csrc/prepass.cu, csrc/scene.cu).

Each wrapper checks device, dtype, shape and contiguity, allocates the
output, launches its kernel on PyTorch's current stream through the ctypes
library (ops/cuda_lib.py) and raises if the launch returns a CUDA error.
Tensors on the CPU go to the kernel's plain PyTorch version in
ops/batch_exec.py instead; that is the only case that does.  A tensor on
any other device raises.

Each wrapper counts its kernel launches in its `launches` attribute, so a
run can show that its main path went through the kernels
(reset_launch_counts sets both to 0).
"""

from __future__ import annotations

import torch

from . import batch_exec
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


def scene_tiles(plan: DevicePlan, big_wind):
    """Canvas tiles (num_tiles, T, T, 4) f32 premultiplied of a plan.

    big_wind: the prepass stack of plan.bigs, or None when it has none.
    """
    device = plan.lines.device
    if not _kernel_device(device, "scene_tiles"):
        return batch_exec._scene_tiles(plan, big_wind)
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
    from . import cuda_lib

    lib = cuda_lib.load()
    num_tiles = plan.num_tiles
    out = torch.empty((num_tiles, t, t, 4), dtype=f32, device=device)
    rc = lib.svgr_scene_tiles(
        plan.lines.data_ptr(), segs, plan.carry.data_ptr(),
        plan.tile_id.data_ptr(), n, plan.iparams.data_ptr(),
        plan.fparams.data_ptr(), plan.stop_offsets.data_ptr(),
        plan.stop_colors.data_ptr(), k_stops, _ptr(big_wind),
        _ptr(plan.clips), _ptr(plan.field), out.data_ptr(), num_tiles, t,
        _stream(device),
    )
    _raise_on(rc, "scene_tiles")
    scene_tiles.launches += 1
    return out


scene_tiles.launches = 0


def execute_items_fused(plan: DevicePlan):
    """Whole-plan execution: the prepass, then the scene tiles."""
    return scene_tiles(plan, prepass_winding(plan.bigs, plan.tile))


def reset_launch_counts() -> None:
    prepass_winding.launches = 0
    scene_tiles.launches = 0
