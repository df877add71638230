"""The port's plain executors against the JAX package's executors.

The port's plain PyTorch versions of the two CUDA kernels (prepass winding
and scene tiles, svgrasterize_tpu_torch/ops/batch_exec.py) run here on the
CPU, fed the exact plan the JAX package lowered (plan_from_lowered).  JAX
runs on its CPU backend twice: SVGR_FUSED=0 is its XLA executor,
SVGR_FUSED=interp its Pallas kernels in interpret mode.  The prepass is
also held on several classes in one call, and the band-culling rules of
the prepass and scene kernels are checked to change no bit of the
winding.  The kernels themselves only
run on a CUDA card, where chip_smoke.py holds them against these plain
versions.
"""

from __future__ import annotations

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import svgrasterize_tpu.render_plan as jrp
from svgrasterize_tpu.ops import batch_exec as j_batch_exec
from svgrasterize_tpu.ops import fused_exec as j_fused_exec

from svgrasterize_tpu_torch.ops import batch_exec, fused_exec
from svgrasterize_tpu_torch.ops import coverage as t_cov
from svgrasterize_tpu_torch.render_plan import (
    _band_split,
    execute_lowered,
    plan_from_lowered,
)

from torch_support import FLAT_DOCS, jax_lower, torch_lower, viewport_of

# The closed form is the same f32 arithmetic in both packages; only the
# order of the per-pixel sums over edges differs.
PREPASS_TOL = 2e-5
# The bound tests/test_fused_exec.py holds between the JAX package's own
# two executors.
EXEC_TOL = 1e-5


def _band_edges(rng, rows: int, width: int, tile: int) -> np.ndarray:
    """Random padded edge lists as lowering makes them: band-split at
    8-row boundaries (the JAX prepass kernel requires it), zero padding."""
    out = np.zeros((rows, width, 4), np.float32)
    for r in range(rows):
        live = int(rng.integers(1, width // 2))
        edges = rng.uniform(-2, tile + 2, (live, 4)).astype(np.float32)
        edges[:, 0] = np.clip(edges[:, 0], 0, tile)
        edges[:, 2] = np.clip(edges[:, 2], 0, tile)
        split = _band_split(edges, tile)[:width]
        out[r, : split.shape[0]] = split
    return out


@pytest.mark.parametrize("tile", [32, 64, 128])
def test_prepass_matches_jax(tile, monkeypatch):
    rng = np.random.default_rng(tile)
    classes = [_band_edges(rng, 8, w, tile) for w in (32, 128)]
    got = batch_exec._prepass_winding([torch.from_numpy(c) for c in classes], tile)
    # the wrapper takes the plain version for CPU tensors
    wrapped = fused_exec.prepass_winding([torch.from_numpy(c) for c in classes], tile)
    assert torch.equal(got, wrapped)
    assert got.shape == (8 + 8 + 1, tile, tile)
    assert float(got[-1].abs().max()) == 0.0

    xla = np.asarray(j_batch_exec._prepass_winding(
        tuple(jnp.asarray(c) for c in classes), tile))
    monkeypatch.setenv("SVGR_FUSED", "interp")
    interp = np.asarray(j_fused_exec.prepass_winding(
        tuple(jnp.asarray(c) for c in classes), tile))
    assert np.abs(got.numpy() - xla).max() <= PREPASS_TOL
    assert np.abs(got.numpy() - interp).max() <= PREPASS_TOL


def _multiclass(rng, tile: int) -> list:
    """Classes of widths 16-1024 as one prepass call gets them; each has an
    all-zero padded row, one class is nothing but padding rows."""
    classes = []
    for width, rows in ((16, 8), (64, 16), (256, 8), (1024, 8)):
        arr = _band_edges(rng, rows, width, tile)
        arr[rows // 2] = 0.0
        classes.append(arr)
    classes.append(np.zeros((8, 32, 4), np.float32))
    return classes


@pytest.mark.parametrize("tile", [16, 32, 64, 128])
def test_prepass_multiclass_matches_jax(tile, monkeypatch):
    """Several classes in one call (the kernel's one launch per call)."""
    classes = _multiclass(np.random.default_rng(100 + tile), tile)
    got = batch_exec._prepass_winding([torch.from_numpy(c) for c in classes], tile)
    fused_exec.reset_launch_counts()
    wrapped = fused_exec.prepass_winding([torch.from_numpy(c) for c in classes], tile)
    assert fused_exec.prepass_winding.launches == 0  # CPU tensors: the plain version
    assert torch.equal(got, wrapped)
    starts = np.cumsum([0] + [c.shape[0] for c in classes])
    assert got.shape == (starts[-1] + 1, tile, tile)
    # the padded row of each class, the all-padding class, the scratch row
    zero_rows = [s + c.shape[0] // 2 for s, c in zip(starts, classes)]
    zero_rows += list(range(starts[-2], starts[-1] + 1))
    assert float(got[zero_rows].abs().max()) == 0.0
    assert float(got[: starts[-2]].abs().max()) > 0.0

    xla = np.asarray(j_batch_exec._prepass_winding(
        tuple(jnp.asarray(c) for c in classes), tile))
    monkeypatch.setenv("SVGR_FUSED", "interp")
    interp = np.asarray(j_fused_exec.prepass_winding(
        tuple(jnp.asarray(c) for c in classes), tile))
    assert np.abs(got.numpy() - xla).max() <= PREPASS_TOL
    assert np.abs(got.numpy() - interp).max() <= PREPASS_TOL


def _sequential(per_edge, keep):
    """Sum of the kept per-edge fields one edge at a time, in edge order:
    the prepass kernel's summation order."""
    acc = torch.zeros(per_edge.shape[1:], dtype=torch.float32)
    for e in np.flatnonzero(keep):
        acc = acc + per_edge[e]
    return acc


@pytest.mark.parametrize("tile", [16, 32, 64, 128])
def test_prepass_band_culling_is_exact(tile):
    """The prepass kernel's culling rule: a band of 8 rows sums only the
    edges whose [y_lo, y_hi] meets it (and a warp only those meeting its
    row), padding and horizontal edges dropped.  Every dropped edge gives
    an exact 0.0 there, so the culled sum equals the unculled one bit for
    bit when both add in edge order."""
    rng = np.random.default_rng(7 + tile)
    edges = _band_edges(rng, 1, 256, tile)[0]
    raw = rng.uniform(-3, tile + 3, (40, 4)).astype(np.float32)  # not band-split
    raw[::5, 2] = raw[::5, 0]  # horizontal
    edges = np.concatenate([edges[:160], raw, np.zeros((8, 4), np.float32)])
    per_edge = t_cov.winding_fields(torch.from_numpy(edges)[:, None], tile, tile)
    a0, b0 = edges[:, 0], edges[:, 2]
    y_lo, y_hi = np.minimum(a0, b0), np.maximum(a0, b0)
    live = a0 != b0  # sign != 0: padding rows are horizontal
    unculled = _sequential(per_edge, np.ones(len(edges), bool))
    for r0 in range(0, tile, 8):
        keep = live & (y_hi > r0) & (y_lo < r0 + 8)
        assert float(per_edge[~keep, r0:r0 + 8].abs().max()) == 0.0
        band = _sequential(per_edge, keep)[r0:r0 + 8]
        assert torch.equal(band, unculled[r0:r0 + 8])
    for r in range(tile):
        misses = (y_hi <= r) | (y_lo >= r + 1)
        assert float(per_edge[misses, r].abs().max()) == 0.0
    plain = batch_exec._prepass_winding([torch.from_numpy(edges)[None]], tile)[0]
    assert float((plain - unculled).abs().max()) <= PREPASS_TOL


def _scene_item_edges(rng, tile: int) -> np.ndarray:
    """One item's SMALL_SEGS inline edges as the scene kernel stages them:
    band-split edges as lowering makes them, then raw (unsplit) ones with
    horizontal edges among them, zero padding between and after."""
    split = _band_edges(rng, 1, 32, tile)[0]
    split = split[split.any(axis=1)]
    raw = rng.uniform(-3, tile + 3, (12, 4)).astype(np.float32)
    raw[:, 0] = np.clip(raw[:, 0], 0, tile)
    raw[:, 2] = np.clip(raw[:, 2], 0, tile)
    raw[::4, 2] = raw[::4, 0]  # horizontal
    live = np.concatenate([split, np.zeros((3, 4), np.float32), raw])
    edges = np.zeros((batch_exec.SMALL_SEGS, 4), np.float32)
    edges[: live.shape[0]] = live[: batch_exec.SMALL_SEGS]
    return edges


@pytest.mark.parametrize("band", [1, 2, 4, 8])
@pytest.mark.parametrize("tile", [16, 32, 64, 128])
def test_scene_band_culling_is_exact(tile, band):
    """The scene kernel's culling rule: a band of rows (a warp's: 1 row at
    T = 64, 2 at T = 32, 4 at T = 16; or a block's 8) sums only the item's inline
    edges with sign != 0 whose [y_lo, y_hi] meets it, compacted in edge
    order and added kGroup = 8 at a time, with exact zeros past the last.
    Every dropped edge gives an exact 0.0 in the band, so the culled
    winding plus the carry equals the walk over all SMALL_SEGS edges bit
    for bit."""
    rng = np.random.default_rng(23 + tile + band)
    edges = _scene_item_edges(rng, tile)
    carry = torch.from_numpy(np.round(rng.uniform(-2, 2, tile) * 2).astype(np.float32) / 2)
    per_edge = t_cov.winding_fields(torch.from_numpy(edges)[:, None], tile, tile)
    a0, b0 = edges[:, 0], edges[:, 2]
    y_lo, y_hi = np.minimum(a0, b0), np.maximum(a0, b0)
    live = a0 != b0  # sign != 0: padding rows are horizontal
    assert (~live).sum() >= 3 and live.sum() >= 8
    unculled = _sequential(per_edge, np.ones(len(edges), bool)) + carry[:, None]
    for r0 in range(0, tile, band):
        keep = live & (y_hi > r0) & (y_lo < r0 + band)
        assert float(per_edge[~keep, r0:r0 + band].abs().max()) == 0.0
        kept = np.flatnonzero(keep)
        acc = torch.zeros((band, tile), dtype=torch.float32)
        for k in range(0, len(kept), 8):
            for g in range(8):
                acc = acc + (per_edge[kept[k + g], r0:r0 + band] if k + g < len(kept)
                             else torch.zeros((), dtype=torch.float32))
        assert torch.equal(acc + carry[r0:r0 + band, None], unculled[r0:r0 + band])
    plain = t_cov.winding_fields(torch.from_numpy(edges)[None], tile, tile)[0]
    assert float((plain + carry[:, None] - unculled).abs().max()) <= PREPASS_TOL


def _jax_canvas(svg, tile, mode, monkeypatch):
    """JAX execute_lowered on a plan lowered anew under SVGR_FUSED=mode
    (_device_plan caches on the plan's items)."""
    monkeypatch.setenv("SVGR_FUSED", mode)
    lowered = jax_lower(svg, tile)
    return lowered, np.asarray(jrp.execute_lowered(lowered, (0, 0), False))


CASES = [
    ("features", 32, "1"), ("features", 32, "0"), ("features", 64, "0"),
    ("solids", 32, "1"), ("gradients_clips", 32, "1"), ("tile64", 64, "1"),
    ("flat", 32, "1"), ("flat", 32, "0"), ("gradients_clips", 128, "0"), ("flat", 128, "1"),
]


@pytest.mark.parametrize("name,tile,collapse", CASES)
def test_scene_executor_matches_jax(name, tile, collapse, monkeypatch):
    """The port's plain execute_items on the JAX-lowered plan.

    collapse "0" lowers with the JAX package's static-run collapse off, so
    every draw reaches the executor as its own item (gradients, clips,
    strokes, evenodd, big classes); "1" is the default plan, where runs
    arrive as precomposed field items.

    The JAX executors floor coverage below 1e-6 at different points: the
    XLA executor (batch_exec.py:194) before the opacity multiply, the TPU
    kernel (fused_exec.py:587-588) after it.  The port follows the XLA
    executor; the difference stays below the tolerance on these plans.
    """
    svg = FLAT_DOCS[name]
    monkeypatch.setenv("SVGR_COLLAPSE", collapse)
    lowered, ref = _jax_canvas(svg, tile, "0", monkeypatch)
    _lowered2, interp = _jax_canvas(svg, tile, "interp", monkeypatch)
    got = batch_exec.execute_items(plan_from_lowered(lowered, "cpu")).numpy()
    assert got.shape == ref.shape
    assert np.isfinite(got).all()
    assert np.abs(got - ref).max() <= EXEC_TOL
    assert np.abs(got - interp).max() <= EXEC_TOL
    if name == "features" and collapse == "0":
        _assert_features(lowered, got)


def _assert_features(lowered, canvas):
    """The features plan reaches every code path of the executor."""
    items = lowered.items
    n_tiles = lowered.grid[0] * lowered.grid[1]
    live = items["tile_id"] < n_tiles
    kind, spread = items["kind"][live], items["spread"][live]
    grads = kind != batch_exec.PAINT_SOLID
    assert {0, 1, 2} <= set(kind.tolist())
    assert {0, 1, 2} <= set(spread[grads].tolist())
    assert (items["fill_rule"][live] == 1).any()
    assert (items["clip_idx"][live] >= 0).any()
    assert (items["big_idx"][live] >= 0).any() and max(b.shape[1] for b in lowered.bigs) > 64
    assert (np.abs(items["carry"][live]).max(axis=1) > 0).any()
    empty = sorted(set(range(n_tiles)) - set(items["tile_id"][live].tolist()))
    assert empty and float(np.abs(canvas[empty]).max()) == 0.0


def test_default_plan_has_collapse_fields():
    lowered = torch_lower(FLAT_DOCS["features"], 32)
    plan = plan_from_lowered(lowered, "cpu")
    assert plan.field is not None
    assert (plan.iparams[:, batch_exec.I_FIELD] >= 0).any()


@pytest.mark.parametrize("name,tile", [("features", 32), ("flat", 64), ("flat", 128)])
def test_port_lowering_and_execution_match_jax(name, tile, monkeypatch):
    """The whole port (its own lowering, plan upload and executor wrapper)
    against the JAX package end to end on the CPU."""
    _lowered, ref = _jax_canvas(FLAT_DOCS[name], tile, "0", monkeypatch)
    got = execute_lowered(torch_lower(FLAT_DOCS[name], tile), "cpu").numpy()
    assert np.abs(got - ref).max() <= EXEC_TOL
    assert viewport_of(FLAT_DOCS[name])[2] <= 128


def test_kernel_tiles_are_the_tiles_the_sources_take():
    """fused_exec.KERNEL_TILES names exactly the tiles csrc/ instantiates:
    the launch<T> cases of the scene, prepass and blur-chunk kernels, and
    the tiles the pool-row writer accepts."""
    csrc = Path(fused_exec.__file__).resolve().parent.parent / "csrc"
    for name in ("scene.cu", "prepass.cu", "blur_chunk.cu"):
        src = (csrc / name).read_text()
        cases = re.findall(r"case (\d+):\s*return \(int\)launch<(\d+)>", src)
        assert all(a == b for a, b in cases), name
        assert tuple(int(a) for a, _b in cases) == fused_exec.KERNEL_TILES, name
    src = (csrc / "pool_rows.cu").read_text()
    taken = tuple(int(t) for t in re.findall(r"tile != (\d+)", src))
    assert taken == fused_exec.KERNEL_TILES
    assert fused_exec.KERNEL_TILES == (16, 32, 64, 128)
