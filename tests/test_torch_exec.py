"""The port's plain executors against the JAX package's executors.

The port's plain PyTorch versions of the two CUDA kernels (prepass winding
and scene tiles, svgrasterize_tpu_torch/ops/batch_exec.py) run here on the
CPU, fed the exact plan the JAX package lowered (plan_from_lowered).  JAX
runs on its CPU backend twice: SVGR_FUSED=0 is its XLA executor,
SVGR_FUSED=interp its Pallas kernels in interpret mode.  The kernels
themselves only run on a CUDA card, where chip_smoke.py holds them against
these plain versions.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import svgrasterize_tpu.render_plan as jrp
from svgrasterize_tpu.ops import batch_exec as j_batch_exec
from svgrasterize_tpu.ops import fused_exec as j_fused_exec

from svgrasterize_tpu_torch.ops import batch_exec, fused_exec
from svgrasterize_tpu_torch.render_plan import (
    _band_split,
    execute_lowered,
    plan_from_lowered,
)

from test_torch_lowering import DOCS, jax_lower, torch_lower, viewport_of

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


@pytest.mark.parametrize("tile", [32, 64])
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


def _jax_canvas(svg, tile, mode, monkeypatch):
    """JAX execute_lowered on a plan lowered anew under SVGR_FUSED=mode
    (_device_plan caches on the plan's items)."""
    monkeypatch.setenv("SVGR_FUSED", mode)
    lowered = jax_lower(svg, tile)
    return lowered, np.asarray(jrp.execute_lowered(lowered, (0, 0), False))


CASES = [
    ("features", 32, "1"), ("features", 32, "0"), ("features", 64, "0"),
    ("solids", 32, "1"), ("gradients_clips", 32, "1"), ("tile64", 64, "1"),
    ("flat", 32, "1"), ("flat", 32, "0"),
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
    svg = DOCS[name]
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
    lowered = torch_lower(DOCS["features"], 32)
    plan = plan_from_lowered(lowered, "cpu")
    assert plan.field is not None
    assert (plan.iparams[:, batch_exec.I_FIELD] >= 0).any()


@pytest.mark.parametrize("name,tile", [("features", 32), ("flat", 64)])
def test_port_lowering_and_execution_match_jax(name, tile, monkeypatch):
    """The whole port (its own lowering, plan upload and executor wrapper)
    against the JAX package end to end on the CPU."""
    _lowered, ref = _jax_canvas(DOCS[name], tile, "0", monkeypatch)
    got = execute_lowered(torch_lower(DOCS[name], tile), "cpu").numpy()
    assert np.abs(got - ref).max() <= EXEC_TOL
    assert viewport_of(DOCS[name])[2] <= 128
