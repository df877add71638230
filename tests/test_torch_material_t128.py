"""The 8K material configuration's path at tile 128, at a small size on the
CPU: the frozen flat_doc generator parsed at a width, lowered onto 128-px
tiles (lower_scene(..., tile=128)), served by CompiledScene.render_many(1)
through the plain versions of the kernels, against the benchmark's plain
reference within rasterbench/configs/material_7680.json's limits; and the
reference in bfloat16 fails those limits.  Width 600 leaves a partial tile
on each axis."""

from __future__ import annotations

import json
import os

import pytest
import torch

from rasterbench.docs import flat_doc
from rasterbench.reference import compare, raster
from svgrasterize_tpu_torch.core.transform import Transform
from svgrasterize_tpu_torch.frontend.svg import scene_from_str
from svgrasterize_tpu_torch.render_plan import CompiledScene, lower_scene

import torch_support  # noqa: F401 (the CPU thread budget)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_DRAWS = 200
SEEDS = (2 ** 31 + 11, 2 ** 32 + 5)


def _config():
    with open(os.path.join(ROOT, "rasterbench", "configs", "material_7680.json"),
              encoding="utf-8") as f:
        return json.load(f)


def _fails(gaps, limits):
    return [name for name, limit in limits.items() if not gaps[name] <= limit]


@pytest.fixture(scope="module", params=[(512, SEEDS[0]), (600, SEEDS[1])],
                ids=lambda p: f"w{p[0]}")
def served(request):
    """(the served layer, the document's records, the canvas size, scale)."""
    width, seed = request.param
    config = _config()
    svg, doc = flat_doc.generate(seed, N_DRAWS, config["args"]["size"])
    scene, _ids, (w, h) = scene_from_str(svg, None, width, None)
    viewport = (0, 0, int(h), int(w))
    lowered = lower_scene(scene, Transform().matrix(0, 1, 0, 1, 0, 0), viewport, False,
                          config["tile"], device="cpu")
    assert lowered is not None and not lowered.groups
    assert lowered.tile == 128
    cs = CompiledScene(lowered, viewport, False, device="cpu")
    layer = cs.render_many(1)
    return layer, doc, (int(h), int(w)), width / doc["width"], lowered.grid


def test_the_grid_covers_the_canvas_with_128_px_tiles(served):
    _layer, _doc, (h, w), _scale, grid = served
    assert tuple(grid) == (-(-h // 128), -(-w // 128))


def test_served_at_tile_128_is_within_the_limits(served):
    layer, doc, (h, w), scale, _grid = served
    assert tuple(layer.image.shape) == (h, w, 4) and tuple(layer.offset) == (0, 0)
    assert layer.pre_alpha and not layer.linear_rgb
    config = _config()
    ref = raster.render(doc, h, w, scale, tile=config["tile"], dtype=torch.float32)
    gaps = compare.gaps(layer.image, ref, config["block"])
    assert not _fails(gaps, config["limits"]), gaps


def test_the_reference_in_bfloat16_fails_the_limits(served):
    _layer, doc, (h, w), scale, _grid = served
    config = _config()
    ref = raster.render(doc, h, w, scale, tile=config["tile"], dtype=torch.float32)
    low = raster.render(doc, h, w, scale, tile=config["tile"], dtype=torch.bfloat16)
    gaps = compare.gaps(low, ref, config["block"])
    assert _fails(gaps, config["limits"]), gaps
