"""The 8K material cell (material_7680.pipelined): its files by name, a run
on the CPU at a small size with its own 128-px tile (correct), the control
failing its limits there and (marker `card`) at the cell's size, the
faults of test_rb_faults caught at tile 128, and the arithmetic of
output_roofline."""

import json
import os
from types import SimpleNamespace

import pytest

from rasterbench.harness import cell
from rasterbench.metrics import output_roofline
from rasterbench.tests.test_rb_faults import (  # noqa: F401  (counted_frames: a fixture)
    cached_layer, counted_frames, half_left_out, state_unchanged, tile_altered)
from rasterbench.tools.calibrate import control_gaps

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CELL = "material_7680.pipelined"
# the cell at a size a CPU test run holds, its tile kept: 600 px leaves a
# partial 128-px tile on each axis
SMALL = {"args": {"n_draws": 200, "size": 1488}, "width": 600, "warmup_seconds": 0}
PEAKS = {"hbm_bytes_per_s": 3.35e12, "fp32_flops_per_s": 67e12}


def _bench():
    with open(os.path.join(ROOT, "BENCHMARK.json"), encoding="utf-8") as f:
        return json.load(f)


def test_the_cell_resolves_to_the_8k_configuration():
    bench, entry, config, params = cell.resolve(ROOT, CELL)
    assert (entry["config"], entry["traffic"], entry["chips"]) == ("material_7680", "pipelined", 1)
    assert (config["width"], config["tile"], config["passes"]) == (7680, 128, False)
    assert config["generator"] == "flat_doc" and config["reference"] == "raster"
    assert config["args"] == {"n_draws": 1536, "size": 1488} and config["reduced"] == []
    assert params["entry"] == "render_many" and params["in_flight"] == 3
    names = {m["name"] for m in cell.cell_metrics(bench, CELL, True)}
    assert {"scene_roofline", "output_ms", "output_roofline", "kernels_per_frame"} <= names
    assert {m["name"] for m in cell.cell_metrics(bench, CELL, False)} == {
        "frame_ms", "request_p95_ms", "peak_mem_gib", "setup_s"}


def _run(fault=None, seed=2 ** 31 + 977):
    return cell.run(ROOT, CELL, seed, 0.3, False, device="cpu", fault=fault, overrides=SMALL,
                    log=lambda msg: None)


def test_a_sound_run_at_tile_128_is_correct():
    r = _run()
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0


@pytest.mark.parametrize("seed", [2 ** 31 + 5, 2 ** 33 + 1])
def test_the_control_fails_at_a_small_size(seed):
    _bench_, _entry, config, _params = cell.resolve(ROOT, CELL)
    gaps = control_gaps(ROOT, CELL, seed, "cpu", SMALL)
    assert [n for n, lim in config["limits"].items() if not gaps[n] <= lim], gaps


@pytest.mark.card
def test_the_control_fails_at_the_cells_size():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    _bench_, _entry, config, _params = cell.resolve(ROOT, CELL)
    for seed in (2 ** 31 + 7, 2 ** 32 + 9):
        gaps = control_gaps(ROOT, CELL, seed, "cuda")
        assert [n for n, lim in config["limits"].items() if not gaps[n] <= lim], gaps


@pytest.mark.parametrize("fault", [state_unchanged, half_left_out, tile_altered, cached_layer],
                         ids=lambda f: f.__name__)
def test_a_broken_timed_path_at_tile_128_is_not_correct(fault):
    r = _run(fault)
    assert not r["correct"], r["checks"]


def _ctx(ops, requests=4, viewport=(0, 0, 100, 200)):
    return SimpleNamespace(trace={"ops": ops}, frames=requests,
                           traffic={"frames_per_request": 1}, viewport=viewport, peaks=PEAKS)


def test_output_roofline_is_one_write_of_the_layer_over_the_output_path():
    one_write_ns = 100 * 200 * 16 / PEAKS["hbm_bytes_per_s"] * 1e9
    # 4 requests, each one copy outside the graph taking exactly one write
    ops = [("copy", 10 * i, one_write_ns, False) for i in range(4)]
    ops.append(("scene_kernel", 0, 1e6, True))  # the graph's: not the output path
    assert output_roofline.read(_ctx(ops)) == pytest.approx(100.0)
    # two copies a request, each a read and a write: a quarter
    ops = [("copy", 10 * i, 2 * one_write_ns, False) for i in range(8)]
    assert output_roofline.read(_ctx(ops)) == pytest.approx(25.0)


def test_output_roofline_reads_nothing_without_outside_operations():
    assert output_roofline.read(_ctx([("scene_kernel", 0, 5e5, True)])) is None
    assert output_roofline.read(_ctx([])) is None
    assert output_roofline.read(SimpleNamespace(trace=None, viewport=(0, 0, 1, 1),
                                                peaks=PEAKS)) is None


def test_output_roofline_is_listed_for_the_three_cells():
    metric = {m["name"]: m for m in _bench()["per_layer"]}["output_roofline"]
    assert metric["workloads"] == ["material_3840.pipelined", "icons_3840.pipelined", CELL]
    assert (metric["unit"], metric["better"], metric["moves"]) == ("%", "higher", "frame_ms")
