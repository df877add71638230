"""The control: the reference computed in the precision below the
configuration's, put in the program's place, fails the comparison.  On the
CPU at a size a test run holds; on the card (marker `card`) at the cell's
own size."""

import json
import os

import pytest
import torch

from rasterbench.tools.calibrate import control_gaps

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
# each cell at a size a CPU test run holds, with no timed warm-up
SMALL = {
    "material_3840.pipelined": {"args": {"n_draws": 200, "size": 1488},
                                "width": 512, "tile": 32, "warmup_seconds": 0},
    "icons_3840.pipelined": {"args": {"n_draws": 150, "width": 480, "height": 123},
                             "width": 480, "tile": 32, "warmup_seconds": 0},
}


def _json(rel):
    with open(os.path.join(ROOT, rel), encoding="utf-8") as f:
        return json.load(f)


def _limits(cell_name):
    bench = _json("BENCHMARK.json")
    entry = {c["name"]: c for c in bench["workloads"]}[cell_name]
    config_entry = {c["name"]: c for c in bench["configs"]}[entry["config"]]
    return _json(config_entry["file"])["limits"]


def _fails(gaps, limits):
    return [name for name, limit in limits.items() if not gaps[name] <= limit]


@pytest.mark.parametrize("seed", [2 ** 31 + 5, 2 ** 31 + 6])
@pytest.mark.parametrize("cell_name", sorted(SMALL))
def test_control_fails_at_a_small_size(cell_name, seed):
    gaps = control_gaps(ROOT, cell_name, seed, "cpu", SMALL[cell_name])
    assert _fails(gaps, _limits(cell_name)), gaps


@pytest.mark.card
@pytest.mark.parametrize("cell_name", sorted(SMALL))
def test_control_fails_at_the_cells_size(cell_name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for seed in (2 ** 31 + 7, 2 ** 31 + 8, 2 ** 31 + 9):
        gaps = control_gaps(ROOT, cell_name, seed, "cuda")
        assert _fails(gaps, _limits(cell_name)), gaps
