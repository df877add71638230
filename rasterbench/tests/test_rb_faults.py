"""A run's check, driven on the CPU at a small size with the program's plain
versions: sound, it comes out correct; with the timed path broken
underneath, it comes out not correct.  Each fault is one this cell can
have: a request that returns the frame's state unchanged (as it was before
any rendering), half of the frame's tiles left out, one tile altered where
the frame is produced, and a request that renders nothing and returns an
earlier frame.  (One card: there is no exchange between
chips to leave out.)"""

import os

import pytest
import torch

from rasterbench.harness import cell

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
# each cell at a size a CPU test run holds, with no timed warm-up
SMALL = {
    "material_3840.pipelined": {"args": {"n_draws": 120, "size": 1488},
                                "width": 320, "tile": 32, "warmup_seconds": 0},
    "icons_3840.pipelined": {"args": {"n_draws": 150, "width": 480, "height": 123},
                             "width": 480, "tile": 32, "warmup_seconds": 0},
}


def _layer_like(layer, image):
    from svgrasterize_tpu_torch.core.layer import Layer

    return Layer(image, layer.offset, layer.pre_alpha, layer.linear_rgb)


def state_unchanged(_cs, call):
    def request():
        layer = call()
        return _layer_like(layer, torch.zeros_like(layer.image))
    return request


def half_left_out(_cs, call):
    def request():
        layer = call()
        image = layer.image.clone()
        image[image.shape[0] // 2:] = 0
        return _layer_like(layer, image)
    return request


def tile_altered(cs, call):
    def request():
        layer = call()
        image = layer.image.clone()
        t = cs.tile
        image[t:2 * t, t:2 * t] += 0.25
        return _layer_like(layer, image)
    return request


def cached_layer(_cs, call):
    """Every request after the first returns the first's layer, the entry
    not called: right pixels, no frame rendered."""
    first = []

    def request():
        if not first:
            first.append(call())
        return first[0]
    return request


@pytest.fixture(autouse=True)
def counted_frames(monkeypatch):
    """The CPU path counts its frames as the card counts its replays, so
    that the run's count of frames is checked here too."""
    from svgrasterize_tpu_torch.render_plan import CompiledScene

    render_tiles_many = CompiledScene.render_tiles_many

    def counting(self, k):
        tiles = render_tiles_many(self, k)
        if self.program.device.type != "cuda":
            self.replays += int(k)
        return tiles

    monkeypatch.setattr(CompiledScene, "render_tiles_many", counting)


def _run(cell_name, fault=None, seed=2 ** 31 + 977):
    return cell.run(ROOT, cell_name, seed, 0.3, False, device="cpu", fault=fault,
                    overrides=SMALL[cell_name], log=lambda msg: None)


@pytest.mark.parametrize("cell_name", sorted(SMALL))
def test_a_sound_run_is_correct(cell_name):
    r = _run(cell_name)
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0
    assert list(r)[-1] == "checks"
    for check in r["checks"].values():
        assert check["value"] <= check["limit"]


@pytest.mark.parametrize("fault", [state_unchanged, half_left_out, tile_altered, cached_layer],
                         ids=lambda f: f.__name__)
@pytest.mark.parametrize("cell_name", sorted(SMALL))
def test_a_broken_timed_path_is_not_correct(cell_name, fault):
    r = _run(cell_name, fault)
    assert not r["correct"], r["checks"]
