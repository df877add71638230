"""The untile kernel (csrc/untile.cu via ops/fused_exec.untile) and the
serving path that copies a request's layer with it.

On the CPU: the wrapper hands the kernel's C entry the tiles, the grid's
width, the tile, a layer of its own and the viewport's size, and raises on
what the kernel does not take; render_many on the
card's path (CPU tensors standing in for the graph's output) copies its
layer straight out of the frame and never clones it, while
render_tiles_many still returns a clone the caller owns.  The tests marked
`card` hold the kernel itself to the plain path on a CUDA card and skip
without one; there (no JAX, so without tests/conftest.py):

    python -m pytest tests/test_torch_untile.py --noconftest -q
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from svgrasterize_tpu_torch.core.transform import Transform
from svgrasterize_tpu_torch.ops import fused_exec
from svgrasterize_tpu_torch.render_plan import CompiledScene, lower_scene, tiles_to_layer

from chip_smoke import _bits, untile_cases
from torch_support import as_on_the_card, doc_scene, serve  # noqa: F401 (a fixture)

TILES = fused_exec.KERNEL_TILES
KINDS = sorted(untile_cases(16))  # viewports on a grid of tiles, by name


def _tiles(t: int, grid_h: int, grid_w: int, seed: int, device="cpu"):
    """Random bit patterns as f32 tiles: every NaN payload and -0.0 included,
    so only a copy of the bits equals the plain path."""
    rng = np.random.default_rng(seed)
    bits = rng.integers(-2**31, 2**31, (grid_h * grid_w, t, t, 4), dtype=np.int64)
    return torch.from_numpy(bits.astype(np.int32)).view(torch.float32).to(device)


def _plain(tiles, grid, t: int, viewport):
    """tiles_to_layer's plain reshape, permute and crop, on the CPU."""
    return tiles_to_layer(tiles.cpu(), grid, t, viewport, False).image


class _Recorder:
    """csrc/untile.cu's C entry, recording its launch arguments."""

    def __init__(self):
        self.calls = []

    def svgr_untile(self, *args):
        self.calls.append(args)
        return 0


@pytest.mark.parametrize("t", TILES)
def test_untile_hands_the_kernel_its_arguments(t, monkeypatch):
    from svgrasterize_tpu_torch.ops import cuda_lib

    lib = _Recorder()
    monkeypatch.setattr(cuda_lib, "load", lambda: lib)
    monkeypatch.setattr(fused_exec, "_kernel_device", lambda device, what: True)
    monkeypatch.setattr(fused_exec, "_stream", lambda device: 77)
    grid_h, grid_w, h, w = untile_cases(t)["both_cropped"]
    tiles = _tiles(t, grid_h, grid_w, t)
    before = fused_exec.untile.launches
    got = fused_exec.untile(tiles, (grid_h, grid_w), t, (5, 7, h, w))
    assert lib.calls == [(tiles.data_ptr(), grid_w, t, got.data_ptr(), h, w, 77)]
    assert fused_exec.untile.launches == before + 1
    assert got.shape == (h, w, 4) and got.dtype == torch.float32 and got.is_contiguous()
    assert got.untyped_storage().data_ptr() != tiles.untyped_storage().data_ptr()
    # an empty viewport launches nothing
    assert fused_exec.untile(tiles, (grid_h, grid_w), t, (0, 0, 0, w)).shape == (0, w, 4)
    assert len(lib.calls) == 1 and fused_exec.untile.launches == before + 1


def _faults(device="cpu", t=32, grid=(2, 3)):
    """untile's arguments that the kernel does not take, by name."""
    tiles = _tiles(t, *grid, 0, device)
    n = grid[0] * grid[1]
    vp = (0, 0, grid[0] * t, grid[1] * t)
    return {
        "cpu_tensor": (tiles.cpu(), grid, t, vp),
        "float64": (tiles.double(), grid, t, vp),
        "grid_shape": (tiles, (grid[0] + 1, grid[1]), t, vp),
        "channels": (tiles[..., :3].contiguous(), grid, t, vp),
        "non_contiguous": (tiles.transpose(1, 2), grid, t, vp),
        "misaligned": (torch.zeros(n * t * t * 4 + 1, device=device)[1:].view(n, t, t, 4),
                       grid, t, vp),
        "tile_8": (tiles.reshape(-1, 8, 8, 4), (grid[0] * 4, grid[1] * 4), 8, vp),
        "viewport_too_tall": (tiles, grid, t, (0, 0, grid[0] * t + 1, 1)),
        "viewport_too_wide": (tiles, grid, t, (0, 0, 1, grid[1] * t + 1)),
    }


FAULTS = sorted(_faults())


@pytest.mark.parametrize("fault", FAULTS)
def test_untile_raises_on_what_the_kernel_does_not_take(fault, monkeypatch):
    if fault != "cpu_tensor":
        monkeypatch.setattr(fused_exec, "_kernel_device", lambda device, what: True)
    before = fused_exec.untile.launches
    with pytest.raises(ValueError, match="untile|tiles"):
        fused_exec.untile(*_faults()[fault])
    assert fused_exec.untile.launches == before


def test_render_many_copies_its_layer_out_of_the_frame_without_a_clone(doc_scene, monkeypatch):
    cs = serve(doc_scene)
    want = cs.render()
    as_on_the_card(cs, monkeypatch)
    cloned = []
    real_clone = torch.Tensor.clone

    def clone(self, *args, **kwargs):
        cloned.append(self.data_ptr())
        return real_clone(self, *args, **kwargs)

    monkeypatch.setattr(torch.Tensor, "clone", clone)
    frame = cs._frame.data_ptr()
    layers = [cs.render_many(1), cs.render_many(3)]
    assert frame not in cloned
    for layer in layers:
        assert (layer.offset, layer.pre_alpha, layer.linear_rgb) == (
            want.offset, want.pre_alpha, want.linear_rgb)
        assert torch.equal(_bits(layer.image), _bits(want.image))
        assert layer.image.untyped_storage().data_ptr() != frame
    # render_tiles_many's callers own its tiles: one clone, of the frame
    tiles = cs.render_tiles_many(2)
    assert cloned.count(frame) == 1
    assert tiles.data_ptr() != frame and torch.equal(_bits(tiles), _bits(cs._frame))
    assert cs.replays == 1 + 6  # the CPU's request in serve, then the replays


def test_requests_count_their_frames_whichever_method_serves_them(doc_scene):
    cs = serve(doc_scene)  # one render_many(1)
    cs.render_many(2)
    cs.render_tiles_many(3)
    cs.render_tiles()  # a frame outside any request
    assert cs.replays == 1 + 2 + 3


# ----------------------------------------------------------------------------
# on the card
# ----------------------------------------------------------------------------
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.card
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("t", TILES)
def test_untile_on_the_card_is_the_plain_layer_bit_for_bit(t, kind, card):
    grid_h, grid_w, h, w = untile_cases(t)[kind]
    tiles = _tiles(t, grid_h, grid_w, 100 + t + len(kind), card)
    viewport = (3, 1, h, w)
    before = fused_exec.untile.launches
    got = fused_exec.untile(tiles, (grid_h, grid_w), t, viewport)
    torch.cuda.synchronize()
    assert fused_exec.untile.launches == before + 1
    assert got.device == card and got.shape == (h, w, 4) and got.is_contiguous()
    assert got.untyped_storage().data_ptr() != tiles.untyped_storage().data_ptr()
    assert torch.equal(_bits(got.cpu()), _bits(_plain(tiles, (grid_h, grid_w), t, viewport)))
    layer = tiles_to_layer(tiles, (grid_h, grid_w), t, viewport, True)
    assert fused_exec.untile.launches == before + 2
    assert (layer.offset, layer.pre_alpha, layer.linear_rgb) == ((3, 1), True, True)
    assert torch.equal(_bits(layer.image), _bits(got))


@pytest.mark.card
@pytest.mark.parametrize("fault", FAULTS)
def test_untile_on_the_card_raises_on_what_the_kernel_does_not_take(fault, card):
    before = fused_exec.untile.launches
    with pytest.raises(ValueError, match="untile|tiles"):
        fused_exec.untile(*_faults(card)[fault])
    assert fused_exec.untile.launches == before


@pytest.mark.card
def test_render_many_on_the_card_copies_the_frame_once(doc_scene, card):
    scene, viewport = doc_scene
    lowered = lower_scene(scene, Transform().matrix(0, 1, 0, 1, 0, 0), viewport, False, 32,
                          device=card)
    cs = CompiledScene(lowered, viewport, False, device=card)
    cs.render_many(1)  # the eager warm-up frame and the capture
    before = fused_exec.untile.launches
    layers = [cs.render_many(1), cs.render_many(2)]
    tiles = cs.render_tiles_many(1)
    torch.cuda.synchronize()
    assert fused_exec.untile.launches == before + 2
    want = tiles_to_layer(tiles.cpu(), lowered.grid, 32, viewport, False).image
    frame = cs._frame.untyped_storage().data_ptr()
    for layer in layers:
        assert layer.image.untyped_storage().data_ptr() != frame
        assert torch.equal(_bits(layer.image.cpu()), _bits(want))
    assert tiles.untyped_storage().data_ptr() != frame
