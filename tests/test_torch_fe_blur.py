"""The filter chains' separable blur kernel (csrc/fe_blur.cu via
ops/fused_exec.fe_blur) and Layer.convolve's choice of it.

On the CPU: Layer.convolve keeps its conversion and band matmuls bit for
bit; the kernel's plain version (ops/blur.fe_blur) is the full 2D
convolution of the un-premultiplied layer (float64, within 1e-6); the
wrapper hands the C entry its arguments, a scratch layer only for taps too
long for one launch's shared memory (the rule csrc/fe_blur.cu states), and
raises on what the kernel does not take; the icons_3840 benchmark sheet
carries 8 separable chain blurs.  The tests marked `card` hold the kernel
to the plain version on a CUDA card and skip without one; there (no JAX,
so without tests/conftest.py):

    python -m pytest tests/test_torch_fe_blur.py --noconftest -q
"""

from __future__ import annotations

import json
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from svgrasterize_tpu_torch import filter as tfilter
from svgrasterize_tpu_torch.core.color import pre_to_straight_alpha
from svgrasterize_tpu_torch.core.layer import Layer
from svgrasterize_tpu_torch.core.transform import Transform
from svgrasterize_tpu_torch.frontend.svg import scene_from_str
from svgrasterize_tpu_torch.ops import blur, fused_exec
from svgrasterize_tpu_torch.render_plan import CompiledScene, lower_scene

from chip_smoke import BLUR_TOL
from torch_support import doc_scene  # noqa: F401 (a fixture)

ROOT = Path(__file__).resolve().parent.parent
EXEC_TOL = 1e-5  # a card frame against the same program on the CPU (tests/test_torch_passes.py)
THRESHOLD = np.float32(0.0001)  # core/color.py pre_to_straight_alpha's alpha floor

# the icons_3840 frame's chain blurs (seed 0 at 3840 x 985, T=32): each
# drop shadow's SourceAlpha crop and its square taps
ICON_BLURS = (((163, 178), 15), ((93, 214), 11), ((172, 173), 5), ((136, 204), 15),
              ((105, 96), 13), ((111, 153), 19), ((213, 213), 5), ((214, 213), 5))


def _gaussian(k: int) -> np.ndarray:
    x = np.arange(k) - (k - 1) / 2
    g = np.exp(-x * x / (2 * (k / 5) ** 2))
    return (g / g.sum()).astype(np.float32)


def _taps(kh: int, kw: int, device="cpu") -> blur.BlurTaps:
    return blur.BlurTaps((kh, kw), torch.from_numpy(_gaussian(kh)).to(device),
                         torch.from_numpy(_gaussian(kw)).to(device), None)


def _premultiplied(rng, h: int, w: int) -> np.ndarray:
    """Random premultiplied RGBA; a tenth of the pixels transparent, a
    tenth at the un-premultiply's floor (0.0001 and the floats beside it)."""
    alpha = rng.uniform(0, 1, (h, w, 1)).astype(np.float32)
    pick = rng.random((h, w, 1))
    floor = np.array([np.nextafter(THRESHOLD, 0), THRESHOLD, np.nextafter(THRESHOLD, 1)],
                     np.float32)
    alpha = np.where(pick < 0.1, 0, alpha)
    alpha = np.where(pick > 0.9, floor[rng.integers(0, 3, (h, w, 1))], alpha)
    rgb = rng.uniform(0, 1, (h, w, 3)).astype(np.float32)
    rgb = np.where(pick > 0.95, rng.uniform(0, 1e-4, (h, w, 3)), rgb * alpha)
    return np.concatenate([rgb, alpha], -1).astype(np.float32)


# name -> (h, w, kh, kw, unpremultiply)
CASES = {
    **{f"icon_{i}": (*shape, k, k, True) for i, (shape, k) in enumerate(ICON_BLURS)},
    "one_pixel": (1, 1, 5, 5, True),
    "kh_ne_kw": (40, 70, 7, 21, True),
    "one_column": (150, 1, 9, 3, True),
    "long_taps_narrow_layer": (12, 9, 61, 41, True),
    "long_rows": (30, 200, 101, 3, True),
    "alpha_floor": (64, 64, 9, 9, True),
    "straight_flag_off": (50, 80, 11, 7, False),
}


def _case(name: str, device="cpu"):
    """(image, taps, unpremultiply) of a case; seeded by its name."""
    h, w, kh, kw, unpremultiply = CASES[name]
    rng = np.random.default_rng(sum(name.encode()) + 1000 * h + w)
    image = _premultiplied(rng, h, w)
    if name == "alpha_floor":  # every pixel at or beside the floor, or 0
        image[..., 3] = rng.choice([0, np.nextafter(THRESHOLD, 0), THRESHOLD,
                                    np.nextafter(THRESHOLD, 1)], (h, w))
    if not unpremultiply:  # an already straight layer
        image = pre_to_straight_alpha(torch.from_numpy(image)).numpy()
    return torch.from_numpy(image).to(device), _taps(kh, kw, device), unpremultiply


def _full_convolution(image: np.ndarray, u: np.ndarray, v: np.ndarray) -> np.ndarray:
    """The full 2D convolution with outer(u, v) in float64, tap by tap."""
    h, w, ch = image.shape
    x = image.astype(np.float64)
    rows = np.zeros((h + len(u) - 1, w, ch))
    for a, t in enumerate(u.astype(np.float64)):
        rows[a:a + h] += t * x
    out = np.zeros((h + len(u) - 1, w + len(v) - 1, ch))
    for b, t in enumerate(v.astype(np.float64)):
        out[:, b:b + w] += t * rows
    return out


# ----------------------------------------------------------------------------
# on the CPU
# ----------------------------------------------------------------------------
@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_fe_blur_is_the_full_convolution_of_the_straight_layer(name):
    image, taps, unpremultiply = _case(name)
    got = blur.fe_blur(image, taps.u, taps.v, unpremultiply)
    straight = pre_to_straight_alpha(image) if unpremultiply else image
    want = _full_convolution(straight.numpy(), taps.u.numpy(), taps.v.numpy())
    assert got.shape == want.shape
    assert np.abs(got.numpy() - want).max() <= 1e-6


def _rotated(k: int) -> np.ndarray:
    """A normalised Gaussian kernel that does not separate (rotated axes)."""
    r = np.arange(k) - (k - 1) / 2
    y, x = np.meshgrid(r, r, indexing="ij")
    g = np.exp(-((x + y) ** 2) / 8 - ((x - y) ** 2) / 40)
    return (g / g.sum()).astype(np.float32)


# (pre_alpha, the layer's colorspace, the chain's, channels)
STATES = {
    "premultiplied": (True, False, False, 4),
    "premultiplied_linear": (True, True, True, 4),
    "straight": (False, False, False, 4),
    "premultiplied_to_linear": (True, False, True, 4),
    "straight_to_srgb": (False, True, False, 4),
    "alpha_only": (True, False, False, 1),
}


def _state_layer(state: str, device="cpu") -> Layer:
    pre, linear, _target, channels = STATES[state]
    image = torch.from_numpy(_premultiplied(np.random.default_rng(len(state)), 37, 29))
    if not pre:
        image = pre_to_straight_alpha(image)
    return Layer(image[..., 4 - channels:].contiguous().to(device), (5, -3), pre, linear)


@pytest.mark.parametrize("kind", ["separable", "rotated"])
@pytest.mark.parametrize("state", sorted(STATES))
def test_convolve_on_the_cpu_is_the_conversion_then_the_band_matmuls(state, kind):
    """The CPU's path bit for bit: convert to straight alpha in the chain's
    colorspace, then convolve_separable (or convolve_full)."""
    layer = _state_layer(state)
    target = STATES[state][2]
    kernel = np.outer(_gaussian(7), _gaussian(5)) if kind == "separable" else _rotated(7)
    taps = blur.upload_kernel(kernel, "cpu")
    assert (taps.full is None) == (kind == "separable")
    before = fused_exec.fe_blur.launches
    got = layer.convolve(taps, target)
    ref = layer.convert(pre_alpha=False, linear_rgb=target)
    want = (blur.convolve_separable(ref.image, taps.u, taps.v) if taps.full is None
            else blur.convolve_full(ref.image, taps.full))
    assert fused_exec.fe_blur.launches == before
    kh, kw = taps.shape
    assert (got.offset, got.pre_alpha, got.linear_rgb) == (
        (int(5 - kh / 2), int(-3 - kw / 2)), False, target)
    assert torch.equal(got.image.view(torch.int32), want.view(torch.int32))
    # an array kernel is uploaded and takes the same path
    again = layer.convolve(kernel, target)
    assert torch.equal(again.image.view(torch.int32), want.view(torch.int32))


def test_the_launch_rule_is_the_sources():
    """fe_blur_launches mirrors csrc/fe_blur.cu: its block's output tile and
    shared-memory limit; one launch up to square taps of 32, and for the
    icon sheet's taps."""
    src = (Path(fused_exec.__file__).resolve().parent.parent / "csrc" / "fe_blur.cu").read_text()
    consts = {k: int(v) for k, v in re.findall(r"constexpr \w+ (k\w+) = (\d+)", src)}
    assert (consts["kTileH"], consts["kTileW"]) == fused_exec.FE_BLUR_TILE
    shared = re.search(r"kSharedMax = (\d+) \* (\d+);", src)
    assert int(shared.group(1)) * int(shared.group(2)) == fused_exec.FE_BLUR_SHARED
    assert [fused_exec.fe_blur_launches(k, k) for k in (3, 19, 32, 33, 61)] == [1, 1, 1, 2, 2]
    assert {fused_exec.fe_blur_launches(k, k) for _shape, k in ICON_BLURS} == {1}
    assert fused_exec.fe_blur_launches(101, 3) == 2 and fused_exec.fe_blur_launches(3, 101) == 1


class _Recorder:
    """csrc/fe_blur.cu's C entry, recording its launch arguments."""

    def __init__(self):
        self.calls = []

    def svgr_fe_blur(self, *args):
        self.calls.append(args)
        return 0


@pytest.mark.parametrize("name", ["icon_5", "kh_ne_kw", "long_taps_narrow_layer", "long_rows"])
def test_fe_blur_hands_the_kernel_its_arguments(name, monkeypatch):
    from svgrasterize_tpu_torch.ops import cuda_lib

    lib = _Recorder()
    monkeypatch.setattr(cuda_lib, "load", lambda: lib)
    monkeypatch.setattr(fused_exec, "_kernel_device", lambda device, what: True)
    monkeypatch.setattr(fused_exec, "_stream", lambda device: 77)
    image, taps, unpremultiply = _case(name)
    h, w, kh, kw, _ = CASES[name]
    launches = fused_exec.fe_blur_launches(kh, kw)
    scratches = []
    real_empty = torch.empty

    def empty(*args, **kwargs):
        t = real_empty(*args, **kwargs)
        scratches.append(t)
        return t

    monkeypatch.setattr(torch, "empty", empty)
    before = fused_exec.fe_blur.launches
    got = fused_exec.fe_blur(image, taps, unpremultiply)
    assert got.shape == (h + kh - 1, w + kw - 1, 4) and got.is_contiguous()
    assert fused_exec.fe_blur.launches == before + launches
    out, *scratch = scratches
    assert out.data_ptr() == got.data_ptr()
    if launches == 1:
        assert scratch == []
    else:
        assert [tuple(s.shape) for s in scratch] == [(h + kh - 1, w, 4)]
    assert lib.calls == [(image.data_ptr(), h, w, taps.u.data_ptr(), kh, taps.v.data_ptr(), kw,
                          int(unpremultiply), scratch[0].data_ptr() if scratch else None,
                          got.data_ptr(), 77)]


def _faults(device="cpu"):
    """fe_blur's arguments that the kernel does not take, by name."""
    image, taps, _ = _case("kh_ne_kw", device)
    return {
        "cpu_image": (image.cpu(), taps, True),
        "float64": (image.double(), taps, True),
        "three_channels": (image[..., :3].contiguous(), taps, True),
        "non_contiguous": (image.transpose(0, 1), taps, True),
        "misaligned": (torch.zeros(image.numel() + 1, device=device)[1:].view(image.shape),
                       taps, True),
        "rotated_taps": (image, blur.upload_kernel(_rotated(5), device), True),
        "short_u": (image, taps._replace(u=taps.u[:-1]), True),
        "taps_float64": (image, taps._replace(v=taps.v.double()), True),
    }


FAULTS = sorted(_faults())


@pytest.mark.parametrize("fault", FAULTS)
def test_fe_blur_raises_on_what_the_kernel_does_not_take(fault, monkeypatch):
    if fault != "cpu_image":
        monkeypatch.setattr(fused_exec, "_kernel_device", lambda device, what: True)
    before = fused_exec.fe_blur.launches
    with pytest.raises(ValueError, match="fe_blur|image|taps|u |v "):
        fused_exec.fe_blur(*_faults()[fault])
    assert fused_exec.fe_blur.launches == before


def chain_blurs(program) -> list:
    """(kh, kw) of every separable blur the program's filter chains run a
    frame: feGaussianBlur and feDropShadow primitives whose taps separate."""
    found = []
    for level in program.levels:
        for part in level.filters:
            for (kind, _attrs, _inputs), const in zip(part.flt.filters,
                                                       part.consts.primitives):
                taps = const[0] if kind == tfilter.FE_DROP_SHADOW else const
                if kind in (tfilter.FE_GAUSSIAN_BLUR, tfilter.FE_DROP_SHADOW) \
                        and taps is not None and taps.full is None:
                    found.append(tuple(taps.shape))
    return found


def _icon_sheet(device):
    """The icons_3840 benchmark cell's document (seed 0), compiled."""
    from rasterbench.docs import pass_doc as icons

    config = json.loads((ROOT / "rasterbench" / "configs" / "icons_3840.json").read_text())
    svg, _records = icons.generate(0, **config["args"])
    scene, _ids, (w, h) = scene_from_str(svg, None, config["width"], None)
    viewport = (0, 0, int(h), int(w))
    lowered = lower_scene(scene, Transform().matrix(0, 1, 0, 1, 0, 0), viewport, False,
                          config["tile"], device=device)
    return CompiledScene(lowered, viewport, False, device=device)


def test_the_icon_sheet_carries_eight_separable_chain_blurs():
    """The cell's frame runs 8 chain blurs, all separable and all short
    enough for one launch: the drop shadows' SourceAlpha blurs."""
    blurs = chain_blurs(_icon_sheet("cpu").program)
    assert sorted(blurs) == sorted((k, k) for _shape, k in ICON_BLURS)
    assert {fused_exec.fe_blur_launches(*k) for k in blurs} == {1}


def _serve_doc(doc: str, device, doc_scene):
    if doc == "icons_3840":
        return _icon_sheet(device)
    scene, viewport = doc_scene
    lowered = lower_scene(scene, Transform().matrix(0, 1, 0, 1, 0, 0), viewport, False, 32,
                          device=device)
    return CompiledScene(lowered, viewport, False, device=device)


def test_the_pass_document_carries_chain_blurs(doc_scene):
    """The tests' pass document has separable chain blurs, so its frame
    reaches the kernel on the card."""
    assert chain_blurs(_serve_doc("pass_doc", "cpu", doc_scene).program)


# ----------------------------------------------------------------------------
# on the card
# ----------------------------------------------------------------------------
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.card
@pytest.mark.parametrize("name", sorted(CASES))
def test_fe_blur_on_the_card_matches_plain(name, card):
    image, taps, unpremultiply = _case(name, card)
    h, w, kh, kw, _ = CASES[name]
    before = fused_exec.fe_blur.launches
    got = fused_exec.fe_blur(image, taps, unpremultiply)
    torch.cuda.synchronize()
    assert fused_exec.fe_blur.launches == before + fused_exec.fe_blur_launches(kh, kw)
    assert got.device == card and got.shape == (h + kh - 1, w + kw - 1, 4)
    want = blur.fe_blur(image.cpu(), taps.u.cpu(), taps.v.cpu(), unpremultiply)
    assert bool(torch.isfinite(got).all())
    assert float((got.cpu() - want).abs().max()) <= BLUR_TOL
    on_card = blur.fe_blur(image, taps.u, taps.v, unpremultiply)
    assert float((got - on_card).abs().max()) <= BLUR_TOL


@pytest.mark.card
@pytest.mark.parametrize("fault", FAULTS + ["taps_on_cpu"])
def test_fe_blur_on_the_card_raises_on_what_the_kernel_does_not_take(fault, card):
    if fault == "taps_on_cpu":
        image, taps, _ = _case("kh_ne_kw", card)
        args = (image, _taps(*taps.shape), True)
    else:
        args = _faults(card)[fault]
    before = fused_exec.fe_blur.launches
    with pytest.raises(ValueError, match="fe_blur|image|taps|u |v "):
        fused_exec.fe_blur(*args)
    assert fused_exec.fe_blur.launches == before


@pytest.mark.card
@pytest.mark.parametrize("kind", ["separable", "rotated"])
@pytest.mark.parametrize("state", sorted(STATES))
def test_convolve_on_the_card_takes_the_kernel_for_separable_rgba(state, kind, card):
    """Layer.convolve on the card: one fe_blur launch for a 4-channel layer
    whose taps separate, un-premultiplying in the kernel where the
    colorspace stays; otherwise today's path.  Within BLUR_TOL of the CPU."""
    target = STATES[state][2]
    kernel = np.outer(_gaussian(7), _gaussian(5)) if kind == "separable" else _rotated(7)
    want = _state_layer(state).convolve(blur.upload_kernel(kernel, "cpu"), target)
    calls = []
    real = fused_exec.fe_blur

    def recorded(image, taps, unpremultiply):
        calls.append(unpremultiply)
        return real(image, taps, unpremultiply)

    recorded.launches = 0  # the kernel's count while it stands in

    layer = _state_layer(state, card)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fused_exec, "fe_blur", recorded)
        got = layer.convolve(blur.upload_kernel(kernel, card), target)
    torch.cuda.synchronize()
    pre, linear, _target, channels = STATES[state]
    expect = [pre and linear == target] if kind == "separable" and channels == 4 else []
    assert calls == expect
    assert (got.offset, got.pre_alpha, got.linear_rgb) == (want.offset, False, target)
    assert float((got.image.cpu() - want.image).abs().max()) <= BLUR_TOL


@pytest.mark.card
@pytest.mark.parametrize("doc", ["pass_doc", "icons_3840"])
def test_a_captured_frame_launches_one_blur_per_chain_blur(doc, doc_scene, card):
    """A served frame captures one fe_blur launch per separable chain blur
    its program carries (8 in the icon sheet) and equals the frame the same
    program renders on the CPU, through the band matmuls."""
    cs = _serve_doc(doc, card, doc_scene)
    blurs = chain_blurs(cs.program)
    tiles = cs.render_tiles_many(1)
    torch.cuda.synchronize()
    assert cs.frame_launches["fe_blur"] == len(blurs) > 0
    if doc == "icons_3840":
        assert len(blurs) == 8
    want = _serve_doc(doc, "cpu", doc_scene).render_tiles()
    assert float((tiles.cpu() - want).abs().max()) <= EXEC_TOL
