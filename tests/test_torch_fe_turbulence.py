"""The filter chains' feTurbulence kernel (csrc/fe_turbulence.cu via
ops/fused_exec.fe_turbulence) and filter._apply's choice of it.

On the CPU: filter._apply keeps turbulence_impl's image bit for bit and
never launches the kernel; the wrapper hands the C entry its arguments,
launches nothing for an empty region and raises on what the kernel does not
take; the effects_3840 benchmark sheet carries 2 turbulence primitives, the
two grain cards.  The tests marked `card` hold the kernel to
turbulence_impl on a CUDA card (fractalNoise and turbulence, 1 to 8
octaves, baseFrequency x and y apart, scaled, rotated and skewed
transforms, offsets, sizes from 0 x w and 1 x 1 to the grain cards') and
the served effects frame to two launches; they skip without a card.  There
(no JAX, so without tests/conftest.py):

    python -m pytest tests/test_torch_fe_turbulence.py --noconftest -q
"""

from __future__ import annotations

import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from svgrasterize_tpu_torch import filter as tfilter
from svgrasterize_tpu_torch.core.layer import Layer
from svgrasterize_tpu_torch.core.transform import Transform
from svgrasterize_tpu_torch.frontend.svg import scene_from_str
from svgrasterize_tpu_torch.ops import fused_exec
from svgrasterize_tpu_torch.ops.turbulence import lattice_tables, turbulence_impl
from svgrasterize_tpu_torch.render_plan import CompiledScene, lower_scene

from chip_smoke import TURBULENCE_TOL
import torch_support  # noqa: F401 (the CPU thread budget)

ROOT = Path(__file__).resolve().parent.parent
EXEC_TOL = 1e-5  # a replayed frame against the eager frame (tests/test_torch_fe_blur.py)
VIEW = Transform().matrix(0, 1, 0, 1, 0, 0)  # the served frames' user -> (row, column)

# the effects_3840 frame's grain cards (seed 0 at 3840 x 985, T=32): each
# feTurbulence's output region (offset, (h, w)) under VIEW, fractalNoise at
# 0.65 with 3 octaves and seed 0, in linearRGB
GRAIN_CARDS = (((184, 148), (203, 323)), ((361, 2468), (203, 323)))

TRANSFORMS = {
    "view": VIEW,
    "scale": VIEW.translate(-31.25, 17.5).scale(2.58),
    "rotate": VIEW.translate(120.0, -40.0).rotate(math.radians(30.0)).scale(1.7, 0.8),
    "skew": VIEW.translate(-5.0, 9.0).skew(math.radians(25.0), math.radians(-10.0)),
}

# name -> (offset, (h, w), transform, base_fx, base_fy, octaves, fractal, seed)
CASES = {
    **{f"grain_card_{i}": (offset, size, "view", 0.65, 0.65, 3, True, 0)
       for i, (offset, size) in enumerate(GRAIN_CARDS)},
    "one_pixel": ((7, -3), (1, 1), "scale", 0.05, 0.12, 2, True, 3),
    "empty_rows": ((0, 0), (0, 41), "view", 0.1, 0.1, 1, True, 0),
    "empty_columns": ((5, 5), (17, 0), "view", 0.1, 0.1, 1, False, 0),
    "odd_width_turbulence": ((-13, 29), (37, 101), "view", 0.09, 0.09, 2, False, 5),
    "one_octave": ((3, 8), (64, 77), "rotate", 0.2, 0.07, 1, True, 11),
    "two_octaves_skew": ((-40, 12), (90, 133), "skew", 0.05, 0.12, 2, True, 42),
    "eight_octaves": ((100, -250), (55, 257), "scale", 0.013, 0.031, 8, False, -7),
    "eight_octaves_fractal": ((9, 9), (129, 63), "rotate", 0.4, 0.4, 8, True, 2 ** 31 + 3),
    "wide_scaled": ((32, 64), (544, 832), "scale", 0.65, 0.65, 3, True, 0),
}


def _case(name: str, device="cpu"):
    """(selector, gradient, offset, (h, w), transform, fx, fy, octaves,
    fractal) of a case, its tables as Filter.prepare uploads them to
    device (the selector int32 on the card, int64 on the CPU)."""
    offset, size, transform, fx, fy, octaves, fractal, seed = CASES[name]
    attrs = (fx, fy, octaves, seed, fractal, None)
    selector, gradient = tfilter._prepare_primitive(tfilter.FE_TURBULENCE, attrs,
                                                    TRANSFORMS[transform], True, device)
    return (selector, gradient, offset, size, TRANSFORMS[transform], fx, fy, octaves,
            fractal)


def _plain(selector, gradient, offset, size, transform, fx, fy, octaves, fractal):
    """turbulence_impl over the region's pixel centres in user space, formed
    step by step as the CPU's path forms them, on the tables' device."""
    (h, w), inv, dev = size, transform.invert.m, gradient.device
    pr = torch.arange(h, dtype=torch.float32, device=dev)[:, None] + offset[0] + 0.5
    pc = torch.arange(w, dtype=torch.float32, device=dev)[None, :] + offset[1] + 0.5
    ux = float(inv[0, 0]) * pr + float(inv[0, 1]) * pc + float(inv[0, 2])
    uy = float(inv[1, 0]) * pr + float(inv[1, 1]) * pc + float(inv[1, 2])
    ux, uy = torch.broadcast_tensors(ux, uy)
    return turbulence_impl(selector, gradient, ux, uy, fx, fy, octaves, fractal)


def _kernel(selector, gradient, offset, size, transform, fx, fy, octaves, fractal):
    return fused_exec.fe_turbulence(selector, gradient, offset, size,
                                    transform.invert.m[:2], fx, fy, octaves, fractal)


def _source(offset, size, device) -> Layer:
    """A source graphic whose extent is the region (its pixels unread)."""
    image = torch.full((*size, 4), 0.5, dtype=torch.float32, device=device)
    return Layer(image, offset, pre_alpha=True, linear_rgb=False)


def _apply(name: str, device):
    """filter._apply of the case's primitive on a source on device."""
    offset, size, transform, fx, fy, octaves, fractal, seed = CASES[name]
    attrs = (fx, fy, octaves, seed, fractal, None)
    const = tfilter._prepare_primitive(tfilter.FE_TURBULENCE, attrs, TRANSFORMS[transform],
                                       True, device)
    return tfilter._apply(tfilter.FE_TURBULENCE, attrs, [_source(offset, size, device)],
                          TRANSFORMS[transform], True, const)


# ----------------------------------------------------------------------------
# on the CPU
# ----------------------------------------------------------------------------
def test_the_tables_are_the_kernels_table_size():
    selector, gradient = lattice_tables(0)
    assert selector.shape == (fused_exec.TURBULENCE_TABLE,) and selector.dtype == np.int32
    assert gradient.shape == (4, fused_exec.TURBULENCE_TABLE, 2)
    assert 0 <= selector.min() and selector.max() < 256  # the kernel's bound on entries


@pytest.mark.parametrize("name", sorted(CASES))
def test_apply_on_the_cpu_is_turbulence_impl_bit_for_bit(name):
    """The CPU's path is unchanged: the int64 selector, turbulence_impl over
    the pixel centres, no kernel launch."""
    selector, gradient, offset, size, *_rest = args = _case(name)
    assert selector.dtype == torch.int64 and gradient.dtype == torch.float32
    before = fused_exec.fe_turbulence.launches
    got = _apply(name, "cpu")
    want = _plain(*args)
    assert fused_exec.fe_turbulence.launches == before
    assert (got.offset, got.pre_alpha, got.linear_rgb) == (offset, False, True)
    assert tuple(got.image.shape) == (*size, 4)
    assert torch.equal(got.image.view(torch.int32), want.view(torch.int32))


class _Recorder:
    """csrc/fe_turbulence.cu's C entry, recording its launch arguments."""

    def __init__(self):
        self.calls = []

    def svgr_fe_turbulence(self, *args):
        self.calls.append(args)
        return 0


@pytest.fixture
def recorded(monkeypatch):
    from svgrasterize_tpu_torch.ops import cuda_lib

    lib = _Recorder()
    monkeypatch.setattr(cuda_lib, "load", lambda: lib)
    monkeypatch.setattr(fused_exec, "_kernel_device", lambda device, what: True)
    monkeypatch.setattr(fused_exec, "_stream", lambda device: 77)
    return lib


@pytest.mark.parametrize("name", sorted(CASES))
def test_fe_turbulence_hands_the_kernel_its_arguments(name, recorded):
    selector, gradient, offset, (h, w), transform, fx, fy, octaves, fractal = _case(name)
    selector = selector.to(torch.int32)  # as the card's route uploads it
    before = fused_exec.fe_turbulence.launches
    got = fused_exec.fe_turbulence(selector, gradient, offset, (h, w),
                                   transform.invert.m[:2], fx, fy, octaves, fractal)
    assert got.shape == (h, w, 4) and got.dtype == torch.float32 and got.is_contiguous()
    if not (h and w):
        assert recorded.calls == [] and fused_exec.fe_turbulence.launches == before
        return
    assert fused_exec.fe_turbulence.launches == before + 1
    inv = transform.invert.m
    assert recorded.calls == [(selector.data_ptr(), gradient.data_ptr(), *offset, h, w,
                               *(float(v) for v in inv[:2].ravel()), fx, fy, octaves,
                               int(fractal), got.data_ptr(), 77)]


def _faults(device="cpu"):
    """fe_turbulence's arguments that the kernel does not take, by name."""
    selector, gradient, offset, size, transform, fx, fy, octaves, fractal = _case(
        "odd_width_turbulence", device)
    selector = selector.to(torch.int32)  # as the card's route uploads it
    inv = transform.invert.m[:2]
    good = dict(selector=selector, gradient=gradient, offset=offset, size=size, inverse=inv,
                base_fx=fx, base_fy=fy, octaves=octaves, fractal=fractal)
    return {
        "cpu_tables": dict(good, selector=selector.cpu(), gradient=gradient.cpu()),
        "selector_int64": dict(good, selector=selector.long()),
        "selector_float": dict(good, selector=selector.float()),
        "selector_short": dict(good, selector=selector[:-1]),
        "gradient_float64": dict(good, gradient=gradient.double()),
        "gradient_one_channel": dict(good, gradient=gradient[:1].contiguous()),
        "selector_misaligned": dict(
            good, selector=torch.zeros(fused_exec.TURBULENCE_TABLE + 1, dtype=torch.int32,
                                       device=device)[1:]),
        "gradient_misaligned": dict(
            good, gradient=torch.zeros(gradient.numel() + 1, device=device)[1:].view(
                gradient.shape)),
        "gradient_non_contiguous": dict(
            good, gradient=gradient.transpose(1, 2).contiguous().transpose(1, 2)),
        "inverse_3x3": dict(good, inverse=transform.invert.m),
        "octaves_zero": dict(good, octaves=0),
        "octaves_negative": dict(good, octaves=-2),
        "negative_height": dict(good, size=(-1, 5)),
        "past_32_bits": dict(good, offset=(2 ** 31 - 10, 0)),
    }


FAULTS = sorted(_faults())


@pytest.mark.parametrize("fault", FAULTS)
def test_fe_turbulence_raises_on_what_the_kernel_does_not_take(fault, monkeypatch):
    if fault != "cpu_tables":
        monkeypatch.setattr(fused_exec, "_kernel_device", lambda device, what: True)
    before = fused_exec.fe_turbulence.launches
    with pytest.raises(ValueError, match="fe_turbulence|selector|gradient"):
        fused_exec.fe_turbulence(**_faults()[fault])
    assert fused_exec.fe_turbulence.launches == before


def _effects_sheet(device):
    """The effects_3840 benchmark cell's document (seed 0), compiled."""
    from rasterbench.docs import effects_doc

    config = json.loads((ROOT / "rasterbench" / "configs" / "effects_3840.json").read_text())
    svg, _records = effects_doc.generate(0, **config["args"])
    scene, _ids, (w, h) = scene_from_str(svg, None, config["width"], None)
    viewport = (0, 0, int(h), int(w))
    lowered = lower_scene(scene, VIEW, viewport, False, config["tile"], device=device)
    return CompiledScene(lowered, viewport, False, device=device)


def _turbulence_attrs(program) -> list:
    """The attributes of every feTurbulence the program's filter chains run
    a frame."""
    return [attrs for level in program.levels for part in level.filters
            for kind, attrs, _inputs in part.flt.filters if kind == tfilter.FE_TURBULENCE]


def test_the_effects_sheet_carries_two_turbulence_primitives(monkeypatch):
    """The cell's frame runs 2 feTurbulence, the grain cards: fractalNoise
    at 0.65, 3 octaves, seed 0, over the regions GRAIN_CARDS names."""
    cs = _effects_sheet("cpu")
    assert _turbulence_attrs(cs.program) == [(0.65, 0.65, 3, 0, True, None)] * 2
    regions = []
    real = tfilter._apply

    def recorded(kind, attrs, inputs, transform, linear, const):
        out = real(kind, attrs, inputs, transform, linear, const)
        if kind == tfilter.FE_TURBULENCE:
            regions.append((out.offset, tuple(out.image.shape[:2]), linear,
                            np.array_equal(transform.m, VIEW.m)))
        return out

    monkeypatch.setattr(tfilter, "_apply", recorded)
    cs.render_tiles()
    assert regions == [(offset, size, True, True) for offset, size in GRAIN_CARDS]


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
def test_fe_turbulence_on_the_card_matches_plain(name, card):
    args = _case(name, card)
    selector, _gradient, _offset, (h, w), *_rest = args
    assert selector.dtype == torch.int32
    before = fused_exec.fe_turbulence.launches
    got = _kernel(*args)
    torch.cuda.synchronize()
    assert fused_exec.fe_turbulence.launches == before + (1 if h and w else 0)
    assert got.device == card and got.shape == (h, w, 4)
    if not (h and w):
        return
    assert bool(torch.isfinite(got).all())
    assert 0.0 <= float(got.min()) and float(got.max()) <= 1.0
    assert float((got - _plain(*args)).abs().max()) <= TURBULENCE_TOL
    assert float((got.cpu() - _plain(*_case(name))).abs().max()) <= TURBULENCE_TOL


@pytest.mark.card
@pytest.mark.parametrize("fault", FAULTS + ["tables_on_two_devices"])
def test_fe_turbulence_on_the_card_raises_on_what_the_kernel_does_not_take(fault, card):
    if fault == "tables_on_two_devices":
        args = _faults(card)["octaves_zero"]
        args = dict(args, octaves=3, gradient=args["gradient"].cpu())
    else:
        args = _faults(card)[fault]
    before = fused_exec.fe_turbulence.launches
    with pytest.raises(ValueError, match="fe_turbulence|selector|gradient"):
        fused_exec.fe_turbulence(**args)
    assert fused_exec.fe_turbulence.launches == before


@pytest.mark.card
@pytest.mark.parametrize("name", sorted(CASES))
def test_apply_on_the_card_takes_the_kernel(name, card):
    """filter._apply on a source on the card: one fe_turbulence launch (none
    for an empty region), within TURBULENCE_TOL of the CPU's path."""
    _offset, (h, w), *_rest = CASES[name]
    before = fused_exec.fe_turbulence.launches
    got = _apply(name, card)
    torch.cuda.synchronize()
    assert fused_exec.fe_turbulence.launches == before + (1 if h and w else 0)
    want = _apply(name, "cpu")
    assert (got.offset, got.pre_alpha, got.linear_rgb) == (want.offset, False, True)
    assert got.image.shape == want.image.shape
    if h and w:
        assert float((got.image.cpu() - want.image).abs().max()) <= TURBULENCE_TOL


@pytest.mark.card
def test_a_captured_effects_frame_launches_two_turbulence_kernels(card):
    """A served effects frame captures one fe_turbulence launch a grain card
    and equals the eager frame on the card."""
    cs = _effects_sheet(card)
    eager = cs.render_tiles()
    fused_exec.reset_launch_counts()
    tiles = cs.render_tiles_many(1)
    torch.cuda.synchronize()
    assert cs.frame_launches["fe_turbulence"] == 2
    # two a frame: the eager frame before the capture, and the captured one
    assert fused_exec.fe_turbulence.launches == 4
    assert float((tiles - eager).abs().max()) <= EXEC_TOL
