"""The effects sheet (rasterbench/docs/effects_doc.py: lit buttons, morphology
halos and insets, diffuse embossing, turbulence grain) served by the port on
the CPU against the benchmark's plain reference (rasterbench/reference/
effects.py) within rasterbench/configs/effects_3840.json's limits; the
reference in bfloat16 fails those limits; and each new primitive of the
reference against the port's Filter on a seeded layer.  The second canvas
(600 x 190) leaves a partial tile on each axis and a grain card past the
bottom edge."""

from __future__ import annotations

import json
import os

import numpy as np
import pytest
import torch

from rasterbench.docs import effects_doc
from rasterbench.reference import compare, effects
from svgrasterize_tpu_torch import scene_from_str as t_scene_from_str
from svgrasterize_tpu_torch.core.layer import Layer
from svgrasterize_tpu_torch.core.transform import Transform
from svgrasterize_tpu_torch.frontend.svg import scene_from_str
from svgrasterize_tpu_torch.render_plan import CompiledScene, lower_scene

import torch_support  # noqa: F401 (the CPU thread budget)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_DRAWS = 64
SEEDS = (2 ** 31 + 11, 2 ** 32 + 5)


def _config():
    with open(os.path.join(ROOT, "rasterbench", "configs", "effects_3840.json"),
              encoding="utf-8") as f:
        return json.load(f)


def _fails(gaps, limits):
    return [name for name, limit in limits.items() if not gaps[name] <= limit]


@pytest.fixture(scope="module", params=[(640, 200, SEEDS[0]), (600, 190, SEEDS[1])],
                ids=lambda p: f"w{p[0]}")
def served(request):
    """(the served layer, the document's records, the canvas size, scale)."""
    width, height, seed = request.param
    config = _config()
    svg, doc = effects_doc.generate(seed, N_DRAWS, width, height)
    scene, _ids, (w, h) = scene_from_str(svg, None, width, None)
    viewport = (0, 0, int(h), int(w))
    lowered = lower_scene(scene, Transform().matrix(0, 1, 0, 1, 0, 0), viewport, False,
                          config["tile"], device="cpu")
    assert lowered is not None and lowered.groups
    cs = CompiledScene(lowered, viewport, False, device="cpu")
    return cs.render_many(1), doc, (int(h), int(w)), width / doc["width"]


def test_every_part_kind_is_on_the_sheet(served):
    _layer, doc, _size, _scale = served
    kinds = {}
    for item in doc["items"]:
        kind = item.get("filter", "").rstrip("0123456789")
        kinds[kind] = kinds.get(kind, 0) + 1
    assert kinds == {"": N_DRAWS, "lit": 12, "halo": 8, "inset": 4, "emboss": 4, "grain": 2}


def test_served_effects_are_within_the_limits(served):
    layer, doc, (h, w), scale = served
    assert tuple(layer.image.shape) == (h, w, 4) and tuple(layer.offset) == (0, 0)
    assert layer.pre_alpha and not layer.linear_rgb
    config = _config()
    ref = effects.render(doc, h, w, scale, tile=config["tile"], dtype=torch.float32)
    gaps = compare.gaps(layer.image, ref, config["block"])
    assert not _fails(gaps, config["limits"]), gaps


def test_the_reference_in_bfloat16_fails_the_limits(served):
    _layer, doc, (h, w), scale = served
    config = _config()
    ref = effects.render(doc, h, w, scale, tile=config["tile"], dtype=torch.float32)
    low = effects.render(doc, h, w, scale, tile=config["tile"], dtype=torch.bfloat16)
    gaps = compare.gaps(low, ref, config["block"])
    assert _fails(gaps, config["limits"]), gaps


# ----------------------------------------------------------------------------
# each new primitive: the reference against the port's Filter
# ----------------------------------------------------------------------------
SCALE = 1.25
OFFSET = (5, 7)
# (SVG primitive, its effects_doc-style record, tolerance and its reason)
PRIMITIVES = {
    "specular_point": (
        "<feSpecularLighting in='SourceAlpha' surfaceScale='5' specularConstant='.75'"
        " specularExponent='20' lighting-color='#bbbbbb'>"
        "<fePointLight x='-50' y='-100' z='200'/></feSpecularLighting>",
        dict(op="specular", input="SourceAlpha", surface_scale=5.0, constant=0.75,
             exponent=20.0, color=(187, 187, 187), light=("point", -50.0, -100.0, 200.0)),
        # equal here; a backend that sums the Sobel products in another
        # order moves N.H by an ulp, which its 20th power makes 20
        2e-6),
    "diffuse_distant": (
        "<feDiffuseLighting in='SourceAlpha' surfaceScale='3' diffuseConstant='1'"
        " lighting-color='white'><feDistantLight azimuth='45' elevation='45'/>"
        "</feDiffuseLighting>",
        dict(op="diffuse", input="SourceAlpha", surface_scale=3.0, constant=1.0,
             color=(255, 255, 255), light=("distant", 45.0, 45.0)),
        # equal here; an ulp of the Sobel sums where a backend orders them
        # otherwise
        1e-6),
    "dilate": (
        "<feMorphology in='SourceAlpha' operator='dilate' radius='2'/>",
        dict(op="morphology", input="SourceAlpha", operator="dilate", radius=2.0),
        # a maximum picks one of its inputs, the same alpha in both: exact
        0.0),
    "erode": (
        "<feMorphology in='SourceGraphic' operator='erode' radius='1'/>",
        dict(op="morphology", input="SourceGraphic", operator="erode", radius=1.0),
        # a minimum of premultiplied values that each package takes from
        # sRGB to linear with its own code: equal here, an ulp apart at most
        1e-6),
    "flood": (
        "<feFlood flood-color='#3080c0' flood-opacity='0.7'/>",
        dict(op="flood", color=(48, 128, 192), opacity=0.7),
        # the colour taken to linear RGB in float64 by both, then rounded
        # to float32: exact
        0.0),
    "turbulence": (
        "<feTurbulence type='fractalNoise' baseFrequency='0.65' numOctaves='3' seed='0'/>",
        dict(op="turbulence", kind="fractalNoise", base_frequency=(0.65, 0.65), octaves=3,
             seed=0),
        # equal here; the port maps a pixel to user space by multiplying
        # by 1 / 1.25, the reference divides by 1.25, so a point may lie an
        # ulp apart, which the noise's slope (about 3 a unit at 4 x 0.65)
        # keeps near 1e-5
        1e-5),
}


def _seeded_layer(seed: int, h: int = 24, w: int = 28) -> np.ndarray:
    """Seeded premultiplied sRGB RGBA with transparent, partial and opaque
    pixels."""
    rng = np.random.default_rng(seed)
    alpha = rng.uniform(0, 1, (h, w, 1))
    alpha[rng.random((h, w, 1)) < 0.15] = 0.0
    alpha[rng.random((h, w, 1)) < 0.15] = 1.0
    rgb = rng.uniform(0, 1, (h, w, 3)) * alpha
    return np.concatenate([rgb, alpha], -1).astype(np.float32)


@pytest.mark.parametrize("name", sorted(PRIMITIVES))
def test_reference_primitive_matches_the_port(name):
    svg_prim, record, tol = PRIMITIVES[name]
    image = _seeded_layer(sorted(PRIMITIVES).index(name))
    h, w = image.shape[:2]

    doc = ("<svg xmlns='http://www.w3.org/2000/svg' width='32' height='32'><defs>"
           f"<filter id='f'>{svg_prim}</filter></defs>"
           "<rect width='10' height='10' filter='url(#f)'/></svg>")
    flt = t_scene_from_str(doc)[1]["f"]
    transform = Transform().matrix(0, 1, 0, 1, 0, 0).scale(SCALE)
    got = flt(transform, Layer(torch.from_numpy(image), OFFSET, pre_alpha=True,
                               linear_rgb=False))

    ext, theirs = effects.apply_primitive(record, torch.from_numpy(image), OFFSET, SCALE)

    assert ext == (got.x, got.x + got.height, got.y, got.y + got.width)
    mine = got.convert(pre_alpha=False, linear_rgb=True).image
    assert float(mine.abs().max()) > 0.0
    assert float((mine - theirs).abs().max()) <= tol


def test_lighting_constants_are_row_major():
    """Filter.prepare uploads the Sobel kernels row-major, so a frame's
    convolutions copy neither (a transposed upload cost one copy a lighting
    primitive a frame)."""
    doc = ("<svg xmlns='http://www.w3.org/2000/svg' width='32' height='32'><defs>"
           f"<filter id='f'>{PRIMITIVES['specular_point'][0]}"
           f"{PRIMITIVES['diffuse_distant'][0]}</filter></defs>"
           "<rect width='10' height='10' filter='url(#f)'/></svg>")
    flt = t_scene_from_str(doc)[1]["f"]
    consts = flt.prepare(Transform().matrix(0, 1, 0, 1, 0, 0), "cpu")
    for sobel_r, sobel_c, _color in consts.primitives:
        assert sobel_r.is_contiguous() and sobel_c.is_contiguous()
        assert torch.equal(sobel_c, sobel_r.T)
