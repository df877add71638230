"""The port's interpreter slice against the JAX package, on the CPU.

The plain whole-image winding (ops/coverage.winding, the plain version of
csrc/winding.cu) against JAX coverage.winding and the Pallas winding kernel
in interpret mode; the batched entry (fused_exec.winding_batch) equal to
per-mask fields; fill rules and gradient fills; path_mask / path_fill;
RasterImage.render; Scene.render with group batching off (a per-path
oracle) and on (render_group_hybrid, JAX under SVGR_FUSED=0), and the masks
it gathers into one winding_batch call per render; pattern and
image lowering, its executor, and the CLI.  f32 fields agree within 1e-5
(the same closed forms, summed in another order); lowered arrays are
bit-identical except the pattern atlas and the collapse fields that gather
from it; PNGs agree within 1/255.  The kernel itself runs only on a CUDA
card, where chip_smoke.py holds it against the plain version.
"""

from __future__ import annotations

import base64

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import svgrasterize_tpu.ops.pallas_coverage as j_pc
import svgrasterize_tpu.render_plan as jrp
from svgrasterize_tpu import render as j_render
from svgrasterize_tpu.core.layer import merge_at as j_merge_at
from svgrasterize_tpu.core.png import read_png, write_png
from svgrasterize_tpu.core.transform import Transform as JTransform
from svgrasterize_tpu.ops import coverage as j_cov
from svgrasterize_tpu.ops import fill_rule as j_fill_rule
from svgrasterize_tpu.ops import gradient as j_grad
from svgrasterize_tpu.paint import RasterImage as JRasterImage

import svgrasterize_tpu_torch.render_plan as trp
from svgrasterize_tpu_torch import render as t_render
from svgrasterize_tpu_torch.cli import main as torch_main
from svgrasterize_tpu_torch.core.layer import merge_at as t_merge_at
from svgrasterize_tpu_torch.core.transform import Transform as TTransform
from svgrasterize_tpu_torch.ops import coverage as t_cov
from svgrasterize_tpu_torch.ops import fill_rule as t_fill_rule
from svgrasterize_tpu_torch.ops import fused_exec
from svgrasterize_tpu_torch.ops import gradient as t_grad
from svgrasterize_tpu_torch.paint import RasterImage as TRasterImage
from svgrasterize_tpu_torch.scene import RENDER_FILL

from torch_support import interpret_pallas  # noqa: F401 (a fixture)
from torch_support import (assert_items_equal, assert_png_close, jax_png, jax_scene, torch_scene,
                           viewport_of)

TOL = 1e-5
SWAP = (0, 1, 0, 1, 0, 0)  # images are indexed (row, col) = (y, x)


@pytest.fixture()
def no_hybrid(monkeypatch):
    """Both interpreters render every path on its own (the per-path oracle)."""
    monkeypatch.setattr(jrp, "HYBRID_ENABLED", False)
    monkeypatch.setattr(trp, "HYBRID_ENABLED", False)


def _png_uri(image: np.ndarray) -> str:
    return "data:image/png;base64," + base64.b64encode(write_png(image).getvalue()).decode()


def _png(seed: int, h: int, w: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    image = rng.integers(0, 256, (h, w, 4)).astype(np.uint8)
    image[..., 3] = np.maximum(image[..., 3], 64)
    return image


# ----------------------------------------------------------------------------
# documents
# ----------------------------------------------------------------------------
def _checker_uri() -> str:
    tile = np.zeros((4, 4, 4), np.uint8)
    tile[:2, :2] = tile[2:, 2:] = [255, 0, 0, 255]
    tile[:2, 2:] = tile[2:, :2] = [0, 0, 255, 255]
    return _png_uri(tile)


def _random_featureful(seed: int) -> str:
    """tests/test_fused_exec.py test_random_featureful_equivalence's scene."""
    rng = np.random.default_rng(seed)
    defs = """<defs>
    <linearGradient id='lg'><stop offset='0' stop-color='#f00'/>
    <stop offset='1' stop-color='#00f'/></linearGradient>
    <radialGradient id='rg'><stop offset='0' stop-color='#fff'/>
    <stop offset='1' stop-color='#137'/></radialGradient>
    <clipPath id='c'><circle cx='48' cy='32' r='26'/></clipPath>
    <pattern id='p' width='6' height='6' patternUnits='userSpaceOnUse'>
    <rect width='3' height='3' fill='#d04020'/></pattern></defs>"""
    fills = ["url(#lg)", "url(#rg)", "url(#p)", "#20a040", "#a02060"]
    parts = []
    for _ in range(14):
        fill = fills[rng.integers(0, len(fills))]
        clip = " clip-path='url(#c)'" if rng.random() < 0.3 else ""
        op = rng.uniform(0.4, 1.0)
        if rng.random() < 0.5:
            x, y = rng.uniform(0, 70, 2)
            w, h = rng.uniform(6, 40, 2)
            parts.append(f"<rect x='{x:.1f}' y='{y:.1f}' width='{w:.1f}'"
                         f" height='{h:.1f}' fill='{fill}' opacity='{op:.2f}'{clip}/>")
        else:
            cx, cy = rng.uniform(10, 85, 2)
            r = rng.uniform(5, 22)
            parts.append(f"<circle cx='{cx:.1f}' cy='{cy:.1f}' r='{r:.1f}'"
                         f" fill='{fill}' opacity='{op:.2f}'{clip}/>")
    return ("<svg xmlns='http://www.w3.org/2000/svg' width='96' height='64'>"
            + defs + "".join(parts) + "</svg>")


def _stops(k: int, seed: int) -> str:
    rng = np.random.default_rng(seed)
    offs = np.sort(rng.uniform(0, 1, k))
    offs[0], offs[-1] = 0.0, 1.0
    return "".join(
        f"<stop offset='{o:.4f}' stop-color='#%02x%02x%02x'/>" % tuple(rng.integers(0, 256, 3))
        for o in offs
    )


# tests/test_frontend.py (documents rendered through the interpreter there)
FRONTEND = {
    "solid": """<svg xmlns="http://www.w3.org/2000/svg" width="48" height="48">
      <rect x="4" y="4" width="24" height="20" fill="#336699"/>
      <path d="M8 40 L24 10 L40 40 Z" fill="green" fill-opacity="0.7"/></svg>""",
    "symbol": """<svg xmlns="http://www.w3.org/2000/svg" width="64" height="64">
      <defs><symbol id="s" viewBox="0 0 10 10">
      <rect x="1" y="1" width="8" height="8" fill="lime"/></symbol></defs>
      <use href="#s" x="8" y="8" width="40" height="40"/></svg>""",
    "markers": """<svg xmlns="http://www.w3.org/2000/svg" width="120" height="80">
      <defs><marker id="arrow" viewBox="0 0 10 10" refX="9" refY="5"
      markerWidth="6" markerHeight="6" orient="auto">
      <path d="M0 0 L10 5 L0 10 Z" fill="crimson"/></marker>
      <marker id="dot" markerWidth="8" markerHeight="8" refX="4" refY="4"
      markerUnits="userSpaceOnUse"><circle cx="4" cy="4" r="3" fill="navy"/></marker></defs>
      <path d="M10 70 L50 20 L90 60 L110 10" fill="none" stroke="black"
      stroke-width="2" marker-start="url(#dot)" marker-mid="url(#dot)"
      marker-end="url(#arrow)"/></svg>""",
    "marker_overflow": """<svg xmlns="http://www.w3.org/2000/svg" width="120" height="60">
      <defs><marker id="m" markerWidth="6" markerHeight="6" refX="3" refY="3"
      markerUnits="userSpaceOnUse"><circle cx="3" cy="3" r="8" fill="red"/></marker></defs>
      <path d="M20 30 L100 30" stroke="black" stroke-width="1"
      marker-start="url(#m)" marker-end="url(#m)"/></svg>""",
    "css": """<svg xmlns='http://www.w3.org/2000/svg' width='64' height='32'>
      <style>/* comment */ .warm { fill: #d04020; }
      rect.cool { fill: #2060c0; }
      #special { fill: #20a040; opacity: 0.5; }</style>
      <rect class='warm' x='2' y='2' width='16' height='28'/>
      <rect class='cool' x='22' y='2' width='16' height='28' fill='black'/>
      <rect id='special' class='warm' x='42' y='2' width='16' height='28'
      style='opacity:1'/></svg>""",
    "image": ("<svg xmlns='http://www.w3.org/2000/svg' width='64' height='64'>"
              f"<image href='{_checker_uri()}' x='8' y='8' width='32' height='32'/></svg>"),
    "image_rotated": ("<svg xmlns='http://www.w3.org/2000/svg' width='64' height='64'>"
                      "<g transform='rotate(90 24 24)'>"
                      f"<image href='{_checker_uri()}' x='8' y='8' width='32' height='32'/>"
                      "</g></svg>"),
    "dasharray": """<svg xmlns="http://www.w3.org/2000/svg" width="120" height="30">
      <line x1="10" y1="15" x2="110" y2="15" stroke="black" stroke-width="4"
      stroke-dasharray="10 6"/></svg>""",
    "miterlimit": """<svg xmlns='http://www.w3.org/2000/svg' width='64' height='64'>
      <path d='M8 56 L32 12 L56 56' fill='none' stroke='black' stroke-width='6'
      stroke-miterlimit='1'/></svg>""",
}

# pattern documents of tests/test_render_plan.py and tests/test_fused_exec.py
PATTERNS = {
    "pattern_fill_batches": """<svg xmlns="http://www.w3.org/2000/svg" width="160" height="96">
      <defs><pattern id="p" width="12" height="12" patternUnits="userSpaceOnUse">
      <rect width="6" height="6" fill="red"/>
      <rect x="6" y="6" width="6" height="6" fill="blue"/></pattern>
      <pattern id="q" width="0.25" height="0.25">
      <circle cx="8" cy="8" r="6" fill="#00aa55"/></pattern></defs>
      <rect x="4" y="4" width="70" height="88" fill="url(#p)"/>
      <circle cx="120" cy="48" r="40" fill="url(#q)"/></svg>""",
    "pattern_paints": """<svg xmlns='http://www.w3.org/2000/svg' width='96' height='64'>
      <defs><pattern id='p' width='8' height='8' patternUnits='userSpaceOnUse'>
      <rect x='0' y='0' width='4' height='4' fill='#d04020'/>
      <rect x='4' y='4' width='4' height='4' fill='#2060c0'/></pattern></defs>
      <rect x='4' y='4' width='60' height='40' fill='url(#p)'/>
      <circle cx='75' cy='40' r='18' fill='url(#p)'/>
      <rect x='10' y='48' width='40' height='12' fill='#20a040'/></svg>""",
    "featureful_3": _random_featureful(3),
    "featureful_4": _random_featureful(4),
    "kvec_patterns": """<svg xmlns='http://www.w3.org/2000/svg' width='96' height='64'>
      <defs><pattern id='p' width='8' height='8' patternUnits='userSpaceOnUse'>
      <rect x='0' y='0' width='4' height='4' fill='#d04020'/></pattern></defs>
      <rect x='4' y='4' width='60' height='40' fill='url(#p)'/></svg>""",
}

# what the batched path cannot express, and feImage
INTERP_ONLY = {
    "stroke_in_clip": """<svg xmlns='http://www.w3.org/2000/svg' width='96' height='64'>
      <defs><clipPath id='c'><path d='M8 32 Q48 -8 88 32' fill='none' stroke='black'
      stroke-width='10'/><circle cx='48' cy='44' r='10'/></clipPath></defs>
      <rect x='2' y='2' width='92' height='60' fill='#2060c0' clip-path='url(#c)'/>
      <circle cx='20' cy='20' r='12' fill='#d04020'/></svg>""",
    "color_interpolation": """<svg xmlns='http://www.w3.org/2000/svg' width='96' height='64'>
      <defs><linearGradient id='g' color-interpolation='linearRGB' x1='0' x2='1'>
      <stop offset='0' stop-color='#ff0000'/><stop offset='1' stop-color='#0000ff'/>
      </linearGradient><radialGradient id='r' color-interpolation='linearRGB'>
      <stop offset='0' stop-color='#ffff00'/><stop offset='1' stop-color='#008040'/>
      </radialGradient></defs>
      <rect x='4' y='4' width='56' height='40' fill='url(#g)'/>
      <circle cx='66' cy='36' r='24' fill='url(#r)' fill-opacity='0.8'/></svg>""",
    "stops80": ("<svg xmlns='http://www.w3.org/2000/svg' width='96' height='64'><defs>"
                f"<linearGradient id='g' x2='1' y2='0.5'>{_stops(80, 0)}</linearGradient>"
                "</defs><rect x='4' y='4' width='88' height='56' fill='url(#g)'/>"
                "<circle cx='30' cy='30' r='10' fill='#20a040'/></svg>"),
    "fe_image_fragment": """<svg xmlns='http://www.w3.org/2000/svg' width='64' height='48'>
      <defs><g id='frag'><circle cx='12' cy='12' r='10' fill='lime'/>
      <rect x='14' y='6' width='12' height='8' fill='#8020c0'/></g>
      <filter id='f'><feImage href='#frag' result='im'/>
      <feComposite in='im' in2='SourceGraphic' operator='over'/></filter></defs>
      <rect x='24' y='8' width='30' height='30' fill='blue' filter='url(#f)'/></svg>""",
    "fe_image_png": ("<svg xmlns='http://www.w3.org/2000/svg' width='64' height='48'><defs>"
                     f"<filter id='f'><feImage href='{_png_uri(_png(1, 6, 9))}' x='10' y='6'"
                     " width='30' height='20' result='im'/>"
                     "<feComposite in='im' in2='SourceGraphic' operator='over'/></filter></defs>"
                     "<rect x='20' y='10' width='30' height='30' fill='#c02060'"
                     " filter='url(#f)'/></svg>"),
}

SCENE_DOCS = {**FRONTEND, **PATTERNS, **INTERP_ONLY}


def _jax_canvas(svg: str, **kw) -> np.ndarray:
    vp = viewport_of(svg)
    layer, _ = jax_scene(svg).render(JTransform().matrix(*SWAP), viewport=vp, **kw)
    layer = layer.convert(pre_alpha=True, linear_rgb=False)
    return np.asarray(j_merge_at(jnp.zeros((vp[2], vp[3], 4)), layer.image, layer.offset))


def _torch_canvas(svg: str, **kw) -> np.ndarray:
    vp = viewport_of(svg)
    layer, _ = torch_scene(svg).render(TTransform().matrix(*SWAP), viewport=vp,
                                       device="cpu", **kw)
    layer = layer.convert(pre_alpha=True, linear_rgb=False)
    return t_merge_at(torch.zeros((vp[2], vp[3], 4)), layer.image, layer.offset).numpy()


def _assert_close(got, ref, tol=TOL):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape and np.isfinite(got).all()
    assert np.abs(got - ref).max() <= tol


# ----------------------------------------------------------------------------
# winding, fill rules, gradients
# ----------------------------------------------------------------------------
def _random_lines(seed, n, lo, hi):
    rng = np.random.default_rng(seed)
    return j_cov.pad_lines(rng.uniform(lo, hi, size=(n, 4)).astype(np.float32))


SQUARE = np.array([[8, 8, 8, 24], [8, 24, 24, 24], [24, 24, 24, 8], [24, 8, 8, 8]],
                  np.float32)
WINDING_CASES = {
    "random": (_random_lines(3, 48, -10, 70), 60, 150),
    "non_block_multiple": (_random_lines(11, 32, 0, 37), 37, 41),
    "closed_square": (j_cov.pad_lines(SQUARE), 32, 32),
}


@pytest.mark.parametrize("name", sorted(WINDING_CASES))
def test_winding_matches_jax_and_pallas(name, interpret_pallas):
    lines, h, w = WINDING_CASES[name]
    got = fused_exec.winding(torch.from_numpy(lines), h, w).numpy()
    assert fused_exec.winding.launches == 0  # CPU tensors take the plain version
    _assert_close(got, j_cov.winding(jnp.asarray(lines), h, w))
    _assert_close(got, j_pc.winding_pallas(jnp.asarray(lines), h, w))
    # padding rows contribute nothing: the real edges alone give the same field
    live = lines[np.any(lines != 0, axis=1)]
    _assert_close(t_cov.winding(torch.from_numpy(live), h, w).numpy(), got)
    if name == "closed_square":
        assert abs(abs(got[16, 16]) - 1.0) < 1e-6 and abs(got[4, 4]) < 1e-6


def _batch_masks():
    """Edge lists and sizes a batch may hold: an empty list, a 1-row mask,
    widths that are not multiples of 128, a 0 x w and an h x 0 mask."""
    lines = [_random_lines(21, 48, -10, 300), np.zeros((0, 4), np.float32),
             _random_lines(22, 9, -2, 40), _random_lines(23, 30, 0, 40),
             _random_lines(24, 5, 0, 8), _random_lines(25, 17, -5, 150),
             _random_lines(26, 8, 0, 9)]
    sizes = [(60, 257), (12, 20), (1, 37), (0, 50), (40, 0), (130, 129), (7, 3)]
    return lines, sizes


def test_winding_batch_matches_per_mask_and_jax():
    lines, sizes = _batch_masks()
    fused_exec.reset_launch_counts()
    got = fused_exec.winding_batch(lines, sizes, "cpu")
    assert fused_exec.winding.launches == 0  # the CPU takes the plain version
    assert [tuple(f.shape) for f in got] == sizes
    for field, e, (h, w) in zip(got, lines, sizes):
        assert torch.equal(field, t_cov.winding(torch.from_numpy(e), h, w))
        if h and w:
            _assert_close(field.numpy(), j_cov.winding(jnp.asarray(e.reshape(-1, 4)), h, w))
    # the kernel's table: each mask's edges, field and blocks follow the last
    table, totals = fused_exec._mask_table([len(e) for e in lines], sizes)
    rows, cols = fused_exec.WINDING_BLOCK
    blocks = [-(-h // rows) * -(-w // cols) for h, w in sizes]
    assert totals == (sum(len(e) for e in lines), sum(h * w for h, w in sizes), sum(blocks))
    assert table.shape == (len(sizes), fused_exec.WINDING_TABLE_COLS)
    assert table[:, 0].tolist() == np.cumsum([0] + [len(e) for e in lines])[:-1].tolist()
    assert table[:, 1].tolist() == [len(e) for e in lines]
    assert table[:, 2:4].tolist() == [list(s) for s in sizes]
    assert table[:, 4].tolist() == np.cumsum([0] + [h * w for h, w in sizes])[:-1].tolist()
    assert table[:, 5].tolist() == np.cumsum([0] + blocks)[:-1].tolist()
    assert blocks[3] == blocks[4] == 0 and blocks[5] == 17 * 1


@pytest.mark.parametrize("rule", ["nonzero", "evenodd"])
def test_fill_rule_matches_jax(rule):
    wind = np.random.default_rng(5).uniform(-3, 3, (40, 50)).astype(np.float32)
    wind[::7] = 1e-7  # under the floor
    got = t_fill_rule.apply(torch.from_numpy(wind), rule).numpy()
    _assert_close(got, j_fill_rule.apply(jnp.asarray(wind), rule))


@pytest.mark.parametrize("helper", ["canvas_create", "pixel_grid"])
def test_device_helpers_default_to_the_card(helper):
    """Called without a device, both helpers ask for the card: on a host
    without one they raise, they never quietly return a CPU tensor."""
    from svgrasterize_tpu_torch.core.layer import canvas_create

    call = {"canvas_create": lambda **kw: canvas_create(6, 4, **kw)[0],
            "pixel_grid": lambda **kw: t_grad.pixel_grid(4, 6, 0.0, 0.0, **kw)}[helper]
    assert call(device="cpu").shape[:2] == (4, 6)
    if torch.cuda.is_available():
        assert call().device.type == "cuda"
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            call()


def _stop_arrays(k: int):
    rng = np.random.default_rng(k)
    offsets = np.sort(rng.uniform(0, 1, k)).astype(np.float32)
    offsets[1] = offsets[2]  # a duplicate stop: a hard step
    colors = rng.uniform(0, 1, (k, 4)).astype(np.float32)
    return offsets, colors


AFFINE = np.array([[0.03, 0.01, -0.2], [-0.012, 0.025, 0.1]], np.float32)


@pytest.mark.parametrize("spread", ["pad", "repeat", "reflect"])
def test_linear_fill_matches_jax(spread):
    offsets, colors = _stop_arrays(5)
    p0, p1 = np.array([0.1, 0.2], np.float32), np.array([0.7, 0.5], np.float32)
    ref = j_grad.linear_fill(30, 44, jnp.asarray([3.0, -2.0]), jnp.asarray(AFFINE),
                             jnp.asarray(p0), jnp.asarray(p1), jnp.asarray(offsets),
                             jnp.asarray(colors), spread)
    t = torch.from_numpy
    got = t_grad.linear_fill(30, 44, (3.0, -2.0), t(AFFINE), t(p0), t(p1), t(offsets),
                             t(colors), spread)
    _assert_close(got.numpy(), ref)


@pytest.mark.parametrize("focal", [False, True], ids=["centred", "focal"])
@pytest.mark.parametrize("spread", ["pad", "repeat", "reflect"])
def test_radial_fill_matches_jax(spread, focal):
    offsets, colors = _stop_arrays(4)
    center = np.array([0.5, 0.45], np.float32)
    fcenter = np.array([0.62, 0.4], np.float32) if focal else center
    radius, fradius = np.float32(0.3), np.float32(0.05 if focal else 0.0)
    args = (center, radius, fcenter, fradius, offsets, colors)
    ref = j_grad.radial_fill(30, 44, jnp.asarray([1.0, 4.0]), jnp.asarray(AFFINE),
                             *(jnp.asarray(a) for a in args), spread, focal)
    got = t_grad.radial_fill(30, 44, (1.0, 4.0), torch.from_numpy(AFFINE),
                             *(torch.as_tensor(a) for a in args), spread, focal)
    _assert_close(got.numpy(), ref)


# ----------------------------------------------------------------------------
# path_mask, path_fill, RasterImage
# ----------------------------------------------------------------------------
FILL_DOCS = {
    "solid": "<path d='M5 5 L50 12 L30 40 Z' fill='#d04020' fill-opacity='0.6'/>",
    "linear": ("<defs><linearGradient id='g' x2='1' y2='0.4' spreadMethod='reflect'>"
               "<stop offset='0' stop-color='#f00'/><stop offset='0.6' stop-color='#0f0'/>"
               "<stop offset='1' stop-color='#00f'/></linearGradient></defs>"
               "<ellipse cx='30' cy='22' rx='24' ry='16' fill='url(#g)'/>"),
    "radial": ("<defs><radialGradient id='g' r='0.4' fx='0.3' fy='0.35'>"
               "<stop offset='0' stop-color='#fff'/><stop offset='1' stop-color='#204080'/>"
               "</radialGradient></defs><rect x='4' y='6' width='50' height='34' fill='url(#g)'/>"),
    "pattern": ("<defs><pattern id='p' width='0.2' height='0.3' patternTransform='rotate(20)'>"
                "<rect width='5' height='4' fill='#d04020'/><circle cx='6' cy='6' r='3'"
                " fill='#2060c0'/></pattern></defs>"
                "<circle cx='30' cy='24' r='19' fill='url(#p)'/>"),
    "evenodd": ("<path d='M4 4 L56 4 L56 44 L4 44 Z M14 14 L46 14 L46 34 L14 34 Z'"
                " fill='#20a040' fill-rule='evenodd'/>"),
}


def _first_fill(scene):
    """(path, paint, fill_rule) of the first fill node of a scene graph."""
    kind, args = scene
    if kind == RENDER_FILL:
        return args
    for child in args:
        if isinstance(child, type(scene)):
            found = _first_fill(child)
            if found is not None:
                return found
    return None


@pytest.mark.parametrize("name", sorted(FILL_DOCS))
def test_path_mask_and_fill_match_jax(name):
    svg = ("<svg xmlns='http://www.w3.org/2000/svg' width='64' height='48'>"
           + FILL_DOCS[name] + "</svg>")
    j_path, j_paint, j_rule = _first_fill(jax_scene(svg))
    t_path, t_paint, t_rule = _first_fill(torch_scene(svg))
    jtr, ttr = JTransform().matrix(*SWAP), TTransform().matrix(*SWAP)
    vp = (2, 3, 40, 56)
    ref_mask, _ = j_render.path_mask(j_path, jtr, j_rule, vp)
    got_mask, _ = t_render.path_mask(t_path, ttr, t_rule, vp, device="cpu")
    assert got_mask.offset == ref_mask.offset
    _assert_close(got_mask.image.numpy(), ref_mask.image)
    ref, ref_hull = j_render.path_fill(j_path, jtr, j_paint, j_rule, vp, False)
    got, got_hull = t_path.fill(ttr, t_paint, t_rule, vp, False, device="cpu")
    assert got.offset == ref.offset
    assert (got.pre_alpha, got.linear_rgb) == (ref.pre_alpha, ref.linear_rgb)
    assert np.array_equal(got_hull.raw_points, ref_hull.raw_points)
    _assert_close(got.image.numpy(), ref.image)


RASTER_CASES = {
    "upscale": JTransform().matrix(*SWAP).translate(3.5, 2.0).scale(3.1, 2.4),
    "downscale": JTransform().matrix(*SWAP).translate(1.0, 4.0).scale(0.37, 0.45),
    "rotated": JTransform().matrix(*SWAP).translate(30, 20).rotate(0.6).scale(1.7, 1.2),
}


@pytest.mark.parametrize("name", sorted(RASTER_CASES))
def test_raster_image_render_matches_jax(name):
    array = _png(7, 23, 31)
    jtr = RASTER_CASES[name]
    ttr = TTransform(jtr.m.copy())
    for mask_only in (False, True):
        ref, ref_hull = JRasterImage(array).render(jtr, mask_only=mask_only)
        got, got_hull = TRasterImage(array).render(ttr, mask_only=mask_only, device="cpu")
        assert got.offset == ref.offset
        assert np.array_equal(got_hull.raw_points, ref_hull.raw_points)
        _assert_close(got.image.numpy(), ref.image)


# ----------------------------------------------------------------------------
# Scene.render
# ----------------------------------------------------------------------------
@pytest.mark.parametrize("name", sorted(SCENE_DOCS))
def test_scene_render_matches_jax(name, no_hybrid):
    svg = SCENE_DOCS[name]
    ref = _jax_canvas(svg)
    assert ref[..., 3].max() > 0
    _assert_close(_torch_canvas(svg), ref)


@pytest.mark.parametrize("name", sorted(INTERP_ONLY) + ["featureful_3", "image_rotated"])
def test_hybrid_render_matches_jax(name, monkeypatch):
    """Scene.render batches its lowerable group runs (render_group_hybrid)
    in both packages; JAX runs them through its XLA executor at the port's
    tile size."""
    monkeypatch.setenv("SVGR_FUSED", "0")
    monkeypatch.setenv("SVGR_TILE", "32")
    svg = SCENE_DOCS[name]
    _assert_close(_torch_canvas(svg), _jax_canvas(svg))


# documents whose path masks Scene.render gathers: (svg, hybrid batching on,
# winding_batch calls = renders with a gathered mask, lone winding calls,
# masks gathered over all renders)
GATHER_DOCS = {
    "group": ("""<svg xmlns='http://www.w3.org/2000/svg' width='96' height='64'>
      <g transform='translate(2 3)'><rect x='4' y='4' width='30' height='20' fill='#d04020'/>
      <circle cx='60' cy='30' r='16' fill='none' stroke='#2060c0' stroke-width='4'/>
      <path d='M10 50 L40 30 L70 58 Z' fill='#20a040' stroke='black'/></g>
      <rect x='200' y='200' width='4' height='4' fill='red'/></svg>""", False, 1, 0, 5),
    "user_clip": ("""<svg xmlns='http://www.w3.org/2000/svg' width='96' height='64'>
      <defs><clipPath id='c'><circle cx='40' cy='30' r='22'/>
      <rect x='60' y='4' width='20' height='20'/></clipPath></defs>
      <g clip-path='url(#c)' opacity='0.7'><rect x='2' y='2' width='90' height='58' fill='#2060c0'/>
      <circle cx='50' cy='30' r='12' fill='#d04020'/></g></svg>""", False, 1, 0, 4),
    "bbox_clip": ("""<svg xmlns='http://www.w3.org/2000/svg' width='96' height='64'>
      <defs><clipPath id='c' clipPathUnits='objectBoundingBox'>
      <circle cx='0.5' cy='0.5' r='0.4'/></clipPath></defs>
      <rect x='10' y='6' width='70' height='50' fill='#2060c0' clip-path='url(#c)'/>
      <circle cx='20' cy='20' r='10' fill='#d04020'/></svg>""", False, 1, 1, 2),
    "pattern": (PATTERNS["pattern_paints"], False, 3, 0, 3 + 2 + 2),
    "hybrid": (INTERP_ONLY["stroke_in_clip"], True, 1, 0, 3),
}


@pytest.mark.parametrize("name", sorted(GATHER_DOCS))
def test_render_gathers_masks(name, monkeypatch):
    """Scene.render rasterizes every mask it can foresee in one
    winding_batch call per render (a pattern tile's sub-scene render is a
    render of its own), uses each gathered mask once, and rasterizes alone
    only what depends on a rendered hull; the image matches JAX."""
    svg, hybrid, n_batch, n_lone, n_gathered = GATHER_DOCS[name]
    monkeypatch.setattr(jrp, "HYBRID_ENABLED", hybrid)
    monkeypatch.setattr(trp, "HYBRID_ENABLED", hybrid)
    monkeypatch.setenv("SVGR_FUSED", "0")
    monkeypatch.setenv("SVGR_TILE", "32")
    calls = {"winding_batch": 0, "winding": 0}
    for fn in calls:
        orig = getattr(fused_exec, fn)

        def counted(*args, _orig=orig, _fn=fn, **kw):
            calls[_fn] += 1
            return _orig(*args, **kw)

        monkeypatch.setattr(fused_exec, fn, counted)
    batches = []

    class Recorded(t_render.MaskBatch):
        def __init__(self, device):
            super().__init__(device)
            batches.append(self)

    monkeypatch.setattr(t_render, "MaskBatch", Recorded)
    got = _torch_canvas(svg)
    assert calls == {"winding_batch": n_batch, "winding": n_lone}
    assert sum(b.added for b in batches) == n_gathered
    assert all(b.taken == b.added for b in batches)
    assert sum(bool(b.added) for b in batches) == n_batch
    _assert_close(got, _jax_canvas(svg))


@pytest.mark.parametrize("name", sorted(INTERP_ONLY))
def test_interp_only_documents_do_not_lower(name):
    """lower_scene gives up on a document exactly when the JAX package's
    does (feImage documents lower in both), and can_lower agrees."""
    svg = SCENE_DOCS[name]
    vp = viewport_of(svg)
    j_none = jrp.lower_scene(jax_scene(svg), JTransform().matrix(*SWAP), vp, False, tile=32) is None
    t_none = trp.lower_scene(torch_scene(svg), TTransform().matrix(*SWAP), vp, False, 32,
                             device="cpu") is None
    assert j_none == t_none
    assert trp.can_lower(torch_scene(svg), False) == jrp.can_lower(jax_scene(svg), False)


# ----------------------------------------------------------------------------
# pattern lowering and its executor
# ----------------------------------------------------------------------------
LOWER_DOCS = {**PATTERNS, "image": FRONTEND["image"], "image_rotated": FRONTEND["image_rotated"]}


@pytest.mark.parametrize("name", sorted(LOWER_DOCS))
def test_pattern_lowering_and_executor_match_jax(name, monkeypatch):
    monkeypatch.setenv("SVGR_FUSED", "0")
    svg = LOWER_DOCS[name]
    vp = viewport_of(svg)
    ref = jrp.lower_scene(jax_scene(svg), JTransform().matrix(*SWAP), vp, False, tile=32)
    got = trp.lower_scene(torch_scene(svg), TTransform().matrix(*SWAP), vp, False, 32,
                          device="cpu")
    assert ref.patterns is not None and got.patterns is not None
    assert got.patterns.shape == ref.patterns.shape
    _assert_close(got.patterns, ref.patterns)
    # collapse fields gather from the atlas: within the atlas tolerance
    ref_items = {k: v for k, v in ref.items.items() if k != "field"}
    assert_items_equal(ref_items, {k: v for k, v in got.items.items() if k != "field"})
    if "field" in ref.items:
        _assert_close(got.items["field"], ref.items["field"])
    for a, b in zip(ref.bigs, got.bigs, strict=True):
        assert np.array_equal(a, b)
    assert np.array_equal(got.clips, ref.clips) and got.groups == ref.groups == []
    tiles = np.asarray(jrp.execute_lowered(ref, (0, 0), False))
    _assert_close(trp.execute_lowered(got, "cpu").numpy(), tiles)
    # the port's executors on the JAX package's plan
    _assert_close(trp.execute_lowered(ref, "cpu").numpy(), tiles)


# ----------------------------------------------------------------------------
# CLI
# ----------------------------------------------------------------------------
ID_DOC = """<svg xmlns='http://www.w3.org/2000/svg' width='96' height='64'>
<defs><pattern id='p' width='7' height='5' patternUnits='userSpaceOnUse'>
<rect width='4' height='3' fill='#d04020'/></pattern></defs>
<rect x='0' y='0' width='96' height='64' fill='#eeeeee'/>
<g id='target' transform='translate(10 6)'><rect x='4' y='4' width='40' height='30'
fill='url(#p)'/><circle cx='50' cy='30' r='14' fill='url(#p)' stroke='#2060c0'/></g></svg>"""


@pytest.mark.parametrize("case", ["interp_only", "id", "raw_path"])
def test_cli_matches_jax_cli(case, tmp_path, monkeypatch):
    extra = []
    if case == "interp_only":
        src = tmp_path / "doc.svg"
        src.write_text(INTERP_ONLY["stroke_in_clip"])
    elif case == "id":
        src = tmp_path / "doc.svg"
        src.write_text(ID_DOC)
        extra = ["-id", "target"]
    else:
        src = tmp_path / "doc.path"
        src.write_text("M4 4 L40 8 L30 36 Z M12 12 C 50 0, 0 50, 44 40 Z")
    ref = jax_png(str(src), str(tmp_path / "jax.png"), monkeypatch, *extra)
    out = tmp_path / "port.png"
    assert torch_main([str(src), str(out), "--device", "cpu", *extra]) == 0
    with open(out, "rb") as f:
        assert_png_close(read_png(f.read()), ref)
