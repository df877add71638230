"""What the port's tests share: the CPU thread budget of a test worker, the
documents the tests render, and the helpers that parse, lower, serve and
compare them on the CPU.

Every tests/test_torch_*.py imports this module, so the budget holds
whichever of them run.  It is not a test module (its name does not match
test_*.py) and needs no conftest.  Importing it needs no JAX, which the
card's machine does not have: the helpers that use the JAX package import
it in their bodies, and PASS_DOCS, which holds two documents of the JAX
package's tests, is built on first use.
"""

from __future__ import annotations

import functools
import os

import numpy as np
import pytest
import torch

import svgrasterize_tpu_torch.render_plan as trp
from svgrasterize_tpu_torch import scene_from_str as t_scene_from_str
from svgrasterize_tpu_torch.core.transform import Transform as TTransform
from svgrasterize_tpu_torch.text.fonts import DEFAULT_FONTS as T_DEFAULT_FONTS
from svgrasterize_tpu_torch.text.fonts import FontsDB as TFontsDB
from svgrasterize_tpu_torch.utils.stress import stress_doc

from chip_smoke import flat_doc, pass_doc

# xdist runs its workers side by side, and each one's PyTorch starts an
# intra-op thread per CPU: 6 workers x 8 threads on 8 CPUs wait on each
# other (one serving test: 8.9 s alone, over 100 s six at once; 13.3-16.0 s
# six at once with one thread each).  So a worker takes its share of the
# CPUs; outside xdist PyTorch keeps its default.
_WORKERS = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
if _WORKERS:
    torch.set_num_threads(max(1, len(os.sched_getaffinity(0)) // int(_WORKERS)))


# ----------------------------------------------------------------------------
# pass-free documents
# ----------------------------------------------------------------------------
def _star(cx, cy, n=200, r_out=12.0, r_in=5.0) -> str:
    ang = np.linspace(0, 2 * np.pi, n, endpoint=False)
    rad = np.where(np.arange(n) % 2 == 0, r_out, r_in)
    pts = [f"{cx + r * np.cos(a):.2f} {cy + r * np.sin(a):.2f}" for a, r in zip(ang, rad)]
    return "M" + " L".join(pts) + " Z"


# Every feature of the single-pass executor, with the right edge column
# (x >= 128) left empty so some tiles have no item at tile 32 and 64.
FEATURES = f"""<svg xmlns='http://www.w3.org/2000/svg' width='160' height='96'>
<defs>
<linearGradient id='pad' x1='0.2' y1='0' x2='0.6' y2='0.3'>
<stop offset='0' stop-color='#ff0000'/><stop offset='0.5' stop-color='#00ff00'/>
<stop offset='1' stop-color='#0000ff'/></linearGradient>
<linearGradient id='rep' x1='0.1' y1='0.1' x2='0.4' y2='0.2' spreadMethod='repeat'>
<stop offset='0' stop-color='#ffcc00'/><stop offset='1' stop-color='#0033cc'/></linearGradient>
<linearGradient id='ref' x1='0' y1='0' x2='0.3' y2='0.3' spreadMethod='reflect'>
<stop offset='0' stop-color='#10e0a0'/><stop offset='0.4' stop-color='#e01060' stop-opacity='0.6'/>
<stop offset='0.4' stop-color='#2020f0'/><stop offset='1' stop-color='#f0f020'/></linearGradient>
<radialGradient id='rad' cx='0.5' cy='0.5' r='0.4' fx='0.3' fy='0.35'>
<stop offset='0' stop-color='#ffffff'/><stop offset='1' stop-color='#204080'/></radialGradient>
<radialGradient id='radr' cx='0.5' cy='0.5' r='0.3' fx='0.6' fy='0.5' spreadMethod='reflect'>
<stop offset='0' stop-color='#a0ff40'/><stop offset='0.6' stop-color='#4010a0'/>
<stop offset='1' stop-color='#ff8000'/></radialGradient>
<clipPath id='c'><circle cx='34' cy='30' r='22'/></clipPath>
<clipPath id='c2'><rect x='70' y='34' width='50' height='26' transform='rotate(12 95 47)'/></clipPath>
</defs>
<rect x='2' y='2' width='124' height='60' fill='#c0c0c0' fill-opacity='0.5'/>
<rect x='6' y='6' width='56' height='48' fill='url(#rad)' clip-path='url(#c)'/>
<rect x='66' y='4' width='58' height='28' fill='url(#pad)'/>
<rect x='66' y='36' width='58' height='24' fill='url(#rep)' clip-path='url(#c2)'/>
<circle cx='28' cy='76' r='17' fill='url(#ref)'/>
<ellipse cx='98' cy='78' rx='26' ry='15' fill='url(#radr)' fill-opacity='0.8'/>
<path d='M8 66 L58 94 L66 58 L16 92 Z' fill='#20a040' fill-rule='evenodd'/>
<path d='{_star(80, 74)}' fill='#803080'/>
<polyline points='4,40 30,20 50,44 60,10' fill='none' stroke='#2050d0'
  stroke-width='3' stroke-linejoin='round'/>
<path d='M70 62 Q 90 95 122 62' fill='none' stroke='url(#pad)' stroke-width='4'
  stroke-linejoin='bevel' stroke-linecap='round'/>
<path d='M44 20 L54 8 L60 26 Z' fill='none' stroke='#aa2200' stroke-width='2.5'
  stroke-linejoin='miter'/>
</svg>"""

# pass-free documents of tests/test_fused_exec.py
SOLIDS = """<svg xmlns='http://www.w3.org/2000/svg' width='96' height='64'>
<rect x='4' y='4' width='50' height='40' fill='#d04020'/>
<circle cx='70' cy='32' r='20' fill='#2060c0' opacity='0.7'/>
<path d='M10 50 L90 44 L50 62 Z M20 48 L80 48 L50 60 Z'
      fill='#20a040' fill-rule='evenodd'/>
</svg>"""

GRADIENTS_CLIPS = """<svg xmlns='http://www.w3.org/2000/svg' width='96' height='64'>
<defs>
<linearGradient id='lg' x1='0' y1='0' x2='1' y2='1' spreadMethod='reflect'>
<stop offset='0' stop-color='#ff0000'/><stop offset='0.5' stop-color='#00ff00'/>
<stop offset='1' stop-color='#0000ff'/></linearGradient>
<radialGradient id='rg' cx='0.5' cy='0.5' r='0.5' fx='0.3' fy='0.3'>
<stop offset='0' stop-color='#ffffff'/><stop offset='1' stop-color='#204080'/>
</radialGradient>
<clipPath id='c'><circle cx='30' cy='30' r='22'/></clipPath></defs>
<rect x='4' y='4' width='50' height='40' fill='url(#rg)' clip-path='url(#c)'/>
<rect x='56' y='6' width='36' height='20' fill='url(#lg)'/>
<path d='M2 2 C 90 0, 4 60, 94 62 L 94 2 Z' fill='#208040' opacity='0.5'/>
</svg>"""

TILE64 = """<svg xmlns='http://www.w3.org/2000/svg' width='160' height='128'>
<defs><linearGradient id='lg' x1='0' y1='0' x2='1' y2='1'>
<stop offset='0' stop-color='#ff0000'/><stop offset='1' stop-color='#0000ff'/>
</linearGradient>
<clipPath id='c'><circle cx='60' cy='60' r='45'/></clipPath></defs>
<rect x='8' y='8' width='100' height='90' fill='url(#lg)' clip-path='url(#c)'/>
<path d='M10 100 C 150 10, 20 120, 150 120 L 10 120 Z' fill='#20a040'/>
</svg>"""

FLAT = flat_doc(60, 128, seed=3)

FLAT_DOCS = {
    "features": FEATURES,
    "solids": SOLIDS,
    "gradients_clips": GRADIENTS_CLIPS,
    "tile64": TILE64,
    "flat": FLAT,
}


# ----------------------------------------------------------------------------
# isolation-pass documents
# ----------------------------------------------------------------------------
# the mask and filter documents of tests/test_render_plan.py
MASKS = """<svg xmlns="http://www.w3.org/2000/svg" width="128" height="96">
  <defs>
    <mask id="m">
      <rect x="0" y="0" width="128" height="96" fill="white"/>
      <circle cx="64" cy="48" r="30" fill="black"/>
    </mask>
    <mask id="grad_m">
      <linearGradient id="mg"><stop offset="0" stop-color="white"/>
      <stop offset="1" stop-color="black"/></linearGradient>
      <rect x="0" y="0" width="128" height="96" fill="url(#mg)"/>
    </mask>
  </defs>
  <rect x="8" y="8" width="112" height="80" fill="tomato" mask="url(#m)"/>
  <circle cx="64" cy="48" r="20" fill="navy" mask="url(#grad_m)"/>
</svg>"""

MASK_HIDES = """<svg xmlns="http://www.w3.org/2000/svg" width="96" height="96">
  <defs><mask id="m"><rect x="0" y="0" width="48" height="96" fill="white"/></mask></defs>
  <rect x="0" y="0" width="96" height="96" fill="lime" mask="url(#m)"/>
</svg>"""

FILTER_BLUR_OFFSET = """<svg xmlns="http://www.w3.org/2000/svg" width="160" height="120">
  <defs>
    <filter id="b"><feGaussianBlur stdDeviation="3"/></filter>
    <filter id="o"><feOffset dx="6" dy="4"/></filter>
  </defs>
  <rect x="30" y="30" width="60" height="40" fill="#2266aa" filter="url(#b)"/>
  <circle cx="120" cy="60" r="22" fill="tomato" filter="url(#o)"/>
</svg>"""

DROP_SHADOW_CHAIN = """<svg xmlns="http://www.w3.org/2000/svg" width="128" height="128">
  <defs>
    <filter id="ds">
      <feGaussianBlur in="SourceAlpha" stdDeviation="2" result="blur"/>
      <feOffset in="blur" dx="4" dy="4" result="shadow"/>
      <feMerge><feMergeNode in="shadow"/><feMergeNode in="SourceGraphic"/></feMerge>
    </filter>
  </defs>
  <rect x="24" y="24" width="64" height="64" fill="gold" filter="url(#ds)"/>
</svg>"""

# every isolation construct at once: nested group opacity, an anti-aliased
# clip over a multi-draw group, a nested clip, a bbox-units clip, a
# gradient mask, a lone blur and a SourceAlpha blur, a drop shadow, a
# colour-matrix / composite chain, and a filter inside an opacity group
# (two dependency levels)
PASSES = """<svg xmlns='http://www.w3.org/2000/svg' width='160' height='128'>
<defs>
 <linearGradient id='mg' x1='0' y1='0' x2='1' y2='0.3'>
  <stop offset='0' stop-color='white'/><stop offset='1' stop-color='#202020'/></linearGradient>
 <mask id='m'><rect x='80' y='56' width='80' height='72' fill='url(#mg)'/></mask>
 <clipPath id='c'><circle cx='44' cy='40' r='30'/></clipPath>
 <clipPath id='c2'><rect x='20' y='60' width='60' height='50' transform='rotate(12 50 85)'/></clipPath>
 <clipPath id='cb' clipPathUnits='objectBoundingBox'><circle cx='0.5' cy='0.5' r='0.45'/></clipPath>
 <filter id='b'><feGaussianBlur stdDeviation='2 3'/></filter>
 <filter id='ba'><feGaussianBlur in='SourceAlpha' stdDeviation='1.5'/></filter>
 <filter id='sh'><feDropShadow dx='3' dy='2' stdDeviation='1.5' flood-color='#203040'
   flood-opacity='0.6'/></filter>
 <filter id='cm'><feColorMatrix type='saturate' values='0.3' result='s'/>
   <feComposite in='s' in2='SourceGraphic' operator='atop'/></filter>
</defs>
<rect x='0' y='0' width='160' height='128' fill='#f0f0e0'/>
<g opacity='0.6'><rect x='8' y='8' width='50' height='40' fill='#d03020'/>
 <circle cx='50' cy='40' r='18' fill='#2050d0'/>
 <g opacity='0.5'><rect x='30' y='30' width='30' height='30' fill='#20a040'/>
  <circle cx='60' cy='55' r='10' fill='#a0a020'/></g></g>
<g clip-path='url(#c)'><rect x='10' y='10' width='60' height='40' fill='#802080'/>
 <circle cx='60' cy='50' r='20' fill='#208080' fill-opacity='0.7'/></g>
<g clip-path='url(#c2)'><g clip-path='url(#c)'><rect x='20' y='20' width='60' height='90'
 fill='#c08020'/></g><circle cx='40' cy='90' r='14' fill='#4040c0'/></g>
<g clip-path='url(#cb)'><rect x='100' y='8' width='50' height='40' fill='#10a0c0'/>
 <rect x='110' y='18' width='30' height='30' fill='#c01060' fill-opacity='0.6'/></g>
<rect x='86' y='60' width='70' height='60' fill='#3070c0' mask='url(#m)'/>
<g opacity='0.8'><rect x='96' y='70' width='30' height='20' fill='#e02080' filter='url(#b)'/>
 <circle cx='130' cy='100' r='12' fill='#20e080'/></g>
<ellipse cx='30' cy='112' rx='18' ry='9' fill='#a050a0' filter='url(#ba)'/>
<rect x='64' y='96' width='24' height='20' fill='#f0a020' filter='url(#sh)'/>
<circle cx='140' cy='40' r='12' fill='#e04010' filter='url(#cm)'/>
</svg>"""


def __getattr__(name):
    # PASS_DOCS takes BLURS and MIXED from tests/test_filter_batch.py, which
    # imports JAX: built on its first import, so that this module needs none
    if name != "PASS_DOCS":
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    from test_filter_batch import BLURS, MIXED

    docs = {
        "blurs": BLURS,
        "mixed": MIXED,
        "masks": MASKS,
        "mask_hides": MASK_HIDES,
        "filter_blur_offset": FILTER_BLUR_OFFSET,
        "drop_shadow_chain": DROP_SHADOW_CHAIN,
        "passes": PASSES,
        "stress": stress_doc(200, 256),
    }
    globals()["PASS_DOCS"] = docs
    return docs


# ----------------------------------------------------------------------------
# parsing and lowering in both packages
# ----------------------------------------------------------------------------
def _fonts(db_cls, path):
    db = db_cls()
    db.register_file(path)
    return db


T_FONTS = _fonts(TFontsDB, T_DEFAULT_FONTS)


@functools.cache
def jax_fonts():
    """The JAX package's font database, built on first call."""
    from svgrasterize_tpu.text.fonts import DEFAULT_FONTS as J_DEFAULT_FONTS
    from svgrasterize_tpu.text.fonts import FontsDB as JFontsDB

    # both packages read the same font file (the JAX package's asset)
    assert J_DEFAULT_FONTS == T_DEFAULT_FONTS
    return _fonts(JFontsDB, J_DEFAULT_FONTS)


def viewport_of(svg: str):
    _scene, _ids, (w, h) = t_scene_from_str(svg, fonts=T_FONTS)
    return (0, 0, int(h), int(w))


def jax_scene(svg: str):
    from svgrasterize_tpu import scene_from_str as j_scene_from_str

    return j_scene_from_str(svg, fonts=jax_fonts())[0]


def torch_scene(svg: str):
    return t_scene_from_str(svg, fonts=T_FONTS)[0]


def jax_lower(svg: str, tile: int):
    import svgrasterize_tpu.render_plan as jrp
    from svgrasterize_tpu import scene_from_str as j_scene_from_str
    from svgrasterize_tpu.core.transform import Transform as JTransform

    # the viewport from the JAX package's own parse: torch_lower's comes
    # from the port's, so the two plans' grids also hold the sizes equal
    scene, _ids, (w, h) = j_scene_from_str(svg, fonts=jax_fonts())
    tr = JTransform().matrix(0, 1, 0, 1, 0, 0)
    return jrp.lower_scene(scene, tr, (0, 0, int(h), int(w)), False, tile=tile)


def torch_lower(svg: str, tile: int):
    tr = TTransform().matrix(0, 1, 0, 1, 0, 0)
    return trp.lower_scene(torch_scene(svg), tr, viewport_of(svg), False, tile, device="cpu")


# ----------------------------------------------------------------------------
# comparisons against the JAX package
# ----------------------------------------------------------------------------
def jax_png(svg_path, out_path, monkeypatch, *extra):
    from svgrasterize_tpu.cli import main as jax_main
    from svgrasterize_tpu.core.png import read_png

    # the JAX CLI defaults SVGR_TILE to 32 in the process environment;
    # monkeypatch sets it first and removes it afterwards
    monkeypatch.setenv("SVGR_TILE", "32")
    assert jax_main([svg_path, out_path, "--platform", "cpu", *extra]) == 0
    with open(out_path, "rb") as f:
        return read_png(f.read())


def assert_png_close(got, ref):
    assert got.shape == ref.shape
    diff = np.abs(got.astype(np.int16) - ref.astype(np.int16))
    assert int(diff.max()) <= 1
    assert float((diff == 0).mean()) >= 0.999


def assert_items_equal(ref: dict, got: dict):
    ref_keys = {k for k in ref if not k.startswith("_")}
    assert set(got) == ref_keys
    for key in sorted(ref_keys):
        a, b = np.asarray(ref[key]), got[key]
        assert a.dtype == b.dtype and a.shape == b.shape, key
        assert np.array_equal(a, b), key


@pytest.fixture()
def interpret_pallas(monkeypatch):
    import svgrasterize_tpu.ops.pallas_coverage as j_pc
    from jax.experimental import pallas as pl

    orig = pl.pallas_call

    def interp(*args, **kwargs):
        kwargs["interpret"] = True
        return orig(*args, **kwargs)

    monkeypatch.setattr(j_pc.pl, "pallas_call", interp)


# ----------------------------------------------------------------------------
# serving a pass document, on the CPU and as on the card
# ----------------------------------------------------------------------------
SIZE = 256


@pytest.fixture(scope="module")
def doc_scene():
    scene, _ids, (w, h) = t_scene_from_str(pass_doc(96, SIZE, 0), None, SIZE, None)
    return scene, (0, 0, int(h), int(w))


def serve(doc_scene, requests: int = 1):
    scene, viewport = doc_scene
    lowered = trp.lower_scene(scene, TTransform().matrix(0, 1, 0, 1, 0, 0), viewport, False,
                              32, device="cpu")
    assert lowered is not None and lowered.groups
    cs = trp.CompiledScene(lowered, viewport, False, device="cpu")
    for _ in range(requests):
        cs.render_many(1)
    return cs


class _Graph:
    """A captured frame's stand-in: replay() writes the frame's tiles into
    the captured output, as a CUDA graph's replay does."""

    def __init__(self, out, tiles):
        self.out, self.tiles, self.replays = out, tiles, 0

    def replay(self):
        self.out.copy_(self.tiles)
        self.replays += 1


def as_on_the_card(cs, monkeypatch):
    """cs's requests take the card's path (graph replays, then the frame's
    copy) with the CPU's tensors."""
    tiles = cs.render_tiles()
    monkeypatch.setattr(cs, "_program", cs._program._replace(device=torch.device("cuda")))
    cs._frame = torch.zeros_like(tiles)
    cs._graph = _Graph(cs._frame, tiles)
    return cs._graph
