"""Port lowering (svgrasterize_tpu_torch.render_plan.lower_scene) against the
JAX package's lower_scene: every array of the plan must be bit-identical at
the same explicit tile size.

Also holds the pass-free documents the other test_torch_* files share.
"""

from __future__ import annotations

import numpy as np
import pytest

import svgrasterize_tpu.render_plan as jrp
from svgrasterize_tpu import scene_from_str as j_scene_from_str
from svgrasterize_tpu.core.transform import Transform as JTransform
from svgrasterize_tpu.text.fonts import DEFAULT_FONTS as J_DEFAULT_FONTS
from svgrasterize_tpu.text.fonts import FontsDB as JFontsDB

import svgrasterize_tpu_torch.render_plan as trp
from svgrasterize_tpu_torch import scene_from_str as t_scene_from_str
from svgrasterize_tpu_torch.core.transform import Transform as TTransform
from svgrasterize_tpu_torch.text.fonts import DEFAULT_FONTS as T_DEFAULT_FONTS
from svgrasterize_tpu_torch.text.fonts import FontsDB as TFontsDB

from chip_smoke import flat_doc


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

DOCS = {
    "features": FEATURES,
    "solids": SOLIDS,
    "gradients_clips": GRADIENTS_CLIPS,
    "tile64": TILE64,
    "flat": FLAT,
}


def _fonts(db_cls, path):
    db = db_cls()
    db.register_file(path)
    return db


# both packages read the same font file (the JAX package's asset)
assert J_DEFAULT_FONTS == T_DEFAULT_FONTS
J_FONTS = _fonts(JFontsDB, J_DEFAULT_FONTS)
T_FONTS = _fonts(TFontsDB, T_DEFAULT_FONTS)


def viewport_of(svg: str):
    _scene, _ids, (w, h) = j_scene_from_str(svg, fonts=J_FONTS)
    return (0, 0, int(h), int(w))


def jax_scene(svg: str):
    return j_scene_from_str(svg, fonts=J_FONTS)[0]


def torch_scene(svg: str):
    return t_scene_from_str(svg, fonts=T_FONTS)[0]


def jax_lower(svg: str, tile: int):
    tr = JTransform().matrix(0, 1, 0, 1, 0, 0)
    return jrp.lower_scene(jax_scene(svg), tr, viewport_of(svg), False, tile=tile)


def torch_lower(svg: str, tile: int):
    tr = TTransform().matrix(0, 1, 0, 1, 0, 0)
    return trp.lower_scene(torch_scene(svg), tr, viewport_of(svg), False, tile, device="cpu")


@pytest.mark.parametrize("tile", [32, 64, 128])
@pytest.mark.parametrize("name", sorted(DOCS))
def test_lowering_bit_identical(name, tile):
    ref = jax_lower(DOCS[name], tile)
    got = torch_lower(DOCS[name], tile)
    assert ref is not None and got is not None
    assert ref.groups == [] and got.groups == []
    assert got.tile == ref.tile == tile
    assert tuple(got.grid) == tuple(ref.grid)
    ref_keys = {k for k in ref.items if not k.startswith("_")}
    assert set(got.items) == ref_keys
    for key in sorted(ref_keys):
        a, b = np.asarray(ref.items[key]), got.items[key]
        assert a.dtype == b.dtype and a.shape == b.shape, key
        assert np.array_equal(a, b), key
    assert len(got.bigs) == len(ref.bigs)
    for a, b in zip(ref.bigs, got.bigs):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert got.clips.dtype == ref.clips.dtype
    assert np.array_equal(got.clips, ref.clips)
    assert np.array_equal(got.hull.raw_points, ref.hull.raw_points)
    assert got.patterns is None and ref.patterns is None
