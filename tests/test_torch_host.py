"""Host-side twins of the port (svgrasterize_tpu_torch) against the JAX
package: geometry, parsing and PNG encoding must be exactly equal; the port
must import without jax; and pattern paints and feImage, which the port
once refused, render through every entry point as in the JAX package.
"""

from __future__ import annotations

import io
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from svgrasterize_tpu import scene_from_str as j_scene_from_str
from svgrasterize_tpu.core import png as j_png
from svgrasterize_tpu.core.transform import Transform as JTransform
from svgrasterize_tpu.frontend import parsers as j_parsers
from svgrasterize_tpu.geom.path import Path as JPath
from svgrasterize_tpu.utils.constants import FLATNESS

from svgrasterize_tpu_torch import scene_from_str as t_scene_from_str
from svgrasterize_tpu_torch.core import png as t_png
from svgrasterize_tpu_torch.core.transform import Transform as TTransform
from svgrasterize_tpu_torch.frontend import parsers as t_parsers
from svgrasterize_tpu_torch.geom.path import Path as TPath
from svgrasterize_tpu_torch.render_plan import (
    compile_scene,
    lower_scene,
    plan_from_lowered,
    render_fast,
)

from test_torch_lowering import DOCS, J_FONTS, T_FONTS, jax_lower

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PATHS = [
    "M10 10 L50 12 L30 40 Z",
    "M5 5 C 40 0, 0 40, 45 45 S 80 10, 60 60 Q 30 70 10 50 T 5 5 Z",
    "M20 20 A 15 10 30 1 0 60 40 A 5 5 0 0 1 70 30 Z M30 30 h10 v10 h-10 z",
]
TR = (1.5, 0.2, -0.3, 1.2, 3.0, 4.0)


@pytest.mark.parametrize("d", PATHS)
def test_flatten_matches(d):
    jt = JTransform().matrix(*TR)
    tt = TTransform().matrix(*TR)
    a = JPath.from_svg(d).flatten(jt, FLATNESS)
    b = TPath.from_svg(d).flatten(tt, FLATNESS)
    assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("join,cap", [("miter", "butt"), ("round", "round"), ("bevel", "square")])
def test_stroke_outlines_match(join, cap):
    d = PATHS[1]
    a = JPath.from_svg(d).stroke(3.5, cap, join).flatten(JTransform(), FLATNESS)
    b = TPath.from_svg(d).stroke(3.5, cap, join).flatten(TTransform(), FLATNESS)
    assert a.size and np.array_equal(a, b)


def test_colors_and_transforms_match():
    for text in ("#d04020", "#abc", "red", "rgb(10, 200, 30)", "rgba(10,20,30,0.5)",
                 "hsl(120, 50%, 40%)"):
        a, b = j_parsers.parse_color(text), t_parsers.parse_color(text)
        assert (a is None and b is None) or np.array_equal(a, b), text
    for text in ("translate(3 4) rotate(30 5 6) scale(2, 0.5)",
                 "matrix(1 0.2 -0.3 1.1 5 6) skewX(12) skewY(-7)"):
        assert np.array_equal(j_parsers.parse_transform(text).m,
                              t_parsers.parse_transform(text).m), text


def test_png_bytes_match():
    rng = np.random.default_rng(0)
    image = rng.uniform(0, 1, (23, 37, 4))
    a = j_png.write_png(image, io.BytesIO()).getvalue()
    b = t_png.write_png(image, io.BytesIO()).getvalue()
    assert a == b
    assert np.array_equal(t_png.read_png(b), j_png.read_png(a))


@pytest.mark.parametrize("name", ["features", "flat"])
def test_scene_repr_and_to_path_match(name):
    js, j_ids, j_size = j_scene_from_str(DOCS[name], fonts=J_FONTS)
    ts, t_ids, t_size = t_scene_from_str(DOCS[name], fonts=T_FONTS)
    assert repr(js) == repr(ts)
    assert j_size == t_size and sorted(j_ids) == sorted(t_ids)
    jp = js.to_path(JTransform().matrix(0, 1, 0, 1, 0, 0))
    tp = ts.to_path(TTransform().matrix(0, 1, 0, 1, 0, 0))
    assert jp.to_svg() == tp.to_svg()


def test_import_leaves_jax_out():
    code = (
        "import sys\n"
        "import svgrasterize_tpu_torch, svgrasterize_tpu_torch.cli\n"
        "import svgrasterize_tpu_torch.render_plan, svgrasterize_tpu_torch.ops.fused_exec\n"
        "import svgrasterize_tpu_torch.ops.cuda_lib, chip_smoke\n"
        "import svgrasterize_tpu_torch.parallel\n"
        "import svgrasterize_tpu_torch.parallel.mesh, svgrasterize_tpu_torch.parallel.scene\n"
        "import svgrasterize_tpu_torch.parallel.batch, svgrasterize_tpu_torch.parallel.atlas\n"
        "import svgrasterize_tpu_torch.parallel.distributed\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'svgrasterize_tpu' or m.startswith('svgrasterize_tpu.')]\n"
        "print(bad)\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
        check=True, timeout=120,
    )
    assert out.stdout.strip() == "[]", out.stdout + out.stderr


# pattern paints, also inside an opacity group or a mask, and feImage
GROUP_OPACITY = """<svg xmlns='http://www.w3.org/2000/svg' width='64' height='48'>
<defs><pattern id='p' width='8' height='8' patternUnits='userSpaceOnUse'>
<rect width='4' height='4' fill='#d04020'/></pattern></defs>
<g opacity='0.5'><rect x='4' y='4' width='30' height='20' fill='url(#p)'/>
<circle cx='30' cy='24' r='12' fill='blue'/></g></svg>"""
PATTERN = """<svg xmlns='http://www.w3.org/2000/svg' width='64' height='48'>
<defs><pattern id='p' width='8' height='8' patternUnits='userSpaceOnUse'>
<rect width='4' height='4' fill='#d04020'/></pattern></defs>
<rect x='4' y='4' width='50' height='30' fill='url(#p)'/></svg>"""
MASK = """<svg xmlns='http://www.w3.org/2000/svg' width='64' height='48'>
<defs><pattern id='p' width='8' height='8' patternUnits='userSpaceOnUse'>
<rect width='4' height='4' fill='white'/></pattern>
<mask id='m'><circle cx='30' cy='24' r='16' fill='url(#p)'/></mask></defs>
<rect x='4' y='4' width='50' height='30' fill='#2060c0' mask='url(#m)'/></svg>"""
FILTER = """<svg xmlns='http://www.w3.org/2000/svg' width='64' height='48'>
<defs><g id='frag'><circle cx='12' cy='12' r='10' fill='lime'/></g>
<filter id='f'><feImage href='#frag'/></filter></defs>
<circle cx='30' cy='24' r='12' fill='#a0b020' filter='url(#f)'/></svg>"""

EXEC_TOL = 1e-5  # the bound the executors hold against the JAX package


def _canvas(layer, vp, merge_at, zeros):
    layer = layer.convert(pre_alpha=True, linear_rgb=False)
    return np.asarray(merge_at(zeros((vp[2], vp[3], 4)), layer.image, layer.offset))


@pytest.mark.parametrize("svg", [GROUP_OPACITY, PATTERN, MASK, FILTER],
                         ids=["group_opacity", "pattern", "mask", "filter"])
def test_unported_features_raise(svg, monkeypatch):
    """render_fast, compile_scene, lower_scene + execute_lowered and
    Scene.render all match the JAX package's render_fast (its XLA executor
    at the same tile) on documents the port refused before its interpreter
    was ported.  (The name is the one this test had then.)"""
    import jax.numpy as jnp

    import svgrasterize_tpu.render_plan as jrp
    from svgrasterize_tpu.core.layer import merge_at as j_merge_at
    from svgrasterize_tpu_torch.core.layer import merge_at as t_merge_at
    from svgrasterize_tpu_torch.render_plan import execute_lowered, tiles_to_layer

    monkeypatch.setenv("SVGR_FUSED", "0")
    monkeypatch.setenv("SVGR_TILE", "32")
    scene, _ids, (w, h) = t_scene_from_str(svg)
    tr = TTransform().matrix(0, 1, 0, 1, 0, 0)
    vp = (0, 0, int(h), int(w))
    j_layer, _ = jrp.render_fast(j_scene_from_str(svg)[0], JTransform().matrix(0, 1, 0, 1, 0, 0),
                                 vp, False)
    ref = _canvas(j_layer, vp, j_merge_at, jnp.zeros)
    assert ref[..., 3].max() > 0

    def close(layer):
        got = _canvas(layer, vp, t_merge_at, torch.zeros)
        assert got.shape == ref.shape and np.abs(got - ref).max() <= EXEC_TOL

    close(render_fast(scene, tr, vp, device="cpu")[0])
    close(compile_scene(scene, tr, vp, device="cpu").render())
    lowered = lower_scene(scene, tr, vp, False, 32, device="cpu")
    close(tiles_to_layer(execute_lowered(lowered, "cpu"), lowered.grid, 32, vp, False))
    close(scene.render(tr, viewport=vp, device="cpu")[0])


def test_jax_plan_with_passes_is_refused(monkeypatch):
    """A JAX plan whose passes paint patterns (its lowering rendered the
    pattern tiles through its interpreter) runs on the port's executors and
    matches the JAX package's.  (The name is the one this test had while
    such plans were refused.)"""
    import svgrasterize_tpu.render_plan as jrp
    from svgrasterize_tpu_torch.render_plan import execute_lowered

    monkeypatch.setenv("SVGR_FUSED", "0")
    lowered = jax_lower(GROUP_OPACITY, 32)
    assert lowered.groups and lowered.patterns is not None
    ref = np.asarray(jrp.execute_lowered(lowered, (0, 0), False))
    plan_from_lowered(lowered, "cpu")
    got = execute_lowered(lowered, "cpu").numpy()
    assert np.abs(got - ref).max() <= EXEC_TOL
