"""The port's tools (svgrasterize_tpu_torch/tools) against the JAX
package's, case for case with tests/test_tools.py: font_transform, ttf2svg
and spritify's sheet byte-equal, specimen's layout and path equal, and the
PNGs of specimen and `spritify --render` (the port on `--device cpu`)
within 1/255 of the JAX tools'."""

from __future__ import annotations

import json
import os
import subprocess

import numpy as np
import pytest
import torch

from svgrasterize_tpu.core.png import read_png
from svgrasterize_tpu.text.fonts import FontsDB as JFontsDB
from svgrasterize_tpu.tools import font_transform as j_font_transform
from svgrasterize_tpu.tools import specimen as j_specimen
from svgrasterize_tpu.tools import spritify as j_spritify
from svgrasterize_tpu.tools import ttf2svg as j_ttf2svg

from svgrasterize_tpu_torch.text.fonts import FontsDB as TFontsDB
from svgrasterize_tpu_torch.tools import font_transform as t_font_transform
from svgrasterize_tpu_torch.tools import specimen as t_specimen
from svgrasterize_tpu_torch.tools import spritify as t_spritify
from svgrasterize_tpu_torch.tools import ttf2svg as t_ttf2svg

from chip_smoke import tiny_ttf
import torch_support  # noqa: F401 (the CPU thread budget)

PNG_TOL = 1  # 8-bit steps

TINY_FONT = (
    '<svg xmlns="http://www.w3.org/2000/svg"><defs>'
    '<font id="f"><font-face font-family="Tiny" units-per-em="1000"/>'
    '<glyph unicode="a" horiz-adv-x="500" d="M100 0 L400 0 L400 600 L100 600 Z"/>'
    '<glyph unicode="b" horiz-adv-x="500" d="M100 0 L400 0 L250 700 Z"/>'
    '<glyph unicode="!" horiz-adv-x="300" d="M100 0 L200 0 L150 500 Z"/>'
    "</font></defs></svg>"
)


def _png(path) -> np.ndarray:
    with open(path, "rb") as f:
        return np.asarray(read_png(f.read()), dtype=np.int16)


def _within(a, b) -> None:
    assert a.shape == b.shape and int(np.abs(a - b).max()) <= PNG_TOL


@pytest.fixture()
def icon_dir(tmp_path):
    icons = tmp_path / "icons"
    icons.mkdir()
    for name, color in (("a", "red"), ("b", "blue"), ("c", "green")):
        (icons / f"{name}.svg").write_text(
            f'<svg xmlns="http://www.w3.org/2000/svg" width="20" height="20">'
            f'<circle cx="10" cy="10" r="8" fill="{color}"/></svg>'
        )
    return str(icons)


def test_spritify_pack_and_render(icon_dir, tmp_path):
    paths = {k: str(tmp_path / k) for k in ("j.svg", "j.png", "t.svg", "t.png")}
    assert j_spritify.main([icon_dir, paths["j.svg"], "-s", "32",
                            "--render", paths["j.png"]]) == 0
    assert t_spritify.main([icon_dir, paths["t.svg"], "-s", "32",
                            "--render", paths["t.png"], "--device", "cpu"]) == 0
    with open(paths["j.svg"], "rb") as a, open(paths["t.svg"], "rb") as b:
        assert a.read() == b.read()
    ref, got = _png(paths["j.png"]), _png(paths["t.png"])
    assert got.shape[-1] == 4 and (got[..., 3] > 0).sum() > 100
    _within(got, ref)


def test_font_transform_roundtrip(tmp_path):
    src = tmp_path / "font.svg"
    src.write_text(
        '<svg xmlns="http://www.w3.org/2000/svg"><defs>'
        '<font id="f"><font-face font-family="T" units-per-em="1000"/>'
        '<glyph unicode="a" horiz-adv-x="500" d="M0 0 L100 0 L100 100 Z"/>'
        '<glyph unicode="b" horiz-adv-x="500" d="M10 0 C 40 80, 60 80, 90 0 Q 50 -20 10 0 Z"/>'
        "</font></defs></svg>"
    )
    j_out, t_out = tmp_path / "j.svg", tmp_path / "t.svg"
    transform = "translate(5 -3) rotate(15) scale(2, 0.5)"
    assert j_font_transform.main([transform, str(src), str(j_out)]) == 0
    assert t_font_transform.main([transform, str(src), str(t_out)]) == 0
    assert j_out.read_bytes() == t_out.read_bytes()
    assert b"glyph" in t_out.read_bytes()


def _no_fontforge(*_args, **_kwargs):
    raise FileNotFoundError("fontforge")


def test_ttf2svg_matches(tmp_path, monkeypatch):
    pytest.importorskip("fontTools")
    ttf = tmp_path / "tiny.ttf"
    tiny_ttf(ttf)
    monkeypatch.setattr(subprocess, "run", _no_fontforge)  # the fontTools branch in both
    j_out, t_out = tmp_path / "j.svg", tmp_path / "t.svg"
    assert j_ttf2svg.main([str(ttf), str(j_out)]) == 0
    assert t_ttf2svg.main([str(ttf), str(t_out)]) == 0
    assert j_out.read_text() == t_out.read_text()
    assert 'unicode="&amp;"' in t_out.read_text()

    # specimen loads a .ttf through ttf2svg: the glyphs of the JAX tool's
    # SVG font
    font = t_specimen._load_font(str(ttf))
    db = JFontsDB()
    db.register_file(str(j_out))
    ref = db.all_fonts()[0]
    assert font.family == ref.family == "TinyTT"
    assert {k: (g.advance, g.source) for k, g in font.glyphs.items()} == {
        k: (g.advance, g.source) for k, g in ref.glyphs.items()}


def _fonts(src):
    fonts = []
    for db in (JFontsDB(), TFontsDB()):
        db.register_file(str(src))
        db.resolve("")
        fonts.append(db.all_fonts()[0])
    return fonts


def _layout(sections):
    return [(s.name, s.header_row, [(c.glyph.unicode, c.row, c.col) for c in s.cells])
            for s in sections]


def test_specimen_sheet(tmp_path):
    src = tmp_path / "font.svg"
    src.write_text(TINY_FONT)
    j_font, t_font = _fonts(src)

    # pure layout: 'a'/'b' (Ll) and '!' (Po) form two sections
    for cols in (1, 2, 3):
        (j_sections, j_rows), (t_sections, t_rows) = (
            j_specimen.plan_sheet(j_font, cols), t_specimen.plan_sheet(t_font, cols))
        assert _layout(t_sections) == _layout(j_sections) and t_rows == j_rows
    t_sections, rows = t_specimen.plan_sheet(t_font, cols=2)
    assert [s.name for s in t_sections] == ["Ll", "Po"] and rows == 5

    for baseline in (False, True):
        j_path, j_wh = j_specimen.specimen(j_font, size=16.0, cols=2, show_baseline=baseline)
        t_path, t_wh = t_specimen.specimen(t_font, size=16.0, cols=2, show_baseline=baseline)
        assert t_path.subpaths and t_wh == j_wh == (32.0, 80.0)
        assert t_path.to_svg() == j_path.to_svg()

    j_png, t_png = str(tmp_path / "j.png"), str(tmp_path / "t.png")
    assert j_specimen.main([str(src), j_png, "-s", "16", "--cols", "2"]) == 0
    assert t_specimen.main([str(src), t_png, "-s", "16", "--cols", "2",
                            "--device", "cpu"]) == 0
    got = _png(t_png)
    assert got.shape[:2] == (80, 32)
    # black ink present on the white background
    assert (got[..., :3].min(-1) < 128).sum() > 20
    _within(got, _png(j_png))


def test_specimen_output_dispatch(tmp_path, capsys, monkeypatch):
    """No output -> terminal preview; '-' -> stdout; text formats too, and
    each text output equal to the JAX tool's."""
    src = tmp_path / "font.svg"
    src.write_text(
        '<svg xmlns="http://www.w3.org/2000/svg"><defs>'
        '<font id="f"><font-face font-family="Tiny" units-per-em="1000"/>'
        '<glyph unicode="a" horiz-adv-x="500" d="M100 0 L400 0 L400 600 L100 600 Z"/>'
        "</font></defs></svg>"
    )
    monkeypatch.chdir(tmp_path)

    # no output + png: renders to the terminal (truecolor half-blocks)
    shown = []
    monkeypatch.setattr(
        "svgrasterize_tpu_torch.utils.debug.show_layer",
        lambda layer, out=None: shown.append(tuple(layer.image.shape)),
    )
    assert t_specimen.main([str(src), "-s", "16", "--cols", "2", "--device", "cpu"]) == 0
    assert shown and shown[0][-1] == 4
    assert not os.path.exists(str(tmp_path / "-"))

    # text formats with no output go to stdout, and '-' means stdout too
    for args in (["-f", "path", "-s", "16"], ["-", "-f", "svg", "-s", "16"],
                 ["-", "-f", "json"]):
        assert j_specimen.main([str(src)] + args) == 0
        ref = capsys.readouterr().out
        assert t_specimen.main([str(src)] + args) == 0
        assert capsys.readouterr().out == ref and ref
    assert isinstance(json.loads(ref), dict)
    assert not os.path.exists(str(tmp_path / "-"))


def test_renders_raise_without_a_card(icon_dir, tmp_path, monkeypatch):
    """Asked for cuda (the default) without a card, the tools raise."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    src = tmp_path / "font.svg"
    src.write_text(TINY_FONT)
    scene, wh = t_specimen.specimen_scene(_fonts(src)[1], 16.0, 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_specimen.rasterize_sheet(scene, wh)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_specimen.main([str(src), str(tmp_path / "s.png"), "-s", "16"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_spritify.main([icon_dir, str(tmp_path / "s.svg"), "--render",
                         str(tmp_path / "s.png")])
