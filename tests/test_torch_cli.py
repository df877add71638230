"""End to end: the port's render_fast and CLI (--device cpu) against the
JAX package's CLI (--platform cpu) on the same small documents.

PNG channels must agree within 1/255: both render the same f32 canvas up
to ~1e-6 (sums in another order), and such a difference at a .5
quantisation boundary flips one 8-bit step.  At least 99.9 % of the bytes
must be equal.
"""

from __future__ import annotations

import io

import pytest
import torch

from svgrasterize_tpu.cli import main as jax_main
from svgrasterize_tpu.core.png import read_png

from svgrasterize_tpu_torch.cli import main as torch_main
from svgrasterize_tpu_torch.core.layer import Layer, merge_at
from svgrasterize_tpu_torch.core.transform import Transform
from svgrasterize_tpu_torch.render_plan import render_fast

from torch_support import FLAT_DOCS, assert_png_close, jax_png, torch_scene, viewport_of


@pytest.mark.parametrize("name", ["features", "flat"])
def test_cli_and_render_fast_match_jax_cli(name, tmp_path, monkeypatch):
    svg = tmp_path / "doc.svg"
    svg.write_text(FLAT_DOCS[name])
    ref = jax_png(str(svg), str(tmp_path / "jax.png"), monkeypatch)

    assert torch_main([str(svg), str(tmp_path / "port.png"), "--device", "cpu"]) == 0
    with open(tmp_path / "port.png", "rb") as f:
        assert_png_close(read_png(f.read()), ref)

    # render_fast directly, through the CLI's canvas merge and PNG encoder
    vp = viewport_of(FLAT_DOCS[name])
    layer, _hull = render_fast(torch_scene(FLAT_DOCS[name]),
                               Transform().matrix(0, 1, 0, 1, 0, 0), vp,
                               tile=32, device="cpu")
    canvas = merge_at(torch.zeros((vp[2], vp[3], 4)), layer.image, layer.offset)
    png = Layer(canvas, (0, 0), True, False).write_png(io.BytesIO()).getvalue()
    assert_png_close(read_png(png), ref)


def test_cli_background_and_width_match_jax_cli(tmp_path, monkeypatch):
    svg = tmp_path / "doc.svg"
    svg.write_text(FLAT_DOCS["solids"])
    args = ["-bg", "#fafad2", "-w", "144"]
    ref = jax_png(str(svg), str(tmp_path / "jax.png"), monkeypatch, *args)
    assert torch_main([str(svg), str(tmp_path / "port.png"), "--device", "cpu", *args]) == 0
    with open(tmp_path / "port.png", "rb") as f:
        got = read_png(f.read())
    assert got.shape == (96, 144, 4)
    assert_png_close(got, ref)


def test_cli_as_path_matches_jax_cli(tmp_path, monkeypatch, capsys):
    svg = tmp_path / "doc.svg"
    svg.write_text(FLAT_DOCS["features"])
    monkeypatch.setenv("SVGR_TILE", "32")
    assert jax_main([str(svg), "-", "--as-path", "--platform", "cpu"]) == 0
    ref = capsys.readouterr().out
    assert torch_main([str(svg), "-", "--as-path", "--device", "cpu"]) == 0
    assert capsys.readouterr().out == ref and ref


def test_cli_without_a_card_raises(tmp_path):
    svg = tmp_path / "doc.svg"
    svg.write_text(FLAT_DOCS["solids"])
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        torch_main([str(svg), str(tmp_path / "out.png")])


def test_cli_without_document_size_raises(tmp_path, monkeypatch):
    """A raw path file has no document size: the CLI renders it through the
    interpreter (Scene.render without a viewport), as the JAX CLI does.
    (The name is the one this test had while that route raised.)"""
    path = tmp_path / "shape.path"
    path.write_text("M2 2 L30 4 L16 28 Z")
    ref = jax_png(str(path), str(tmp_path / "jax.png"), monkeypatch)
    assert torch_main([str(path), str(tmp_path / "port.png"), "--device", "cpu"]) == 0
    with open(tmp_path / "port.png", "rb") as f:
        assert_png_close(read_png(f.read()), ref)
