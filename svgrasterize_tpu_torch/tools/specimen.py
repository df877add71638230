"""Font specimen sheets: every glyph of a font on a labeled grid.

Counterpart of the reference's font_speciment tool (reference repo,
font_speciment.py) rebuilt on this framework's primitives:

  * layout is a PURE planning step (`plan_sheet`): glyphs are bucketed by
    unicode category into sections and flowed onto a fixed-width grid,
    yielding immutable cell records — no mutating row bookkeeping;
  * the sheet is a `Scene` (`specimen_scene`): glyph fills placed by
    per-cell transforms, labels and rules as ordinary fill/stroke nodes —
    so PNG output rides the same batched lowered/tiled device pipeline as
    every other render (render_plan.render_fast), not a host mask;
  * svg/path/json outputs derive from the scene (`Scene.to_path`).

The twin of the JAX package's tools/specimen.py: PNG output renders with
PyTorch on `--device` (default cuda, through the port's kernels; raises
without a card), and `--device cpu` renders through the plain versions.

Output formats: svg, path (raw path data), json (glyph name -> unicode
map), png.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import unicodedata
from dataclasses import dataclass

import numpy as np
import torch

from ..core.transform import Transform
from ..geom.path import PATH_LINE, Path
from ..scene import Scene
from ..text.fonts import DEFAULT_FONTS, Font, FontsDB

DEFAULT_COLS = 42
DEFAULT_SIZE = 32.0

# glyph categories with no ink: controls, separators, format chars
_SKIP_CATEGORIES = {"Cc", "Cf", "Zs", "Zl", "Zp"}

PAD = 0.08    # cell padding, as a fraction of the cell size
LABEL = 0.62  # label text height, as a fraction of the cell size
RULE = 1.6    # section rule thickness (px)
INK = np.array([0.0, 0.0, 0.0, 1.0])


@dataclass(frozen=True)
class GlyphCell:
    """One glyph placed at (row, col) of the sheet grid."""

    glyph: object
    row: int
    col: int


@dataclass(frozen=True)
class Section:
    """A unicode-category band: header row plus its glyph cells."""

    name: str
    header_row: int
    cells: tuple


def plan_sheet(font: Font, cols: int = DEFAULT_COLS):
    """Pure layout pass: sections flowed onto a cols-wide grid.

    Returns (sections, total_rows); row 0 is the sheet title band, each
    section occupies one header row followed by ceil(n/cols) glyph rows.
    """
    by_cat: dict[str, list] = {}
    for key, glyph in font.glyphs.items():
        try:
            cat = unicodedata.category(key)
        except TypeError:
            cat = "Other"
        if cat in _SKIP_CATEGORIES or glyph.path.is_empty():
            continue
        by_cat.setdefault(cat, []).append((key, glyph))

    sections: list[Section] = []
    row = 1
    for name in sorted(by_cat):
        glyphs = [g for _k, g in sorted(by_cat[name], key=lambda kg: kg[0])]
        cells = tuple(
            GlyphCell(g, row + 1 + i // cols, i % cols)
            for i, g in enumerate(glyphs)
        )
        sections.append(Section(name, row, cells))
        row = cells[-1].row + 1
    return sections, row


def _label_font(font: Font) -> Font:
    """The face used for titles/section labels (bundled sans, else self)."""
    if os.path.isfile(DEFAULT_FONTS):
        db = FontsDB()
        db.register_file(DEFAULT_FONTS)
        resolved = db.resolve("sans")
        if resolved is not None:
            return resolved
    return font


def _hline(x: float, y: float, length: float) -> Path:
    return Path([[(PATH_LINE, [[x, y], [x + length, y]])]])


def specimen_scene(
    font: Font,
    size: float = DEFAULT_SIZE,
    cols: int = DEFAULT_COLS,
    show_baseline: bool = False,
):
    """Build the sheet as a Scene; returns (scene, (width, height))."""
    labels = _label_font(font)
    sections, rows = plan_sheet(font, cols)
    width, height = cols * size, rows * size
    em = float(font.units_per_em)

    # em square -> padded cell: y-flip (glyph space is y-up) then fit
    cell_fit = (
        Transform()
        .translate(PAD * size, PAD * size)
        .scale((1.0 - 2.0 * PAD) * size / em)
        .scale(1.0, -1.0)
        .translate(0.0, -em)
    )

    def text_at(string: str, x: float, y: float, centered: bool = False):
        path, advance = labels.str_to_path(LABEL * size, string)
        if centered:
            x = x + (width - advance) / 2.0
        return Scene.fill(path, INK).transform(Transform().translate(x, y)), advance

    parts: list[Scene] = []
    title, _ = text_at(
        f"{font.family} {size:g}px", 0.0, (1.0 - PAD) * size, centered=True
    )
    parts.append(title)

    for sec in sections:
        y = (sec.header_row + 1.0 - PAD) * size
        head, advance = text_at(sec.name, PAD * size, y)
        parts.append(head)
        rule_x = 2.0 * PAD * size + advance
        parts.append(
            Scene.stroke(
                _hline(rule_x, y - 0.5 * LABEL * size, width - rule_x - PAD * size),
                INK, RULE,
            )
        )
        if show_baseline:
            for r in sorted({c.row for c in sec.cells}):
                parts.append(
                    Scene.stroke(
                        _hline(0.0, (r + 1.0 - PAD) * size, width), INK, 0.25
                    )
                )
        for cell in sec.cells:
            place = Transform().translate(cell.col * size, cell.row * size)
            if cell.glyph.advance > em:
                # wide glyphs shrink uniformly to keep their advance inside
                place = place.scale(em / cell.glyph.advance)
            parts.append(Scene.fill(cell.glyph.path, INK).transform(place @ cell_fit))

    return Scene.group(parts), (width, height)


def specimen(
    font: Font,
    size: float = DEFAULT_SIZE,
    cols: int = DEFAULT_COLS,
    show_baseline: bool = False,
) -> tuple[Path, tuple[float, float]]:
    """Flattened-path view of the sheet; returns (path, (width, height))."""
    scene, wh = specimen_scene(font, size, cols, show_baseline)
    return scene.to_path(Transform()), wh


def rasterize_sheet(scene, size_wh, device="cuda"):
    """Rasterize the sheet scene on `device` (black ink on white) -> Layer."""
    from ..core.layer import Layer, merge_at
    from ..render_plan import render_fast

    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device cuda: no CUDA device is available")
    w, h = int(np.ceil(size_wh[0])), int(np.ceil(size_wh[1]))
    tr = Transform().matrix(0, 1, 0, 1, 0, 0)  # canvas is (row, col) indexed
    result = render_fast(scene, tr, (0, 0, h, w), False, device=device)
    if result is None:
        layer, _hull = scene.render(tr, viewport=(0, 0, h, w), linear_rgb=False,
                                    device=device)
        canvas = torch.zeros((h, w, 4), dtype=torch.float32, device=device)
        layer = layer.convert(pre_alpha=True, linear_rgb=False)
        canvas = merge_at(canvas, layer.image, layer.offset)
        layer = Layer(canvas, (0, 0), pre_alpha=True, linear_rgb=False)
    else:
        layer, _hull = result
    return layer.background([1.0, 1.0, 1.0, 1.0])


def render_sheet(scene, size_wh, output, device="cuda") -> bool:
    """Rasterize and write PNG to `output` (a path or '-' for stdout)."""
    layer = rasterize_sheet(scene, size_wh, device)
    if output == "-":
        layer.write_png(sys.stdout.buffer)
    else:
        with open(output, "wb") as file:
            layer.write_png(file)
    return True


def _load_font(spec: str) -> Font | None:
    """Load a font from an SVG file, a TTF (via ttf2svg), or by family name."""
    _, ext = os.path.splitext(spec)
    if ext.lower() in (".ttf", ".otf"):
        from .ttf2svg import convert

        # the SVG font is read once, while loading, in a directory of its own
        with tempfile.TemporaryDirectory() as tmp:
            converted = os.path.join(
                tmp, f"{os.path.splitext(os.path.basename(spec))[0]}.svg")
            convert(spec, converted)
            return _load_font(converted)

    db = FontsDB()
    if os.path.isfile(spec):
        db.register_file(spec)
        db.resolve("")  # force the lazy load
        fonts = db.all_fonts()
        return fonts[0] if fonts else None
    sys.stderr.write("[info] not a file; resolving as a font family name\n")
    db.register_file(DEFAULT_FONTS)
    return db.resolve(spec)


_SHEET_SVG = (
    '<svg xmlns="http://www.w3.org/2000/svg" width="{w}" height="{h}" '
    'viewBox="0 0 {w} {h}">\n'
    '  <rect width="{w}" height="{h}" fill="white"/>\n'
    '  <path fill="black" d="{d}"/>\n'
    "</svg>\n"
)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="render a font specimen sheet")
    parser.add_argument("font", help="SVG/TTF font file, or a font family name")
    parser.add_argument("output", nargs="?", help="output file (format from extension)")
    parser.add_argument("-f", "--format", choices=["svg", "path", "json", "png"])
    parser.add_argument("-s", "--size", type=float, default=DEFAULT_SIZE)
    parser.add_argument("--cols", type=int, default=DEFAULT_COLS)
    parser.add_argument("-b", "--baseline", action="store_true", help="show baselines")
    parser.add_argument(
        "--device", default="cuda", help="torch device to render on (default: cuda)"
    )
    args = parser.parse_args(argv)

    font = _load_font(args.font)
    if font is None:
        sys.stderr.write(f"[error] cannot load font: {args.font}\n")
        return 1

    out_format = args.format or (
        os.path.splitext(args.output)[1][1:].lower() if args.output else "png"
    )
    output = args.output  # None: terminal preview (png) / stdout (text)

    def write_text(data: str) -> None:
        if output is None or output == "-":
            sys.stdout.write(data)
        else:
            with open(output, "w", encoding="utf-8") as file:
                file.write(data)

    if out_format == "json":
        write_text(json.dumps(font.glyph_names()))
        return 0

    scene, size_wh = specimen_scene(font, args.size, args.cols, args.baseline)
    if out_format == "path":
        write_text(scene.to_path(Transform()).to_svg())
    elif out_format == "svg":
        write_text(
            _SHEET_SVG.format(
                w=int(size_wh[0]), h=int(size_wh[1]),
                d=scene.to_path(Transform()).to_svg(),
            )
        )
    elif out_format == "png":
        if output is None:
            # no output file: show the sheet in the terminal, matching the
            # reference tool (font_speciment.py:126,152-155)
            from ..utils.debug import show_layer

            show_layer(rasterize_sheet(scene, size_wh, args.device))
        elif not render_sheet(scene, size_wh, output, args.device):
            sys.stderr.write("[error] nothing to render\n")
            return 1
    else:
        sys.stderr.write(f"[error] unsupported format: {out_format}\n")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
