"""TTF/OTF -> SVG font conversion.

The reference delegates to fontforge (ttf2svg script).  This version tries
fontforge first and falls back to fontTools when available; both are gated
(neither ships in the base environment) with a clear error otherwise.
The twin of the JAX package's tools/ttf2svg.py (host code only).
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys


def convert(input_path: str, output_path: str) -> None:
    """Convert a binary font to an SVG font file."""
    # 1. fontforge (what the reference uses)
    try:
        subprocess.run(
            ["fontforge", "-lang=py", "-c", f"import fontforge; fontforge.open({input_path!r}).generate({output_path!r})"],
            check=True,
            capture_output=True,
        )
        return
    except (FileNotFoundError, subprocess.CalledProcessError):
        pass
    # 2. fontTools, if installed
    try:
        from fontTools.ttLib import TTFont  # type: ignore
    except ImportError:
        raise RuntimeError(
            "TTF conversion needs fontforge or fontTools; neither is available"
        ) from None
    _fonttools_to_svg(TTFont(input_path), output_path)


def _fonttools_to_svg(font, output_path: str) -> None:
    """Minimal SVG-font writer from a fontTools TTFont (glyphs as paths)."""
    from fontTools.pens.svgPathPen import SVGPathPen  # type: ignore

    units_per_em = font["head"].unitsPerEm
    name = font["name"].getDebugName(1) or "Unknown"
    cmap = font.getBestCmap()
    glyph_set = font.getGlyphSet()
    hmtx = font["hmtx"]

    lines = [
        '<?xml version="1.0"?>',
        '<svg xmlns="http://www.w3.org/2000/svg">',
        "<defs><font>",
        f'<font-face font-family="{name}" units-per-em="{units_per_em}" '
        f'ascent="{font["hhea"].ascent}" descent="{font["hhea"].descent}"/>',
        f'<missing-glyph horiz-adv-x="{units_per_em // 2}"/>',
    ]
    for code, glyph_name in sorted(cmap.items()):
        pen = SVGPathPen(glyph_set)
        glyph_set[glyph_name].draw(pen)
        advance = hmtx[glyph_name][0]
        char = chr(code).replace("&", "&amp;").replace("<", "&lt;").replace('"', "&quot;")
        lines.append(
            f'<glyph unicode="{char}" glyph-name="{glyph_name}" '
            f'horiz-adv-x="{advance}" d="{pen.getCommands()}"/>'
        )
    lines += ["</font></defs>", "</svg>"]
    with open(output_path, "w", encoding="utf-8") as file:
        file.write("\n".join(lines))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="convert TTF/OTF to an SVG font")
    parser.add_argument("input", help="input .ttf/.otf")
    parser.add_argument("output", nargs="?", help="output .svg (default: input basename)")
    args = parser.parse_args(argv)
    output = args.output or os.path.splitext(args.input)[0] + ".svg"
    try:
        convert(args.input, output)
    except RuntimeError as err:
        sys.stderr.write(f"[error] {err}\n")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
