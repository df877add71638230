"""Apply an SVG transform to every glyph outline in an SVG font file.

Equivalent of the reference's font_transform.py: parses each <glyph d="...">,
applies the transform, and serializes the path back.  The twin of the JAX
package's tools/font_transform.py, on the port's parser and Path (host
code only).
"""

from __future__ import annotations

import argparse
import sys
import xml.etree.ElementTree as etree

from ..frontend.parsers import parse_transform
from ..geom.path import Path

SVG_NS = "http://www.w3.org/2000/svg"


def transform_font_tree(tree: etree.ElementTree, transform) -> int:
    """Rewrite every glyph `d` in the tree; returns the number rewritten."""
    count = 0
    root = tree.getroot()
    for glyph in root.iter(f"{{{SVG_NS}}}glyph"):
        data = glyph.attrib.get("d")
        if not data:
            continue
        glyph.attrib["d"] = Path.from_svg(data).transform(transform).to_svg()
        count += 1
    return count


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="apply a transform to an SVG font")
    parser.add_argument("transform", help="SVG transform string (e.g. 'scale(2)')")
    parser.add_argument("font", help="input SVG font file")
    parser.add_argument("output", help="output SVG font file")
    args = parser.parse_args(argv)

    transform = parse_transform(args.transform)
    if transform is None:
        sys.stderr.write("[error] empty transform\n")
        return 1

    etree.register_namespace("", SVG_NS)
    tree = etree.parse(args.font)
    count = transform_font_tree(tree, transform)
    tree.write(args.output, xml_declaration=True)
    sys.stderr.write(f"[info] transformed {count} glyphs\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
