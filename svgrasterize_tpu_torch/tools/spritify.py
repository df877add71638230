"""Pack a directory of SVG icons into one sprite-sheet SVG.

Equivalent of the reference's spritify.py: pure XML manipulation — each input
document becomes a nested <svg> tile with an id, laid out on a grid.  The
twin of the JAX package's tools/spritify.py; --render rasterizes the sheet
with PyTorch on --device (default cuda, raises without a card) through the
port's batched atlas renderer.
"""

from __future__ import annotations

import argparse
import math
import os
import sys
import xml.etree.ElementTree as etree

import torch

SVG_NS = "http://www.w3.org/2000/svg"

DEFAULT_SIZE = 48
DEFAULT_MARGIN = 10


def build_sprite(inputs: dict[str, etree.Element], size: int, margin: int, columns: int | None):
    """Compose named SVG roots into one sprite document root."""
    columns = columns or max(1, round(math.sqrt(len(inputs))))
    rows = -(-len(inputs) // columns) if inputs else 0

    step = size + margin
    root = etree.Element(f"{{{SVG_NS}}}svg")
    root.attrib["width"] = str(columns * step + margin)
    root.attrib["height"] = str(rows * step + margin)

    for index, (name, item) in enumerate(sorted(inputs.items())):
        row, col = divmod(index, columns)
        item.attrib.setdefault("id", name)
        item.attrib["width"] = str(size)
        item.attrib["height"] = str(size)
        item.attrib["x"] = str(col * step + margin)
        item.attrib["y"] = str(row * step + margin)
        root.append(item)
    return root


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="pack SVG icons into a sprite sheet")
    parser.add_argument("input", help="directory of source .svg files")
    parser.add_argument("output", help="output sprite .svg")
    parser.add_argument("-s", "--size", type=int, default=DEFAULT_SIZE, help="tile size")
    parser.add_argument("-m", "--margin", type=int, default=DEFAULT_MARGIN, help="tile margin")
    parser.add_argument("-c", "--columns", type=int, help="grid columns")
    parser.add_argument(
        "--render",
        metavar="PNG",
        help="also rasterize the sheet via the batched atlas renderer",
    )
    parser.add_argument(
        "--device", default="cuda", help="torch device for --render (default: cuda)"
    )
    args = parser.parse_args(argv)
    device = torch.device(args.device)
    if args.render and device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is available")

    if not os.path.isdir(args.input):
        sys.stderr.write(f"[error] not a directory: {args.input}\n")
        return 1

    etree.register_namespace("", SVG_NS)
    inputs: dict[str, etree.Element] = {}
    for entry in os.listdir(args.input):
        path = os.path.join(args.input, entry)
        if not entry.endswith(".svg") or not os.path.isfile(path):
            continue
        inputs[os.path.splitext(entry)[0]] = etree.parse(path).getroot()

    root = build_sprite(inputs, args.size, args.margin, args.columns)
    etree.ElementTree(root).write(args.output)
    sys.stderr.write(f"[info] packed {len(inputs)} icons\n")

    if args.render:
        from ..frontend.svg import scene_from_str
        from ..parallel.atlas import render_atlas

        docs = []
        for name in sorted(inputs):
            element = inputs[name]
            # the packed tile carries sheet placement; render the raw doc
            placement = {k: element.attrib.pop(k, None) for k in ("x", "y")}
            scene, _ids, size = scene_from_str(etree.tostring(element, encoding="unicode"))
            for k, v in placement.items():
                if v is not None:
                    element.attrib[k] = v
            docs.append((scene, size))
        layer = render_atlas(docs, cell=args.size, cols=args.columns, margin=args.margin,
                             device=device)
        with open(args.render, "wb") as out:
            layer.write_png(out)
        sys.stderr.write(f"[info] rendered {args.render} ({layer.width}x{layer.height})\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
