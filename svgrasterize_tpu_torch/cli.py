"""Command-line interface: SVG -> PNG with PyTorch, on a CUDA card by default.

Flag-compatible with the JAX package's CLI (positional svg/output, -bg/-fg
colors, -w width, -id element, -t extra transform, --linear-rgb, --fonts,
--as-path, --profile); its --platform becomes --device (default cuda).
Routing is the JAX CLI's: a sized document goes through the batched path
(render_plan.render_fast); when that cannot express the scene, through the
interpreter (Scene.render with the viewport, whose groups batch their
lowerable runs); a document without a size, a raw .path file and --id
render through the interpreter alone.  The result merges onto the canvas.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import torch

from .core.layer import Layer, merge_at
from .core.transform import Transform
from .frontend.parsers import parse_color, parse_transform
from .frontend.svg import scene_from_filepath
from .geom.path import Path
from .render_plan import render_fast
from .scene import Scene
from .text.fonts import DEFAULT_FONTS, FontsDB
from .utils import profiling
from .utils.constants import DEFAULT_TILE


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="svgrasterize-tpu-torch", description="SVG rasterizer (PyTorch / CUDA)"
    )
    parser.add_argument("svg", help="input SVG file (or .path raw path data)")
    parser.add_argument("output", help="output PNG file ('-' for stdout)")
    parser.add_argument("-bg", type=parse_color, help="background color")
    parser.add_argument("-fg", type=parse_color, help="default foreground color")
    parser.add_argument("-w", "--width", type=int, help="output width in pixels")
    parser.add_argument("-id", help="render only the element with this id")
    parser.add_argument(
        "-t", "--transform", type=parse_transform, help="extra transform applied to the scene"
    )
    parser.add_argument("--linear-rgb", action="store_true", help="compose in linear RGB")
    parser.add_argument("--fonts", nargs="*", help="SVG files containing font definitions")
    parser.add_argument("--as-path", action="store_true", help="dump the scene as SVG path data")
    parser.add_argument("--profile", action="store_true", help="print timing breakdown to stderr")
    parser.add_argument(
        "--verbose", action="store_true", help="print full tracebacks for input errors"
    )
    parser.add_argument(
        "--device", default="cuda", help="torch device to render on (default: cuda)"
    )
    opts = parser.parse_args(argv)

    device = torch.device(opts.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is available")

    fonts = FontsDB()
    for font_file in opts.fonts if opts.fonts is not None else [DEFAULT_FONTS]:
        fonts.register_file(font_file)

    # images are indexed (row, col) = (y, x): prepend the axis-swap transform
    transform = Transform() if opts.as_path else Transform().matrix(0, 1, 0, 1, 0, 0)
    if opts.transform is not None:
        transform = transform @ opts.transform

    if not os.path.exists(opts.svg):
        sys.stderr.write(f"[error] no such file: {opts.svg}\n")
        return 1

    try:
        if opts.svg.endswith(".path"):
            with open(opts.svg, encoding="utf-8") as file:
                path = Path.from_svg(file.read())
            opts.bg = parse_color("white") if opts.bg is None else opts.bg
            fg = parse_color("black") if opts.fg is None else opts.fg
            scene = Scene.fill(path, fg)
            ids, size = {}, None
        else:
            scene, ids, size = scene_from_filepath(
                opts.svg, opts.fg, opts.width, fonts
            )
    except (SyntaxError, ValueError, UnicodeDecodeError) as exc:
        # etree.ParseError is a SyntaxError subclass; report malformed
        # inputs cleanly instead of dumping a traceback
        sys.stderr.write(
            f"[error] cannot parse {opts.svg}: {type(exc).__name__}: {exc}\n"
        )
        if opts.verbose:
            import traceback

            traceback.print_exc()
        return 1

    if scene is None:
        sys.stderr.write("[error] nothing to render\n")
        return 0

    if opts.id is not None:
        size = None
        scene = ids.get(opts.id)
        if scene is None:
            sys.stderr.write(f"[error] no element with id: {opts.id}\n")
            return 1

    if opts.as_path:
        data = scene.to_path(transform).to_svg()
        if opts.output == "-":
            sys.stdout.write(data)
        else:
            with open(opts.output, "w", encoding="utf-8") as file:
                file.write(data)
        return 0

    if opts.profile:  # the render's spans: lowering, filter parts and primitives
        profiling.reset()
        profiling.enable(True)
    start = time.monotonic()
    sub = dict(linear_rgb=opts.linear_rgb, tile=DEFAULT_TILE, device=device)
    if size is not None:
        w, h = size
        viewport = (0, 0, int(h), int(w))
        # whole-scene batched path when the scene lowers; otherwise the
        # interpreter batches lowerable group runs internally
        result = render_fast(scene, transform, viewport, **sub)
        if result is None:
            result = scene.render(transform, viewport=viewport, **sub)
    else:
        result = scene.render(transform, **sub)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    elapsed = time.monotonic() - start
    sys.stderr.write(f"[info] rendered in {elapsed:.2f}\n")
    if opts.profile:
        profiling.enable(False)
        sys.stderr.write(profiling.report() + "\n")
    sys.stderr.flush()

    if result is None:
        sys.stderr.write("[error] nothing to render\n")
        return 1
    layer, _hull = result

    if size is not None:
        layer = layer.convert(pre_alpha=True, linear_rgb=opts.linear_rgb)
        canvas = torch.zeros((int(h), int(w), 4), dtype=torch.float32, device=device)
        canvas = merge_at(canvas, layer.image, layer.offset)
        layer = Layer(canvas, (0, 0), pre_alpha=True, linear_rgb=opts.linear_rgb)

    if opts.bg is not None:
        layer = layer.background(opts.bg)

    if opts.output == "-":
        layer.write_png(sys.stdout.buffer)
    else:
        with open(opts.output, "wb") as file:
            layer.write_png(file)
    return 0


if __name__ == "__main__":
    sys.exit(main())
