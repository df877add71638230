#!/usr/bin/env python3
"""On-card smoke run of the PyTorch / CUDA port (svgrasterize_tpu_torch).

Run from the repository root on a machine with one CUDA card (Hopper,
sm_90a):

    python3 chip_smoke.py

It builds the hand-written CUDA kernels from svgrasterize_tpu_torch/csrc
with nvcc (one process per source, in parallel) and prints each compiled
kernel's registers and spills, holds each against its plain PyTorch version
on the card (the prepass on random multi-class calls, one launch each; the
scene kernel on random plans reaching every item kind at T = 16, 32, 64 and
128; the blur-chunk kernel on a document level's chunks and on random
chunks at every tile, each alone and packed into one level, one launch
each; the filter parts' entry and exit kernels on every part of the
icons_3840 benchmark frame and on random parts at every tile; the chain blur
kernel on that frame's 8 drop-shadow blurs and on random layers and taps,
both of its routes; the winding kernel
on one interpreter render's masks, one launch per mask and all of them in
one batched launch, which must agree bit for bit, on random lists up to
2,048 edges at 1024 x 1024 and on the adversarial lists of
tests/test_torch_winding.py at 1024 x 1024 and 4096 wide, repeated calls
bit-equal and back-to-back batches through the pinned staging buffers;
the untile kernel on random bit patterns at every tile, its viewport
cropped, one pixel, one tile wide and one high, bit for bit, and timed at
the benchmark cells' frames beside the clone and the permuting copy it
replaces), then drives the port's main paths: the
CLI renders a generated pass-free 1,536-draw document at 1488 x 1488 and a
compiled scene of it serves 5 frames at 3840 x 3840; the CLI renders a
generated document full of isolation passes (group opacity, masks, clips,
filters) at 1488 x 1488, and a compiled stress document of 2,000 draws and
opacity groups serves at 1024 x 1024; the CLI renders, and a compiled scene
serves, a 1488 x 1488 document of pattern fills and raster images; the CLI
renders a 1488 x 1488 document the batched path cannot express through the
interpreter (Scene.render, whose groups batch their lowerable runs), and
one group of it alone with -id.  Then the serving and scale-out slice:
the four serving documents by CUDA-graph replay
(CompiledScene.render_tiles_many: the captured frame launches what an
eager frame launches and the replayed frame equals it bit for bit), replay
ms/frame of the flat and pass documents at T = 16, 32, 64 and 128, the
pass document at T = 128 against its CPU render (its blur level and pool
rows at 128 against plain), the JAX package's 8K serving configuration
(the flat document at 7680 x 7680, T = 128) by graph replay against eager
and the plain executor, both documents over a mesh of four shards on the card (within 1e-5 of one
device), a fill batch through the winding kernel, sprite atlases of 13
documents x 4 (rendered once each) and of 52 distinct ones (within 1e-5 of
the combined plan) and a sharded one.  Then the tools: a specimen sheet of
the bundled Source Sans Pro (1,300 glyphs, 32 px cells, 42 a row) and a
sprite sheet of 52 icon documents rendered through the atlas, each on the
card and on the CPU (PNGs within 1/255, sprite SVGs byte-equal), with one
specimen render split by profiling stages, and font_transform and ttf2svg
once each; torch.profiler traces (utils.profiling.trace_to, under
build/profile) of one eager frame of the pass document split by kernel and
of one fill batch, its winding kernel apart from the rest of the call; and
the multi-process dry run as one NCCL rank in a process of its own.
Launch counts are set to 0 just before
each path and read just after it.  Each phase prints one line; any failure
exits non-zero.  The line before the last is a JSON object with per-kernel
launches (summed over the paths), errors, times and least-time bounds; the
last line is {"ok": true, "device": {"platform": "gpu", "kind": ...,
"count": ...}}.

Without a CUDA device it exits non-zero and prints no result.  It imports
nothing of JAX.
"""

from __future__ import annotations

import io
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

PREPASS_TOL = 1e-4  # same f32 closed form; only the summation order differs
SCENE_TOL = 1e-4  # per-pixel sums of the same terms in another order
BLUR_TOL = 1e-5  # the same band products, summed in another order
WINDING_TOL = 1e-4  # the prepass's closed form over a whole image, other order
PNG_TOL = 1  # 8-bit steps: ~1e-6 differences at a .5 boundary flip one step
CPU_TOL = 1e-5  # a card frame against the same program rendered on the CPU
PART_TOL = 1e-5  # the part kernels: the same f32 steps; powf within an ulp or two
TURBULENCE_TOL = 2e-6  # the same f32 steps in the same order, values in [0, 1]

CLI_SIZE = 1488
CLI_DRAWS = 1536
SERVE_WIDTH = 3840
SERVE_FRAMES = 5
PASS_DRAWS = 768
STRESS_DRAWS = 2000
STRESS_SIZE = 1024
INTERP_DRAWS = 600
PATTERN_GROUP = "pattern_group"  # the id the [interp_id] render draws
SERVE_MANY = 50  # frames per timed render_tiles_many call
# the JAX package's 8K serving configuration (bench.py build_8k): the
# material-design-sized flat document parsed at 7680 wide, at the tile its
# _pick_tile takes there (the smallest whose grid has at most 4,096 tiles)
EIGHT_K_WIDTH, EIGHT_K_TILE = 7680, 128
# (h, w, T) of the benchmark cells' frames: material_3840, material_7680,
# icons_3840 (whose grid of 31 tile rows is cropped to 985)
UNTILE_FRAMES = ((3840, 3840, 64), (7680, 7680, 128), (985, 3840, 32))
SHARDS = 4  # shards of the single-process mesh, all on the one card
FILL_PATHS, FILL_SEGS, FILL_SIZE = 64, 64, 256  # the fill batch: paths x edges at size^2
WINDING_CASES, WINDING_WIDE = 1024, 4096  # the winding kernel's adversarial lists
ATLAS_DOCS, ATLAS_COPIES, ATLAS_CELL = 13, 4, 192  # 52 cells of 192, 7 x 8
ATLAS_TOL = 1e-5  # the same items at other placements: gradients' float rounding
# the tools: a specimen sheet of the bundled font's 1,300 glyphs, 42 cells of
# 32 px a row (1344 px wide), and a sprite sheet of 52 icons in cells of 192
# (7 columns: the [atlas] phase's 1344 x 1536)
SPECIMEN_FONT, SPECIMEN_SIZE, SPECIMEN_COLS = "Source Sans Pro", 32, 42
SPRITE_ICONS, SPRITE_COLS = ATLAS_DOCS * ATLAS_COPIES, 7
# the port's kernels as a profiler trace names them (their __global__ names)
TRACE_KERNELS = {"prepass_kernel": "prepass_winding", "scene_kernel": "scene_tiles",
                 "blur_level_kernel": "blur_chunk", "pool_rows_kernel": "pool_rows",
                 "winding_kernel": "winding", "part_entry_kernel": "part_entry",
                 "part_exit_kernel": "part_exit", "untile_kernel": "untile",
                 "fe_blur_kernel": "fe_blur", "fe_turbulence_kernel": "fe_turbulence"}

# Least-time bounds (NVIDIA's H100 SXM data sheet, full 700 W power limit):
# device memory rate and the f32 rate outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# FP32 operations of winding.cuh's edge_contrib, split by what they depend
# on, counting a division as one.  Per (edge, row) whose slab the edge
# crosses, needed once whatever the width: the row clip lo / hi / dy 4, the
# dy == 0 test 1, the two slab columns xs0 / xs1 6, sign * dy 1.  Per
# (edge, pixel) pair: g0 / g1 2, den and its |den| test 3, two
# antiderivatives 7, difference and division 2, times sign * dy 1, the sum 1.
ROW_OPS = 12
PAIR_OPS = 16
# per output pixel of the scanline winding kernel: the carries' running sum,
# the row base and the partial cell added to it
SCAN_OPS = 3
# operations per (item, pixel) of the scene kernel after the winding:
# coverage 2, clip 1, floor 1, opacity 1, OVER of four channels 9; paint is
# not counted, so the bound stays a least time
ITEM_PIXEL_OPS = 14


# ----------------------------------------------------------------------------
# the generated document
# ----------------------------------------------------------------------------
def flat_doc(n_draws: int, size: int, seed: int) -> str:
    """A pass-free SVG document of n_draws draws on a size x size canvas.

    Mixes rects, circles and quadratic / cubic paths; about a quarter are
    strokes (miter, round and bevel joins); solid, linear and radial paints
    with 2-5 stops and all three spread modes, faded by fill-opacity (never
    group opacity); evenodd paths; 16 user-space clipPaths on leaf shapes,
    clipping about a third of the draws; a few shapes spanning many tiles;
    a few star paths with hundreds of edges (big segment classes); and one
    line of text in the default SVG font.  Every isolation construct is
    avoided, so the document lowers to a single pass.
    """
    rng = np.random.default_rng(seed)
    s = size / 1488.0  # geometry scales with the canvas

    def color():
        return "#%02x%02x%02x" % tuple(int(v) for v in rng.integers(0, 256, 3))

    defs = []
    spreads = ("pad", "reflect", "repeat")
    n_grad = 24
    for g in range(n_grad):
        k = int(rng.integers(2, 6))
        offs = np.sort(rng.uniform(0.0, 1.0, k))
        offs[0] = 0.0
        stops = "".join(
            f"<stop offset='{o:.3f}' stop-color='{color()}'"
            f" stop-opacity='{rng.uniform(0.5, 1.0):.2f}'/>"
            for o in offs
        )
        spread = spreads[g % 3]
        if g % 2 == 0:
            x1, y1 = rng.uniform(0.0, 0.4, 2)
            x2, y2 = rng.uniform(0.5, 0.9, 2)
            defs.append(
                f"<linearGradient id='g{g}' x1='{x1:.2f}' y1='{y1:.2f}'"
                f" x2='{x2:.2f}' y2='{y2:.2f}' spreadMethod='{spread}'>"
                f"{stops}</linearGradient>"
            )
        else:
            r = rng.uniform(0.2, 0.5)
            fx, fy = 0.5 + rng.uniform(-0.5, 0.5, 2) * r
            defs.append(
                f"<radialGradient id='g{g}' cx='0.5' cy='0.5' r='{r:.2f}'"
                f" fx='{fx:.2f}' fy='{fy:.2f}' spreadMethod='{spread}'>"
                f"{stops}</radialGradient>"
            )
    for c in range(16):
        cx, cy = rng.uniform(0.1, 0.9, 2) * size
        rad = rng.uniform(60, 260) * s
        if c % 2 == 0:
            shape = f"<circle cx='{cx:.1f}' cy='{cy:.1f}' r='{rad:.1f}'/>"
        else:
            shape = (
                f"<rect x='{cx - rad:.1f}' y='{cy - 0.7 * rad:.1f}'"
                f" width='{2 * rad:.1f}' height='{1.4 * rad:.1f}'"
                f" transform='rotate({rng.uniform(0, 90):.1f} {cx:.1f} {cy:.1f})'/>"
            )
        defs.append(f"<clipPath id='c{c}'>{shape}</clipPath>")

    body = []
    joins = ("miter", "round", "bevel")
    for i in range(n_draws):
        if i % 307 == 5:
            extent = rng.uniform(400, 1100) * s  # spans many tiles: carries
        else:
            extent = rng.uniform(6, 90) * s
        x, y = rng.uniform(-0.05, 0.95, 2) * size
        roll = rng.random()
        if roll < 0.5:
            paint = color()
        else:
            paint = f"url(#g{int(rng.integers(0, n_grad))})"
        attrs = ""
        if rng.random() < 0.35:
            attrs += f" fill-opacity='{rng.uniform(0.4, 1.0):.2f}'"
        if rng.random() < 0.33:
            attrs += f" clip-path='url(#c{int(rng.integers(0, 16))})'"
        if rng.random() < 0.25:
            width = rng.uniform(1.0, 8.0) * s
            join = joins[i % 3]
            attrs += (
                f" fill='none' stroke='{paint}' stroke-width='{width:.2f}'"
                f" stroke-linejoin='{join}'"
            )
        else:
            attrs += f" fill='{paint}'"
        kind = i % 4
        if kind == 0:
            body.append(
                f"<rect x='{x:.1f}' y='{y:.1f}' width='{extent:.1f}'"
                f" height='{extent * rng.uniform(0.3, 1.2):.1f}'{attrs}/>"
            )
        elif kind == 1:
            body.append(
                f"<circle cx='{x:.1f}' cy='{y:.1f}' r='{extent / 2:.1f}'{attrs}/>"
            )
        else:
            pts = rng.uniform(0, extent, (4, 2)) + (x, y)
            if kind == 2:
                d = (
                    f"M{pts[0, 0]:.1f} {pts[0, 1]:.1f} Q{pts[1, 0]:.1f} {pts[1, 1]:.1f}"
                    f" {pts[2, 0]:.1f} {pts[2, 1]:.1f} T{pts[3, 0]:.1f} {pts[3, 1]:.1f} Z"
                )
            else:
                d = (
                    f"M{pts[0, 0]:.1f} {pts[0, 1]:.1f} C{pts[1, 0]:.1f} {pts[1, 1]:.1f}"
                    f" {pts[2, 0]:.1f} {pts[2, 1]:.1f} {pts[3, 0]:.1f} {pts[3, 1]:.1f}"
                    f" C{x:.1f} {pts[3, 1]:.1f} {pts[0, 0]:.1f} {y:.1f}"
                    f" {x + extent / 2:.1f} {y + extent / 2:.1f} Z"
                )
            if rng.random() < 0.4:
                attrs += " fill-rule='evenodd'"
            body.append(f"<path d='{d}'{attrs}/>")
        if i % 256 == 7:
            # a star of hundreds of short edges inside one or two tiles
            n_pts = 240
            ang = np.linspace(0, 2 * np.pi, n_pts, endpoint=False)
            rad = np.where(np.arange(n_pts) % 2 == 0, 14.0, 6.0) * s
            px = x + rad * np.cos(ang)
            py = y + rad * np.sin(ang)
            d = "M" + " L".join(f"{a:.2f} {b:.2f}" for a, b in zip(px, py)) + " Z"
            body.append(f"<path d='{d}' fill='{color()}' fill-rule='evenodd'/>")
    body.append(
        f"<text x='{40 * s:.1f}' y='{size - 40 * s:.1f}' font-size='{36 * s:.1f}'"
        f" fill='#202020'>svgrasterize torch port 0123456789</text>"
    )
    return (
        f"<svg xmlns='http://www.w3.org/2000/svg' width='{size}' height='{size}'"
        f" viewBox='0 0 {size} {size}'><defs>{''.join(defs)}</defs>"
        + "".join(body) + "</svg>"
    )


def pass_doc(n_draws: int, size: int, seed: int) -> str:
    """A document of isolation passes on a size x size canvas, icon-sheet
    like: n_draws plain draws, and among them 64 opacity groups of 3
    draws, 12 gradient masks, 12 anti-aliased clip paths over multi-draw
    groups, 24 lone feGaussianBlur filters (stdDeviation 1-8, some
    anisotropic, some on SourceAlpha), 8 drop-shadow chains, 8
    colour-matrix / composite chains and 8 filters nested inside opacity
    groups (so the plan has at least 2 dependency levels)."""
    rng = np.random.default_rng(seed)
    s = size / 1488.0

    def color():
        return "#%02x%02x%02x" % tuple(int(v) for v in rng.integers(0, 256, 3))

    def xy():
        return rng.uniform(0.02, 0.9, 2) * size

    defs = []
    for g in range(8):
        stops = "".join(
            f"<stop offset='{o:.2f}' stop-color='{color()}'/>" for o in (0.0, 0.5, 1.0)
        )
        defs.append(
            f"<linearGradient id='g{g}' x1='0' y1='0' x2='{rng.uniform(0.4, 1):.2f}'"
            f" y2='{rng.uniform(0, 1):.2f}'>{stops}</linearGradient>"
        )
    for m in range(12):
        defs.append(
            f"<linearGradient id='mg{m}' x1='0' y1='0' x2='1' y2='{rng.uniform(0, 1):.2f}'>"
            "<stop offset='0' stop-color='white'/><stop offset='1' stop-color='#101010'/>"
            f"</linearGradient><mask id='m{m}' maskContentUnits='objectBoundingBox'>"
            f"<rect x='0' y='0' width='1' height='1' fill='url(#mg{m})'/></mask>"
        )
    for c in range(12):
        cx, cy = xy()
        r = rng.uniform(30, 90) * s
        shape = (f"<circle cx='{cx:.1f}' cy='{cy:.1f}' r='{r:.1f}'/>" if c % 2 == 0 else
                 f"<rect x='{cx - r:.1f}' y='{cy - r / 2:.1f}' width='{2 * r:.1f}'"
                 f" height='{r:.1f}' transform='rotate({rng.uniform(5, 80):.1f}"
                 f" {cx:.1f} {cy:.1f})'/>")
        defs.append(f"<clipPath id='c{c}'>{shape}</clipPath>")
    for b in range(24):
        sx = rng.uniform(1, 8)
        std = f"{sx:.2f}" if b % 3 else f"{sx:.2f} {rng.uniform(1, 8):.2f}"
        src = " in='SourceAlpha'" if b % 4 == 1 else ""
        defs.append(f"<filter id='b{b}'><feGaussianBlur{src} stdDeviation='{std}'/></filter>")
    for d in range(8):
        defs.append(
            f"<filter id='ds{d}'><feGaussianBlur in='SourceAlpha'"
            f" stdDeviation='{rng.uniform(1, 4):.2f}' result='blur'/>"
            f"<feOffset in='blur' dx='{rng.uniform(2, 8):.1f}' dy='{rng.uniform(2, 8):.1f}'"
            " result='shadow'/><feMerge><feMergeNode in='shadow'/>"
            "<feMergeNode in='SourceGraphic'/></feMerge></filter>"
        )
    ops = ("atop", "in", "out", "xor")
    for k in range(8):
        cm = (f"type='saturate' values='{rng.uniform(0, 1):.2f}'" if k % 2 == 0 else
              f"type='hueRotate' values='{rng.uniform(0, 360):.0f}'")
        comp = (f"operator='{ops[k % 4]}'" if k < 4 else
                "operator='arithmetic' k1='0.2' k2='0.6' k3='0.4' k4='0'")
        defs.append(
            f"<filter id='cm{k}'><feColorMatrix {cm} result='c'/>"
            f"<feComposite in='c' in2='SourceGraphic' {comp}/></filter>"
        )

    def shape(extent, attrs):
        x, y = xy()
        kind = int(rng.integers(0, 3))
        if kind == 0:
            return (f"<rect x='{x:.1f}' y='{y:.1f}' width='{extent:.1f}'"
                    f" height='{extent * rng.uniform(0.4, 1.2):.1f}'{attrs}/>")
        if kind == 1:
            return f"<circle cx='{x:.1f}' cy='{y:.1f}' r='{extent / 2:.1f}'{attrs}/>"
        pts = rng.uniform(0, extent, (3, 2)) + (x, y)
        return (f"<path d='M{x:.1f} {y:.1f} Q{pts[0, 0]:.1f} {pts[0, 1]:.1f}"
                f" {pts[1, 0]:.1f} {pts[1, 1]:.1f} T{pts[2, 0]:.1f} {pts[2, 1]:.1f} Z'{attrs}/>")

    def paint():
        if rng.random() < 0.6:
            return f" fill='{color()}'"
        return f" fill='url(#g{int(rng.integers(0, 8))})'"

    def draw(lo=8, hi=80):
        attrs = paint()
        if rng.random() < 0.3:
            attrs += f" fill-opacity='{rng.uniform(0.4, 1):.2f}'"
        return shape(rng.uniform(lo, hi) * s, attrs)

    specials = (
        [lambda k: f"<g opacity='{rng.uniform(0.3, 0.8):.2f}'>{draw()}{draw()}{draw()}</g>"] * 64
        + [lambda k: f"<g mask='url(#m{k % 12})'>{draw(40, 140)}{draw(20, 80)}</g>"] * 12
        + [lambda k: f"<g clip-path='url(#c{k % 12})'>{draw(60, 200)}{draw(40, 140)}"
                     f"{draw(20, 80)}</g>"] * 12
        + [lambda k: shape(rng.uniform(16, 120) * s, paint() + f" filter='url(#b{k % 24})'")] * 24
        + [lambda k: shape(rng.uniform(20, 90) * s, paint() + f" filter='url(#ds{k % 8})'")] * 8
        + [lambda k: shape(rng.uniform(20, 90) * s, paint() + f" filter='url(#cm{k % 8})'")] * 8
        + [lambda k: f"<g opacity='{rng.uniform(0.4, 0.9):.2f}'>"
                     + shape(rng.uniform(16, 80) * s, paint() + f" filter='url(#b{k % 24})'")
                     + draw() + "</g>"] * 8
    )
    order = rng.permutation(len(specials))
    every = max(1, n_draws // len(specials))
    body = []
    k = 0
    for i in range(n_draws):
        body.append(draw())
        if i % every == every - 1 and k < len(specials):
            body.append(specials[order[k]](k))
            k += 1
    body.extend(specials[order[j]](j) for j in range(k, len(specials)))
    return (
        f"<svg xmlns='http://www.w3.org/2000/svg' width='{size}' height='{size}'"
        f" viewBox='0 0 {size} {size}'><defs>{''.join(defs)}</defs>"
        + "".join(body) + "</svg>"
    )


def _png_data_uri(rng, h: int, w: int) -> str:
    """A data: URI of an (h, w) RGBA PNG made from rng: smooth colour ramps,
    noise and a soft alpha edge (straight alpha, as <image> payloads are)."""
    import base64

    from svgrasterize_tpu_torch.core.png import write_png

    yy, xx = np.mgrid[0:h, 0:w] / np.array([h, w])[:, None, None]
    base = rng.uniform(0, 1, (3, 3))
    rgb = np.stack([base[c, 0] * xx + base[c, 1] * yy + base[c, 2] for c in range(3)], -1)
    rgb = np.clip(rgb / rgb.max() + rng.normal(0, 0.05, (h, w, 3)), 0, 1)
    alpha = np.clip(4 * np.minimum(np.minimum(xx, 1 - xx), np.minimum(yy, 1 - yy)) + 0.2, 0, 1)
    image = np.round(np.concatenate([rgb, alpha[..., None]], -1) * 255).astype(np.uint8)
    return "data:image/png;base64," + base64.b64encode(write_png(image).getvalue()).decode()


def interp_doc(n_draws: int, size: int, seed: int, kinds=None) -> str:
    """A document that needs the interpreter, on a size x size canvas:
    n_draws plain draws with, in between them, 24 <pattern> fills (half
    userSpaceOnUse, half objectBoundingBox, some with
    patternContentUnits='objectBoundingBox', some with a gradient inside
    the tile), 8 <image> elements with seeded PNG data URIs (2 rotated, 2
    downscaled, 2 upscaled), 6 gradients with color-interpolation='linearRGB',
    2 gradients of 80 stops, 4 clip paths holding a stroke, and feImage
    filters: 2 of a #fragment, 1 of a PNG data URI.  The linearRGB and
    80-stop gradients and the stroked clips are what the batched path
    cannot express, so render_fast returns None and Scene.render batches
    the runs between them.  kinds: the special kinds to include (default
    all of "pattern", "image", "linear_rgb", "stops80", "stroke_clip",
    "fe_image").
    """
    kinds = set(kinds or ("pattern", "image", "linear_rgb", "stops80", "stroke_clip",
                          "fe_image"))
    rng = np.random.default_rng(seed)
    s = size / 1488.0

    def color():
        return "#%02x%02x%02x" % tuple(int(v) for v in rng.integers(0, 256, 3))

    def xy():
        return rng.uniform(0.02, 0.9, 2) * size

    def stops(k):
        offs = np.sort(rng.uniform(0, 1, k))
        offs[0], offs[-1] = 0.0, 1.0
        return "".join(f"<stop offset='{o:.4f}' stop-color='{color()}'/>" for o in offs)

    defs = []
    for g in range(8):
        defs.append(f"<linearGradient id='g{g}' x1='0' y1='0' x2='1' y2='{rng.uniform(0, 1):.2f}'>"
                    f"{stops(3)}</linearGradient>")
    for k in range(24):
        units = "userSpaceOnUse" if k % 2 == 0 else "objectBoundingBox"
        if units == "userSpaceOnUse":
            pw, ph = rng.uniform(10, 40, 2) * s
            geom = f"x='{rng.uniform(0, 20):.1f}' y='{rng.uniform(0, 20):.1f}' width='{pw:.1f}' height='{ph:.1f}'"
        else:
            pw, ph = rng.uniform(0.1, 0.35, 2)
            geom = f"x='0' y='0' width='{pw:.3f}' height='{ph:.3f}'"
        fill = f"url(#pg{k})" if k % 3 == 0 else color()
        if k % 3 == 0:
            defs.append(f"<radialGradient id='pg{k}'>{stops(3)}</radialGradient>")
        if k % 4 == 1:  # content in bounding-box fractions
            content = (f"<rect x='0' y='0' width='0.08' height='0.06' fill='{fill}'/>"
                       f"<circle cx='0.1' cy='0.1' r='0.04' fill='{color()}'/>")
            extra = " patternContentUnits='objectBoundingBox'"
        else:
            cw = (pw if units == "userSpaceOnUse" else 20.0 * s)
            content = (f"<rect x='0' y='0' width='{0.6 * cw:.1f}' height='{0.5 * cw:.1f}' fill='{fill}'/>"
                       f"<circle cx='{0.7 * cw:.1f}' cy='{0.7 * cw:.1f}' r='{0.25 * cw:.1f}'"
                       f" fill='{color()}' fill-opacity='0.8'/>")
            extra = ""
        rot = f" patternTransform='rotate({rng.uniform(-30, 30):.1f})'" if k % 5 == 2 else ""
        defs.append(f"<pattern id='p{k}' patternUnits='{units}' {geom}{extra}{rot}>"
                    f"{content}</pattern>")
    for k in range(6):
        tag = "linearGradient" if k % 2 == 0 else "radialGradient"
        defs.append(f"<{tag} id='lin{k}' color-interpolation='linearRGB'>{stops(4)}</{tag}>")
    for k in range(2):
        defs.append(f"<linearGradient id='many{k}' x1='0' y1='0' x2='1' y2='0.5'>"
                    f"{stops(80)}</linearGradient>")
    for k in range(4):
        cx, cy = xy()
        r = rng.uniform(40, 110) * s
        defs.append(
            f"<clipPath id='cs{k}'><path d='M{cx - r:.1f} {cy:.1f} Q{cx:.1f} {cy - 1.5 * r:.1f}"
            f" {cx + r:.1f} {cy:.1f} T{cx - r:.1f} {cy + r / 2:.1f}' fill='none' stroke='black'"
            f" stroke-width='{rng.uniform(10, 30) * s:.1f}'/>"
            f"<circle cx='{cx:.1f}' cy='{cy:.1f}' r='{r / 3:.1f}'/></clipPath>"
        )
    for k in range(2):
        fx, fy = xy()
        r = rng.uniform(15, 50) * s
        defs.append(f"<g id='frag{k}'><circle cx='{fx:.1f}' cy='{fy:.1f}' r='{r:.1f}'"
                    f" fill='{color()}'/><rect x='{fx:.1f}' y='{fy:.1f}' width='{r:.1f}'"
                    f" height='{r / 2:.1f}' fill='url(#g{k})'/></g>")
        defs.append(f"<filter id='fi{k}'><feImage href='#frag{k}' result='im'/>"
                    "<feComposite in='im' in2='SourceGraphic' operator='over'/></filter>")
    fx, fy = xy()
    defs.append(f"<filter id='fp'><feImage href='{_png_data_uri(rng, 24, 40)}' x='{fx:.1f}'"
                f" y='{fy:.1f}' width='{90 * s:.1f}' height='{60 * s:.1f}' result='im'/>"
                "<feComposite in='im' in2='SourceGraphic' operator='over'/></filter>")

    def shape(extent, attrs):
        x, y = xy()
        kind = int(rng.integers(0, 3))
        if kind == 0:
            return (f"<rect x='{x:.1f}' y='{y:.1f}' width='{extent:.1f}'"
                    f" height='{extent * rng.uniform(0.4, 1.2):.1f}'{attrs}/>")
        if kind == 1:
            return f"<circle cx='{x:.1f}' cy='{y:.1f}' r='{extent / 2:.1f}'{attrs}/>"
        pts = rng.uniform(0, extent, (3, 2)) + (x, y)
        return (f"<path d='M{x:.1f} {y:.1f} Q{pts[0, 0]:.1f} {pts[0, 1]:.1f}"
                f" {pts[1, 0]:.1f} {pts[1, 1]:.1f} T{pts[2, 0]:.1f} {pts[2, 1]:.1f} Z'{attrs}/>")

    def draw():
        paint = color() if rng.random() < 0.7 else f"url(#g{int(rng.integers(0, 8))})"
        attrs = f" fill='{paint}'"
        if rng.random() < 0.3:
            attrs += f" fill-opacity='{rng.uniform(0.4, 1):.2f}'"
        return shape(rng.uniform(8, 90) * s, attrs)

    def image(k):
        ih, iw = (int(v) for v in rng.integers(24, 64, 2))
        scale = (1.0, 1.0, 0.5, 0.35, 2.5, 4.0, 1.3, 0.8)[k]
        x, y = xy()
        tr = f" transform='rotate({rng.uniform(10, 80):.1f} {x:.1f} {y:.1f})'" if k >= 6 else ""
        return (f"<image x='{x:.1f}' y='{y:.1f}' width='{iw * scale * s:.1f}'"
                f" height='{ih * scale * s:.1f}' href='{_png_data_uri(rng, ih, iw)}'{tr}/>")

    specials = []
    if "pattern" in kinds:
        specials += [lambda k: shape(rng.uniform(60, 220) * s, f" fill='url(#p{k % 24})'")] * 24
    if "image" in kinds:
        specials += [lambda k: image(k % 8)] * 8
    if "linear_rgb" in kinds:
        specials += [lambda k: shape(rng.uniform(60, 200) * s, f" fill='url(#lin{k % 6})'")] * 6
    if "stops80" in kinds:
        specials += [lambda k: shape(rng.uniform(100, 300) * s, f" fill='url(#many{k % 2})'")] * 2
    if "stroke_clip" in kinds:
        specials += [lambda k: f"<g clip-path='url(#cs{k % 4})'>{draw()}"
                               f"{shape(rng.uniform(80, 240) * s, f' fill={chr(39)}{color()}{chr(39)}')}"
                               "</g>"] * 4
    if "fe_image" in kinds:
        specials += [lambda k: shape(rng.uniform(30, 90) * s, f" fill='{color()}' filter='url(#fi{k % 2})'")] * 2
        specials += [lambda k: shape(rng.uniform(30, 90) * s, f" fill='{color()}' filter='url(#fp)'")]
    order = rng.permutation(len(specials))
    every = max(1, n_draws // max(len(specials), 1))
    body = []
    k = 0
    for i in range(n_draws):
        body.append(draw())
        if i % every == every - 1 and k < len(specials):
            body.append(specials[order[k]](int(order[k])))
            k += 1
    body.extend(specials[order[j]](int(order[j])) for j in range(k, len(specials)))
    if "pattern" in kinds:  # the group an --id render draws
        body.append(f"<g id='{PATTERN_GROUP}'>"
                    + "".join(shape(rng.uniform(80, 200) * s, f" fill='url(#p{k})'")
                              for k in (0, 1, 4))
                    + "</g>")
    return (
        f"<svg xmlns='http://www.w3.org/2000/svg' width='{size}' height='{size}'"
        f" viewBox='0 0 {size} {size}'><defs>{''.join(defs)}</defs>"
        + "".join(body) + "</svg>"
    )


def pattern_doc(n_draws: int, size: int, seed: int) -> str:
    """interp_doc restricted to its pattern fills and images: the batched
    path lowers it whole."""
    return interp_doc(n_draws, size, seed, kinds=("pattern", "image"))


def icon_doc(index: int) -> str:
    """A 48 x 48 icon-like document made from `index`: a gradient plate, 8-13
    solid and gradient shapes (some translucent), an opacity group and a
    masked group (two isolation passes).  Everything stays inside the
    document, and there is no filter (a blur's placement truncates by its
    layer origin), so every copy of it in an atlas renders alike."""
    rng = np.random.default_rng(1000 + index)

    def color():
        return "#%02x%02x%02x" % tuple(int(v) for v in rng.integers(0, 256, 3))

    def shape(attrs):  # inside the 48 x 48 cell: content must not reach a neighbour
        x, y = rng.uniform(12, 26, 2)
        e = rng.uniform(6, 20)
        kind = int(rng.integers(0, 3))
        if kind == 0:
            return (f"<rect x='{x:.2f}' y='{y:.2f}' width='{e:.2f}' height='{e * 0.7:.2f}'"
                    f" rx='{e / 6:.2f}'{attrs}/>")
        if kind == 1:
            return f"<circle cx='{x:.2f}' cy='{y:.2f}' r='{e / 2:.2f}'{attrs}/>"
        p = rng.uniform(2, 46, (4, 2))
        return (f"<path d='M{x:.2f} {y:.2f} Q{p[0, 0]:.2f} {p[0, 1]:.2f} {p[1, 0]:.2f}"
                f" {p[1, 1]:.2f} Q{p[2, 0]:.2f} {p[2, 1]:.2f} {p[3, 0]:.2f} {p[3, 1]:.2f} Z'"
                f"{attrs}/>")

    def paint():
        r = rng.random()
        if r < 0.25:
            return " fill='url(#lg)'"
        if r < 0.4:
            return " fill='url(#rg)'"
        return f" fill='{color()}'" + (f" fill-opacity='{rng.uniform(0.4, 1):.2f}'"
                                        if rng.random() < 0.3 else "")

    body = [shape(paint()) for _ in range(int(rng.integers(8, 14)))]
    body.insert(int(rng.integers(0, len(body))),
                f"<g opacity='{rng.uniform(0.3, 0.8):.2f}'>{shape(paint())}{shape(paint())}</g>")
    body.insert(int(rng.integers(0, len(body))),
                f"<g mask='url(#m)'>{shape(paint())}{shape(paint())}</g>")
    return (
        "<svg xmlns='http://www.w3.org/2000/svg' width='48' height='48'><defs>"
        f"<linearGradient id='lg' x2='{rng.uniform(0.3, 1):.2f}' y2='{rng.uniform(0, 1):.2f}'>"
        f"<stop offset='0' stop-color='{color()}'/><stop offset='1' stop-color='{color()}'/>"
        f"</linearGradient><radialGradient id='rg'><stop offset='0' stop-color='{color()}'/>"
        f"<stop offset='1' stop-color='{color()}' stop-opacity='0.3'/></radialGradient>"
        "<mask id='m'><rect width='48' height='48' fill='url(#lg)'/></mask></defs>"
        f"<rect x='1' y='1' width='46' height='46' rx='8' fill='url(#lg)'/>"
        + "".join(body) + "</svg>"
    )


def winding_cases(height: int, width: int, wide: int, seed: int = 0) -> dict:
    """Adversarial edge lists of the whole-image winding kernel, name ->
    (lines (S, 4) f32 (a0, a1, b0, b1), mask height, mask width).

    At height x width: edges crossing column 0 and column width, edges
    wholly left and wholly right of the mask, vertical edges on integer and
    non-integer columns, near-vertical ones whose slab columns differ by at
    most 1e-7 (the closed form's |den| <= 1e-7 branch), steep and shallow
    edges, edges outside [0, height), horizontal and padding rows among live
    ones, and a dense random list (many edges sharing a cell or a carry
    column).  Then an empty list, a 1 x 1, a 1-row and a 1-column mask, and
    a 5-row mask `wide` columns wide, beyond one column segment of the
    kernel (edges on segment borders, shallow edges across segments).
    Random steep edges are left out: where a slab's columns nearly coincide
    the closed form amplifies one ulp of them, so two correct
    implementations that round a column apart differ there."""
    h, w = float(height), float(width)
    rng = np.random.default_rng(seed)

    def rand(n, ys, xs):
        e = np.empty((n, 4), np.float32)
        e[:, 0::2] = rng.uniform(*ys, (n, 2))
        e[:, 1::2] = rng.uniform(*xs, (n, 2))
        return e

    def fixed(rows):
        return np.array(rows, np.float32).reshape(-1, 4)

    y0, y1 = round(0.08 * h) + 0.25, round(0.83 * h) - 0.5
    near = np.array([0.5, 0.5, 3.0, 0.25, 1e-8, 7.75], np.float32)
    cases = {
        "crossing_borders": (np.concatenate([
            rand(12, (-2, h + 2), (-0.35 * w, 0.3 * w)),
            rand(12, (-2, h + 2), (0.7 * w, 1.35 * w)),
            fixed([[y0, -5, y0, w + 5], [y0, w + 5, y1, w + 5], [y1, w + 5, y1, -5],
                   [y1, -5, y0, -5]])]), height, width),
        "outside_columns": (np.concatenate([
            rand(10, (-3, h + 3), (-1.5 * w, -0.5)), rand(10, (-3, h + 3), (w + 0.5, 2.5 * w)),
            rand(6, (0, h), (0, w))]), height, width),
        "vertical": (fixed([
            [0.04 * h, round(w / 8), 0.83 * h, round(w / 8)],
            [0.92 * h, round(w / 4) + 0.5, 0.14 * h, round(w / 4) + 0.5],
            [0, 0, h, 0], [h, w, 0, w],
            [0.17 * h, round(0.45 * w) - 0.001, 0.37 * h, round(0.45 * w) - 0.001],
            [0.31 * h, round(0.75 * w), 0.08 * h, round(0.75 * w)],
            [0.1 * h, round(0.3 * w) + 0.25, 0.81 * h, round(0.3 * w) + 0.25]]), height, width),
        "near_vertical": (np.stack([
            np.array([0.04, 0.21, 0.0, 0.27, 0.58, 0.14], np.float32) * np.float32(h), near,
            np.array([0.49, 0.65, 0.75, 0.69, 0.05, 0.86], np.float32) * np.float32(h),
            np.nextafter(near, np.float32(np.inf))], 1), height, width),
        "steep_and_shallow": (fixed([
            [0, 0.075 * w, 0.98 * h, 0.09 * w], [0.96 * h, 0.28 * w, 0.02 * h, 0.2525 * w],
            [0.125 * h, 0.025 * w, 0.146 * h, 0.95 * w], [0.425 * h, 0.975 * w, 0.454 * h, 0.0125 * w],
            [0.04 * h, -4, 0.92 * h, w + 4], [0.529 * h, 0.05 * w, 0.5295 * h, 0.925 * w]]),
            height, width),
        "outside_rows": (np.concatenate([
            rand(8, (-1.25 * h, -0.25), (0, w)), rand(8, (h + 0.25, 2.25 * h), (0, w)),
            rand(8, (-0.4 * h, 1.4 * h), (0, w))]), height, width),
        "horizontal_and_padding": (np.concatenate([
            rand(10, (0, h), (0, w)), np.zeros((7, 4), np.float32),
            fixed([[0.2 * h, 1, 0.2 * h, 0.75 * w], [round(0.48 * h) + 0.5, 0.75 * w,
                                                     round(0.48 * h) + 0.5, 2],
                   [0, 0, 0, 0.22 * w]])]), height, width),
        "dense_random": (rand(96, (-4, h + 4), (-4, w + 6)), height, width),
        "empty": (np.zeros((0, 4), np.float32), 6, 9),
        "one_pixel": (fixed([[0.2, 0.1, 0.9, 0.7], [0.9, 0.7, 0.4, -0.3], [-1, -1, 2, 2]]), 1, 1),
        "one_row": (rand(16, (-1, 2), (-3, 53)), 1, 50),
        "one_column": (rand(16, (-3, 43), (-30, 30)), 40, 1),
        "beyond_one_segment": (np.concatenate([
            rand(24, (-1, 6), (-20, wide + 20)),
            fixed([[0.5, 255.5, 4.5, 256.5], [4.2, 511.9, 0.1, 512.1], [1, 5, 1.5, wide - 5],
                   [3.9, wide - 1, 3.1, -2], [0, 256, 5, 256]])]), 5, wide),
    }
    return cases


# ----------------------------------------------------------------------------
# helpers
# ----------------------------------------------------------------------------
def _say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def _time_ms(torch, fn, reps: int) -> float:
    """Mean ms per call of fn on the card, by CUDA events after a warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _device_ms(torch, fn, reps: int) -> float:
    """Mean ms per call of fn on the card with the host ahead of it: a
    sleep kernel queued first holds the card while the host enqueues every
    call, so the calls run back to back and the host's dispatch between
    them is hidden (_time_ms includes it wherever it is the slower side)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)  # ~50 ms at the H100's clocks
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _lower(doc_path: str, width, tile: int, passes: bool = False):
    """Parse and lower a document as the CLI does; returns
    (viewport, lowered, {layer: seconds}).  passes: whether the document
    must lower to isolation passes (else to a single pass)."""
    from svgrasterize_tpu_torch.core.transform import Transform
    from svgrasterize_tpu_torch.frontend.svg import scene_from_filepath
    from svgrasterize_tpu_torch.render_plan import lower_scene
    from svgrasterize_tpu_torch.text.fonts import DEFAULT_FONTS, FontsDB

    seconds = {}
    t0 = time.monotonic()
    fonts = FontsDB()  # loads the font file lazily, while parsing the text
    fonts.register_file(DEFAULT_FONTS)
    scene, _ids, (w, h) = scene_from_filepath(doc_path, None, width, fonts)
    seconds["parse"] = time.monotonic() - t0
    viewport = (0, 0, int(h), int(w))
    t0 = time.monotonic()
    lowered = lower_scene(scene, Transform().matrix(0, 1, 0, 1, 0, 0), viewport,
                          False, tile)
    seconds["lower"] = time.monotonic() - t0
    if lowered is None or bool(lowered.groups) != passes:
        raise RuntimeError(f"the generated document must lower {'with' if passes else 'without'}"
                           " isolation passes")
    return viewport, lowered, seconds


def _launches() -> dict:
    from svgrasterize_tpu_torch.ops import fused_exec

    return {k.__name__: k.launches for k in fused_exec.KERNELS}


def _bound(nbytes: float, ops: float) -> dict:
    """The least time of a kernel's work: its bytes (each input read once,
    each output written once) over the memory rate against its FP32
    operations over the FP32 rate; the larger one bounds it."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return dict(bound_ms=max(t_bytes, t_ops) * 1e3,
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def _live_edges(edges) -> int:
    """Edges of edges (..., 4) that can contribute: not horizontal and not
    padding (a zero row is horizontal)."""
    return int((edges[..., 0] != edges[..., 2]).sum())


def _winding_ops(edges, height: int, width: int) -> int:
    """FP32 operations a winding field of edges (..., 4) needs: ROW_OPS for
    each live edge and each row in [0, height) whose slab it crosses, and
    PAIR_OPS for each such (edge, row) times every pixel of the row."""
    import torch

    y_lo = torch.minimum(edges[..., 0], edges[..., 2])
    y_hi = torch.maximum(edges[..., 0], edges[..., 2])
    rows = (torch.clamp(torch.ceil(y_hi), 0, height)
            - torch.clamp(torch.floor(y_lo), 0, height)).clamp(min=0)
    live = edges[..., 0] != edges[..., 2]
    edge_rows = int((rows * live).sum())
    return edge_rows * (ROW_OPS + PAIR_OPS * width)


def _prepass_bound(bigs, t: int) -> dict:
    """Bound of one prepass launch over a plan's classes: their live edges
    read once and every row's (T, T) field plus the zero row written once,
    against _winding_ops over the rows."""
    nbytes = sum(_live_edges(b) * 16 for b in bigs) + (
        sum(b.shape[0] for b in bigs) + 1) * t * t * 4
    return _bound(nbytes, sum(_winding_ops(b, t, t) for b in bigs))


def _scene_bound(plan, big, pool=None) -> dict:
    """Bound of one scene-kernel launch on a plan.  Bytes: the run table,
    the live items' parameters, carries and live inline edges, the stop tables of their
    gradient items, each prepass / clip / field / pool row some live item
    names, at most one atlas texel per pattern-item pixel (never more than
    the atlas), read once; the tiles written once.  Operations: the inline
    winding of the live items plus ITEM_PIXEL_OPS per item pixel."""
    import torch

    from svgrasterize_tpu_torch.ops import batch_exec as be

    t = plan.tile
    live = plan.tile_id < plan.num_tiles
    n_live = int(live.sum())
    ip = plan.iparams[live]
    kind = ip[:, be.I_KIND]
    per_item = (plan.carry, plan.iparams, plan.fparams)
    nbytes = n_live * sum(x[0].numel() * x.element_size() for x in per_item)
    nbytes += (plan.num_tiles + 1) * 4  # the run table
    nbytes += _live_edges(plan.lines[live]) * 16
    n_grad = int(((kind == be.PAINT_LINEAR) | (kind == be.PAINT_RADIAL)).sum())
    nbytes += n_grad * (plan.stop_offsets[0].numel() + plan.stop_colors[0].numel()) * 4

    def rows_named(cols, table, px_bytes):
        if table is None:
            return 0
        idx = ip[:, cols].reshape(-1)
        return torch.unique(idx[idx >= 0]).numel() * t * t * px_bytes

    nbytes += rows_named([be.I_BIG], big, 4) + rows_named([be.I_CLIP], plan.clips, 4)
    nbytes += rows_named([be.I_FIELD], plan.field, 16)
    nbytes += rows_named([be.I_TEX, be.I_MASK], pool, 16)
    if plan.patterns is not None:
        n_pat = int((kind == be.PAINT_PATTERN).sum())
        atlas = plan.patterns.numel() * plan.patterns.element_size()
        nbytes += min(atlas, n_pat * t * t * 16)
    nbytes += plan.num_tiles * t * t * 16
    ops = _winding_ops(plan.lines[live], t, t) + ITEM_PIXEL_OPS * n_live * t * t
    return _bound(nbytes, ops)


def _chunk_bound(chunks, t: int) -> dict:
    """Bound of the blur-chunk launches of a level: the canvas rows each
    chunk reads, its band operators and its out tiles, against the multiply
    -adds of O = BH @ X @ BW^T over the operators' nonzero entries, four
    channels."""
    import torch

    nbytes = ops = 0
    for ck in chunks:
        rows = torch.unique(ck["lut"][ck["lut"] >= 0]).numel()
        n_out = ck["B"] * ck["NOi"] * ck["NOj"]
        nbytes += (rows + n_out) * t * t * 16 + 4 * int(
            (ck["bh"] != 0).sum() + (ck["bw"] != 0).sum())
        for b in range(ck["B"]):
            ops += 8 * (int((ck["bh"][b] != 0).sum()) * ck["NSj"] * t
                        + int((ck["bw"][b] != 0).sum()) * ck["NOi"] * t)
    return _bound(nbytes, ops)


def _scanline_ops(edges, height: int, width: int) -> int:
    """FP32 operations of the scanline winding (csrc/winding.cu) of edges
    (S, 4) at height x width: ROW_OPS for each live (edge, row) pair in
    [0, height), PAIR_OPS for each partial cell [floor(xmin), ceil(xmax))
    of the pair inside [0, width), and SCAN_OPS per pixel."""
    import torch

    a0, a1, b0, b1 = edges.reshape(-1, 4).unbind(-1)
    y_lo, y_hi = torch.minimum(a0, b0), torch.maximum(a0, b0)
    x_lo, x_hi = torch.where(a0 <= b0, a1, b1), torch.where(a0 <= b0, b1, a1)
    dy = y_hi - y_lo
    slope = (x_hi - x_lo) / torch.where(dy > 0, dy, torch.ones_like(dy))
    r0 = torch.clamp(torch.floor(y_lo), 0, height).long()
    n = torch.where(a0 != b0, (torch.clamp(torch.ceil(y_hi), 0, height).long() - r0)
                    .clamp(min=0), 0)
    e = torch.repeat_interleave(torch.arange(n.numel(), device=n.device), n)
    row = (r0[e] + torch.arange(e.numel(), device=n.device)
           - torch.repeat_interleave(torch.cumsum(n, 0) - n, n)).float()
    xs0 = x_lo[e] + slope[e] * (torch.maximum(y_lo[e], row) - y_lo[e])
    xs1 = x_lo[e] + slope[e] * (torch.minimum(y_hi[e], row + 1) - y_lo[e])
    cells = (torch.clamp(torch.ceil(torch.maximum(xs0, xs1)), 0, width)
             - torch.clamp(torch.floor(torch.minimum(xs0, xs1)), 0, width))
    return e.numel() * ROW_OPS + int(cells.sum()) * PAIR_OPS + SCAN_OPS * height * width


def _winding_bound(calls, count=_scanline_ops) -> dict:
    """Bound of whole-image winding launches: the live edges of each list
    read once and each field written once, against count's operations:
    _scanline_ops, the work the kernel does, or _winding_ops, the dense
    per-pixel closed form of the TPU kernel, for comparison with it."""
    nbytes = sum(_live_edges(lines) * 16 + h * w * 4 for lines, h, w in calls)
    return _bound(nbytes, sum(count(lines, h, w) for lines, h, w in calls))


def _ptxas_report(log: str) -> list:
    """(kernel<T>, registers, spill bytes, static shared bytes) of each
    entry that nvcc -Xptxas -v compiled, from its log."""
    import re

    report, name, spilled = [], None, 0
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            k = re.search(r"([a-z_]+_kernel)(?:ILi(\d+)E)?", m.group(1))
            name = (m.group(1) if not k else f"{k.group(1)}<{k.group(2)}>" if k.group(2)
                    else k.group(1))
            spilled = 0
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m and name:
            spilled = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", ln)
        if m and name:
            smem = re.search(r"(\d+) bytes smem", ln)
            report.append((name, int(m.group(1)), spilled, int(smem.group(1)) if smem else 0))
            name = None
    return report


class _Recorder:
    """Wraps a module function for the span of a with-block: records each
    call's arguments (record=True) and/or its synchronised wall time (outer
    calls only).  Used to collect the interpreter's winding inputs and to
    split a render's time; the wrapped function runs unchanged."""

    def __init__(self, module, name: str, record: bool = False):
        self.module, self.name, self.record = module, name, record
        self.calls, self.seconds, self._depth = [], 0.0, 0

    def __enter__(self):
        import torch

        fn = self.fn = getattr(self.module, self.name)

        def wrapped(*args, **kwargs):
            if self.record:
                self.calls.append(tuple(a.clone() if isinstance(a, torch.Tensor) else a
                                        for a in args))
            self._depth += 1
            torch.cuda.synchronize()
            t0 = time.monotonic()
            try:
                return fn(*args, **kwargs)
            finally:
                torch.cuda.synchronize()
                self._depth -= 1
                if self._depth == 0:
                    self.seconds += time.monotonic() - t0

        # a kernel wrapper counts its launches on the function its module
        # name resolves to, which is this one while the block runs; those
        # launches are not a main path's and are not kept
        wrapped.__dict__.update(fn.__dict__)
        setattr(self.module, self.name, wrapped)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.fn)


def _random_canvas(torch, rng, t: int, rows: int, dev):
    """rows random premultiplied pass rows (rows, t, t, 4) on the card, a
    fifth of the pixels fully transparent."""
    alpha = rng.uniform(0, 1, (rows, t, t, 1))
    alpha[rng.random(alpha.shape) < 0.2] = 0.0
    canvas = np.concatenate([rng.uniform(0, 1, (rows, t, t, 3)) * alpha, alpha], -1)
    return torch.from_numpy(canvas.astype(np.float32)).to(dev)


def _random_chunk(rng, t: int, rows: int) -> dict:
    """A random blur chunk (build_chunks' numpy form) over canvas rows
    [0, rows): B parts over random spans, LUTs with empty (-1) tiles,
    gaussian band operators with per-part crops and placements (a part
    whose crop is small leaves out tiles with empty bands, as a chunk's
    smaller parts do), SourceAlpha members, a random colorspace."""
    from svgrasterize_tpu_torch.ops import filter_batch

    B = int(rng.integers(2, 6))
    nsi, nsj = (int(v) for v in rng.integers(1, 4, 2))
    noi, noj = nsi + int(rng.integers(0, 2)), nsj + int(rng.integers(0, 2))

    def taps(k):
        u = np.exp(-np.square(np.arange(k) - k // 2) / (2 * (k / 5) ** 2))
        return u / u.sum()

    def band(u, n_in, n_out):
        crop = int(rng.integers(1, n_in + 1))
        return filter_batch._band(u, crop, int(rng.integers(0, n_in - crop + 1)),
                                  int(rng.integers(-len(u), t)), n_out, n_in)

    u, v = taps(int(rng.integers(3, 20)) | 1), taps(int(rng.integers(3, 20)) | 1)
    return {
        "B": B, "NSi": nsi, "NSj": nsj, "NOi": noi, "NOj": noj,
        "chain_linear": bool(rng.integers(0, 2)),
        "lut": rng.integers(-1, rows, (B, nsi * nsj)).astype(np.int32),
        "bh": np.stack([band(u, nsi * t, noi * t) for _ in range(B)]),
        "bw": np.stack([band(v, nsj * t, noj * t) for _ in range(B)]),
        "src_alpha": rng.random(B) < 0.4,
        "out_idx": np.arange(B * noi * noj, dtype=np.int32),
        "pool_idx": list(range(B * noi * noj)),
    }


def _random_plan(torch, rng, t: int, dev):
    """A random scene plan on the card that reaches every item kind of the
    scene kernel: solid, linear and radial gradients (every spread, stops
    with a duplicate offset), patterns from an atlas, collapsed-run fields,
    pool textures and masks, clip fields and big-class prepass rows, under
    both fill rules, with 0-64 inline edges an item (horizontal edges and
    zero padding among them) and carries; 2 of its 12 tiles are empty and
    16 padding items trail.  Returns (plan, big_wind, pool)."""
    from svgrasterize_tpu_torch.ops import batch_exec as be

    grid, segs, k, n = (3, 4), be.SMALL_SEGS, 5, 240
    num_tiles = grid[0] * grid[1]
    live_tiles = rng.permutation(num_tiles)[:num_tiles - 2]
    tile_id = np.concatenate([np.sort(rng.choice(live_tiles, n)),
                              np.full(16, num_tiles)]).astype(np.int32)
    n += 16
    lines = np.zeros((n, segs, 4), np.float32)
    for i in range(n):
        live = int(rng.integers(0, segs + 1))
        e = rng.uniform(-3, t + 3, (live, 4)).astype(np.float32)
        e[:, 0] = np.clip(e[:, 0], 0, t)
        e[:, 2] = np.clip(e[:, 2], 0, t)
        e[::7, 2] = e[::7, 0]  # horizontal
        lines[i, :live] = e
    n_big, n_clip, n_field, n_pool, n_pat, th = 6, 5, 4, 6, 3, 24
    kind = rng.integers(0, 4, n)
    ip = np.zeros((n, be.N_IPARAMS), np.int32)
    ip[:, be.I_KIND] = kind
    ip[:, be.I_RULE] = rng.integers(0, 2, n)
    ip[:, be.I_SPREAD] = rng.integers(0, 3, n)

    def some(p, count):
        return np.where(rng.random(n) < p, rng.integers(0, count, n), -1)

    ip[:, be.I_BIG] = some(0.15, n_big)
    ip[:, be.I_CLIP] = some(0.3, n_clip)
    ip[:, be.I_FIELD] = some(0.1, n_field)
    ip[:, be.I_TEX] = some(0.1, n_pool)
    ip[:, be.I_MASK] = some(0.15, n_pool)
    pat = kind == be.PAINT_PATTERN
    ip[:, be.I_PAT] = np.where(pat, rng.integers(0, n_pat, n), -1)
    ip[:, be.I_PAT_LO:be.I_PAT_LO + 2] = np.where(pat[:, None], rng.integers(-2, 3, (n, 2)), 0)
    ip[:, be.I_PAT_MAX:be.I_PAT_MAX + 2] = np.where(pat[:, None],
                                                     rng.integers(4, th, (n, 2)), 0)
    fp = np.zeros((n, be.N_FPARAMS), np.float32)
    fp[:, be.F_OPACITY] = rng.uniform(0.3, 1.0, n)
    fp[:, be.F_TILE_R] = tile_id % num_tiles // grid[1] * t
    fp[:, be.F_TILE_C] = tile_id % num_tiles % grid[1] * t
    alpha = rng.uniform(0.2, 1.0, n)
    fp[:, be.F_COLOR:be.F_COLOR + 3] = rng.uniform(0, 1, (n, 3)) * alpha[:, None]
    fp[:, be.F_COLOR + 3] = alpha
    ang = rng.uniform(-0.5, 0.5, n)
    scale = rng.uniform(0.5, 2.0, n)
    fp[:, be.F_AFFINE:be.F_AFFINE + 6] = np.stack([
        np.sin(ang) * scale, np.cos(ang) * scale, rng.uniform(-20, 20, n),
        np.cos(ang) * scale, -np.sin(ang) * scale, rng.uniform(-20, 20, n)], 1)
    extent = 4.0 * t
    fp[:, be.F_P0:be.F_P0 + 2] = rng.uniform(0, extent, (n, 2))
    fp[:, be.F_P1:be.F_P1 + 2] = rng.uniform(0, extent, (n, 2))
    fp[:, be.F_CENTER:be.F_CENTER + 2] = rng.uniform(0, extent, (n, 2))
    fp[:, be.F_FCENTER:be.F_FCENTER + 2] = (fp[:, be.F_CENTER:be.F_CENTER + 2]
                                            + rng.uniform(-4, 4, (n, 2)))
    fp[:, be.F_RADIUS] = rng.uniform(8, 3 * t, n)
    fp[:, be.F_FRADIUS] = np.where(rng.random(n) < 0.5, 0.0, rng.uniform(0, 4, n))
    wh = rng.uniform(5, 30, (n, 2))
    fp[:, be.F_PAT_FWD:be.F_PAT_FWD + 6] = np.stack([
        th / wh[:, 0] * 0.9, rng.uniform(-0.3, 0.3, n), rng.uniform(-1, 1, n),
        rng.uniform(-0.3, 0.3, n), th / wh[:, 1] * 0.9, rng.uniform(-1, 1, n)], 1)
    fp[:, be.F_PAT_XY:be.F_PAT_XY + 2] = rng.uniform(-10, 10, (n, 2))
    fp[:, be.F_PAT_WH:be.F_PAT_WH + 2] = np.where(pat[:, None], wh, 1.0)
    offs = np.sort(rng.uniform(0, 1, (n, k)), axis=1)
    offs[:, 0] = 0.0
    offs[::3, 2] = offs[::3, 1]  # a duplicate offset: a step
    s_alpha = rng.uniform(0.3, 1.0, (n, k, 1))
    stop_cols = np.concatenate([rng.uniform(0, 1, (n, k, 3)) * s_alpha, s_alpha], -1)

    def premultiplied(shape):
        a = rng.uniform(0, 1, shape + (1,))
        return np.concatenate([rng.uniform(0, 1, shape + (3,)) * a, a], -1)

    clips = rng.uniform(0, 1, (n_clip, t, t))
    clips[rng.random(clips.shape) < 0.2] = 0.0
    clips[rng.random(clips.shape) < 0.2] = 1.0
    big_edges = np.zeros((n_big, 128, 4), np.float32)
    for r in range(n_big):
        live = int(rng.integers(1, 129))
        big_edges[r, :live] = rng.uniform(-4, t + 4, (live, 4))

    def up(a, dtype=np.float32):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=dtype)).to(dev)

    plan = be.DevicePlan(
        tile=t, grid=grid, lines=up(lines),
        carry=up(np.round(rng.uniform(-2, 2, (n, t)) * 2) / 2),
        tile_id=up(tile_id, np.int32), iparams=up(ip, np.int32), fparams=up(fp),
        stop_offsets=up(offs), stop_colors=up(stop_cols), bigs=(up(big_edges),),
        clips=up(clips), field=up(premultiplied((n_field, t, t))), reads_pool=True,
        patterns=up(premultiplied((n_pat, th, th))),
        runs=up(be.tile_runs(tile_id, num_tiles), np.int32),
    )
    return plan, be._prepass_winding(plan.bigs, t), up(premultiplied((n_pool, t, t)))


def _item_kinds(plan) -> set:
    """The item kinds a plan's live items reach in the scene kernel."""
    from svgrasterize_tpu_torch.ops import batch_exec as be

    ip = plan.iparams[plan.tile_id < plan.num_tiles].cpu()
    names = {be.PAINT_SOLID: "solid", be.PAINT_LINEAR: "linear",
             be.PAINT_RADIAL: "radial", be.PAINT_PATTERN: "pattern"}
    kinds = {names[int(v)] for v in ip[:, be.I_KIND].unique()}
    for col, name in ((be.I_FIELD, "field"), (be.I_TEX, "tex"), (be.I_MASK, "mask"),
                      (be.I_CLIP, "clip"), (be.I_BIG, "big")):
        if bool((ip[:, col] >= 0).any()):
            kinds.add(name)
    return kinds


def _culled_edges(plan) -> tuple:
    """(evaluated, walked): (edge, pixel-row) pairs of the plan's live
    inline items that the scene kernel evaluates (each warp's kept edges,
    sign != 0 and meeting its rows, rounded up to its group of 8, at each
    of its rows) against segs x rows per item, every padded edge at every
    row, as the first design walked them."""
    t = plan.tile
    # csrc/scene.cu Layout: 32 lanes over T / 2 columns, a whole row at 64, 128
    rows_per_warp = max(64 // t, 1)
    live = (plan.tile_id < plan.num_tiles) & (plan.iparams[:, 3] < 0)  # I_BIG
    lines = plan.lines[live]
    a0, b0 = lines[..., 0], lines[..., 2]
    y_lo, y_hi, sign = a0.minimum(b0), a0.maximum(b0), a0 != b0
    evaluated = 0
    for r0 in range(0, t, rows_per_warp):
        kept = (sign & (y_hi > r0) & (y_lo < r0 + rows_per_warp)).sum(1)
        evaluated += int(((kept + 7) // 8 * 8).sum()) * rows_per_warp
    return evaluated, lines.shape[0] * lines.shape[1] * t


def _pool_rows_check(torch, prog, canvas) -> dict:
    """The pool row kernel against plain on a program's pool: rows of a
    level's canvas and of it reversed, to random pool rows; the pools must
    be equal.  Returns the kernel's entry (times, bound, the one PyTorch
    call computing the same function, a yardstick) and the rows written."""
    from svgrasterize_tpu_torch.ops import batch_exec, fused_exec
    from svgrasterize_tpu_torch.render_plan import new_pool

    t = canvas.shape[1]
    src_all = torch.cat([canvas, canvas.flip(0)])
    g = torch.Generator().manual_seed(3)
    src_idx = torch.randperm(src_all.shape[0], generator=g)[: prog.pool_rows].to(torch.int32)
    dst_idx = torch.randperm(prog.pool_rows, generator=g)[: src_idx.shape[0]].to(torch.int32)
    src_idx, dst_idx = src_idx[: dst_idx.shape[0]].to(canvas.device), dst_idx.to(canvas.device)
    pool_k, pool_p = new_pool(prog), new_pool(prog)
    fused_exec.pool_rows(pool_k, src_all, src_idx, dst_idx)
    batch_exec._pool_rows(pool_p, src_all, src_idx, dst_idx)
    torch.cuda.synchronize()
    if not torch.equal(pool_k, pool_p):
        raise RuntimeError(f"pool row kernel differs from plain at T={t}")
    ms = _time_ms(torch, lambda: fused_exec.pool_rows(pool_k, src_all, src_idx, dst_idx), 50)
    dev_ms = _device_ms(torch, lambda: fused_exec.pool_rows(pool_k, src_all, src_idx, dst_idx),
                        50)
    plain_ms = _time_ms(torch, lambda: batch_exec._pool_rows(pool_p, src_all, src_idx, dst_idx),
                        50)
    pool_l, src_l, dst_l = new_pool(prog), src_idx.long(), dst_idx.long()

    def library():
        pool_l[dst_l] = src_all[src_l]

    library_ms = _time_ms(torch, library, 50)
    n = dst_idx.shape[0]
    return dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms, **_bound(2 * n * t * t * 16, 0),
                library_ms=library_ms, dev_ms=dev_ms, rows=n, tile=t, pool=prog.pool_rows)


def _pool_rows_line(r: dict) -> str:
    return (f"{r['rows']} rows of T={r['tile']} into a {r['pool']}-row pool: equal;"
            f" kernel {r['ms']:.4f} ms ({r['dev_ms']:.4f} ms with the host ahead), plain"
            f" {r['plain_ms']:.4f} ms, pool[dst] = src[idx] {r['library_ms']:.4f} ms, bound"
            f" {r['bound_ms']:.6f} ms ({r['bound_by']})")


def random_part(torch, rng, t: int, dev):
    """A random filter part (render_plan._PartFilter), the level's canvas its
    rows lie in and a viewport: a span of up to 4 x 4 tiles with empty
    slots and its rows in random order, a source bbox whose edges may lie
    inside the span, on it or past it on any side, either chain
    colorspace, and an out span of up to 4 x 4 tiles, some of them written
    to distinct pool rows among POOL_SPARE more."""
    from svgrasterize_tpu_torch.core.transform import Transform
    from svgrasterize_tpu_torch.filter import Filter
    from svgrasterize_tpu_torch.render_plan import _PartFilter

    def ints(lo, hi, n=2):
        return [int(v) for v in rng.integers(lo, hi, n)]

    si0, sj0 = ints(0, 4)
    nsi, nsj = ints(1, 5)
    count = int(rng.integers(1, nsi * nsj + 1))
    local = rng.permutation(nsi * nsj)[:count]  # each row's span tile
    slots = np.full(nsi * nsj, -1)
    slots[local] = np.arange(count)
    first = int(rng.integers(0, 4))
    canvas = _random_canvas(torch, rng, t, first + count + int(rng.integers(0, 3)), dev)
    viewport = tuple(ints(-40, 41))
    bbox = []  # each edge past the span's, on it or inside, a third of the time each
    for origin, size in ((viewport[0] + si0 * t, nsi * t), (viewport[1] + sj0 * t, nsj * t)):
        lo = origin + (-int(rng.integers(1, t + 1)), 0, int(rng.integers(0, size)))[
            rng.integers(0, 3)]
        end = origin + size
        hi = (end + int(rng.integers(1, t + 1)), end,
              int(rng.integers(max(lo, origin) + 1, end + 1)))[rng.integers(0, 3)]
        bbox.append((lo, hi))
    di0, dj0 = ints(0, 4)
    nti, ntj = ints(1, 5)
    n_out = int(rng.integers(1, nti * ntj + 1))
    flt = Filter.empty(linear=bool(rng.integers(0, 2)))

    def i32(values):
        return torch.as_tensor(np.asarray(values, np.int32), device=dev)

    part = _PartFilter(
        flt=flt, transform=Transform(), content_bbox=(bbox[0][0], bbox[1][0], bbox[0][1],
                                                      bbox[1][1]),
        rows=(first, count), span=(si0, sj0, nsi, nsj),
        local=torch.as_tensor(local, dtype=torch.int64, device=dev), slots=i32(slots),
        out=(di0, dj0, nti, ntj), consts=flt.prepare(Transform(), dev),
        src_idx=i32(rng.permutation(nti * ntj)[:n_out]),
        dst_idx=i32(rng.permutation(n_out + POOL_SPARE)[:n_out]),
    )
    return canvas, part, viewport


POOL_SPARE = 5  # pool rows beyond a random part's out tiles


def random_result(torch, rng, part, t: int, viewport, dev, state=None):
    """A random chain result for random_part's part: 1 or 4 channels, either
    alpha mode and colorspace (state: (channels, pre_alpha, linear_rgb) to
    fix them), values a little outside [0, 1] and alphas at and below the
    1e-4 guard, contiguous or a view with other strides, and an offset
    anywhere from wholly above or left of the out span to wholly below or
    right of it."""
    from svgrasterize_tpu_torch.core.layer import Layer

    di0, dj0, nti, ntj = part.out
    h, w = int(rng.integers(1, nti * t + t)), int(rng.integers(1, ntj * t + t))
    channels = 1 if rng.random() < 0.25 else 4
    pre, lin = (bool(v) for v in rng.integers(0, 2, 2))
    if state is not None:
        channels, pre, lin = state
    alpha = rng.uniform(0, 1, (h, w, 1))
    alpha[rng.random(alpha.shape) < 0.2] = 0.0
    alpha[rng.random(alpha.shape) < 0.05] = 5e-5
    rgb = rng.uniform(0, 1, (h, w, 3)) * (alpha if pre else 1.0)
    image = np.concatenate([rgb, alpha], -1) * np.where(rng.random((h, w, 4)) < 0.03,
                                                        1.1, 1.0)
    image = torch.from_numpy(image.astype(np.float32)).to(dev)
    layout = int(rng.integers(0, 3))
    if channels == 1:
        image = image[..., 3:] if layout else image[..., 3:].contiguous()
    elif layout == 1:  # a window of a wider image
        wide = image.new_zeros((h, w + 3, 4))
        wide[:, 2:w + 2] = image
        image = wide[:, 2:w + 2]
    elif layout == 2:  # channel-planar storage
        image = image.permute(2, 0, 1).contiguous().permute(1, 2, 0)
    off = (int(rng.integers(-h, nti * t + 1)), int(rng.integers(-w, ntj * t + 1)))
    return Layer(image, (off[0] + viewport[0] + di0 * t, off[1] + viewport[1] + dj0 * t),
                 pre_alpha=pre, linear_rgb=lin)


def _part_io_bytes(parts, viewport, t: int) -> tuple:
    """Bytes the part kernels need for parts, each read once and written
    once: entry, the crop's pixels and the two seeds; exit, the result's
    pixels inside the out span and the out tiles."""
    from svgrasterize_tpu_torch.ops import part_io

    entry = exit_ = 0
    for part, result in parts:
        (r0, r1, c0, c1), _off = part_io.crop_window(part, viewport, t)
        _si0, _sj0, nsi, nsj = part.span
        pixels = len(range(nsi * t)[r0:r1]) * len(range(nsj * t)[c0:c1])
        entry += 3 * pixels * 16
        _di0, _dj0, nti, ntj = part.out
        off_r, off_c = part_io.exit_offset(result, part, viewport, t)
        h, w, channels = result.image.shape
        inside = (max(0, min(off_r + h, nti * t) - max(off_r, 0))
                  * max(0, min(off_c + w, ntj * t) - max(off_c, 0)))
        exit_ += inside * channels * 4 + part.src_idx.shape[0] * t * t * 16
    return entry, exit_


def _icon_frame(dev, config_name: str = "icons_3840"):
    """A benchmark frame of rasterbench's configuration config_name (the
    icon sheets: icons_3840, effects_3840), seed 0, compiled on dev:
    (CompiledScene, viewport, tile)."""
    import importlib

    from svgrasterize_tpu_torch.core.transform import Transform
    from svgrasterize_tpu_torch.frontend.svg import scene_from_str
    from svgrasterize_tpu_torch.render_plan import CompiledScene, lower_scene

    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), "rasterbench",
                           "configs", f"{config_name}.json"), encoding="utf-8") as f:
        config = json.load(f)
    generator = importlib.import_module(f"rasterbench.docs.{config['generator']}")
    svg, _records = generator.generate(0, **config["args"])
    scene, _ids, (w, h) = scene_from_str(svg, None, config["width"], None)
    vp = (0, 0, int(h), int(w))
    t = config["tile"]
    lowered = lower_scene(scene, Transform().matrix(0, 1, 0, 1, 0, 0), vp, False, t,
                          device=dev)
    return CompiledScene(lowered, vp, False, device=dev), vp, t


def _part_io_phase(torch, dev, results: dict) -> None:
    """The part entry and exit kernels against their plain versions: every
    filter part of the icons_3840 benchmark frame (rasterbench's
    configuration), then random parts at T=16/32/64/128; each call one
    launch.  Times of the frame's parts by CUDA events, against their
    bytes bound; the served icon frame captures one entry and one exit a
    part."""
    from svgrasterize_tpu_torch.ops import fused_exec, part_io
    from svgrasterize_tpu_torch.render_plan import KERNEL_OPS, _apply_group_post, new_pool

    cs, vp, t = _icon_frame(dev)
    prog = cs.program
    pool = new_pool(prog)
    parts, seeds_err, exit_err = [], 0.0, 0.0

    def check_entry(canvas, part, viewport, t):
        before = fused_exec.part_entry.launches
        got = fused_exec.part_entry(canvas, part, viewport, False, t)
        if fused_exec.part_entry.launches != before + 1:
            raise RuntimeError("part_entry made other than one launch")
        ref = part_io.part_entry(canvas, part, viewport, False, t)
        err = 0.0
        for g, r in zip(got, ref):
            if (g.offset, g.pre_alpha, g.linear_rgb, g.image.shape) != (
                    r.offset, r.pre_alpha, r.linear_rgb, r.image.shape):
                raise RuntimeError(f"part_entry gives {g}, plain {r}")
            err = max(err, float((g.image - r.image).abs().max()))
        return got, err

    def check_exit(pool, result, part, viewport, t, linear_rgb):
        got, ref = pool.clone(), pool.clone()
        before = fused_exec.part_exit.launches
        fused_exec.part_exit(got, result, part, viewport, linear_rgb, t)
        if fused_exec.part_exit.launches != before + 1:
            raise RuntimeError("part_exit made other than one launch")
        part_io.part_exit(ref, result, part, viewport, linear_rgb, t)
        return float((got - ref).abs().max())

    # the frame's parts, in order (each level's rows in the pool first)
    for level in prog.levels:
        canvas = fused_exec.execute_items_fused(level.plan, pool if level.needs_pool else None)
        for part in level.filters:
            seeds, err = check_entry(canvas, part, vp[:2], t)
            seeds_err = max(seeds_err, err)
            result = part.flt(part.transform, seeds[1], part.consts, seeds=seeds)
            exit_err = max(exit_err, check_exit(pool, result, part, vp[:2], t, False))
            parts.append((canvas, part, seeds, result))
        _apply_group_post(canvas, pool, level, vp[:2], False, t, KERNEL_OPS)
    torch.cuda.synchronize()
    if not parts:
        raise RuntimeError("the icons_3840 frame has no filter part")
    states = sorted({(r.image.shape[2], r.pre_alpha, r.linear_rgb) for *_x, r in parts})

    def entries():
        for canvas, part, _s, _r in parts:
            fused_exec.part_entry(canvas, part, vp[:2], False, t)

    def exits():
        for _c, part, _s, result in parts:
            fused_exec.part_exit(pool, result, part, vp[:2], False, t)

    def plain_entries():
        for canvas, part, _s, _r in parts:
            part_io.part_entry(canvas, part, vp[:2], False, t)

    def plain_exits():
        for _c, part, _s, result in parts:
            part_io.part_exit(pool, result, part, vp[:2], False, t)

    n = len(parts)
    entry_bytes, exit_bytes = _part_io_bytes([(p, r) for _c, p, _s, r in parts], vp[:2], t)
    timed = {}
    for name, fn, plain, nbytes in (("part_entry", entries, plain_entries, entry_bytes),
                                    ("part_exit", exits, plain_exits, exit_bytes)):
        timed[name] = dict(ms=_time_ms(torch, fn, 20) / n, dev_ms=_device_ms(torch, fn, 20) / n,
                           plain_ms=_time_ms(torch, plain, 5) / n, **_bound(nbytes / n, 0))

    # random parts at every tile, their results in every state
    rng = np.random.default_rng(18)
    worst = {"part_entry": 0.0, "part_exit": 0.0}
    for tr in fused_exec.KERNEL_TILES:
        for _ in range(24):
            canvas, part, viewport = random_part(torch, rng, tr, dev)
            lin_canvas = bool(rng.integers(0, 2))
            got = fused_exec.part_entry(canvas, part, viewport, lin_canvas, tr)
            ref = part_io.part_entry(canvas, part, viewport, lin_canvas, tr)
            for g, r in zip(got, ref):
                if g.image.shape != r.image.shape or g.offset != r.offset:
                    raise RuntimeError(f"part_entry at T={tr}: {g} against plain {r}")
                if g.image.numel():
                    worst["part_entry"] = max(worst["part_entry"],
                                              float((g.image - r.image).abs().max()))
            rpool = _random_canvas(torch, rng, tr, part.dst_idx.shape[0] + POOL_SPARE, dev)
            result = random_result(torch, rng, part, tr, viewport, dev)
            worst["part_exit"] = max(worst["part_exit"], check_exit(
                rpool, result, part, viewport, tr, lin_canvas))
    torch.cuda.synchronize()
    for name, err in (("part_entry", max(seeds_err, worst["part_entry"])),
                      ("part_exit", max(exit_err, worst["part_exit"]))):
        if not err <= PART_TOL:
            raise RuntimeError(f"{name} kernel disagrees with plain: {err} > {PART_TOL}")
        results[name] = dict(max_abs_err=err, library_ms=None, **timed[name])

    # the served icon frame: one entry and one exit a part, captured
    fused_exec.reset_launch_counts()
    cs.render_tiles_many(2)
    torch.cuda.synchronize()
    captured = {k: cs.frame_launches[k] for k in ("part_entry", "part_exit")}
    if captured != {"part_entry": n, "part_exit": n}:
        raise RuntimeError(f"the icon frame captured {captured} for {n} filter parts")
    crops = [s[1].image.shape[0] * s[1].image.shape[1] for _c, _p, s, _r in parts]
    _say("part_io", (
        f"icons_3840 T={t}: {n} filter parts in {len(prog.levels)} levels, crops"
        f" {min(crops)}-{max(crops)} px ({sum(crops)} in all), results (channels, pre_alpha,"
        f" linear_rgb) {states}: entry max abs diff {seeds_err:.3g}, exit {exit_err:.3g};"
        f" random parts T={list(fused_exec.KERNEL_TILES)} x 24: entry"
        f" {worst['part_entry']:.3g}, exit {worst['part_exit']:.3g}; the served frame"
        f" captures {captured}"
    ))
    for name, r in timed.items():
        _say("part_io", (
            f"{name}, the frame's {n} parts: {r['ms']:.4f} ms a call ({r['dev_ms']:.4f} ms"
            f" with the host ahead), plain {r['plain_ms']:.4f} ms, bound {r['bound_ms']:.6f}"
            f" ms ({r['bound_by']})"
        ))
    del cs, prog, pool, parts


def _fe_blur_bound(calls) -> dict:
    """Bound of one chain blur, the mean of calls (image, taps, flag): the
    layer read once and the grown layer written once, against 8 operations
    a tap and pixel (a multiply and an add on four channels) of the pass
    down the rows and of the pass along them."""
    nbytes = ops = 0
    for image, taps, _flag in calls:
        (h, w, _c), (kh, kw) = image.shape, taps.shape
        ho, wo = h + kh - 1, w + kw - 1
        nbytes += (h * w + ho * wo) * 16
        ops += 8 * (ho * w * kh + ho * wo * kw)
    return _bound(nbytes / len(calls), ops / len(calls))


def _fe_blur_phase(torch, dev, results: dict) -> None:
    """The chain blur kernel against its plain version: the icons_3840
    frame's 8 chain blurs (recorded from an eager frame), then random
    layers and taps, both routes, flag on and off, alphas at the
    un-premultiply's floor; each call its launches.  The frame's blurs
    timed against their bound, the plain version and cuDNN's depthwise
    convolution (TF32 off, timed only); the served frame captures one
    launch a chain blur."""
    from svgrasterize_tpu_torch.core.color import pre_to_straight_alpha
    from svgrasterize_tpu_torch.ops import blur, fused_exec

    cs, _vp, t = _icon_frame(dev)
    with _Recorder(fused_exec, "fe_blur", record=True) as rec:
        cs.render_tiles()
    calls = rec.calls
    if len(calls) != 8 or not all(flag for *_x, flag in calls):
        raise RuntimeError(f"the icons_3840 frame blurred {len(calls)} chain layers"
                           f" ({[flag for *_x, flag in calls]}), not 8 to un-premultiply")

    def check(image, taps, flag):
        before = fused_exec.fe_blur.launches
        got = fused_exec.fe_blur(image, taps, flag)
        kh, kw = taps.shape
        if fused_exec.fe_blur.launches != before + fused_exec.fe_blur_launches(kh, kw):
            raise RuntimeError(f"fe_blur of {kh} x {kw} taps made other than"
                               f" {fused_exec.fe_blur_launches(kh, kw)} launches")
        ref = blur.fe_blur(image, taps.u, taps.v, flag)
        if got.shape != ref.shape or not bool(torch.isfinite(got).all()):
            raise RuntimeError(f"fe_blur gives {tuple(got.shape)}, plain {tuple(ref.shape)}")
        return float((got - ref).abs().max())

    frame_err = max(check(*c) for c in calls)
    rng = np.random.default_rng(22)
    floor = np.float32(0.0001)
    worst, routes = 0.0, set()
    for kh, kw in ((3, 3), (5, 5), (11, 11), (19, 19), (7, 21), (23, 25), (25, 23), (41, 61),
                   (101, 3), (3, 101)):
        for h, w in ((1, 1), (1, 300), (300, 1), (int(rng.integers(2, 40)),
                                                   int(rng.integers(2, 40))),
                     (int(rng.integers(90, 260)), int(rng.integers(90, 260)))):
            alpha = rng.uniform(0, 1, (h, w, 1)).astype(np.float32)
            pick = rng.random((h, w, 1))
            alpha[pick < 0.2] = 0
            alpha[pick > 0.8] = rng.choice([np.nextafter(floor, 0), floor,
                                            np.nextafter(floor, 1)], int((pick > 0.8).sum()))
            image = np.concatenate([rng.uniform(0, 1, (h, w, 3)) * alpha, alpha], -1)
            image = torch.from_numpy(image.astype(np.float32)).to(dev)
            taps = blur.BlurTaps((kh, kw), *(torch.from_numpy(rng.dirichlet(np.ones(k))
                                                                .astype(np.float32)).to(dev)
                                             for k in (kh, kw)), None)
            flag = bool(rng.integers(0, 2))
            if not flag:
                image = pre_to_straight_alpha(image)
            worst = max(worst, check(image, taps, flag))
            routes.add(fused_exec.fe_blur_launches(kh, kw))
    torch.cuda.synchronize()
    err = max(frame_err, worst)
    if not err <= BLUR_TOL or routes != {1, 2}:
        raise RuntimeError(f"fe_blur kernel disagrees with plain: {err} > {BLUR_TOL}"
                           f" (routes {routes})")

    def kernels():
        for image, taps, flag in calls:
            fused_exec.fe_blur(image, taps, flag)

    def plain():
        for image, taps, flag in calls:
            blur.fe_blur(image, taps.u, taps.v, flag)

    straight = [(pre_to_straight_alpha(image), torch.outer(taps.u, taps.v))
                for image, taps, _flag in calls]

    def library():
        for image, kernel in straight:
            blur.convolve_full(image, kernel)

    n = len(calls)
    timed = dict(ms=_time_ms(torch, kernels, 50) / n, dev_ms=_device_ms(torch, kernels, 50) / n,
                 plain_ms=_time_ms(torch, plain, 10) / n,
                 library_ms=_time_ms(torch, library, 10) / n, **_fe_blur_bound(calls))
    results["fe_blur"] = dict(max_abs_err=err, **timed)

    # the served icon frame: one launch a chain blur, captured
    fused_exec.reset_launch_counts()
    cs.render_tiles_many(2)
    torch.cuda.synchronize()
    if cs.frame_launches["fe_blur"] != n:
        raise RuntimeError(f"the icon frame captured {cs.frame_launches['fe_blur']} fe_blur"
                           f" launches for {n} chain blurs")
    shapes = [(tuple(image.shape[:2]), taps.shape[0]) for image, taps, _f in calls]
    _say("fe_blur", (
        f"icons_3840 T={t}: {n} chain blurs (layer, taps) {shapes}: max abs diff"
        f" {frame_err:.3g}; random layers 1x1-260x260, taps 3-101, routes {sorted(routes)}:"
        f" {worst:.3g}; the served frame captures {cs.frame_launches['fe_blur']}"
    ))
    _say("fe_blur", (
        f"the frame's {n} blurs: {timed['ms']:.4f} ms a call ({timed['dev_ms']:.4f} ms with the"
        f" host ahead), plain {timed['plain_ms']:.4f} ms, cuDNN depthwise (TF32 off)"
        f" {timed['library_ms']:.4f} ms, bound {timed['bound_ms']:.6f} ms ({timed['bound_by']})"
    ))
    del cs, calls, straight


def _turbulence_ops(h: int, w: int, octaves: int, fractal: bool) -> int:
    """FP32 operations of csrc/fe_turbulence.cu over an h x w region: per
    pixel its centre and user point (14: two adds a centre, two products
    and two adds a coordinate, the two frequencies) and the four channels'
    remap and clamp (fractalNoise's add and halving, two compares a channel);
    per octave the lattice cell (two adds, floors, subtractions and the
    second offsets: 8), the two s-curves (8), per channel the four corners'
    dot products (12), three lerps (9), the absolute value for turbulence,
    the scaled sum (2), and the doubling (2)."""
    per_octave = 8 + 8 + 4 * (12 + 9 + (0 if fractal else 1) + 2) + 2
    per_pixel = 14 + 4 * ((2 if fractal else 0) + 2) + octaves * per_octave
    return h * w * per_pixel


def _fe_turbulence_bound(calls) -> dict:
    """Bound of one feTurbulence, the mean of calls (fe_turbulence's
    arguments): the tables read once and the (h, w, 4) f32 image written
    once, against _turbulence_ops."""
    nbytes = ops = 0
    for selector, gradient, _offset, (h, w), _inv, _fx, _fy, octaves, fractal in calls:
        nbytes += selector.numel() * 4 + gradient.numel() * 4 + h * w * 16
        ops += _turbulence_ops(h, w, octaves, fractal)
    return _bound(nbytes / len(calls), ops / len(calls))


def _kernel_us(torch, fn, name: str, reps: int) -> float:
    """Mean device us of the kernels whose trace name holds name, a call of
    fn, from a torch.profiler trace of reps calls after a warm-up."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        prof.export_chrome_trace(os.path.join(tmp, "trace.json"))
        events = _trace_events(tmp)
    kernels = _device_events(events).get("kernel", {})
    return sum(us for n, (_c, us) in kernels.items() if name in n) / reps


def _fe_turbulence_phase(torch, dev, results: dict, path_launches: dict) -> None:
    """The feTurbulence kernel against its plain version: the effects_3840
    frame's 2 grain cards (recorded from an eager frame), then random
    regions, transforms (scale, rotation, skew), frequencies, octaves 1-8,
    fractalNoise and turbulence; each call one launch.  The grain cards
    timed against their bound and the plain version on the card (no
    PyTorch call computes the noise); the served frame captures one launch
    a grain card (a main path)."""
    import math

    from svgrasterize_tpu_torch import filter as tfilter
    from svgrasterize_tpu_torch.core.transform import Transform
    from svgrasterize_tpu_torch.ops import fused_exec
    from svgrasterize_tpu_torch.ops.turbulence import turbulence_region

    cs, _vp, t = _icon_frame(dev, "effects_3840")
    with _Recorder(fused_exec, "fe_turbulence", record=True) as rec:
        cs.render_tiles()
    calls = rec.calls
    if len(calls) != 2:
        raise RuntimeError(f"the effects_3840 frame ran {len(calls)} feTurbulence, not 2")

    def check(*args):
        size = args[3]
        before = fused_exec.fe_turbulence.launches
        got = fused_exec.fe_turbulence(*args)
        if fused_exec.fe_turbulence.launches != before + 1:
            raise RuntimeError(f"fe_turbulence of {size} made other than one launch")
        ref = turbulence_region(*args)
        if got.shape != ref.shape or not bool(torch.isfinite(got).all()):
            raise RuntimeError(f"fe_turbulence gives {tuple(got.shape)}, plain {tuple(ref.shape)}")
        return float((got - ref).abs().max())

    frame_err = max(check(*c) for c in calls)
    rng = np.random.default_rng(24)
    view = Transform().matrix(0, 1, 0, 1, 0, 0)
    worst = 0.0
    for octaves in (1, 2, 3, 4, 8):
        for fractal in (True, False):
            for h, w in ((1, 1), (1, 300), (int(rng.integers(2, 64)), int(rng.integers(2, 64))),
                         (int(rng.integers(100, 600)), int(rng.integers(100, 900)))):
                tr = view.translate(*rng.uniform(-300, 300, 2)).rotate(
                    rng.uniform(-math.pi, math.pi)).skew(*rng.uniform(-0.5, 0.5, 2)).scale(
                    *rng.uniform(0.3, 3.0, 2))
                fx, fy = (float(f) for f in rng.uniform(0.005, 0.7, 2))
                attrs = (fx, fy, octaves, int(rng.integers(-2**31, 2**32)), fractal, None)
                selector, gradient = tfilter._prepare_primitive(tfilter.FE_TURBULENCE, attrs,
                                                                tr, True, dev)
                offset = tuple(int(o) for o in rng.integers(-500, 3000, 2))
                worst = max(worst, check(selector, gradient, offset, (h, w),
                                         tr.invert.m[:2], fx, fy, octaves, fractal))
    torch.cuda.synchronize()
    err = max(frame_err, worst)
    if not err <= TURBULENCE_TOL:
        raise RuntimeError(f"fe_turbulence kernel disagrees with plain: {err} > {TURBULENCE_TOL}")

    def kernels():
        for args in calls:
            fused_exec.fe_turbulence(*args)

    def plain():
        for args in calls:
            turbulence_region(*args)

    n = len(calls)
    timed = dict(ms=_time_ms(torch, kernels, 50) / n, dev_ms=_device_ms(torch, kernels, 50) / n,
                 kernel_us=_kernel_us(torch, kernels, "fe_turbulence_kernel", 20) / n,
                 plain_ms=_time_ms(torch, plain, 10) / n, library_ms=None,
                 **_fe_turbulence_bound(calls))
    results["fe_turbulence"] = dict(max_abs_err=err, **timed)

    # the served effects frame: one launch a grain card, captured
    fused_exec.reset_launch_counts()
    cs.render_tiles_many(2)
    torch.cuda.synchronize()
    path_launches["effects_serve"] = _launches()
    if cs.frame_launches["fe_turbulence"] != n:
        raise RuntimeError(f"the effects frame captured {cs.frame_launches['fe_turbulence']}"
                           f" fe_turbulence launches for {n} grain cards")
    shapes = [(tuple(c[2]), tuple(c[3]), c[7], c[8]) for c in calls]
    _say("fe_turbulence", (
        f"effects_3840 T={t}: {n} grain cards (offset, size, octaves, fractal) {shapes}: max abs"
        f" diff {frame_err:.3g}; random regions 1x1-600x900, octaves 1-8, both types,"
        f" rotated, skewed, scaled: {worst:.3g}; the served frame captures"
        f" {cs.frame_launches['fe_turbulence']}"
    ))
    _say("fe_turbulence", (
        f"a grain card: {timed['ms']:.4f} ms a call ({timed['dev_ms']:.4f} ms with the host"
        f" ahead; the kernel alone {timed['kernel_us']:.2f} us by the profiler), plain (PyTorch"
        f" on the card) {timed['plain_ms']:.4f} ms, bound {timed['bound_ms']:.6f} ms"
        f" ({timed['bound_by']}; bytes {_bound(calls[0][3][0] * calls[0][3][1] * 16, 0)['bound_ms']:.6f}"
        f" ms, operations {_bound(0, _turbulence_ops(*calls[0][3], calls[0][7], calls[0][8]))['bound_ms']:.6f} ms)"
    ))
    del cs, calls


def _serve_8k_phase(torch, doc: str, fonts, dev, path_launches: dict) -> None:
    """The JAX package's 8K serving configuration on the card: the flat
    document parsed at EIGHT_K_WIDTH wide, lowered at EIGHT_K_TILE, uploaded
    and served by graph replay (replay == eager bit for bit), an eager frame
    against the plain executor; compile seconds by step, ms/frame, the
    kernels with the host ahead beside their bounds, peak device memory."""
    from svgrasterize_tpu_torch import render_plan
    from svgrasterize_tpu_torch.core.transform import Transform
    from svgrasterize_tpu_torch.frontend.svg import scene_from_filepath
    from svgrasterize_tpu_torch.ops import batch_exec, fused_exec

    swap = Transform().matrix(0, 1, 0, 1, 0, 0)
    t8 = time.monotonic()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    scene8, _ids, (w8, h8) = scene_from_filepath(doc, None, EIGHT_K_WIDTH, fonts)
    parse_s = time.monotonic() - t0
    vp8 = (0, 0, int(h8), int(w8))
    t0 = time.monotonic()
    low8 = render_plan.lower_scene(scene8, swap, vp8, False, EIGHT_K_TILE, device=dev)
    lower_s = time.monotonic() - t0
    if low8 is None or low8.groups:
        raise RuntimeError("the 8K document must lower without isolation passes")
    t0 = time.monotonic()
    cs8 = render_plan.CompiledScene(low8, vp8, False, device=dev)
    torch.cuda.synchronize()
    upload_s = time.monotonic() - t0
    r8 = _serve_many(torch, cs8, "serve_8k", path_launches, 3)
    if min(r8["launches"]["prepass_winding"], r8["launches"]["scene_tiles"]) == 0:
        raise RuntimeError(f"the 8K frame missed a kernel: {r8['launches']}")
    eager8 = cs8.render_tiles()
    plain8 = cs8.render_tiles(plain=True)
    torch.cuda.synchronize()
    grid8 = low8.grid
    if tuple(eager8.shape) != (grid8[0] * grid8[1], EIGHT_K_TILE, EIGHT_K_TILE, 4) \
            or grid8[0] * EIGHT_K_TILE < vp8[2] or grid8[1] * EIGHT_K_TILE < vp8[3]:
        raise RuntimeError(f"8K tiles {tuple(eager8.shape)} do not cover {vp8}")
    err8 = float((eager8 - plain8).abs().max())
    if not bool(torch.isfinite(eager8).all()) or not err8 <= SCENE_TOL:
        raise RuntimeError(f"the 8K frame disagrees with the plain executor: {err8}")
    if float(eager8[..., 3].max()) <= 0.0:
        raise RuntimeError("the 8K frame is blank")
    del plain8, eager8
    p8 = cs8.plan
    big8 = fused_exec.prepass_winding(p8.bigs, EIGHT_K_TILE)
    calls = {
        "prepass": (lambda: fused_exec.prepass_winding(p8.bigs, EIGHT_K_TILE),
                    lambda: batch_exec._prepass_winding(p8.bigs, EIGHT_K_TILE),
                    _prepass_bound(p8.bigs, EIGHT_K_TILE)),
        "scene": (lambda: fused_exec.scene_tiles(p8, big8),
                  lambda: batch_exec._scene_tiles(p8, big8), _scene_bound(p8, big8)),
    }
    kernel_times = "; ".join(
        f"{name} {_time_ms(torch, fn, 10):.4f} ms per call ({_device_ms(torch, fn, 10):.4f}"
        f" with the host ahead), plain {_time_ms(torch, plain, 1):.4f}, bound"
        f" {b['bound_ms']:.6f} ({b['bound_by']})"
        for name, (fn, plain, b) in calls.items())
    evaluated, walked = _culled_edges(p8)
    peak8 = torch.cuda.max_memory_allocated()
    mpx8 = vp8[2] * vp8[3] / 1e6
    _say("serve_8k", (
        f"flat_doc({CLI_DRAWS}, {CLI_SIZE}) at {vp8[3]}x{vp8[2]} T={EIGHT_K_TILE}:"
        f" {grid8[0]}x{grid8[1]} tiles, {p8.tile_id.shape[0]} items, big rows"
        f" {[tuple(b.shape[:2]) for b in p8.bigs]}; compile {parse_s + lower_s + upload_s:.2f}s"
        f" (parse {parse_s:.2f}, lowering {lower_s:.2f}, upload {upload_s:.2f}); replay"
        f" {r8['replay_ms']:.4f} ms/frame ({mpx8 / r8['replay_ms'] * 1e3:.1f} Mpx/s), eager"
        f" {r8['eager_ms']:.4f} ms/frame ({mpx8 / r8['eager_ms'] * 1e3:.1f} Mpx/s); replay"
        f" == eager bit for bit; eager vs plain max abs diff {err8:.3g}; {kernel_times}; edges"
        f" evaluated {evaluated} of {walked} ({evaluated / max(walked, 1) * 100:.2f}%);"
        f" max_memory_allocated {peak8} bytes ({peak8 / 2**30:.3f} GiB; {base} allocated"
        f" before the phase); launches {r8['launches']}; phase"
        f" {time.monotonic() - t8:.2f}s"
    ))
    del cs8, low8, big8, p8, scene8, calls
    torch.cuda.empty_cache()


def untile_cases(t: int) -> dict:
    """{name: (grid_h, grid_w, h, w)} of the untile checks at tile t: the
    whole grid, the viewport cropped in rows, in columns and in both, one
    pixel, a grid one tile wide and one tile high."""
    return {
        "full": (3, 4, 3 * t, 4 * t),
        "rows_cropped": (3, 4, 3 * t - 5, 4 * t),
        "cols_cropped": (3, 4, 3 * t, 3 * t + t // 2 + 1),
        "both_cropped": (3, 4, 2 * t + 1, 3 * t + 7),
        "one_pixel": (2, 3, 1, 1),
        "one_tile_wide": (3, 1, 3 * t - 2, t - 3),
        "one_tile_high": (1, 5, t - 1, 5 * t),
    }


def _untile_phase(torch, dev) -> dict:
    """The untile kernel (csrc/untile.cu) against tiles_to_layer's plain
    reshape, permute and crop (on the CPU), bit for bit, on random bit
    patterns at every tile (untile_cases), one launch each; then at the
    benchmark cells' frames (UNTILE_FRAMES) bit for bit against the
    permuting copy on the card, and its time alone by CUDA events beside
    its bound (one read and one write of the viewport's pixels), the
    frame's clone and the permuting copy (the two copies a served request
    made before it).  Returns the 8K frame's numbers for the summary."""
    from svgrasterize_tpu_torch.ops import fused_exec
    from svgrasterize_tpu_torch.render_plan import tiles_to_layer

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

    def random_tiles(n: int, t: int):
        raw = torch.randint(0, 256, (n * t * t * 16,), dtype=torch.uint8, device=dev,
                            generator=gen)
        return raw.view(torch.float32).view(n, t, t, 4)

    checked, timed = 0, {}
    for t in fused_exec.KERNEL_TILES:
        for grid_h, grid_w, h, w in untile_cases(t).values():
            tiles = random_tiles(grid_h * grid_w, t)
            before = fused_exec.untile.launches
            got = fused_exec.untile(tiles, (grid_h, grid_w), t, (0, 0, h, w))
            want = tiles_to_layer(tiles.cpu(), (grid_h, grid_w), t, (0, 0, h, w), False).image
            torch.cuda.synchronize()
            if fused_exec.untile.launches != before + 1 or not torch.equal(_bits(got.cpu()),
                                                                           _bits(want)):
                raise RuntimeError(f"untile at T={t} on {grid_h} x {grid_w} tiles, viewport"
                                   f" {h} x {w}, differs from the plain path")
            checked += 1
    _say("untile", f"{checked} cases at T={list(fused_exec.KERNEL_TILES)} equal the plain"
                   " reshape, permute and crop bit for bit, one launch each")
    for h, w, t in UNTILE_FRAMES:
        grid_h, grid_w = -(-h // t), -(-w // t)
        tiles = random_tiles(grid_h * grid_w, t)

        def untile():
            return fused_exec.untile(tiles, (grid_h, grid_w), t, (0, 0, h, w))

        def permuted():
            canvas = tiles.reshape(grid_h, grid_w, t, t, 4).permute(0, 2, 1, 3, 4)
            return canvas.reshape(grid_h * t, grid_w * t, 4)

        got, want = untile(), permuted()[:h, :w]
        same = _bits(got) == _bits(want)
        # the largest difference where the bits differ (inf where either is NaN)
        err = float(torch.where(same, 0.0, (got - want).abs().nan_to_num(
            nan=float("inf"))).max())
        if not bool(same.all()):
            raise RuntimeError(f"untile at {w} x {h} T={t} differs from the permuting copy"
                               f" (max abs err {err})")
        del got, want, same
        bound = _bound(2 * h * w * 16, 0)["bound_ms"]
        ms = {"untile": _time_ms(torch, untile, 20), "clone": _time_ms(torch, tiles.clone, 20),
              "permuting copy": _time_ms(torch, permuted, 20)}
        host_ahead = _device_ms(torch, untile, 20)
        timed[(h, w, t)] = dict(max_abs_err=err, ms=ms["untile"],
                                plain_ms=ms["permuting copy"], bound_ms=bound,
                                bound_by="bytes", library_ms=None)
        _say("untile", (
            f"{w}x{h} T={t} ({grid_h}x{grid_w} tiles): bound {bound:.6f} ms (one read and one"
            f" write of the viewport's pixels); " + "; ".join(
                f"{name} {v:.4f} ms ({bound / v * 100:.1f} % of the bound)"
                for name, v in ms.items())
            + f"; untile with the host ahead {host_ahead:.4f} ms; the clone and the permuting"
            f" copy together {ms['clone'] + ms['permuting copy']:.4f} ms"))
        del tiles
    torch.cuda.empty_cache()
    return timed[(EIGHT_K_WIDTH, EIGHT_K_WIDTH, EIGHT_K_TILE)]


def _png_pixels(tiles, lowered, viewport) -> np.ndarray:
    """The CLI's output pixels for canvas tiles: merge onto a transparent
    canvas, straight sRGB, 8 bits."""
    import torch

    from svgrasterize_tpu_torch.core.layer import Layer, merge_at
    from svgrasterize_tpu_torch.core.png import read_png
    from svgrasterize_tpu_torch.render_plan import tiles_to_layer

    layer = tiles_to_layer(tiles, lowered.grid, lowered.tile, viewport, False)
    canvas = torch.zeros((viewport[2], viewport[3], 4), dtype=torch.float32,
                         device=tiles.device)
    canvas = merge_at(canvas, layer.image, layer.offset)
    buf = Layer(canvas, (0, 0), True, False).write_png(io.BytesIO())
    return read_png(buf.getvalue())


def _layer_breakdown(torch, doc: str, dev) -> str:
    """Seconds per layer of one render as the CLI runs it: parse (with the
    font file), lowering, upload, the two kernels (CUDA events), PNG readback +
    encode (+ the decode of this check)."""
    from svgrasterize_tpu_torch.ops import fused_exec
    from svgrasterize_tpu_torch.render_plan import plan_from_lowered

    vp, lowered, seconds = _lower(doc, None, 32)
    t0 = time.monotonic()
    plan = plan_from_lowered(lowered, dev)
    torch.cuda.synchronize()
    seconds["upload"] = time.monotonic() - t0
    seconds["kernels"] = _time_ms(
        torch, lambda: fused_exec.execute_items_fused(plan), 20) / 1e3
    tiles = fused_exec.execute_items_fused(plan)
    torch.cuda.synchronize()
    t0 = time.monotonic()
    _png_pixels(tiles, lowered, vp)
    seconds["png"] = time.monotonic() - t0
    parts = ", ".join(f"{k} {v:.6f}s" for k, v in seconds.items())
    return f"{vp[3]}x{vp[2]} T=32: {parts}"


def _pass_breakdown(torch, prog, pool, viewport) -> str:
    """ms per frame of an uploaded pass program through the kernels, and of
    its stages by kind: the levels' scene programs, the per-part filter
    chains (entry and exit kernels, PyTorch ops between), the blur levels (one launch each), the level pool
    writes and the main stream.  CUDA events around the calls, so a stage whose host
    dispatch is slower than the card is timed by its dispatch.  pool holds
    every level's rows (a run_program with it came first)."""
    from svgrasterize_tpu_torch.ops import fused_exec
    from svgrasterize_tpu_torch.render_plan import KERNEL_OPS, _apply_part_filter, run_program

    t, origin = prog.tile, viewport[:2]
    levels = prog.levels

    def scenes():
        return [fused_exec.execute_items_fused(lv.plan, pool if lv.needs_pool else None)
                for lv in levels]

    canvases = scenes()

    def filters():
        for lv, canvas in zip(levels, canvases):
            for part in lv.filters:
                _apply_part_filter(canvas, pool, part, origin, False, t, KERNEL_OPS)

    def blurs():
        for lv, canvas in zip(levels, canvases):
            if lv.blur is not None:
                fused_exec.blur_chunk(canvas, lv.blur, t, False)

    def writes():
        for lv, canvas in zip(levels, canvases):
            if lv.copy_rows is not None:
                fused_exec.pool_rows(pool, canvas, *lv.copy_rows)

    stages = {
        "program": lambda: run_program(prog, origin, False, pool=pool),
        "level scenes": scenes,
        "filter chains": filters,
        "blur levels": blurs,
        "plain-pass pool writes": writes,
        "main stream": lambda: fused_exec.execute_items_fused(prog.main, pool),
    }
    ms = {name: _time_ms(torch, fn, 10) for name, fn in stages.items()}
    return "ms/frame " + ", ".join(f"{k} {v:.4f}" for k, v in ms.items())


def _bits(t):
    """t's float32 values as int32 bit patterns (tells -0.0 from +0.0)."""
    import torch

    return t.contiguous().view(torch.int32)


def _serve_many(torch, cs, label: str, path_launches: dict, eager_reps: int) -> dict:
    """Replay against eager on one compiled scene (a main path: counts set to
    0 before its first render_tiles_many, which captures, and read after):
    the captured frame launches what one eager frame launches, the replayed
    frame equals render_tiles() bit for bit, and ms per frame of both (CUDA
    events around render_tiles_many(SERVE_MANY), one clone per call)."""
    from svgrasterize_tpu_torch.ops import fused_exec

    fused_exec.reset_launch_counts()
    eager = cs.render_tiles()
    torch.cuda.synchronize()
    eager_counts = _launches()
    fused_exec.reset_launch_counts()
    many = cs.render_tiles_many(SERVE_MANY)  # eager warm-up, capture, replays
    torch.cuda.synchronize()
    path_launches[label] = _launches()
    if cs.frame_launches != eager_counts:
        raise RuntimeError(f"{label}: the captured frame launched {cs.frame_launches},"
                           f" an eager frame {eager_counts}")
    if not torch.equal(_bits(many), _bits(eager)):
        raise RuntimeError(f"{label}: the replayed frame differs from render_tiles()")
    replay_ms = _time_ms(torch, lambda: cs.render_tiles_many(SERVE_MANY), 1) / SERVE_MANY
    eager_ms = _time_ms(torch, cs.render_tiles, eager_reps)
    return dict(replay_ms=replay_ms, eager_ms=eager_ms, launches=cs.frame_launches)


def _sharded_launches(cs) -> int:
    """Scene launches one frame of a sharded compiled scene makes: one per
    shard with items, over its levels' programs and its main stream."""
    plans = [lv.plan for lv in cs.program.levels] + [cs.plan]
    return sum(s.plan is not None for p in plans for s in p.shards)


def _png_file(path) -> np.ndarray:
    from svgrasterize_tpu_torch.core.png import read_png

    with open(path, "rb") as f:
        return read_png(f.read()).astype(np.int16)


def _tool_pair(torch, label: str, run, out_cuda: str, out_cpu: str, path_launches: dict):
    """One tool's main path on the card (its default device; counts set to 0
    just before and read just after) and the same call with --device cpu:
    returns (seconds on the card, seconds on the CPU, the two PNGs)."""
    from svgrasterize_tpu_torch.ops import fused_exec

    fused_exec.reset_launch_counts()
    t0 = time.monotonic()
    rc = run(out_cuda, [])
    torch.cuda.synchronize()
    card_s = time.monotonic() - t0
    path_launches[label] = _launches()
    t0 = time.monotonic()
    rc_cpu = run(out_cpu, ["--device", "cpu"])
    cpu_s = time.monotonic() - t0
    if rc != 0 or rc_cpu != 0:
        raise RuntimeError(f"{label} exited {rc} (cuda), {rc_cpu} (cpu)")
    if path_launches[label]["scene_tiles"] == 0:
        raise RuntimeError(f"{label} did not launch the scene kernel: {path_launches[label]}")
    return card_s, cpu_s, _png_file(out_cuda + ".png"), _png_file(out_cpu + ".png")


def _png_diff(img, ref, label: str) -> int:
    if img.shape != ref.shape or int(img[..., 3].max()) == 0:
        raise RuntimeError(f"{label} PNG {img.shape} is blank or not {ref.shape}")
    diff = int(np.abs(img - ref).max())
    if diff > PNG_TOL:
        raise RuntimeError(f"{label} PNG differs from the CPU render by {diff}/255")
    return diff


def _tools_phase(torch, dev, tmp: str, path_launches: dict) -> None:
    """The tools as a user runs them: a specimen sheet of the bundled font
    and a sprite sheet of icon documents (main paths), each on the card and
    on the CPU; where one specimen render's host time goes (profiling.stage
    around each step); font_transform and ttf2svg once each."""
    import gzip
    import importlib.util

    from svgrasterize_tpu_torch.core.transform import Transform
    from svgrasterize_tpu_torch.ops import fused_exec
    from svgrasterize_tpu_torch.render_plan import plan_from_lowered, lower_scene, tiles_to_layer
    from svgrasterize_tpu_torch.text.fonts import DEFAULT_FONTS
    from svgrasterize_tpu_torch.tools import font_transform, specimen, spritify, ttf2svg
    from svgrasterize_tpu_torch.utils import profiling

    # specimen: the sheet through the CLI entry point, card and CPU
    sheet_args = [SPECIMEN_FONT, "-s", str(SPECIMEN_SIZE), "--cols", str(SPECIMEN_COLS)]
    card_s, cpu_s, img, ref = _tool_pair(
        torch, "specimen",
        lambda out, extra: specimen.main(sheet_args[:1] + [out + ".png"] + sheet_args[1:] + extra),
        os.path.join(tmp, "sheet_cuda"), os.path.join(tmp, "sheet_cpu"), path_launches)
    diff = _png_diff(img, ref, "specimen")
    # where one render's time goes, each step a profiling stage (host wall
    # time; the kernels' stage ends in a synchronize, and the kernels alone
    # are timed by CUDA events)
    profiling.enable()
    profiling.reset()
    with profiling.stage("parse font + build sheet"):
        font = specimen._load_font(SPECIMEN_FONT)
        scene, (sw, sh) = specimen.specimen_scene(font, SPECIMEN_SIZE, SPECIMEN_COLS)
    vp = (0, 0, int(np.ceil(sh)), int(np.ceil(sw)))
    lowered = lower_scene(scene, Transform().matrix(0, 1, 0, 1, 0, 0), vp, False, 32,
                          device=dev)  # the port's own "lower" spans
    if lowered is None or lowered.groups:
        raise RuntimeError("the specimen sheet must lower to one pass")
    with profiling.stage("upload"):
        plan = plan_from_lowered(lowered, dev)
        torch.cuda.synchronize()
    with profiling.stage("kernels"):
        tiles = fused_exec.execute_items_fused(plan)
        torch.cuda.synchronize()
    with profiling.stage("png"):
        layer = tiles_to_layer(tiles, lowered.grid, lowered.tile, vp, False)
        layer.background([1.0, 1.0, 1.0, 1.0]).write_png(io.BytesIO())
    split = "; ".join(" ".join(ln.split()) for ln in profiling.report().splitlines())
    profiling.enable(False)
    kernels_ms = _time_ms(torch, lambda: fused_exec.execute_items_fused(plan), 10)
    n_items = int((plan.tile_id < plan.num_tiles).sum())
    _say("tools", (
        f"specimen {SPECIMEN_FONT} ({len(font.glyphs)} glyphs) -s {SPECIMEN_SIZE} --cols"
        f" {SPECIMEN_COLS}: {img.shape[1]}x{img.shape[0]} sheet, {n_items} items, big rows"
        f" {[tuple(b.shape[:2]) for b in plan.bigs]}; {card_s:.3f}s (cuda), {cpu_s:.3f}s"
        f" (cpu), max diff {diff}/255; launches {path_launches['specimen']}; one render by"
        f" stage: {split}; kernels alone {kernels_ms:.4f} ms (CUDA events)"
    ))

    # spritify --render: icon documents packed and rendered through the atlas
    icons = os.path.join(tmp, "icons")
    os.makedirs(icons)
    for i in range(SPRITE_ICONS):
        with open(os.path.join(icons, f"icon_{i:02d}.svg"), "w", encoding="utf-8") as f:
            f.write(icon_doc(i))
    sprite_args = ["-s", str(ATLAS_CELL), "-m", "0", "-c", str(SPRITE_COLS)]
    card_s, cpu_s, img, ref = _tool_pair(
        torch, "spritify",
        lambda out, extra: spritify.main([icons, out + ".svg"] + sprite_args
                                         + ["--render", out + ".png"] + extra),
        os.path.join(tmp, "sprite_cuda"), os.path.join(tmp, "sprite_cpu"), path_launches)
    diff = _png_diff(img, ref, "spritify")
    with open(os.path.join(tmp, "sprite_cuda.svg"), "rb") as a, \
            open(os.path.join(tmp, "sprite_cpu.svg"), "rb") as b:
        if a.read() != b.read():
            raise RuntimeError("spritify wrote another sprite SVG on the card than on the CPU")
    _say("tools", (
        f"spritify --render {SPRITE_ICONS} icons {' '.join(sprite_args)}:"
        f" {img.shape[1]}x{img.shape[0]} sheet; {card_s:.3f}s (cuda), {cpu_s:.3f}s (cpu),"
        f" max diff {diff}/255, sprite SVGs byte-equal; launches {path_launches['spritify']}"
    ))

    # font_transform on the bundled fonts, ttf2svg on a TTF built in memory
    fonts_svg = os.path.join(tmp, "fonts.svg")
    with gzip.open(DEFAULT_FONTS, "rb") as src, open(fonts_svg, "wb") as dst:
        dst.write(src.read())
    t0 = time.monotonic()
    rc = font_transform.main(["translate(0 100) scale(2)", fonts_svg,
                              os.path.join(tmp, "fonts_x2.svg")])
    ft_s = time.monotonic() - t0
    if rc != 0:
        raise RuntimeError(f"font_transform exited {rc}")
    ttf = os.path.join(tmp, "tiny.ttf")
    if importlib.util.find_spec("fontTools") is None:
        # neither fontforge nor fontTools: ttf2svg must say so and exit 1
        rc_ttf = ttf2svg.main([ttf, os.path.join(tmp, "tiny.svg")])
        if rc_ttf != 1:
            raise RuntimeError(f"ttf2svg without fontforge or fontTools exited {rc_ttf}")
        done = "ttf2svg: no fontforge or fontTools on this machine, exited 1 saying so"
    else:
        tiny_ttf(ttf)
        t0 = time.monotonic()
        rc_ttf = ttf2svg.main([ttf, os.path.join(tmp, "tiny.svg")])
        ttf_s = time.monotonic() - t0
        converted = specimen._load_font(ttf)
        if rc_ttf != 0 or converted is None or len(converted.glyphs) != 2:
            raise RuntimeError(f"ttf2svg exited {rc_ttf}")
        done = f"ttf2svg of a 2-glyph TTF {ttf_s:.3f}s, loaded back as {converted.family!r}"
    _say("tools", f"font_transform of the bundled fonts ({os.path.getsize(fonts_svg)} bytes)"
                  f" {ft_s:.3f}s; {done}")


def tiny_ttf(path: str) -> None:
    """A TTF of two glyphs ('a' with a quadratic curve, '&'), built in
    memory with fontTools."""
    from fontTools.fontBuilder import FontBuilder
    from fontTools.pens.ttGlyphPen import TTGlyphPen

    outlines = {".notdef": [(100, 0), (400, 0), (400, 700), (100, 700)],
                "a": [(50, 0), (450, 0), (450, 500), (50, 500)],
                "ampersand": [(100, 0), (300, 0), (200, 650)]}
    glyphs = {}
    for name, pts in outlines.items():
        pen = TTGlyphPen(None)
        pen.moveTo(pts[0])
        for pt in pts[1:]:
            pen.lineTo(pt)
        if name == "a":
            pen.qCurveTo((250, 700), (50, 500))
        pen.closePath()
        glyphs[name] = pen.glyph()
    fb = FontBuilder(1000, isTTF=True)
    fb.setupGlyphOrder(list(outlines))
    fb.setupCharacterMap({ord("a"): "a", ord("&"): "ampersand"})
    fb.setupGlyf(glyphs)
    fb.setupHorizontalMetrics({n: (500, 0) for n in outlines})
    fb.setupHorizontalHeader(ascent=800, descent=-200)
    fb.setupNameTable({"familyName": "TinyTT", "styleName": "Regular"})
    fb.setupOS2()
    fb.setupPost()
    fb.save(path)


def _trace_events(log_dir: str) -> list:
    """The events of the one Chrome trace profiling.trace_to wrote into
    log_dir."""
    traces = [f for f in os.listdir(log_dir) if f.endswith(".json")]
    if len(traces) != 1:
        raise RuntimeError(f"{log_dir} holds {len(traces)} traces")
    with open(os.path.join(log_dir, traces[0]), encoding="utf-8") as f:
        return json.load(f)["traceEvents"]


def _device_events(events, lo: float = -float("inf"), hi: float = float("inf")) -> dict:
    """{kind: {name: [count, device us]}} of the device events that start in
    [lo, hi) (trace microseconds); kind is the trace's category ("kernel",
    "gpu_memcpy", "gpu_memset")."""
    out = {}
    for ev in events:
        if ev.get("ph") == "X" and ev.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset") \
                and lo <= float(ev["ts"]) < hi:
            entry = out.setdefault(ev["cat"], {}).setdefault(ev["name"], [0, 0.0])
            entry[0] += 1
            entry[1] += float(ev.get("dur", 0.0))
    return out


def _port_kernel(name: str):
    """The fused_exec wrapper whose kernel a trace's kernel name is, or None
    for PyTorch's own kernels."""
    import re

    m = re.search(r"(?<![A-Za-z0-9_])(" + "|".join(TRACE_KERNELS) + r")(?![A-Za-z0-9_])", name)
    return TRACE_KERNELS[m.group(1)] if m else None


def _profile_phase(torch, pass_cs, lines, colors, path_launches: dict) -> None:
    """A torch.profiler trace (profiling.trace_to) of one eager frame of the
    pass document, split by kernel, and of one fill_batch call, its winding
    kernel apart from the table's upload and the packing."""
    import shutil

    from svgrasterize_tpu_torch.ops import fused_exec
    from svgrasterize_tpu_torch.parallel import batch as pbatch
    from svgrasterize_tpu_torch.utils import profiling

    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "profile")
    shutil.rmtree(root, ignore_errors=True)

    # one trace of both, each in a stage of its own: one eager frame of the
    # pass document (a main path: counts set to 0 just before, read just
    # after), then one fill_batch call.  Each ends in a synchronize, so the
    # fill batch's device events start after its stage does and every
    # earlier one belongs to the frame.
    pass_cs.render_tiles()
    pbatch.fill_batch(lines, colors, FILL_SIZE, FILL_SIZE, device=lines.device)
    torch.cuda.synchronize()
    fused_exec.reset_launch_counts()
    profiling.enable()  # the stages' record_function marks, in the trace
    with profiling.trace_to(root):
        with profiling.stage("svgr_pass_frame"):
            pass_cs.render_tiles()
            torch.cuda.synchronize()
        path_launches["profile_pass_frame"] = counts = _launches()
        with profiling.stage("svgr_fill_batch"):
            t0 = time.perf_counter()
            pbatch.fill_batch(lines, colors, FILL_SIZE, FILL_SIZE, device=lines.device)
            torch.cuda.synchronize()
            call_ms = (time.perf_counter() - t0) * 1e3
    profiling.enable(False)
    events = _trace_events(root)
    t_fill = min(float(ev["ts"]) for ev in events if ev.get("name") == "svgr_fill_batch")

    kernels = _device_events(events, hi=t_fill).get("kernel", {})
    traced = {_port_kernel(n) for n in kernels} - {None}
    missing = [k for k, v in counts.items() if v and k not in traced]
    if not kernels or missing:
        raise RuntimeError(f"the pass frame's trace holds no device event of {missing or 'any kernel'}")
    port_us = sum(us for n, (_c, us) in kernels.items() if _port_kernel(n))
    torch_us = sum(us for n, (_c, us) in kernels.items() if not _port_kernel(n))
    top = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:10]
    _say("profile", (
        f"pass frame (eager render_tiles, pass_doc {CLI_SIZE}^2 T=32): {len(kernels)} kernels,"
        f" {sum(c for c, _us in kernels.values())} launches, device time {port_us / 1e3:.4f} ms"
        f" in the port's kernels (launches {counts}), {torch_us / 1e3:.4f} ms in PyTorch's"
        f" own (the filter chains and canvas ops)"
    ))
    for name, (n, us) in top:
        _say("profile", f"  {us / 1e3:9.4f} ms x{n:<4d} {name[:110]}")

    # the fill batch: the winding kernel against the rest of the call
    trace = _device_events(events, lo=t_fill)
    kernels = trace.get("kernel", {})
    wind = [(c, us) for n, (c, us) in kernels.items() if _port_kernel(n) == "winding"]
    if len(wind) != 1 or wind[0][0] != 1:
        raise RuntimeError(f"the fill_batch trace holds {wind} winding kernel events; its"
                           f" device events: {trace}")
    other_us = sum(us for n, (_c, us) in kernels.items() if _port_kernel(n) != "winding")
    copies = trace.get("gpu_memcpy", {})
    _say("profile", (
        f"fill_batch {FILL_PATHS} x {FILL_SEGS} edges at {FILL_SIZE}^2: winding kernel"
        f" {wind[0][1] / 1e3:.4f} ms device time; other kernels (fill rule, colour)"
        f" {other_us / 1e3:.4f} ms; table upload {sum(us for _c, us in copies.values()) / 1e3:.4f}"
        f" ms in {sum(c for c, _us in copies.values())} copies; the call {call_ms:.4f} ms host"
        f" wall time under the profiler"
    ))


# ----------------------------------------------------------------------------
# phases
# ----------------------------------------------------------------------------
def main() -> int:
    import torch

    if not torch.cuda.is_available():
        sys.stderr.write("chip_smoke: no CUDA device; nothing was run\n")
        return 1
    from svgrasterize_tpu_torch import cli
    from svgrasterize_tpu_torch.core.png import read_png
    from svgrasterize_tpu_torch.ops import batch_exec, cuda_lib, filter_batch, fused_exec
    from svgrasterize_tpu_torch.render_plan import (
        compile_scene,
        new_pool,
        plan_from_lowered,
        run_program,
        upload_program,
    )

    dev = torch.device("cuda", 0)
    # the plain versions' reductions and products stay in full f32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. device
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    _say("device", f"{kind} x{count}; torch {torch.__version__} cuda {torch.version.cuda}")

    # 2. build
    so, build_s = cuda_lib.build()
    cuda_lib.load()
    _say("build", f"{so.name} in {build_s:.2f}s (0 = cached)")
    for name, regs, spilled, smem in _ptxas_report((so.parent / "nvcc.log").read_text()):
        _say("build", f"{name}: {regs} registers, {spilled} bytes spilled, {smem} bytes"
                      " static shared memory")

    results = {"untile": _untile_phase(torch, dev)}
    with tempfile.TemporaryDirectory() as tmp:
        doc = os.path.join(tmp, "flat.svg")
        with open(doc, "w", encoding="utf-8") as f:
            f.write(flat_doc(CLI_DRAWS, CLI_SIZE, seed=0))

        vp_cli, low_cli, seconds = _lower(doc, None, 32)
        plan = plan_from_lowered(low_cli, dev)
        n_items = int((low_cli.items["tile_id"] < plan.num_tiles).sum())
        _say("plan", (
            f"{CLI_SIZE}^2 T=32: {n_items} items, big rows "
            f"{[tuple(b.shape) for b in low_cli.bigs]}, clips "
            f"{low_cli.clips.shape[0]}, fields "
            f"{0 if plan.field is None else plan.field.shape[0]}, "
            f"lowered in {seconds['lower']:.2f}s"
        ))

        # 3. prepass kernel against plain: random multi-class calls (mixed
        # widths, all-padding rows), one launch each, then the plan's classes
        rng = np.random.default_rng(1)
        worst = 0.0
        for t in fused_exec.KERNEL_TILES:
            t_worst, shapes = 0.0, []
            for _ in range(3):
                arrays = []
                widths = rng.choice((16, 32, 64, 128, 256, 512, 1024),
                                    size=int(rng.integers(2, 6)), replace=False)
                for width in sorted(int(w) for w in widths):
                    m = int(rng.integers(1, 41))
                    edges = np.zeros((m, width, 4), np.float32)
                    for r in range(m):
                        if rng.random() < 0.2:
                            continue  # an all-padding row
                        live = int(rng.integers(1, width + 1))
                        edges[r, :live] = rng.uniform(-4, t + 4, (live, 4))
                    arrays.append(torch.from_numpy(edges).to(dev))
                shapes.append([tuple(a.shape[:2]) for a in arrays])
                before = fused_exec.prepass_winding.launches
                got = fused_exec.prepass_winding(arrays, t)
                if fused_exec.prepass_winding.launches != before + 1:
                    raise RuntimeError("prepass_winding made more than one launch")
                ref = batch_exec._prepass_winding(arrays, t)
                torch.cuda.synchronize()
                t_worst = max(t_worst, float((got - ref).abs().max()))
            worst = max(worst, t_worst)
            _say("prepass", f"T={t} calls of classes (rows, width) {shapes}, one launch"
                            f" each: max abs diff {t_worst:.3g}")
            if not worst <= PREPASS_TOL:
                raise RuntimeError(f"prepass kernel disagrees: {worst} > {PREPASS_TOL}")
        got = fused_exec.prepass_winding(plan.bigs, plan.tile)
        ref = batch_exec._prepass_winding(plan.bigs, plan.tile)
        err = 0.0 if got is None else float((got - ref).abs().max())
        if not err <= PREPASS_TOL:
            raise RuntimeError(f"prepass kernel disagrees on the plan: {err}")
        ms = _time_ms(torch, lambda: fused_exec.prepass_winding(plan.bigs, 32), 20)
        dev_ms = _device_ms(torch, lambda: fused_exec.prepass_winding(plan.bigs, 32), 20)
        plain_ms = _time_ms(torch, lambda: batch_exec._prepass_winding(plan.bigs, 32), 5)
        results["prepass_winding"] = dict(max_abs_err=max(err, worst), ms=ms, plain_ms=plain_ms,
                                          **_prepass_bound(plan.bigs, 32), library_ms=None)
        _say("prepass", (
            f"flat plan T=32 ({sum(b.shape[0] for b in plan.bigs)} rows): max abs diff"
            f" {err:.3g}; kernel {ms:.4f} ms per call ({dev_ms:.4f} ms with the host"
            f" ahead), plain {plain_ms:.4f} ms, bound"
            f" {results['prepass_winding']['bound_ms']:.6f} ms"
            f" ({results['prepass_winding']['bound_by']})"
        ))

        # 4. scene kernel against plain, on the 1488^2 plan at T=32
        big = fused_exec.prepass_winding(plan.bigs, plan.tile)
        got = fused_exec.scene_tiles(plan, big)
        ref = batch_exec._scene_tiles(plan, big)
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        if not bool(torch.isfinite(got).all()) or not err <= SCENE_TOL:
            raise RuntimeError(f"scene kernel disagrees: {err} > {SCENE_TOL}")
        ms = _time_ms(torch, lambda: fused_exec.scene_tiles(plan, big), 20)
        dev_ms = _device_ms(torch, lambda: fused_exec.scene_tiles(plan, big), 20)
        plain_ms = _time_ms(torch, lambda: batch_exec._scene_tiles(plan, big), 3)
        results["scene_tiles"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                      **_scene_bound(plan, big), library_ms=None)
        evaluated, walked = _culled_edges(plan)
        _say("scene", (
            f"flat plan T=32: max abs diff {err:.3g}; kernel {ms:.4f} ms per call"
            f" ({dev_ms:.4f} ms with the host ahead), plain {plain_ms:.4f} ms, bound"
            f" {results['scene_tiles']['bound_ms']:.6f} ms"
            f" ({results['scene_tiles']['bound_by']}); edges evaluated {evaluated} of"
            f" {walked} (segs x rows), {evaluated / max(walked, 1) * 100:.2f}%"
        ))
        # random plans reaching every item kind, at every tile size
        rng = np.random.default_rng(5)
        for t in fused_exec.KERNEL_TILES:
            rplan, rbig, rpool = _random_plan(torch, rng, t, dev)
            kinds = _item_kinds(rplan)
            if len(kinds) < 9:
                raise RuntimeError(f"the random plan misses item kinds: {sorted(kinds)}")
            got = fused_exec.scene_tiles(rplan, rbig, rpool)
            ref = batch_exec._scene_tiles(rplan, rbig, rpool)
            torch.cuda.synchronize()
            err = float((got - ref).abs().max())
            if not bool(torch.isfinite(got).all()) or not err <= SCENE_TOL:
                raise RuntimeError(f"scene kernel disagrees on the random plan at T={t}: {err}")
            results["scene_tiles"]["max_abs_err"] = max(results["scene_tiles"]["max_abs_err"], err)
            _say("scene", (
                f"random plan T={t} ({rplan.tile_id.shape[0]} items over"
                f" {rplan.num_tiles} tiles, 2 empty; {', '.join(sorted(kinds))}):"
                f" max abs diff {err:.3g}"
            ))
        plain_png = _png_pixels(batch_exec.execute_items(plan), low_cli, vp_cli)
        _say("layers", _layer_breakdown(torch, doc, dev))

        # the main paths; each one's counters set to 0 just before it
        path_launches = {}

        # 5. CLI, pass-free document
        fused_exec.reset_launch_counts()
        out_png = os.path.join(tmp, "out.png")
        t0 = time.monotonic()
        rc = cli.main([doc, out_png])
        cli_s = time.monotonic() - t0
        path_launches["cli"] = _launches()
        if rc != 0:
            raise RuntimeError(f"CLI exited {rc}")
        with open(out_png, "rb") as f:
            img = read_png(f.read())
        if img.shape != (CLI_SIZE, CLI_SIZE, 4):
            raise RuntimeError(f"CLI image shape {img.shape}")
        if int(img[..., 3].max()) == 0 or len(np.unique(img.reshape(-1, 4), axis=0)) < 64:
            raise RuntimeError("CLI image is blank")
        diff = np.abs(img.astype(np.int16) - plain_png.astype(np.int16))
        if int(diff.max()) > PNG_TOL:
            raise RuntimeError(f"CLI PNG differs from the plain render by {diff.max()}/255")
        cli_counts = path_launches["cli"]
        if min(cli_counts["prepass_winding"], cli_counts["scene_tiles"]) == 0:
            raise RuntimeError(f"CLI did not launch both kernels: {cli_counts}")
        _say("cli", (
            f"{CLI_SIZE}x{CLI_SIZE} PNG in {cli_s:.3f}s (parse + lower + render +"
            f" encode); max diff vs plain {int(diff.max())}/255,"
            f" {float((diff == 0).mean()) * 100:.4f}% bytes equal; launches {cli_counts}"
        ))

        # 6. serving at 3840^2, T=64
        from svgrasterize_tpu_torch.frontend.svg import scene_from_filepath
        from svgrasterize_tpu_torch.text.fonts import DEFAULT_FONTS, FontsDB
        from svgrasterize_tpu_torch.core.transform import Transform

        fonts = FontsDB()
        fonts.register_file(DEFAULT_FONTS)
        scene, _ids, (w, h) = scene_from_filepath(doc, None, SERVE_WIDTH, fonts)
        vp = (0, 0, int(h), int(w))
        t0 = time.monotonic()
        cs = compile_scene(scene, Transform().matrix(0, 1, 0, 1, 0, 0), vp,
                           tile=64, device=dev)
        compile_s = time.monotonic() - t0
        if cs is None:
            raise RuntimeError("serving scene did not lower")
        fused_exec.reset_launch_counts()
        first = cs.render_tiles()
        torch.cuda.synchronize()
        frame_ms = _time_ms(torch, cs.render_tiles, SERVE_FRAMES)
        last = cs.render_tiles()
        torch.cuda.synchronize()
        path_launches["serve"] = _launches()
        if not torch.equal(first, last):
            raise RuntimeError("serving frames differ")
        if min(path_launches["serve"]["prepass_winding"], path_launches["serve"]["scene_tiles"]) == 0:
            raise RuntimeError(f"serving missed a kernel: {path_launches['serve']}")
        plain_frame_ms = _time_ms(torch, lambda: cs.render_tiles(plain=True), 2)
        plain_last = cs.render_tiles(plain=True)
        serve_err = float((last - plain_last).abs().max())
        if not serve_err <= SCENE_TOL:
            raise RuntimeError(f"serving kernels disagree with plain: {serve_err}")
        # the frame's split between its two kernels, each timed alone
        splan = cs.plan
        sbig = fused_exec.prepass_winding(splan.bigs, 64)
        serr = float((sbig - batch_exec._prepass_winding(splan.bigs, 64)).abs().max())
        if not serr <= PREPASS_TOL:
            raise RuntimeError(f"prepass kernel disagrees on the serving plan: {serr}")
        spre_ms = _time_ms(torch, lambda: fused_exec.prepass_winding(splan.bigs, 64), 20)
        spre_dev_ms = _device_ms(torch, lambda: fused_exec.prepass_winding(splan.bigs, 64), 20)
        sscene_ms = _time_ms(torch, lambda: fused_exec.scene_tiles(splan, sbig), 20)
        sscene_dev_ms = _device_ms(torch, lambda: fused_exec.scene_tiles(splan, sbig), 20)
        sgot = fused_exec.scene_tiles(splan, sbig)
        sref = batch_exec._scene_tiles(splan, sbig)
        torch.cuda.synchronize()
        sscene_err = float((sgot - sref).abs().max())
        del sgot, sref
        if not sscene_err <= SCENE_TOL:
            raise RuntimeError(f"scene kernel disagrees on the serving plan: {sscene_err}")
        ssb = _scene_bound(splan, sbig)
        evaluated, walked = _culled_edges(splan)
        _say("scene", (
            f"serving plan {int(w)}^2 T=64: max abs diff {sscene_err:.3g}; kernel"
            f" {sscene_ms:.4f} ms per call ({sscene_dev_ms:.4f} ms with the host ahead),"
            f" bound {ssb['bound_ms']:.6f} ms ({ssb['bound_by']}); edges evaluated"
            f" {evaluated} of {walked} (segs x rows),"
            f" {evaluated / max(walked, 1) * 100:.2f}%"
        ))
        sb = _prepass_bound(splan.bigs, 64)
        _say("prepass", (
            f"serving plan {int(w)}^2 T=64 (classes (rows, width)"
            f" {[tuple(b.shape[:2]) for b in splan.bigs]}): max abs diff {serr:.3g};"
            f" kernel {spre_ms:.4f} ms per call ({spre_dev_ms:.4f} ms with the host"
            f" ahead), bound {sb['bound_ms']:.6f} ms ({sb['bound_by']})"
        ))
        serve_cs, flat_scene, flat_vp = cs, scene, vp
        mpx = w * h / 1e6
        _say("serve", (
            f"{int(w)}x{int(h)} T=64 {cs.plan.tile_id.shape[0]} items, compiled in"
            f" {compile_s:.2f}s; kernels {frame_ms:.3f} ms/frame"
            f" ({mpx / frame_ms * 1e3:.1f} Mpx/s), plain {plain_frame_ms:.3f}"
            f" ms/frame ({mpx / plain_frame_ms * 1e3:.1f} Mpx/s); max abs diff"
            f" {serve_err:.3g}; last frame == first; launches {path_launches['serve']};"
            f" split (each kernel alone, CUDA events): prepass {spre_ms:.4f} ms,"
            f" scene {sscene_ms:.4f} ms"
        ))

        # 7. the isolation-pass document: plan, kernels against plain, CLI
        pdoc = os.path.join(tmp, "passes.svg")
        with open(pdoc, "w", encoding="utf-8") as f:
            f.write(pass_doc(PASS_DRAWS, CLI_SIZE, seed=0))
        vp_p, low_p, seconds_p = _lower(pdoc, None, 32, passes=True)
        prog = upload_program(low_p, dev)
        chunks = [ck for level in prog.levels if level.blur for ck in level.blur.chunks]
        n_filters = sum(len(level.filters) for level in prog.levels)
        _say("plan", (
            f"passes {CLI_SIZE}^2 T=32: {len(prog.levels)} levels, rows"
            f" {[lv.plan.num_tiles for lv in prog.levels]}, pool {prog.pool_rows},"
            f" {len(chunks)} blur chunks of {sum(ck['B'] for ck in chunks)} parts,"
            f" {n_filters} per-part filter chains; lowered in {seconds_p['lower']:.2f}s"
        ))
        if len(prog.levels) < 2 or not chunks or not n_filters:
            raise RuntimeError("the pass document misses a construct")
        plain_tiles = run_program(prog, vp_p[:2], False, plain=True)
        got_tiles = run_program(prog, vp_p[:2], False)
        torch.cuda.synchronize()
        pass_err = float((got_tiles - plain_tiles).abs().max())
        if not bool(torch.isfinite(got_tiles).all()) or not pass_err <= SCENE_TOL:
            raise RuntimeError(f"pass program disagrees with plain: {pass_err}")
        pass_plain_png = _png_pixels(plain_tiles, low_p, vp_p)

        # scene kernel on the main stream with pass items (tex / mask) and
        # the pool the levels leave
        pool = new_pool(prog)
        run_program(prog, vp_p[:2], False, pool=pool)
        mplan = prog.main
        big = fused_exec.prepass_winding(mplan.bigs, mplan.tile)
        got = fused_exec.scene_tiles(mplan, big, pool)
        ref = batch_exec._scene_tiles(mplan, big, pool)
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        if not err <= SCENE_TOL:
            raise RuntimeError(f"scene kernel disagrees on pass items: {err}")
        ms = _time_ms(torch, lambda: fused_exec.scene_tiles(mplan, big, pool), 20)
        dev_ms = _device_ms(torch, lambda: fused_exec.scene_tiles(mplan, big, pool), 20)
        plain_ms = _time_ms(torch, lambda: batch_exec._scene_tiles(mplan, big, pool), 3)
        results["scene_tiles"]["max_abs_err"] = max(results["scene_tiles"]["max_abs_err"], err)
        n_pass_items = int(((mplan.iparams[:, batch_exec.I_TEX] >= 0)
                            | (mplan.iparams[:, batch_exec.I_MASK] >= 0)).sum())
        b = _scene_bound(mplan, big, pool)
        _say("scene", (
            f"passes main stream ({n_pass_items} tex/mask items): max abs diff {err:.3g};"
            f" kernel {ms:.4f} ms per call ({dev_ms:.4f} ms with the host ahead), plain"
            f" {plain_ms:.4f} ms, bound {b['bound_ms']:.4f} ms ({b['bound_by']})"
        ))
        _say("pass_layers", _pass_breakdown(torch, prog, pool, vp_p))

        # 8. blur chunk kernel against plain: the document's level 0 (its
        # chunks in one launch), then random chunks at every tile size, each
        # alone and packed into one level
        level0 = prog.levels[0]
        canvas0 = fused_exec.execute_items_fused(level0.plan, None)
        blur0 = level0.blur
        before = fused_exec.blur_chunk.launches
        got = fused_exec.blur_chunk(canvas0, blur0, 32, False)
        if fused_exec.blur_chunk.launches != before + 1:
            raise RuntimeError("blur_chunk made more than one launch for a level")
        ref = filter_batch.apply_level(canvas0, blur0, 32, False)
        torch.cuda.synchronize()
        doc_err = worst = float((got - ref).abs().max())
        rng = np.random.default_rng(2)
        shapes = {}
        for t in fused_exec.KERNEL_TILES:
            rows_t = _random_canvas(torch, rng, t, 24, dev)
            cks = [_random_chunk(rng, t, 24) for _ in range(4)]
            shapes[t] = [(ck["B"], ck["NSi"], ck["NSj"], ck["NOi"], ck["NOj"]) for ck in cks]
            levels = [filter_batch.pack_level([ck], t, dev) for ck in cks]
            levels.append(filter_batch.pack_level(cks, t, dev))
            for lv in levels:
                for lin in (False, True):
                    before = fused_exec.blur_chunk.launches
                    got = fused_exec.blur_chunk(rows_t, lv, t, lin)
                    if fused_exec.blur_chunk.launches != before + 1:
                        raise RuntimeError("blur_chunk made more than one launch for a level")
                    # per chunk, as the plain path runs it
                    ref = torch.cat([filter_batch.apply_chunk(rows_t, ck, t, lin)
                                     for ck in lv.chunks])
                    torch.cuda.synchronize()
                    worst = max(worst, float((got - ref).abs().max()))
        if not worst <= BLUR_TOL:
            raise RuntimeError(f"blur chunk kernel disagrees: {worst} > {BLUR_TOL}")
        ms = _time_ms(torch, lambda: fused_exec.blur_chunk(canvas0, blur0, 32, False), 20)
        dev_ms = _device_ms(torch, lambda: fused_exec.blur_chunk(canvas0, blur0, 32, False), 20)
        plain_ms = _time_ms(torch, lambda: filter_batch.apply_level(canvas0, blur0, 32, False), 5)
        results["blur_chunk"] = dict(max_abs_err=worst, ms=ms, plain_ms=plain_ms,
                                     **_chunk_bound(blur0.chunks, 32), library_ms=None)
        # each chunk of level 0 as a level of its own: what paces the launch
        alone = []
        for i in blur0.order:
            one = filter_batch.pack_level([low_p.groups[0]["_blur_batch"][0][i]], 32, dev)
            one_ms = _device_ms(torch, lambda: fused_exec.blur_chunk(canvas0, one, 32, False), 20)
            alone.append(f"{one.tiles} tiles {one_ms:.4f}")
        _say("blur_chunk", (
            f"level 0's {len(blur0.chunks)} chunks ({sum(ck['B'] for ck in blur0.chunks)}"
            f" parts, {blur0.tiles} out tiles) in one launch: max abs diff {doc_err:.3g};"
            f" random chunks (B, NSi, NSj, NOi, NOj) {shapes}, each alone and the four"
            f" packed, one launch each: worst {worst:.3g}; level 0: kernel {ms:.4f} ms per"
            f" call ({dev_ms:.4f} ms with the host ahead), plain {plain_ms:.4f} ms, bound"
            f" {results['blur_chunk']['bound_ms']:.6f} ms ({results['blur_chunk']['bound_by']});"
            f" each chunk alone, in packed order, ms with the host ahead: {'; '.join(alone)}"
        ))

        # 9. pool row writer against plain: exact
        results["pool_rows"] = _pool_rows_check(torch, prog, canvas0)
        _say("pool_rows", _pool_rows_line(results["pool_rows"]))

        # 9b. the filter parts' entry and exit kernels against plain, 9c.
        # the chain blur kernel, 9d. the feTurbulence kernel
        _part_io_phase(torch, dev, results)
        _fe_blur_phase(torch, dev, results)
        _fe_turbulence_phase(torch, dev, results, path_launches)

        # 10. CLI, isolation-pass document (a main path)
        fused_exec.reset_launch_counts()
        out_png = os.path.join(tmp, "passes.png")
        t0 = time.monotonic()
        rc = cli.main([pdoc, out_png])
        pcli_s = time.monotonic() - t0
        path_launches["passes"] = _launches()
        if rc != 0:
            raise RuntimeError(f"CLI exited {rc} on the pass document")
        with open(out_png, "rb") as f:
            img = read_png(f.read())
        if img.shape != (CLI_SIZE, CLI_SIZE, 4) or int(img[..., 3].max()) == 0:
            raise RuntimeError(f"pass document CLI image {img.shape} is wrong or blank")
        diff = np.abs(img.astype(np.int16) - pass_plain_png.astype(np.int16))
        if int(diff.max()) > PNG_TOL:
            raise RuntimeError(f"pass CLI PNG differs from the plain render by {diff.max()}/255")
        missed = [k for k in ("scene_tiles", "blur_chunk", "pool_rows", "fe_blur")
                  if path_launches["passes"][k] == 0]
        if missed:
            raise RuntimeError(f"pass CLI did not launch {missed}: {path_launches['passes']}")
        blur_levels = sum(lv.blur is not None for lv in prog.levels)
        if path_launches["passes"]["blur_chunk"] != blur_levels:
            raise RuntimeError(f"pass CLI made {path_launches['passes']['blur_chunk']} blur"
                               f" launches for {blur_levels} levels with chunks")
        _say("passes", (
            f"{CLI_SIZE}x{CLI_SIZE} PNG in {pcli_s:.3f}s; max diff vs plain"
            f" {int(diff.max())}/255, {float((diff == 0).mean()) * 100:.4f}% bytes equal;"
            f" pass program vs plain max abs diff {pass_err:.3g}; launches"
            f" {path_launches['passes']} ({len(chunks)} blur chunks in"
            f" {blur_levels} level launch(es))"
        ))

        # 11. serving the stress document (a main path)
        from svgrasterize_tpu_torch.frontend.svg import scene_from_str
        from svgrasterize_tpu_torch.utils.stress import stress_doc

        scene, _ids, (w, h) = scene_from_str(stress_doc(STRESS_DRAWS, STRESS_SIZE))
        vp = (0, 0, int(h), int(w))
        t0 = time.monotonic()
        cs = compile_scene(scene, Transform().matrix(0, 1, 0, 1, 0, 0), vp,
                           tile=32, device=dev)
        compile_s = time.monotonic() - t0
        if cs is None or not cs.program.levels:
            raise RuntimeError("the stress document must lower with isolation passes")
        fused_exec.reset_launch_counts()
        first = cs.render_tiles()
        torch.cuda.synchronize()
        frame_ms = _time_ms(torch, cs.render_tiles, SERVE_FRAMES)
        last = cs.render_tiles()
        torch.cuda.synchronize()
        path_launches["serve_passes"] = _launches()
        if not torch.equal(first, last):
            raise RuntimeError("stress serving frames differ")
        missed = [k for k in ("scene_tiles", "pool_rows")
                  if path_launches["serve_passes"][k] == 0]
        if missed:
            raise RuntimeError(f"stress serving did not launch {missed}")
        plain_frame_ms = _time_ms(torch, lambda: cs.render_tiles(plain=True), 2)
        plain_last = cs.render_tiles(plain=True)
        stress_err = float((last - plain_last).abs().max())
        if not stress_err <= SCENE_TOL:
            raise RuntimeError(f"stress serving disagrees with plain: {stress_err}")
        stress_cs = cs
        mpx = w * h / 1e6
        _say("serve_passes", (
            f"stress_doc({STRESS_DRAWS}, {STRESS_SIZE}) T=32: {len(cs.program.levels)}"
            f" levels, pool {cs.program.pool_rows} rows, {cs.plan.tile_id.shape[0]} main"
            f" items, compiled in {compile_s:.2f}s; kernels {frame_ms:.3f} ms/frame"
            f" ({mpx / frame_ms * 1e3:.1f} Mpx/s), plain {plain_frame_ms:.3f} ms/frame;"
            f" max abs diff {stress_err:.3g}; last frame == first; launches"
            f" {path_launches['serve_passes']}"
        ))

        # 12. the interpreter document: the batched path cannot express it
        from svgrasterize_tpu_torch import render_plan
        from svgrasterize_tpu_torch.ops import coverage

        idoc = os.path.join(tmp, "interp.svg")
        with open(idoc, "w", encoding="utf-8") as f:
            f.write(interp_doc(INTERP_DRAWS, CLI_SIZE, seed=0))
        t0 = time.monotonic()
        scene, _ids, (w, h) = scene_from_filepath(idoc, None, None, fonts)
        parse_s = time.monotonic() - t0
        vp_i = (0, 0, int(h), int(w))
        swap = Transform().matrix(0, 1, 0, 1, 0, 0)
        if render_plan.lower_scene(scene, swap, vp_i, False, 32, device=dev) is not None:
            raise RuntimeError("the interpreter document must not lower whole")

        # 13. winding kernel against plain: every mask of one interpreter
        # render (its batched entry and its one-list entry), one launch per
        # mask and all in one batched launch; then random edge lists
        with _Recorder(fused_exec, "winding_batch", record=True) as rec_batch, \
                _Recorder(fused_exec, "winding", record=True) as rec_one:
            scene.render(swap, viewport=vp_i, device=dev)
        calls = [(torch.from_numpy(np.asarray(e, np.float32).reshape(-1, 4)).to(dev), hh, ww)
                 for lists, shapes, _dev in rec_batch.calls
                 for e, (hh, ww) in zip(lists, shapes)] + rec_one.calls
        if not calls:
            raise RuntimeError("the interpreter render rasterized no path mask")
        worst, per_mask = 0.0, []
        for lines, hh, ww in calls:
            got = fused_exec.winding(lines, hh, ww)
            ref = coverage.winding(lines, hh, ww)
            torch.cuda.synchronize()
            worst = max(worst, float((got - ref).abs().max()))
            per_mask.append(got)
        if not worst <= WINDING_TOL:
            raise RuntimeError(f"winding kernel disagrees on the render's masks: {worst}")
        host_lists = [lines.cpu().numpy() for lines, _h, _w in calls]
        shapes = [(hh, ww) for _l, hh, ww in calls]
        before = fused_exec.winding.launches
        batched = fused_exec.winding_batch(host_lists, shapes, dev)
        torch.cuda.synchronize()
        if fused_exec.winding.launches != before + 1:
            raise RuntimeError("winding_batch made more than one launch")
        if not all(torch.equal(_bits(a), _bits(b)) for a, b in zip(batched, per_mask, strict=True)):
            raise RuntimeError("batched winding fields differ from the per-mask kernel's")

        def all_masks(fn):
            for lines, hh, ww in calls:
                fn(lines, hh, ww)

        loop_ms = _time_ms(torch, lambda: all_masks(fused_exec.winding), 10)
        loop_dev_ms = _device_ms(torch, lambda: all_masks(fused_exec.winding), 10)
        uploaded = fused_exec.upload_winding_batch(host_lists, shapes, dev)
        ms = _time_ms(torch, lambda: fused_exec.launch_winding_batch(uploaded), 20)
        dev_ms = _device_ms(torch, lambda: fused_exec.launch_winding_batch(uploaded), 20)
        call_ms = _time_ms(torch, lambda: fused_exec.winding_batch(host_lists, shapes, dev), 20)
        plain_ms = _time_ms(torch, lambda: all_masks(coverage.winding), 2)
        fused_exec.reset_launch_counts()
        scene.render(swap, viewport=vp_i, device=dev)
        torch.cuda.synchronize()
        render_launches = fused_exec.winding.launches
        sizes = sorted(hh * ww for _l, hh, ww in calls)
        edges = sorted(lines.shape[0] for lines, _h, _w in calls)
        results["winding"] = dict(max_abs_err=worst, ms=ms, plain_ms=plain_ms,
                                  **_winding_bound(calls), library_ms=None)
        dense = _winding_bound(calls, _winding_ops)
        _say("winding", (
            f"{len(calls)} masks of one interpreter render (pixels median"
            f" {sizes[len(sizes) // 2]}, max {sizes[-1]}; edges median"
            f" {edges[len(edges) // 2]}, max {edges[-1]}): max abs diff {worst:.3g};"
            f" batched fields == per-mask fields bit for bit; one batched launch {ms:.4f} ms"
            f" ({dev_ms:.4f} ms with the host ahead; with packing and upload"
            f" {call_ms:.4f} ms), one launch per mask {loop_ms:.4f} ms ({loop_dev_ms:.4f}"
            f" ms with the host ahead), plain {plain_ms:.4f} ms, bound"
            f" {results['winding']['bound_ms']:.6f} ms ({results['winding']['bound_by']};"
            f" dense closed form {dense['bound_ms']:.6f} ms, {dense['bound_by']});"
            f" the render made {len(rec_batch.calls)} winding_batch and"
            f" {len(rec_one.calls)} winding calls, {render_launches} launches"
        ))
        rng = np.random.default_rng(4)
        for segs, hh, ww in ((16, 200, 300), (256, 513, 777), (2048, 1024, 1024)):
            e = rng.uniform(-8, max(hh, ww) + 8, (segs, 4)).astype(np.float32)
            e[::9, 2] = e[::9, 0]  # horizontal edges
            e[::13] = 0.0  # padding rows
            lines = torch.from_numpy(e).to(dev)
            got = fused_exec.winding(lines, hh, ww)
            ref = coverage.winding(lines, hh, ww)
            torch.cuda.synchronize()
            err = float((got - ref).abs().max())
            if not bool(torch.isfinite(got).all()) or not err <= WINDING_TOL:
                raise RuntimeError(f"winding kernel disagrees at S={segs}: {err}")
            results["winding"]["max_abs_err"] = max(results["winding"]["max_abs_err"], err)
            if not torch.equal(_bits(fused_exec.winding(lines, hh, ww)), _bits(got)):
                raise RuntimeError(f"two winding calls at S={segs} differ")
            k_ms = _time_ms(torch, lambda: fused_exec.winding(lines, hh, ww), 10)
            k_dev_ms = _device_ms(torch, lambda: fused_exec.winding(lines, hh, ww), 10)
            p_ms = _time_ms(torch, lambda: coverage.winding(lines, hh, ww), 2)
            b = _winding_bound([(lines, hh, ww)])
            dense = _winding_bound([(lines, hh, ww)], _winding_ops)
            _say("winding", (
                f"random S={segs} {hh}x{ww}: max abs diff {err:.3g}, repeat bit-equal; kernel"
                f" {k_ms:.4f} ms ({k_dev_ms:.4f} ms with the host ahead), plain {p_ms:.4f} ms,"
                f" bound {b['bound_ms']:.4f} ms ({b['bound_by']}; dense closed form"
                f" {dense['bound_ms']:.4f} ms, {dense['bound_by']})"
            ))

        # the adversarial lists of tests/test_torch_winding.py at
        # WINDING_CASES^2, one mask WINDING_WIDE wide: each against plain,
        # repeated calls bit-equal, all of them in one batch equal to the
        # one-list fields; then back-to-back batches of other masks through
        # the two pinned staging buffers, which must not grow again
        cases = winding_cases(WINDING_CASES, WINDING_CASES, WINDING_WIDE)
        case_calls, case_fields, case_worst = [], [], 0.0
        for name, (e, hh, ww) in cases.items():
            lines = torch.from_numpy(e).to(dev)
            got = fused_exec.winding(lines, hh, ww)
            again = fused_exec.winding(lines, hh, ww)
            ref = coverage.winding(lines, hh, ww)
            torch.cuda.synchronize()
            err = float((got - ref).abs().max()) if got.numel() else 0.0
            if not bool(torch.isfinite(got).all()) or not err <= WINDING_TOL:
                raise RuntimeError(f"winding kernel disagrees on {name}: {err}")
            if not torch.equal(_bits(got), _bits(again)):
                raise RuntimeError(f"two winding calls on {name} differ")
            case_worst = max(case_worst, err)
            case_calls.append((lines, hh, ww))
            case_fields.append(got)
        results["winding"]["max_abs_err"] = max(results["winding"]["max_abs_err"], case_worst)
        case_lists = [cases[n][0] for n in cases]
        case_shapes = [cases[n][1:] for n in cases]
        staging = []
        for _ in range(2):  # back to back, no synchronize between the batches
            first = fused_exec.winding_batch(case_lists, case_shapes, dev)
            second = fused_exec.winding_batch(host_lists, shapes, dev)
            staging.append([h.data_ptr() for h in fused_exec._staging[dev].hosts])
            torch.cuda.synchronize()
            for fields, ref in ((first, case_fields), (second, per_mask)):
                if not all(torch.equal(_bits(a), _bits(b)) for a, b in zip(fields, ref, strict=True)):
                    raise RuntimeError("back-to-back winding batches differ from the one-list fields")
        if staging[0] != staging[1]:
            raise RuntimeError("upload_winding_batch allocated new staging buffers")
        c_ms = _time_ms(torch, lambda: [fused_exec.winding(*c) for c in case_calls], 5)
        b = _winding_bound(case_calls)
        dense = _winding_bound(case_calls, _winding_ops)
        _say("winding", (
            f"{len(cases)} adversarial lists ({', '.join(cases)}) at {WINDING_CASES}^2, one"
            f" {WINDING_WIDE} wide: max abs diff {case_worst:.3g}; repeated calls bit-equal;"
            f" one batch == one-list fields bit for bit; two back-to-back batch pairs correct,"
            f" staging buffers reused; all lists {c_ms:.4f} ms, bound {b['bound_ms']:.4f} ms"
            f" ({b['bound_by']}; dense closed form {dense['bound_ms']:.4f} ms, {dense['bound_by']})"
        ))

        # 14. pattern paints and images, which lower whole: the scene kernel
        # with pattern items against plain, the CLI and serving (main paths)
        tdoc = os.path.join(tmp, "patterns.svg")
        with open(tdoc, "w", encoding="utf-8") as f:
            f.write(pattern_doc(INTERP_DRAWS, CLI_SIZE, seed=0))
        vp_t, low_t, seconds_t = _lower(tdoc, None, 32)
        tplan = plan_from_lowered(low_t, dev)
        n_pat = int((tplan.iparams[:, batch_exec.I_KIND] == batch_exec.PAINT_PATTERN).sum())
        if tplan.patterns is None or not n_pat:
            raise RuntimeError("the pattern document lowered no pattern item")
        big = fused_exec.prepass_winding(tplan.bigs, tplan.tile)
        got = fused_exec.scene_tiles(tplan, big)
        ref = batch_exec._scene_tiles(tplan, big)
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        if not bool(torch.isfinite(got).all()) or not err <= SCENE_TOL:
            raise RuntimeError(f"scene kernel disagrees on pattern items: {err}")
        results["scene_tiles"]["max_abs_err"] = max(results["scene_tiles"]["max_abs_err"], err)
        ms = _time_ms(torch, lambda: fused_exec.scene_tiles(tplan, big), 20)
        dev_ms = _device_ms(torch, lambda: fused_exec.scene_tiles(tplan, big), 20)
        plain_ms = _time_ms(torch, lambda: batch_exec._scene_tiles(tplan, big), 3)
        b = _scene_bound(tplan, big)
        _say("scene", (
            f"patterns {CLI_SIZE}^2 ({n_pat} pattern items, atlas"
            f" {tuple(tplan.patterns.shape)}, lowered in {seconds_t['lower']:.2f}s): max abs"
            f" diff {err:.3g}; kernel {ms:.4f} ms per call ({dev_ms:.4f} ms with the host"
            f" ahead), plain {plain_ms:.4f} ms, bound {b['bound_ms']:.4f} ms ({b['bound_by']})"
        ))
        pat_plain_png = _png_pixels(batch_exec.execute_items(tplan), low_t, vp_t)
        fused_exec.reset_launch_counts()
        out_png = os.path.join(tmp, "patterns.png")
        t0 = time.monotonic()
        rc = cli.main([tdoc, out_png])
        tcli_s = time.monotonic() - t0
        path_launches["patterns"] = _launches()
        if rc != 0:
            raise RuntimeError(f"CLI exited {rc} on the pattern document")
        with open(out_png, "rb") as f:
            img = read_png(f.read())
        if img.shape != (CLI_SIZE, CLI_SIZE, 4) or int(img[..., 3].max()) == 0:
            raise RuntimeError(f"pattern document CLI image {img.shape} is wrong or blank")
        diff = np.abs(img.astype(np.int16) - pat_plain_png.astype(np.int16))
        if int(diff.max()) > PNG_TOL:
            raise RuntimeError(f"pattern CLI PNG differs from the plain render by {diff.max()}/255")
        missed = [k for k in ("scene_tiles", "winding") if path_launches["patterns"][k] == 0]
        if missed:
            raise RuntimeError(f"pattern CLI did not launch {missed}: {path_launches['patterns']}")
        scene_t, _ids, _size = scene_from_filepath(tdoc, None, None, fonts)
        cs = compile_scene(scene_t, swap, vp_t, tile=32, device=dev)
        fused_exec.reset_launch_counts()
        first = cs.render_tiles()
        frame_ms = _time_ms(torch, cs.render_tiles, SERVE_FRAMES)
        last = cs.render_tiles()
        torch.cuda.synchronize()
        path_launches["serve_patterns"] = _launches()
        if not torch.equal(first, last) or path_launches["serve_patterns"]["scene_tiles"] == 0:
            raise RuntimeError("pattern serving frames differ or missed the scene kernel")
        pattern_cs = cs
        plain_frame_ms = _time_ms(torch, lambda: cs.render_tiles(plain=True), 2)
        serve_err = float((last - cs.render_tiles(plain=True)).abs().max())
        if not serve_err <= SCENE_TOL:
            raise RuntimeError(f"pattern serving disagrees with plain: {serve_err}")
        _say("patterns", (
            f"{CLI_SIZE}x{CLI_SIZE} CLI PNG in {tcli_s:.3f}s; max diff vs plain"
            f" {int(diff.max())}/255; launches {path_launches['patterns']}; serving"
            f" {frame_ms:.3f} ms/frame, plain {plain_frame_ms:.3f} ms/frame, max abs diff"
            f" {serve_err:.3g}; launches {path_launches['serve_patterns']}"
        ))

        # 15. the interpreter document through the CLI (a main path), held
        # against the same CLI on the CPU (the plain versions throughout)
        fused_exec.reset_launch_counts()
        out_png = os.path.join(tmp, "interp.png")
        t0 = time.monotonic()
        rc = cli.main([idoc, out_png])
        icli_s = time.monotonic() - t0
        path_launches["interp"] = _launches()
        cpu_png = os.path.join(tmp, "interp_cpu.png")
        t0 = time.monotonic()
        rc_cpu = cli.main([idoc, cpu_png, "--device", "cpu"])
        cpu_s = time.monotonic() - t0
        if rc != 0 or rc_cpu != 0:
            raise RuntimeError(f"CLI exited {rc} (cuda), {rc_cpu} (cpu) on the interpreter document")
        with open(out_png, "rb") as f:
            img = read_png(f.read())
        with open(cpu_png, "rb") as f:
            ref_img = read_png(f.read())
        if img.shape != (CLI_SIZE, CLI_SIZE, 4) or int(img[..., 3].max()) == 0:
            raise RuntimeError(f"interpreter CLI image {img.shape} is wrong or blank")
        diff = np.abs(img.astype(np.int16) - ref_img.astype(np.int16))
        if int(diff.max()) > PNG_TOL:
            raise RuntimeError(f"interpreter CLI PNG differs from the CPU render by {diff.max()}/255")
        missed = [k for k in ("scene_tiles", "winding") if path_launches["interp"][k] == 0]
        if missed:
            raise RuntimeError(f"interpreter CLI did not launch {missed}: {path_launches['interp']}")
        # where one render's time goes: the batched group runs (their
        # lowering, pattern tiles and kernels) and the interpreter's own paths
        with _Recorder(render_plan, "render_fast") as runs:
            t0 = time.monotonic()
            layer, _hull = scene.render(swap, viewport=vp_i, device=dev)
            torch.cuda.synchronize()
            render_s = time.monotonic() - t0
        t0 = time.monotonic()
        layer.convert(pre_alpha=True, linear_rgb=False).write_png(io.BytesIO())
        png_s = time.monotonic() - t0
        _say("interp", (
            f"{CLI_SIZE}x{CLI_SIZE} CLI PNG in {icli_s:.3f}s (cuda), {cpu_s:.3f}s (cpu);"
            f" max diff {int(diff.max())}/255, {float((diff == 0).mean()) * 100:.4f}% bytes"
            f" equal; launches {path_launches['interp']}; one render: parse"
            f" {parse_s:.4f}s, group runs (render_fast) {runs.seconds:.4f}s, interpreter"
            f" paths {render_s - runs.seconds:.4f}s, PNG {png_s:.4f}s"
        ))

        # 16. --id: a pattern-filled group alone, no viewport (pure interpreter)
        fused_exec.reset_launch_counts()
        out_png = os.path.join(tmp, "id.png")
        t0 = time.monotonic()
        rc = cli.main([idoc, out_png, "-id", PATTERN_GROUP])
        id_s = time.monotonic() - t0
        path_launches["interp_id"] = _launches()
        rc_cpu = cli.main([idoc, cpu_png, "-id", PATTERN_GROUP, "--device", "cpu"])
        if rc != 0 or rc_cpu != 0:
            raise RuntimeError(f"--id CLI exited {rc} (cuda), {rc_cpu} (cpu)")
        with open(out_png, "rb") as f:
            img = read_png(f.read())
        with open(cpu_png, "rb") as f:
            ref_img = read_png(f.read())
        if img.shape != ref_img.shape or int(img[..., 3].max()) == 0:
            raise RuntimeError(f"--id image {img.shape} is blank or not {ref_img.shape}")
        diff = np.abs(img.astype(np.int16) - ref_img.astype(np.int16))
        if int(diff.max()) > PNG_TOL or path_launches["interp_id"]["winding"] == 0:
            raise RuntimeError(f"--id render differs by {diff.max()}/255 or launched no"
                               f" winding: {path_launches['interp_id']}")
        _say("interp_id", (
            f"-id {PATTERN_GROUP}: {img.shape[1]}x{img.shape[0]} PNG in {id_s:.3f}s; max diff"
            f" vs cpu {int(diff.max())}/255; launches {path_launches['interp_id']}"
        ))

        # 17. serving by CUDA-graph replay (main paths): the four serving
        # documents, replay bit for bit against render_tiles
        from svgrasterize_tpu_torch.render_plan import CompiledScene

        pass_cs = CompiledScene(low_p, vp_p, False, device=dev)
        serving = (("flat", serve_cs, flat_vp, 64), ("pass", pass_cs, vp_p, 32),
                   ("stress", stress_cs, (0, 0, STRESS_SIZE, STRESS_SIZE), 32),
                   ("pattern", pattern_cs, vp_t, 32))
        captured = set()
        for label, cs_, vp_, t in serving:
            r = _serve_many(torch, cs_, f"serve_many_{label}", path_launches, 5)
            captured |= {k for k, v in r["launches"].items() if v}
            mpx = vp_[2] * vp_[3] / 1e6
            _say("serve_many", (
                f"{label} {vp_[3]}x{vp_[2]} T={t}: replay {r['replay_ms']:.4f} ms/frame"
                f" ({mpx / r['replay_ms'] * 1e3:.1f} Mpx/s), eager {r['eager_ms']:.4f}"
                f" ms/frame ({r['eager_ms'] / r['replay_ms']:.2f}x); replay == render_tiles"
                f" bit for bit; captured frame launches {r['launches']}"
            ))
        missed = {"prepass_winding", "scene_tiles", "blur_chunk", "pool_rows", "part_entry",
                  "part_exit"} - captured
        if missed:
            raise RuntimeError(f"no captured frame launched {sorted(missed)}")
        # one entry and one exit a filter part; none in a pass-free frame
        for cs_ in (serve_cs, pass_cs):
            n_parts = sum(len(lv.filters) for lv in cs_.program.levels)
            if (cs_.frame_launches["part_entry"], cs_.frame_launches["part_exit"]) != (
                    n_parts, n_parts):
                raise RuntimeError(f"a frame of {n_parts} filter parts launched"
                                   f" {cs_.frame_launches}")

        # 18. replay ms/frame by tile size (measured only); the pass
        # document's T=128 scene is kept for 18b
        scene_p, _ids, _size = scene_from_filepath(pdoc, None, None, fonts)
        for label, scene_, vp_, done in (("flat", flat_scene, flat_vp, {64: serve_cs}),
                                         ("pass", scene_p, vp_p, {32: pass_cs})):
            row = []
            for t in fused_exec.KERNEL_TILES:
                t0 = time.monotonic()
                cs_ = done.get(t) or compile_scene(scene_, swap, vp_, tile=t, device=dev)
                compile_s = time.monotonic() - t0
                r = _serve_many(torch, cs_, f"serve_tiles_{label}_{t}", path_launches, 2)
                row.append(f"T={t} {r['replay_ms']:.4f} (eager {r['eager_ms']:.4f},"
                           f" compiled in {compile_s:.2f}s)")
                if label == "pass" and t == 128:
                    pass128_cs = cs_
                del cs_
            torch.cuda.empty_cache()
            _say("serve_tiles", f"{label} {vp_[3]}x{vp_[2]} replay ms/frame: {'; '.join(row)}")

        # 18b. the pass document at T=128 on a real level: the frame against
        # the same document compiled on the CPU (the plain versions), then
        # level 0's blur launch and the pool rows at T=128 against plain
        pass128 = path_launches["serve_tiles_pass_128"]
        if min(pass128["scene_tiles"], pass128["blur_chunk"], pass128["pool_rows"]) == 0:
            raise RuntimeError(f"the T=128 pass frame missed a kernel: {pass128}")
        t0 = time.monotonic()
        cpu128 = compile_scene(scene_p, swap, vp_p, tile=128, device="cpu")
        cpu_tiles = cpu128.render_tiles()
        cpu_s = time.monotonic() - t0
        got = pass128_cs.render_tiles()
        torch.cuda.synchronize()
        err = float((got.cpu() - cpu_tiles).abs().max())
        if got.shape != cpu_tiles.shape or not bool(torch.isfinite(got).all()) \
                or not err <= CPU_TOL:
            raise RuntimeError(f"the T=128 pass frame differs from the CPU's: {err}")
        prog128 = pass128_cs.program
        level128 = prog128.levels[0]
        canvas128 = fused_exec.execute_items_fused(level128.plan, None)
        blur128 = level128.blur
        bgot = fused_exec.blur_chunk(canvas128, blur128, 128, False)
        bref = filter_batch.apply_level(canvas128, blur128, 128, False)
        torch.cuda.synchronize()
        berr = float((bgot - bref).abs().max())
        if not berr <= BLUR_TOL:
            raise RuntimeError(f"blur chunk kernel disagrees at T=128: {berr}")
        results["blur_chunk"]["max_abs_err"] = max(results["blur_chunk"]["max_abs_err"], berr)

        def blur128_call():
            return fused_exec.blur_chunk(canvas128, blur128, 128, False)

        b_ms, b_dev_ms = _time_ms(torch, blur128_call, 20), _device_ms(torch, blur128_call, 20)
        b_plain_ms = _time_ms(
            torch, lambda: filter_batch.apply_level(canvas128, blur128, 128, False), 5)
        bb = _chunk_bound(blur128.chunks, 128)
        _say("pass_128", (
            f"passes {CLI_SIZE}^2 T=128: {len(prog128.levels)} levels, pool"
            f" {prog128.pool_rows} rows, launches {pass128}; frame vs device=cpu max abs diff"
            f" {err:.3g} (cpu compile + render {cpu_s:.2f}s); level 0's"
            f" {len(blur128.chunks)} chunks ({blur128.tiles} out tiles) in one launch: max abs"
            f" diff {berr:.3g}; kernel {b_ms:.4f} ms per call ({b_dev_ms:.4f} ms with the host"
            f" ahead), plain {b_plain_ms:.4f} ms, bound {bb['bound_ms']:.6f} ms"
            f" ({bb['bound_by']})"
        ))
        _say("pool_rows", _pool_rows_line(_pool_rows_check(torch, prog128, canvas128)))
        del pass128_cs, cpu128, cpu_tiles, got, canvas128, bgot, bref
        torch.cuda.empty_cache()

        # 18c. the JAX package's 8K serving configuration (a main path)
        _serve_8k_phase(torch, doc, fonts, dev, path_launches)

        # 19. a single-process mesh of SHARDS shards on the card (main paths)
        from svgrasterize_tpu_torch.parallel.mesh import make_mesh

        mesh = make_mesh([dev] * SHARDS)
        for label, scene_, vp_, t, ref_cs in (("flat", flat_scene, flat_vp, 64, serve_cs),
                                              ("pass", scene_p, vp_p, 32, pass_cs)):
            t0 = time.monotonic()
            sh = compile_scene(scene_, swap, vp_, False, mesh, tile=t, device=dev)
            compile_s = time.monotonic() - t0
            fused_exec.reset_launch_counts()
            tiles = sh.render_tiles()
            torch.cuda.synchronize()
            path_launches[f"sharded_{label}"] = counts = _launches()
            expected = _sharded_launches(sh)
            if counts["scene_tiles"] != expected:
                raise RuntimeError(f"sharded {label}: {counts['scene_tiles']} scene launches,"
                                   f" {expected} shard plans")
            err = float((tiles - ref_cs.render_tiles()).abs().max())
            if not bool(torch.isfinite(tiles).all()) or not err <= BLUR_TOL:
                raise RuntimeError(f"sharded {label} frame differs from one device's: {err}")
            frame_ms = _time_ms(torch, sh.render_tiles, 3)
            n_plans = len(sh.program.levels) + 1
            _say("sharded", (
                f"{label} {vp_[3]}x{vp_[2]} T={t} over {SHARDS} shards: max abs diff vs one"
                f" device {err:.3g}; main stream skew {sh.plan.balance['skew']:.4f} (items"
                f" {sh.plan.balance['counts'].tolist()}); {counts['scene_tiles']} scene launches"
                f" for {n_plans} plan(s) ({counts['scene_tiles'] / n_plans:.2f} per plan);"
                f" {frame_ms:.4f} ms/frame; compiled in {compile_s:.2f}s; launches {counts}"
            ))
            del sh, tiles
        torch.cuda.empty_cache()

        # 20. the fill batch through the winding kernel (a main path)
        from svgrasterize_tpu_torch.parallel import batch as pbatch
        from svgrasterize_tpu_torch.utils.stress import edge_batch

        lines, colors = edge_batch(FILL_PATHS, FILL_SEGS, float(FILL_SIZE), seed=0)
        lines_d, colors_d = torch.from_numpy(lines).to(dev), torch.from_numpy(colors).to(dev)
        fused_exec.reset_launch_counts()
        got = pbatch.fill_batch(lines_d, colors_d, FILL_SIZE, FILL_SIZE, device=dev)
        torch.cuda.synchronize()
        path_launches["fill_batch"] = _launches()
        if path_launches["fill_batch"]["winding"] != 1:
            raise RuntimeError(f"fill_batch launches {path_launches['fill_batch']}")

        def plain_fill():
            wind = torch.stack([coverage.winding(e, FILL_SIZE, FILL_SIZE) for e in lines_d])
            return pbatch._fill(wind, colors_d, None)

        ref = plain_fill()
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        if not bool(torch.isfinite(got).all()) or not err <= WINDING_TOL:
            raise RuntimeError(f"fill_batch disagrees with plain: {err}")
        # a repeated call: the same bits, and the batch table from the cache
        # (no host-to-device copy)
        hits = fused_exec._uniform_batch.cache_info().hits
        again = pbatch.fill_batch(lines_d, colors_d, FILL_SIZE, FILL_SIZE, device=dev)
        torch.cuda.synchronize()
        if not torch.equal(_bits(again), _bits(got)):
            raise RuntimeError("two fill_batch calls differ")
        if fused_exec._uniform_batch.cache_info().hits != hits + 1:
            raise RuntimeError("winding_uniform built its batch table again")
        ms = _time_ms(torch, lambda: pbatch.fill_batch(lines_d, colors_d, FILL_SIZE, FILL_SIZE,
                                                       device=dev), 20)
        k_ms = _time_ms(torch, lambda: fused_exec.winding_uniform(lines_d, FILL_SIZE, FILL_SIZE), 20)
        k_dev_ms = _device_ms(torch, lambda: fused_exec.winding_uniform(lines_d, FILL_SIZE,
                                                                        FILL_SIZE), 20)
        plain_ms = _time_ms(torch, plain_fill, 2)
        mpx = FILL_PATHS * FILL_SIZE * FILL_SIZE / 1e6
        fill_calls = [(e, FILL_SIZE, FILL_SIZE) for e in lines_d]
        b = _winding_bound(fill_calls)
        dense = _winding_bound(fill_calls, _winding_ops)
        _say("fill_batch", (
            f"{FILL_PATHS} paths x {FILL_SEGS} edges at {FILL_SIZE}^2: max abs diff vs plain"
            f" {err:.3g}, repeat bit-equal, table cached; {ms:.4f} ms ({mpx / ms * 1e3:.1f}"
            f" Mpx/s), plain {plain_ms:.4f} ms; winding kernel (winding_uniform) {k_ms:.4f} ms"
            f" ({k_dev_ms:.4f} ms with the host ahead), bound {b['bound_ms']:.4f} ms"
            f" ({b['bound_by']}; dense closed form {dense['bound_ms']:.4f} ms,"
            f" {dense['bound_by']}); launches {path_launches['fill_batch']}"
        ))

        # 21. sprite atlases: 13 documents x 4 (dedup) and 52 distinct ones
        from svgrasterize_tpu_torch.parallel.atlas import atlas_scene, compile_atlas, render_atlas

        def icon_docs(indices):
            out = []
            for i in indices:
                sc, _ids, size = scene_from_str(icon_doc(i))
                out.append((sc, (float(size[0]), float(size[1]))))
            return out

        repeated = icon_docs(range(ATLAS_DOCS)) * ATLAS_COPIES
        distinct = icon_docs(range(ATLAS_DOCS * ATLAS_COPIES))
        for label, docs, n_unique in (("dedup", repeated, ATLAS_DOCS),
                                      ("distinct", distinct, len(distinct))):
            t0 = time.monotonic()
            srv = compile_atlas(docs, cell=ATLAS_CELL, device=dev)
            compile_s = time.monotonic() - t0
            if srv is None or srv.n_unique != n_unique or srv.n_docs != len(docs):
                raise RuntimeError(f"atlas {label}: {None if srv is None else srv.n_unique}"
                                   f" unique of {len(docs)}")
            combined, (aw, ah) = atlas_scene(docs, ATLAS_CELL)
            plain = compile_scene(combined, swap, (0, 0, ah, aw), tile=32, device=dev)
            err = float((srv.render_tiles() - plain.render_tiles()).abs().max())
            if not err <= ATLAS_TOL:
                raise RuntimeError(f"atlas {label} differs from the combined plan: {err}")
            fused_exec.reset_launch_counts()
            many = srv.render_tiles_many(SERVE_MANY)
            torch.cuda.synchronize()
            path_launches[f"atlas_{label}"] = _launches()
            if not torch.equal(_bits(many), _bits(srv.render_tiles())):
                raise RuntimeError(f"atlas {label}: replay differs from render_tiles()")
            replay_ms = _time_ms(torch, lambda: srv.render_tiles_many(SERVE_MANY), 1) / SERVE_MANY
            eager_ms = _time_ms(torch, srv.render_tiles, 5)
            mpx = aw * ah / 1e6
            _say("atlas", (
                f"{label}: {len(docs)} documents ({srv.n_unique} rendered) in cells of"
                f" {ATLAS_CELL}, {aw}x{ah}; max abs diff vs the combined plan {err:.3g};"
                f" replay {replay_ms:.4f} ms/frame ({mpx / replay_ms * 1e3:.1f} Mpx/s), eager"
                f" {eager_ms:.4f} ms/frame ({mpx / eager_ms * 1e3:.1f} Mpx/s); compiled in"
                f" {compile_s:.2f}s; launches {path_launches[f'atlas_{label}']}"
            ))
            del srv, plain, many
        torch.cuda.empty_cache()
        single = render_atlas(repeated, cell=ATLAS_CELL, device=dev)
        fused_exec.reset_launch_counts()
        sharded = render_atlas(repeated, cell=ATLAS_CELL, mesh=mesh, device=dev)
        torch.cuda.synchronize()
        path_launches["atlas_sharded"] = _launches()
        err = float((sharded.image - single.image).abs().max())
        if not err <= ATLAS_TOL:
            raise RuntimeError(f"sharded render_atlas differs from one device's: {err}")
        _say("atlas", f"render_atlas over {SHARDS} shards vs one device: max abs diff {err:.3g};"
                      f" launches {path_launches['atlas_sharded']}")

        # 22. the tools (main paths), and 23. profiler traces of the pass
        # frame and of the fill batch
        _tools_phase(torch, dev, tmp, path_launches)
        _profile_phase(torch, pass_cs, lines_d, colors_d, path_launches)

        # 24. the multi-process dry run: one NCCL rank in its own process
        from svgrasterize_tpu_torch.parallel.distributed import spawn_local

        t0 = time.monotonic()
        line = spawn_local(1, 1, timeout=300, full=True, device="cuda")
        _say("distributed", f"{line} ({time.monotonic() - t0:.2f}s)")

    launches = {
        k: sum(counts[k] for counts in path_launches.values())
        for k in ("prepass_winding", "scene_tiles", "blur_chunk", "pool_rows", "winding",
                  "part_entry", "part_exit", "untile", "fe_blur", "fe_turbulence")
    }
    sources = {
        "prepass_winding": ("prepass.cu", "svgrasterize_tpu/ops/fused_exec.py:443"),
        "scene_tiles": ("scene.cu", "svgrasterize_tpu/ops/fused_exec.py:853"),
        "blur_chunk": ("blur_chunk.cu", "svgrasterize_tpu/ops/filter_batch.py:396"),
        "pool_rows": ("pool_rows.cu", "svgrasterize_tpu/render_plan.py:2092"),
        "winding": ("winding.cu", "svgrasterize_tpu/ops/pallas_coverage.py:36"),
        "part_entry": ("part_io.cu", None),
        "part_exit": ("part_io.cu", None),
        "untile": ("untile.cu", None),
        "fe_blur": ("fe_blur.cu", None),
        "fe_turbulence": ("fe_turbulence.cu", None),
    }
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    kernels = [
        dict(name=name, route="cuda", source=f"svgrasterize_tpu_torch/csrc/{src}",
             replaces=replaces, launches=launches[name], **{k: results[name][k] for k in keys})
        for name, (src, replaces) in sources.items()
    ]
    if min(k["launches"] for k in kernels) == 0:
        raise RuntimeError(f"a kernel was never launched on a main path: {launches}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
