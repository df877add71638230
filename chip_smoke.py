#!/usr/bin/env python3
"""On-card smoke run of the PyTorch / CUDA port (svgrasterize_tpu_torch).

Run from the repository root on a machine with one CUDA card (Hopper,
sm_90a):

    python3 chip_smoke.py

It builds the five hand-written CUDA kernels from svgrasterize_tpu_torch/csrc
with nvcc (one process per source, in parallel) and prints each compiled
kernel's registers and spills, holds each against its plain PyTorch version
on the card (the prepass on random multi-class calls, one launch each; the
scene kernel on random plans reaching every item kind at T = 16, 32 and 64;
the blur-chunk kernel on a document level's chunks and on random chunks,
each alone and packed into one level, one launch each; the winding kernel
on one interpreter render's masks, one launch per mask and all of them in
one batched launch, which must agree bit for bit), then drives the port's
main paths: the
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
ms/frame of the flat and pass documents at T = 16, 32 and 64, both
documents over a mesh of four shards on the card (within 1e-5 of one
device), a fill batch through the winding kernel, sprite atlases of 13
documents x 4 (rendered once each) and of 52 distinct ones (within 1e-5 of
the combined plan) and a sharded one, and the multi-process dry run as one
NCCL rank in a process of its own.  Launch counts are set to 0 just before
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
SHARDS = 4  # shards of the single-process mesh, all on the one card
FILL_PATHS, FILL_SEGS, FILL_SIZE = 64, 64, 256  # the fill batch: paths x edges at size^2
ATLAS_DOCS, ATLAS_COPIES, ATLAS_CELL = 13, 4, 192  # 52 cells of 192, 7 x 8
ATLAS_TOL = 1e-5  # the same items at other placements: gradients' float rounding

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


def _winding_bound(calls) -> dict:
    """Bound of whole-image winding launches: the live edges of each list
    read once and each field written once, against _winding_ops."""
    nbytes = sum(_live_edges(lines) * 16 + h * w * 4 for lines, h, w in calls)
    ops = sum(_winding_ops(lines, h, w) for lines, h, w in calls)
    return _bound(nbytes, ops)


def _ptxas_report(log: str) -> list:
    """(kernel<T>, registers, spill bytes, static shared bytes) of each
    entry that nvcc -Xptxas -v compiled, from its log."""
    import re

    report, name, spilled = [], None, 0
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            k = re.search(r"([a-z_]+_kernel)ILi(\d+)E", m.group(1))
            name = f"{k.group(1)}<{k.group(2)}>" if k else m.group(1)
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
    rows_per_warp = 64 // t  # csrc/scene.cu Layout: 32 lanes over T / 2 columns
    live = (plan.tile_id < plan.num_tiles) & (plan.iparams[:, 3] < 0)  # I_BIG
    lines = plan.lines[live]
    a0, b0 = lines[..., 0], lines[..., 2]
    y_lo, y_hi, sign = a0.minimum(b0), a0.maximum(b0), a0 != b0
    evaluated = 0
    for r0 in range(0, t, rows_per_warp):
        kept = (sign & (y_hi > r0) & (y_lo < r0 + rows_per_warp)).sum(1)
        evaluated += int(((kept + 7) // 8 * 8).sum()) * rows_per_warp
    return evaluated, lines.shape[0] * lines.shape[1] * t


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
    chains (PyTorch ops), the blur levels (one launch each), the level pool
    writes and the main stream.  CUDA events around the calls, so a stage whose host
    dispatch is slower than the card is timed by its dispatch.  pool holds
    every level's rows (a run_program with it came first)."""
    from svgrasterize_tpu_torch.ops import fused_exec
    from svgrasterize_tpu_torch.render_plan import _apply_part_filter, run_program

    t, origin = prog.tile, viewport[:2]
    levels = prog.levels

    def scenes():
        return [fused_exec.execute_items_fused(lv.plan, pool if lv.needs_pool else None)
                for lv in levels]

    canvases = scenes()

    def filters():
        for lv, canvas in zip(levels, canvases):
            for part in lv.filters:
                _apply_part_filter(canvas, part, origin, False, t)

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

    results = {}
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
        for t in (16, 32, 64):
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
        for t in (16, 32, 64):
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
        # chunks in one launch), then random chunks at T=16, 32 and 64, each
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
        for t in (16, 32, 64):
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
        src_all = torch.cat([canvas0, canvas0.flip(0)])
        n_rows = src_all.shape[0]
        g = torch.Generator().manual_seed(3)
        src_idx = torch.randperm(n_rows, generator=g)[: prog.pool_rows].to(torch.int32)
        dst_idx = torch.randperm(prog.pool_rows, generator=g)[: src_idx.shape[0]].to(torch.int32)
        src_idx, dst_idx = src_idx[: dst_idx.shape[0]].to(dev), dst_idx.to(dev)
        pool_k, pool_p = new_pool(prog), new_pool(prog)
        fused_exec.pool_rows(pool_k, src_all, src_idx, dst_idx)
        batch_exec._pool_rows(pool_p, src_all, src_idx, dst_idx)
        torch.cuda.synchronize()
        if not torch.equal(pool_k, pool_p):
            raise RuntimeError("pool row kernel differs from plain")
        ms = _time_ms(torch, lambda: fused_exec.pool_rows(pool_k, src_all, src_idx, dst_idx), 50)
        plain_ms = _time_ms(torch, lambda: batch_exec._pool_rows(pool_p, src_all, src_idx, dst_idx), 50)
        # the one PyTorch call that computes the same function (a yardstick)
        pool_l, src_l, dst_l = new_pool(prog), src_idx.long(), dst_idx.long()

        def library():
            pool_l[dst_l] = src_all[src_l]

        library_ms = _time_ms(torch, library, 50)
        n_written = dst_idx.shape[0]
        results["pool_rows"] = dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                                    **_bound(2 * n_written * 32 * 32 * 16, 0),
                                    library_ms=library_ms)
        _say("pool_rows", (
            f"{n_written} rows of T=32 into a {prog.pool_rows}-row pool: equal;"
            f" kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, pool[dst] = src[idx]"
            f" {library_ms:.4f} ms"
        ))

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
        missed = [k for k in ("scene_tiles", "blur_chunk", "pool_rows")
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
        if not all(torch.equal(a, b) for a, b in zip(batched, per_mask, strict=True)):
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
        _say("winding", (
            f"{len(calls)} masks of one interpreter render (pixels median"
            f" {sizes[len(sizes) // 2]}, max {sizes[-1]}; edges median"
            f" {edges[len(edges) // 2]}, max {edges[-1]}): max abs diff {worst:.3g};"
            f" batched fields == per-mask fields; one batched launch {ms:.4f} ms"
            f" ({dev_ms:.4f} ms with the host ahead; with packing and upload"
            f" {call_ms:.4f} ms), one launch per mask {loop_ms:.4f} ms ({loop_dev_ms:.4f}"
            f" ms with the host ahead), plain {plain_ms:.4f} ms, bound"
            f" {results['winding']['bound_ms']:.6f} ms ({results['winding']['bound_by']});"
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
            k_ms = _time_ms(torch, lambda: fused_exec.winding(lines, hh, ww), 10)
            p_ms = _time_ms(torch, lambda: coverage.winding(lines, hh, ww), 2)
            b = _winding_bound([(lines, hh, ww)])
            _say("winding", (
                f"random S={segs} {hh}x{ww}: max abs diff {err:.3g}; kernel {k_ms:.4f} ms,"
                f" plain {p_ms:.4f} ms, bound {b['bound_ms']:.4f} ms ({b['bound_by']})"
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
        missed = {"prepass_winding", "scene_tiles", "blur_chunk", "pool_rows"} - captured
        if missed:
            raise RuntimeError(f"no captured frame launched {sorted(missed)}")

        # 18. replay ms/frame by tile size (measured only)
        scene_p, _ids, _size = scene_from_filepath(pdoc, None, None, fonts)
        for label, scene_, vp_, done in (("flat", flat_scene, flat_vp, {64: serve_cs}),
                                         ("pass", scene_p, vp_p, {32: pass_cs})):
            row = []
            for t in (16, 32, 64):
                t0 = time.monotonic()
                cs_ = done.get(t) or compile_scene(scene_, swap, vp_, tile=t, device=dev)
                compile_s = time.monotonic() - t0
                r = _serve_many(torch, cs_, f"serve_tiles_{label}_{t}", path_launches, 2)
                row.append(f"T={t} {r['replay_ms']:.4f} (eager {r['eager_ms']:.4f},"
                           f" compiled in {compile_s:.2f}s)")
                del cs_
            torch.cuda.empty_cache()
            _say("serve_tiles", f"{label} {vp_[3]}x{vp_[2]} replay ms/frame: {'; '.join(row)}")

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
        ms = _time_ms(torch, lambda: pbatch.fill_batch(lines_d, colors_d, FILL_SIZE, FILL_SIZE,
                                                       device=dev), 20)
        plain_ms = _time_ms(torch, plain_fill, 2)
        mpx = FILL_PATHS * FILL_SIZE * FILL_SIZE / 1e6
        b = _winding_bound([(e, FILL_SIZE, FILL_SIZE) for e in lines_d])
        _say("fill_batch", (
            f"{FILL_PATHS} paths x {FILL_SEGS} edges at {FILL_SIZE}^2: max abs diff vs plain"
            f" {err:.3g}; {ms:.4f} ms ({mpx / ms * 1e3:.1f} Mpx/s), plain {plain_ms:.4f} ms;"
            f" winding bound {b['bound_ms']:.4f} ms ({b['bound_by']}); launches"
            f" {path_launches['fill_batch']}"
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

        # 22. the multi-process dry run: one NCCL rank in its own process
        from svgrasterize_tpu_torch.parallel.distributed import spawn_local

        t0 = time.monotonic()
        line = spawn_local(1, 1, timeout=300, full=True, device="cuda")
        _say("distributed", f"{line} ({time.monotonic() - t0:.2f}s)")

    launches = {
        k: sum(counts[k] for counts in path_launches.values())
        for k in ("prepass_winding", "scene_tiles", "blur_chunk", "pool_rows", "winding")
    }
    sources = {
        "prepass_winding": ("prepass.cu", "svgrasterize_tpu/ops/fused_exec.py:443"),
        "scene_tiles": ("scene.cu", "svgrasterize_tpu/ops/fused_exec.py:853"),
        "blur_chunk": ("blur_chunk.cu", "svgrasterize_tpu/ops/filter_batch.py:396"),
        "pool_rows": ("pool_rows.cu", "svgrasterize_tpu/render_plan.py:2092"),
        "winding": ("winding.cu", "svgrasterize_tpu/ops/pallas_coverage.py:36"),
    }
    kernels = [
        dict(name=name, route="cuda", source=f"svgrasterize_tpu_torch/csrc/{src}",
             replaces=replaces, launches=launches[name], **results[name])
        for name, (src, replaces) in sources.items()
    ]
    if min(k["launches"] for k in kernels) == 0:
        raise RuntimeError(f"a kernel was never launched on a main path: {launches}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
