#!/usr/bin/env python3
"""On-card smoke run of the PyTorch / CUDA port (svgrasterize_tpu_torch).

Run from the repository root on a machine with one CUDA card (Hopper,
sm_90a):

    python3 chip_smoke.py

It builds the two hand-written CUDA kernels from svgrasterize_tpu_torch/csrc
with nvcc, holds each against its plain PyTorch version on the card, then
drives the port's main path: the CLI renders a generated 1,536-draw
document at 1488 x 1488, and a compiled scene of the same document serves
5 frames at 3840 x 3840.  Each phase prints one line; any failure exits
non-zero.  The line before the last is a JSON object with per-kernel
launches, errors and times; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

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
PNG_TOL = 1  # 8-bit steps: ~1e-6 differences at a .5 boundary flip one step

CLI_SIZE = 1488
CLI_DRAWS = 1536
SERVE_WIDTH = 3840
SERVE_FRAMES = 5


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


def _lower(doc_path: str, width, tile: int):
    """Parse and lower a document as the CLI does; returns
    (viewport, lowered, {layer: seconds})."""
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
    if lowered is None or lowered.groups:
        raise RuntimeError("the generated document must lower to a single pass")
    return viewport, lowered, seconds


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
    from svgrasterize_tpu_torch.ops import batch_exec, cuda_lib, fused_exec
    from svgrasterize_tpu_torch.render_plan import compile_scene, plan_from_lowered

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
    ptxas = [
        ln.strip() for ln in (so.parent / "nvcc.log").read_text().splitlines()
        if "registers" in ln or "Compiling entry" in ln
    ]
    _say("build", f"{so.name} in {build_s:.2f}s (0 = cached)")
    for ln in ptxas:
        _say("build", ln)

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

        # 3. prepass kernel against plain
        rng = np.random.default_rng(1)
        worst = 0.0
        for t in (32, 64):
            for width in (128, 256, 512, 1024):
                m = 48
                edges = np.zeros((m, width, 4), np.float32)
                for r in range(m):
                    live = int(rng.integers(1, width + 1))
                    edges[r, :live] = rng.uniform(-4, t + 4, (live, 4))
                arr = torch.from_numpy(edges).to(dev)
                got = fused_exec.prepass_winding([arr], t)
                ref = batch_exec._prepass_winding([arr], t)
                torch.cuda.synchronize()
                err = float((got - ref).abs().max())
                worst = max(worst, err)
                _say("prepass", f"T={t} width={width}: max abs diff {err:.3g}")
                if not err <= PREPASS_TOL:
                    raise RuntimeError(f"prepass kernel disagrees: {err} > {PREPASS_TOL}")
        got = fused_exec.prepass_winding(plan.bigs, plan.tile)
        ref = batch_exec._prepass_winding(plan.bigs, plan.tile)
        err = 0.0 if got is None else float((got - ref).abs().max())
        if not err <= PREPASS_TOL:
            raise RuntimeError(f"prepass kernel disagrees on the plan: {err}")
        ms = _time_ms(torch, lambda: fused_exec.prepass_winding(plan.bigs, 32), 20)
        plain_ms = _time_ms(torch, lambda: batch_exec._prepass_winding(plan.bigs, 32), 5)
        results["prepass_winding"] = dict(max_abs_err=max(err, worst), ms=ms, plain_ms=plain_ms)
        _say("prepass", (
            f"plan bigs: max abs diff {err:.3g}; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms"
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
        plain_ms = _time_ms(torch, lambda: batch_exec._scene_tiles(plan, big), 3)
        results["scene_tiles"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)
        _say("scene", f"max abs diff {err:.3g}; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
        plain_png = _png_pixels(batch_exec.execute_items(plan), low_cli, vp_cli)
        _say("layers", _layer_breakdown(torch, doc, dev))

        # the main path: CLI render, then serving; counters from 0
        fused_exec.reset_launch_counts()

        # 5. CLI
        out_png = os.path.join(tmp, "out.png")
        t0 = time.monotonic()
        rc = cli.main([doc, out_png])
        cli_s = time.monotonic() - t0
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
        cli_counts = (fused_exec.prepass_winding.launches, fused_exec.scene_tiles.launches)
        if min(cli_counts) == 0:
            raise RuntimeError(f"CLI did not launch both kernels: {cli_counts}")
        _say("cli", (
            f"{CLI_SIZE}x{CLI_SIZE} PNG in {cli_s:.3f}s (parse + lower + render +"
            f" encode); max diff vs plain {int(diff.max())}/255,"
            f" {float((diff == 0).mean()) * 100:.4f}% bytes equal; launches"
            f" prepass {cli_counts[0]}, scene {cli_counts[1]}"
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
        first = cs.render_tiles()
        torch.cuda.synchronize()
        frame_ms = _time_ms(torch, cs.render_tiles, SERVE_FRAMES)
        last = cs.render_tiles()
        torch.cuda.synchronize()
        launches = {
            "prepass_winding": fused_exec.prepass_winding.launches,
            "scene_tiles": fused_exec.scene_tiles.launches,
        }
        if not torch.equal(first, last):
            raise RuntimeError("serving frames differ")
        if min(launches.values()) == 0:
            raise RuntimeError(f"main path missed a kernel: {launches}")
        plain_frame_ms = _time_ms(torch, lambda: batch_exec.execute_items(cs.plan), 2)
        plain_last = batch_exec.execute_items(cs.plan)
        serve_err = float((last - plain_last).abs().max())
        if not serve_err <= SCENE_TOL:
            raise RuntimeError(f"serving kernels disagree with plain: {serve_err}")
        mpx = w * h / 1e6
        _say("serve", (
            f"{int(w)}x{int(h)} T=64 {cs.plan.tile_id.shape[0]} items, compiled in"
            f" {compile_s:.2f}s; kernels {frame_ms:.3f} ms/frame"
            f" ({mpx / frame_ms * 1e3:.1f} Mpx/s), plain {plain_frame_ms:.3f}"
            f" ms/frame ({mpx / plain_frame_ms * 1e3:.1f} Mpx/s); max abs diff"
            f" {serve_err:.3g}; last frame == first"
        ))

    kernels = [
        dict(name="prepass_winding", route="cuda",
             source="svgrasterize_tpu_torch/csrc/prepass.cu",
             replaces="svgrasterize_tpu/ops/fused_exec.py:443",
             launches=launches["prepass_winding"], **results["prepass_winding"]),
        dict(name="scene_tiles", route="cuda",
             source="svgrasterize_tpu_torch/csrc/scene.cu",
             replaces="svgrasterize_tpu/ops/fused_exec.py:853",
             launches=launches["scene_tiles"], **results["scene_tiles"]),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
