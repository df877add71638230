"""Pathological stress-scene generator: the anti-collapse worst case.

All perf evidence elsewhere is three demo files whose z-stacks collapse
well (render_plan._collapse_runs) and whose pass mixes cluster cleanly.
This generator builds the opposite on purpose: thousands of SMALL
overlapping items with an opacity GROUP interleaved after every
gradient shape — group outputs are frame-dynamic pool reads (tex
items), which are the only paints the static-run collapse can never
precompose (solid AND gradient runs both collapse since round 4), so
runs break at every other item and every item survives to the kernel's
serial per-item loop; the pass mix per tile stays deep (the kvec
step-padding worst case, see ops/fused_exec.kvec_cluster).
Deterministic in (n_items, seed) so recorded numbers are comparable
across rounds.  A copy of the JAX package's utils/stress.py (the same
document for the same arguments).

Used by the port's tests and chip_smoke.py's serving phase.
"""

from __future__ import annotations


def stress_doc(n_items: int = 2000, size: int = 1024, seed: int = 0) -> str:
    """A worst-case SVG document of n_items small overlapping draws."""
    import numpy as np

    rng = np.random.default_rng(seed)
    defs = []
    for g in range(8):
        stops = "".join(
            f'<stop offset="{o:.2f}" stop-color="rgb({rng.integers(0, 256)},'
            f'{rng.integers(0, 256)},{rng.integers(0, 256)})" '
            f'stop-opacity="{rng.uniform(0.4, 1):.2f}"/>'
            for o in (0.0, float(rng.uniform(0.3, 0.7)), 1.0)
        )
        if g % 2:
            defs.append(
                f'<linearGradient id="g{g}" x1="0" y1="0" '
                f'x2="{rng.uniform(0.5, 1):.2f}" y2="1">{stops}'
                "</linearGradient>"
            )
        else:
            defs.append(
                f'<radialGradient id="g{g}" fx="{rng.uniform(0.2, 0.4):.2f}" '
                f'fy="{rng.uniform(0.2, 0.4):.2f}">{stops}</radialGradient>'
            )
    for c in range(6):
        cx, cy = rng.integers(0, size, 2)
        defs.append(
            f'<clipPath id="c{c}"><circle cx="{cx}" cy="{cy}" '
            f'r="{rng.integers(size // 4, size // 2)}"/></clipPath>'
        )

    body = []
    i = 0
    while i < n_items:
        x, y = rng.integers(0, size - 40, 2)
        paint = f"url(#g{i % 8})"
        attrs = f'fill="{paint}" fill-opacity="{rng.uniform(0.3, 0.9):.2f}"'
        if i % 3 == 0:
            attrs += f' clip-path="url(#c{i % 6})"'
        if i % 5 == 0:
            attrs += (
                f' transform="rotate({rng.uniform(-30, 30):.1f} {x} {y})"'
            )
        kind = (i // 2) % 3 if i % 2 == 0 else 3
        if kind == 0:
            shape = (
                f'<rect x="{x}" y="{y}" width="{rng.integers(12, 40)}" '
                f'height="{rng.integers(12, 40)}" {attrs}/>'
            )
        elif kind == 1:
            shape = (
                f'<circle cx="{x}" cy="{y}" r="{rng.integers(6, 22)}" '
                f"{attrs}/>"
            )
        elif kind == 2:
            x2, y2 = x + rng.integers(10, 40), y + rng.integers(10, 40)
            shape = (
                f'<path d="M{x} {y} Q{x2} {y} {x2} {y2} T{x} {y2} Z" '
                f"{attrs}/>"
            )
        else:
            # opacity group with two members: an isolation pass whose
            # output is a frame-dynamic tex item — breaks every run
            shape = (
                f'<g opacity="{rng.uniform(0.3, 0.8):.2f}">'
                f'<rect x="{x}" y="{y}" width="24" height="24" {attrs}/>'
                f'<circle cx="{x + 14}" cy="{y + 14}" r="10" '
                f'fill="url(#g{(i + 1) % 8})"/></g>'
            )
            i += 1  # the group emits two draws
        body.append(shape)
        i += 1

    return (
        f'<svg xmlns="http://www.w3.org/2000/svg" width="{size}" '
        f'height="{size}"><defs>{"".join(defs)}</defs>{"".join(body)}</svg>'
    )


def edge_batch(n_paths: int, n_segs: int, extent: float, seed: int = 0):
    """A batch of n_paths random closed polygons of n_segs edges each, as
    (lines (N, S, 4) f32 edge lists (a0, a1, b0, b1) in an extent x extent
    image, colors (N, 4) f32 premultiplied): the input of
    parallel.batch.fill_batch (the JAX repository's benchmark fill batch,
    the same arrays for the same arguments)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    angles = np.sort(rng.uniform(0, 2 * np.pi, size=(n_paths, n_segs)), axis=1)
    radius = rng.uniform(0.2, 0.48, size=(n_paths, 1)) * extent
    center = rng.uniform(0.3, 0.7, size=(n_paths, 2)) * extent
    pts = np.stack(
        [center[:, 0:1] + radius * np.cos(angles), center[:, 1:2] + radius * np.sin(angles)],
        axis=-1,
    )  # (N, S, 2)
    lines = np.concatenate([pts, np.roll(pts, -1, axis=1)], axis=-1).astype(np.float32)
    colors = rng.uniform(0.1, 1.0, size=(n_paths, 4)).astype(np.float32)
    colors[:, :3] *= colors[:, 3:]
    return lines, colors
