"""A pass-free, material-design-like document (frozen generator).

A frozen copy of `chip_smoke.flat_doc(n_draws, size, seed)` with three
departures: the quarter of draws that the original strokes are filled with
the same paint (the stroke width is still drawn from the generator, so every
later draw keeps its place), and the line of text is left out (icon and
illustration exports ship both as outlines); and the document is always the
original's for seed 0 (LAYOUT_SEED), its draws painted in an order drawn from
the run's seed, so that every seed does the same work.

`generate` returns the SVG text and the same document as plain records
(`reference.raster` renders those): every number in a record is the number
as the text spells it.
"""

from __future__ import annotations

import numpy as np


def _num(value: float, digits: int = 1):
    """A number as the text spells it, and its value read back."""
    text = f"{value:.{digits}f}"
    return text, float(text)


# every run's document is drawn from this seed (chip_smoke's); the run's seed
# draws the order its elements are painted in
LAYOUT_SEED = 0


def _paint_order(seed: int, body: list, items: list):
    """The body's elements and their records in an order drawn from seed."""
    order = np.random.default_rng(seed).permutation(len(body))
    return [body[i] for i in order], [items[i] for i in order]


def generate(seed: int, n_draws: int = 1536, size: int = 1488):
    """(svg text, document records) of n_draws draws on a size x size canvas:
    the document of LAYOUT_SEED, its draws painted in an order drawn from
    seed (every seed paints the same shapes: the same work in another order).

    Rects, circles and quadratic / cubic paths; solid, linear and radial
    paints with 2-5 stops and all three spread modes, faded by fill-opacity;
    evenodd paths; 16 user-space clipPaths on leaf shapes; a few shapes
    spanning many tiles; a few 240-edge stars.  No isolation construct.
    """
    rng = np.random.default_rng(LAYOUT_SEED)
    s = size / 1488.0

    def color():
        rgb = tuple(int(v) for v in rng.integers(0, 256, 3))
        return "#%02x%02x%02x" % rgb, rgb

    defs = []
    gradients = {}
    spreads = ("pad", "reflect", "repeat")
    n_grad = 24
    for g in range(n_grad):
        k = int(rng.integers(2, 6))
        offs = np.sort(rng.uniform(0.0, 1.0, k))
        offs[0] = 0.0
        stop_text, stops = [], []
        for o in offs:
            o_s, o_v = _num(o, 3)
            c_s, c_v = color()
            a_s, a_v = _num(rng.uniform(0.5, 1.0), 2)
            stop_text.append(f"<stop offset='{o_s}' stop-color='{c_s}' stop-opacity='{a_s}'/>")
            stops.append((o_v, c_v, a_v))
        spread = spreads[g % 3]
        if g % 2 == 0:
            x1, y1 = (_num(v, 2) for v in rng.uniform(0.0, 0.4, 2))
            x2, y2 = (_num(v, 2) for v in rng.uniform(0.5, 0.9, 2))
            defs.append(
                f"<linearGradient id='g{g}' x1='{x1[0]}' y1='{y1[0]}'"
                f" x2='{x2[0]}' y2='{y2[0]}' spreadMethod='{spread}'>"
                f"{''.join(stop_text)}</linearGradient>"
            )
            gradients[f"g{g}"] = dict(kind="linear", x1=x1[1], y1=y1[1], x2=x2[1], y2=y2[1],
                                      spread=spread, stops=stops)
        else:
            r_val = rng.uniform(0.2, 0.5)
            r = _num(r_val, 2)
            fx, fy = (_num(v, 2) for v in 0.5 + rng.uniform(-0.5, 0.5, 2) * r_val)
            defs.append(
                f"<radialGradient id='g{g}' cx='0.5' cy='0.5' r='{r[0]}'"
                f" fx='{fx[0]}' fy='{fy[0]}' spreadMethod='{spread}'>"
                f"{''.join(stop_text)}</radialGradient>"
            )
            gradients[f"g{g}"] = dict(kind="radial", cx=0.5, cy=0.5, r=r[1], fx=fx[1],
                                      fy=fy[1], spread=spread, stops=stops)
    clips = {}
    for c in range(16):
        cx, cy = rng.uniform(0.1, 0.9, 2) * size
        rad = rng.uniform(60, 260) * s
        if c % 2 == 0:
            (cxs, cxv), (cys, cyv), (rs, rv) = _num(cx), _num(cy), _num(rad)
            shape = f"<circle cx='{cxs}' cy='{cys}' r='{rs}'/>"
            clips[f"c{c}"] = dict(kind="circle", cx=cxv, cy=cyv, r=rv)
        else:
            x, y = _num(cx - rad), _num(cy - 0.7 * rad)
            w, h = _num(2 * rad), _num(1.4 * rad)
            a, pcx, pcy = _num(rng.uniform(0, 90)), _num(cx), _num(cy)
            shape = (
                f"<rect x='{x[0]}' y='{y[0]}' width='{w[0]}' height='{h[0]}'"
                f" transform='rotate({a[0]} {pcx[0]} {pcy[0]})'/>"
            )
            clips[f"c{c}"] = dict(kind="rect", x=x[1], y=y[1], w=w[1], h=h[1],
                                  rotate=(a[1], pcx[1], pcy[1]))
        defs.append(f"<clipPath id='c{c}'>{shape}</clipPath>")

    body = []
    items = []
    for i in range(n_draws):
        if i % 307 == 5:
            extent = rng.uniform(400, 1100) * s  # spans many tiles: carries
        else:
            extent = rng.uniform(6, 90) * s
        x, y = rng.uniform(-0.05, 0.95, 2) * size
        roll = rng.random()
        if roll < 0.5:
            paint_text, rgb = color()
            paint = ("solid", rgb)
        else:
            gid = f"g{int(rng.integers(0, n_grad))}"
            paint_text, paint = f"url(#{gid})", ("gradient", gid)
        attrs = ""
        item = dict(paint=paint, opacity=1.0, clip=None, rule="nonzero")
        if rng.random() < 0.35:
            o = _num(rng.uniform(0.4, 1.0), 2)
            attrs += f" fill-opacity='{o[0]}'"
            item["opacity"] = o[1]
        if rng.random() < 0.33:
            cid = f"c{int(rng.integers(0, 16))}"
            attrs += f" clip-path='url(#{cid})'"
            item["clip"] = cid
        if rng.random() < 0.25:
            rng.uniform(1.0, 8.0)  # the original's stroke width: filled here
        attrs += f" fill='{paint_text}'"
        kind = i % 4
        if kind == 0:
            xs, ys, ws = _num(x), _num(y), _num(extent)
            hs = _num(extent * rng.uniform(0.3, 1.2))
            body.append(f"<rect x='{xs[0]}' y='{ys[0]}' width='{ws[0]}' height='{hs[0]}'{attrs}/>")
            item.update(shape="rect", x=xs[1], y=ys[1], w=ws[1], h=hs[1])
        elif kind == 1:
            xs, ys, rs = _num(x), _num(y), _num(extent / 2)
            body.append(f"<circle cx='{xs[0]}' cy='{ys[0]}' r='{rs[0]}'{attrs}/>")
            item.update(shape="circle", cx=xs[1], cy=ys[1], r=rs[1])
        else:
            pts = rng.uniform(0, extent, (4, 2)) + (x, y)
            p = [[_num(v) for v in row] for row in pts]
            if kind == 2:
                d = (
                    f"M{p[0][0][0]} {p[0][1][0]} Q{p[1][0][0]} {p[1][1][0]}"
                    f" {p[2][0][0]} {p[2][1][0]} T{p[3][0][0]} {p[3][1][0]} Z"
                )
                cmds = [("M", p[0][0][1], p[0][1][1]),
                        ("Q", p[1][0][1], p[1][1][1], p[2][0][1], p[2][1][1]),
                        ("T", p[3][0][1], p[3][1][1]), ("Z",)]
            else:
                xs, ys = _num(x), _num(y)
                ex, ey = _num(x + extent / 2), _num(y + extent / 2)
                d = (
                    f"M{p[0][0][0]} {p[0][1][0]} C{p[1][0][0]} {p[1][1][0]}"
                    f" {p[2][0][0]} {p[2][1][0]} {p[3][0][0]} {p[3][1][0]}"
                    f" C{xs[0]} {p[3][1][0]} {p[0][0][0]} {ys[0]}"
                    f" {ex[0]} {ey[0]} Z"
                )
                cmds = [("M", p[0][0][1], p[0][1][1]),
                        ("C", p[1][0][1], p[1][1][1], p[2][0][1], p[2][1][1],
                         p[3][0][1], p[3][1][1]),
                        ("C", xs[1], p[3][1][1], p[0][0][1], ys[1], ex[1], ey[1]), ("Z",)]
            if rng.random() < 0.4:
                attrs += " fill-rule='evenodd'"
                item["rule"] = "evenodd"
            body.append(f"<path d='{d}'{attrs}/>")
            item.update(shape="path", d=cmds)
        items.append(item)
        if i % 256 == 7:
            # a star of hundreds of short edges inside one or two tiles
            n_pts = 240
            ang = np.linspace(0, 2 * np.pi, n_pts, endpoint=False)
            rad = np.where(np.arange(n_pts) % 2 == 0, 14.0, 6.0) * s
            px = x + rad * np.cos(ang)
            py = y + rad * np.sin(ang)
            pairs = [(_num(a, 2), _num(b, 2)) for a, b in zip(px, py)]
            d = "M" + " L".join(f"{a[0]} {b[0]}" for a, b in pairs) + " Z"
            c_s, c_v = color()
            body.append(f"<path d='{d}' fill='{c_s}' fill-rule='evenodd'/>")
            cmds = [("M" if k == 0 else "L", a[1], b[1]) for k, (a, b) in enumerate(pairs)]
            items.append(dict(paint=("solid", c_v), opacity=1.0, clip=None, rule="evenodd",
                              shape="path", d=cmds + [("Z",)]))
    body, items = _paint_order(seed, body, items)
    svg = (
        f"<svg xmlns='http://www.w3.org/2000/svg' width='{size}' height='{size}'"
        f" viewBox='0 0 {size} {size}'><defs>{''.join(defs)}</defs>"
        + "".join(body) + "</svg>"
    )
    doc = dict(width=float(size), height=float(size), gradients=gradients, clips=clips,
               masks={}, filters={}, items=items)
    return svg, doc
