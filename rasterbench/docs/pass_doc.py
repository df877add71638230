"""An icon-sheet-like document of isolation passes (frozen generator).

A frozen copy of `chip_smoke.pass_doc(n_draws, size, seed)` with two
departures: the canvas takes width and height apart (the original's is
square; geometry scales by width / 1488 as in the original, and draws are
placed over the whole canvas: each x by the width, each y by the height);
and the document is always the one drawn from LAYOUT_SEED, its top-level
elements painted in an order drawn from the run's seed, so that every seed
does the same work.

`generate` returns the SVG text and the same document as plain records
(`reference.passes` renders those): every number in a record is the number
as the text spells it.
"""

from __future__ import annotations

import numpy as np

from rasterbench.docs.flat_doc import LAYOUT_SEED, _num, _paint_order


def generate(seed: int, n_draws: int = 768, width: int = 1488, height: int = 1488):
    """(svg text, document records): n_draws plain draws, and among them 64
    opacity groups of 3 draws, 12 gradient masks, 12 anti-aliased clip paths
    over multi-draw groups, 24 lone feGaussianBlur filters (stdDeviation
    1-8, some anisotropic, some on SourceAlpha), 8 drop-shadow chains, 8
    colour-matrix / composite chains and 8 filters nested inside opacity
    groups: the document of LAYOUT_SEED, its top-level elements painted in
    an order drawn from seed (the same work in another order)."""
    rng = np.random.default_rng(LAYOUT_SEED)
    s = width / 1488.0
    extent_xy = np.array([width, height], np.float64)

    def color():
        rgb = tuple(int(v) for v in rng.integers(0, 256, 3))
        return "#%02x%02x%02x" % rgb, rgb

    def xy():
        return rng.uniform(0.02, 0.9, 2) * extent_xy

    defs = []
    gradients, masks, clips, filters = {}, {}, {}, {}
    for g in range(8):
        stops, stop_text = [], []
        for o in (0.0, 0.5, 1.0):
            c_s, c_v = color()
            stop_text.append(f"<stop offset='{o:.2f}' stop-color='{c_s}'/>")
            stops.append((o, c_v, 1.0))
        x2, y2 = _num(rng.uniform(0.4, 1), 2), _num(rng.uniform(0, 1), 2)
        defs.append(
            f"<linearGradient id='g{g}' x1='0' y1='0' x2='{x2[0]}'"
            f" y2='{y2[0]}'>{''.join(stop_text)}</linearGradient>"
        )
        gradients[f"g{g}"] = dict(kind="linear", x1=0.0, y1=0.0, x2=x2[1], y2=y2[1],
                                  spread="pad", stops=stops)
    for m in range(12):
        y2 = _num(rng.uniform(0, 1), 2)
        defs.append(
            f"<linearGradient id='mg{m}' x1='0' y1='0' x2='1' y2='{y2[0]}'>"
            "<stop offset='0' stop-color='white'/><stop offset='1' stop-color='#101010'/>"
            f"</linearGradient><mask id='m{m}' maskContentUnits='objectBoundingBox'>"
            f"<rect x='0' y='0' width='1' height='1' fill='url(#mg{m})'/></mask>"
        )
        gradients[f"mg{m}"] = dict(kind="linear", x1=0.0, y1=0.0, x2=1.0, y2=y2[1],
                                   spread="pad", stops=[(0.0, (255, 255, 255), 1.0),
                                                        (1.0, (16, 16, 16), 1.0)])
        masks[f"m{m}"] = dict(gradient=f"mg{m}")
    for c in range(12):
        cx, cy = xy()
        r = rng.uniform(30, 90) * s
        if c % 2 == 0:
            (cxs, cxv), (cys, cyv), (rs, rv) = _num(cx), _num(cy), _num(r)
            shape = f"<circle cx='{cxs}' cy='{cys}' r='{rs}'/>"
            clips[f"c{c}"] = dict(kind="circle", cx=cxv, cy=cyv, r=rv)
        else:
            x, y, w, h = _num(cx - r), _num(cy - r / 2), _num(2 * r), _num(r)
            a, pcx, pcy = _num(rng.uniform(5, 80)), _num(cx), _num(cy)
            shape = (f"<rect x='{x[0]}' y='{y[0]}' width='{w[0]}'"
                     f" height='{h[0]}' transform='rotate({a[0]}"
                     f" {pcx[0]} {pcy[0]})'/>")
            clips[f"c{c}"] = dict(kind="rect", x=x[1], y=y[1], w=w[1], h=h[1],
                                  rotate=(a[1], pcx[1], pcy[1]))
        defs.append(f"<clipPath id='c{c}'>{shape}</clipPath>")
    for b in range(24):
        sx = _num(rng.uniform(1, 8), 2)
        sy = sx if b % 3 else _num(rng.uniform(1, 8), 2)
        std = sx[0] if b % 3 else f"{sx[0]} {sy[0]}"
        alpha = b % 4 == 1
        src = " in='SourceAlpha'" if alpha else ""
        defs.append(f"<filter id='b{b}'><feGaussianBlur{src} stdDeviation='{std}'/></filter>")
        filters[f"b{b}"] = [dict(op="blur", input="SourceAlpha" if alpha else "SourceGraphic",
                                 std=(sx[1], sy[1]), result="out")]
    for d in range(8):
        std, dx, dy = _num(rng.uniform(1, 4), 2), _num(rng.uniform(2, 8)), _num(rng.uniform(2, 8))
        defs.append(
            f"<filter id='ds{d}'><feGaussianBlur in='SourceAlpha'"
            f" stdDeviation='{std[0]}' result='blur'/>"
            f"<feOffset in='blur' dx='{dx[0]}' dy='{dy[0]}'"
            " result='shadow'/><feMerge><feMergeNode in='shadow'/>"
            "<feMergeNode in='SourceGraphic'/></feMerge></filter>"
        )
        filters[f"ds{d}"] = [
            dict(op="blur", input="SourceAlpha", std=(std[1], std[1]), result="blur"),
            dict(op="offset", input="blur", dx=dx[1], dy=dy[1], result="shadow"),
            dict(op="merge", inputs=["shadow", "SourceGraphic"], result="out"),
        ]
    ops = ("atop", "in", "out", "xor")
    for k in range(8):
        if k % 2 == 0:
            v = _num(rng.uniform(0, 1), 2)
            cm, matrix = f"type='saturate' values='{v[0]}'", ("saturate", v[1])
        else:
            v = _num(rng.uniform(0, 360), 0)
            cm, matrix = f"type='hueRotate' values='{v[0]}'", ("hueRotate", v[1])
        if k < 4:
            comp, operator = f"operator='{ops[k % 4]}'", ops[k % 4]
        else:
            comp, operator = ("operator='arithmetic' k1='0.2' k2='0.6' k3='0.4' k4='0'",
                              ("arithmetic", 0.2, 0.6, 0.4, 0.0))
        defs.append(
            f"<filter id='cm{k}'><feColorMatrix {cm} result='c'/>"
            f"<feComposite in='c' in2='SourceGraphic' {comp}/></filter>"
        )
        filters[f"cm{k}"] = [
            dict(op="matrix", input="SourceGraphic", matrix=matrix, result="c"),
            dict(op="composite", inputs=["c", "SourceGraphic"], operator=operator,
                 result="out"),
        ]

    def shape(extent, attrs, record):
        x, y = xy()
        kind = int(rng.integers(0, 3))
        if kind == 0:
            xs, ys, ws = _num(x), _num(y), _num(extent)
            hs = _num(extent * rng.uniform(0.4, 1.2))
            record.update(shape="rect", x=xs[1], y=ys[1], w=ws[1], h=hs[1])
            return f"<rect x='{xs[0]}' y='{ys[0]}' width='{ws[0]}' height='{hs[0]}'{attrs}/>"
        if kind == 1:
            xs, ys, rs = _num(x), _num(y), _num(extent / 2)
            record.update(shape="circle", cx=xs[1], cy=ys[1], r=rs[1])
            return f"<circle cx='{xs[0]}' cy='{ys[0]}' r='{rs[0]}'{attrs}/>"
        pts = rng.uniform(0, extent, (3, 2)) + (x, y)
        p = [[_num(v) for v in row] for row in pts]
        xs, ys = _num(x), _num(y)
        record.update(shape="path", d=[("M", xs[1], ys[1]),
                                       ("Q", p[0][0][1], p[0][1][1], p[1][0][1], p[1][1][1]),
                                       ("T", p[2][0][1], p[2][1][1]), ("Z",)])
        return (f"<path d='M{xs[0]} {ys[0]} Q{p[0][0][0]} {p[0][1][0]}"
                f" {p[1][0][0]} {p[1][1][0]} T{p[2][0][0]} {p[2][1][0]} Z'{attrs}/>")

    def paint(record):
        if rng.random() < 0.6:
            c_s, c_v = color()
            record["paint"] = ("solid", c_v)
            return f" fill='{c_s}'"
        gid = f"g{int(rng.integers(0, 8))}"
        record["paint"] = ("gradient", gid)
        return f" fill='url(#{gid})'"

    def plain():
        return dict(opacity=1.0, clip=None, rule="nonzero")

    def draw(out, lo=8, hi=80):
        record = plain()
        attrs = paint(record)
        if rng.random() < 0.3:
            o = _num(rng.uniform(0.4, 1), 2)
            attrs += f" fill-opacity='{o[0]}'"
            record["opacity"] = o[1]
        text = shape(rng.uniform(lo, hi) * s, attrs, record)
        out.append(record)
        return text

    def filtered(lo, hi, fid, out):
        record = plain()
        extent = rng.uniform(lo, hi) * s
        text = shape(extent, paint(record) + f" filter='url(#{fid})'", record)
        record["filter"] = fid
        out.append(record)
        return text

    def group(kind, value, children_fn, out):
        record = dict(group=kind, value=value, children=[])
        text = children_fn(record["children"])
        out.append(record)
        return text

    def opacity_group(k, out):
        o = _num(rng.uniform(0.3, 0.8), 2)
        return group("opacity", o[1], lambda ch: f"<g opacity='{o[0]}'>"
                     + draw(ch) + draw(ch) + draw(ch) + "</g>", out)

    def mask_group(k, out):
        return group("mask", f"m{k % 12}", lambda ch: f"<g mask='url(#m{k % 12})'>"
                     + draw(ch, 40, 140) + draw(ch, 20, 80) + "</g>", out)

    def clip_group(k, out):
        return group("clip", f"c{k % 12}", lambda ch: f"<g clip-path='url(#c{k % 12})'>"
                     + draw(ch, 60, 200) + draw(ch, 40, 140) + draw(ch, 20, 80) + "</g>", out)

    def nested(k, out):
        o = _num(rng.uniform(0.4, 0.9), 2)
        return group("opacity", o[1], lambda ch: f"<g opacity='{o[0]}'>"
                     + filtered(16, 80, f"b{k % 24}", ch) + draw(ch) + "</g>", out)

    specials = (
        [opacity_group] * 64 + [mask_group] * 12 + [clip_group] * 12
        + [lambda k, out: filtered(16, 120, f"b{k % 24}", out)] * 24
        + [lambda k, out: filtered(20, 90, f"ds{k % 8}", out)] * 8
        + [lambda k, out: filtered(20, 90, f"cm{k % 8}", out)] * 8
        + [nested] * 8
    )
    order = rng.permutation(len(specials))
    every = max(1, n_draws // len(specials))
    body, items = [], []
    k = 0
    for i in range(n_draws):
        body.append(draw(items))
        if i % every == every - 1 and k < len(specials):
            body.append(specials[order[k]](k, items))
            k += 1
    body.extend(specials[order[j]](j, items) for j in range(k, len(specials)))
    body, items = _paint_order(seed, body, items)
    svg = (
        f"<svg xmlns='http://www.w3.org/2000/svg' width='{width}' height='{height}'"
        f" viewBox='0 0 {width} {height}'><defs>{''.join(defs)}</defs>"
        + "".join(body) + "</svg>"
    )
    doc = dict(width=float(width), height=float(height), gradients=gradients, clips=clips,
               masks=masks, filters=filters, items=items)
    return svg, doc
