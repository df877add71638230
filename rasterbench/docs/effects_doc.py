"""An icon sheet of lit, outlined, embossed and grained filter effects
(frozen generator).

The canvas, the plain draws and their gradients are drawn as in
`pass_doc`: the canvas takes width and height apart, geometry scales by
width / 1488, draws are placed over the whole canvas.  Among them sit 30
filtered elements, each under a chain that holds at least one of the SVG
1.1 lighting, morphology, flood and turbulence primitives:

- 12 lit buttons: rounded rects of 200 x 120 user units (the W3C example
  `filters01.svg`'s own region), gradient-filled, under its chain verbatim
  (feGaussianBlur of SourceAlpha, feOffset, feSpecularLighting under a
  fePointLight, feComposite in and arithmetic, feMerge) but for the filter
  region;
- 8 halos: feMorphology dilate of SourceAlpha (radius 1, 2 or 3), feFlood,
  feComposite in, feMerge under SourceGraphic;
- 4 insets: feMorphology erode of SourceGraphic (radius 1 or 2);
- 4 embossed shapes: feDiffuseLighting of SourceAlpha under a
  feDistantLight, feComposite arithmetic k1 = 1 with SourceGraphic;
- 2 grain cards: rects of 320 x 200 user units under feTurbulence
  fractalNoise (baseFrequency 0.65, 3 octaves, seed 0), feColorMatrix
  saturate 0, feComposite in with SourceGraphic, feMerge over it.

Filter regions and `stitchTiles` are left out (the system ignores both).
The filtered elements lie wholly inside the canvas.  The document is always
the one drawn from LAYOUT_SEED, its top-level elements painted in an order
drawn from the run's seed, so that every seed does the same work.

`generate` returns the SVG text and the same document as plain records
(`reference.effects` renders those): every number in a record is the
number as the text spells it.
"""

from __future__ import annotations

import numpy as np

from rasterbench.docs.flat_doc import LAYOUT_SEED, _num, _paint_order

# the W3C SVG 1.1 filters01.svg chain, its filter region left out
LIT = (
    "<filter id='lit'>"
    "<feGaussianBlur in='SourceAlpha' stdDeviation='4' result='blur'/>"
    "<feOffset in='blur' dx='4' dy='4' result='offsetBlur'/>"
    "<feSpecularLighting in='blur' surfaceScale='5' specularConstant='.75'"
    " specularExponent='20' lighting-color='#bbbbbb' result='specOut'>"
    "<fePointLight x='-5000' y='-10000' z='20000'/></feSpecularLighting>"
    "<feComposite in='specOut' in2='SourceAlpha' operator='in' result='specOut'/>"
    "<feComposite in='SourceGraphic' in2='specOut' operator='arithmetic'"
    " k1='0' k2='1' k3='1' k4='0' result='litPaint'/>"
    "<feMerge><feMergeNode in='offsetBlur'/><feMergeNode in='litPaint'/></feMerge>"
    "</filter>"
)
LIT_RECORDS = [
    dict(op="blur", input="SourceAlpha", std=(4.0, 4.0), result="blur"),
    dict(op="offset", input="blur", dx=4.0, dy=4.0, result="offsetBlur"),
    dict(op="specular", input="blur", surface_scale=5.0, constant=0.75, exponent=20.0,
         color=(187, 187, 187), light=("point", -5000.0, -10000.0, 20000.0),
         result="specOut"),
    dict(op="composite", inputs=["specOut", "SourceAlpha"], operator="in", result="specOut"),
    dict(op="composite", inputs=["SourceGraphic", "specOut"],
         operator=("arithmetic", 0.0, 1.0, 1.0, 0.0), result="litPaint"),
    dict(op="merge", inputs=["offsetBlur", "litPaint"], result="out"),
]
EMBOSS = (
    "<filter id='emboss'>"
    "<feDiffuseLighting in='SourceAlpha' surfaceScale='3' diffuseConstant='1'"
    " lighting-color='white' result='light'>"
    "<feDistantLight azimuth='45' elevation='45'/></feDiffuseLighting>"
    "<feComposite in='light' in2='SourceGraphic' operator='arithmetic'"
    " k1='1' k2='0' k3='0' k4='0'/>"
    "</filter>"
)
EMBOSS_RECORDS = [
    dict(op="diffuse", input="SourceAlpha", surface_scale=3.0, constant=1.0,
         color=(255, 255, 255), light=("distant", 45.0, 45.0), result="light"),
    dict(op="composite", inputs=["light", "SourceGraphic"],
         operator=("arithmetic", 1.0, 0.0, 0.0, 0.0), result="out"),
]
GRAIN = (
    "<filter id='grain'>"
    "<feTurbulence type='fractalNoise' baseFrequency='0.65' numOctaves='3' seed='0'"
    " result='noise'/>"
    "<feColorMatrix in='noise' type='saturate' values='0' result='grey'/>"
    "<feComposite in='grey' in2='SourceGraphic' operator='in' result='grain'/>"
    "<feMerge><feMergeNode in='SourceGraphic'/><feMergeNode in='grain'/></feMerge>"
    "</filter>"
)
GRAIN_RECORDS = [
    dict(op="turbulence", kind="fractalNoise", base_frequency=(0.65, 0.65), octaves=3,
         seed=0, result="noise"),
    dict(op="matrix", input="noise", matrix=("saturate", 0.0), result="grey"),
    dict(op="composite", inputs=["grey", "SourceGraphic"], operator="in", result="grain"),
    dict(op="merge", inputs=["SourceGraphic", "grain"], result="out"),
]
# the filtered elements, by kind
COUNTS = {"lit": 12, "halo": 8, "inset": 4, "emboss": 4, "grain": 2}
BUTTON = (200.0, 120.0, 20.0)  # width, height, corner radius (user units)
CARD = (320.0, 200.0)
KAPPA = 0.5523  # a quarter circle's cubic control distance, per unit radius


def generate(seed: int, n_draws: int = 512, width: int = 1488, height: int = 1488):
    """(svg text, document records): n_draws plain draws and 30 filtered
    elements (12 lit buttons, 8 halos, 4 insets, 4 embossed shapes, 2 grain
    cards): the document of LAYOUT_SEED, its top-level elements painted in
    an order drawn from seed (the same work in another order)."""
    rng = np.random.default_rng(LAYOUT_SEED)
    s = width / 1488.0
    extent_xy = np.array([width, height], np.float64)

    def color():
        rgb = tuple(int(v) for v in rng.integers(0, 256, 3))
        return "#%02x%02x%02x" % rgb, rgb

    def xy():
        return rng.uniform(0.02, 0.9, 2) * extent_xy

    def inside(w, h):
        """A top-left corner that keeps a w x h box inside the canvas."""
        lo = 0.02 * extent_xy
        hi = np.maximum(lo, extent_xy - lo - np.array([w, h]))
        return rng.uniform(lo, hi)

    defs = [LIT, EMBOSS, GRAIN]
    gradients = {}
    filters = {"lit": LIT_RECORDS, "emboss": EMBOSS_RECORDS, "grain": GRAIN_RECORDS}
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
    for k in range(COUNTS["halo"]):
        r = (1, 2, 3)[k % 3]
        c_s, c_v = color()
        defs.append(
            f"<filter id='halo{k}'>"
            f"<feMorphology in='SourceAlpha' operator='dilate' radius='{r}' result='grown'/>"
            f"<feFlood flood-color='{c_s}' result='paint'/>"
            "<feComposite in='paint' in2='grown' operator='in' result='halo'/>"
            "<feMerge><feMergeNode in='halo'/><feMergeNode in='SourceGraphic'/></feMerge>"
            "</filter>"
        )
        filters[f"halo{k}"] = [
            dict(op="morphology", input="SourceAlpha", operator="dilate", radius=float(r),
                 result="grown"),
            dict(op="flood", color=c_v, opacity=1.0, result="paint"),
            dict(op="composite", inputs=["paint", "grown"], operator="in", result="halo"),
            dict(op="merge", inputs=["halo", "SourceGraphic"], result="out"),
        ]
    for k in range(COUNTS["inset"]):
        r = (1, 2)[k % 2]
        defs.append(f"<filter id='inset{k}'><feMorphology in='SourceGraphic'"
                    f" operator='erode' radius='{r}'/></filter>")
        filters[f"inset{k}"] = [dict(op="morphology", input="SourceGraphic", operator="erode",
                                     radius=float(r), result="out")]

    def shape(extent, attrs, record, place=xy):
        x, y = place()
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

    def paint(record, solid=0.6):
        if rng.random() < solid:
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

    def icon(fid, out, lo=20, hi=90):
        """A plain shape under a filter, wholly inside the canvas."""
        record = plain()
        extent = rng.uniform(lo, hi) * s
        text = shape(extent, paint(record) + f" filter='url(#{fid})'", record,
                     place=lambda: inside(1.7 * extent, 1.7 * extent) + 0.5 * extent)
        record["filter"] = fid
        out.append(record)
        return text

    def button(out):
        """A gradient-filled rounded rect under the lit chain."""
        w, h, r = BUTTON
        x, y = inside(w, h)
        c = KAPPA * r
        # the outline from the top edge's left end, clockwise, a cubic a corner
        pts = [("M", x + r, y), ("L", x + w - r, y),
               ("C", x + w - r + c, y, x + w, y + r - c, x + w, y + r), ("L", x + w, y + h - r),
               ("C", x + w, y + h - r + c, x + w - r + c, y + h, x + w - r, y + h),
               ("L", x + r, y + h),
               ("C", x + r - c, y + h, x, y + h - r + c, x, y + h - r), ("L", x, y + r),
               ("C", x, y + r - c, x + r - c, y, x + r, y)]
        spelled = [(op, [_num(v) for v in args]) for op, *args in pts]
        d = " ".join(op + " ".join(t for t, _v in nums) for op, nums in spelled) + " Z"
        record = plain()
        attrs = paint(record, solid=0.0)
        record.update(shape="path", d=[(op, *(v for _t, v in nums)) for op, nums in spelled]
                      + [("Z",)], filter="lit")
        out.append(record)
        return f"<path d='{d}'{attrs} filter='url(#lit)'/>"

    def card(out):
        """A gradient-filled card under the grain chain."""
        w, h = CARD
        x, y = inside(w, h)
        xs, ys, ws, hs = _num(x), _num(y), _num(w), _num(h)
        record = plain()
        attrs = paint(record, solid=0.0)
        record.update(shape="rect", x=xs[1], y=ys[1], w=ws[1], h=hs[1], filter="grain")
        out.append(record)
        return (f"<rect x='{xs[0]}' y='{ys[0]}' width='{ws[0]}' height='{hs[0]}'{attrs}"
                " filter='url(#grain)'/>")

    specials = (
        [button] * COUNTS["lit"]
        + [lambda out, k=k: icon(f"halo{k}", out) for k in range(COUNTS["halo"])]
        + [lambda out, k=k: icon(f"inset{k}", out) for k in range(COUNTS["inset"])]
        + [lambda out: icon("emboss", out)] * COUNTS["emboss"]
        + [card] * COUNTS["grain"]
    )
    order = rng.permutation(len(specials))
    every = max(1, n_draws // len(specials))
    body, items = [], []
    k = 0
    for i in range(n_draws):
        body.append(draw(items))
        if i % every == every - 1 and k < len(specials):
            body.append(specials[order[k]](items))
            k += 1
    body.extend(specials[order[j]](items) for j in range(k, len(specials)))
    body, items = _paint_order(seed, body, items)
    svg = (
        f"<svg xmlns='http://www.w3.org/2000/svg' width='{width}' height='{height}'"
        f" viewBox='0 0 {width} {height}'><defs>{''.join(defs)}</defs>"
        + "".join(body) + "</svg>"
    )
    doc = dict(width=float(width), height=float(height), gradients=gradients, clips={},
               masks={}, filters=filters, items=items)
    return svg, doc
