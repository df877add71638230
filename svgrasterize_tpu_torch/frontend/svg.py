"""SVG document -> Scene graph builder (host-side).

Walks the XML element tree, cascades styleable attributes, lowers shapes to
path data, and constructs the retained-mode Scene IR plus an id registry for
url(#...) references.  Feature parity target is the reference scene builder
(svgrasterize.py:2724-3787): svg/viewBox negotiation, path,
g, defs, gradients, clipPath, mask, filter, pattern, all basic shapes, font,
text/tspan, and use.
"""

from __future__ import annotations

import gzip
import io
import os
import warnings
from xml.etree import ElementTree as etree

import numpy as np

from ..core.transform import Transform
from ..filter import (
    COLOR_MATRIX_LUM,
    Filter,
    color_matrix_hue_rotate,
    color_matrix_saturate,
)
from ..geom.path import FILL_NONZERO, PATH_CLOSED, PATH_LINE, Path
from ..ops.compose import (
    COMPOSE_ATOP,
    COMPOSE_IN,
    COMPOSE_OUT,
    COMPOSE_OVER,
    COMPOSE_XOR,
)
from ..paint import GradLinear, GradRadial, Pattern, RasterImage
from ..scene import Scene
from ..text.fonts import FONT_STYLE_NORMAL, Font, FontsDB, Glyph, font_weight
from ..utils.constants import FLOAT
from . import parsers
from .parsers import (
    DEFAULT_FONT_SIZE,
    parse_angle,
    parse_color,
    parse_float,
    parse_float_list,
    parse_paint,
    parse_size,
    parse_transform,
    parse_url,
)

UNITS_USER = "userSpaceOnUse"
UNITS_BBOX = "objectBoundingBox"

# Attributes that cascade from parent to child elements.
INHERITED_ATTRS = frozenset(
    {
        "color",
        "fill",
        "fill-rule",
        "fill-opacity",
        "stroke",
        "stroke-opacity",
        "stroke-width",
        "stroke-linecap",
        "stroke-linejoin",
        "stroke-miterlimit",
        "font-family",
        "font-size",
        "font-weight",
        "font-style",
        "text-anchor",
        "visibility",
        "paint-order",
        # xml:space is XML-inherited; ElementTree expands the prefix
        "{http://www.w3.org/XML/1998/namespace}space",
    }
)

# Definition-only elements: never rendered directly, so `display`/conditional
# processing must not stop their registration (they stay referenceable).
_DEFINITION_TAGS = frozenset(
    {
        "defs", "linearGradient", "radialGradient", "clipPath", "mask",
        "filter", "pattern", "marker", "symbol", "font", "style", "script",
        "title", "desc", "metadata",
    }
)

# Graphics/text leaves where `visibility: hidden` suppresses rendering (on a
# container it only cascades — a child can reset `visibility: visible`).
_VISIBILITY_LEAF_TAGS = frozenset(
    {
        "path", "rect", "circle", "ellipse", "line", "polygon", "polyline",
        "text", "image", "use",
    }
)

# SVG 1.1 static feature-string prefixes this rasterizer claims
# (requiredFeatures values outside these evaluate false).
_FEATURE_PREFIXES = (
    "http://www.w3.org/TR/SVG11/feature#",
    "http://www.w3.org/TR/SVG/feature#",
    "org.w3c.svg",
    "org.w3c.dom.svg",
)


def conditional_ok(attrs: dict, language: str = "en") -> bool:
    """SVG 1.1 5.8 conditional processing (beyond the reference — it has no
    <switch>/conditional support at all).

    * requiredFeatures: true when absent; an empty value is false; otherwise
      every listed feature must be an SVG 1.1 static feature string.
    * requiredExtensions: true only when absent — no extensions are
      implemented and an empty value is itself false per spec (this is the
      attribute Illustrator/Inkscape exports use to pick their vector
      fallback inside <switch>).
    * systemLanguage: true when absent; otherwise some entry must match the
      user language by exact tag or dash-prefix (SVG 1.1 5.8.5).
    """
    feats = attrs.get("requiredFeatures")
    if feats is not None:
        listed = feats.split()
        if not listed or not all(
            f.startswith(_FEATURE_PREFIXES) for f in listed
        ):
            return False
    if attrs.get("requiredExtensions") is not None:
        # no extensions are implemented, and per spec an empty value is
        # itself false — so any presence of the attribute fails
        return False
    langs = attrs.get("systemLanguage")
    if langs is not None:
        # lenient primary-subtag match (a static rasterizer with user
        # language "en" should render systemLanguage="en-US" content)
        wanted = language.lower().split("-")[0]
        tags = [t.strip().lower() for t in langs.split(",") if t.strip()]
        if not any(t == wanted or t.split("-")[0] == wanted for t in tags):
            return False
    return True


def _local_tag(element) -> str:
    return element.tag.split("}")[-1]


def cascade_attrs(raw: dict, inherited: dict | None = None, css=None,
                  tag: str | None = None) -> dict:
    """Merge element attributes over inherited ones, expanding style="".

    With a parsed stylesheet (`css`, see parse_stylesheet) the SVG cascade
    order applies: presentation attributes < matched CSS rules (by
    specificity) < inline style="".  The reference ignores <style> blocks
    entirely.
    """
    attrs = dict(raw)
    style = attrs.pop("style", None)
    if css:
        attrs.update(match_rules(css, tag, attrs.get("class"), attrs.get("id")))
    if style is not None:
        for decl in style.split(";"):
            decl = decl.strip()
            if not decl:
                continue
            key, _, value = decl.partition(":")
            attrs[key.strip()] = value.strip()
    if inherited:
        attrs = {**inherited, **attrs}
    return attrs


def parse_stylesheet(text: str) -> list:
    """Minimal CSS for <style> blocks: tag / .class / #id simple selectors
    (the last simple selector of any combinator chain matches; pseudo
    classes and attribute selectors are skipped).  Returns rules sorted by
    (specificity, source order) ready for match_rules."""
    import re

    text = re.sub(r"/\*.*?\*/", "", text, flags=re.S)
    rules: list = []
    for block in text.split("}"):
        if "{" not in block:
            continue
        sel_part, _, body = block.partition("{")
        props = {}
        for decl in body.split(";"):
            key, _, value = decl.partition(":")
            if key.strip() and value.strip():
                props[key.strip()] = value.strip().removesuffix("!important").strip()
        if not props:
            continue
        for sel in sel_part.split(","):
            sel = sel.strip()
            if not sel or any(ch in sel for ch in ":[|"):
                continue  # unsupported selector features
            simple = re.split(r"[\s>+~]+", sel)[-1]
            m = re.fullmatch(r"(\*|[A-Za-z][\w-]*)?((?:[.#][\w-]+)*)", simple)
            if m is None or (m.group(1) is None and not m.group(2)):
                continue
            tag = m.group(1)
            classes: set = set()
            sel_id = None
            for tok in re.findall(r"[.#][\w-]+", m.group(2) or ""):
                if tok[0] == ".":
                    classes.add(tok[1:])
                else:
                    sel_id = tok[1:]
            spec = (
                (100 if sel_id else 0)
                + 10 * len(classes)
                + (1 if tag not in (None, "*") else 0)
            )
            rules.append((spec, len(rules), tag, classes, sel_id, props))
    rules.sort(key=lambda r: (r[0], r[1]))
    return rules


def match_rules(rules: list, tag, class_attr, elem_id) -> dict:
    """Properties of every rule matching (tag, class list, id), later
    (more specific) rules overriding earlier ones."""
    classes = set((class_attr or "").split())
    out: dict = {}
    for _spec, _order, rtag, rclasses, rid, props in rules:
        if rtag not in (None, "*") and rtag != tag:
            continue
        if rid is not None and rid != elem_id:
            continue
        if not rclasses <= classes:
            continue
        out.update(props)
    return out


def viewbox_transform(bbox, viewbox, par: str | None = None) -> Transform:
    """Transform fitting `viewbox` into `bbox` per preserveAspectRatio.

    bbox: (x, y, w, h) with w/h possibly None (derived from the viewbox
    aspect ratio); viewbox: (vx, vy, vw, vh); par: the
    preserveAspectRatio string ("xMidYMid meet" when None/invalid —
    "none" stretches, "slice" covers, xMin/xMid/xMax + YMin/YMid/YMax
    pick the anchor).  The reference hardwires centered meet.
    """
    vx, vy, vw, vh = viewbox
    x, y, w, h = bbox
    if w is None and h is None:
        w, h = vw, vh
    elif w is None:
        w = vw * h / vh
    elif h is None:
        h = vh * w / vw

    align, sizing = "xMidYMid", "meet"
    if par:
        parts = par.strip().split()
        if parts and (parts[0] == "none" or parts[0].startswith(("xMin", "xMid", "xMax"))):
            align = parts[0]
        if len(parts) > 1 and parts[1] in ("meet", "slice"):
            sizing = parts[1]
    if align == "none":
        sx, sy = w / vw, h / vh
        fx = fy = 0.0
    else:
        pick = max if sizing == "slice" else min
        sx = sy = pick(w / vw, h / vh)
        fx = {"xMin": 0.0, "xMid": 0.5, "xMax": 1.0}.get(align[:4], 0.5)
        fy = {"YMin": 0.0, "YMid": 0.5, "YMax": 1.0}.get(align[4:8], 0.5)
    return (
        Transform()
        .translate(x + (w - vw * sx) * fx, y + (h - vh * sy) * fy)
        .scale(sx, sy)
        .translate(-vx, -vy)
    )


def rect_path_data(x, y, width, height, rx=None, ry=None) -> str:
    """Lower a <rect> (optionally rounded) to SVG path data."""
    if rx is None and ry is None:
        rx = ry = 0.0
    elif rx is None:
        rx = ry
    elif ry is None:
        ry = rx
    rx = min(rx, width / 2)
    ry = min(ry, height / 2)
    rounded = rx > 0 and ry > 0
    parts = [f"M{x + rx:g},{y:g}", f"H{x + width - rx:g}"]
    if rounded:
        parts.append(f"A{rx:g},{ry:g} 0 0 1 {x + width:g},{y + ry:g}")
    parts.append(f"V{y + height - ry:g}")
    if rounded:
        parts.append(f"A{rx:g},{ry:g} 0 0 1 {x + width - rx:g},{y + height:g}")
    parts.append(f"H{x + rx:g}")
    if rounded:
        parts.append(f"A{rx:g},{ry:g} 0 0 1 {x:g},{y + height - ry:g}")
    parts.append(f"V{y + ry:g}")
    if rounded:
        parts.append(f"A{rx:g},{ry:g} 0 0 1 {x + rx:g},{y:g}")
    parts.append("z")
    return " ".join(parts)


def ellipse_path_data(cx, cy, rx, ry=None) -> str:
    """Lower a <circle>/<ellipse> to SVG path data (four arc quadrants)."""
    if rx is None and ry is None:
        return ""
    rx = ry if rx is None else rx
    ry = rx if ry is None else ry
    return " ".join(
        [
            f"M{cx + rx:g},{cy:g}",
            f"A{rx:g},{ry:g} 0 0 1 {cx:g},{cy + ry:g}",
            f"A{rx:g},{ry:g} 0 0 1 {cx - rx:g},{cy:g}",
            f"A{rx:g},{ry:g} 0 0 1 {cx:g},{cy - ry:g}",
            f"A{rx:g},{ry:g} 0 0 1 {cx + rx:g},{cy:g}",
            "z",
        ]
    )


# ------------------------------------------------------------------------------
# element handlers
# ------------------------------------------------------------------------------
def build_shape_scenes(attrs: dict, ids: dict, fg, path: Path | None = None) -> list:
    """Scenes (fill and/or stroke) for a path-bearing element."""
    if path is None:
        data = attrs.get("d")
        if data is None:
            return []
        path = Path.from_svg(data)

    parts: dict = {"fill": [], "stroke": [], "markers": []}
    group = parts["fill"]
    fill = attrs.get("fill")
    if fill is not None:
        fill = attrs.get("color") if fill == "currentColor" else parse_paint(fill, ids)
    elif fg is not None:
        fill = fg
    else:
        fill = np.array([0.0, 0.0, 0.0, 1.0], dtype=FLOAT)
    if fill is not None:
        scene = Scene.fill(path, fill, attrs.get("fill-rule", FILL_NONZERO))
        fill_opacity = parse_float(attrs.get("fill-opacity"))
        if fill_opacity is not None:
            scene = scene.opacity(fill_opacity)
        group.append(scene)

    stroke = attrs.get("stroke")
    stroke = attrs.get("color") if stroke == "currentColor" else parse_paint(stroke, ids)
    if stroke is not None:
        stroke_path = path
        dasharray = attrs.get("stroke-dasharray")
        if dasharray not in (None, "none"):
            dashes = parse_float_list(dasharray.replace("%", ""))
            if dashes and any(v > 0 for v in dashes):
                stroke_path = path.dash(
                    dashes, parse_float(attrs.get("stroke-dashoffset", "0")) or 0.0
                )
        linejoin = attrs.get("stroke-linejoin")
        miterlimit = parse_float(attrs.get("stroke-miterlimit"))
        if miterlimit is not None and linejoin in (None, "miter"):
            linejoin = ("miter", miterlimit)
        scene = Scene.stroke(
            stroke_path,
            stroke,
            parse_float(attrs.get("stroke-width", "1")),
            attrs.get("stroke-linecap"),
            linejoin,
        )
        stroke_opacity = parse_float(attrs.get("stroke-opacity"))
        if stroke_opacity is not None:
            scene = scene.opacity(stroke_opacity)
        parts["stroke"].append(scene)

    parts["markers"].extend(_marker_scenes(attrs, ids, path))

    # paint-order (SVG 2, beyond the reference): listed layers paint first,
    # omitted ones follow in normal order (fill, stroke, markers)
    order = [
        kw for kw in (attrs.get("paint-order") or "").split()
        if kw in parts
    ]
    order += [kw for kw in ("fill", "stroke", "markers") if kw not in order]
    return [scene for kw in order for scene in parts[kw]]


def _marker_scenes(attrs: dict, ids: dict, path: Path) -> list:
    """Instantiate marker-start/-mid/-end at the path's vertex frames.

    Beyond the reference's feature set (it lists markers as NOT SUPPORTED).
    Marker content is placed vertex-by-vertex: translate to the vertex,
    rotate by the orient rule (auto = tangent / bisector), scale by the
    stroke width for markerUnits=strokeWidth, fit the viewBox into the
    marker box, and anchor refX/refY at the vertex (SVG 1.1 11.6.2).
    Content outside the marker viewport is clipped unless the marker sets
    overflow: visible|auto (the UA default for marker is hidden).
    """
    import math

    refs = {}
    for pos in ("start", "mid", "end"):
        value = attrs.get(f"marker-{pos}", attrs.get("marker"))
        if value is None:
            continue
        target = parse_url(value, ids)
        if isinstance(target, tuple) and len(target) == 8 and target[0] == "marker":
            refs[pos] = target
    if not refs:
        return []

    sw = parse_float(attrs.get("stroke-width", "1")) or 1.0
    out: list = []
    subpaths = path.vertex_frames()
    for frames in subpaths:
        for i, (point, d_in, d_out) in enumerate(frames):
            pos = "start" if i == 0 else ("end" if i == len(frames) - 1 else "mid")
            marker = refs.get(pos)
            if marker is None:
                continue
            _kind, scene, view_box, (mw, mh), (rx, ry), orient, units, overflow = marker
            if overflow not in ("visible", "auto"):
                # clip to the marker viewport: content coordinates map onto
                # the (0, 0, mw, mh) box (through the viewBox fit when set)
                clip_box = view_box if view_box else (0.0, 0.0, mw, mh)
                clip = Scene.fill(
                    Path.from_svg(rect_path_data(*clip_box)), np.ones(4)
                )
                scene = scene.clip(clip)
            if isinstance(orient, str):
                dirs = [d for d in (d_in, d_out) if d is not None]
                if dirs:
                    mean = dirs[0] if len(dirs) == 1 else dirs[0] / np.linalg.norm(
                        dirs[0]
                    ) + dirs[1] / np.linalg.norm(dirs[1])
                    angle = math.atan2(mean[1], mean[0])
                else:
                    angle = 0.0
                if orient == "auto-start-reverse" and pos == "start":
                    angle += math.pi
            else:
                angle = orient
            tr = Transform().translate(point[0], point[1]).rotate(angle)
            if units == "strokeWidth":
                tr = tr.scale(sw)
            if view_box:
                vb_tr = viewbox_transform((0, 0, mw, mh), view_box)
                q = vb_tr(np.array([rx, ry], dtype=FLOAT))
                tr = tr.translate(-q[0], -q[1]) @ vb_tr
            else:
                tr = tr.translate(-rx, -ry)
            out.append(scene.transform(tr))
    return out


def build_gradient(element, is_linear: bool, ids: dict):
    """Parse a gradient element (handles href inheritance via the ids dict)."""
    attrs = element.attrib
    parent = None
    href = attrs.get("href") or next(
        (v for k, v in attrs.items() if k.endswith("}href")), None
    )
    if href and href.startswith("#"):
        parent = ids.get(href[1:])
    parent_fields = parent._asdict() if isinstance(parent, (GradLinear, GradRadial)) else {}

    transform = parse_transform(attrs.get("gradientTransform") or attrs.get("transform"))
    if transform is None:
        transform = parent_fields.get("transform")

    spread = attrs.get("spreadMethod", parent_fields.get("spread", "pad"))
    units = attrs.get("gradientUnits", UNITS_BBOX)
    bbox_units = units != UNITS_USER

    stops = parse_stops(element) or parent_fields.get("stops")
    if not stops:
        return None  # a gradient without stops paints nothing
    if len(stops) == 1:
        return stops[0][1]  # a single stop degrades to its solid color

    color_interp = attrs.get("color-interpolation")
    linear_rgb = {"linearRGB": True, "sRGB": False}.get(color_interp)

    if is_linear:
        p0 = np.array(
            [parse_float(attrs.get("x1", "0")), parse_float(attrs.get("y1", "0"))], dtype=FLOAT
        )
        p1 = np.array(
            [parse_float(attrs.get("x2", "1")), parse_float(attrs.get("y2", "0"))], dtype=FLOAT
        )
        return GradLinear(p0, p1, stops, transform, spread, bbox_units, linear_rgb)

    cx = parse_float(attrs.get("cx", "0.5"))
    cy = parse_float(attrs.get("cy", "0.5"))
    fx = parse_float(attrs.get("fx"))
    fy = parse_float(attrs.get("fy"))
    fcenter = None
    if fx is not None or fy is not None:
        fcenter = np.array([cx if fx is None else fx, cy if fy is None else fy], dtype=FLOAT)
    center = np.array([cx, cy], dtype=FLOAT)
    radius = parse_float(attrs.get("r")) or 0.5
    fradius = parse_float(attrs.get("fr"))
    return GradRadial(
        center, radius, fcenter, fradius, stops, transform, spread, bbox_units, linear_rgb
    )


def parse_stops(element) -> list:
    """Gradient <stop> children -> sorted [(offset, premult-linear rgba)]."""
    stops = []
    for child in element:
        if not child.tag.endswith("stop"):
            continue
        attrs = cascade_attrs(child.attrib)
        offset = parse_float(attrs.get("offset")) or 0.0
        offset = min(max(offset, 0.0), 1.0)
        color = parse_color(attrs.get("stop-color"))
        if color is None:
            continue
        opacity = attrs.get("stop-opacity")
        if opacity:
            color = color * float(opacity)
        stops.append((offset, color))
    stops.sort(key=lambda s: s[0])
    return stops


_COMPOSITE_MODES = {
    "over": COMPOSE_OVER,
    "in": COMPOSE_IN,
    "out": COMPOSE_OUT,
    "atop": COMPOSE_ATOP,
    "xor": COMPOSE_XOR,
}


def load_image_resource(href: str, base: str | None):
    """Resolve a feImage href to ("scene", Scene) or ("raster", (H, W, 4)
    uint8 straight-alpha sRGB) — data: URIs (base64 or URL-encoded PNG /
    SVG) and local file paths relative to the document.  Network URLs are
    not fetched (warn + None)."""
    import base64
    import urllib.parse

    from ..core.png import read_png

    try:
        if href.startswith("data:"):
            head, _, payload = href.partition(",")
            mime = head[5:]
            data = (
                base64.b64decode(payload)
                if ";base64" in mime
                else urllib.parse.unquote_to_bytes(payload)
            )
            if "image/svg" in mime:
                scene, _ids, size = scene_from_str(data.decode("utf-8"))
                return ("scene", (scene, size)) if scene is not None else None
            if "image/png" in mime:
                return "raster", read_png(data)
            warnings.warn(f"unsupported data: media type {mime.split(';')[0]!r}")
            return None
        if href.startswith(("http:", "https:")):
            warnings.warn(f"network image resources are not fetched: {href!r}")
            return None
        path = href if os.path.isabs(href) else os.path.join(base or ".", href)
        ext = os.path.splitext(path)[1].lower()
        if ext in (".svg", ".svgz", ".gz"):
            scene, _ids, size = scene_from_filepath(path)
            return ("scene", (scene, size)) if scene is not None else None
        with open(path, "rb") as file:
            return "raster", read_png(file)
    except (OSError, ValueError, NotImplementedError) as exc:
        warnings.warn(f"failed to load image resource {href!r}: {exc}")
        return None


def build_filter(element, ids: dict) -> Filter:
    """Parse a <filter> element into the SSA-style Filter op list.

    ids: the document id registry (feImage resolves #fragments against it).
    color-interpolation-filters selects the operating space (the spec
    default is linearRGB; Inkscape exports routinely set sRGB — the
    reference supports only linearRGB).
    """
    interp = cascade_attrs(element.attrib).get("color-interpolation-filters", "")
    flt = Filter.empty(linear=interp != "sRGB")
    for child in element:
        tag = _local_tag(child)
        attrs = child.attrib
        result = attrs.get("result")
        input_ = attrs.get("in")
        n_before = len(flt.filters)

        if tag == "feOffset":
            flt = flt.offset(
                parse_float(attrs.get("dx", "0")), parse_float(attrs.get("dy", "0")), input_, result
            )
        elif tag == "feGaussianBlur":
            stds = parse_float_list(attrs.get("stdDeviation"), 1, 2)
            if stds:
                std_x = stds[0]
                std_y = stds[1] if len(stds) > 1 else stds[0]
                flt = flt.blur(std_x, std_y, input_, result)
        elif tag == "feMerge":
            names = [
                node.get("in") for node in child if _local_tag(node) == "feMergeNode"
            ]
            flt = flt.merge(names, result)
        elif tag == "feBlend":
            flt = flt.blend(input_, attrs.get("in2"), attrs.get("mode"), result)
        elif tag == "feComposite":
            operator = attrs.get("operator", "over")
            if operator == "arithmetic":
                mode = tuple(
                    parse_float(attrs.get(k, "0")) for k in ("k1", "k2", "k3", "k4")
                )
            else:
                mode = _COMPOSITE_MODES.get(operator)
                if mode is None:
                    warnings.warn(f"unsupported composite operator: {operator}")
                    mode = COMPOSE_OVER
            flt = flt.composite(input_, attrs.get("in2"), mode, result)
        elif tag == "feColorMatrix":
            kind = attrs.get("type", "matrix")
            values = attrs.get("values")
            matrix = None
            if kind == "matrix":
                matrix = (
                    np.eye(4, 5)
                    if values is None
                    else np.array(parse_float_list(values, 20, 20)).reshape(4, 5)
                )
            elif kind == "saturate":
                matrix = color_matrix_saturate(1.0 if values is None else parse_float(values))
            elif kind == "hueRotate":
                matrix = color_matrix_hue_rotate(0.0 if values is None else parse_angle(values))
            elif kind == "luminanceToAlpha":
                matrix = COLOR_MATRIX_LUM
            else:
                warnings.warn(f"unsupported color matrix type: {kind}")
            if matrix is not None:
                flt = flt.color_matrix(input_, matrix, result)
        elif tag == "feMorphology":
            operator = attrs.get("operator", "erode")
            method = {"erode": "min", "dilate": "max"}.get(operator)
            if method is None:
                warnings.warn(f"invalid morphology operator: {operator}")
                continue
            radius = parse_float_list(attrs.get("radius", "0"), 1, 2)
            rx = radius[0]
            ry = radius[1] if len(radius) > 1 else rx
            if rx > 0 and ry > 0:
                flt = flt.morphology(rx, ry, method, input_, result)
        elif tag == "feFlood":
            flt = flt.flood(_flood_color(attrs), _fe_region(attrs), result)
        elif tag == "feTile":
            flt = flt.tile(input_, result)
        elif tag == "feComponentTransfer":
            funcs = {}
            for node in child:
                chan = {"feFuncR": 0, "feFuncG": 1, "feFuncB": 2, "feFuncA": 3}.get(
                    _local_tag(node)
                )
                if chan is None:
                    continue
                fn = _transfer_func(node.attrib)
                if fn is not None:
                    funcs[chan] = fn
            flt = flt.component_transfer(funcs, input_, result)
        elif tag == "feTurbulence":
            freq = parse_float_list(attrs.get("baseFrequency", "0"), 1, 2)
            fx = freq[0]
            fy = freq[1] if len(freq) > 1 else fx
            flt = flt.turbulence(
                fx, fy,
                octaves=int(parse_float(attrs.get("numOctaves", "1"))),
                seed=int(parse_float(attrs.get("seed", "0"))),
                fractal=attrs.get("type") == "fractalNoise",
                region=_fe_region(attrs),
                result=result,
            )
        elif tag == "feConvolveMatrix":
            order = parse_float_list(attrs.get("order", "3"), 1, 2)
            ox = int(order[0])
            oy = int(order[1]) if len(order) > 1 else ox
            values = parse_float_list(attrs.get("kernelMatrix"))
            if not values or len(values) != ox * oy:
                warnings.warn("feConvolveMatrix needs kernelMatrix of order X*Y")
                continue
            if attrs.get("edgeMode", "duplicate") != "none":
                warnings.warn("feConvolveMatrix edgeMode degrades to 'none'")
            divisor = attrs.get("divisor")
            flt = flt.convolve_matrix(
                np.array(values).reshape(oy, ox),
                divisor=None if divisor is None else parse_float(divisor),
                bias=parse_float(attrs.get("bias", "0")),
                preserve_alpha=attrs.get("preserveAlpha") == "true",
                input=input_,
                result=result,
            )
        elif tag == "feDisplacementMap":
            chan = {"R": 0, "G": 1, "B": 2, "A": 3}
            flt = flt.displacement_map(
                parse_float(attrs.get("scale", "0")),
                chan.get(attrs.get("xChannelSelector", "A"), 3),
                chan.get(attrs.get("yChannelSelector", "A"), 3),
                input_,
                attrs.get("in2"),
                result,
            )
        elif tag == "feImage":
            href = attrs.get("href") or next(
                (v for k, v in attrs.items() if k.endswith("}href")), None
            )
            target = ids.get(href[1:]) if href and href.startswith("#") else None
            if isinstance(target, Scene):
                # intra-document fragment; x/y place it, scaling to the
                # subregion is not applied (fragments have no intrinsic size)
                flt = flt.image(target, _fe_region(attrs), result)
            elif href and not href.startswith("#"):
                resource = load_image_resource(href, ids.get("\x00base"))
                if resource is None:
                    continue
                kind_r, payload = resource
                if kind_r == "scene":
                    flt = flt.image(payload[0], _fe_region(attrs), result)
                else:
                    flt = flt.image(("raster", payload), _fe_region(attrs), result)
            else:
                warnings.warn(f"feImage reference not resolvable: {href!r}")
        elif tag in ("feDiffuseLighting", "feSpecularLighting"):
            light = _light_source(child)
            if light is None:
                warnings.warn(f"{tag} needs a light source child")
                continue
            color = parse_color(attrs.get("lighting-color", "white"))
            if color is None:
                color = np.array([1.0, 1.0, 1.0, 1.0])
            color = color.copy()
            if color[3] > 0:
                color[:3] /= color[3]
            ss = parse_float(attrs.get("surfaceScale", "1"))
            if tag == "feDiffuseLighting":
                flt = flt.diffuse_lighting(
                    ss, parse_float(attrs.get("diffuseConstant", "1")),
                    color[:3], light, input_, result,
                )
            else:
                flt = flt.specular_lighting(
                    ss, parse_float(attrs.get("specularConstant", "1")),
                    parse_float(attrs.get("specularExponent", "1")),
                    color[:3], light, input_, result,
                )
        elif tag == "feDropShadow":
            stds = parse_float_list(attrs.get("stdDeviation", "2"), 1, 2)
            flt = flt.drop_shadow(
                parse_float(attrs.get("dx", "2")),
                parse_float(attrs.get("dy", "2")),
                stds[0],
                _flood_color(attrs),
                input_,
                result,
            )
        else:
            warnings.warn(f"unsupported filter primitive: {tag}")
        if len(flt.filters) > n_before:
            # x/y/width/height subregion clips the primitive's result
            # (SVG 15.7.5; the reference ignores subregions)
            flt = flt.set_region(_fe_region(attrs))
    return flt


def _flood_color(attrs) -> np.ndarray:
    """flood-color/flood-opacity -> straight-alpha linear-RGB (4,)."""
    color = parse_color(attrs.get("flood-color", "black"))
    if color is None:
        color = np.array([0.0, 0.0, 0.0, 1.0])
    color = color.copy()
    if color[3] > 0:
        color[:3] /= color[3]  # parse_color returns premultiplied
    color[3] *= parse_float(attrs.get("flood-opacity", "1"))
    return color


def _fe_region(attrs):
    """Explicit primitive subregion (x, y, width, height) in user units."""
    if not all(k in attrs for k in ("x", "y", "width", "height")):
        return None
    vals = [parse_float(attrs[k]) for k in ("x", "y", "width", "height")]
    if any(v is None for v in vals) or vals[2] <= 0 or vals[3] <= 0:
        return None
    return tuple(vals)


def _light_source(element):
    """First light-source child of a lighting primitive -> light tuple."""
    import math

    for node in element:
        tag = _local_tag(node)
        attrs = node.attrib
        if tag == "feDistantLight":
            return (
                "distant",
                math.radians(parse_float(attrs.get("azimuth", "0"))),
                math.radians(parse_float(attrs.get("elevation", "0"))),
            )
        if tag == "fePointLight":
            return (
                "point",
                parse_float(attrs.get("x", "0")),
                parse_float(attrs.get("y", "0")),
                parse_float(attrs.get("z", "0")),
            )
        if tag == "feSpotLight":
            cone = attrs.get("limitingConeAngle")
            return (
                "spot",
                parse_float(attrs.get("x", "0")),
                parse_float(attrs.get("y", "0")),
                parse_float(attrs.get("z", "0")),
                parse_float(attrs.get("pointsAtX", "0")),
                parse_float(attrs.get("pointsAtY", "0")),
                parse_float(attrs.get("pointsAtZ", "0")),
                parse_float(attrs.get("specularExponent", "1")),
                None if cone is None else math.radians(parse_float(cone)),
            )
    return None


def _transfer_func(attrs):
    """One feFunc[RGBA] element -> (kind, *params) or None for identity."""
    kind = attrs.get("type", "identity")
    if kind == "identity":
        return None
    if kind in ("table", "discrete"):
        values = parse_float_list(attrs.get("tableValues", ""))
        return (kind, values) if values else None
    if kind == "linear":
        return (
            "linear",
            parse_float(attrs.get("slope", "1")),
            parse_float(attrs.get("intercept", "0")),
        )
    if kind == "gamma":
        return (
            "gamma",
            parse_float(attrs.get("amplitude", "1")),
            parse_float(attrs.get("exponent", "1")),
            parse_float(attrs.get("offset", "0")),
        )
    warnings.warn(f"unknown transfer function type: {kind}")
    return None


def build_font(element) -> Font | None:
    """Parse an SVG <font> element (font-face, glyphs, missing-glyph, hkern)."""
    glyphs: dict[str, Glyph] = {}
    by_name: dict[str, Glyph] = {}
    hkern: dict[tuple[str, str], float] = {}
    missing: Glyph | None = None
    font: Font | None = None

    for child in element:
        tag = _local_tag(child)
        attrs = cascade_attrs(child.attrib, element.attrib)

        if tag == "glyph":
            unicode = attrs.get("unicode")
            advance = attrs.get("horiz-adv-x")
            if unicode is None or advance is None:
                continue
            glyph = Glyph(unicode, float(advance), attrs.get("d", ""), attrs.get("glyph-name"))
            glyphs[unicode] = glyph
            if glyph.name:
                by_name[glyph.name] = glyph

        elif tag == "missing-glyph":
            advance = attrs.get("horiz-adv-x")
            if advance is not None:
                missing = Glyph(None, float(advance), attrs.get("d", ""), "missing-glyph")

        elif tag == "font-face":
            units_per_em = float(attrs.get("units-per-em", "2048"))
            font = Font(
                family=attrs.get("font-family", f"font-{id(element):x}"),
                weight=font_weight(attrs.get("font-weight")),
                style=attrs.get("font-style", FONT_STYLE_NORMAL),
                ascent=float(attrs.get("ascent", units_per_em)),
                descent=float(attrs.get("descent", "0")),
                units_per_em=units_per_em,
                glyphs={},
                missing_glyph=None,
                hkern={},
            )

        elif tag == "hkern":
            kern = attrs.get("k")
            if kern is None:
                continue
            left: list[str] = []
            right: list[str] = []
            for target, u_key, g_key in ((left, "u1", "g1"), (right, "u2", "g2")):
                unicodes = attrs.get(u_key)
                if unicodes:
                    target.extend(u for u in unicodes.split(",") if u)
                names = attrs.get(g_key)
                if names:
                    for name in filter(None, names.split(",")):
                        glyph = by_name.get(name)
                        if glyph is not None and glyph.unicode:
                            target.append(glyph.unicode)
            value = float(kern)
            for l in left:
                for r in right:
                    hkern[(l, r)] = value

    if font is None:
        warnings.warn("<font> without <font-face>")
        return None
    font.glyphs.update(glyphs)
    font.hkern.update(hkern)
    font.missing_glyph = missing
    return font


def _text_path_scenes(element, attrs: dict, fonts: FontsDB, ids: dict, fg) -> list:
    """Lay glyphs along a referenced path (SVG 1.1 10.13.2).

    Beyond both the reference (textPath listed as not supported,
    svgrasterize.py:9-13) and SVG Tiny: method="align"
    (default) rotates each glyph rigidly to the path tangent at its
    advance midpoint; method="stretch" warps every glyph outline point
    along the path (arc-length position + normal offset), so glyphs bend
    with the curve.  Glyphs whose midpoints fall off the path are not
    rendered.  startOffset supports user units and %-of-path-length;
    spacing is parsed ("auto" renders like the default "exact", which the
    spec permits).  <tspan> children are styled runs: each run cascades
    its own fill/font-* attributes (plus dx, an extra shift along the
    path) and continues the pen from the previous run's arc position.
    tspan x re-anchors the pen arc-length (with y: to the projection of
    the new point onto the path); dy shifts the baseline along the path
    normal.  The reference supports none of this
    (svgrasterize.py:9-13).
    """
    import math

    href = attrs.get("href") or next(
        (v for k, v in element.attrib.items() if k.endswith("}href")), None
    )
    if not href or not href.startswith("#"):
        warnings.warn(f"textPath needs a #fragment href: {href!r}")
        return []
    target = ids.get(href[1:])
    if not isinstance(target, Scene):
        warnings.warn(f"textPath reference is not a shape: {href!r}")
        return []
    path = target.to_path(Transform())
    polys = path.polylines(tolerance=0.1)
    if not polys:
        return []
    points = np.concatenate([p for p, _closed in polys], axis=0)
    seg_vec = points[1:] - points[:-1]
    seg_len = np.linalg.norm(seg_vec, axis=1)
    cum = np.concatenate([[0.0], np.cumsum(seg_len)])
    total = float(cum[-1])
    if total <= 0:
        return []

    # styled runs: the textPath's own text, then tspan children (with the
    # usual attribute cascade), tails in the parent's style — document order.
    # tspan x/y/dy become ("pos", …) repositioning events in the stream:
    # x re-anchors the pen's arc length (with y too, to the projection of
    # the new point onto the path), dy shifts the baseline along the
    # normal.  The cascade copies parent attrs wholesale, so positional
    # keys are POPPED when their element's event is emitted — nested
    # tspans must not re-apply them.
    runs: list = []

    def _collect(node, node_attrs, top=False):
        pos = {
            key: node_attrs.pop(key)
            for key in ("x", "y", "dx", "dy")
            if key in node_attrs
        }
        # the textPath's own x/y (inherited from <text>) are consumed by
        # the <text> layout, not re-applied here; its dx still applies
        if top:
            pos = {k: v for k, v in pos.items() if k == "dx"}
        if pos:
            runs.append(("pos", pos, None))
        if node.text:
            runs.append(("text", node.text, node_attrs))
        for child in node:
            if _local_tag(child) == "tspan":
                child_attrs = cascade_attrs(
                    child.attrib, node_attrs, ids.get("\x00css"), "tspan"
                )
                _collect(child, child_attrs)
            if child.tail:
                runs.append(("text", child.tail, node_attrs))

    _collect(element, dict(attrs), top=True)
    if not runs:
        return []

    start = attrs.get("startOffset", "0")
    if isinstance(start, str) and start.strip().endswith("%"):
        start_offset = total * float(start.strip()[:-1]) / 100.0
    else:
        start_offset = parse_size(start) or 0.0

    stretch = element.get("method", attrs.get("method", "align")) == "stretch"

    safe_len = np.where(seg_len > 1e-12, seg_len, 1.0)
    unit = seg_vec / safe_len[:, None]                     # (S, 2) tangents

    def warp(pts: np.ndarray) -> np.ndarray:
        """Map glyph-space points (x = arc length along the path, y =
        signed normal offset) onto the path."""
        s = np.clip(pts[:, 0], 0.0, total)
        seg = np.clip(np.searchsorted(cum, s, side="right") - 1, 0, len(seg_len) - 1)
        frac = (s - cum[seg]) / safe_len[seg]
        pos = points[seg] + seg_vec[seg] * frac[:, None]
        t = unit[seg]
        normal = np.stack([-t[:, 1], t[:, 0]], axis=1)
        return pos + normal * pts[:, 1:2]

    def place_run(text, run_attrs, pen_u, v_off=0.0):
        """Lay one styled run starting at arc position pen_u (user units);
        v_off shifts the baseline along the path normal (tspan dy).
        Returns (subpaths, next pen_u)."""
        size = parse_float(run_attrs.get("font-size", str(DEFAULT_FONT_SIZE)))
        font = fonts.resolve(
            run_attrs.get("font-family"),
            font_weight(run_attrs.get("font-weight")),
            run_attrs.get("font-style"),
        )
        if font is None:
            return [], pen_u
        scale = size / font.units_per_em
        glyph_scale = Transform().scale(scale, -scale)
        placed, advance = font.shape(text)

        subpaths: list = []
        for pen, glyph in placed:
            width = glyph.advance * scale
            base = pen_u + pen * scale
            mid = base + width / 2
            if mid < 0 or mid > total:
                continue  # off-path glyphs are not rendered (spec)
            if stretch:
                # x-advance becomes arc length: warp every outline point
                # (curve control points included — the standard
                # approximation; arcs expand to cubics first, their params
                # are not points)
                from ..geom import arc as arc_ops
                from ..geom.path import PATH_ARC, PATH_CUBIC

                flat = glyph.path.transform(
                    Transform().translate(base, v_off) @ glyph_scale
                )
                for sub in flat.subpaths:
                    warped = []
                    for kind, payload in sub:
                        if kind == PATH_ARC:
                            for cub in arc_ops.to_cubics(*payload):
                                pts = warp(np.asarray(cub, dtype=FLOAT))
                                warped.append((PATH_CUBIC, pts.tolist()))
                        else:
                            pts = warp(np.asarray(payload, dtype=FLOAT))
                            warped.append((kind, pts.tolist()))
                    subpaths.append(warped)
                continue
            seg = min(np.searchsorted(cum, mid, side="right") - 1, len(seg_len) - 1)
            if seg_len[seg] <= 1e-12:
                continue
            frac = (mid - cum[seg]) / seg_len[seg]
            point = points[seg] + seg_vec[seg] * frac
            angle = math.atan2(seg_vec[seg][1], seg_vec[seg][0])
            tr = (
                Transform()
                .translate(point[0], point[1])
                .rotate(angle)
                .translate(-width / 2, v_off)
                @ glyph_scale
            )
            subpaths.extend(glyph.path.transform(tr).subpaths)
        return subpaths, pen_u + advance * scale

    def _first_size(raw):
        """First value of a possibly list-valued positional attribute
        (runs shape whole, so only the run-level position applies)."""
        if raw is None:
            return None
        try:
            vals = parse_float_list(raw)
        except ValueError:
            vals = None
        if vals:
            return float(vals[0])
        return parse_size(raw)

    scenes: list = []
    pen_u = start_offset
    v_off = 0.0
    prev_space = True  # leading whitespace never renders
    for kind_r, payload, run_attrs in runs:
        if kind_r == "pos":
            # x re-anchors the pen's arc position (SVG 1.1 10.13.2: a new
            # absolute offset along the path); with y too, the new point
            # projects onto the path (closest point) — the reference
            # ignores both (svgrasterize.py:9-13)
            x = _first_size(payload.get("x"))
            y = _first_size(payload.get("y"))
            if x is not None and y is not None:
                p = np.array([x, y], dtype=FLOAT)
                rel = p[None, :] - points[:-1]
                t = np.clip(
                    (rel * seg_vec).sum(1) / (safe_len * safe_len), 0.0, 1.0
                )
                foot = points[:-1] + seg_vec * t[:, None]
                d2 = ((p[None, :] - foot) ** 2).sum(1)
                seg = int(np.argmin(d2))
                pen_u = float(cum[seg] + t[seg] * seg_len[seg])
            elif x is not None:
                pen_u = x
            dx = _first_size(payload.get("dx"))
            if dx is not None:
                pen_u += dx
            dy = _first_size(payload.get("dy"))
            if dy is not None:
                v_off += dy
            continue
        text = payload.replace("\n", " ")
        lead = " " if text[0] in " \t" and not prev_space else ""
        trail = " " if text[-1] in " \t" else ""
        collapsed = " ".join(filter(None, text.strip().split()))
        if not collapsed:
            if not lead:
                continue
            collapsed = " "  # whitespace-only run: one inter-run space
        else:
            collapsed = lead + collapsed + trail
        prev_space = bool(trail) or not collapsed.strip()
        run_attrs = dict(run_attrs)
        run_attrs.pop("dx", None)  # consumed by the element's pos event
        subpaths, pen_u = place_run(collapsed, run_attrs, pen_u, v_off)
        if subpaths:
            scenes.extend(build_shape_scenes(run_attrs, ids, fg, Path(subpaths)))
    return scenes


def build_text(element, attrs: dict, fonts: FontsDB, ids: dict, fg) -> list:
    """Lower a <text> element (with nested tspans) into glyph-path scenes.

    Whitespace handling: runs of whitespace collapse to single spaces; a
    leading/trailing space is preserved only when it glues adjacent chunks.
    """

    def pos_lists(run_attrs):
        """Pop x/dx/y/dy as (scalar, per-char list) pairs.

        SVG allows whitespace/comma-separated lists that position each
        character individually (beyond the reference, which crashes on
        them); a single value keeps the full parse_size unit handling.
        """
        out = {}
        for key in ("x", "dx", "y", "dy"):
            raw = run_attrs.pop(key, None)
            if raw is None:
                out[key] = (None, None)
                continue
            try:
                vals = parse_float_list(raw)
            except ValueError:
                vals = None  # unit-suffixed scalar, e.g. "12px"
            if vals is not None and len(vals) > 1:
                out[key] = (vals[0], vals)
            else:
                out[key] = (parse_size(raw), None)
        return out

    def layout_run(text, run_attrs, pen, pending_space):
        # NOTE: pops mutate run_attrs on purpose — x/y/dx/dy reposition the
        # pen once per element; later runs of the same element must not
        # re-apply them (they continue from the advanced pen position).
        pen_x, pen_y = pen
        pos = pos_lists(run_attrs)
        x, x_list = pos["x"]
        if x is not None:
            pen_x = x
        dx, dx_list = pos["dx"]
        if dx is not None:
            pen_x += dx
        y, y_list = pos["y"]
        if y is not None:
            pen_y = y
        dy, dy_list = pos["dy"]
        if dy is not None:
            pen_y += dy

        # visibility: hidden suppresses the glyphs but NOT the pen advance
        # (layout is unaffected; a nested tspan can reset to visible since
        # visibility is in INHERITED_ATTRS).  display: none is handled in
        # the element walk below — it prunes layout too.
        hidden = run_attrs.get("visibility", "").strip().lower() in (
            "hidden", "collapse"
        )

        if not text:
            return [], (pen_x, pen_y), pending_space

        text = text.replace("\n", " ")
        if run_attrs.get(
            "{http://www.w3.org/XML/1998/namespace}space"
        ) == "preserve":
            # xml:space="preserve" (beyond the reference): newlines/tabs
            # become spaces but runs of spaces stay verbatim
            collapsed = text.replace("\t", " ")
            if not collapsed:
                return [], (pen_x, pen_y), pending_space
            trail = " " if collapsed.endswith(" ") else ""
        else:
            lead = (
                " " if text[0] in " \t" and len(text) > 1 and not pending_space
                else ""
            )
            trail = " " if text[-1] in " \t" else ""
            collapsed = " ".join(filter(None, text.strip().split()))
            if not collapsed:
                return [], (pen_x, pen_y), pending_space
            collapsed = lead + collapsed + trail

        size = parse_float(run_attrs.get("font-size", str(DEFAULT_FONT_SIZE)))
        font = fonts.resolve(
            run_attrs.get("font-family"),
            font_weight(run_attrs.get("font-weight")),
            run_attrs.get("font-style"),
        )
        if font is None:
            return [], (pen_x, pen_y), pending_space

        if any(lst is not None for lst in (x_list, dx_list, y_list, dy_list)):
            # per-character positioning: each char shapes alone (explicit
            # positions break ligatures, as in browsers) and the lists
            # apply per SVG 1.1 10.5 — exhausted lists continue the pen
            subpaths: list = []
            for i, ch in enumerate(collapsed):
                if x_list is not None and i > 0 and i < len(x_list):
                    pen_x = x_list[i]
                if dx_list is not None and i > 0 and i < len(dx_list):
                    pen_x += dx_list[i]
                if y_list is not None and i > 0 and i < len(y_list):
                    pen_y = y_list[i]
                if dy_list is not None and i > 0 and i < len(dy_list):
                    pen_y += dy_list[i]
                ch_path, ch_adv = font.str_to_path(size, ch)
                if ch_path.subpaths:
                    move = Transform().translate(pen_x, pen_y)
                    subpaths.extend(ch_path.transform(move).subpaths)
                pen_x += ch_adv
            scenes = (
                build_shape_scenes(run_attrs, ids, fg, Path(subpaths))
                if subpaths and not hidden else []
            )
            return scenes, (pen_x, pen_y), bool(trail)

        path, advance = font.str_to_path(size, collapsed)

        move = Transform().translate(pen_x, pen_y)
        scenes = [] if hidden else [
            s.transform(move) for s in build_shape_scenes(run_attrs, ids, fg, path)
        ]
        return scenes, (pen_x + advance, pen_y), bool(trail)

    def walk(node, node_attrs, pen, pending_space):
        scenes, pen, pending_space = layout_run(node.text, node_attrs, pen, pending_space)
        for child in node:
            if _local_tag(child) in ("tspan", "text"):
                child_attrs = cascade_attrs(
                    child.attrib, node_attrs, ids.get("\x00css"), _local_tag(child)
                )
                # display: none prunes the subtree INCLUDING its pen advance
                # (unlike visibility, which only hides glyphs — layout_run)
                if child_attrs.get("display", "").strip().lower() == "none":
                    tail, pen, pending_space = layout_run(
                        child.tail, node_attrs, pen, pending_space
                    )
                    scenes.extend(tail)
                    continue
                sub, pen, pending_space = walk(child, child_attrs, pen, pending_space)
                scenes.extend(sub)
            elif _local_tag(child) == "textPath":
                child_attrs = cascade_attrs(
                    child.attrib, node_attrs, ids.get("\x00css"), "textPath"
                )
                if child_attrs.get("display", "").strip().lower() != "none":
                    scenes.extend(
                        _text_path_scenes(child, child_attrs, fonts, ids, fg)
                    )
            tail, pen, pending_space = layout_run(child.tail, node_attrs, pen, pending_space)
            scenes.extend(tail)
        return scenes, pen, pending_space

    raw_start = attrs.get("x", "0")
    try:
        start_vals = parse_float_list(raw_start)
        start_x = start_vals[0] if start_vals else 0.0
    except ValueError:
        start_x = parse_size(raw_start) or 0.0  # unit-suffixed scalar
    scenes, (end_x, _end_y), _space = walk(element, attrs, (0.0, 0.0), True)

    anchor = attrs.get("text-anchor")
    shift = None
    if anchor == "middle":
        shift = Transform().translate((start_x - end_x) / 2, 0)
    elif anchor == "end":
        shift = Transform().translate(start_x - end_x, 0)
    if shift is not None:
        scenes = [s.transform(shift) for s in scenes]
    return scenes


# ------------------------------------------------------------------------------
# document walker
# ------------------------------------------------------------------------------
class _IdRegistry(dict):
    """The document id registry, with an opt-in miss counter.

    During the forward-reference pre-pass every url(#)/href resolution
    funnels through .get(); counting the round-1 misses bounds the longest
    unresolved definition chain, which sets how many repair rounds the
    pre-pass needs (a→b→c declared later needs one round per link)."""

    counting = False

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.misses = 0

    def get(self, key, default=None):
        # "\x00"-prefixed keys are internal plumbing (css/base), not ids
        if self.counting and key not in self and not str(key).startswith("\x00"):
            self.misses += 1
        return super().get(key, default)


def scene_from_xml(file, fg=None, width=None, fonts: FontsDB | None = None,
                   base: str | None = None):
    """Build a Scene from an SVG file object.

    Returns (scene | None, ids, size) where ids maps element ids to the
    objects they defined (scenes, gradients, patterns, filters, clip tuples)
    and size is the top-level (width, height) if the document declares one.
    base: directory external resource references (feImage) resolve against.
    """
    fonts = FontsDB() if fonts is None else fonts
    ids: dict = _IdRegistry({"\x00base": base})
    doc_size: list = [None]
    prepass_mode: list = [False]  # True while the definition pre-pass walks
    # current viewport (w, h) for resolving percentage lengths (SVG 1.1
    # 7.10) — pushed per <svg> from its viewBox / negotiated size; the
    # reference has no such notion and mis-scales "%" with a warning
    # (svgrasterize.py:3546-3548)
    vp_stack: list = [None]

    def psize(text, axis="d", default=None):
        vp = vp_stack[-1]
        ref = None
        if vp is not None:
            vw_, vh_ = vp
            if axis == "x":
                ref = vw_
            elif axis == "y":
                ref = vh_
            else:
                ref = float(np.hypot(vw_, vh_)) / float(np.sqrt(2.0))
        return parse_size(text, default, percent_ref=ref)

    def walk(element, inherited, top=False, forced_width=None):
        tag = _local_tag(element)
        attrs = cascade_attrs(element.attrib, inherited, ids.get("\x00css"), tag)
        inherit_down = {k: v for k, v in attrs.items() if k in INHERITED_ATTRS}

        if tag not in _DEFINITION_TAGS:
            # display: none removes the whole subtree (no visibility-style
            # override in descendants); conditional processing attributes
            # apply to any rendered element, not only <switch> children
            # (SVG 1.1 5.8).  Both are beyond the reference.
            if attrs.get("display", "").strip().lower() == "none":
                return []
            if not conditional_ok(attrs):
                return []
        if (
            tag in _VISIBILITY_LEAF_TAGS
            and attrs.get("visibility", "").strip().lower()
            in ("hidden", "collapse")
        ):
            return []

        group: list = []
        if tag == "svg":
            # negotiate the viewport BEFORE walking children so their
            # percentage lengths resolve against it
            declared = parse_float_list(attrs.get("viewBox"), 4, 4)
            if top and declared and vp_stack[-1] is None:
                # standalone root: percentages on the <svg> itself resolve
                # against its own viewBox (e.g. rust.svg width="100%");
                # 100% means "intrinsic size" — leave unset so the
                # negotiation below keeps the exact (fractional) viewBox
                # aspect instead of pre-truncating
                def _root_len(text, axis):
                    if text is not None and text.strip().endswith("%") and \
                            abs(float(text.strip()[:-1]) - 100.0) < 1e-9:
                        return None
                    return psize(text, axis)

                vp_stack.append((declared[2], declared[3]))
                try:
                    x = psize(attrs.get("x", "0"), "x")
                    y = psize(attrs.get("y", "0"), "y")
                    w = _root_len(attrs.get("width"), "x")
                    h = _root_len(attrs.get("height"), "y")
                finally:
                    vp_stack.pop()
            else:
                x = psize(attrs.get("x", "0"), "x")
                y = psize(attrs.get("y", "0"), "y")
                w = psize(attrs.get("width"), "x")
                h = psize(attrs.get("height"), "y")
            viewbox = None
            if w is not None and h is not None:
                viewbox = [0, 0, w, h]
            if forced_width is not None:
                if w is not None and h is not None:
                    w, h = forced_width, int(forced_width * h / w)
                else:
                    w, h = forced_width, None
            viewbox = declared or viewbox
            if viewbox is not None:
                vp_stack.append((viewbox[2], viewbox[3]))
            elif w is not None and h is not None:
                vp_stack.append((w, h))
            else:
                vp_stack.append(vp_stack[-1])
            try:
                for child in element:
                    group.extend(walk(child, inherit_down))
            finally:
                vp_stack.pop()
            if not group:
                return group
            scene = Scene.group(group)

            if viewbox is not None:
                scene = scene.transform(viewbox_transform(
                    (x, y, w, h), viewbox, attrs.get("preserveAspectRatio")
                ))
                _vx, _vy, vw, vh = viewbox
                if w is None and h is None:
                    w, h = vw, vh
                elif h is None:
                    h = vh * w / vw
                elif w is None:
                    w = vw * h / vh
            elif x > 0 and y > 0:
                scene = scene.transform(Transform().translate(x, y))

            if w is not None and h is not None:
                if top:
                    doc_size[0] = (w, h)
                else:
                    frame = [
                        (PATH_LINE, [[x, y], [x + w, y]]),
                        (PATH_LINE, [[x + w, y], [x + w, y + h]]),
                        (PATH_LINE, [[x + w, y + h], [x, y + h]]),
                        (PATH_CLOSED, [[x, y + h], [x, y]]),
                    ]
                    scene = scene.clip(Scene.fill(Path([frame]), np.ones(4)))
            group = [scene]

        elif tag == "path":
            group.extend(build_shape_scenes(attrs, ids, fg))

        elif tag in ("g", "a"):
            # <a> renders as a transparent container (links have no visual
            # effect in a static rasterizer); the reference warns and drops
            # the anchor's graphic children
            for child in element:
                group.extend(walk(child, inherit_down))

        elif tag == "switch":
            # beyond the reference: render the FIRST direct child whose
            # conditional attributes evaluate true (SVG 1.1 5.8.1) —
            # the standard vector-fallback idiom of Illustrator exports
            for child in element:
                if _local_tag(child) in _DEFINITION_TAGS:
                    continue  # title/desc/defs are not switch candidates
                child_attrs = cascade_attrs(
                    child.attrib, None, ids.get("\x00css"), _local_tag(child)
                )
                if conditional_ok(child_attrs):
                    group.extend(walk(child, inherit_down))
                    break

        elif tag == "defs":
            for child in element:
                walk(child, inherit_down)

        elif tag in ("linearGradient", "radialGradient"):
            elem_id = attrs.get("id")
            if elem_id is not None:
                ids[elem_id] = build_gradient(element, tag == "linearGradient", ids)
            return []

        elif tag == "clipPath":
            elem_id = attrs.get("id")
            clip_rule = attrs.get("clip-rule")
            if clip_rule is not None:
                inherit_down.setdefault("fill-rule", clip_rule)
            if elem_id is not None:
                for child in element:
                    group.extend(walk(child, inherit_down))
                if group:
                    scene = Scene.group(group)
                    transform = parse_transform(attrs.get("transform"))
                    if transform is not None:
                        scene = scene.transform(transform)
                    ids[elem_id] = (scene, attrs.get("clipPathUnits") == UNITS_BBOX)
            return []

        elif tag == "mask":
            elem_id = attrs.get("id")
            if elem_id is not None:
                for child in element:
                    group.extend(walk(child, inherit_down))
                if group:
                    scene = Scene.group(group)
                    transform = parse_transform(attrs.get("transform"))
                    if transform is not None:
                        scene = scene.transform(transform)
                    ids[elem_id] = (scene, attrs.get("maskContentUnits") == UNITS_BBOX)
                group = []
            return []

        elif tag == "filter":
            elem_id = attrs.get("id")
            if elem_id is not None:
                ids[elem_id] = build_filter(element, ids)
            return []

        elif tag == "pattern":
            elem_id = attrs.get("id")
            if elem_id is not None:
                px = parse_float(attrs.get("x", "0"))
                py = parse_float(attrs.get("y", "0"))
                pw = parse_float(attrs.get("width"))
                ph = parse_float(attrs.get("height"))
                if pw is None or ph is None:
                    return []
                for child in element:
                    group.extend(walk(child, inherit_down))
                if not group:
                    return []
                scene = Scene.group(group)
                group = []
                ids[elem_id] = Pattern(
                    scene=scene,
                    scene_bbox_units=attrs.get("patternContentUnits", UNITS_USER) == UNITS_BBOX,
                    scene_view_box=parse_float_list(attrs.get("viewBox"), 4, 4),
                    x=px,
                    y=py,
                    width=pw,
                    height=ph,
                    transform=parse_transform(attrs.get("patternTransform")) or Transform(),
                    bbox_units=attrs.get("patternUnits", UNITS_BBOX) == UNITS_BBOX,
                )
            return []

        elif tag == "rect":
            attrs["d"] = rect_path_data(
                psize(attrs.pop("x", "0"), "x"),
                psize(attrs.pop("y", "0"), "y"),
                psize(attrs.pop("width"), "x"),
                psize(attrs.pop("height"), "y"),
                psize(attrs.get("rx"), "x"),
                psize(attrs.get("ry"), "y"),
            )
            group.extend(build_shape_scenes(attrs, ids, fg))

        elif tag == "circle":
            r = psize(attrs.pop("r"), "d")
            attrs["d"] = ellipse_path_data(
                psize(attrs.pop("cx", "0"), "x"), psize(attrs.pop("cy", "0"), "y"), r, r
            )
            group.extend(build_shape_scenes(attrs, ids, fg))

        elif tag == "ellipse":
            attrs["d"] = ellipse_path_data(
                psize(attrs.pop("cx", "0"), "x"),
                psize(attrs.pop("cy", "0"), "y"),
                psize(attrs.pop("rx", None), "x"),
                psize(attrs.pop("ry", None), "y"),
            )
            group.extend(build_shape_scenes(attrs, ids, fg))

        elif tag == "polygon":
            attrs["d"] = f"M{attrs.pop('points')}z"
            group.extend(build_shape_scenes(attrs, ids, fg))

        elif tag == "polyline":
            attrs["d"] = f"M{attrs.pop('points')}"
            group.extend(build_shape_scenes(attrs, ids, fg))

        elif tag == "line":
            x1, y1, x2, y2 = (
                psize(attrs.pop(k, "0"), ax)
                for k, ax in (("x1", "x"), ("y1", "y"), ("x2", "x"), ("y2", "y"))
            )
            attrs["d"] = f"M{x1},{y1} {x2},{y2}"
            group.extend(build_shape_scenes(attrs, ids, fg))

        elif tag in ("title", "desc", "metadata", "style", "script"):
            return []

        elif tag == "font":
            if prepass_mode[0]:
                # fonts register by APPENDING to the FontsDB: the definition
                # pre-pass must not add a duplicate for every <font> that
                # lives inside <defs> (fonts.svgz is exactly that layout)
                return []
            font = build_font(element)
            if font is not None:
                elem_id = attrs.get("id")
                fonts.register(font, elem_id)
                if elem_id is not None:
                    ids[elem_id] = font
            return []

        elif tag == "text":
            group.extend(build_text(element, attrs, fonts, ids, fg))

        elif tag == "image":
            # beyond the reference (it warns on unknown elements): raster
            # payloads become a rect filled by a single-cell Pattern whose
            # sub-scene is a RasterImage; SVG payloads place like <use>
            href = attrs.get("href") or next(
                (v for k, v in element.attrib.items() if k.endswith("}href")), None
            )
            resource = load_image_resource(href, ids.get("\x00base")) if href else None
            if resource is not None:
                kind_r, payload = resource
                x = psize(attrs.get("x", "0"), "x") or 0.0
                y = psize(attrs.get("y", "0"), "y") or 0.0
                w = psize(attrs.get("width"), "x")
                h = psize(attrs.get("height"), "y")
                if kind_r == "raster":
                    # a rect filled by a single-cell Pattern whose sub-scene
                    # is the raster (rides every accelerated paint path).
                    # anchored=True keeps the draw transform's translation
                    # in the tiling frame, so rotated placements stay
                    # content-aligned; the element's own x/y folds into the
                    # cell anchor, scaling maps through paint.transform
                    # (preserveAspectRatio=none behavior).
                    ih, iw = payload.shape[:2]
                    w = float(iw) if w is None else w
                    h = float(ih) if h is None else h
                    sx, sy = w / iw, h / ih
                    paint = Pattern(
                        RasterImage(payload), False, None,
                        x / sx, y / sy, float(iw), float(ih),
                        Transform().scale(sx, sy), False, anchored=True,
                    )
                    rect = Path.from_svg(rect_path_data(x, y, w, h))
                    group.append(Scene.fill(rect, paint))
                else:
                    inner, size = payload
                    tr = Transform().translate(x, y)
                    if size is not None and w is not None and h is not None:
                        sw, sh = float(size[0]), float(size[1])
                        if sw > 0 and sh > 0:
                            tr = tr @ viewbox_transform(
                                (0, 0, w, h), (0, 0, sw, sh),
                                attrs.get("preserveAspectRatio"),
                            )
                    group.append(inner.transform(tr))

        elif tag == "marker":
            # beyond the reference (it lists markers as NOT SUPPORTED)
            elem_id = attrs.get("id")
            if elem_id is not None:
                m_children: list = []
                for child in element:
                    m_children.extend(walk(child, inherit_down))
                if m_children:
                    orient = attrs.get("orient", "0")
                    ids[elem_id] = (
                        "marker",
                        Scene.group(m_children),
                        parse_float_list(attrs.get("viewBox"), 4, 4),
                        (
                            parse_float(attrs.get("markerWidth", "3")),
                            parse_float(attrs.get("markerHeight", "3")),
                        ),
                        (
                            parse_float(attrs.get("refX", "0")),
                            parse_float(attrs.get("refY", "0")),
                        ),
                        orient if orient in ("auto", "auto-start-reverse")
                        else parse_angle(orient),
                        attrs.get("markerUnits", "strokeWidth"),
                        # UA stylesheet default for marker viewports is
                        # overflow: hidden (SVG 1.1 14.3.3)
                        attrs.get("overflow", "hidden"),
                    )
            return []

        elif tag == "symbol":
            # beyond the reference (it lists symbol as NOT SUPPORTED):
            # the content renders only through <use>, scaled by its viewBox
            elem_id = attrs.get("id")
            if elem_id is not None:
                sym_children: list = []
                for child in element:
                    sym_children.extend(walk(child, inherit_down))
                if sym_children:
                    ids[elem_id] = (
                        "symbol",
                        Scene.group(sym_children),
                        parse_float_list(attrs.get("viewBox"), 4, 4),
                        attrs.get("preserveAspectRatio"),
                    )
            return []

        elif tag == "use":
            x, y = attrs.get("x"), attrs.get("y")
            if x is not None or y is not None:
                attrs["transform"] = attrs.get("transform", "") + f" translate({x or 0}, {y or 0})"
            href = attrs.get("href") or next(
                (v for k, v in attrs.items() if k.endswith("}href")), None
            )
            if href and href.startswith("#"):
                target = ids.get(href[1:])
                if isinstance(target, Scene):
                    group.append(target)
                elif isinstance(target, tuple) and len(target) == 4 and target[0] == "symbol":
                    _kind, sym_scene, view_box, sym_par = target
                    if view_box:
                        w = psize(attrs.get("width"), "x") or view_box[2]
                        h = psize(attrs.get("height"), "y") or view_box[3]
                        sym_scene = sym_scene.transform(
                            viewbox_transform((0, 0, w, h), view_box, sym_par)
                        )
                    group.append(sym_scene)

        else:
            warnings.warn(f"unsupported element: {tag}")

        if not group:
            return group

        # wrapping order: filter, opacity, clip, mask, then transform last so
        # clip/mask geometry lives in the element's transformed space
        filter_ref = attrs.get("filter")
        if filter_ref is not None:
            flt = parse_url(filter_ref, ids)
            if isinstance(flt, Filter):
                group = [Scene.group(group).filter(flt)]
            else:
                warnings.warn(f"filter reference is not a filter: {filter_ref}")

        opacity = parse_float(attrs.get("opacity"))
        if opacity is not None:
            group = [Scene.group(group).opacity(opacity)]

        clip_ref = attrs.get("clip-path")
        if clip_ref is not None:
            clip = parse_url(clip_ref, ids)
            if isinstance(clip, tuple) and len(clip) == 2 and isinstance(clip[0], Scene):
                clip_scene, bbox_units = clip
                group = [Scene.group(group).clip(clip_scene, bbox_units)]
            else:
                warnings.warn(f"clip-path reference is not a clip path: {clip_ref}")

        mask_ref = attrs.get("mask")
        if mask_ref is not None:
            mask = parse_url(mask_ref, ids)
            if isinstance(mask, tuple) and len(mask) == 2 and isinstance(mask[0], Scene):
                mask_scene, bbox_units = mask
                group = [Scene.group(group).mask(mask_scene, bbox_units)]
            else:
                warnings.warn(f"mask reference is not a mask: {mask_ref}")

        transform = parse_transform(attrs.get("transform"))
        if transform is not None:
            group = [s.transform(transform) for s in group]

        elem_id = attrs.get("id")
        if elem_id is not None:
            ids[elem_id] = Scene.group(group)

        return group

    root = etree.parse(file).getroot()
    css_text = "".join(
        e.text or "" for e in root.iter() if _local_tag(e) == "style"
    )
    if css_text.strip():
        ids["\x00css"] = parse_stylesheet(css_text)
    default_color = np.array([0.0, 0.0, 0.0, 1.0], dtype=FLOAT) if fg is None else fg

    # FORWARD REFERENCES (beyond the reference, which walks strictly
    # sequentially): register definition elements up front so url(#)/href
    # targets declared later in the document (defs-at-end exports) still
    # resolve.  Definitions re-register during the main walk with the full
    # attribute cascade/viewport context, so backward references are
    # unaffected; the pre-pass is best-effort (warnings suppressed, errors
    # ignored) and skips definitions nested inside an already-walked one.
    # <font> is excluded: FontsDB.register appends, so a pre-pass plus the
    # main walk would register every document font twice
    _PREBUILD_TAGS = frozenset(
        {
            "defs", "linearGradient", "radialGradient", "clipPath", "mask",
            "filter", "pattern", "marker", "symbol",
        }
    )
    # ids actually referenced anywhere in the document — the leaf pre-walk
    # below is gated on this so unreferenced authoring ids (icons.svg has
    # hundreds) cost nothing
    import re as _re

    referenced: set = set()
    for el in root.iter():
        for value in el.attrib.values():
            if value.startswith("#"):
                referenced.add(value[1:])
            else:
                referenced.update(_re.findall(r"url\(\s*#([^)\s]+)\s*\)", value))

    # adaptive rounds so definitions referencing LATER definitions (gradient
    # href chains) re-register against a fully populated registry: round 1's
    # unresolved-lookup count bounds the longest forward chain, so run that
    # many repair rounds (capped — genuinely missing ids also count misses).
    # A fixed 2 rounds left depth-≥3 chains (a→b→c all declared later)
    # silently stale: round 2's re-read of b predates b's own re-registration
    prepass_mode[0] = True
    ids.counting = True
    n_rounds = 1
    try:
        _round = 0
        while _round < n_rounds:
            walked: set = set()
            for el in root.iter():
                tag_l = _local_tag(el)
                # id-bearing geometry leaves also pre-register so a <use>
                # earlier in the document resolves them (their tail
                # registration stores the local subtree, exactly what the
                # main walk re-registers; text/image stay main-walk-only —
                # pre-walking them would shape against not-yet-registered
                # document fonts / re-read image files)
                forward_leaf = (
                    tag_l in (
                        "path", "rect", "circle", "ellipse", "line",
                        "polygon", "polyline",
                    )
                    and el.get("id") in referenced
                )
                if (
                    tag_l not in _PREBUILD_TAGS and not forward_leaf
                ) or id(el) in walked:
                    continue
                for sub in el.iter():
                    walked.add(id(sub))
                try:
                    with warnings.catch_warnings():
                        warnings.simplefilter("ignore")
                        walk(el, {"color": default_color})
                except Exception:
                    pass  # the main walk reports real problems with context
            if _round == 0:
                n_rounds = 1 + min(ids.misses, 7)
            _round += 1
    finally:
        prepass_mode[0] = False
        ids.counting = False

    group = walk(root, {"color": default_color}, top=True, forced_width=width)
    ids.pop("\x00base", None)  # internal plumbing, not part of the registry
    ids.pop("\x00css", None)
    if not group:
        return None, ids, doc_size[0]
    return Scene.group(group), ids, doc_size[0]


def scene_from_filepath(path, fg=None, width=None, fonts: FontsDB | None = None):
    """Build a Scene from an .svg or gzipped .svgz/.gz file path."""
    path = os.path.expanduser(path)
    base = os.path.dirname(os.path.abspath(path))
    _, ext = os.path.splitext(path)
    if ext in (".svgz", ".gz"):
        with gzip.open(path, mode="rt", encoding="utf-8") as file:
            return scene_from_xml(file, fg, width, fonts, base=base)
    with open(path, encoding="utf-8") as file:
        return scene_from_xml(file, fg, width, fonts, base=base)


def scene_from_str(text: str, fg=None, width=None, fonts: FontsDB | None = None):
    """Build a Scene from SVG source text."""
    return scene_from_xml(io.StringIO(text), fg, width, fonts)
