"""SVG attribute value parsers (host-side, pure).

Covers the value grammar the reference accepts
(svgrasterize.py:3416-3624): transform lists, floats with
%/px/pt suffixes, float lists, angles, sizes with physical units, url(#id)
references, paints, and colors (hex 3/4/6/8 digits, rgb()/rgba() with
percentages, hsl(), plus the full CSS named-color table).  Parsed colors are
returned in the framework's canonical form: premultiplied-alpha linear RGB.
"""

from __future__ import annotations

import math
import re
import warnings

import numpy as np

from ..core import color as color_ops
from ..core.transform import Transform
from ..utils.constants import FLOAT, FLOAT_RE

_HEX_RE = re.compile(r"#?([0-9A-Fa-f]+)$")
_FUNC_COLOR_RE = re.compile(r"\s*(rgba?|hsla?)\s*\(([^)]+)\)\s*$")
_TRANSFORM_RE = re.compile(r"\s*(matrix|translate|scale|rotate|skewX|skewY)\s*\(([^)]+)\)\s*")
_URL_RE = re.compile(r"url\(\s*#([^)\s]+)\s*\)")

DEFAULT_FONT_SIZE = 12.0


def parse_float(text, default=None):
    """Parse a float; '%' divides by 100, px/pt suffixes are stripped."""
    if text is None:
        return default
    if isinstance(text, (int, float)):
        return float(text)
    text = text.strip()
    if not text:
        return default
    if text.endswith("%"):
        return float(text[:-1]) / 100.0
    if text.endswith(("px", "pt")):
        return float(text[:-2])
    return float(text)


def parse_float_list(text, at_least=None, at_most=None):
    """Parse whitespace/comma separated floats."""
    if text is None:
        return None
    values = [float(tok) for tok in text.replace(",", " ").split() if tok]
    if at_least is not None and len(values) < at_least:
        raise ValueError(f"expected at least {at_least} numbers in {text!r}")
    if at_most is not None and len(values) > at_most:
        raise ValueError(f"expected at most {at_most} numbers in {text!r}")
    return values


def parse_angle(text) -> float:
    """Parse an SVG angle into radians (bare numbers are degrees)."""
    text = str(text).strip()
    if text.endswith("deg"):
        return float(text[:-3]) * math.pi / 180.0
    if text.endswith("grad"):
        return float(text[:-4]) * math.pi / 200.0
    if text.endswith("rad"):
        return float(text[:-3])
    return float(text) * math.pi / 180.0


def parse_size(
    text, default=None, dpi: float = 96.0,
    font_size: float = DEFAULT_FONT_SIZE, percent_ref: float | None = None,
):
    """Parse a length with physical units into pixels.

    percent_ref is the viewport-relative reference length for "%" values
    (SVG 1.1 7.10: width of the viewport for x-lengths, height for
    y-lengths, diagonal/sqrt(2) otherwise).  The reference implementation
    warns and mis-scales percentages (svgrasterize.py:
    3546-3548); callers with a viewport pass the reference length instead.
    """
    if text is None:
        return default
    if isinstance(text, (int, float)):
        return float(text)
    text = text.strip().lower()
    match = FLOAT_RE.match(text)
    if match is None:
        warnings.warn(f"invalid size: {text!r}")
        return default
    value = float(match.group(0))
    unit = text[match.end() :].strip()
    scale = {
        "": 1.0,
        "px": 1.0,
        "in": dpi,
        "cm": dpi / 2.54,
        "mm": dpi / 25.4,
        "pt": dpi / 72.0,
        "pc": dpi / 6.0,
        "em": font_size,
        "ex": font_size / 2.0,
    }.get(unit)
    if scale is None:
        if unit == "%":
            if percent_ref is not None:
                return value / 100.0 * percent_ref
            warnings.warn("percentage size without a viewport reference")
            return value
        warnings.warn(f"unknown size unit: {unit!r}")
        return value
    return value * scale


def parse_transform(text) -> Transform | None:
    """Parse an SVG transform list into a Transform (or None for empty input)."""
    if text is None:
        return None
    tr = Transform()
    rest = text.strip().replace(",", " ")
    while rest:
        match = _TRANSFORM_RE.match(rest)
        if match is None:
            raise ValueError(f"cannot parse transform near: {rest!r}")
        rest = rest[match.end() :]
        op, raw = match.groups()
        args = [a for a in raw.split() if a]

        if op == "matrix":
            if len(args) != 6:
                raise ValueError(f"matrix() needs 6 numbers, got {len(args)}")
            a, b, c, d, e, f = map(float, args)
            # SVG matrix(a b c d e f) is column-major
            tr = tr.matrix(a, c, e, b, d, f)
        elif op == "translate":
            nums = list(map(float, args))
            if len(nums) == 1:
                nums.append(0.0)
            if len(nums) != 2:
                raise ValueError("translate() needs 1 or 2 numbers")
            tr = tr.translate(*nums)
        elif op == "scale":
            nums = list(map(float, args))
            if len(nums) == 1:
                nums.append(nums[0])
            if len(nums) != 2:
                raise ValueError("scale() needs 1 or 2 numbers")
            tr = tr.scale(*nums)
        elif op == "rotate":
            if len(args) == 1:
                tr = tr.rotate(parse_angle(args[0]))
            elif len(args) == 3:
                angle = parse_angle(args[0])
                cx, cy = float(args[1]), float(args[2])
                tr = tr.translate(cx, cy).rotate(angle).translate(-cx, -cy)
            else:
                raise ValueError("rotate() needs 1 or 3 numbers")
        elif op == "skewX":
            if len(args) != 1:
                raise ValueError("skewX() needs 1 number")
            tr = tr.skew(parse_angle(args[0]), 0.0)
        elif op == "skewY":
            if len(args) != 1:
                raise ValueError("skewY() needs 1 number")
            tr = tr.skew(0.0, parse_angle(args[0]))
    return tr


def parse_url(text: str | None, ids: dict):
    """Resolve a url(#id) reference against the document id registry."""
    if text is None:
        return None
    match = _URL_RE.match(text.strip())
    if match is None:
        return None
    target = ids.get(match.group(1))
    if target is None:
        warnings.warn(f"unresolved reference: {text!r}")
    return target


def parse_paint(text: str | None, ids: dict):
    """Resolve a paint value: none | url(#id) | color. Returns None for none."""
    if text is None:
        return None
    text = text.strip()
    if text == "none":
        return None
    target = parse_url(text, ids)
    if target is not None:
        return target
    color = parse_color(text)
    if color is not None:
        return color
    warnings.warn(f"invalid paint: {text!r}")
    return None


def _hsl_to_rgb(h: float, s: float, l: float) -> tuple[float, float, float]:
    c = (1 - abs(2 * l - 1)) * s
    hp = (h % 360.0) / 60.0
    x = c * (1 - abs(hp % 2 - 1))
    r, g, b = {0: (c, x, 0), 1: (x, c, 0), 2: (0, c, x), 3: (0, x, c), 4: (x, 0, c), 5: (c, 0, x)}[
        int(hp) % 6
    ]
    m = l - c / 2
    return r + m, g + m, b + m


def parse_color(text: str | None):
    """Parse a CSS color into premultiplied-alpha linear-RGB (4,) float64.

    Accepts #rgb/#rgba/#rrggbb/#rrggbbaa, rgb()/rgba() with optional %,
    hsl()/hsla(), and named colors.  Returns None on failure (with a warning).
    """
    if text is None:
        return None
    text = text.strip()

    rgba = None
    match = _HEX_RE.match(text)
    if match is not None:
        digits = match.group(1)
        if len(digits) in (3, 4):
            rgba = np.array([int(d, 16) for d in digits], dtype=FLOAT) / 15.0
        elif len(digits) in (6, 8):
            pairs = [digits[i : i + 2] for i in range(0, len(digits), 2)]
            rgba = np.array([int(p, 16) for p in pairs], dtype=FLOAT) / 255.0
        else:
            warnings.warn(f"invalid hex color: {text!r}")
            return None

    if rgba is None:
        match = _FUNC_COLOR_RE.match(text)
        if match is not None:
            func, raw = match.groups()
            args = [a for a in raw.replace(",", " ").replace("/", " ").split() if a]
            if func in ("rgb", "rgba"):
                # every non-% channel is divided by 255, alpha included —
                # matching the reference parser's semantics exactly
                channels = [
                    float(a[:-1]) / 100.0 if a.endswith("%") else float(a) / 255.0
                    for a in args
                ]
                rgba = np.array(channels, dtype=FLOAT)
            else:  # hsl / hsla
                h = parse_angle(args[0]) * 180.0 / math.pi if args[0][-1].isalpha() else float(args[0])
                s = float(args[1].rstrip("%")) / 100.0
                l = float(args[2].rstrip("%")) / 100.0
                rgb = _hsl_to_rgb(h, s, l)
                alpha = float(args[3].rstrip("%")) / (100.0 if args[3].endswith("%") else 1.0) if len(args) > 3 else 1.0
                rgba = np.array([*rgb, alpha], dtype=FLOAT)

    if rgba is None:
        named = CSS_COLORS.get(text.lower())
        if named is None:
            warnings.warn(f"invalid color: {text!r}")
            return None
        return parse_color(named)

    if rgba.shape == (3,):
        rgba = np.concatenate([rgba, [1.0]])
    rgba = color_ops.srgb_to_linear(rgba)
    rgba[:3] *= rgba[3]
    return rgba


# The 148 CSS/SVG named colors (CSS Color Module level 4 standard table).
# fmt: off
CSS_COLORS: dict[str, str] = {
    "aliceblue": "#f0f8ff", "antiquewhite": "#faebd7", "aqua": "#00ffff",
    "aquamarine": "#7fffd4", "azure": "#f0ffff", "beige": "#f5f5dc",
    "bisque": "#ffe4c4", "black": "#000000", "blanchedalmond": "#ffebcd",
    "blue": "#0000ff", "blueviolet": "#8a2be2", "brown": "#a52a2a",
    "burlywood": "#deb887", "cadetblue": "#5f9ea0", "chartreuse": "#7fff00",
    "chocolate": "#d2691e", "coral": "#ff7f50", "cornflowerblue": "#6495ed",
    "cornsilk": "#fff8dc", "crimson": "#dc143c", "cyan": "#00ffff",
    "darkblue": "#00008b", "darkcyan": "#008b8b", "darkgoldenrod": "#b8860b",
    "darkgray": "#a9a9a9", "darkgreen": "#006400", "darkgrey": "#a9a9a9",
    "darkkhaki": "#bdb76b", "darkmagenta": "#8b008b", "darkolivegreen": "#556b2f",
    "darkorange": "#ff8c00", "darkorchid": "#9932cc", "darkred": "#8b0000",
    "darksalmon": "#e9967a", "darkseagreen": "#8fbc8f", "darkslateblue": "#483d8b",
    "darkslategray": "#2f4f4f", "darkslategrey": "#2f4f4f", "darkturquoise": "#00ced1",
    "darkviolet": "#9400d3", "deeppink": "#ff1493", "deepskyblue": "#00bfff",
    "dimgray": "#696969", "dimgrey": "#696969", "dodgerblue": "#1e90ff",
    "firebrick": "#b22222", "floralwhite": "#fffaf0", "forestgreen": "#228b22",
    "fuchsia": "#ff00ff", "gainsboro": "#dcdcdc", "ghostwhite": "#f8f8ff",
    "gold": "#ffd700", "goldenrod": "#daa520", "gray": "#808080",
    "green": "#008000", "greenyellow": "#adff2f", "grey": "#808080",
    "honeydew": "#f0fff0", "hotpink": "#ff69b4", "indianred": "#cd5c5c",
    "indigo": "#4b0082", "ivory": "#fffff0", "khaki": "#f0e68c",
    "lavender": "#e6e6fa", "lavenderblush": "#fff0f5", "lawngreen": "#7cfc00",
    "lemonchiffon": "#fffacd", "lightblue": "#add8e6", "lightcoral": "#f08080",
    "lightcyan": "#e0ffff", "lightgoldenrodyellow": "#fafad2", "lightgray": "#d3d3d3",
    "lightgreen": "#90ee90", "lightgrey": "#d3d3d3", "lightpink": "#ffb6c1",
    "lightsalmon": "#ffa07a", "lightseagreen": "#20b2aa", "lightskyblue": "#87cefa",
    "lightslategray": "#778899", "lightslategrey": "#778899", "lightsteelblue": "#b0c4de",
    "lightyellow": "#ffffe0", "lime": "#00ff00", "limegreen": "#32cd32",
    "linen": "#faf0e6", "magenta": "#ff00ff", "maroon": "#800000",
    "mediumaquamarine": "#66cdaa", "mediumblue": "#0000cd", "mediumorchid": "#ba55d3",
    "mediumpurple": "#9370db", "mediumseagreen": "#3cb371", "mediumslateblue": "#7b68ee",
    "mediumspringgreen": "#00fa9a", "mediumturquoise": "#48d1cc",
    "mediumvioletred": "#c71585", "midnightblue": "#191970", "mintcream": "#f5fffa",
    "mistyrose": "#ffe4e1", "moccasin": "#ffe4b5", "navajowhite": "#ffdead",
    "navy": "#000080", "oldlace": "#fdf5e6", "olive": "#808000",
    "olivedrab": "#6b8e23", "orange": "#ffa500", "orangered": "#ff4500",
    "orchid": "#da70d6", "palegoldenrod": "#eee8aa", "palegreen": "#98fb98",
    "paleturquoise": "#afeeee", "palevioletred": "#db7093", "papayawhip": "#ffefd5",
    "peachpuff": "#ffdab9", "peru": "#cd853f", "pink": "#ffc0cb",
    "plum": "#dda0dd", "powderblue": "#b0e0e6", "purple": "#800080",
    "rebeccapurple": "#663399", "red": "#ff0000", "rosybrown": "#bc8f8f",
    "royalblue": "#4169e1", "saddlebrown": "#8b4513", "salmon": "#fa8072",
    "sandybrown": "#f4a460", "seagreen": "#2e8b57", "seashell": "#fff5ee",
    "sienna": "#a0522d", "silver": "#c0c0c0", "skyblue": "#87ceeb",
    "slateblue": "#6a5acd", "slategray": "#708090", "slategrey": "#708090",
    "snow": "#fffafa", "springgreen": "#00ff7f", "steelblue": "#4682b4",
    "tan": "#d2b48c", "teal": "#008080", "thistle": "#d8bfd8",
    "tomato": "#ff6347", "turquoise": "#40e0d0", "violet": "#ee82ee",
    "wheat": "#f5deb3", "white": "#ffffff", "whitesmoke": "#f5f5f5",
    "yellow": "#ffff00", "yellowgreen": "#9acd32",
}
# fmt: on
