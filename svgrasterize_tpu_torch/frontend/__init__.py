"""SVG frontend: XML scene building and attribute/value parsing (host-side)."""

from .parsers import (
    parse_angle,
    parse_color,
    parse_float,
    parse_float_list,
    parse_paint,
    parse_size,
    parse_transform,
    parse_url,
)
from .svg import (
    scene_from_filepath,
    scene_from_str,
    scene_from_xml,
    viewbox_transform,
)
