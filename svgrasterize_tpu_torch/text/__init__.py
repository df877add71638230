"""Text and font subsystem: SVG fonts, glyph lookup, string -> Path shaping."""

from .fonts import DEFAULT_FONTS, Font, FontsDB, Glyph, font_weight
