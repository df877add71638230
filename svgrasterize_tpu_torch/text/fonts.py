"""SVG font model: glyphs, fonts, and a lazily-loaded font database.

Parity target: svgrasterize.py:2564-2718.  An SVG font maps
unicode strings (possibly multi-character ligatures) to path outlines in em
units; shaping is greedy longest-match with horizontal kerning.  Glyph path
parsing is deferred until a glyph is actually used, and glyph outline tensors
are cached per (font, glyph) so repeated characters batch on device.
"""

from __future__ import annotations

import os
import warnings
from dataclasses import dataclass, field

from ..geom.path import Path

FONT_STYLE_NORMAL = "normal"
FONT_WEIGHT_NORMAL = 400
FONT_WEIGHT_BOLD = 700
DEFAULT_FONT_SIZE = 12.0

# Well-known family names used for generic fallback classification.
_SANS_FAMILIES = {"arial", "verdana", "helvetica"}
_SERIF_FAMILIES = {"times new roman", "times", "georgia"}
_MONO_FAMILIES = {"iosevka", "courier", "pragmatapro", "consolas"}

# Bundled default font collection (same deal as the reference's fonts.svgz).
# the font asset is shared with the JAX package and read in place, by path
# (importing svgrasterize_tpu would pull in jax)
DEFAULT_FONTS = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "svgrasterize_tpu", "assets", "fonts.svgz",
)


def font_weight(value) -> int:
    """Normalize a font-weight attribute to its numeric value."""
    if value is None:
        return FONT_WEIGHT_NORMAL
    if isinstance(value, (int, float)):
        return int(value)
    value = value.strip().lower()
    if value == "normal":
        return FONT_WEIGHT_NORMAL
    if value == "bold":
        return FONT_WEIGHT_BOLD
    return int(float(value))


@dataclass
class Glyph:
    """One glyph: unicode key (may be a ligature string), advance, outline."""

    unicode: str | None
    advance: float
    source: str  # raw SVG path data, parsed lazily
    name: str | None = None
    _path: Path | None = field(default=None, repr=False)

    @property
    def path(self) -> Path:
        if self._path is None:
            self._path = Path.from_svg(self.source) if self.source else Path([])
        return self._path


@dataclass
class Font:
    family: str
    weight: int
    style: str
    ascent: float
    descent: float
    units_per_em: float
    glyphs: dict[str, Glyph]
    missing_glyph: Glyph | None
    hkern: dict[tuple[str, str], float]
    _prefixes: set | None = field(default=None, repr=False, compare=False)

    def _ligature_prefixes(self) -> set:
        """Proper prefixes of every multi-char glyph key (built once, lazily)."""
        if self._prefixes is None:
            prefixes: set[str] = set()
            for key in self.glyphs:
                for end in range(1, len(key)):
                    prefixes.add(key[:end])
            self._prefixes = prefixes
        return self._prefixes

    def shape(self, string: str) -> tuple[list[tuple[float, Glyph]], float]:
        """Greedy longest-match shaping with kerning.

        Returns ([(pen_offset, glyph)], total_advance) in em units.
        """
        prefixes = self._ligature_prefixes()
        placed: list[tuple[float, Glyph]] = []
        pen = 0.0
        prev: str | None = None
        i = 0
        n = len(string)
        while i < n:
            # longest ligature starting at i
            glyph = None
            length = 1
            j = i + 1
            while j <= n:
                candidate = string[i:j]
                found = self.glyphs.get(candidate)
                if found is not None:
                    glyph, length = found, j - i
                if candidate not in prefixes:
                    break
                j += 1
            if glyph is None:
                glyph = self.missing_glyph
                if glyph is None:
                    i += 1
                    continue
            if prev is not None and glyph.unicode is not None:
                pen -= self.hkern.get((prev, glyph.unicode), 0.0)
            placed.append((pen, glyph))
            pen += glyph.advance
            prev = glyph.unicode
            i += length
        return placed, pen

    def str_to_path(self, size: float, string: str) -> tuple[Path, float]:
        """Shape a string into one Path in user units; returns (path, advance).

        Glyph outlines are flipped (font y-up -> render y-down) and scaled by
        size / units_per_em, with each glyph translated by its pen offset.
        """
        from ..core.transform import Transform

        scale = size / self.units_per_em
        placed, advance = self.shape(string)
        subpaths: list = []
        for pen, glyph in placed:
            tr = Transform().scale(scale, -scale).translate(pen, 0.0)
            for sub in glyph.path.transform(tr).subpaths:
                subpaths.append(sub)
        return Path(subpaths), advance * scale

    def glyph_names(self) -> dict[str, str]:
        return {g.name: g.unicode for g in self.glyphs.values() if g.name}

    def __repr__(self) -> str:
        return (
            f"Font(family={self.family!r}, weight={self.weight}, "
            f"style={self.style!r}, glyphs={len(self.glyphs)})"
        )


class FontsDB:
    """Font registry with lazy file loading and family/weight/style resolution."""

    __slots__ = ("_fonts", "_pending_files")

    def __init__(self):
        self._fonts: dict[str, list[Font]] = {}
        self._pending_files: list[str] = []

    def register(self, font: Font, alias: str | None = None) -> None:
        self._fonts.setdefault(font.family.lower(), []).append(font)
        if alias and alias.lower() != font.family.lower():
            self._fonts.setdefault(alias.lower(), []).append(font)

    def register_file(self, path: str) -> None:
        """Queue an SVG(Z) file containing <font> elements for lazy loading."""
        self._pending_files.append(path)

    def all_fonts(self) -> list[Font]:
        """Every distinct registered font (loading pending files first)."""
        self._load_pending()
        seen: list[Font] = []
        for fonts in self._fonts.values():
            for font in fonts:
                if all(font is not other for other in seen):
                    seen.append(font)
        return seen

    def families(self) -> list[str]:
        self._load_pending()
        return sorted(self._fonts)

    def _load_pending(self) -> None:
        from ..frontend.svg import scene_from_filepath

        while self._pending_files:
            source = self._pending_files.pop()
            if not os.path.isfile(source):
                warnings.warn(f"fonts file not found: {source}")
                continue
            # parsing the file registers every <font> element with this DB
            scene_from_filepath(source, fonts=self)

    def resolve(self, family: str | None, weight: int | None = None, style: str | None = None) -> Font | None:
        """Best-match font for (family, weight, style) with generic fallbacks."""
        self._load_pending()

        family = "serif" if family is None else family.lower().strip()
        candidates = self._fonts.get(family)
        if candidates is None:
            if "sans" in family or family in _SANS_FAMILIES:
                generic = "sans"
            elif "mono" in family or family in _MONO_FAMILIES:
                generic = "monospace"
            else:
                generic = "serif"
            candidates = self._fonts.get(generic) or self._fonts.get("serif")
        if not candidates:
            return None

        style = style or FONT_STYLE_NORMAL
        styled = [f for f in candidates if f.style == style]
        if not styled:
            styled = [f for f in candidates if f.style == FONT_STYLE_NORMAL]
        if not styled:
            return None

        weight = weight or FONT_WEIGHT_NORMAL
        return min(styled, key=lambda f: abs(f.weight - weight))
