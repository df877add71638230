"""Porter-Duff composition constants and OVER (torch).

The operator ids match the JAX package's ops/compose.py; the SVG frontend
writes them into the scene graph.  Only OVER runs on this slice's path
(the background fill and the canvas merge); the other operators compose
isolation groups and arrive with that slice.
"""

from __future__ import annotations

COMPOSE_OVER = 0
COMPOSE_OUT = 1
COMPOSE_IN = 2
COMPOSE_ATOP = 3
COMPOSE_XOR = 4


def over(dst, src):
    """Premultiplied `src` OVER `dst` (numpy broadcasting rules)."""
    return src + dst * (1 - src[..., -1:])
