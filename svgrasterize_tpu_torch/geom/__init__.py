from .path import Path
from .hull import ConvexHull
from . import bezier, arc, stroke
