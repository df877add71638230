"""svgrasterize_tpu_torch: the PyTorch / CUDA port of svgrasterize_tpu.

The batched render path (SVG -> scene -> host lowering -> device executor
-> PNG, isolation passes and pattern paints included) and the interpreter
(Scene.render, which batches its lowerable group runs through the batched
path) run on a CUDA card through five hand-written kernels
(ops/fused_exec.py, csrc/), and on the CPU through their plain PyTorch
versions (ops/batch_exec.py, ops/filter_batch.py, ops/coverage.py).  The
package imports torch and never jax.
"""

from .core.transform import Transform
from .core.layer import Layer, canvas_create
from .core import color, png
from .geom.path import Path, FILL_NONZERO, FILL_EVENODD
from .geom.hull import ConvexHull
from .paint import GradLinear, GradRadial, Pattern
from .scene import Scene
from .filter import Filter
from .frontend.svg import scene_from_filepath, scene_from_str, scene_from_xml
from .render_plan import CompiledScene, compile_scene, render_fast
from .frontend.parsers import parse_color, parse_transform
from .text.fonts import DEFAULT_FONTS, Font, FontsDB, Glyph

__version__ = "0.1.0"
