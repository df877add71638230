"""Global numeric constants for the framework.

Host-side geometry runs in float64 (numpy); device-side rasterization runs in
float32. Parity target: svgrasterize.py:40-42.
"""

from __future__ import annotations

import re
import sys

import numpy as np

EPSILON = sys.float_info.epsilon

# Host geometry dtype (path parsing, transforms, stroke expansion).
FLOAT = np.float64

# Device rasterization dtype: f32; coverage formulas are exact
# in real arithmetic, so f32 only contributes rounding noise well below the
# 1/255 quantization of the final PNG.
DEVICE_FLOAT = np.float32

# SVG numeric token (same grammar as SVG spec floats).
FLOAT_RE = re.compile(r"[-+]?(?:(?:\d*\.\d+)|(?:\d+\.?))(?:[Ee][+-]?\d+)?")

# Default curve-flattening tolerance in device pixels (reference hardcodes
# 0.1px at svgrasterize.py:953-955).
FLATNESS = 0.1

# Canvas tile size of the batched render path's one-shot renders (the CLI
# and the interpreter's group runs), as in the JAX CLI; every entry point
# takes it as an argument.
DEFAULT_TILE = 32
