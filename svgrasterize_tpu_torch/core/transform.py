"""2D affine transforms (3x3 homogeneous matrices), host-side numpy.

Semantics-compatible with the reference Transform
(svgrasterize.py:509-570): right-multiplying builder methods,
cached inverse, batch point application.
"""

from __future__ import annotations

import math

import numpy as np

from ..utils.constants import FLOAT


class Transform:
    __slots__ = ("m", "_inv")

    def __init__(self, matrix: np.ndarray | None = None, inverse: np.ndarray | None = None):
        if matrix is None:
            self.m = np.identity(3, dtype=FLOAT)
            self._inv = self.m
        else:
            self.m = np.asarray(matrix, dtype=FLOAT)
            self._inv = inverse

    # --- composition ---------------------------------------------------
    def __matmul__(self, other: "Transform") -> "Transform":
        return Transform(self.m @ other.m)

    @property
    def invert(self) -> "Transform":
        if self._inv is None:
            self._inv = np.linalg.inv(self.m)
        return Transform(self._inv, self.m)

    # --- application ---------------------------------------------------
    def __call__(self, points):
        """Apply to an (..., 2) array of points."""
        points = np.asarray(points, dtype=FLOAT)
        if points.size == 0:
            return points
        return points @ self.m[:2, :2].T + self.m[:2, 2]

    def apply_vectors(self, vectors):
        """Apply only the linear part (no translation)."""
        vectors = np.asarray(vectors, dtype=FLOAT)
        return vectors @ self.m[:2, :2].T

    # --- builders (all return new transforms, composed on the right) ----
    def matrix(self, m00, m01, m02, m10, m11, m12) -> "Transform":
        return Transform(self.m @ np.array([[m00, m01, m02], [m10, m11, m12], [0, 0, 1]], dtype=FLOAT))

    def translate(self, tx: float, ty: float) -> "Transform":
        return self.matrix(1, 0, tx, 0, 1, ty)

    def scale(self, sx: float, sy: float | None = None) -> "Transform":
        sy = sx if sy is None else sy
        return self.matrix(sx, 0, 0, 0, sy, 0)

    def rotate(self, angle: float) -> "Transform":
        c, s = math.cos(angle), math.sin(angle)
        return self.matrix(c, -s, 0, s, c, 0)

    def skew(self, ax: float, ay: float) -> "Transform":
        return self.matrix(1, math.tan(ax), 0, math.tan(ay), 1, 0)

    def no_translate(self) -> "Transform":
        m = self.m.copy()
        m[:2, 2] = 0
        return Transform(m)

    # --- properties ------------------------------------------------------
    @property
    def is_axis_aligned(self) -> bool:
        """True when the linear part has no rotation/skew component."""
        return abs(self.m[0, 1]) < 1e-12 and abs(self.m[1, 0]) < 1e-12

    @property
    def is_swap_axis_aligned(self) -> bool:
        """True when the linear part is a pure axis swap + scale."""
        return abs(self.m[0, 0]) < 1e-12 and abs(self.m[1, 1]) < 1e-12

    def scale_factors(self) -> tuple[float, float]:
        """Lengths of the images of the unit x/y vectors."""
        sx = float(np.hypot(self.m[0, 0], self.m[1, 0]))
        sy = float(np.hypot(self.m[0, 1], self.m[1, 1]))
        return sx, sy

    def __repr__(self) -> str:
        return str(np.around(self.m, 4).tolist()[:2])
