"""Elliptical arcs: SVG endpoint form -> center-parametric -> cubic beziers.

Endpoint conversion follows the SVG spec implementation notes
(https://www.w3.org/TR/SVG/implnote.html#ArcImplementationNotes); the cubic
approximation uses the standard tangent-scaling alpha from "Drawing an
elliptical arc using polylines, quadratic or cubic Bezier curves" (L. Maisonobe).
Parity target: svgrasterize.py:2355-2478.
"""

from __future__ import annotations

import math

import numpy as np

from ..utils.constants import FLOAT

# An arc slice spanning at most pi/4 keeps cubic approximation error tiny.
MAX_SLICE_ANGLE = math.pi / 4


def endpoint_to_center(src, dst, rx, ry, x_axis_rot_deg, large: bool, sweep: bool):
    """Convert SVG endpoint arc params to (center, rx, ry, phi, eta, eta_delta)."""
    rx, ry = abs(rx), abs(ry)
    src = np.asarray(src, dtype=FLOAT)
    dst = np.asarray(dst, dtype=FLOAT)
    phi = math.radians(x_axis_rot_deg)
    cos_p, sin_p = math.cos(phi), math.sin(phi)
    rot_inv = np.array([[cos_p, sin_p], [-sin_p, cos_p]], dtype=FLOAT)

    # midpoint form (spec Eq 5.1)
    x1, y1 = rot_inv @ ((src - dst) / 2)
    # scale radii up if the endpoints cannot be joined (Eq 6.2-6.3)
    lam = (x1 / rx) ** 2 + (y1 / ry) ** 2
    if lam > 1:
        s = math.sqrt(lam)
        rx, ry = rx * s, ry * s
    # center in the rotated frame (Eq 5.2)
    denom = (rx * y1) ** 2 + (ry * x1) ** 2
    radicand = max(0.0, (rx * ry) ** 2 / denom - 1.0) if denom > 0 else 0.0
    coef = math.sqrt(radicand)
    if large == sweep:
        coef = -coef
    cx1 = coef * rx * y1 / ry
    cy1 = -coef * ry * x1 / rx
    # back to the original frame (Eq 5.3)
    center = rot_inv.T @ np.array([cx1, cy1]) + (src + dst) / 2

    # start / sweep angles (Eq 5.5-5.6)
    v1 = np.array([(x1 - cx1) / rx, (y1 - cy1) / ry])
    v2 = np.array([(-x1 - cx1) / rx, (-y1 - cy1) / ry])
    eta = signed_angle(np.array([1.0, 0.0]), v1)
    eta_delta = math.fmod(signed_angle(v1, v2), 2 * math.pi)
    if not sweep and eta_delta > 0:
        eta_delta -= 2 * math.pi
    if sweep and eta_delta < 0:
        eta_delta += 2 * math.pi
    return center, rx, ry, phi, eta, eta_delta


def signed_angle(v0, v1) -> float:
    """Signed angle from v0 to v1 (positive = counter-clockwise in xy)."""
    norm = np.linalg.norm(v0) * np.linalg.norm(v1)
    cos_a = float(np.clip(np.dot(v0, v1) / norm, -1, 1))
    angle = math.acos(cos_a)
    cross = v0[0] * v1[1] - v0[1] * v1[0]
    return -angle if cross < 0 else angle


def to_cubics(center, rx, ry, phi, eta, eta_delta) -> np.ndarray:
    """Approximate an arc by cubics, one per <= pi/4 slice. Returns (K, 4, 2)."""
    center = np.asarray(center, dtype=FLOAT)
    rot = np.array(
        [[math.cos(phi), -math.sin(phi)], [math.sin(phi), math.cos(phi)]], dtype=FLOAT
    )

    def at(angle):
        return rot @ np.array([rx * math.cos(angle), ry * math.sin(angle)]) + center

    def tangent(angle):
        return rot @ np.array([-rx * math.sin(angle), ry * math.cos(angle)])

    slices = max(1, math.ceil(abs(eta_delta) / MAX_SLICE_ANGLE))
    angles = np.linspace(eta, eta + eta_delta, slices + 1)
    cubics = np.zeros((slices, 4, 2), dtype=FLOAT)
    for i, (a0, a1) in enumerate(zip(angles, angles[1:])):
        half = (a1 - a0) / 2
        alpha = math.sin(a1 - a0) * (math.sqrt(4 + 3 * math.tan(half) ** 2) - 1) / 3
        p0, p3 = at(a0), at(a1)
        cubics[i] = [p0, p0 + alpha * tangent(a0), p3 - alpha * tangent(a1), p3]
    return cubics


def parametric(center, rx, ry, phi, eta, eta_delta):
    rot = np.array(
        [[math.cos(phi), -math.sin(phi)], [math.sin(phi), math.cos(phi)]], dtype=FLOAT
    )
    center = np.asarray(center, dtype=FLOAT)

    def arc(t):
        angle = eta + t * eta_delta
        return rot @ np.array([rx * math.cos(angle), ry * math.sin(angle)]) + center

    return arc
