"""The plain reference on hand-worked cases."""

import math

import numpy as np
import pytest
import torch

from rasterbench.reference import raster

F32 = torch.float32


def _cov(edges, rule, h, w):
    return raster.coverage(np.asarray(edges, np.float64), rule, (0, h, 0, w), F32, "cpu")


def test_rect_coverage_is_exact():
    item = dict(shape="rect", x=1.25, y=2.5, w=3.5, h=2.25)
    cov = _cov(raster.shape_edges(item, 1.0), "nonzero", 8, 8).numpy()
    # columns: 1 covers 0.75, 2-3 whole, 4 covers 0.75; rows: 2 half, 3 whole, 4 0.75
    col = np.array([0, 0.75, 1, 1, 0.75, 0, 0, 0])
    row = np.array([0, 0, 0.5, 1, 0.75, 0, 0, 0])
    np.testing.assert_allclose(cov, row[:, None] * col[None, :], atol=1e-6)
    assert cov.sum() == pytest.approx(3.5 * 2.25, abs=1e-5)


def test_circle_area_and_symmetry():
    ring = raster.circle_ring(20.0, 20.0, 15.0, 1.0)
    cov = _cov(raster._ring_edges([ring]), "nonzero", 40, 40).numpy()
    x, y = ring[:, 0], ring[:, 1]
    polygon = 0.5 * abs(np.dot(x, np.roll(y, -1)) - np.dot(y, np.roll(x, -1)))
    assert cov.sum() == pytest.approx(polygon, abs=1e-3)
    # inscribed within FLATNESS of the circle: short of its area by less
    # than the perimeter times FLATNESS
    assert 0 < math.pi * 15 ** 2 - polygon < 2 * math.pi * 15 * raster.FLATNESS
    np.testing.assert_allclose(cov, cov.T, atol=1e-5)
    np.testing.assert_allclose(cov, cov[::-1, :], atol=1e-5)


def test_triangle_pixel_is_half_covered():
    # the diagonal of one pixel: the pixel below it is half covered
    cov = _cov(raster._ring_edges([[[0, 0], [4, 0], [0, 4]]]), "nonzero", 4, 4).numpy()
    assert cov[0, 3] == pytest.approx(0.5, abs=1e-6)
    assert cov[0, 0] == pytest.approx(1.0, abs=1e-6)
    assert cov.sum() == pytest.approx(8.0, abs=1e-5)


def test_evenodd_and_nonzero_of_nested_squares():
    rings = [[[0, 0], [8, 0], [8, 8], [0, 8]], [[2, 2], [6, 2], [6, 6], [2, 6]]]
    edges = raster._ring_edges(rings)
    assert _cov(edges, "nonzero", 8, 8)[4, 4] == 1.0
    assert _cov(edges, "evenodd", 8, 8)[4, 4] == 0.0
    assert _cov(edges, "evenodd", 8, 8)[1, 1] == 1.0


@pytest.mark.parametrize("spread,expect", [
    ("pad", [0.0, 0.0, 0.25, 0.75, 1.0, 1.0]),
    # repeat keeps the sign of t (numpy's modf): negative t clamps to the first stop
    ("repeat", [0.0, 0.0, 0.25, 0.75, 0.25, 0.75]),
    ("reflect", [0.75, 0.25, 0.25, 0.75, 0.75, 0.25]),
])
def test_linear_gradient_spreads(spread, expect):
    # a black-to-white ramp over x in [0, 4] of a bbox [0, 0, 4, 1] (the
    # gradient runs from x1 = 0.5 to x2 = 1.5 in bbox units: 2 to 6 in user)
    grad = dict(kind="linear", x1=0.5, y1=0.0, x2=1.5, y2=0.0, spread=spread,
                stops=[(0.0, (0, 0, 0), 1.0), (1.0, (255, 255, 255), 1.0)])
    # pixel centres x = -3.5 .. 11.5 every 3 user units: t = (x - 2) / 4
    paint = raster.gradient(grad, (0.0, 0.0, 4.0, 1.0), (0, 1, -4, 12), 1.0, F32, "cpu")
    red = paint[0, ::3, 0].numpy()
    t = (np.arange(-4, 12, 3) + 0.5 - 2.0) / 4.0
    np.testing.assert_allclose(t, [-1.375, -0.625, 0.125, 0.875, 1.625, 2.375])
    np.testing.assert_allclose(red, {"pad": np.clip(t, 0, 1),
                                     "repeat": np.clip(t - np.trunc(t), 0, 1),
                                     "reflect": np.abs(np.remainder(t + 1, 2) - 1)}[spread],
                               atol=1e-6)
    assert len(expect) == 6


def test_radial_gradient_centre_and_rim():
    grad = dict(kind="radial", cx=0.5, cy=0.5, r=0.5, fx=0.5, fy=0.5, spread="pad",
                stops=[(0.0, (255, 0, 0), 1.0), (1.0, (0, 0, 255), 0.5)])
    paint = raster.gradient(grad, (0.0, 0.0, 100.0, 100.0), (0, 100, 0, 100), 1.0, F32, "cpu")
    # the pixel beside the centre: its centre lies sqrt(0.5) user units off,
    # t = sqrt(0.5) / 50; a corner: t > 1 -> the last stop, premultiplied
    t = math.sqrt(0.5) / 50
    np.testing.assert_allclose(paint[50, 50].numpy(), [1 - t, 0, 0.5 * t, 1 - 0.5 * t], atol=1e-6)
    np.testing.assert_allclose(paint[0, 0].numpy(), [0, 0, 0.5, 0.5], atol=1e-6)


def test_over_and_opacity():
    doc = dict(width=4.0, height=4.0, gradients={}, clips={}, items=[
        dict(shape="rect", x=0.0, y=0.0, w=4.0, h=4.0, paint=("solid", (255, 0, 0)),
             opacity=1.0, clip=None, rule="nonzero"),
        dict(shape="rect", x=0.0, y=0.0, w=2.0, h=4.0, paint=("solid", (0, 0, 255)),
             opacity=0.5, clip=None, rule="nonzero"),
    ])
    img = raster.render(doc, 4, 4, 1.0).numpy()
    np.testing.assert_allclose(img[0, 0], [0.5, 0, 0.5, 1.0], atol=1e-6)
    np.testing.assert_allclose(img[0, 3], [1.0, 0, 0, 1.0], atol=1e-6)


def test_clip_multiplies_coverage():
    doc = dict(width=8.0, height=8.0, gradients={},
               clips={"c": dict(kind="rect", x=0.0, y=0.0, w=4.0, h=8.0, rotate=(0.0, 0.0, 0.0))},
               items=[dict(shape="rect", x=0.0, y=0.0, w=8.0, h=8.0, paint=("solid", (0, 255, 0)),
                           opacity=1.0, clip="c", rule="nonzero")])
    img = raster.render(doc, 8, 8, 1.0).numpy()
    assert img[:, :4, 3].min() == 1.0 and img[:, 4:, 3].max() == 0.0


def test_rotated_clip_rect_keeps_its_area():
    clip = dict(kind="rect", x=10.0, y=12.0, w=20.0, h=8.0, rotate=(30.0, 20.0, 16.0))
    cov = _cov(raster.clip_edges(clip, 1.0), "nonzero", 40, 40)
    assert float(cov.sum()) == pytest.approx(160.0, abs=1e-3)
