"""The port's utils/debug.py and utils/profiling.py against the JAX
package's: the curve samplers and show_layer exactly equal, the stage
table alike, trace_to writing a trace, and checked raising exactly where
the JAX package's checkify wrapper raises."""

from __future__ import annotations

import io
import os
import re
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import checkify

from svgrasterize_tpu.core.layer import Layer as JLayer
from svgrasterize_tpu.utils import debug as j_debug
from svgrasterize_tpu.utils import profiling as j_prof

from svgrasterize_tpu_torch.core.layer import Layer as TLayer
from svgrasterize_tpu_torch.utils import debug as t_debug
from svgrasterize_tpu_torch.utils import profiling as t_prof

import torch_support  # noqa: F401 (the CPU thread budget)

CURVE = [[3.0, 4.0], [30.0, -5.0], [10.0, 45.0], [38.0, 36.0]]


@pytest.mark.parametrize("radius", [0.5, 1.2, 2.0, 3.3])
def test_point_mask_matches(radius):
    a, b = j_debug.point_mask(radius), t_debug.point_mask(radius)
    assert a.dtype == b.dtype and np.array_equal(a, b)


def test_sample_curve_matches():
    a = j_debug.sample_curve(np.zeros((40, 44)), CURVE, samples=50, radius=1.7)
    b = t_debug.sample_curve(np.zeros((40, 44)), CURVE, samples=50, radius=1.7)
    assert a.max() > 0 and np.array_equal(a, b)


def test_sample_curve_points_matches():
    points = np.array(CURVE + [[-2.0, 20.0], [41.0, 43.5]])  # two off the canvas edge
    a = j_debug.sample_curve_points(np.zeros((40, 44)), points)
    b = t_debug.sample_curve_points(np.zeros((40, 44)), points)
    assert a.max() > 0 and np.array_equal(a, b)


@pytest.mark.parametrize("pre_alpha", [True, False])
def test_show_layer_matches(pre_alpha):
    image = np.random.default_rng(0).uniform(0, 1, (7, 5, 4)).astype(np.float32)
    if pre_alpha:
        image[..., :3] *= image[..., 3:]
    a, b = io.StringIO(), io.StringIO()
    j_debug.show_layer(JLayer(jnp.asarray(image), (0, 0), pre_alpha, False), out=a)
    t_debug.show_layer(TLayer(torch.from_numpy(image), (0, 0), pre_alpha, False), out=b)
    assert a.getvalue() and a.getvalue() == b.getvalue()


def _stage_table(prof) -> str:
    """A short nested run of stages; the report with each fixed-width time
    field masked (the gap before it kept)."""
    prof.reset()
    for _ in range(2):
        with prof.stage("outer"):
            time.sleep(0.02)
            with prof.stage("inner"):
                time.sleep(0.002)
    return re.sub(r"[ \d.]{9} ms", "ms", prof.report())


@pytest.mark.parametrize("enabled", [True, False])
def test_stage_report_reset_match(enabled):
    try:
        for prof in (j_prof, t_prof):
            prof.enable(enabled)
        a, b = _stage_table(j_prof), _stage_table(t_prof)
        assert a == b
        assert ("outer" in b and "x2" in b) if enabled else b == "(no stages recorded)"
        j_prof.reset()
        t_prof.reset()
        assert j_prof.report() == t_prof.report() == "(no stages recorded)"
    finally:
        for prof in (j_prof, t_prof):
            prof.enable(False)
            prof.reset()


def test_trace_to_writes_the_stage(tmp_path):
    # a stage marks the trace only with tracing on (off, it is a null context)
    t_prof.enable(True)
    try:
        with t_prof.trace_to(str(tmp_path)):
            with t_prof.stage("svgr_traced_stage"):
                torch.ones(64, 64) @ torch.ones(64, 64)
    finally:
        t_prof.enable(False)
        t_prof.reset()
    traces = [f for f in os.listdir(tmp_path) if f.endswith(".json")]
    assert len(traces) == 1
    assert "svgr_traced_stage" in (tmp_path / traces[0]).read_text()


# (name, fn on jnp / torch arrays, inputs as numpy arrays)
CHECKED_CASES = [
    ("nan_0_over_0", lambda x: x / x, (np.zeros(3, np.float32),)),
    ("float_1_over_0", lambda x: 1.0 / x, (np.zeros(3, np.float32),)),
    ("int_division_by_zero", lambda a, b: a // b,
     (np.arange(3, dtype=np.int32), np.zeros(3, np.int32))),
    ("index_out_of_bounds", lambda x, i: x[i],
     (np.arange(3, dtype=np.float32), np.array([0, 7]))),
    ("finite", lambda x: x * 2 + 1, (np.arange(3, dtype=np.float32),)),
]


@pytest.mark.parametrize("fn,inputs", [c[1:] for c in CHECKED_CASES],
                         ids=[c[0] for c in CHECKED_CASES])
def test_checked_raises_where_jax_does(fn, inputs):
    def outcome(wrapped, args, errors):
        try:
            return np.asarray(wrapped(*args))
        except errors:
            return "raised"

    ref = outcome(j_prof.checked(fn), [jnp.asarray(a) for a in inputs],
                  checkify.JaxRuntimeError)
    got = outcome(t_prof.checked(fn), [torch.from_numpy(a) for a in inputs],
                  (RuntimeError, IndexError))
    if isinstance(ref, str):
        assert got == ref
    else:
        assert not isinstance(got, str) and np.array_equal(got, ref)
