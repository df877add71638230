"""The metric arithmetic: rates over the whole window, percentiles of every
sample, the least work counted from a hand-worked document."""

import math
from types import SimpleNamespace

import pytest

from rasterbench.harness import phase, trace
from rasterbench.harness.traffic import HostClock, Window, closed_loop
from rasterbench.metrics import _work, frame_ms, request_p50_ms, request_p95_ms, slow_start_s


def _ctx(**kw):
    return SimpleNamespace(**kw)


def test_frame_ms_is_the_whole_window_over_its_requests():
    w = Window()
    w.seconds, w.completed, w.attempted = 12.5, 5000, 5000
    assert frame_ms.read(_ctx(window=w)) == pytest.approx(2.5)


def test_percentiles_take_every_sample():
    w = Window()
    w.latencies_ms = [float(v) for v in range(1, 101)]  # 1 .. 100
    assert request_p95_ms.read(_ctx(window=w)) == pytest.approx(95.05)
    assert request_p50_ms.read(_ctx(window=w)) == pytest.approx(50.5)
    w.latencies_ms = [1.0] * 94 + [100.0] * 6  # the tail is every request's
    assert request_p95_ms.read(_ctx(window=w)) == pytest.approx(100.0)


def test_closed_loop_keeps_its_requests_in_flight_and_counts_all():
    issued, done = [], []
    w = closed_loop(lambda: issued.append(1) or len(issued), HostClock(),
                    {"in_flight": 3}, requests=10, keep=lambda i, out: done.append(out))
    assert w.attempted == w.completed == 10 and done == list(range(1, 11))
    assert len(w.latencies_ms) == 10


def test_least_work_of_a_hand_worked_document():
    doc = dict(width=100.0, height=100.0, clips={},
               gradients={"g": dict(kind="linear", x1=0, y1=0, x2=1, y2=0, spread="pad",
                                    stops=[(0.0, (0, 0, 0), 1.0), (1.0, (9, 9, 9), 1.0)])},
               items=[dict(shape="rect", x=0.0, y=0.0, w=10.0, h=20.0, paint=("solid", (1, 2, 3)),
                           opacity=1.0, clip=None, rule="nonzero"),
                      dict(shape="circle", cx=50.0, cy=50.0, r=5.0, paint=("gradient", "g"),
                           opacity=0.5, clip=None, rule="nonzero")])
    nbytes, ops = _work.scene_work(doc, (0, 0, 200, 200), 2.0)
    # output 200 x 200 x 4 float32; inputs: rect 4 + paint 4 + opacity 1,
    # circle 3 + gradient 5 + 2 stops x 5 + opacity 1
    assert nbytes == 200 * 200 * 16 + 4 * (9 + 19)
    assert ops == pytest.approx(14 * (10 * 20 + math.pi * 25) * 4)
    ms = _work.least_ms(nbytes, ops, {"hbm_bytes_per_s": 1e9, "fp32_flops_per_s": 1e12})
    assert ms == pytest.approx(nbytes / 1e9 * 1e3)


def test_busy_time_is_the_union_of_device_operations():
    summary = dict(bounds=(0, 100), host=[("cudaEventSynchronize", 40, 70)], ops=[
        ("a", 10, 20, True), ("b", 20, 15, True), ("c", 50, 10, False)])
    busy, gaps = trace.busy_and_gaps(summary)
    assert busy == 35
    assert sorted(g[0] for g in gaps) == [10, 15, 40]
    top = trace.breakdown(summary)
    assert top["device_ops"][0] == ["a", 20e-9]
    assert top["idle_gaps"][0] == ["host: python", 40e-9]
    assert top["idle_gaps"][1] == ["cudaEventSynchronize", 15e-9]


def test_slow_start_is_the_end_of_the_last_slow_half_second():
    w, steady = Window(intervals=True), Window(intervals=True)
    steady.intervals_ms = [3.4] * 2900
    # 3.75 ms a frame for 4.5 s, then 3.4 ms for 20 s
    w.intervals_ms = [3.75] * 1200 + [3.4] * 5883
    assert slow_start_s.read(_ctx(warmup=w, window=steady)) == pytest.approx(4.5)
    w.intervals_ms = [3.75] * 6000 + [3.4] * 100  # slow until the warm-up's last 0.5 s
    assert slow_start_s.read(_ctx(warmup=w, window=steady)) == pytest.approx(22.5)
    w.intervals_ms = [3.4] * 7000  # never slow
    assert slow_start_s.read(_ctx(warmup=w, window=steady)) == 0.0
    w.intervals_ms = [3.8] * 2000  # under 10 s of traffic: nothing to read
    assert slow_start_s.read(_ctx(warmup=w, window=steady)) is None
    assert slow_start_s.read(_ctx(warmup=Window(), window=steady)) is None
    assert slow_start_s.read(_ctx(warmup=w, window=Window())) is None


def test_closed_loop_times_completion_to_completion_where_asked():
    w = closed_loop(lambda: None, HostClock(), {"in_flight": 2}, requests=6,
                    window=Window(intervals=True))
    assert len(w.intervals_ms) == 5 and min(w.intervals_ms) >= 0
    assert closed_loop(lambda: None, HostClock(), {"in_flight": 2}, requests=3).intervals_ms is None


def test_the_warm_up_serves_until_the_detector_reads_fast():
    readings, served = iter([1.36, 1.35, 1.34, 1.01, 1.36]), []
    out = phase.wait_out(lambda: next(readings), served.append)
    assert out == [1.36, 1.35, 1.34, 1.01] and served == [1.0, 1.0, 1.0]
    served.clear()
    assert phase.wait_out(lambda: 1.01, served.append) == [1.01] and not served
    # never fast: it stops at its limit
    assert phase.wait_out(lambda: 1.36, served.append, 0.0) == [1.36] and not served
