"""The program's spans, read: the frame mapper and the idle attribution on
hand-built event lists, self times on a hand-built record, the span
readers without their data, and the probe at a small size on the CPU."""

import importlib
import json
import os
from types import SimpleNamespace

import pytest

from rasterbench.harness import cell, probe, spans, trace, traffic

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SLICE = "slice"


# the metrics harness/probe.py reads, each listed in BENCHMARK.json
SPAN_METRICS = ["lower_build_s", "lower_pack_s", "lower_collapse_s", "lower_groups_s",
                "request_host_ms", "replay_host_ms", "idle_in_replay_pct", "post_assemble_ms",
                "post_chain_ms", "post_retile_ms", "post_ops_per_frame", "fe_blur_ms",
                "fe_merge_ms", "fe_color_matrix_ms", "fe_composite_ms"]


def _eager():
    """An eager frame: a kernel outside every span, two launched inside
    post.assemble, one inside fe.blur inside post.chain, a copy in
    post.retile."""
    evs = [("mark", "frame", 0, 1000, None),
           ("mark", "post.assemble", 100, 300, None),
           ("mark", "post.chain", 300, 600, None),
           ("mark", "fe.blur", 350, 500, None),
           ("mark", "post.retile", 600, 800, None)]
    for k, (t, name) in enumerate([(50, "scene"), (150, "fill"), (200, "cat"), (400, "conv"),
                                   (700, "Memcpy DtoD (Device -> Device)")]):
        evs.append(("launch", "cudaLaunchKernel", t, t + 5, 100 + k))
        # device work runs later than its launch, in launch order
        evs.append(("device", name, 2000 + 10 * k, 2005 + 10 * k, (100 + k, 0)))
    return evs


def _replay(corr, t0, names, durs, launch=None):
    """A graph launch at t0 (or launch) and its operations from t0 + 10 on."""
    evs = [("launch", "cudaGraphLaunch", t0 if launch is None else launch, t0 + 5, corr)]
    t = t0 + 10
    for name, ns in zip(names, durs):
        evs.append(("device", name, t, t + ns, (corr, 0)))
        t += ns + 1
    return evs


NAMES = ["scene", "fill", "cat", "conv", "Memcpy DtoD (Device -> Device)"]


def test_eager_frame_takes_the_spans_around_each_launch():
    eager = spans.eager_frame(_eager(), "frame")
    assert [(n, c) for n, _ns, c in eager] == [
        ("scene", ()), ("fill", ("post.assemble",)), ("cat", ("post.assemble",)),
        ("conv", ("fe.blur", "post.chain")), ("Memcpy DtoD (Device -> Device)", ("post.retile",))]
    assert all(ns == 5 for _n, ns, _c in eager)


def test_matching_replays_map_op_for_op():
    evs = [("mark", SLICE, 0, 10_000, None)]
    # a graph runs the eager frame's device-to-device copy as a kernel
    evs += _replay(1, 100, NAMES[:-1] + ["memcpy32_post"], [10, 20, 30, 40, 50])
    evs += _replay(2, 1000, NAMES, [30, 40, 50, 60, 70])
    complete = spans.replays(evs, SLICE)
    assert len(complete) == 2
    by_chain, miss = spans.map_replays(spans.eager_frame(_eager(), "frame"), complete)
    assert miss is None
    assert spans.ns_in(by_chain, "post.assemble") == (20 + 30 + 40 + 50) / 2
    assert spans.ns_in(by_chain, "post.chain") == spans.ns_in(by_chain, "fe.blur") == 50
    assert spans.ns_in(by_chain, "post.retile") == 60
    assert by_chain[()] == 20
    assert sum(by_chain.values()) == (150 + 250) / 2


def test_a_replay_that_differs_by_one_operation_maps_nothing():
    evs = [("mark", SLICE, 0, 10_000, None)]
    evs += _replay(1, 100, NAMES, [10] * 5)
    evs += _replay(2, 1000, ["scene", "fill", "add", "conv", "Memcpy"], [10] * 5)
    by_chain, miss = spans.map_replays(spans.eager_frame(_eager(), "frame"),
                                       spans.replays(evs, SLICE))
    assert by_chain is None and miss == (1, 2, "cat", "add")
    # one operation more, at the end
    evs = [("mark", SLICE, 0, 10_000, None)] + _replay(1, 100, NAMES + ["extra"], [10] * 6)
    by_chain, miss = spans.map_replays(spans.eager_frame(_eager(), "frame"),
                                       spans.replays(evs, SLICE))
    assert by_chain is None and miss == (0, 5, None, "extra")


def test_replays_with_records_lost_are_dropped_before_the_mapping():
    eager = spans.eager_frame(_eager(), "frame")
    evs = [("mark", SLICE, 0, 10_000, None)]
    evs += _replay(1, 100, NAMES, [10] * 5)
    # the profiler lost the records of the first two operations
    evs += _replay(2, 1000, NAMES[2:], [10] * 3)
    evs += _replay(3, 2000, NAMES[:-1] + ["memcpy32_post"], [30] * 5)
    complete, lossy = spans.whole(eager, spans.replays(evs, SLICE))
    assert lossy == 1 and len(complete) == 2
    by_chain, miss = spans.map_replays(eager, complete)
    assert miss is None and sum(by_chain.values()) == (50 + 150) / 2
    # one operation fewer and another in its place differs: kept, and maps nothing
    evs = [("mark", SLICE, 0, 10_000, None)] + _replay(1, 100, ["scene", "add", "conv"], [10] * 3)
    complete, lossy = spans.whole(eager, spans.replays(evs, SLICE))
    assert lossy == 0
    assert spans.map_replays(eager, complete) == (None, (0, 1, "fill", "add"))


def test_the_longest_eager_frame_is_mapped():
    full = spans.eager_frame(_eager(), "frame")
    lossy = [op for op in full if op[0] != "fill"]
    assert spans.longest([lossy, full]) == spans.longest([full, lossy]) == full
    assert spans.longest([]) == []
    assert not spans.lost_records(NAMES, NAMES)
    assert spans.lost_records(NAMES, NAMES[1:])
    assert not spans.lost_records(NAMES, NAMES[1:][::-1])


def test_profiled_sessions_are_made_until_one_maps():
    said, outcomes = [], [RuntimeError("no records"), ({"idle_in_replay_pct": 1.0}, False),
                          ({"post_chain_ms": 2.0}, True), ({"never": 0}, True)]

    def session():
        got = outcomes.pop(0)
        if isinstance(got, Exception):
            raise got
        return got

    assert probe._until_mapped(session, said.append) == {"post_chain_ms": 2.0}
    assert len(outcomes) == 1 and "failed" in said[0] and "session 2 of" in said[-1]
    # none maps: the last session's metrics, after ATTEMPTS
    outcomes = [({"idle_in_replay_pct": 1.0}, False)] * probe.ATTEMPTS + [({}, True)]
    assert probe._until_mapped(session, said.append) == {"idle_in_replay_pct": 1.0}
    assert len(outcomes) == 1


def test_replays_cut_by_the_slice_are_dropped():
    evs = [("mark", SLICE, 1000, 5000, None)]
    # launched before the slice: its last operations fall inside it
    evs += _replay(1, 800, NAMES, [100] * 5, launch=800)
    evs += _replay(2, 2000, NAMES, [10] * 5)
    # launched inside, its last operation runs past the slice's end
    evs += _replay(3, 4900, NAMES, [30] * 5)
    # launched before the profile: its launch is not in it
    evs += [e for e in _replay(4, 1200, NAMES, [10] * 5) if e[0] == "device"]
    complete = spans.replays(evs, SLICE)
    assert complete == [[(n, 10) for n in NAMES]]


def test_idle_is_attributed_to_the_host_inside_request_replay():
    summary = dict(bounds=(0, 100), host=[], ops=[
        ("a", 10, 10, True), ("b", 40, 10, True), ("c", 80, 10, True)])
    _busy, gaps = trace.busy_and_gaps(summary)
    assert [g[0] for g in gaps] == [10, 20, 30, 10]
    evs = [("mark", "request.replay", 5, 15, None),     # 5 of the first gap
           ("mark", "request", 0, 100, None),           # another span: not counted
           ("mark", "request.replay", 25, 45, None),    # 15 of the second
           ("mark", "request.replay", 60, 95, None)]    # 20 of the third, 5 of the last
    assert spans.idle_in(gaps, evs, "request.replay") == (70, 45)
    assert spans.idle_in(gaps, [], "request.replay") == (70, 0)


def test_self_times_and_lowering_steps_from_a_record():
    from svgrasterize_tpu_torch.utils.profiling import Span

    ms = 1_000_000
    record = [Span(2, "lower.build", 1, None, 0, 40 * ms),
              Span(4, "lower.collapse", 3, None, 45 * ms, 55 * ms),
              Span(3, "lower.pack", 1, None, 41 * ms, 60 * ms),
              Span(6, "lower.pack", 5, None, 62 * ms, 70 * ms),
              Span(5, "lower.groups", 1, None, 61 * ms, 90 * ms),
              Span(1, "lower", None, None, 0, 100 * ms)]
    own = spans.self_ns(record)
    assert own[1] == (100 - 40 - 19 - 29) * ms and own[3] == 9 * ms and own[5] == 21 * ms
    steps = spans.lowering(record)
    assert steps["lower"] == pytest.approx(0.1)
    assert steps["lower_self"] == pytest.approx(0.012)
    assert steps["lower.build"] == pytest.approx(0.04)
    assert steps["lower.pack"] == pytest.approx(0.009 + 0.008)
    assert steps["lower.collapse"] == pytest.approx(0.01)
    assert steps["lower.groups"] == pytest.approx(0.021)
    assert spans.durations_ms(record, "lower.pack") == [19.0, 8.0]


@pytest.mark.parametrize("name", SPAN_METRICS)
def test_span_readers_give_none_without_their_data(name):
    with open(os.path.join(ROOT, "BENCHMARK.json"), encoding="utf-8") as f:
        assert name in {m["name"] for m in json.load(f)["per_layer"]}
    reader = importlib.import_module(f"rasterbench.metrics.{name}")
    assert reader.read(SimpleNamespace(program_spans=None)) is None
    assert reader.read(SimpleNamespace(program_spans={})) is None
    assert reader.read(SimpleNamespace(program_spans={name: 1.5})) == 1.5


def test_the_probe_gives_none_where_the_program_keeps_no_record(monkeypatch):
    from svgrasterize_tpu_torch.utils import profiling

    monkeypatch.delattr(profiling, "spans")
    said = []
    assert probe.run(SimpleNamespace(), device="cpu", log=said.append) is None
    assert "no span record" in said[0]


def test_the_probe_reads_lowering_and_requests_on_the_cpu():
    """At a small size: the lowering split covers lowering; requests give
    host times; no device metric without a card; tracing is off after."""
    from svgrasterize_tpu_torch.utils import profiling

    _bench, _cell, config, params = cell.resolve(ROOT, "icons_3840.pipelined")
    config = {**config, "args": {"n_draws": 96, "width": 384, "height": 128}, "width": 384}
    ctx = SimpleNamespace(config=config, traffic={**params, "warmup_requests": 1},
                          viewport=(0, 0, 128, 384), spans={"lower": None},
                          window=traffic.Window())
    said = []
    out = probe.run(ctx, device="cpu", log=said.append)
    assert out is not None, said
    assert set(out) == {"lower_build_s", "lower_pack_s", "lower_collapse_s", "lower_groups_s",
                        "request_host_ms", "replay_host_ms"}
    assert all(v > 0 for v in out.values())
    assert out["replay_host_ms"] <= out["request_host_ms"]
    assert not profiling.tracing and profiling.spans() == []
