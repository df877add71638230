"""The port's spans (utils.profiling.stage) on a compiled render of a small
isolation-pass document, on the CPU.

With tracing off a span is a shared null context: no record_function, no
record.  With tracing on, lowering, the filter parts' post stage, each
filter primitive and each serving request record the spans that the
benchmark's readers and the CLI's --profile read, nested as the code nests
them, each mirrored by a record_function of its name.
"""

from __future__ import annotations

import pytest
import torch

from svgrasterize_tpu_torch import filter as filter_mod
from svgrasterize_tpu_torch.cli import main as torch_main
from svgrasterize_tpu_torch.utils import profiling

from chip_smoke import pass_doc
from torch_support import SIZE, as_on_the_card, doc_scene, serve  # noqa: F401 (a fixture)

LOWERING = {"lower", "lower.build", "lower.pack", "lower.collapse", "lower.groups"}
POST = {"post.assemble", "post.chain", "post.retile"}
# the filter primitives pass_doc's chains use
PRIMITIVES = {"fe.blur", "fe.offset", "fe.merge", "fe.color_matrix", "fe.composite"}


@pytest.fixture
def tracing():
    """Tracing on, the record empty; off and empty afterwards."""
    profiling.reset()
    profiling.enable(True)
    yield
    profiling.enable(False)
    profiling.reset()


@pytest.fixture
def mirrors(monkeypatch):
    """The names of the record_function marks entered, in order."""
    entered = []
    real = torch.profiler.record_function

    def counted(name, *args):
        entered.append(name)
        return real(name, *args)

    monkeypatch.setattr(torch.profiler, "record_function", counted)
    return entered


def test_spans_off_record_nothing_and_mark_nothing(doc_scene, mirrors):
    profiling.reset()
    assert not profiling.tracing
    cs = serve(doc_scene)
    cs.render_tiles_many(2)
    assert mirrors == []
    assert profiling.spans() == []
    assert profiling.report() == "(no stages recorded)"
    # one shared null context, made once
    assert profiling.stage("a") is profiling.stage("b", request=True)


def test_spans_on_nest_as_the_code_does(doc_scene, tracing, mirrors):
    serve(doc_scene)
    spans = profiling.spans()
    by_id = {s.id: s for s in spans}
    names = [s.name for s in spans]
    assert LOWERING | POST | PRIMITIVES | {"request", "request.replay", "request.output"} \
        <= set(names)
    # each span mirrored by one record_function of its name
    assert sorted(mirrors) == sorted(names)

    def parent(s):
        return by_id[s.parent].name if s.parent is not None else None

    for s in spans:
        if s.name in ("lower.build", "lower.groups"):
            assert parent(s) == "lower"
        elif s.name == "lower.pack":
            assert parent(s) in ("lower", "lower.groups")
        elif s.name == "lower.collapse":
            assert parent(s) == "lower.pack"
        elif s.name in POST:
            # on the CPU a request's frames run eagerly, inside its replay span
            assert parent(s) == "request.replay"
        elif s.name.startswith("fe."):
            assert parent(s) == "post.chain"
        elif s.name in ("request.replay", "request.output"):
            assert parent(s) == "request"
        else:
            assert s.name in ("lower", "request") and s.parent is None
    assert sum(n == "lower.pack" and parent(s) == "lower.groups"
               for n, s in zip(names, spans)) >= 1

    # children lie inside their parents; self times are non-negative and
    # the self times of a subtree add up to its root's time
    children = {}
    for s in spans:
        if s.parent is not None:
            p = by_id[s.parent]
            assert p.start_ns <= s.start_ns <= s.end_ns <= p.end_ns
            children.setdefault(s.parent, []).append(s)
    self_ns = {s.id: (s.end_ns - s.start_ns) - sum(c.end_ns - c.start_ns
                                                   for c in children.get(s.id, ()))
               for s in spans}
    assert min(self_ns.values()) >= 0

    def subtree(i):
        return self_ns[i] + sum(subtree(c.id) for c in children.get(i, ()))

    for root in (s for s in spans if s.parent is None):
        assert subtree(root.id) == root.end_ns - root.start_ns


def test_a_request_id_is_shared_by_its_spans(doc_scene, tracing):
    cs = serve(doc_scene, requests=2)
    cs.render_tiles_many(1)
    spans = profiling.spans()
    requests = [s for s in spans if s.name == "request"]
    # render_many and render_tiles_many each open one request
    assert len(requests) == 3 and len({s.request for s in requests}) == 3
    # render_many's frames, then their copy into the layer; on the CPU
    # render_tiles_many returns its frame's own tiles, which it does not copy
    children = [["request.replay", "request.output"]] * 2 + [["request.replay"]]
    for req, expected in zip(requests, children):
        inside = [s for s in spans if req.start_ns <= s.start_ns and s.end_ns <= req.end_ns
                  and s is not req]
        assert [s.name for s in inside if s.parent == req.id] == expected
        assert inside and all(s.request == req.request for s in inside)
    assert all(s.request is None for s in spans if s.name in LOWERING)


def test_render_many_with_tracing_off_opens_no_span(doc_scene, monkeypatch, mirrors):
    profiling.reset()
    cs = serve(doc_scene)
    opened = []
    monkeypatch.setattr(profiling._Stage, "__enter__", lambda self: opened.append(self.name))
    graph = as_on_the_card(cs, monkeypatch)
    layers = [cs.render_many(1) for _ in range(2)]
    layers.append(cs.render_many(3))
    # the CPU's request in serve, then the five replays
    assert graph.replays == 5 and cs.replays == 1 + 5
    assert opened == [] and mirrors == [] and profiling.spans() == []
    # each request's layer is a copy of its own, not the captured frame
    assert layers[0].image.data_ptr() != layers[1].image.data_ptr()
    assert all(layer.image.untyped_storage().data_ptr() != cs._frame.data_ptr()
               for layer in layers)


def test_the_card_path_copies_its_output_under_request_output(doc_scene, monkeypatch):
    cs = serve(doc_scene)
    graph = as_on_the_card(cs, monkeypatch)
    off = cs.render_many(2)
    profiling.reset()
    profiling.enable(True)
    try:
        on = cs.render_many(2)
        tiles = cs.render_tiles_many(1)
    finally:
        profiling.enable(False)
    spans = profiling.spans()
    profiling.reset()
    assert graph.replays == 5
    torch.testing.assert_close(on.image, off.image, rtol=0, atol=0)
    torch.testing.assert_close(tiles, cs._frame, rtol=0, atol=0)
    assert tiles.data_ptr() != cs._frame.data_ptr()
    requests = [s for s in spans if s.name == "request"]
    assert len(requests) == 2
    # render_many: the replays, then the layer's one copy out of the frame;
    # render_tiles_many: the replays and the clone the caller owns
    children = [["request.replay", "request.output"],
                ["request.replay", "request.output"]]
    for req, expected in zip(requests, children):
        got = [s for s in spans if s.parent == req.id]
        assert [s.name for s in got] == expected
        assert all(s.request == req.request for s in got)


def test_reset_clears_the_record(doc_scene, tracing):
    with profiling.stage("outer"):
        with profiling.stage("inner"):
            pass
    assert [s.name for s in profiling.spans()] == ["inner", "outer"]
    assert "outer" in profiling.report()
    profiling.reset()
    assert profiling.spans() == []
    assert profiling.report() == "(no stages recorded)"


def test_every_filter_primitive_has_a_span():
    kinds = {v for k, v in vars(filter_mod).items() if k.startswith("FE_")
             and isinstance(v, int)}
    assert set(filter_mod.FE_SPANS) == kinds
    assert all(name.startswith("fe.") for name in filter_mod.FE_SPANS.values())
    assert len(set(filter_mod.FE_SPANS.values())) == len(kinds)


def test_cli_profile_prints_the_stage_table(tmp_path, capsys):
    svg = tmp_path / "doc.svg"
    svg.write_text(pass_doc(96, SIZE, 0))
    assert torch_main([str(svg), str(tmp_path / "out.png"), "--device", "cpu",
                       "--profile"]) == 0
    table = capsys.readouterr().err
    for name in sorted(LOWERING | POST | PRIMITIVES):
        assert f"\n{name} " in table, name
    assert not profiling.tracing
    profiling.reset()
