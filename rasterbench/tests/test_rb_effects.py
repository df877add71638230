"""The effects cell (effects_3840.pipelined): its generator (deterministic,
its records spelling the numbers of its text, the same elements and filter
parts for every seed), its reference (no JAX, nothing of the program), its
files by name, a run on the CPU at a small size (correct), the faults of
test_rb_faults caught, the control failing its limits, and the arithmetic
of chain_roofline."""

import ast
import json
import os
import re
import xml.etree.ElementTree as ET
from types import SimpleNamespace

import pytest

from rasterbench.docs import effects_doc
from rasterbench.harness import cell
from rasterbench.metrics import chain_roofline
from rasterbench.tests.test_rb_faults import (  # noqa: F401  (counted_frames: a fixture)
    cached_layer, counted_frames, half_left_out, state_unchanged, tile_altered)
from rasterbench.tools.calibrate import control_gaps

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CELL = "effects_3840.pipelined"
# the cell at a size a CPU test run holds, its tile kept
SMALL = {"args": {"n_draws": 64, "width": 640, "height": 200}, "width": 640,
         "warmup_seconds": 0}
PEAKS = {"hbm_bytes_per_s": 3.35e12, "fp32_flops_per_s": 67e12}
NUMBER = re.compile(r"-?(?:\d+\.?\d*|\.\d+)")
SVG_NS = "{http://www.w3.org/2000/svg}"


def _kind(item):
    return item.get("filter", "").rstrip("0123456789")


def test_the_generator_is_deterministic():
    assert effects_doc.generate(7, 100, 1280, 400) == effects_doc.generate(7, 100, 1280, 400)


def test_every_seed_paints_the_same_elements_and_parts():
    svg_a, doc_a = effects_doc.generate(1, 512, 3840, 985)
    svg_b, doc_b = effects_doc.generate(2 ** 33 + 3, 512, 3840, 985)
    assert svg_a != svg_b and sorted(svg_a) == sorted(svg_b)
    key = lambda item: json.dumps(item, sort_keys=True)  # noqa: E731
    assert sorted(map(key, doc_a["items"])) == sorted(map(key, doc_b["items"]))
    kinds = {}
    for item in doc_a["items"]:
        kinds[_kind(item)] = kinds.get(_kind(item), 0) + 1
    assert kinds == {"": 512, "lit": 12, "halo": 8, "inset": 4, "emboss": 4, "grain": 2}
    assert doc_a["filters"] == doc_b["filters"] and len(doc_a["filters"]) == 15


def _numbers(text):
    return [float(t) for t in NUMBER.findall(text)]


def _record_numbers(item):
    if item["shape"] == "rect":
        return [item["x"], item["y"], item["w"], item["h"]]
    if item["shape"] == "circle":
        return [item["cx"], item["cy"], item["r"]]
    return [v for cmd in item["d"] for v in cmd[1:]]


def test_the_records_spell_the_numbers_of_the_text():
    svg, doc = effects_doc.generate(5, 80, 1280, 400)
    root = ET.fromstring(svg)
    body = [e for e in root if e.tag != SVG_NS + "defs"]
    assert len(body) == len(doc["items"])
    for element, item in zip(body, doc["items"]):
        tag = element.tag[len(SVG_NS):]
        assert tag == item["shape"]
        attrs = element.attrib
        if tag == "path":
            assert _numbers(attrs["d"]) == _record_numbers(item)
        else:
            keys = ("x", "y", "width", "height") if tag == "rect" else ("cx", "cy", "r")
            assert [float(attrs[k]) for k in keys] == _record_numbers(item)
        fill = attrs["fill"]
        kind, value = item["paint"]
        if kind == "solid":
            assert fill == "#%02x%02x%02x" % value
        else:
            assert fill == f"url(#{value})"
        assert float(attrs.get("fill-opacity", 1.0)) == item["opacity"]
        assert attrs.get("filter") == (f"url(#{item['filter']})" if "filter" in item else None)
    defs = root.find(SVG_NS + "defs")
    filters = {f.get("id"): list(f) for f in defs if f.tag == SVG_NS + "filter"}
    assert set(filters) == set(doc["filters"])
    ops = {"feGaussianBlur": "blur", "feOffset": "offset", "feSpecularLighting": "specular",
           "feDiffuseLighting": "diffuse", "feComposite": "composite", "feMerge": "merge",
           "feMorphology": "morphology", "feFlood": "flood", "feTurbulence": "turbulence",
           "feColorMatrix": "matrix"}
    for fid, prims in filters.items():
        records = doc["filters"][fid]
        assert [ops[p.tag[len(SVG_NS):]] for p in prims] == [r["op"] for r in records]
        for prim, rec in zip(prims, records):
            a = prim.attrib
            op = rec["op"]
            if op == "blur":
                assert (float(a["stdDeviation"]),) * 2 == rec["std"]
            elif op == "offset":
                assert (float(a["dx"]), float(a["dy"])) == (rec["dx"], rec["dy"])
            elif op in ("specular", "diffuse"):
                light = prim[0]
                assert float(a["surfaceScale"]) == rec["surface_scale"]
                key = "specularConstant" if op == "specular" else "diffuseConstant"
                assert float(a[key]) == rec["constant"]
                if op == "specular":
                    assert float(a["specularExponent"]) == rec["exponent"]
                    assert a["lighting-color"] == "#%02x%02x%02x" % rec["color"]
                    assert (float(light.get("x")), float(light.get("y")),
                            float(light.get("z"))) == rec["light"][1:]
                else:
                    assert a["lighting-color"] == "white" and rec["color"] == (255, 255, 255)
                    assert (float(light.get("azimuth")),
                            float(light.get("elevation"))) == rec["light"][1:]
            elif op == "composite":
                if a["operator"] == "arithmetic":
                    assert tuple(float(a[k]) for k in ("k1", "k2", "k3", "k4")) \
                        == rec["operator"][1:]
                else:
                    assert a["operator"] == rec["operator"]
                assert [a["in"], a["in2"]] == rec["inputs"]
            elif op == "merge":
                assert [n.get("in") for n in prim] == rec["inputs"]
            elif op == "morphology":
                assert (a["operator"], float(a["radius"])) == (rec["operator"], rec["radius"])
            elif op == "flood":
                assert a["flood-color"] == "#%02x%02x%02x" % rec["color"]
            elif op == "turbulence":
                assert (a["type"], float(a["baseFrequency"]), int(a["numOctaves"]),
                        int(a["seed"])) == (rec["kind"], rec["base_frequency"][0],
                                            rec["octaves"], rec["seed"])
            elif op == "matrix":
                assert (a["type"], float(a["values"])) == rec["matrix"]
            assert a.get("result", rec["result"]) == rec["result"]


def test_filtered_elements_lie_inside_the_canvas():
    _svg, doc = effects_doc.generate(3, 512, 3840, 985)
    from rasterbench.reference import raster

    for item in doc["items"]:
        if "filter" in item:
            edges = raster.shape_edges(item, 1.0)
            assert edges[:, 0::2].min() >= 0 and edges[:, 0::2].max() <= 3840
            assert edges[:, 1::2].min() >= 0 and edges[:, 1::2].max() <= 985


def test_the_reference_imports_neither_jax_nor_the_program():
    path = os.path.join(ROOT, "rasterbench", "reference", "effects.py")
    tree = ast.parse(open(path, encoding="utf-8").read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module.split(".")[0])
    assert not names & {"jax", "jaxlib", "flax", "svgrasterize_tpu", "svgrasterize_tpu_torch",
                        "chip_smoke"}
    assert names <= {"__future__", "math", "numpy", "torch", "rasterbench"}


def _bench():
    with open(os.path.join(ROOT, "BENCHMARK.json"), encoding="utf-8") as f:
        return json.load(f)


def test_the_cell_resolves_to_the_effects_configuration():
    bench, entry, config, params = cell.resolve(ROOT, CELL)
    assert (entry["config"], entry["traffic"], entry["chips"]) == ("effects_3840", "pipelined", 1)
    assert (config["width"], config["tile"], config["passes"]) == (3840, 32, True)
    assert config["generator"] == "effects_doc" and config["reference"] == "effects"
    assert config["args"] == {"n_draws": 512, "width": 3840, "height": 985}
    assert config["reduced"] == [] and config["precision"] == "float32"
    assert params["entry"] == "render_many" and params["in_flight"] == 3
    names = {m["name"] for m in cell.cell_metrics(bench, CELL, True)}
    assert {"post_chain_ms", "chain_roofline", "fe_composite_ms", "kernels_per_frame",
            "output_roofline"} <= names
    assert {m["name"] for m in cell.cell_metrics(bench, CELL, False)} == {
        "frame_ms", "request_p95_ms", "peak_mem_gib", "setup_s"}


def _run(fault=None, seed=2 ** 31 + 977):
    return cell.run(ROOT, CELL, seed, 0.3, False, device="cpu", fault=fault, overrides=SMALL,
                    log=lambda msg: None)


def test_a_sound_run_is_correct():
    r = _run()
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0


@pytest.mark.parametrize("fault", [state_unchanged, half_left_out, tile_altered, cached_layer],
                         ids=lambda f: f.__name__)
def test_a_broken_timed_path_is_not_correct(fault):
    assert not _run(fault)["correct"]


@pytest.mark.parametrize("seed", [2 ** 31 + 5, 2 ** 33 + 1])
def test_the_control_fails_at_a_small_size(seed):
    _bench_, _entry, config, _params = cell.resolve(ROOT, CELL)
    gaps = control_gaps(ROOT, CELL, seed, "cpu", SMALL)
    assert [n for n, lim in config["limits"].items() if not gaps[n] <= lim], gaps


@pytest.mark.card
def test_the_control_fails_at_the_cells_size():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    _bench_, _entry, config, _params = cell.resolve(ROOT, CELL)
    gaps = control_gaps(ROOT, CELL, 2 ** 31 + 7, "cuda")
    assert all(not gaps[n] <= lim for n, lim in config["limits"].items()), gaps


def test_chain_roofline_counts_the_grown_boxes():
    blur = dict(op="blur", input="SourceAlpha", std=(2.0, 2.0), result="b")
    offset = dict(op="offset", input="b", dx=3.0, dy=-1.0, result="o")
    dilate = dict(op="morphology", input="SourceAlpha", operator="dilate", radius=2.0,
                  result="m")
    lone = dict(op="blur", input="SourceGraphic", std=(4.0, 4.0), result="l")
    doc = dict(width=100.0, height=50.0,
               filters={"f": [blur, offset], "g": [dilate], "h": [lone]},
               items=[dict(shape="rect", x=10.0, y=10.0, w=20.0, h=10.0, filter="f"),
                      dict(group="opacity", value=0.5, children=[
                          dict(shape="rect", x=95.0, y=40.0, w=10.0, h=20.0, filter="g"),
                          dict(shape="rect", x=40.0, y=20.0, w=10.0, h=10.0, filter="h")]),
                      dict(shape="rect", x=60.0, y=20.0, w=10.0, h=10.0, filter="h"),
                      dict(shape="rect", x=0.0, y=0.0, w=5.0, h=5.0)])
    # f: blur grows each side by floor(2.5 * 2) = 5, the offset right by 3 and
    # up by 1: rows 4-25, columns 5-38; g: rows 38-50, columns 93-100 (clipped);
    # h, a lone blur, runs in the blur chunks and is not counted
    assert chain_roofline.chain_pixels(doc, (0, 0, 50, 100), 1.0) == 21 * 33 + 12 * 7
    ctx = SimpleNamespace(doc=doc, viewport=(0, 0, 50, 100), config={"width": 100},
                          peaks=PEAKS, program_spans={"post_chain_ms": 0.01})
    nbytes = 2 * 16 * (21 * 33 + 12 * 7)
    assert chain_roofline.read(ctx) == pytest.approx(100 * nbytes / 3.35e12 * 1e3 / 0.01)
    ctx.program_spans = None
    assert chain_roofline.read(ctx) is None


def _post_parts(lowered):
    """The filter parts a lowered plan runs as post chains (not batched into
    its levels' blur chunks)."""
    n = 0
    for g in lowered.groups:
        _chunks, batched = g["_blur_batch"]
        n += sum(p["post"] is not None and pi not in batched
                 for pi, p in enumerate(g["parts"]))
    return n


@pytest.mark.parametrize("generator,n_draws,parts", [("pass_doc", 96, 16),
                                                     ("effects_doc", 64, 30)])
def test_chain_roofline_counts_the_parts_the_program_runs_as_chains(generator, n_draws,
                                                                    parts):
    import importlib

    from svgrasterize_tpu_torch.core.transform import Transform
    from svgrasterize_tpu_torch.frontend.svg import scene_from_str
    from svgrasterize_tpu_torch.render_plan import lower_scene

    gen = importlib.import_module(f"rasterbench.docs.{generator}")
    svg, doc = gen.generate(2 ** 31 + 5, n_draws=n_draws, width=640, height=200)
    assert len(chain_roofline.chain_items(doc)) == parts
    scene, _ids, (w, h) = scene_from_str(svg, None, 640, None)
    viewport = (0, 0, int(h), int(w))
    lowered = lower_scene(scene, Transform().matrix(*cell.SWAP), viewport, False, 32,
                          device="cpu")
    assert _post_parts(lowered) == parts


@pytest.mark.parametrize("cell_name,parts", [("icons_3840.pipelined", 16), (CELL, 30)])
def test_chain_roofline_counts_the_cells_post_chains(cell_name, parts):
    import importlib

    _bench_, _entry, config, _params = cell.resolve(ROOT, cell_name)
    gen = importlib.import_module(f"rasterbench.docs.{config['generator']}")
    _svg, doc = gen.generate(2 ** 31 + 5, **config["args"])
    assert len(chain_roofline.chain_items(doc)) == parts
