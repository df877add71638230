"""BENCHMARK.json: every cell resolves to its files by name, and every name,
unit and field keeps to the benchmark's contract."""

import importlib
import json
import os
import re

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _bench():
    with open(os.path.join(ROOT, "BENCHMARK.json"), encoding="utf-8") as f:
        return json.load(f)


def _json(rel):
    with open(os.path.join(ROOT, rel), encoding="utf-8") as f:
        return json.load(f)


def test_top_level_keys_and_paths():
    bench = _bench()
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert bench["paths"] == ["rasterbench"]
    assert bench["command"] == ["python3", "rasterbench/run.py"]
    assert 1 <= bench["run_seconds"] <= 51


@pytest.mark.parametrize("cell", [c["name"] for c in _bench()["workloads"]])
def test_cell_resolves_to_its_files(cell):
    bench = _bench()
    entry = {c["name"]: c for c in bench["workloads"]}[cell]
    config_entry = {c["name"]: c for c in bench["configs"]}[entry["config"]]
    config = _json(config_entry["file"])
    assert config["name"] == entry["config"] and config["reduced"] == config_entry["reduced"]
    assert config["source"] == config_entry["source"]
    importlib.import_module(f"rasterbench.docs.{config['generator']}")
    importlib.import_module(f"rasterbench.reference.{config['reference']}")
    assert os.path.exists(os.path.join(ROOT, "rasterbench", "traffic", f"{entry['traffic']}.json"))
    assert entry["chips"] in (1, 4) and 1 <= len(entry["why"]) <= 200
    e2e = [m for m in bench["end_to_end"] if cell in m.get("workloads", [cell])]
    layers = [m for m in bench["per_layer"] if cell in m.get("workloads", [cell])]
    assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2 and layers
    for m in e2e + layers:
        importlib.import_module(f"rasterbench.metrics.{m['name']}").read  # noqa: B018


def test_names_units_and_fields():
    bench = _bench()
    names = [c["name"] for c in bench["configs"]] + [c["name"] for c in bench["workloads"]] \
        + [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(names) == len(set(names))
    for name in names:
        assert NAME.match(name), name
    e2e = {m["name"] for m in bench["end_to_end"]}
    for m in bench["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and "\n" not in m["layer"]
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("rasterbench/") and len(c["source"]) <= 200
        for key in c["reduced"]:
            assert NAME.match(key)
    assert len(json.dumps(bench)) <= 64 * 1024
