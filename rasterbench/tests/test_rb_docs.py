"""The frozen document generators: their output for fixed seeds is pinned."""

import hashlib
import json
import os

import pytest

from rasterbench.docs import flat_doc, pass_doc

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
# the cells' documents (their configurations' arguments) for fixed seeds
PINS = {
    ("material_3840", 0): ("867aaa7612301431882f8a5f502d6c66403e5f0fa6bc85918f439e99044009d1",
                           "72f9c9bd628fc992967c00960a886e851db97e0609ca86eaa822f4960bdbeaf7"),
    ("material_3840", 2 ** 31 + 11): (
        "645eade8545907f08d45c2ef83bf1303e4e2fe2052b8e76b9bfbb8e1ef22043e",
        "fcd81048e3ee513cd6c2e6916e057c5d7ff1c679aab54927178db2a49a7ec9c1"),
    ("icons_3840", 0): ("69edf4f739c28cfb1e5729a8f386b56fc3cc82c5906f433ce354e538cc15b644",
                        "28a707d708113aa8d0d98167f782a3c54d2272ae73939660a6c94cd45bf1bc16"),
    ("icons_3840", 2 ** 31 + 11): (
        "ffa56b4af1ed9598ff97afbf300b479797d71ba1f65f413a930f1040ad80f492",
        "72589c3d9451f3856182176559f10af4bdea2ee3105811c2e2a22652ec256c25"),
}


def _generate(name, seed):
    with open(os.path.join(ROOT, "rasterbench", "configs", f"{name}.json"), encoding="utf-8") as f:
        config = json.load(f)
    gen = {"flat_doc": flat_doc, "pass_doc": pass_doc}[config["generator"]]
    return gen.generate(seed, **config["args"])


def _digest(text: str) -> str:
    return hashlib.sha256(text.encode()).hexdigest()


@pytest.mark.parametrize("name,seed", sorted(PINS))
def test_generator_output_is_pinned(name, seed):
    svg, doc = _generate(name, seed)
    assert (_digest(svg), _digest(json.dumps(doc, sort_keys=True))) == PINS[name, seed]


def test_flat_doc_records_match_the_text():
    svg, doc = flat_doc.generate(3, n_draws=40)
    assert svg.count("<rect ") + svg.count("<circle ") + svg.count("<path ") \
        == len(doc["items"]) + sum(c["kind"] != "circle" for c in doc["clips"].values()) \
        + sum(c["kind"] == "circle" for c in doc["clips"].values())
    assert "stroke" not in svg and "<text" not in svg
    for item in doc["items"]:
        if item["shape"] == "rect":
            assert f"x='{item['x']:.1f}' y='{item['y']:.1f}'" in svg


def test_pass_doc_places_draws_over_the_whole_canvas():
    _svg, doc = pass_doc.generate(11, 768, 3840, 985)
    kinds, ys = {}, []

    def walk(items):
        for item in items:
            if "group" in item:
                kinds[item["group"]] = kinds.get(item["group"], 0) + 1
                walk(item["children"])
                continue
            ys.append(item.get("y", item.get("cy", item.get("d", [(0, 0, 0)])[0][2])))
            if "filter" in item:
                kind = item["filter"].rstrip("0123456789")
                kinds[kind] = kinds.get(kind, 0) + 1

    walk(doc["items"])
    # 64 opacity groups and 8 more around a blur; 24 + 8 blurs
    assert kinds == {"opacity": 72, "mask": 12, "clip": 12, "b": 32, "ds": 8, "cm": 8}
    assert max(ys) > 0.8 * 985 and min(ys) < 0.1 * 985


@pytest.mark.parametrize("name", ["material_3840", "icons_3840"])
def test_every_seed_paints_the_same_shapes(name):
    svg_a, doc_a = _generate(name, 1)
    svg_b, doc_b = _generate(name, 2)
    assert svg_a != svg_b and sorted(svg_a) == sorted(svg_b)
    key = lambda item: json.dumps(item, sort_keys=True)  # noqa: E731
    assert sorted(map(key, doc_a["items"])) == sorted(map(key, doc_b["items"]))
