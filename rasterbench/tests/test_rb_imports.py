"""No file of the harness imports JAX or the JAX package (top-level names
compared whole: the port's name begins with the JAX package's), and the
reference imports nothing of the program."""

import ast
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "flax", "svgrasterize_tpu"}
PROGRAM = "svgrasterize_tpu_torch"


def _files(sub=""):
    out = []
    for base, _dirs, files in os.walk(os.path.join(ROOT, sub)):
        out += [os.path.join(base, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _imports(path):
    tree = ast.parse(open(path, encoding="utf-8").read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module" \
                and node.args and isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value).split(".")[0]


@pytest.mark.parametrize("path", _files(), ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_anywhere_in_the_harness(path):
    assert not set(_imports(path)) & FORBIDDEN


@pytest.mark.parametrize("path", _files("reference"), ids=lambda p: os.path.relpath(p, ROOT))
def test_reference_imports_nothing_of_the_program(path):
    found = set(_imports(path))
    assert PROGRAM not in found and "chip_smoke" not in found


def test_the_comparison_is_whole_names():
    names = {"svgrasterize_tpu_torch", "jaxtyping"}
    assert not names & FORBIDDEN
