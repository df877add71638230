"""tests/torch_support.py, the port's test support module, imported in fresh
processes: under xdist it gives each worker its share of the CPUs as
PyTorch threads, outside xdist it leaves PyTorch's default, and it imports
without JAX (the card's machine has none).
"""

from __future__ import annotations

import os
import subprocess
import sys

import pytest

import torch_support  # noqa: F401 (the CPU thread budget)

TESTS = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(TESTS)


def _run(code: str, workers: str | None) -> list[str]:
    """Runs code in a fresh interpreter that imports from tests/ and the
    repository root; PYTEST_XDIST_WORKER_COUNT as given (None: unset)."""
    env = {k: v for k, v in os.environ.items() if k != "PYTEST_XDIST_WORKER_COUNT"}
    if workers is not None:
        env["PYTEST_XDIST_WORKER_COUNT"] = workers
    prelude = f"import sys; sys.path[:0] = [{TESTS!r}, {ROOT!r}]\n"
    out = subprocess.run([sys.executable, "-c", prelude + code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    return out.stdout.split()


THREADS = """
import torch
before = torch.get_num_threads()
import torch_support
print(before, torch.get_num_threads())
"""


@pytest.mark.parametrize("workers", [2, 6])
def test_an_xdist_worker_takes_its_share_of_the_cpus(workers):
    _before, after = map(int, _run(THREADS, str(workers)))
    assert after == max(1, len(os.sched_getaffinity(0)) // workers)


def test_outside_xdist_pytorch_keeps_its_default():
    before, after = map(int, _run(THREADS, None))
    assert after == before


def test_imports_and_lowers_without_jax():
    code = """
sys.modules["jax"] = None  # any import of jax now raises ImportError
import torch_support
lowered = torch_support.torch_lower(torch_support.FLAT_DOCS["solids"], 32)
print(lowered is not None, lowered.tile, sys.modules["jax"] is None)
"""
    assert _run(code, None) == ["True", "32", "True"]
