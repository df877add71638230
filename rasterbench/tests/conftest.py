"""The benchmark's own tests: CPU tests, and tests marked `card`, which need a
CUDA card and skip without one (each test decides so when it runs).

    python -m pytest rasterbench/tests -q
"""


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card (skips without one)")
