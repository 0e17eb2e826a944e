"""The benchmark's CPU tests: the harness's arithmetic, its manifest, and
the comparison with the reference at small sizes on the CPU.  Tests marked
``cuda`` need the card and skip without one."""
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
for p in (BENCH, os.path.dirname(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips without one")
