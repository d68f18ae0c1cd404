"""The benchmark's own tests: ``python -m pytest svt_bench/tests -q`` from
the repository's root. A test marked ``cuda`` decides inside itself whether
a card is there, and skips with a reason where there is none."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips with a reason where there is none"
    )
