"""pytest settings of the benchmark's own tests (``python -m pytest
benchmark/tests``): the checkout's root on the path, and the marker of the
tests that need a card."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips without one")
