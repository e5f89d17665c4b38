"""The benchmark's own tests: CPU ones at tiny sizes, and `gpu` ones that
decide inside the test whether there is a card."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card (skips on a host without one)")
