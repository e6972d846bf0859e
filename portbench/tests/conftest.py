"""The benchmark's own tests: `python -m pytest portbench/tests -q` from the
repo root (the repo's `pytest tests/` does not collect them). Tests marked
`cuda` need the card and skip elsewhere, deciding inside the test."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips where "
        "torch.cuda.is_available() is false")
