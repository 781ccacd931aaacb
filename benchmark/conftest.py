"""pytest settings of the benchmark's own tests (benchmark/tests): the
benchmark's package and the repository's root on the path, and the `gpu`
marker of tests that need a CUDA card. Run them with

    python -m pytest benchmark/tests -q          # on a host: card tests skip
    python -m pytest benchmark/tests -q -m gpu   # on the card
"""
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
for p in (HERE, os.path.dirname(HERE)):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line("markers", "gpu: needs a CUDA card; skips on a host without one")
