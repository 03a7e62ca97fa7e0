"""CPU tests of the port's benchmark, at sizes a test run holds.

    python -m pytest portbench/tests -q            # here, on the CPU
    python -m pytest portbench/tests -q -m cuda    # on a machine with a card

Tests that need the card carry the ``cuda`` marker and decide inside a
fixture whether there is one.
"""

import os
import sys

import pytest

CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if CHECKOUT not in sys.path:
    sys.path.insert(0, CHECKOUT)

# A small table in four windows: every fault below has windows to break.
ROWS = 1 << 16
WINDOW = 1 << 14


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA card (skips without one)")


def cell(name: str):
    """The cell ``<config>.<traffic>`` from its files, listed in
    BENCHMARK.json or not."""
    from portbench import run

    config, traffic = name.split(".", 1)
    return run.load_cell(name, config, traffic)


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")
