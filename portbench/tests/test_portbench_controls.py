"""The control comes out not correct, the program correct: at a size a
test run holds. On the card, at the cell's own size, the same readings
come from ``python3 -m portbench.controls`` (PERF.md keeps them)."""

import pytest

from portbench import controls

from conftest import ROWS, WINDOW, cell


@pytest.fixture(scope="module")
def readings():
    return controls.readings("pem_default", ["http_stats"], [2**31 + 1, 17], 0.5, device="cpu",
                             rows=ROWS, window_rows=WINDOW, emit=lambda line: None)


def _fails(numbers: dict, limits: dict) -> bool:
    return any(numbers[k] > limits[k] for k in limits)


def test_the_program_passes_and_the_float32_control_fails(readings):
    limits = cell("pem_default.http_stats").reference.LIMITS
    assert not _fails(readings["http_stats"]["program"], limits), readings
    assert _fails(readings["http_stats"]["float32"], limits), readings
