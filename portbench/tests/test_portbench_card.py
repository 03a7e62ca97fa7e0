"""On a machine with a card: a short traced run of each cell of
BENCHMARK.json, as timed, is correct, and the float32 control fails at
each cell's size."""

import json

import numpy as np
import pytest

from portbench import run

from conftest import CHECKOUT

pytestmark = pytest.mark.cuda

with open(f"{CHECKOUT}/BENCHMARK.json") as f:
    LISTED = [w["name"] for w in json.load(f)["workloads"]]


@pytest.mark.parametrize("name", LISTED)
def test_a_short_traced_run_on_the_card(card, name):
    r = run.run_cell(run.find_cell(name), 2**31 + 77, 6.0, True, device=card.type)
    assert r["correct"], r["check"]
    assert r["device"]["platform"] == "gpu" and r["device"]["busy_s"] > 0
    assert 0 < r["metrics"]["device.idle_pct"]["value"] < 100
    assert r["metrics"]["fold.roofline_pct"]["value"] < 100


@pytest.mark.parametrize("name", LISTED)
def test_the_float32_control_fails_at_the_cells_size(card, name):
    c = run.find_cell(name)
    ref = c.reference
    data = run.make_data(c, 2**31 + 78)
    numbers = ref.compare([ref.as_program_output(ref.answer(data, np.float32))], ref.prepare(data))
    assert any(numbers[k] > ref.LIMITS[k] for k in ref.LIMITS), numbers
