"""A whole run on the CPU, with the timed path broken underneath, comes
out not correct: once for each fault a cell of one card can have. (No
cell exchanges anything between cards.)"""

import numpy as np
import pytest

from portbench import run

from conftest import ROWS, WINDOW, cell

CELLS = ["pem_default.http_stats"]


def _drop_windows(keep):
    """The engine's scan yields only the windows ``keep(i, n)`` keeps."""
    def hook(eng):
        orig = eng._staged_windows

        def staged(stream, stats, cancel):
            items = list(orig(stream, stats, cancel))
            for i, item in enumerate(items):
                if keep(i, len(items)):
                    yield item
        eng._staged_windows = staged
    return hook


def _alter_answer(eng):
    """One value of each answer changed where the engine produces it."""
    orig = eng.execute_query

    def execute(query, *a, **k):
        out = orig(query, *a, **k)
        batch = out["output"]
        planes = batch.cols["n"]
        bumped = planes[0].copy()
        bumped[0] += 1
        batch.cols["n"] = (bumped,) + tuple(planes[1:])
        return out
    eng.execute_query = execute


FAULTS = {
    # A fold step that leaves its state unchanged: the last window folds nothing.
    "state_unchanged": _drop_windows(lambda i, n: i < n - 1),
    # Half of the batch left out, the aggregates taken over the rest.
    "half_the_rows": _drop_windows(lambda i, n: i % 2 == 0),
    "answer_altered": _alter_answer,
}


@pytest.mark.parametrize("name", CELLS)
def test_an_unbroken_run_is_correct(name):
    r = run.run_cell(cell(name), 3, 0.5, False, device="cpu", rows=ROWS,
                     window_rows=WINDOW)
    assert r["correct"], r["check"]


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("name", CELLS)
def test_a_broken_run_is_not_correct(name, fault):
    r = run.run_cell(cell(name), 3, 0.5, False, device="cpu", rows=ROWS,
                     window_rows=WINDOW, engine_hook=FAULTS[fault])
    assert r["attempted"] > 0
    assert r["correct"] is False, r["check"]
    assert np.isfinite(r["check"]["exact_mismatch"]["value"])
