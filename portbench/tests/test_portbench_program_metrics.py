"""The per-layer metrics the program counts itself (``portbench/registry.py``
and their readers): each reads its histogram of the program's process
registry. After a small run on the CPU each gives a positive number for a
stretch that holds a device op (a card's), none for the CPU run's own
stretch, and none where the registry holds no such histogram or it is
empty."""

import gc

import pytest

from portbench import run, trace

from conftest import ROWS, WINDOW

NAMES = ["fold.dispatch_ms_per_window", "engine.stall_ms_per_query",
         "engine.self_ms_per_query", "engine.gc_ms_per_query"]
HISTOGRAMS = ["pixie_window_stage_seconds", "pixie_pipeline_stall_seconds",
              "pixie_query_engine_self_seconds", "pixie_query_gc_seconds"]


def _reader(name):
    return run.load_module(run.HERE / "metrics" / f"{name}.py", f"portbench_metric_{name}")


def _view(stretch):
    cell = run.find_cell("pem_default.http_stats")
    return run.RunView(cell, 1000, 15, [0.1, 0.3], 0.4, 9.0, stretch, [], 3.35e12)


# A stretch as a card's traced run records one: a device op in it.
CARD = trace.Stretch(0.0, 1.0, 2.0, 0.5, [("void at::native::k", 0.1)])


def _collecting(eng):
    """Every query compiles its fragment after a forced collection, so
    the run's queries have pauses to charge."""
    real = eng._compile

    def compile_after_a_collection(stream):
        gc.collect()
        return real(stream)

    eng._compile = compile_after_a_collection


@pytest.fixture(scope="module")
def cpu_run():
    cell = run.find_cell("pem_default.http_stats")
    return run.run_cell(cell, 2**31 + 21, 1.0, True, device="cpu", rows=ROWS,
                        window_rows=WINDOW, engine_hook=_collecting)


@pytest.mark.parametrize("name", NAMES)
def test_each_reader_reads_the_run_for_a_card_stretch(cpu_run, name):
    assert cpu_run["correct"] is True
    assert name not in cpu_run["metrics"]  # the CPU run's stretch: no device op
    assert _reader(name).read(_view(CARD)) > 0


@pytest.mark.parametrize("name", NAMES)
def test_each_reader_gives_nothing_on_an_empty_registry(monkeypatch, name):
    from pixie_tpu_torch.services import observability

    empty = observability.MetricsRegistry()
    monkeypatch.setattr(observability, "default_registry", empty)
    assert _reader(name).read(_view(CARD)) is None  # no such histogram
    for hist in HISTOGRAMS:
        empty.histogram(hist)
    assert _reader(name).read(_view(CARD)) is None  # one with no observation


def test_the_dispatch_time_is_the_mean_of_the_compute_stage(monkeypatch):
    from pixie_tpu_torch.services import observability

    reg = observability.MetricsRegistry()
    monkeypatch.setattr(observability, "default_registry", reg)
    h = reg.histogram("pixie_window_stage_seconds")
    for stage, s in (("compute", 0.002), ("compute", 0.004), ("stage", 1.0)):
        h.labels(stage=stage).observe(s)
    read = _reader("fold.dispatch_ms_per_window").read
    assert read(_view(CARD)) == pytest.approx(3.0)
    assert read(_view(None)) is None  # an untraced view
