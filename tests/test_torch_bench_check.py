"""The port's bench-shape gates (``pixie_tpu_torch/analysis/``
``bench_check.py``, ``obs_check.py``, ``bound_check.py``) against the JAX
package's, on the CPU.

- each gate returns 0 failures (``check_bounds`` on a CPU engine);
- ``SHAPE_SCHEMAS`` and ``OBS_SCRIPTS`` equal the JAX package's, table
  for table, column for column, dtype for dtype;
- each schema equals the relation of the port bench's replay of that
  shape, so a drift between the bench and the gate fails here;
- a renamed column fails ``check_bench_shapes`` with an unbound-column
  diagnostic;
- an over-budget query is refused at compile with a ``resource-bound``
  ``Diagnostic`` and never executes;
- an observed value over its prediction is a failure of ``_check_one``
  (the gate can fail);
- a partial tail window is staged at its own power-of-two size, which
  keeps a small table's staged bytes inside the bound.
"""

import numpy as np
import pytest
import torch

from pixie_tpu.analysis import bench_check as jax_bench_check
from pixie_tpu.analysis import obs_check as jax_obs_check
from pixie_tpu_torch import bench
from pixie_tpu_torch.analysis import bench_check, bound_check, obs_check
from pixie_tpu_torch.analysis.diagnostics import Diagnostic, PlanCheckError
from pixie_tpu_torch.config import override_flag
from pixie_tpu_torch.types.relation import Relation


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _items(rel):
    return [(c, t.name) for c, t in rel.items()]


def test_bench_shapes_verify_clean():
    assert bench_check.check_bench_shapes(verbose=False) == 0


def test_obs_scripts_verify_clean():
    assert obs_check.check_obs_scripts(verbose=False) == 0


def test_bounds_hold_on_a_cpu_engine():
    assert bound_check.check_bounds(verbose=False, device="cpu") == 0


def test_shape_schemas_equal_jax():
    assert list(bench_check.SHAPE_SCHEMAS) == list(
        jax_bench_check.SHAPE_SCHEMAS)
    for shape, tables in bench_check.SHAPE_SCHEMAS.items():
        ref = jax_bench_check.SHAPE_SCHEMAS[shape]
        assert list(tables) == list(ref)
        for t, rel in tables.items():
            assert _items(rel) == _items(ref[t]), (shape, t)


@pytest.mark.parametrize("shape", list(bench_check.SHAPE_SCHEMAS))
def test_shape_query_equals_jax(shape):
    assert bench_check._shape_query(shape) == jax_bench_check._shape_query(
        shape)


def test_obs_scripts_equal_jax():
    assert obs_check.OBS_SCRIPTS == jax_obs_check.OBS_SCRIPTS


@pytest.mark.parametrize("shape", list(bench_check.SHAPE_SCHEMAS))
def test_schema_equals_the_bench_replay(shape):
    rp = bench.REPLAYS[shape](1 << 12, 1 << 10)
    assert {t: s.relation for t, s in rp.tables.items()} == \
        bench_check.SHAPE_SCHEMAS[shape]


def _renamed(rel, old, new):
    return Relation([(new if c == old else c, t) for c, t in rel.items()])


def test_renamed_column_is_an_unbound_column():
    """A plan compiled against the replay's schema, verified against one
    with ``latency_ns`` renamed: an unbound-column error naming it."""
    from pixie_tpu_torch.analysis.diagnostics import Severity
    from pixie_tpu_torch.analysis.verifier import verify_plan
    from pixie_tpu_torch.planner import CompilerState, compile_pxl
    from pixie_tpu_torch.udf.registry import default_registry

    reg = default_registry()
    schemas = bench_check.SHAPE_SCHEMAS["http_stats"]
    plan = compile_pxl(
        bench_check._shape_query("http_stats"),
        CompilerState(schemas=dict(schemas), registry=reg),
    ).plan
    drift = {"http_events": _renamed(schemas["http_events"], "latency_ns",
                                     "latency")}
    errors = [d for d in verify_plan(plan, drift, reg)
              if d.severity == Severity.ERROR]
    assert [d.code for d in errors] == ["unbound-column"]
    assert "latency_ns" in errors[0].render()


def test_renamed_column_fails_its_shape(monkeypatch, capsys):
    """The gate compiles against the drifted schema: that shape fails
    (the frontend refuses the column first), the others stay clean."""
    schemas = dict(bench_check.SHAPE_SCHEMAS)
    schemas["http_stats"] = {"http_events": _renamed(
        schemas["http_stats"]["http_events"], "latency_ns", "latency")}
    monkeypatch.setattr(bench_check, "SHAPE_SCHEMAS", schemas)
    assert bench_check.check_bench_shapes(verbose=True) == 1
    err = capsys.readouterr().err
    assert "http_stats: FAIL" in err and "'latency_ns'" in err
    assert "service_stats: ok" in err


def test_over_budget_query_is_refused_at_compile():
    assert bound_check._check_rejection(verbose=False, device="cpu") == 0
    engine = bound_check._replay_engine(
        bench_check.SHAPE_SCHEMAS["http_stats"], device="cpu")
    runs = []
    orig = engine._execute_plan
    engine._execute_plan = lambda *a, **k: runs.append(1) or orig(*a, **k)
    with override_flag("bounds_query_budget_mb", 0.01):
        with pytest.raises(PlanCheckError) as ei:
            engine.execute_query(bench_check._shape_query("http_stats"))
    diags = ei.value.diagnostics
    assert diags and all(isinstance(d, Diagnostic) for d in diags)
    assert "resource-bound" in {d.code for d in diags}
    assert runs == []
    # Without the budget the same query runs.
    engine.execute_query(bench_check._shape_query("http_stats"))
    assert runs == [1]


def test_an_observed_value_over_its_prediction_fails(monkeypatch):
    engine = bound_check._replay_engine(
        bench_check.SHAPE_SCHEMAS["http_stats"], device="cpu")
    from pixie_tpu_torch.analysis import bounds

    real = bounds.PlanResourceReport.cost

    def shrunk(self):
        cost = dict(real(self))
        cost["rows_in_hi"] = 1  # the replay folds 4096 rows
        return cost

    monkeypatch.setattr(bounds.PlanResourceReport, "cost", shrunk)
    failures, _, _ = bound_check._check_one(
        "http_stats", engine, bench_check._shape_query("http_stats"),
        verbose=False)
    assert failures == 1


def test_partial_tail_is_staged_at_its_own_size():
    """4096 rows in a table of 2^17-row windows: the tail window is
    staged on demand at 4096 rows, not at the window's 2^17."""
    engine = bound_check._replay_engine(
        bench_check.SHAPE_SCHEMAS["http_stats"], device="cpu")
    engine.execute_query(bench_check._shape_query("http_stats"))
    usage = engine.tracer.last().usage
    row_bytes = 8 * 3 + 4 * 2  # three i64 planes, two i32 string ids
    assert usage.bytes_staged == bound_check.GATE_ROWS * row_bytes
    report = engine.last_resource_report
    assert usage.bytes_staged <= report.cost()["bytes_staged_hi"]
    tail = next(iter(engine.tables["http_events"].device_scan()))[0]
    assert tail.capacity == bound_check.GATE_ROWS
    assert int(tail.cols["latency_ns"][0].numel()) == bound_check.GATE_ROWS
    assert tail.cols["service"][0].dtype == torch.int32
    np.testing.assert_array_equal(
        tail.cols["time_"][0].numpy(),
        engine.tables["http_events"].read_all().cols["time_"][0])
