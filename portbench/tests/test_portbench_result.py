"""The result line and its keys, from whole runs on the CPU."""

import json

import pytest

from portbench import run

from conftest import ROWS, WINDOW, cell


@pytest.fixture(scope="module")
def results():
    out = {}
    for trace in (False, True):
        c = run.find_cell("pem_default.http_stats")
        out[trace] = run.run_cell(c, 2**31 + 9, 2.0, trace, device="cpu",
                                  rows=ROWS, window_rows=WINDOW)
    return out


@pytest.mark.parametrize("trace", [False, True])
def test_the_result_has_the_contracts_keys(results, trace):
    r = results[trace]
    assert list(r)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(r)[-1] == "check"  # the numbers compared come last
    assert r["correct"] is True and r["attempted"] > 0 and r["failed"] == 0
    assert set(r["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    for v in r["check"].values():
        assert set(v) == {"value", "limit"} and v["value"] <= v["limit"]
    json.loads(json.dumps(r))


def test_an_untraced_run_reports_the_end_to_end_metrics(results):
    m = results[False]["metrics"]
    assert set(m) == {"rows_per_s", "query_p95_s", "setup_s"}
    assert m["rows_per_s"]["unit"] == "rows/s" and m["rows_per_s"]["value"] > 0
    assert "busy_s" not in results[False]["device"]


def test_a_traced_run_reports_no_device_metric_without_a_card(results):
    r = results[True]
    assert set(r["metrics"]) == {"planner.compile_ms"}
    assert {"busy_s", "window_s"} <= set(r["device"]) and r["device"]["busy_s"] == 0.0
    assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}


def test_main_refuses_without_a_card(capsys):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert run.main(["--workload", "pem_default.http_stats", "--seed", "1", "--seconds", "1"]) == 2
    assert capsys.readouterr().out == ""


@pytest.mark.parametrize("change", [{"clients": 2}, {"loop": "open"}])
def test_a_mix_other_than_one_closed_loop_client_is_refused(tmp_path, monkeypatch, change):
    import shutil

    for sub in ("configs", "tables", "traffic", "reference"):
        shutil.copytree(run.HERE / sub, tmp_path / sub)
    mix = {**cell("pem_default.http_stats").traffic, **change}
    (tmp_path / "traffic" / "other.json").write_text(json.dumps(mix))
    monkeypatch.setattr(run, "HERE", tmp_path)
    with pytest.raises(run.CellError, match="one closed-loop client"):
        run.load_cell("pem_default.other", "pem_default", "other")
